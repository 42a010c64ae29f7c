// Streaming recurrent matrices through shared memory (sm_90a): the pieces
// that the kernels with a dense product on their time loop share
// (fused_cell_bwd.cu, fused_ann_fwd.cu, fused_ann_bwd.cu).
//
// A recurrent matrix of H = 512 is 1 MB and fits no SM, so a block that
// owns a few batch rows for the whole sequence reads all of it from L2 at
// every step. The wrapper pads the rows of each matrix to 16 bytes and
// (where a step reads several) packs the matrices in the order a step
// reads them, so that the whole sequence is one cyclic stream of tiles of
// up to 64 KB, each a contiguous piece. One thread starts each tile as a
// bulk copy (the Tensor Memory Accelerator, no tensor map) that reports
// the bytes that have landed to an mbarrier; kStages tiles are in flight,
// and the stream runs on across the steps, so the next step's first tiles
// arrive during this step's elementwise work.
//
// The matrix element type MT is a template parameter: float, or
// __nv_bfloat16 in the bf16-stream mode, where a 64 KB tile holds twice the
// rows and a step streams half the bytes. The left operand stays float in
// shared memory (the block rounds it to bf16 when it publishes it, see
// publish), and every product is an FMA in float32: the product of two
// bf16 values is exact there, so the sum is that of a bf16 product with a
// float32 accumulator, in ascending order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparch {

constexpr int kStages = 3;          // tiles in flight
constexpr int kTileBytes = 65536;   // bytes per stage
constexpr int kTileFloats = kTileBytes / 4;
constexpr int kUnroll = 8;          // of the product's inner loop

// The element type of the streams and matrices of a mode.
template <bool BF>
struct Elem {
  using type = float;
};
template <>
struct Elem<true> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// Element idx of an input stream that is float, or (bf16-stream mode only,
// where the caller's projection may have emitted either) bf16.
template <bool BF>
__device__ __forceinline__ float load_stream(const void* p, size_t idx,
                                             bool is_bf16) {
  if constexpr (BF) {
    if (is_bf16) {
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
    }
  }
  return static_cast<const float*>(p)[idx];
}

// N consecutive floats as one load.
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float* d) {
  if constexpr (N == 8) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
    d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
  } else if constexpr (N == 4) {
    const float4 v = reinterpret_cast<const float4*>(p)[0];
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = reinterpret_cast<const float2*>(p)[0];
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = p[0];
  }
}

// Row stride of a streamed matrix in elements (rows padded to 16 bytes:
// four floats or eight bf16, so every row and every tile starts 16-byte
// aligned) and the rows of one tile.
template <typename MT>
__host__ __device__ inline int tile_stride(int H) {
  constexpr int q = 16 / (int)sizeof(MT);
  return (H + q - 1) & ~(q - 1);
}
template <typename MT>
__host__ __device__ inline int tile_rows(int H) {
  const int rows = (kTileBytes / (int)sizeof(MT)) / tile_stride<MT>(H);
  return rows < H ? rows : H;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// The cyclic stream of tiles over n_mats packed (H, Hc) matrices: tile n of
// the stream is tile n % n_tiles of matrix (n / n_tiles) % n_mats and
// lands in stage n % kStages.
template <typename MT>
struct TileStream {
  const MT* base;     // n_mats matrices of H rows of Hc elements
  MT* stages;         // kStages * kTileBytes bytes of shared memory
  uint64_t* full;     // one mbarrier per stage
  int next_tile;      // next tile to start copying
  int tile;           // next tile to consume
  int total_tiles;
  int n_tiles;        // per matrix
  int n_mats;
  int TJ;             // rows of a full tile
  int H;
  int Hc;
};

// The stream of T passes over n_mats packed matrices of H rows each.
template <typename MT>
__device__ __forceinline__ TileStream<MT> stream_over(const MT* base,
                                                      MT* stages,
                                                      uint64_t* full, int H,
                                                      int n_mats, int T) {
  TileStream<MT> s;
  s.base = base;
  s.stages = stages;
  s.full = full;
  s.next_tile = 0;
  s.tile = 0;
  s.H = H;
  s.Hc = tile_stride<MT>(H);
  s.TJ = tile_rows<MT>(H);
  s.n_tiles = (H + s.TJ - 1) / s.TJ;
  s.n_mats = n_mats;
  s.total_tiles = T * n_mats * s.n_tiles;
  return s;
}

// Start the copy of the stream's next tile, if the stream has one left.
template <typename MT>
__device__ __forceinline__ void stream_start(TileStream<MT>& s) {
  constexpr int kTileElems = kTileBytes / (int)sizeof(MT);
  const int n = s.next_tile++;
  if (n >= s.total_tiles || threadIdx.x != 0) return;
  const int in_step = n % (s.n_mats * s.n_tiles);
  const int mat = in_step / s.n_tiles;
  const int j0 = (in_step % s.n_tiles) * s.TJ;
  const int rows = min(s.TJ, s.H - j0);
  const uint32_t bytes = (uint32_t)(rows * s.Hc) * sizeof(MT);
  uint64_t* bar = &s.full[n % kStages];
  mbar_expect_tx(bar, bytes);
  bulk_copy(s.stages + (n % kStages) * kTileElems,
            s.base + ((size_t)mat * s.H + j0) * s.Hc, bytes, bar);
}

// Set up the barriers and fill the pipeline: kStages - 1 tiles in flight.
template <typename MT>
__device__ __forceinline__ void stream_open(TileStream<MT>& s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&s.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < kStages - 1; ++k) stream_start(s);
}

// Write a thread's values v[i][r] (neuron col[i], row r) into a left operand
// of stream_matrix, laid out [neuron][row]; ROUND rounds them to bf16 on the
// way (the bf16-stream mode's operand rounding). The block synchronises
// before it reads them (stream_matrix does, at its first tile).
template <int NPT, int BT, bool ROUND = false>
__device__ __forceinline__ void publish(float* left, const float (&v)[NPT][BT],
                                        const int (&col)[NPT],
                                        const bool (&live)[NPT]) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      left[col[i] * BT + r] = ROUND ? round_bf16(v[i][r]) : v[i][r];
    }
  }
}

// acc[i][r] += sum_j left[j][r] * M[j][col[i]] over the stream's next
// matrix M, j ascending, tile by tile. `left` is H x BT floats in shared
// memory as [j][row], written by the block before the call; when the call
// returns every thread is done reading it.
template <int NPT, int BT, typename MT>
__device__ __forceinline__ void stream_matrix(TileStream<MT>& s,
                                              const float* left,
                                              const int (&col)[NPT],
                                              float (&acc)[NPT][BT]) {
  for (int jt = 0; jt < s.n_tiles; ++jt, ++s.tile) {
    // the tile has landed: its stage's mbarrier has completed the phase
    // of this use
    mbar_wait(&s.full[s.tile % kStages], (s.tile / kStages) & 1);
    // all threads are done with the tile before, and (first tile) `left`
    // is published
    __syncthreads();
    stream_start(s);  // into the stage of the tile before, free now
    const MT* stage =
        s.stages + (s.tile % kStages) * (kTileBytes / (int)sizeof(MT));
    const int j0 = jt * s.TJ;
    const int rows = min(s.TJ, s.H - j0);
#pragma unroll kUnroll
    for (int q = 0; q < rows; ++q) {
      float d[BT];
      load_rows<BT>(left + (size_t)(j0 + q) * BT, d);
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float v = to_float(stage[q * s.Hc + col[i]]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[i][r] = fmaf(d[r], v, acc[i][r]);
      }
    }
  }
  __syncthreads();
}

// out[idx] = sum over k = 0..n_parts-1, ascending, of parts[k][idx]: the
// fixed-order second pass of a reduction over blocks or splits.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, int n_parts,
                                 int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float sum = 0.f;
  for (int k = 0; k < n_parts; ++k) sum += parts[(size_t)k * n + idx];
  out[idx] = sum;
}

}  // namespace sparch
