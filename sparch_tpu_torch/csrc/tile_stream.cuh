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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sparch {

constexpr int kStages = 3;          // tiles in flight
constexpr int kTileFloats = 16384;  // floats per stage (64 KB)
constexpr int kUnroll = 8;          // of the product's inner loop

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

// Row stride of a streamed matrix (rows padded to a multiple of four
// floats, so every row and every tile starts 16-byte aligned) and the rows
// of one tile.
__host__ __device__ inline int tile_stride(int H) { return (H + 3) & ~3; }
__host__ __device__ inline int tile_rows(int H) {
  const int rows = kTileFloats / tile_stride(H);
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
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
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
struct TileStream {
  const float* base;  // n_mats matrices of H rows of Hc floats
  float* stages;      // kStages * kTileFloats floats of shared memory
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
__device__ __forceinline__ TileStream stream_over(const float* base,
                                                  float* stages,
                                                  uint64_t* full, int H,
                                                  int n_mats, int T) {
  TileStream s;
  s.base = base;
  s.stages = stages;
  s.full = full;
  s.next_tile = 0;
  s.tile = 0;
  s.H = H;
  s.Hc = tile_stride(H);
  s.TJ = tile_rows(H);
  s.n_tiles = (H + s.TJ - 1) / s.TJ;
  s.n_mats = n_mats;
  s.total_tiles = T * n_mats * s.n_tiles;
  return s;
}

// Start the copy of the stream's next tile, if the stream has one left.
__device__ __forceinline__ void stream_start(TileStream& s) {
  const int n = s.next_tile++;
  if (n >= s.total_tiles || threadIdx.x != 0) return;
  const int in_step = n % (s.n_mats * s.n_tiles);
  const int mat = in_step / s.n_tiles;
  const int j0 = (in_step % s.n_tiles) * s.TJ;
  const int rows = min(s.TJ, s.H - j0);
  const uint32_t bytes = (uint32_t)(rows * s.Hc) * sizeof(float);
  uint64_t* bar = &s.full[n % kStages];
  mbar_expect_tx(bar, bytes);
  bulk_copy(s.stages + (n % kStages) * kTileFloats,
            s.base + ((size_t)mat * s.H + j0) * s.Hc, bytes, bar);
}

// Set up the barriers and fill the pipeline: kStages - 1 tiles in flight.
__device__ __forceinline__ void stream_open(TileStream& s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&s.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < kStages - 1; ++k) stream_start(s);
}

// Write a thread's values v[i][r] (neuron col[i], row r) into a left operand
// of stream_matrix, laid out [neuron][row]. The block synchronises before
// it reads them (stream_matrix does, at its first tile).
template <int NPT, int BT>
__device__ __forceinline__ void publish(float* left, const float (&v)[NPT][BT],
                                        const int (&col)[NPT],
                                        const bool (&live)[NPT]) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int r = 0; r < BT; ++r) left[col[i] * BT + r] = v[i][r];
  }
}

// acc[i][r] += sum_j left[j][r] * M[j][col[i]] over the stream's next
// matrix M, j ascending, tile by tile. `left` is H x BT floats in shared
// memory as [j][row], written by the block before the call; when the call
// returns every thread is done reading it.
template <int NPT, int BT>
__device__ __forceinline__ void stream_matrix(TileStream& s,
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
    const float* stage = s.stages + (s.tile % kStages) * kTileFloats;
    const int j0 = jt * s.TJ;
    const int rows = min(s.TJ, s.H - j0);
#pragma unroll kUnroll
    for (int q = 0; q < rows; ++q) {
      float d[BT];
      load_rows<BT>(left + (size_t)(j0 + q) * BT, d);
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float v = stage[q * s.Hc + col[i]];
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
