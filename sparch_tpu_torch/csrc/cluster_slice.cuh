// A recurrent matrix split by columns over the SMs of a thread-block
// cluster (sm_90a): the pieces of the cell kernels whose time loop runs a
// product (fused_ann_fwd.cu, fused_ann_bwd.cu, the recurrent forms of
// fused_cell_bwd.cu, and through tp_ann.cuh the tensor-parallel ones).
//
// A cluster of C blocks (up to six), one per SM, owns R batch rows for the
// whole sequence. Block k owns the columns k*Hs .. k*Hs+Hs-1 of every
// matrix of a step (Hs = the slice width, make_plan) and computes them for
// all R rows: thread (tx, ty) owns column k*Hs + tx for the kRt rows from
// ty*kRt, for every gate, so one shared-memory load of a matrix element
// serves kRt rows, and it keeps that neuron's state in registers for all T.
//
// The left operand of a product (all H columns of the cluster's R rows,
// float, [j][row]) lies in every block's shared memory, twice (two
// parities), `planes` operands per parity. When a block has computed its
// columns it stores them into every block's buffer through distributed
// shared memory (to_cluster) and crosses one cluster barrier (release,
// acquire); the next write into a parity comes only after the barrier that
// follows the last read of it, so one barrier per exchange suffices.
//
// The matrices: the wrapper packs each block's slice of the step's
// matrices as one contiguous piece, in passes: the gates of a pass share
// one loop over j and lie side by side in each row of the pass (row j of a
// two-gate pass: [gate a's Hs columns | gate b's]). Where the slice fits in
// shared memory beside the operands it is loaded once by bulk copies (the
// Tensor Memory Accelerator) and stays for all T ("resident"); else it
// streams from L2 in tiles of whole rows through tile_stream.cuh's kStages
// stages (of at most kTileBytes) behind mbarriers, so a cluster reads each
// matrix once per step.
//
// Rounding: each column is summed over j = 0 .. H-1 in ascending order with
// fmaf in float32, as the kernels before the cluster split summed it (one
// block streaming whole matrices for whole rows), so their outputs keep
// those bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace sparch {
namespace slice {

namespace cg = cooperative_groups;

// Blocks of a cluster at most. Six, not the portable eight: an H100 80GB
// HBM3 holds 15 clusters of eight blocks of one SM each at once
// (cudaOccupancyMaxActiveClusters), so 16 clusters of eight rows, B = 128,
// would take two waves; it holds 17 clusters of six.
constexpr int kMaxCluster = 6;
constexpr int kUnrollRows = 8;      // unroll of the product's loop over rows
constexpr int kMinCols = 32;        // a slice's columns at least, H allowing
constexpr int kColAlign = 8;        // slice widths: 16 bytes of bf16
constexpr int kRt = 4;              // rows a thread owns
constexpr int kSmemMax = 232448;    // shared memory of a block
constexpr int kSmemStatic = 1024;   // kept for the static mbarriers
constexpr int kMaxThreads = 384;     // so 168 registers a thread

// The launch plan (ops/fused_ann.py `_cluster_plan` computes the same).
struct Plan {
  int cluster;      // blocks of a cluster
  int rows;         // batch rows of a cluster
  int cols;         // columns of a block's slice, padded to kColAlign
  int resident;     // the slice stays in shared memory for all T
  int stage_bytes;  // else: bytes of a stream stage
  int clusters;
  int threads;
  size_t smem;      // dynamic shared memory of a block
};

// gates: matrices of a step; elem: bytes of a matrix element; planes:
// operands of a parity. H is the rows of each matrix and the width of the
// operand; `width` (0: H) the columns split over the cluster, fewer where
// a rank owns only its block of them (tp_ann.cuh); `cluster` (0: the most
// blocks, up to kMaxCluster, that leave each slice kMinCols columns) the
// blocks of a cluster; `rows` (0: the rule below) the batch rows of a
// cluster; `operands` (0: two parities of `planes`) the operand planes a
// block holds in all (the TP GRU backward's second exchange has one plane).
inline Plan make_plan(int B, int H, int gates, int elem, int planes,
                      int width = 0, int cluster = 0, int rows = 0,
                      int operands = 0) {
  Plan p;
  const int w = width > 0 ? width : H;
  const int c = w / kMinCols < kMaxCluster ? w / kMinCols : kMaxCluster;
  p.cluster = cluster > 0 ? cluster : (c > 1 ? c : 1);
  p.cols = ((w + p.cluster - 1) / p.cluster + kColAlign - 1) / kColAlign *
           kColAlign;
  // eight rows, unless the operands would pass 128 KB or the threads 384
  p.rows = rows > 0 ? rows
           : planes * H <= 2048 && p.cols * 8 / kRt <= kMaxThreads ? 8 : 4;
  const long op = (long)(operands > 0 ? operands : 2 * planes) * p.rows * H *
                  (long)sizeof(float);
  const long mat = (long)gates * H * p.cols * elem;
  const long budget = kSmemMax - kSmemStatic;
  p.resident = op + mat <= budget ? 1 : 0;
  long stage = (budget - op) / kStages / 16 * 16;
  if (stage > kTileBytes) stage = kTileBytes;
  p.stage_bytes = p.resident ? 0 : (int)stage;
  p.clusters = (B + p.rows - 1) / p.rows;
  p.threads = (p.cols * (p.rows / kRt) + 31) / 32 * 32;
  p.smem = (size_t)op + (size_t)(p.resident ? mat : (long)kStages * stage);
  return p;
}

// The block's slice of the step's matrices as a stream of row tiles, or
// resident. Up to two passes a step.
template <typename MT>
struct Stream {
  const MT* src;     // the block's packed slice: the passes in a row
  MT* smem;          // resident: the whole slice; else kStages stages
  uint64_t* full;    // kStages mbarriers
  int resident;
  int stage_elems;
  int H;
  int width[2];      // elements of a row of each pass
  int rows[2];       // rows of a full tile of each pass
  int tiles[2];      // tiles of each pass
  int off[2];        // element offset of each pass in the slice
  int per_step;      // tiles of a step
  int total;
  int next;          // next tile to start copying
  int tile;          // next tile to consume
};

// The stream of T steps over a slice whose passes hold gates[0] and
// gates[1] matrices of Hs columns (gates[1] = 0: one pass).
template <typename MT>
__device__ __forceinline__ Stream<MT> open_stream(
    const MT* src, MT* smem, uint64_t* full, const Plan& pl, int H, int Hs,
    const int (&gates)[2], int T) {
  Stream<MT> s;
  s.src = src;
  s.smem = smem;
  s.full = full;
  s.resident = pl.resident;
  s.stage_elems = pl.stage_bytes / (int)sizeof(MT);
  s.H = H;
  s.per_step = 0;
  int off = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    s.width[p] = gates[p] * Hs;
    s.off[p] = off;
    off += H * s.width[p];
    if (gates[p] == 0) {
      s.rows[p] = 1;
      s.tiles[p] = 0;
    } else if (pl.resident) {
      s.rows[p] = H;
      s.tiles[p] = 1;
    } else {
      s.rows[p] = min(H, s.stage_elems / s.width[p]);
      s.tiles[p] = (H + s.rows[p] - 1) / s.rows[p];
    }
    s.per_step += s.tiles[p];
  }
  s.total = pl.resident ? 0 : T * s.per_step;
  s.next = 0;
  s.tile = 0;
  return s;
}

// Start the copy of the stream's next tile, if it has one left.
template <typename MT>
__device__ __forceinline__ void start_tile(Stream<MT>& s) {
  const int n = s.next++;
  if (n >= s.total || threadIdx.x != 0) return;
  const int in_step = n % s.per_step;
  // the pass by selects, so that the arrays stay in registers
  const bool first = in_step < s.tiles[0];
  const int tile_rows = first ? s.rows[0] : s.rows[1];
  const int width = first ? s.width[0] : s.width[1];
  const int j0 = (first ? in_step : in_step - s.tiles[0]) * tile_rows;
  const int rows = min(tile_rows, s.H - j0);
  const uint32_t bytes = (uint32_t)(rows * width) * sizeof(MT);
  uint64_t* bar = &s.full[n % kStages];
  mbar_expect_tx(bar, bytes);
  bulk_copy(s.smem + (size_t)(n % kStages) * s.stage_elems,
            s.src + (first ? s.off[0] : s.off[1]) + (size_t)j0 * width,
            bytes, bar);
}

// Thread 0 sets up the mbarriers and starts the first copies: the whole
// slice where it is resident, else kStages - 1 tiles. The block (the
// cluster) synchronises before anyone waits on them.
template <typename MT>
__device__ __forceinline__ void begin(Stream<MT>& s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&s.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (s.resident) {
      const int elems = s.off[1] + s.H * s.width[1];
      const uint32_t bytes = (uint32_t)elems * sizeof(MT);
      mbar_expect_tx(&s.full[0], bytes);
      constexpr uint32_t kChunk = 32768;
      for (uint32_t b = 0; b < bytes; b += kChunk) {
        bulk_copy(reinterpret_cast<char*>(s.smem) + b,
                  reinterpret_cast<const char*>(s.src) + b,
                  min(kChunk, bytes - b), &s.full[0]);
      }
    }
  }
  if (!s.resident) {
    for (int k = 0; k < kStages - 1; ++k) start_tile(s);
  }
}

// A resident slice has landed (the one phase of the first mbarrier).
template <typename MT>
__device__ __forceinline__ void await_resident(Stream<MT>& s) {
  if (s.resident) mbar_wait(&s.full[0], 0);
}

// acc[g][r] += sum over the n rows q of the tile at m (row j0 + q of the
// pass, `width` elements a row, gate g's column at g*Hs) of
// op_g[(j0 + q)*R + r] * m[q*width + g*Hs], for the RT rows r of the thread
// (kRt, or every row of the cluster where a thread owns them all). With
// SHARED every gate reads the operand op; else gate g reads op + g*plane.
template <int NP, bool SHARED, typename MT, int RT = kRt>
__device__ __forceinline__ void product_rows(const MT* m, int width, int Hs,
                                             const float* op, int plane,
                                             int R, int j0, int n,
                                             float (&acc)[NP][RT]) {
  constexpr int NO = SHARED ? 1 : NP;
  const float* o = op + (size_t)j0 * R;
  if constexpr (RT % 4 == 0) {
    constexpr int NV = RT / 4;
#pragma unroll kUnrollRows
    for (int q = 0; q < n; ++q) {
      float4 a[NO][NV];
#pragma unroll
      for (int g = 0; g < NO; ++g) {
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          a[g][u] = *reinterpret_cast<const float4*>(o + g * plane + 4 * u);
        }
      }
      o += R;
#pragma unroll
      for (int g = 0; g < NP; ++g) {
        const float v = to_float(m[q * width + g * Hs]);
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const float4& x = a[SHARED ? 0 : g][u];
          acc[g][4 * u] = fmaf(x.x, v, acc[g][4 * u]);
          acc[g][4 * u + 1] = fmaf(x.y, v, acc[g][4 * u + 1]);
          acc[g][4 * u + 2] = fmaf(x.z, v, acc[g][4 * u + 2]);
          acc[g][4 * u + 3] = fmaf(x.w, v, acc[g][4 * u + 3]);
        }
      }
    }
  } else {
#pragma unroll kUnrollRows
    for (int q = 0; q < n; ++q) {
      float a[NO][RT];
#pragma unroll
      for (int g = 0; g < NO; ++g) load_rows<RT>(o + g * plane, a[g]);
      o += R;
#pragma unroll
      for (int g = 0; g < NP; ++g) {
        const float v = to_float(m[q * width + g * Hs]);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[g][r] = fmaf(a[SHARED ? 0 : g][r], v, acc[g][r]);
        }
      }
    }
  }
}

// One pass of a step: acc[g][r] += sum_j op_g[j][row r] * M_g[j][column],
// j ascending, over the pass's NP gates. `op` points at the thread's first
// row of operand j = 0 (a [j][row] buffer of R rows); `col` is the thread's
// column in the slice. Every thread of the block calls it; when it returns
// the thread is done with the operand (the stream's stages are freed at the
// next tile's barrier).
template <int NP, bool SHARED, typename MT, int RT = kRt>
__device__ __forceinline__ void pass(Stream<MT>& s, int p, const float* op,
                                     int plane, int R, int col, int Hs,
                                     float (&acc)[NP][RT]) {
  const int width = s.width[p];
  if (s.resident) {
    product_rows<NP, SHARED, MT, RT>(s.smem + s.off[p] + col, width, Hs, op,
                                     plane, R, 0, s.H, acc);
    return;
  }
  for (int i = 0; i < s.tiles[p]; ++i, ++s.tile) {
    const int stage = s.tile % kStages;
    mbar_wait(&s.full[stage], (s.tile / kStages) & 1);
    // every thread is done with the tile before: its stage is free
    __syncthreads();
    start_tile(s);
    const int j0 = i * s.rows[p];
    product_rows<NP, SHARED, MT, RT>(
        s.smem + (size_t)stage * s.stage_elems + col, width, Hs, op, plane, R,
        j0, min(s.rows[p], s.H - j0), acc);
  }
}

// A thread's RT values (its rows of column j) into every block's operand
// buffer at `at` ([j][row] index of the thread's first row), rounded to
// bf16 on the way where ROUND (the bf16-stream mode's operand rounding).
template <bool ROUND, int RT = kRt>
__device__ __forceinline__ void to_cluster(float* buf, size_t at,
                                           const float (&v)[RT], int C) {
  if constexpr (RT % 4 == 0) {
    float4 x[RT / 4];
#pragma unroll
    for (int u = 0; u < RT / 4; ++u) {
      const float* w = v + 4 * u;
      x[u] = ROUND ? make_float4(round_bf16(w[0]), round_bf16(w[1]),
                                 round_bf16(w[2]), round_bf16(w[3]))
                   : make_float4(w[0], w[1], w[2], w[3]);
    }
    cg::cluster_group cl = cg::this_cluster();
    for (int k = 0; k < C; ++k) {
      float4* dst =
          reinterpret_cast<float4*>(cl.map_shared_rank(buf + at, k));
#pragma unroll
      for (int u = 0; u < RT / 4; ++u) dst[u] = x[u];
    }
  } else {
    float x[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) x[r] = ROUND ? round_bf16(v[r]) : v[r];
    cg::cluster_group cl = cg::this_cluster();
    for (int k = 0; k < C; ++k) {
      float* dst = cl.map_shared_rank(buf + at, k);
#pragma unroll
      for (int r = 0; r < RT; ++r) dst[r] = x[r];
    }
  }
}

// Every thread of every block of the cluster arrives (release) and waits
// (acquire): the stores before it are visible to every block after it.
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// The cluster's rows of a (B, H) state into a [j][row] operand, rounded to
// bf16 where ROUND; rows past B are zero.
template <bool ROUND>
__device__ __forceinline__ void load_state(float* buf, const float* x, int B,
                                          int H, int R, int row0) {
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    const float v = row0 + r < B ? x[(size_t)(row0 + r) * H + j] : 0.f;
    buf[(size_t)j * R + r] = ROUND ? round_bf16(v) : v;
  }
}

// The plan's grid as clusters of pl.cluster blocks, with its dynamic
// shared memory granted to `kernel`; the attribute lives in `attr`.
template <typename K>
cudaError_t cluster_config(K kernel, const Plan& pl, cudaStream_t st,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = dim3(pl.clusters * pl.cluster, 1, 1);
  cfg->blockDim = dim3(pl.threads, 1, 1);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
}

// Launch `kernel` as pl.clusters clusters of pl.cluster blocks.
template <typename K, typename A>
cudaError_t launch(K kernel, const Plan& pl, const A& args, cudaStream_t st) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = cluster_config(kernel, pl, st, &attr, &cfg);
  return err != cudaSuccess ? err : cudaLaunchKernelEx(&cfg, kernel, args);
}

// How many clusters of the plan the card holds at once, or -1.
template <typename K>
int max_active_clusters(K kernel, const Plan& pl) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int n = 0;
  if (cluster_config(kernel, pl, nullptr, &attr, &cfg) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace slice
}  // namespace sparch
