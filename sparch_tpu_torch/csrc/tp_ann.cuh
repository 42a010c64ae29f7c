// Pieces shared by the tensor-parallel non-spiking cell kernels for Hopper
// (sm_90a): tp_ann_fwd.cu and tp_ann_bwd.cu.
//
// Rank r owns the neurons r*Hl .. r*Hl+Hl-1 of a layer of Hg = P*Hl. Each
// step's product is the gathered (rows, Hg) left operand against the
// rank's (Hg, Hl) column block of a recurrent matrix (forward: V[:, shard];
// backward: V^T[:, shard], the rank's rows of V).
//
// Thread-block clusters per rank (cluster_slice.cuh). A cluster of C blocks,
// one per SM, owns R batch rows (a row group) of one rank; block k owns the
// rank's neurons k*Hs .. k*Hs+Hs-1 and the (Hg, Hs) slice of each of the
// step's column blocks, resident in shared memory where it fits beside the
// operands, else streamed from L2 once per cluster and step. Thread (tx,
// ty) owns neuron k*Hs + tx for kRt of the rows, state in registers; the
// left operand (all Hg columns of the R rows, [plane][j][row], two
// parities) lies in every block's shared memory. The wrapper packs each
// block's slice of each rank's column blocks as one contiguous piece, the
// passes of a step in a row (ops/fused_tp_ann.py `_pack_slices`).
//
// The exchange of index e (put, then exchange below): every thread stores
// its values into the operand of every block of its cluster through
// distributed shared memory and, where P > 1, into row group g's rows of
// slot e & 1 of every rank (tp_exchange.cuh's wire: st.global.cg, bf16 in
// the bf16-stream mode, where the operand is rounded alike); the cluster
// crosses one barrier; where P > 1, block 0's thread 0 publishes the count
// for the cluster (the counter keeps its meaning: rank r has stored row
// group g's exchange e), each block's thread 0 waits on the P - 1 peers,
// and each block copies the peers' columns of the group's rows from its
// own slot into its operand. At P = 1 no slot is touched. The next write
// into a parity of the operand comes only after the barrier that follows
// its last read, and a rank stores into a slot parity only after the peers
// have published an exchange that follows their last read of it: the value
// chain is the backpressure, inside a cluster and across ranks.
//
// Co-residency. Ranks wait on each other, so every cluster of every rank
// must be resident at once: a rank runs `per_rank` clusters, all the row
// groups where the card holds P times as many, else as many as it holds,
// walking the groups g = i, i + per_rank, ... in one order on every rank.
// The wrapper chooses the cluster size from the card's
// cudaOccupancyMaxActiveClusters (ops/fused_tp_ann.py `_tp_plan`: the
// fewest warps a block times walks; a thread's work a step is the same in
// every plan), and the entry points check the plan and size the grid from
// the same query. Launch mode: cooperative clusters, cudaLaunchKernelEx
// with cudaLaunchAttributeCooperative beside
// cudaLaunchAttributeClusterDimension, so the CUDA runtime refuses a grid
// that cannot be resident (on an H100 80GB HBM3 it takes the pair and
// refuses one cluster more than cudaOccupancyMaxActiveClusters);
// tp_exchange.cuh's spin still traps after kSpinTimeoutNs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slice.cuh"
#include "tp_exchange.cuh"

namespace sparch {
namespace tp_ann {

using slice::kRt;

constexpr int kMaxHl = 2048;  // neurons of a rank
constexpr int kColUnit = 8;   // Hl a multiple of it: 16-byte slot rows
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One rank's time-loop plan at `cluster` blocks: cluster_slice.cuh's rule
// with the rank's Hl neurons split over the cluster and the operand Hg
// wide. gates: matrices of a step; planes: operands of a parity;
// operands: the operand planes a block holds (0: two parities of planes).
inline slice::Plan rank_plan(int B, int Hg, int P, int cluster, int gates,
                             int bf16, int planes, int operands = 0) {
  return slice::make_plan(B, Hg, gates, bf16 ? 2 : 4, planes, Hg / P,
                          cluster, 0, operands);
}

// The plan runs: its block fits the threads, and the slice is resident or
// a stream stage holds a row of the widest pass (`widest` gates).
inline bool runs(const slice::Plan& pl, int widest, int bf16) {
  return pl.threads <= slice::kMaxThreads &&
         (pl.resident || pl.stage_bytes >= widest * pl.cols * (bf16 ? 2 : 4));
}

// The wire's 4-element unit: float4, or four bf16 in 8 bytes.
__device__ __forceinline__ float4 wire_load4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 wire_load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Where a thread's values go at an exchange, and what the exchange needs;
// RT: the rows a thread owns (kRt; the spiking tp_cell_bwd.cu: all of the
// cluster's).
template <int RT>
struct RowsSite {
  const tp::Peers* peers;
  const tp::Layout* lay;
  int rank;      // the block's rank
  int group;     // the cluster's row group
  int row_base;  // its first row
  int row0;      // the thread's first row
  int gcol;      // the thread's neuron in the gathered state
  int B, Hg, Hl, W, R, C;
  bool live;     // the thread owns a neuron
  bool rowlive[RT];
};
using Site = RowsSite<kRt>;

// The thread's RT values (its neuron, its rows) into plane `plane` of the
// operand `op` ([plane][j][row], R*Hg floats a plane) of every block of the
// cluster, and where P > 1 into slot e & 1 of every rank (its own
// included) at plane*Hg + gcol of each live row; ROUND (the bf16 mode)
// rounds the operand as the wire of type WT rounds the slot.
template <bool ROUND, typename WT, int RT>
__device__ __forceinline__ void put(const RowsSite<RT>& x, float* op,
                                    int plane, int e, const float (&v)[RT]) {
  if (!x.live) return;
  slice::to_cluster<ROUND, RT>(op + (size_t)plane * x.R * x.Hg,
                               (size_t)x.gcol * x.R + (x.row0 - x.row_base),
                               v, x.C);
  const int P = x.lay->P;
  if (P == 1) return;
  for (int q = 0; q < P; ++q) {
    WT* slot = static_cast<WT*>(x.peers->slots[q]) +
               (size_t)(e & 1) * x.B * x.W + (size_t)plane * x.Hg + x.gcol;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (x.rowlive[r]) {
        tp::wire_store(slot + (size_t)(x.row0 + r) * x.W, v[r]);
      }
    }
  }
}

// Exchange e of the cluster's row group after every thread has put its
// values into `planes` planes of `op`: the cluster's barrier; where P > 1
// the publish, the wait on the peers, and the copy of the peers' columns
// of the group's rows from the own slot e & 1 into op (rows past B zero).
// On return every block's op holds all Hg columns.
template <typename WT, int RT>
__device__ __forceinline__ void exchange(const RowsSite<RT>& x, float* op,
                                         int planes, int e) {
  slice::cluster_barrier();
  const tp::Layout& l = *x.lay;
  if (l.P == 1) return;
  if (threadIdx.x == 0) {
    if (cooperative_groups::this_cluster().block_rank() == 0) {
      tp::publish(*x.peers, l, x.rank, x.group, e);
    }
    tp::await_peers(*x.peers, l, x.rank, x.group, e);
  }
  __syncthreads();
  const int R = x.R, Hg = x.Hg, Hl = x.Hl;
  const int q4 = (Hg - Hl) / 4;  // 4-column units of the peers' columns
  const int units = R * planes * q4;
  const int own0 = x.rank * Hl;
  const WT* in = static_cast<const WT*>(x.peers->slots[x.rank]) +
                 ((size_t)(e & 1) * x.B + x.row_base) * x.W;
  constexpr int kBatch = 4;  // loads in flight per thread
  for (int u0 = threadIdx.x; u0 < units; u0 += kBatch * blockDim.x) {
    float4 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = u0 + b * blockDim.x;
      const int r = u % R;  // rows fastest: the operand is [j][row]
      const int rest = u / R;
      const int pl = rest / q4;
      int j = (rest - pl * q4) * 4;
      j += j < own0 ? 0 : Hl;
      at[b] = u < units ? (pl * Hg + j) * R + r : -1;
      v[b] = (u < units && x.row_base + r < x.B)
                 ? wire_load4(in + (size_t)r * x.W + pl * Hg + j)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (at[b] < 0) continue;
      op[at[b]] = v[b].x;
      op[at[b] + R] = v[b].y;
      op[at[b] + 2 * R] = v[b].z;
      op[at[b] + 3 * R] = v[b].w;
    }
  }
  __syncthreads();
}

// Launch `kernel` as `clusters` clusters of the plan's blocks, cooperative
// (see the header).
template <typename K, typename A>
cudaError_t launch(K kernel, const slice::Plan& pl, int clusters,
                   const A& args, cudaStream_t st) {
  slice::Plan grid = pl;
  grid.clusters = clusters;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  const cudaError_t err = slice::cluster_config(kernel, grid, st, attr, &cfg);
  if (err != cudaSuccess) return err;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// The plan a launch reports (host memory, may be null): cluster, rows,
// cols, resident, clusters per rank, row groups a cluster walks at most,
// the clusters the card holds at once, threads.
constexpr int kPlanInts = 8;
inline void report(int* out, const slice::Plan& pl, int per_rank, int max) {
  if (!out) return;
  const int v[kPlanInts] = {pl.cluster, pl.rows, pl.cols, pl.resident,
                            per_rank, (pl.clusters + per_rank - 1) / per_rank,
                            max, pl.threads};
  for (int i = 0; i < kPlanInts; ++i) out[i] = v[i];
}

// Clusters per rank of a launch of `kernel` at plan `pl` over n_local
// ranks: every row group where the card holds them all, else as many as
// it holds; 0 where it holds fewer clusters than ranks. `max` receives
// what the card holds (-1: the query failed).
template <typename K>
int clusters_per_rank(K kernel, const slice::Plan& pl, int n_local,
                      int* max) {
  *max = slice::max_active_clusters(kernel, pl);
  const int cap = *max / n_local;
  return cap < pl.clusters ? (cap > 0 ? cap : 0) : pl.clusters;
}

}  // namespace tp_ann
}  // namespace sparch
