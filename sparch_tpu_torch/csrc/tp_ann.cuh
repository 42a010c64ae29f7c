// Pieces shared by the tensor-parallel non-spiking cell kernels for Hopper
// (sm_90a): tp_ann_fwd.cu and tp_ann_bwd.cu.
//
// Rank r owns the neurons r*Hl .. r*Hl+Hl-1 of a layer of Hg = P*Hl. Each
// step's product is the gathered (B, Hg) left operand against the rank's
// (Hg, Hl) column block of a recurrent matrix (forward: V[:, shard];
// backward: V^T[:, shard], the rank's rows of V). The wrapper packs every
// rank's blocks of the step's matrices, in the order a step reads them, as
// [rank][matrix][Hg][Hl]: a contiguous stream per rank that
// tile_stream.cuh's pipeline carries through shared memory in 64 KB bulk
// copies, as it carries the single-card kernels' whole matrices.
//
// The exchange (tp_exchange.cuh): a rank's slot is [2][B][W] elements of
// the wire's type, a row of W = planes * Hg holding `planes` gathered planes
// side by side, the rank's block of plane p at p*Hg + r*Hl. A block stores
// its values into every rank's slot, exchanges, and reads the group's
// gathered rows back into shared memory as the next product's left operand,
// [plane][j][row], in float. The wire is float, or __nv_bfloat16 in the
// bf16-stream mode, where a value is rounded to bf16 as it is stored: the
// rounding of the product's left operand that the TPU kernels make as they
// stage their exchange (pallas_tp_ann.py:185, :472), and every reader of
// the slot sees the rounded value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"
#include "tp_exchange.cuh"

namespace sparch {
namespace tp_ann {

constexpr int kThreads = 512;
constexpr int kMaxNpt = 4;   // so Hl <= 2048
constexpr int kMaxWork = 8;  // NPT * BT
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The stream of `passes` passes over a rank's n_mats packed (Hg, Hl)
// column blocks of element type MT (float, or bf16 in the bf16-stream
// mode): tile_stream.cuh's TileStream with rows and columns apart (Hl is a
// multiple of 128, so every row and tile is 16-byte aligned).
template <typename MT>
__device__ __forceinline__ TileStream<MT> block_stream(
    const MT* base, MT* stages, uint64_t* full, int Hg, int Hl, int n_mats,
    int passes) {
  TileStream<MT> s;
  s.base = base;
  s.stages = stages;
  s.full = full;
  s.next_tile = 0;
  s.tile = 0;
  s.H = Hg;
  s.Hc = Hl;
  s.TJ = min(Hg, (kTileBytes / (int)sizeof(MT)) / Hl);
  s.n_tiles = (Hg + s.TJ - 1) / s.TJ;
  s.n_mats = n_mats;
  s.total_tiles = passes * n_mats * s.n_tiles;
  return s;
}

// A thread's values v[i][r] (the rank's neuron col[i], batch row row0 + r)
// into slot `parity` of every rank, at offset `off` of the row (p*Hg + r*Hl
// for plane p), as elements of the wire's type WT.
template <typename WT, int NPT, int BT>
__device__ __forceinline__ void to_peers(const tp::Peers& peers, int P, int B,
                                         int W, int parity, int row0, int off,
                                         const float (&v)[NPT][BT],
                                         const int (&col)[NPT]) {
  for (int q = 0; q < P; ++q) {
    WT* slot = static_cast<WT*>(peers.slots[q]) + (size_t)parity * B * W;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        tp::wire_store(slot + (size_t)(row0 + r) * W + off + col[i],
                       v[i][r]);
      }
    }
  }
}

// After the exchange: the first `planes` gathered planes of the group's BT
// rows, from the own slot `parity` into `left` as [plane][j][row]. The
// block synchronises before it reads them (stream_matrix does, at its first
// tile).
template <typename WT, int BT>
__device__ __forceinline__ void from_slot(float* left, const void* own,
                                          int B, int W, int parity, int row0,
                                          int Hg, int planes) {
  const WT* in =
      static_cast<const WT*>(own) + ((size_t)parity * B + row0) * W;
  const int n = planes * Hg;
  for (int idx = threadIdx.x; idx < BT * n; idx += blockDim.x) {
    const int r = idx / n;
    const int k = idx - r * n;  // plane * Hg + j
    const int pl = k / Hg;
    const int j = k - pl * Hg;
    left[((size_t)pl * Hg + j) * BT + r] =
        tp::wire_load(in + (size_t)r * W + k);
  }
}

// Consider `kernel` at BT rows per block (tp::try_plan): `planes` left
// operands of Hg*BT floats in shared memory beside the stream's stages.
template <int BT, typename K>
void try_plan(K kernel, int threads, int planes, int Hg, int B, int n_local,
              tp::Plan& best, bool& all_fit) {
  tp::try_plan(kernel, BT, threads,
               (size_t)planes * Hg * BT * sizeof(float) +
                   (size_t)kStages * kTileBytes,
               B / BT, n_local, best, all_fit);
}

}  // namespace tp_ann
}  // namespace sparch
