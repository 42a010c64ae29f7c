// Tensor-parallel fused non-spiking cell, forward, for Hopper (sm_90a): the
// sigmoid RNN, the LiGRU and the GRU with the neurons split into P column
// blocks of Hl = Hg/P, one per rank, and the ranks exchanging their states
// inside the time loop.
//
// Replaces: sparch_tpu/ops/pallas_tp_ann.py `_tp_ann_fwd_kernel` (:126,
// through `_tp_ann_forward` :229), in its serving form (the output alone)
// and its training form (the gate series too), in its two stream modes
// (BF): float32, and the TPU kernel's mxu_bf16 mode (below). Per step, for
// one batch row of rank r (y the rank's block of the state, y_full the
// gathered state of the step before; gate 0 is the candidate with V, gate 1
// the update z with Vz, gate 2 the reset r with Vr; V*[:, shard] the rank's
// column block):
//   RNN:    y = sigmoid(wx_t + y_full @ V[:, shard])
//   LiGRU:  z = sigmoid(wzx_t + y_full @ Vz[:, shard])
//           c = relu(wx_t + y_full @ V[:, shard]);   y = z*y + (1-z)*c
//   GRU:    z = sigmoid(wzx_t + y_full @ Vz[:, shard])
//           r = sigmoid(wrx_t + y_full @ Vr[:, shard])
//           ry_full = all-gather of every rank's r*y   (exchange 2t)
//           c = tanh(wx_t + ry_full @ V[:, shard]);  y = z*y + (1-z)*c
//   y_full = all-gather of every rank's y    (exchange t; GRU: 2t + 1)
// The last step's y gather feeds nothing, so every rank skips it alike; the
// GRU's r*y gather of that step feeds its candidate and is made. The first
// products take the gathered initial state y0f (the JAX wrapper all-gathers
// y0 once before its kernel; in the one-card form the full y0 is at hand).
// Normalisation and dropout stay outside, as in the JAX package.
//
// What bounds it on this card: the dense products on the chain, as in
// fused_ann_fwd.cu. Every step is a (B, Hg) x (Hg, Hl) float32 product per
// gate and rank, 2*B*Hg*Hg FLOP per gate over all ranks, T steps one after
// another; the GRU has two dependent products per step with an exchange
// between them. At (128, 100, 1024) the GRU does 80.5 GFLOP (1.20 ms at the
// float32 peak outside the tensor cores). A block that owned whole rows
// would read its rank's column blocks from L2 at every step for those rows
// alone; a cluster reads them once a step for its R rows, and what is left
// on the chain is issue slots and the exchanges (PERF.md §6).
//
// Design (tp_ann.cuh; fused_ann_fwd.cu's, per rank): a thread-block cluster
// of C blocks owns R batch rows of one rank for the whole sequence, block k
// the (Hg, Hs) slice of each of the step's column blocks of its rank,
// resident or streamed once per cluster and step, so a cluster reads its
// rank's matrices once a step for R rows. A step runs its products in
// passes (RNN: V; LiGRU: [V | Vz]; GRU: [Vz | Vr], then V), each thread
// summing its column over all Hg rows in ascending order with FMAs. After
// each pass that feeds another (the GRU's r*y, every step's y but the
// last) the cluster exchanges (tp_ann.cuh): its blocks' columns through
// distributed shared memory, the peers' through the slots; the GRU's r*y
// lands on operand parity 0 and slot parity 0, y on parity 1 and 1; the
// RNN's and LiGRU's y of step t on operand parity (t+1) & 1 and slot
// parity t & 1. At P = 1 this is fused_ann_fwd.cu without the affine and
// the dropout. Where the clusters of every rank do not all fit, a cluster
// walks its row groups, loading each group's rows of y0f before its first
// step.
// - Rounding: each output column sums y_full[j]*V[j][col] over all Hg rows
//   j in ascending order with FMAs, whatever P and the plan are, and the
//   elementwise code is fused_ann_fwd.cu's without the affine: the output
//   equals the single-card kernel's, and that of every P, bit for bit.
// - Rank data: the local rank l's column block starts at column l*Hl of
//   tensors with row stride ld. In the one-card form they are the full
//   (…, H) tensors (ld = H); across cards each rank's own (ld = Hl).
// - Edges are masked: rows >= B and neurons >= Hl load nothing and store
//   nothing; the packed slices are zero past Hl.
// - bf16 mode (the JAX kernel's mxu_bf16: rdt/vdt bf16,
//   pallas_tp_ann.py:243-244): the packed slices are bf16 (rounded once by
//   the wrapper), the wire is bf16 (tp_exchange.cuh) and the operand is
//   rounded alike, so the gathered y and r*y that feed the products are
//   rounded to bf16 (:185, :204, :210), and so is the gathered y0 of the
//   first products (`_dot` rounds its left operand); the output and the
//   gate series are bf16 streams (:219-222), each input stream is float32
//   or bf16 as the model emitted it, and the carried y stays float32 (:172,
//   :208, :224). A product of two bf16 values is exact in float32, so the
//   sums are those of a bf16 product with a float32 accumulator. These are
//   the rounding points of fused_ann_fwd.cu's bf16 mode, so the output
//   still equals that kernel's without the affine and the dropout, at
//   every P.
//
// C interface, bound with ctypes: sparch_tp_ann_fwd checks the plan it is
// given (cluster, rows, resident: ops/fused_tp_ann.py `_tp_plan`) against
// its own at that cluster size, sizes the grid from the clusters the card
// holds, launches (tp_ann.cuh's launch mode), returns the launch's
// cudaError_t (or an invalid-value error for arguments it does not take)
// and never synchronises; `plan` (host memory, may be null) receives the
// plan it ran (tp_ann::report). sparch_tp_ann_fwd_max_clusters answers the
// wrapper's question: how many clusters of a plan the card holds at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tp_ann.cuh"

namespace {

using namespace sparch;
using namespace sparch::tp_ann;

// Streams, slices and slots are float, or bf16 in the bf16 mode; wx is
// float or bf16 there, as wx_bf16 says.
struct Args {
  const void* wx[3];   // (B, T, ld) by gate
  const void* V;       // the packed slices, [n_local][cluster][passes]
  const float* y0f;    // (B, Hg): the gathered initial state
  void* y_out;         // (B, T, ld)
  void* z_out;         // the gate series, (B, T, ld); null: serving form
  void* r_out;
  void* c_out;
  tp::Peers peers;     // slots: per rank [2][B][Hg] elements
  tp::Layout lay;      // per_rank: clusters; n_groups: row groups
  int B, T, Hg, Hl, ld;
  int wx_bf16;         // the input streams are bf16, not float
  slice::Plan plan;
};

template <int MODE, bool BF>
__global__ void __launch_bounds__(slice::kMaxThreads, 1)
tp_ann_fwd_kernel(const __grid_constant__ Args p) {
  using ST = typename Elem<BF>::type;  // streams, slices, wire
  constexpr int G = MODE + 1;
  // the gates of the first pass (the GRU's second pass holds V)
  constexpr int NA = MODE == kRnn ? 1 : 2;
  // two parities of the [j][row] operand (R*Hg floats each), then the
  // resident slice or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const tp::Layout& l = p.lay;
  const int Hg = p.Hg, T = p.T, R = pl.rows, Hs = pl.cols, C = pl.cluster;
  const int k = (int)(blockIdx.x % C);
  const int cl = (int)(blockIdx.x / C);
  const int local = cl / l.per_rank;
  const int first = cl % l.per_rank;  // the cluster's first row group
  const size_t RH = (size_t)R * Hg;
  float* const op0 = smem;  // the two parities of the operand
  float* const op1 = smem + RH;

  const int tx = threadIdx.x % Hs;
  const int ty_raw = threadIdx.x / Hs;
  const bool thread_live = ty_raw < R / kRt;
  const int ry0 = thread_live ? ty_raw * kRt : 0;
  const int col = k * Hs + tx;  // the rank's neuron
  const size_t scol = (size_t)local * p.Hl + col;  // its column in rank data
  const bool wx_bf16 = BF && p.wx_bf16;
  Site x;
  x.peers = &p.peers;
  x.lay = &l;
  x.rank = l.rank0 + local;
  x.gcol = x.rank * p.Hl + col;
  x.B = p.B;
  x.Hg = Hg;
  x.Hl = p.Hl;
  x.W = Hg;
  x.R = R;
  x.C = C;
  x.live = thread_live && col < p.Hl;

  const int gates[2] = {NA, MODE == kGru ? 1 : 0};
  const int walks = (l.n_groups - first + l.per_rank - 1) / l.per_rank;
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.V) + ((size_t)local * C + k) * G * Hg * Hs,
      reinterpret_cast<ST*>(smem + 2 * RH), full, pl, Hg, Hs, gates,
      walks * T);
  slice::begin(s);

  for (int w = 0; w < walks; ++w) {
    x.group = first + w * l.per_rank;
    x.row_base = x.group * R;
    x.row0 = x.row_base + ry0;
    float y[kRt];
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      x.rowlive[r] = thread_live && x.row0 + r < p.B;
      y[r] = (x.live && x.rowlive[r])
                 ? p.y0f[(size_t)(x.row0 + r) * Hg + x.gcol]
                 : 0.f;
    }
    // the group's first left operand, its rows of y0f: the GRU reads y
    // from parity 1, the others y of step t from parity t & 1; the
    // block's threads are done with the group before (its last pass read
    // parity 0 where T is odd)
    if (w > 0) __syncthreads();
    slice::load_state<BF>(MODE == kGru ? op1 : op0, p.y0f, p.B, Hg, R,
                          x.row_base);
    // every block of the cluster runs (is done with the group before), and
    // its operand is in place
    slice::cluster_barrier();
    if (w == 0) slice::await_resident(s);

    for (int t = 0; t < T; ++t) {
      float d[G][kRt];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int r = 0; r < kRt; ++r) {
          const size_t at = ((size_t)(x.row0 + r) * T + t) * p.ld + scol;
          d[g][r] = (x.live && x.rowlive[r])
                        ? load_stream<BF>(p.wx[g], at, wx_bf16)
                        : 0.f;
        }
      }
      float a[NA][kRt];
#pragma unroll
      for (int g = 0; g < NA; ++g) {
#pragma unroll
        for (int r = 0; r < kRt; ++r) a[g][r] = 0.f;
      }
      float z[kRt], rr[kRt], c[kRt];
      float pre[kRt];
      if constexpr (MODE == kGru) {
        // [Vz | Vr] against y, from parity 1
        slice::pass<2, true>(s, 0, op1 + ry0, 0, R, tx, Hs, a);
        float ry[kRt];
#pragma unroll
        for (int r = 0; r < kRt; ++r) {
          z[r] = sigmoidf(d[1][r] + a[0][r]);
          rr[r] = sigmoidf(d[2][r] + a[1][r]);
          ry[r] = rr[r] * y[r];
        }
        put<BF, ST>(x, op0, 0, 2 * t, ry);
        exchange<ST>(x, op0, 1, 2 * t);
        float ac[1][kRt] = {};
        slice::pass<1, true>(s, 1, op0 + ry0, 0, R, tx, Hs, ac);  // (r*y) @ V
#pragma unroll
        for (int r = 0; r < kRt; ++r) pre[r] = d[0][r] + ac[0][r];
      } else {
        slice::pass<NA, true>(s, 0, ((t & 1) ? op1 : op0) + ry0, 0, R, tx,
                              Hs, a);
#pragma unroll
        for (int r = 0; r < kRt; ++r) pre[r] = d[0][r] + a[0][r];
      }
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        if constexpr (MODE == kRnn) {
          y[r] = sigmoidf(pre[r]);
        } else {
          if constexpr (MODE == kLigru) {
            z[r] = sigmoidf(d[1][r] + a[1][r]);
            c[r] = fmaxf(pre[r], 0.f);
          } else {
            c[r] = tanhf(pre[r]);
          }
          y[r] = z[r] * y[r] + (1.0f - z[r]) * c[r];
        }
        if (!(x.live && x.rowlive[r])) continue;
        const size_t at = ((size_t)(x.row0 + r) * T + t) * p.ld + scol;
        static_cast<ST*>(p.y_out)[at] = from_float<ST>(y[r]);
        if constexpr (MODE != kRnn) {
          if (p.c_out) {
            static_cast<ST*>(p.z_out)[at] = from_float<ST>(z[r]);
            static_cast<ST*>(p.c_out)[at] = from_float<ST>(c[r]);
            if constexpr (MODE == kGru) {
              static_cast<ST*>(p.r_out)[at] = from_float<ST>(rr[r]);
            }
          }
        }
      }
      if (t + 1 == T) break;  // the last step's y gather would feed nothing
      const int e = MODE == kGru ? 2 * t + 1 : t;
      float* next = (MODE == kGru || !(t & 1)) ? op1 : op0;
      put<BF, ST>(x, next, 0, e, y);
      exchange<ST>(x, next, 1, e);
    }
  }
}

using Kernel = void (*)(Args);

template <int MODE>
Kernel kernel_of(int bf16) {
  return bf16 ? tp_ann_fwd_kernel<MODE, true> : tp_ann_fwd_kernel<MODE, false>;
}

// The instantiation that a launch of the mode takes.
Kernel kernel_for(int mode, int bf16) {
  switch (mode) {
    case kRnn: return kernel_of<kRnn>(bf16);
    case kLigru: return kernel_of<kLigru>(bf16);
    default: return kernel_of<kGru>(bf16);
  }
}

slice::Plan fwd_plan(int B, int Hg, int P, int cluster, int mode, int bf16) {
  return rank_plan(B, Hg, P, cluster, mode + 1, bf16, 1);
}

bool shape_ok(int B, int Hg, int P, int mode, int cluster) {
  return B > 0 && P >= 1 && P <= tp::kMaxRanks && Hg > 0 && Hg % P == 0 &&
         (Hg / P) % kColUnit == 0 && Hg / P <= kMaxHl && mode >= kRnn &&
         mode <= kGru && cluster >= 1 && cluster <= slice::kMaxCluster;
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU; wx1/wx2 and the gate series of gates the mode
// lacks are ignored. V: every block's slice of every local rank's column
// blocks (ops/fused_tp_ann.py `_pack_slices`). slots/flags: host arrays of
// P device pointers, every rank's slots ([2][B][Hg] elements) and zeroed
// counters ([P][groups][2] u32). c_out non-null (with z_out, and r_out for
// the GRU) writes the gate series. bf16 selects the bf16-stream mode (V,
// the slots, y_out and the gate series bf16; wx bf16 where wx_bf16, else
// float); y0f is float in either mode. cluster, rows, resident: the plan
// the wrapper packed V for.
extern "C" int sparch_tp_ann_fwd(
    const void* wx0, const void* wx1, const void* wx2, const void* V,
    const float* y0f, void* y_out, void* z_out, void* r_out, void* c_out,
    void* const* slots, unsigned* const* flags, int B, int T, int Hg, int P,
    int rank0, int n_local, int ld, int mode, int bf16, int wx_bf16,
    int cluster, int rows, int resident, int* plan, void* stream) {
  if (!shape_ok(B, Hg, P, mode, cluster) || T <= 0 || n_local < 1 ||
      rank0 < 0 || rank0 + n_local > P || !wx0 || (mode >= kLigru && !wx1) ||
      (mode == kGru && !wx2) || !V || !y0f || !y_out ||
      (mode >= kLigru && ((z_out == nullptr) != (c_out == nullptr))) ||
      (mode == kGru && ((r_out == nullptr) != (c_out == nullptr))) ||
      (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const slice::Plan pl = fwd_plan(B, Hg, P, cluster, mode, bf16);
  if (rows != pl.rows || resident != pl.resident ||
      !runs(pl, mode == kRnn ? 1 : 2, bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  Args p{};
  if (!tp::make_peers(slots, flags, P, &p.peers)) {
    return (int)cudaErrorInvalidValue;
  }
  p.wx[0] = wx0;
  p.wx[1] = wx1;
  p.wx[2] = wx2;
  p.V = V;
  p.y0f = y0f;
  p.y_out = y_out;
  p.z_out = z_out;
  p.r_out = r_out;
  p.c_out = mode == kRnn ? nullptr : c_out;
  p.B = B;
  p.T = T;
  p.Hg = Hg;
  p.Hl = Hg / P;
  p.ld = ld;
  p.wx_bf16 = wx_bf16;
  p.plan = pl;
  const Kernel kernel = kernel_for(mode, bf16);
  int max = 0;
  const int per_rank = clusters_per_rank(kernel, pl, n_local, &max);
  if (max < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidConfiguration;
  }
  if (per_rank == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.lay = tp::Layout{P, rank0, n_local, per_rank, pl.clusters};
  report(plan, pl, per_rank, max);
  const cudaError_t err = launch(kernel, pl, n_local * per_rank, p,
                                 static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of the forward's plan at `cluster` blocks the card
// holds at once (cudaOccupancyMaxActiveClusters); -1 where the plan does
// not run or the query fails.
extern "C" int sparch_tp_ann_fwd_max_clusters(int B, int Hg, int P, int mode,
                                              int bf16, int cluster) {
  if (!shape_ok(B, Hg, P, mode, cluster)) return -1;
  const slice::Plan pl = fwd_plan(B, Hg, P, cluster, mode, bf16);
  if (!runs(pl, mode == kRnn ? 1 : 2, bf16)) return -1;
  return slice::max_active_clusters(kernel_for(mode, bf16), pl);
}
