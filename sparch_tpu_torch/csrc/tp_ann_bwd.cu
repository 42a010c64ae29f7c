// Tensor-parallel fused non-spiking cell, backward, for Hopper (sm_90a):
// reverse-time BPTT of the sigmoid RNN, the LiGRU and the GRU over the
// neuron-sharded layout of tp_ann_fwd.cu.
//
// Replaces: sparch_tpu/ops/pallas_tp_ann.py `_tp_ann_bwd_kernel` (:326,
// through `_tp_ann_backward` :458), in its two stream modes (BF): float32,
// and the TPU kernel's mxu_bf16 mode (below). With G_t the total adjoint of
// y_t (the output cotangent plus what step t+1 carries back) and y_p =
// y_{t-1} (y0 at the first step), rank r walks t = T..1 on its block
// (V*row = V*[shard, :], so x_full @ V*row^T is the rank's columns of
// x_full @ V*^T):
//   RNN:   dpre = G*y_t*(1-y_t)
//          gather dpre                          -> D = dpre_full @ Vrow^T
//   LiGRU: dcpre = c > 0 ? G*(1-z) : 0;  dzpre = G*(y_p-c)*z*(1-z)
//          one gather of [dcpre|dzpre]          -> D = G*z + dcpre_full @
//                                                  Vrow^T + dzpre_full @
//                                                  Vzrow^T
//   GRU:   dcpre = G*(1-z)*(1-c^2);  dzpre = G*(y_p-c)*z*(1-z)
//          one gather of [dcpre|dzpre] (2s)     -> dry = dcpre_full @ Vrow^T
//          drpre = dry*y_p*r*(1-r)
//          gather drpre (exchange 2s + 1)       -> D = G*z + dry*r +
//                                                  dzpre_full @ Vzrow^T +
//                                                  drpre_full @ Vrrow^T
//   dWx_t = dpre per gate;  dy0 = G_0 (the D after the last step walked)
// with s = T-1-t. The GRU's dry feeds drpre within the step: the inherent
// critical-path product (pallas_tp_ann.py:33-36); its two exchanges land on
// fixed parities with the value chain as backpressure, as in the forward.
// Every step, t = 1 included (its products give dy0), exchanges.
//
// Departures from the JAX kernel, its sums unchanged:
// - No interleaved row-shard stacks: the JAX kernel gathers [dcpre|dzpre]
//   (and [dzpre|drpre]) into one plane and takes one dot against the
//   interleaved [Vrow|Vzrow] stack. Here a stacked gather is one exchange of
//   two planes side by side, and each gate's product runs on its own,
//   summing over the Hg gathered columns in ascending order; the GRU
//   gathers dzpre with dcpre (both are ready before dry), as
//   fused_ann_bwd.cu does, and drpre alone; the terms of D are added in
//   fused_ann_bwd.cu's order (G*z + dry*r + dz-term + dr-term). D, dWx and
//   dy0 are therefore those of the single-card kernel without the affine and
//   the dropout, bit for bit, at every P.
// - dV is not accumulated per step by outer products: it is the product of
//   fused_ann_bwd.cu after the time loop (dv_product.cuh `dv_kernel`),
//   dV = sum over (b, t) of y_p^T dpre per gate ((r*y_p)^T dcpre for the
//   GRU's candidate), over the y series and the dWx series. In the one-card
//   form the ranks' dWx blocks side by side are the gathered dpre series,
//   so the product runs over the full tensors. Across cards a rank would
//   need the y and gate series gathered (ROADMAP queue 1 item 7c); that form
//   is not written and the entry point refuses n_local < P.
//
// What bounds it on this card: operations. Per step and gate a dense (B,
// Hg) x (Hg, Hl) product per rank, 2*B*Hg*Hg FLOP over all ranks, T times
// in sequence, and dV another 2*B*T*Hg*Hg per gate: at (128, 100, 1024)
// the GRU does 161 GFLOP, 2.40 ms at the float32 peak outside the tensor
// cores, against ~470 MB of streams (0.14 ms at HBM rate). As in the
// forward, a cluster reads its rank's blocks of V^T once a step for its R
// rows; the time loop is left with issue slots and the exchanges on the
// chain, and dV is a third of the time (PERF.md §6).
//
// bf16 mode (the JAX kernel's mxu_bf16: sdt bf16, pallas_tp_ann.py:472):
// g, the residual series (y, z, r, c) and the per-gate dWx are bf16 streams,
// the packed slices of V^T are bf16, and the wire is bf16 (tp_exchange.cuh)
// with the operand rounded alike, so every dpre is rounded to bf16 as it is
// exchanged and both the adjoint products and dV see the rounded value (dWx
// is that value too: dV reads it back); dV's left operands are rounded as
// well (y0 and r*y_p; a stored y is bf16 already, :415-446), and the
// adjoint, dV and dy0 stay float32. y_p is the bf16 y series at every step
// but the first, whose y0 is float: the JAX kernel reads its float32
// boundary state at the first step of each time chunk instead; the port
// has no time chunks (the single-card fused_ann_bwd.cu reads y_p the same
// way). These are fused_ann_bwd.cu's bf16 rounding points, so the gradients
// still equal that kernel's without the affine and the dropout, at every P.
//
// Design: the time loop is tp_ann_fwd.cu's in reverse, as fused_ann_bwd.cu
// is fused_ann_fwd.cu's (tp_ann.cuh): a cluster of C blocks owns R rows of
// one rank, block k the (Hg, Hs) slice of the rank's blocks of V^T, Vz^T,
// Vr^T, thread (tx, ty) neuron k*Hs + tx for kRt rows with the carried
// adjoint in registers. A step exchanges each gate's dpre and runs its
// adjoint products in passes: RNN dpre on operand parity s & 1, then V^T;
// LiGRU [dcpre | dzpre] on parity s & 1, then [V^T | Vz^T]; GRU [dcpre |
// dzpre] on parity 0, then [V^T | Vz^T] (dry and the z term), drpre on
// parity 1, then Vr^T. The GRU's parity 1 holds one plane, so a block
// holds three planes of gathered rows, not four: at P = 2 that takes H up
// to 4096. The slot parities are the exchange indices' (RNN,
// LiGRU s & 1; GRU 0, then 1). At P = 1 this is fused_ann_bwd.cu's time
// loop without the affine and the dropout. No atomics; dV's splits are
// added in a fixed order (sum_parts_kernel): two runs give the same bits.
//
// C interface, bound with ctypes: sparch_tp_ann_bwd checks the plan it is
// given (cluster, rows, resident) against its own at that cluster size,
// enqueues the kernels on the stream, returns the first launch error (or
// an invalid-value error for arguments it does not take) and never
// synchronises, unless it is given split_ms: then it records CUDA events
// around each launch, waits for them and writes the milliseconds of the
// time loop, the dV product (the sum of its splits included) and 0 (the
// other backwards' second passes; this one has none). `plan` (host
// memory, may be null) receives the time loop's plan (tp_ann::report).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dv_product.cuh"
#include "tp_ann.cuh"

namespace {

using namespace sparch;
using namespace sparch::tp_ann;

// Streams, slices and slots are float, or bf16 in the bf16 mode.
struct Args {
  const void* g;       // (B, T, ld)
  const void* y_seq;   // the forward's residual series, (B, T, ld)
  const void* z;
  const void* r;
  const void* c;
  const void* VT;      // the packed slices of V*^T, [P][cluster][passes]
  const float* y0;     // (B, ld)
  void* dwx[3];        // (B, T, ld) by gate
  float* dy0;          // (B, ld)
  tp::Peers peers;     // slots: per rank [2][B][W] elements
  tp::Layout lay;
  int B, T, Hg, Hl, ld, W;
  slice::Plan plan;
};

template <int MODE, bool BF>
__global__ void __launch_bounds__(slice::kMaxThreads, 1)
tp_ann_bwd_kernel(const __grid_constant__ Args p) {
  using ST = typename Elem<BF>::type;  // streams, slices, wire
  constexpr int G = MODE + 1;
  constexpr int NA = MODE == kRnn ? 1 : 2;  // gates of the first pass
  constexpr int PL = MODE == kRnn ? 1 : 2;  // operands of a parity
  // operand planes: two parities of PL, but the GRU's second parity holds
  // drpre alone
  constexpr int OPS = MODE == kGru ? 3 : 2 * PL;
  // the OPS [j][row] operands (R*Hg floats each), then the resident slice
  // or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const tp::Layout& l = p.lay;
  const int Hg = p.Hg, T = p.T, R = pl.rows, Hs = pl.cols, C = pl.cluster;
  const int k = (int)(blockIdx.x % C);
  const int cl = (int)(blockIdx.x / C);
  const int local = cl / l.per_rank;
  const int first = cl % l.per_rank;
  const size_t RH = (size_t)R * Hg;

  const int tx = threadIdx.x % Hs;
  const int ty_raw = threadIdx.x / Hs;
  const bool thread_live = ty_raw < R / kRt;
  const int ry0 = thread_live ? ty_raw * kRt : 0;
  const int col = k * Hs + tx;
  const size_t scol = (size_t)local * p.Hl + col;
  Site x;
  x.peers = &p.peers;
  x.lay = &l;
  x.rank = l.rank0 + local;
  x.gcol = x.rank * p.Hl + col;
  x.B = p.B;
  x.Hg = Hg;
  x.Hl = p.Hl;
  x.W = p.W;
  x.R = R;
  x.C = C;
  x.live = thread_live && col < p.Hl;

  const int gates[2] = {NA, MODE == kGru ? 1 : 0};
  const int walks = (l.n_groups - first + l.per_rank - 1) / l.per_rank;
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.VT) + ((size_t)local * C + k) * G * Hg * Hs,
      reinterpret_cast<ST*>(smem + OPS * RH), full, pl, Hg, Hs, gates,
      walks * T);
  slice::begin(s);
  const ST* g_in = static_cast<const ST*>(p.g);
  const ST* y_seq = static_cast<const ST*>(p.y_seq);
  const ST* z_in = static_cast<const ST*>(p.z);
  const ST* r_in = static_cast<const ST*>(p.r);
  const ST* c_in = static_cast<const ST*>(p.c);

  for (int w = 0; w < walks; ++w) {
    x.group = first + w * l.per_rank;
    x.row_base = x.group * R;
    x.row0 = x.row_base + ry0;
    float D[kRt];
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      x.rowlive[r] = thread_live && x.row0 + r < p.B;
      D[r] = 0.f;
    }
    // every block of the cluster runs, and is done with the group before,
    // before any stores into it
    slice::cluster_barrier();
    if (w == 0) slice::await_resident(s);

    for (int t = T - 1; t >= 0; --t) {
      const int step = T - 1 - t;
      const int par = step & 1;
      float Gt[kRt], yp[kRt], z[kRt], rr[kRt], c[kRt];
      float dpre[G][kRt];
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        const bool ok = x.live && x.rowlive[r];
        const size_t row = (size_t)(x.row0 + r);
        const size_t at = (row * T + t) * p.ld + scol;
        Gt[r] = (ok ? to_float(g_in[at]) : 0.f) + D[r];
        if constexpr (MODE == kRnn) {
          const float y_t = ok ? to_float(y_seq[at]) : 0.f;
          dpre[0][r] = Gt[r] * y_t * (1.0f - y_t);
        } else {
          yp[r] = !ok ? 0.f
                      : (t > 0 ? to_float(y_seq[at - p.ld])
                               : p.y0[row * p.ld + scol]);
          z[r] = ok ? to_float(z_in[at]) : 0.f;
          c[r] = ok ? to_float(c_in[at]) : 0.f;
          const float omz = 1.0f - z[r];
          dpre[1][r] = Gt[r] * (yp[r] - c[r]) * z[r] * omz;
          if constexpr (MODE == kLigru) {
            dpre[0][r] = c[r] > 0.f ? Gt[r] * omz : 0.f;
          } else {
            rr[r] = ok ? to_float(r_in[at]) : 0.f;
            dpre[0][r] = Gt[r] * omz * (1.0f - c[r] * c[r]);
          }
        }
      }
      // the GRU's [dcpre | dzpre] on parity 0 (exchange 2s), the others'
      // dpre on par (exchange s)
      float* op = smem + (size_t)(MODE == kGru ? 0 : par) * PL * RH;
      const int e = MODE == kGru ? 2 * step : step;
      put<BF, ST>(x, op, 0, e, dpre[0]);
      if constexpr (MODE != kRnn) put<BF, ST>(x, op, 1, e, dpre[1]);
      exchange<ST>(x, op, PL, e);
      float a[NA][kRt];
#pragma unroll
      for (int g = 0; g < NA; ++g) {
#pragma unroll
        for (int r = 0; r < kRt; ++r) a[g][r] = 0.f;
      }
      // dpre_0 @ V^T [, dpre_1 @ Vz^T]
      slice::pass<NA, NA == 1>(s, 0, op + ry0, (int)RH, R, tx, Hs, a);
      float a2[1][kRt] = {};
      if constexpr (MODE == kGru) {
        // a[0] is dry, the adjoint of r*y_p
#pragma unroll
        for (int r = 0; r < kRt; ++r) {
          dpre[2][r] = a[0][r] * yp[r] * rr[r] * (1.0f - rr[r]);
        }
        float* op1 = smem + PL * RH;
        put<BF, ST>(x, op1, 0, 2 * step + 1, dpre[2]);
        exchange<ST>(x, op1, 1, 2 * step + 1);
        slice::pass<1, true>(s, 1, op1 + ry0, 0, R, tx, Hs, a2);  // @ Vr^T
      }
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        if constexpr (MODE == kRnn) {
          D[r] = a[0][r];
        } else if constexpr (MODE == kLigru) {
          D[r] = Gt[r] * z[r] + a[0][r] + a[1][r];
        } else {
          D[r] = Gt[r] * z[r] + a[0][r] * rr[r] + a[1][r] + a2[0][r];
        }
        if (!(x.live && x.rowlive[r])) continue;
        const size_t at = ((size_t)(x.row0 + r) * T + t) * p.ld + scol;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dpre[g][r]);
        }
      }
    }
    if (!x.live) continue;
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      if (x.rowlive[r]) p.dy0[(size_t)(x.row0 + r) * p.ld + scol] = D[r];
    }
  }
}

using Kernel = void (*)(Args);

template <int MODE>
Kernel kernel_of(int bf16) {
  return bf16 ? tp_ann_bwd_kernel<MODE, true> : tp_ann_bwd_kernel<MODE, false>;
}

Kernel kernel_for(int mode, int bf16) {
  switch (mode) {
    case kRnn: return kernel_of<kRnn>(bf16);
    case kLigru: return kernel_of<kLigru>(bf16);
    default: return kernel_of<kGru>(bf16);
  }
}

slice::Plan bwd_plan(int B, int Hg, int P, int cluster, int mode, int bf16) {
  return rank_plan(B, Hg, P, cluster, mode + 1, bf16, mode == kRnn ? 1 : 2,
                   mode == kGru ? 3 : 0);
}

bool shape_ok(int B, int Hg, int P, int mode, int cluster) {
  return B > 0 && P >= 1 && P <= tp::kMaxRanks && Hg > 0 && Hg % P == 0 &&
         (Hg / P) % kColUnit == 0 && Hg / P <= kMaxHl && mode >= kRnn &&
         mode <= kGru && cluster >= 1 && cluster <= slice::kMaxCluster;
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU; operands of gates the mode lacks are
// ignored. VT: every block's slice of every rank's blocks of the
// transposed matrices (ops/fused_tp_ann.py `_pack_slices`). slots/flags:
// host arrays of P device pointers, every rank's slots ([2][B][W]
// elements, W = Hg for the RNN, 2*Hg for the stacked gathers) and zeroed
// counters ([P][groups][2] u32). dV (gates, Hg, Hg) and dv_partials
// (ksplit, gates, Hg, Hg; unused and may be null at ksplit 1) receive the
// dV product, in the tile dv_tile (dv_product.cuh `dv_tile`). bf16
// selects the bf16-stream mode (g, the series, VT, the slots and dwx
// bf16); y0, dV and dy0 are float in either mode. cluster, rows,
// resident: the plan the wrapper packed VT for. split_ms: null, or three
// floats of host memory (see above).
extern "C" int sparch_tp_ann_bwd(
    const void* g, const void* y_seq, const void* z, const void* r,
    const void* c, const void* VT, const float* y0, void* dwx0, void* dwx1,
    void* dwx2, float* dV, float* dv_partials, float* dy0,
    void* const* slots, unsigned* const* flags, int B, int T, int Hg, int P,
    int rank0, int n_local, int ld, int mode, int ksplit, int dv_tile,
    int bf16,
    int cluster, int rows, int resident, float* split_ms, int* plan,
    void* stream) {
  void* dwx[3] = {dwx0, dwx1, dwx2};
  if (!shape_ok(B, Hg, P, mode, cluster) || T <= 0 || rank0 != 0 ||
      n_local != P || ld != Hg || ksplit < 1 || !g || !y_seq || !VT || !y0 ||
      !dV || (ksplit > 1 && !dv_partials) || !dy0 ||
      (mode >= kLigru && (!z || !c)) || (mode == kGru && !r) ||
      !dv_tile_ok(dv_tile, Hg, mode + 1, ksplit)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = mode + 1;
  for (int k = 0; k < G; ++k) {
    if (!dwx[k]) return (int)cudaErrorInvalidValue;
  }
  const slice::Plan pl = bwd_plan(B, Hg, P, cluster, mode, bf16);
  if (rows != pl.rows || resident != pl.resident ||
      !runs(pl, mode == kRnn ? 1 : 2, bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  Args p{};
  if (!tp::make_peers(slots, flags, P, &p.peers)) {
    return (int)cudaErrorInvalidValue;
  }
  p.g = g;
  p.y_seq = y_seq;
  p.z = z;
  p.r = r;
  p.c = c;
  p.VT = VT;
  p.y0 = y0;
  for (int k = 0; k < 3; ++k) p.dwx[k] = dwx[k];
  p.dy0 = dy0;
  p.B = B;
  p.T = T;
  p.Hg = Hg;
  p.Hl = Hg / P;
  p.ld = ld;
  p.W = mode == kRnn ? Hg : 2 * Hg;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Split split(split_ms != nullptr);
  split.mark(0, st);
  int err = (int)launch(kernel, pl, n_local * per_rank, p, st);
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(1, st);

  // dV over the full y series and the ranks' dWx blocks (the gathered dpre)
  const DvArgs a{y_seq, y0, mode == kGru ? r : nullptr, {dwx0, dwx1, dwx2},
                 nullptr, 0.f, T, Hg, B * T,
                 dv_rows_per_split(B * T, ksplit), G, 0};
  err = (int)(bf16 ? launch_dv<false, __nv_bfloat16>(a, dV, dv_partials,
                                                     dv_tile, ksplit, st)
                   : launch_dv<false, float>(a, dV, dv_partials, dv_tile,
                                             ksplit, st));
  if (err != 0) return err;
  split.mark(2, st);
  split.mark(3, st);
  split.report(split_ms, 3);
  return (int)cudaGetLastError();
}

// How many clusters of the backward time loop's plan at `cluster` blocks
// the card holds at once (cudaOccupancyMaxActiveClusters); -1 where the
// plan does not run or the query fails.
extern "C" int sparch_tp_ann_bwd_max_clusters(int B, int Hg, int P, int mode,
                                              int bf16, int cluster) {
  if (!shape_ok(B, Hg, P, mode, cluster)) return -1;
  const slice::Plan pl = bwd_plan(B, Hg, P, cluster, mode, bf16);
  if (!runs(pl, mode == kRnn ? 1 : 2, bf16)) return -1;
  return slice::max_active_clusters(kernel_for(mode, bf16), pl);
}
