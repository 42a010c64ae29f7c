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
//          gather dcpre (exchange 2s)           -> dry = dcpre_full @ Vrow^T
//          drpre = dry*y_p*r*(1-r)
//          one gather of [dzpre|drpre] (2s + 1) -> D = G*z + dry*r +
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
//   interleaved [Vrow|Vzrow] stack. Here the stacked gather is one exchange
//   of two planes side by side, and each gate's product runs on its own,
//   summing over the Hg gathered columns in ascending order; the terms of D
//   are then added in fused_ann_bwd.cu's order (G*z + dry*r + dz-term +
//   dr-term). D, dWx and dy0 are therefore those of the single-card kernel
//   without the affine and the dropout, bit for bit, at every P.
// - dV is not accumulated per step by outer products: it is the product of
//   fused_ann_bwd.cu after the time loop (dv_product.cuh `ann_dv_kernel`),
//   dV = sum over (b, t) of y_p^T dpre per gate ((r*y_p)^T dcpre for the
//   GRU's candidate), over the y series and the dWx series. In the one-card
//   form the ranks' dWx blocks side by side are the gathered dpre series,
//   so the product runs over the full tensors. Across cards a rank would
//   need the gathered dpre series (ROADMAP queue 1 item 7); that form is not
//   written and the entry point refuses n_local < P.
//
// What bounds it on this card: operations. Per step and gate a dense (B,
// Hg) x (Hg, Hl) product per rank, 2*B*Hg*Hg FLOP over all ranks, T times
// in sequence, and dV another 2*B*T*Hg*Hg per gate: at (128, 100, 1024)
// the GRU does 161 GFLOP, 2.40 ms at the float32 peak outside the tensor
// cores, against ~470 MB of streams (0.14 ms at HBM rate).
//
// bf16 mode (the JAX kernel's mxu_bf16: sdt bf16, pallas_tp_ann.py:472):
// g, the residual series (y, z, r, c) and the per-gate dWx are bf16 streams,
// the packed blocks of V^T are bf16, and the wire is bf16 (tp_exchange.cuh),
// so every dpre is rounded to bf16 as it is staged and both the adjoint
// products and dV see the rounded value (dWx is that value too: dV reads
// it back); dV's left operands are rounded as well (y0 and r*y_p; a stored y
// is bf16 already, :415-446), and the adjoint, dV and dy0 stay float32.
// y_p is the bf16 y series at every step but the first, whose y0 is float:
// the JAX kernel reads its float32 boundary state at the first step of each
// time chunk instead; the port has no time chunks (the single-card
// fused_ann_bwd.cu reads y_p the same way). These are fused_ann_bwd.cu's
// bf16 rounding points, so the gradients still equal that kernel's without
// the affine and the dropout, at every P.
//
// Design: tp_ann_fwd.cu's in reverse. A block runs one rank's neurons for
// BT batch rows and walks row groups; each gate's gathered dpre rows lie in
// shared memory as [j][row] (two planes for the stacked gathers); the
// rank's blocks of V^T, Vz^T, Vr^T (packed per rank by the wrapper in that
// order) stream from L2 in 64 KB tiles (tile_stream.cuh), summed in
// ascending order with FMAs. No atomics; dV's splits are added in a fixed
// order (sum_parts_kernel): two runs give the same bits.
//
// C interface, bound with ctypes: sparch_tp_ann_bwd enqueues the kernels on
// the stream, returns cudaGetLastError() (or an invalid-value error for
// arguments it does not take) and never synchronises. `plan` (host memory,
// may be null) receives {BT, blocks per rank, blocks per SM, threads}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dv_product.cuh"
#include "tp_ann.cuh"

namespace {

using namespace sparch;
using namespace sparch::tp_ann;
using sparch::tp::Layout;
using sparch::tp::Peers;

// Streams, matrices and slots are float, or bf16 in the bf16 mode.
struct BwdArgs {
  const void* g;       // (B, T, ld)
  const void* y_seq;   // the forward's residual series, (B, T, ld)
  const void* z;
  const void* r;
  const void* c;
  const void* VT;      // [n_local][G][Hg][Hl]: the packed blocks of V*^T
  const float* y0;     // (B, ld)
  void* dwx[3];        // (B, T, ld) by gate
  float* dy0;          // (B, ld)
  Peers peers;         // slots: per rank [2][B][W] elements
  Layout lay;
  int B, T, Hg, Hl, ld, W;
};

template <int MODE, int NPT, int BT, bool BF>
__global__ void __launch_bounds__(kThreads)
tp_ann_bwd_kernel(const BwdArgs p) {
  using ST = typename Elem<BF>::type;  // streams, matrices, wire
  constexpr int G = MODE + 1;
  constexpr int PLANES = MODE == kRnn ? 1 : 2;
  // dynamic shared memory: PLANES left operands of Hg*BT floats, then the
  // stream's stages
  extern __shared__ __align__(16) float pub[];
  __shared__ uint64_t full[kStages];
  const Layout& l = p.lay;
  const int Hg = p.Hg, Hl = p.Hl, T = p.T, ld = p.ld, W = p.W;
  const int local = tp::local_rank(l);
  const int blk = tp::block_in_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * Hl;
  const int my_groups = (l.n_groups - blk + l.per_rank - 1) / l.per_rank;
  float* pub1 = pub + Hg * BT;
  TileStream<ST> s = block_stream(
      static_cast<const ST*>(p.VT) + (size_t)local * G * Hg * Hl,
      reinterpret_cast<ST*>(pub + PLANES * Hg * BT), full, Hg, Hl, G,
      my_groups * T);

  int col[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) col[i] = threadIdx.x + i * blockDim.x;
  stream_open(s);

  for (int grp = blk; grp < l.n_groups; grp += l.per_rank) {
    const int row0 = grp * BT;
    float D[NPT][BT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) D[i][r] = 0.f;
    }
    for (int t = T - 1; t >= 0; --t) {
      const int step = T - 1 - t;
      float Gt[NPT][BT], yp[NPT][BT], z[NPT][BT], rr[NPT][BT], c[NPT][BT];
      float dpre[G][NPT][BT], acc[G][NPT][BT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const size_t row = (size_t)(row0 + r);
          const size_t at = (row * T + t) * ld + col0 + col[i];
          Gt[i][r] = to_float(static_cast<const ST*>(p.g)[at]) + D[i][r];
          if constexpr (MODE == kRnn) {
            const float y_t = to_float(static_cast<const ST*>(p.y_seq)[at]);
            dpre[0][i][r] = Gt[i][r] * y_t * (1.0f - y_t);
          } else {
            yp[i][r] =
                t > 0 ? to_float(static_cast<const ST*>(p.y_seq)[at - ld])
                      : p.y0[row * ld + col0 + col[i]];
            z[i][r] = to_float(static_cast<const ST*>(p.z)[at]);
            c[i][r] = to_float(static_cast<const ST*>(p.c)[at]);
            const float omz = 1.0f - z[i][r];
            dpre[1][i][r] = Gt[i][r] * (yp[i][r] - c[i][r]) * z[i][r] * omz;
            if constexpr (MODE == kLigru) {
              dpre[0][i][r] = c[i][r] > 0.f ? Gt[i][r] * omz : 0.f;
            } else {
              rr[i][r] = to_float(static_cast<const ST*>(p.r)[at]);
              dpre[0][i][r] = Gt[i][r] * omz * (1.0f - c[i][r] * c[i][r]);
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][i][r] = 0.f;
        }
      }
      if constexpr (MODE == kGru) {
        // dcpre alone (plane 0, parity 0): dry feeds drpre within the step
        to_peers<ST, NPT, BT>(p.peers, l.P, p.B, W, 0, row0, rank * Hl,
                              dpre[0], col);
        tp::exchange(p.peers, l, rank, grp, 2 * step);
        from_slot<ST, BT>(pub, p.peers.slots[rank], p.B, W, 0, row0, Hg, 1);
        stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // dry
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            dpre[2][i][r] =
                acc[0][i][r] * yp[i][r] * rr[i][r] * (1.0f - rr[i][r]);
          }
        }
        // [dzpre|drpre] (planes 0 and 1, parity 1)
        to_peers<ST, NPT, BT>(p.peers, l.P, p.B, W, 1, row0, rank * Hl,
                              dpre[1], col);
        to_peers<ST, NPT, BT>(p.peers, l.P, p.B, W, 1, row0, Hg + rank * Hl,
                              dpre[2], col);
        tp::exchange(p.peers, l, rank, grp, 2 * step + 1);
        from_slot<ST, BT>(pub, p.peers.slots[rank], p.B, W, 1, row0, Hg, 2);
        stream_matrix<NPT, BT>(s, pub, col, acc[1]);   // @ Vzrow^T
        stream_matrix<NPT, BT>(s, pub1, col, acc[2]);  // @ Vrrow^T
      } else {
        const int parity = step & 1;
        to_peers<ST, NPT, BT>(p.peers, l.P, p.B, W, parity, row0, rank * Hl,
                              dpre[0], col);
        if constexpr (MODE == kLigru) {
          to_peers<ST, NPT, BT>(p.peers, l.P, p.B, W, parity, row0,
                                Hg + rank * Hl, dpre[1], col);
        }
        tp::exchange(p.peers, l, rank, grp, step);
        from_slot<ST, BT>(pub, p.peers.slots[rank], p.B, W, parity, row0, Hg,
                          PLANES);
        stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // @ Vrow^T
        if constexpr (MODE == kLigru) {
          stream_matrix<NPT, BT>(s, pub1, col, acc[1]);  // @ Vzrow^T
        }
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          if constexpr (MODE == kRnn) {
            D[i][r] = acc[0][i][r];
          } else if constexpr (MODE == kLigru) {
            D[i][r] = Gt[i][r] * z[i][r] + acc[0][i][r] + acc[1][i][r];
          } else {
            D[i][r] = Gt[i][r] * z[i][r] + acc[0][i][r] * rr[i][r] +
                      acc[1][i][r] + acc[2][i][r];
          }
          const size_t at =
              ((size_t)(row0 + r) * T + t) * ld + col0 + col[i];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dpre[g][i][r]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        p.dy0[(size_t)(row0 + r) * ld + col0 + col[i]] = D[i][r];
      }
    }
  }
}

template <int MODE, int NPT, bool BF>
int launch_npt(BwdArgs& p, int* plan, cudaStream_t st) {
  constexpr int PLANES = MODE == kRnn ? 1 : 2;
  const int threads = p.Hl / NPT;
  const int n_local = p.lay.n_local;
  tp::Plan best{0, 0, 0, 0};
  bool fit = false;
  try_plan<1>(tp_ann_bwd_kernel<MODE, NPT, 1, BF>, threads, PLANES, p.Hg,
              p.B, n_local, best, fit);
  try_plan<2>(tp_ann_bwd_kernel<MODE, NPT, 2, BF>, threads, PLANES, p.Hg,
              p.B, n_local, best, fit);
  if constexpr (NPT * 4 <= kMaxWork) {
    try_plan<4>(tp_ann_bwd_kernel<MODE, NPT, 4, BF>, threads, PLANES, p.Hg,
                p.B, n_local, best, fit);
  }
  if constexpr (NPT * 8 <= kMaxWork) {
    try_plan<8>(tp_ann_bwd_kernel<MODE, NPT, 8, BF>, threads, PLANES, p.Hg,
                p.B, n_local, best, fit);
  }
  if (best.bt == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.lay.per_rank = best.per_rank;
  p.lay.n_groups = p.B / best.bt;
  if (plan) {
    plan[0] = best.bt;
    plan[1] = best.per_rank;
    plan[2] = best.per_sm;
    plan[3] = threads;
  }
  const int blocks = n_local * best.per_rank;
  cudaError_t err = cudaErrorInvalidValue;
  switch (best.bt) {
    case 1:
      err = tp::launch_cooperative(tp_ann_bwd_kernel<MODE, NPT, 1, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 2:
      err = tp::launch_cooperative(tp_ann_bwd_kernel<MODE, NPT, 2, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 4:
      if constexpr (NPT * 4 <= kMaxWork) {
        err = tp::launch_cooperative(tp_ann_bwd_kernel<MODE, NPT, 4, BF>,
                                     blocks, threads, best.smem, p, st);
      }
      break;
    default:
      if constexpr (NPT * 8 <= kMaxWork) {
        err = tp::launch_cooperative(tp_ann_bwd_kernel<MODE, NPT, 8, BF>,
                                     blocks, threads, best.smem, p, st);
      }
      break;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int MODE, bool BF>
int launch_mode(BwdArgs& p, int npt, int* plan, cudaStream_t st) {
  switch (npt) {
    case 1: return launch_npt<MODE, 1, BF>(p, plan, st);
    case 2: return launch_npt<MODE, 2, BF>(p, plan, st);
    default: return launch_npt<MODE, 4, BF>(p, plan, st);
  }
}

template <bool BF>
int launch_form(BwdArgs& p, int mode, int npt, int* plan, cudaStream_t st) {
  switch (mode) {
    case kRnn: return launch_mode<kRnn, BF>(p, npt, plan, st);
    case kLigru: return launch_mode<kLigru, BF>(p, npt, plan, st);
    default: return launch_mode<kGru, BF>(p, npt, plan, st);
  }
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU; operands of gates the mode lacks are
// ignored. VT: the packed blocks of the transposed matrices,
// [P][gates][Hg][Hl] in gate order. slots/flags: host arrays of P device
// pointers, every rank's slots ([2][B][W] floats, W = Hg for the RNN, 2*Hg
// for the stacked gathers) and zeroed counters ([P][B][2] u32). dV (gates,
// Hg, Hg) and dv_partials (ksplit, gates, Hg, Hg) receive the dV product.
// bf16 selects the bf16-stream mode (g, the series, VT, the slots and dwx
// bf16); y0, dV and dy0 are float in either mode.
extern "C" int sparch_tp_ann_bwd(
    const void* g, const void* y_seq, const void* z, const void* r,
    const void* c, const void* VT, const float* y0, void* dwx0, void* dwx1,
    void* dwx2, float* dV, float* dv_partials, float* dy0,
    void* const* slots, unsigned* const* flags, int B, int T, int Hg, int P,
    int rank0, int n_local, int ld, int mode, int ksplit, int bf16,
    int* plan, void* stream) {
  void* dwx[3] = {dwx0, dwx1, dwx2};
  if (B <= 0 || B % 8 != 0 || T <= 0 || P < 1 || P > tp::kMaxRanks ||
      Hg <= 0 || Hg % (P * 128) != 0 || Hg / P > kThreads * kMaxNpt ||
      rank0 != 0 || n_local != P || ld != Hg || mode < kRnn || mode > kGru ||
      ksplit < 1 || !g || !y_seq || !VT || !y0 || !dV || !dv_partials ||
      !dy0 || (mode >= kLigru && (!z || !c)) || (mode == kGru && !r)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = mode + 1;
  for (int k = 0; k < G; ++k) {
    if (!dwx[k]) return (int)cudaErrorInvalidValue;
  }
  BwdArgs p{};
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
  p.lay.P = P;
  p.lay.rank0 = rank0;
  p.lay.n_local = n_local;
  p.B = B;
  p.T = T;
  p.Hg = Hg;
  p.Hl = Hg / P;
  p.ld = ld;
  p.W = mode == kRnn ? Hg : 2 * Hg;
  int npt = 1;
  while (p.Hl / npt > kThreads) npt *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = bf16 ? launch_form<true>(p, mode, npt, plan, st)
                 : launch_form<false>(p, mode, npt, plan, st);
  if (err != 0) return err;

  // dV over the full y series and the ranks' dWx blocks (the gathered dpre)
  const int R = B * T;
  int rows_per_split = (R + ksplit - 1) / ksplit;
  rows_per_split = (rows_per_split + kBK - 1) / kBK * kBK;
  AnnDvArgs a{y_seq, y0, mode == kGru ? r : nullptr, {dwx0, dwx1, dwx2},
              dv_partials, T, Hg, R, rows_per_split, G};
  const int tiles = (Hg + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, G * ksplit);
  if (bf16) {
    ann_dv_kernel<__nv_bfloat16><<<grid, kDvThreads, 0, st>>>(a);
  } else {
    ann_dv_kernel<float><<<grid, kDvThreads, 0, st>>>(a);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = G * Hg * Hg;
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(dv_partials, dV, ksplit,
                                                    n);
  return (int)cudaGetLastError();
}
