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
// The GRU's two exchanges of a step have consecutive indices, so r*y always
// lands on parity 0 and y on parity 1 (pallas_tp_ann.py:38-44): a rank
// stores r*y of step t+1 into slot 0 only after it has waited on the y
// exchange of step t, which each peer publishes only after it has read slot
// 0 of step t (its y depends on the r*y it read); likewise y of step t+1
// into slot 1 only after the r*y exchange of step t+1, which each peer
// publishes after reading slot 1 of step t. The value chain is the
// backpressure, as in tp_exchange.cuh.
//
// What bounds it on this card: the dense products on the chain, as in
// fused_ann_fwd.cu. Every step is a (B, Hg) x (Hg, Hl) float32 product per
// gate and rank, 2*B*Hg*Hg FLOP per gate over all ranks, T steps one after
// another; the GRU has two dependent products per step with an exchange
// between them. At (128, 100, 1024) the GRU does 80.5 GFLOP (1.20 ms at the
// float32 peak outside the tensor cores); every block streams its rank's
// column blocks from L2 at every step, and each exchange is a round trip
// through L2.
//
// Design (fused_ann_fwd.cu's, per rank):
// - A block runs one rank's neurons for BT batch rows (a row group) for the
//   whole sequence and walks the groups k, k + per_rank, ... on every rank
//   alike; thread j owns the rank's neurons j + i*blockDim.x (NPT of them)
//   for the BT rows, y in registers. BT is the first of 1, 2, 4, 8 (NPT*BT
//   <= 8, shared memory allowing) at which the card holds every group of
//   every rank at once, else the plan with the most rows at work; the launch
//   is cooperative, so it never deadlocks (tp_exchange.cuh).
// - The left operand of a product (y_full or ry_full, Hg*BT floats) lies in
//   shared memory as [j][row], read back from the own slot after the
//   exchange; the rank's column blocks stream from L2 through shared memory
//   in 64 KB bulk-copy tiles (tile_stream.cuh), packed by the wrapper per
//   rank in the order a step reads them (RNN: V; LiGRU: V, Vz; GRU: Vz, Vr,
//   then V), the stream running on across steps and groups.
// - Rounding: each output column sums y_full[j]*V[j][col] over all Hg rows
//   j in ascending order with FMAs, whatever P is, and the elementwise code
//   is fused_ann_fwd.cu's without the affine: the output equals the
//   single-card kernel's, and that of every P, bit for bit.
// - Rank data: the local rank l's column block starts at column l*Hl of
//   tensors with row stride ld. In the one-card form they are the full
//   (…, H) tensors (ld = H); across cards each rank's own (ld = Hl).
// - bf16 mode (the JAX kernel's mxu_bf16: rdt/vdt bf16,
//   pallas_tp_ann.py:243-244): the packed column blocks are bf16 (rounded
//   once by the wrapper), the wire is bf16 (tp_exchange.cuh), so the
//   gathered y and r*y that feed the products are rounded to bf16 as they
//   are staged (:185, :204, :210), and so is the gathered y0 of the first
//   products (`_dot` rounds its left operand); the output and the gate
//   series are bf16 streams (:219-222), each input stream is float32 or
//   bf16 as the model emitted it, and the carried y stays float32 (:172,
//   :208, :224). A product of two bf16 values is exact in float32, so the
//   sums are those of a bf16 product with a float32 accumulator. These are
//   the rounding points of fused_ann_fwd.cu's bf16 mode, so the output still
//   equals that kernel's without the affine and the dropout, at every P.
//
// C interface, bound with ctypes: sparch_tp_ann_fwd returns the launch's
// cudaError_t (or an invalid-value error for arguments it does not take)
// and never synchronises. `plan` (host memory, may be null) receives {BT,
// blocks per rank, blocks per SM, threads}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tp_ann.cuh"

namespace {

using namespace sparch;
using namespace sparch::tp_ann;
using sparch::tp::Layout;
using sparch::tp::Peers;

// Streams, matrices and slots are float, or bf16 in the bf16 mode; wx is
// float or bf16 there, as wx_bf16 says.
struct FwdArgs {
  const void* wx[3];   // (B, T, ld) by gate
  const void* V;       // [n_local][G][Hg][Hl]: the packed column blocks
  const float* y0f;    // (B, Hg): the gathered initial state
  void* y_out;         // (B, T, ld)
  void* z_out;         // the gate series, (B, T, ld); null: serving form
  void* r_out;
  void* c_out;
  Peers peers;         // slots: per rank [2][B][Hg] elements
  Layout lay;
  int B, T, Hg, Hl, ld;
};

// The bf16 mode's one more flag rides in a struct of its own, so that the
// float32 kernels' parameter block stays what it was before the mode
// existed (see fused_ann_fwd.cu).
struct FwdArgsBf16 : FwdArgs {
  int wx_bf16;  // the input streams are bf16, not float
};
template <bool BF>
struct ModeArgs {
  using type = FwdArgs;
};
template <>
struct ModeArgs<true> {
  using type = FwdArgsBf16;
};

template <int MODE, int NPT, int BT, bool BF>
__global__ void __launch_bounds__(kThreads)
tp_ann_fwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;  // streams, matrices, wire
  constexpr int G = MODE + 1;
  // dynamic shared memory: the left operand (Hg*BT floats), then the
  // stream's stages
  extern __shared__ __align__(16) float pub[];
  __shared__ uint64_t full[kStages];
  const Layout& l = p.lay;
  const int Hg = p.Hg, Hl = p.Hl, T = p.T, ld = p.ld;
  const int local = tp::local_rank(l);
  const int blk = tp::block_in_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * Hl;  // the rank's first column in rank data
  const int my_groups = (l.n_groups - blk + l.per_rank - 1) / l.per_rank;
  TileStream<ST> s = block_stream(
      static_cast<const ST*>(p.V) + (size_t)local * G * Hg * Hl,
      reinterpret_cast<ST*>(pub + Hg * BT), full, Hg, Hl, G, my_groups * T);
  const bool resid = p.c_out != nullptr;
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  int col[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) col[i] = threadIdx.x + i * blockDim.x;
  stream_open(s);

  for (int grp = blk; grp < l.n_groups; grp += l.per_rank) {
    const int row0 = grp * BT;
    float y[NPT][BT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        y[i][r] = p.y0f[(size_t)(row0 + r) * Hg + rank * Hl + col[i]];
      }
    }
    // the first left operand: the group's rows of the gathered y0 (the
    // group before left its last product behind a barrier), rounded to
    // bf16 in the bf16 mode
    for (int idx = threadIdx.x; idx < BT * Hg; idx += blockDim.x) {
      const int r = idx / Hg;
      const int j = idx - r * Hg;
      const float v = p.y0f[(size_t)row0 * Hg + idx];
      pub[j * BT + r] = BF ? round_bf16(v) : v;
    }

    for (int t = 0; t < T; ++t) {
      float d[G][NPT][BT];
      float acc[G][NPT][BT];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            d[g][i][r] = load_stream<BF>(
                p.wx[g], ((size_t)(row0 + r) * T + t) * ld + col0 + col[i],
                wx_bf16);
            acc[g][i][r] = 0.f;
          }
        }
      }
      float z[NPT][BT], rr[NPT][BT], c[NPT][BT];
      if constexpr (MODE == kGru) {
        stream_matrix<NPT, BT>(s, pub, col, acc[1]);  // y_full @ Vz[:, sh]
        stream_matrix<NPT, BT>(s, pub, col, acc[2]);  // y_full @ Vr[:, sh]
        float ry[NPT][BT];
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            z[i][r] = sigmoidf(d[1][i][r] + acc[1][i][r]);
            rr[i][r] = sigmoidf(d[2][i][r] + acc[2][i][r]);
            ry[i][r] = rr[i][r] * y[i][r];
          }
        }
        to_peers<ST, NPT, BT>(p.peers, l.P, p.B, Hg, 0, row0, rank * Hl, ry,
                              col);
        tp::exchange(p.peers, l, rank, grp, 2 * t);
        from_slot<ST, BT>(pub, p.peers.slots[rank], p.B, Hg, 0, row0, Hg, 1);
        stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // ry_full @ V[:, sh]
      } else {
        stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // y_full @ V[:, sh]
        if constexpr (MODE == kLigru) {
          stream_matrix<NPT, BT>(s, pub, col, acc[1]);  // y_full @ Vz[:, sh]
        }
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float pre = d[0][i][r] + acc[0][i][r];
          if constexpr (MODE == kRnn) {
            y[i][r] = sigmoidf(pre);
          } else {
            if constexpr (MODE == kLigru) {
              z[i][r] = sigmoidf(d[1][i][r] + acc[1][i][r]);
              c[i][r] = fmaxf(pre, 0.f);
            } else {
              c[i][r] = tanhf(pre);
            }
            y[i][r] = z[i][r] * y[i][r] + (1.0f - z[i][r]) * c[i][r];
          }
          const size_t at = ((size_t)(row0 + r) * T + t) * ld + col0 + col[i];
          static_cast<ST*>(p.y_out)[at] = from_float<ST>(y[i][r]);
          if constexpr (MODE != kRnn) {
            if (resid) {
              static_cast<ST*>(p.z_out)[at] = from_float<ST>(z[i][r]);
              static_cast<ST*>(p.c_out)[at] = from_float<ST>(c[i][r]);
              if constexpr (MODE == kGru) {
                static_cast<ST*>(p.r_out)[at] = from_float<ST>(rr[i][r]);
              }
            }
          }
        }
      }
      if (t + 1 == T) break;  // the last step's y gather would feed nothing
      const int e = MODE == kGru ? 2 * t + 1 : t;
      to_peers<ST, NPT, BT>(p.peers, l.P, p.B, Hg, e & 1, row0, rank * Hl,
                            y, col);
      tp::exchange(p.peers, l, rank, grp, e);
      from_slot<ST, BT>(pub, p.peers.slots[rank], p.B, Hg, e & 1, row0, Hg,
                        1);
    }
  }
}

template <int MODE, int NPT, bool BF>
int launch_npt(typename ModeArgs<BF>::type& p, int* plan,
               cudaStream_t st) {
  const int threads = p.Hl / NPT;
  const int n_local = p.lay.n_local;
  tp::Plan best{0, 0, 0, 0};
  bool fit = false;
  try_plan<1>(tp_ann_fwd_kernel<MODE, NPT, 1, BF>, threads, 1, p.Hg, p.B,
              n_local, best, fit);
  try_plan<2>(tp_ann_fwd_kernel<MODE, NPT, 2, BF>, threads, 1, p.Hg, p.B,
              n_local, best, fit);
  if constexpr (NPT * 4 <= kMaxWork) {
    try_plan<4>(tp_ann_fwd_kernel<MODE, NPT, 4, BF>, threads, 1, p.Hg, p.B,
                n_local, best, fit);
  }
  if constexpr (NPT * 8 <= kMaxWork) {
    try_plan<8>(tp_ann_fwd_kernel<MODE, NPT, 8, BF>, threads, 1, p.Hg, p.B,
                n_local, best, fit);
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
      err = tp::launch_cooperative(tp_ann_fwd_kernel<MODE, NPT, 1, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 2:
      err = tp::launch_cooperative(tp_ann_fwd_kernel<MODE, NPT, 2, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 4:
      if constexpr (NPT * 4 <= kMaxWork) {
        err = tp::launch_cooperative(tp_ann_fwd_kernel<MODE, NPT, 4, BF>,
                                     blocks, threads, best.smem, p, st);
      }
      break;
    default:
      if constexpr (NPT * 8 <= kMaxWork) {
        err = tp::launch_cooperative(tp_ann_fwd_kernel<MODE, NPT, 8, BF>,
                                     blocks, threads, best.smem, p, st);
      }
      break;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int MODE, bool BF>
int launch_mode(typename ModeArgs<BF>::type& p, int npt, int* plan,
                cudaStream_t st) {
  switch (npt) {
    case 1: return launch_npt<MODE, 1, BF>(p, plan, st);
    case 2: return launch_npt<MODE, 2, BF>(p, plan, st);
    default: return launch_npt<MODE, 4, BF>(p, plan, st);
  }
}

template <bool BF>
int launch_form(typename ModeArgs<BF>::type& p, int mode, int npt, int* plan,
                cudaStream_t st) {
  switch (mode) {
    case kRnn: return launch_mode<kRnn, BF>(p, npt, plan, st);
    case kLigru: return launch_mode<kLigru, BF>(p, npt, plan, st);
    default: return launch_mode<kGru, BF>(p, npt, plan, st);
  }
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU; wx1/wx2 and the gate series of gates the mode
// lacks are ignored. V: the packed column blocks of the n_local ranks,
// [n_local][gates][Hg][Hl] in the order a step reads them. slots/flags: host
// arrays of P device pointers, every rank's slots ([2][B][Hg] floats) and
// zeroed counters ([P][B][2] u32). c_out non-null (with z_out, and r_out
// for the GRU) writes the gate series. bf16 selects the bf16-stream mode
// (V, the slots, y_out and the gate series bf16; wx bf16 where wx_bf16,
// else float); y0f is float in either mode.
extern "C" int sparch_tp_ann_fwd(
    const void* wx0, const void* wx1, const void* wx2, const void* V,
    const float* y0f, void* y_out, void* z_out, void* r_out, void* c_out,
    void* const* slots, unsigned* const* flags, int B, int T, int Hg, int P,
    int rank0, int n_local, int ld, int mode, int bf16, int wx_bf16,
    int* plan, void* stream) {
  if (B <= 0 || B % 8 != 0 || T <= 0 || P < 1 || P > tp::kMaxRanks ||
      Hg <= 0 || Hg % (P * 128) != 0 || Hg / P > kThreads * kMaxNpt ||
      n_local < 1 || rank0 < 0 || rank0 + n_local > P || mode < kRnn ||
      mode > kGru || !wx0 || (mode >= kLigru && !wx1) ||
      (mode == kGru && !wx2) || !V || !y0f || !y_out ||
      (mode >= kLigru && ((z_out == nullptr) != (c_out == nullptr))) ||
      (mode == kGru && ((r_out == nullptr) != (c_out == nullptr))) ||
      (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgsBf16 p{};
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
  p.lay.P = P;
  p.lay.rank0 = rank0;
  p.lay.n_local = n_local;
  p.B = B;
  p.T = T;
  p.Hg = Hg;
  p.Hl = Hg / P;
  p.ld = ld;
  // fewest neurons per thread that keep the block within kThreads
  int npt = 1;
  while (p.Hl / npt > kThreads) npt *= 2;
  p.wx_bf16 = wx_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_form<true>(p, mode, npt, plan, st);
  return launch_form<false>(static_cast<FwdArgs&>(p), mode, npt, plan, st);
}
