// Tensor-parallel fused RLIF/RadLIF forward for Hopper (sm_90a): the
// neurons are split into P column blocks of Hl = H/P, one per rank, and
// the ranks exchange their spikes at every step.
//
// Replaces: sparch_tpu/ops/pallas_tp.py `_tp_fwd_kernel` (:350, through
// `_tp_forward` :609), in its two stream modes (BF): float32, and the TPU
// kernel's mxu_bf16 mode (below). Rank r owns the neurons r*Hl ..
// r*Hl+Hl-1: their drive Wx, constants, state and output, and the column
// block V[:, shard] of the recurrent matrix. Per step, for one batch row
// (the dynamics of :416-445, the single-card fused_cell_fwd.cu without the
// affine and the dropout):
//   drive = Wx_t + s_full @ V[:, shard]
//   w     = beta*w + a*u + b*s ; drive -= w       (ADAPTIVE: RadLIF)
//   u     = alpha*(u - s) + (1-alpha)*drive
//   s     = u > threshold                          (the rank's Hl spikes)
//   s_full = all-gather of every rank's s          (tp_exchange.cuh)
// The step's gather feeds the next step's product, so the last step has
// none; every rank skips it alike, and every rank makes T-1 exchanges per
// row. The first product takes the gathered initial spikes s0_full (the
// caller's: the JAX wrapper all-gathers s0 once before its kernel; in the
// one-card form the full s0 is at hand). RESID also writes the membrane
// series u, the one residual of the backward (tp_cell_bwd.cu). The JAX
// kernel also writes boundary states and the end of the w series: the port
// has no time chunks, so its boundaries are u0/s0, and its backward takes
// dbeta without the w series (as fused_cell_bwd.cu does), so no w is saved.
//
// What bounds it on this card (measured, PERF.md section 6): the T
// dependent steps, as in the single-card kernel. The layout of one block a
// (rank, batch row) read the spiking rows of V's column block from L2 at
// every step and made one release/acquire handshake between the P blocks
// of each row at system scope: at (256, 100, 1024) 2.94 / 4.40 / 4.95 ms
// at P = 1 / 2 / 4, 15-20 us more a step at P > 1. It now runs the
// column-slice layout of spike_slices.cuh where a slice fits in shared
// memory: each rank's column block is cut into slices, every slice of
// every rank is a block of one cooperative launch, and the blocks of a row
// group exchange the spike words through the slots in one arrival a block
// and step; in the one-card form all ranks share rank 0's slot (no
// counter), so the exchange between ranks is the exchange between slices
// and costs the same at every P. The plan (ops/fused_tp.py, through
// ops/fused_cells.py `_fwd_plan`) comes from the wrapper and is checked
// here. Past the widest resident width, the layout below runs:
//
// Design (the layout of one block a rank and batch row):
// - One block runs one rank's neurons of one batch row for the whole
//   sequence (fused_cell_fwd.cu's layout with H replaced by Hl); a block
//   walks rows k, k + per_rank, ... where the card holds fewer than P*B
//   blocks. Thread j owns the rank's neurons j + i*blockDim.x (NPT of
//   them); u, w and s stay in registers.
// - Spikes are 0/1, so each warp's spikes are one __ballot_sync word, and
//   the exchange moves words: row b's gathered spikes are H/32 words, the
//   rank's at words r*Hl/32 ... The words are read back from the own slot
//   into shared memory, and (s_full @ V[:, shard])[j] is the sum of the
//   rows k of V at which s_full spiked, k ascending, as in
//   fused_cell_fwd.cu; a row of the column block is read coalesced. Each
//   (rank, row) block stores its words into every rank's slot and makes a
//   release/acquire handshake with the P - 1 peers of its row
//   (tp_exchange.cuh).
// - Rounding: __fmul_rn/__fadd_rn/__fsub_rn in the JAX kernel's order, so
//   with V on a dyadic grid every s @ V is exact and the spike trains and
//   membrane series equal the plain version's (ops/fused_tp.py
//   tp_cell_plain) and, at any P, the single-card kernel's without the
//   affine, bit for bit; the two layouts are equal bit for bit on any V.
//   The first product (s0 need not be 0/1) sums over k ascending, product
//   then sum, as fused_cell_fwd.cu does.
// - Rank data: the local rank l's column block starts at column l*Hl of
//   tensors with row stride ld. In the one-card form they are the full
//   (…, H) tensors (ld = H); across cards each rank's own (ld = Hl).
// - bf16 mode (the JAX kernel's mxu_bf16: rdt/vdt bf16, pallas_tp.py:625-
//   626): V is bf16 in global memory (rounded once by the wrapper,
//   :386-387, :710) and the spike output a bf16 stream (:660, :674); Wx is
//   read as float32 or bf16, whichever the model gives (the JAX SNN does
//   not cast it); the membrane series and the state stay float32. A spike
//   is 0 or 1, so the wire still moves bit words, exact in either mode, and
//   s_full @ V is the same gather-sum over bf16 rows of V summed in float32.
//   Only the first product sees a rounding: s0_full is rounded to bf16 for
//   it alone (:397-401), while the state keeps the float32 s0 (:394). These
//   are fused_cell_fwd.cu's bf16 rounding points, so the spikes and the
//   membrane series equal that kernel's without the affine and the
//   dropout, and those of every P, bit for bit on a dyadic V.
//
// C interface, bound with ctypes: sparch_tp_cell_fwd returns the launch's
// cudaError_t (or an invalid-value error for arguments it does not take)
// and never synchronises, unless given split_ms (column slices only). With
// `slices` (the column-slice plan, host memory) it runs that layout, else
// the layout of a block a row, and then `plan` (host memory, may be null)
// receives {1 row per block, blocks per rank, blocks per SM, threads}.
// sparch_tp_cell_fwd_slice_blocks reports the column-slice kernel's blocks
// an SM for the wrapper's plan, sparch_tp_cell_fwd_row_blocks the other
// layout's (across cards every card must agree on blocks per rank).

#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_slices.cuh"
#include "tile_stream.cuh"
#include "tp_exchange.cuh"

namespace {

using sparch::Elem;
using sparch::from_float;
using sparch::load_stream;
using sparch::round_bf16;
using sparch::to_float;
using sparch::tp::Layout;
using sparch::tp::Peers;

constexpr int kMaxThreads = 512;
constexpr int kMaxNpt = 4;  // so Hl <= 2048

struct FwdArgs {
  const void* wx;      // (B, T, ld): float, or bf16 where wx_bf16
  const float* alpha;  // (ld,)
  const float* beta;
  const float* a;
  const float* b;
  const void* V;       // (H, ld): rank l's column block at column l*Hl;
                       // float, bf16 in the bf16 mode
  const float* u0;     // (B, ld)
  const float* w0;
  const float* s0f;    // (B, H): the gathered initial spikes
  void* s_out;         // (B, T, ld): float, bf16 in the bf16 mode
  float* u_out;        // (B, T, ld), RESID
  Peers peers;         // slots: per rank [2][B][H/32] spike words
  Layout lay;
  int B, T, H, Hl, ld;
  float threshold;
};

// The bf16 mode's one more flag rides in a struct of its own, so that the
// float32 kernels' parameter block stays what it was before the mode
// existed (see fused_cell_fwd.cu).
struct FwdArgsBf16 : FwdArgs {
  int wx_bf16;  // the Wx stream is bf16, not float
};
template <bool BF>
struct ModeArgs {
  using type = FwdArgs;
};
template <>
struct ModeArgs<true> {
  using type = FwdArgsBf16;
};

template <bool ADAPTIVE, bool RESID, int NPT, bool BF>
__global__ void __launch_bounds__(kMaxThreads)
tp_cell_fwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;  // spikes out, V
  // dynamic shared memory: the s0 row (H floats), then the H/32 gathered
  // spike words
  extern __shared__ float smem[];
  const Layout& l = p.lay;
  const int H = p.H, T = p.T, ld = p.ld;
  const int nw = H / 32;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + H);
  const int local = sparch::tp::local_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * p.Hl;  // the rank's first column in rank data
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int word0 = rank * (p.Hl / 32);  // the rank's first spike word
  const ST* V = static_cast<const ST*>(p.V) + col0;
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  float al[NPT], oma[NPT], be[NPT], aa[NPT], bb[NPT];
  float u[NPT], w[NPT], s[NPT], sv[NPT], x[NPT];
  int col[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    col[i] = threadIdx.x + i * blockDim.x;
    const int c = col0 + col[i];
    al[i] = p.alpha[c];
    oma[i] = __fsub_rn(1.0f, al[i]);
    be[i] = ADAPTIVE ? p.beta[c] : 0.f;
    aa[i] = ADAPTIVE ? p.a[c] : 0.f;
    bb[i] = ADAPTIVE ? p.b[c] : 0.f;
  }

  for (int row = sparch::tp::block_in_rank(l); row < p.B; row += l.per_rank) {
    __syncthreads();  // the last row is done with the s0 row
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      smem[k] = p.s0f[(size_t)row * H + k];
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const size_t at = (size_t)row * ld + col0 + col[i];
      u[i] = p.u0[at];
      w[i] = ADAPTIVE ? p.w0[at] : 0.f;
      s[i] = p.s0f[(size_t)row * H + rank * p.Hl + col[i]];
      sv[i] = 0.f;
    }
    __syncthreads();
    for (int k = 0; k < H; ++k) {
      // bf16 mode: rounded for this product only, the state keeps s0
      const float sk = BF ? round_bf16(smem[k]) : smem[k];
      if (sk != 0.f) {
        const ST* vrow = V + (size_t)k * ld;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          sv[i] = __fadd_rn(sv[i], __fmul_rn(sk, to_float(vrow[col[i]])));
        }
      }
    }

    const size_t base = (size_t)row * T * ld + col0;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      x[i] = load_stream<BF>(p.wx, base + col[i], wx_bf16);
    }

    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        float d = __fadd_rn(x[i], sv[i]);
        if (ADAPTIVE) {
          w[i] = __fadd_rn(__fadd_rn(__fmul_rn(be[i], w[i]),
                                     __fmul_rn(aa[i], u[i])),
                           __fmul_rn(bb[i], s[i]));
          d = __fsub_rn(d, w[i]);
        }
        u[i] = __fadd_rn(__fmul_rn(al[i], __fsub_rn(u[i], s[i])),
                         __fmul_rn(oma[i], d));
        s[i] = u[i] > p.threshold ? 1.f : 0.f;
        const size_t at = base + (size_t)t * ld + col[i];
        static_cast<ST*>(p.s_out)[at] = from_float<ST>(s[i]);
        if (RESID) p.u_out[at] = u[i];
      }
      if (t + 1 == T) break;  // the last step's gather would feed nothing
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        x[i] = load_stream<BF>(p.wx, base + (size_t)(t + 1) * ld + col[i],
                               wx_bf16);
      }
      // the rank's spike words into slot t & 1 of every rank
      const size_t at_row = ((size_t)(t & 1) * p.B + row) * nw;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const uint32_t m = __ballot_sync(0xffffffffu, s[i] != 0.f);
        if (lane == 0) {
          const int word = word0 + i * warps + warp;
          for (int q = 0; q < l.P; ++q) {
            __stcg(static_cast<uint32_t*>(p.peers.slots[q]) + at_row + word,
                   m);
          }
        }
      }
      sparch::tp::exchange(p.peers, l, rank, row, t);
      const uint32_t* gathered =
          static_cast<const uint32_t*>(p.peers.slots[rank]) + at_row;
      for (int k = threadIdx.x; k < nw; k += blockDim.x) {
        mask[k] = __ldcg(gathered + k);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPT; ++i) sv[i] = 0.f;
      for (int wd = 0; wd < nw; ++wd) {
        uint32_t m = mask[wd];
        const ST* vbase = V + (size_t)wd * 32 * ld;
        while (m) {
          // up to four spiking rows per round, added in ascending k; a
          // missing row adds 0, which changes no sum
          const int k0 = __ffs(m) - 1;
          m &= m - 1;
          int k1 = -1, k2 = -1, k3 = -1;
          if (m) { k1 = __ffs(m) - 1; m &= m - 1; }
          if (m) { k2 = __ffs(m) - 1; m &= m - 1; }
          if (m) { k3 = __ffs(m) - 1; m &= m - 1; }
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const ST* vc = vbase + col[i];
            const float v0 = to_float(vc[(size_t)k0 * ld]);
            const float v1 = k1 >= 0 ? to_float(vc[(size_t)k1 * ld]) : 0.f;
            const float v2 = k2 >= 0 ? to_float(vc[(size_t)k2 * ld]) : 0.f;
            const float v3 = k3 >= 0 ? to_float(vc[(size_t)k3 * ld]) : 0.f;
            sv[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sv[i], v0), v1),
                                        v2),
                              v3);
          }
        }
      }
    }
  }
}

// Dynamic shared memory of the layout of a block a row: the s0 row and the
// gathered spike words.
inline size_t row_smem(int H) {
  return (size_t)H * sizeof(float) + (H / 32) * 4;
}

// Fewest neurons per thread that keep the block within kMaxThreads.
inline int row_npt(int Hl) {
  int npt = 1;
  while (Hl / npt > kMaxThreads) npt *= 2;
  return npt;
}

template <bool A, bool R, int NPT, bool BF>
int plan_and_launch(typename ModeArgs<BF>::type& p, int* plan,
                    cudaStream_t st) {
  auto kernel = tp_cell_fwd_kernel<A, R, NPT, BF>;
  const int threads = p.Hl / NPT;
  const size_t smem = row_smem(p.H);
  int per_sm = 0;
  cudaError_t err = sparch::tp::plan_blocks(
      kernel, threads, smem, p.lay.n_local, p.lay.n_groups, &p.lay.per_rank,
      &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (plan) {
    plan[0] = 1;
    plan[1] = p.lay.per_rank;
    plan[2] = per_sm;
    plan[3] = threads;
  }
  err = sparch::tp::launch_cooperative(kernel, p.lay.n_local * p.lay.per_rank,
                                       threads, smem, p, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool A, bool R, bool BF>
int launch_npt(typename ModeArgs<BF>::type& p, int npt, int* plan,
               cudaStream_t st) {
  switch (npt) {
    case 1: return plan_and_launch<A, R, 1, BF>(p, plan, st);
    case 2: return plan_and_launch<A, R, 2, BF>(p, plan, st);
    default: return plan_and_launch<A, R, 4, BF>(p, plan, st);
  }
}

template <bool BF>
int launch_form(typename ModeArgs<BF>::type& p, bool adaptive, bool resid,
                int npt, int* plan, cudaStream_t st) {
  if (adaptive) {
    return resid ? launch_npt<true, true, BF>(p, npt, plan, st)
                 : launch_npt<true, false, BF>(p, npt, plan, st);
  }
  return resid ? launch_npt<false, true, BF>(p, npt, plan, st)
               : launch_npt<false, false, BF>(p, npt, plan, st);
}

// The column-slice layout (spike_slices.cuh) over the launch's ranks: the
// plan {cols, rows, n_res, n_groups, threads} checked, the first product
// into sv0, the time loop over slices of V.
template <bool A, bool R, bool BF>
int launch_slices(const FwdArgsBf16& f, const int* plan, float* sv0,
                  float* split_ms, cudaStream_t st) {
  sparch::slices::Args s{};
  s.wx = f.wx;
  s.alpha = f.alpha;
  s.beta = f.beta;
  s.a = f.a;
  s.b = f.b;
  s.V = f.V;
  s.sv0 = sv0;
  s.u0 = f.u0;
  s.w0 = f.w0;
  s.s0f = f.s0f;
  s.s_out = f.s_out;
  s.u_out = f.u_out;
  s.peers = f.peers;
  s.B = f.B;
  s.T = f.T;
  s.H = f.H;
  s.W = f.H / 32;
  s.P = f.lay.P;
  s.rank0 = f.lay.rank0;
  s.n_local = f.lay.n_local;
  s.Hl = f.Hl;
  s.ld = f.ld;
  s.cols = plan[0];
  s.rows = plan[1];
  s.n_res = plan[2];
  s.n_groups = plan[3];
  s.S_r = s.cols > 0 ? (f.Hl + s.cols - 1) / s.cols : 0;
  s.threshold = f.threshold;
  s.wx_bf16 = f.wx_bf16;
  const int threads = plan[4];
  if (!sv0 || !sparch::slices::check_plan(s, threads, BF)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)sparch::slices::launch<A, false, R, false, BF>(
      s, sv0, threads, split_ms, st);
}

template <bool A, bool R, bool BF>
int row_blocks_npt(int H, int Hl) {
  const int npt = row_npt(Hl);
  void (*k)(typename ModeArgs<BF>::type) =
      npt == 1 ? tp_cell_fwd_kernel<A, R, 1, BF>
               : npt == 2 ? tp_cell_fwd_kernel<A, R, 2, BF>
                          : tp_cell_fwd_kernel<A, R, 4, BF>;
  const size_t smem = row_smem(H);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, Hl / npt,
                                                       smem) == cudaSuccess
             ? n
             : 0;
}

}  // namespace

// Blocks of the column-slice time loop an SM holds at the plan (cols, rows,
// threads); 0 where that plan cannot run.
extern "C" int sparch_tp_cell_fwd_slice_blocks(int adaptive, int resid,
                                               int bf16, int H, int cols,
                                               int rows, int threads) {
  using sparch::slices::blocks_per_sm;
  if (adaptive) {
    if (bf16) {
      return resid ? blocks_per_sm<true, false, true, false, true>(
                         H, cols, rows, threads)
                   : blocks_per_sm<true, false, false, false, true>(
                         H, cols, rows, threads);
    }
    return resid ? blocks_per_sm<true, false, true, false, false>(
                       H, cols, rows, threads)
                 : blocks_per_sm<true, false, false, false, false>(
                       H, cols, rows, threads);
  }
  if (bf16) {
    return resid ? blocks_per_sm<false, false, true, false, true>(
                       H, cols, rows, threads)
                 : blocks_per_sm<false, false, false, false, true>(
                       H, cols, rows, threads);
  }
  return resid ? blocks_per_sm<false, false, true, false, false>(
                     H, cols, rows, threads)
               : blocks_per_sm<false, false, false, false, false>(
                     H, cols, rows, threads);
}

// Blocks of the layout of a block a row an SM of the current card holds,
// at H over P ranks; 0 where the query fails.
extern "C" int sparch_tp_cell_fwd_row_blocks(int adaptive, int resid,
                                             int bf16, int H, int P) {
  if (P < 1 || H % (P * 128) || H / P > kMaxThreads * kMaxNpt) return 0;
  const int Hl = H / P;
  if (adaptive) {
    if (bf16) {
      return resid ? row_blocks_npt<true, true, true>(H, Hl)
                   : row_blocks_npt<true, false, true>(H, Hl);
    }
    return resid ? row_blocks_npt<true, true, false>(H, Hl)
                 : row_blocks_npt<true, false, false>(H, Hl);
  }
  if (bf16) {
    return resid ? row_blocks_npt<false, true, true>(H, Hl)
                 : row_blocks_npt<false, false, true>(H, Hl);
  }
  return resid ? row_blocks_npt<false, true, false>(H, Hl)
               : row_blocks_npt<false, false, false>(H, Hl);
}

// slots/flags: host arrays of P device pointers, every rank's spike-word
// slots ([2][B][H/32] u32) and zeroed counters ([P][B][2] u32); with a
// plan (`slices`) every rank's slot of tagged words ([2][B][H/32] u64;
// in the one-card form only rank 0's is read and the first product zeroes
// it; across cards each rank's own, zeroed by the caller before the entry
// barrier) and no counters. u_out
// non-null writes the membrane series. bf16 selects the bf16-stream mode
// (V and s_out bf16; wx bf16 where wx_bf16, else float).
extern "C" int sparch_tp_cell_fwd(
    const void* wx, const float* alpha, const float* beta, const float* a,
    const float* b, const void* V, const float* u0, const float* w0,
    const float* s0f, void* s_out, float* u_out, void* const* slots,
    unsigned* const* flags, int B, int T, int H, int P, int rank0,
    int n_local, int ld, float threshold, int adaptive, int bf16,
    int wx_bf16, const int* slices, float* sv0, float* split_ms, int* plan,
    void* stream) {
  if (B <= 0 || T <= 0 || P < 1 || P > sparch::tp::kMaxRanks || H <= 0 ||
      H % (P * 128) != 0 || n_local < 1 || rank0 < 0 ||
      rank0 + n_local > P || H / P > kMaxThreads * kMaxNpt || !wx ||
      !alpha || !V || !u0 || !s0f || !s_out ||
      (adaptive && (!beta || !a || !b || !w0)) || (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgsBf16 p{};
  if (slices) {
    if (!slots) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < P; ++q) {
      if (!slots[q]) return (int)cudaErrorInvalidValue;
      p.peers.slots[q] = slots[q];
    }
  } else if (!sparch::tp::make_peers(slots, flags, P, &p.peers)) {
    return (int)cudaErrorInvalidValue;
  }
  p.wx = wx;
  p.alpha = alpha;
  p.beta = beta;
  p.a = a;
  p.b = b;
  p.V = V;
  p.u0 = u0;
  p.w0 = w0;
  p.s0f = s0f;
  p.s_out = s_out;
  p.u_out = u_out;
  p.lay.P = P;
  p.lay.rank0 = rank0;
  p.lay.n_local = n_local;
  p.lay.n_groups = B;
  p.B = B;
  p.T = T;
  p.H = H;
  p.Hl = H / P;
  p.ld = ld;
  p.threshold = threshold;
  const int npt = row_npt(p.Hl);
  p.wx_bf16 = wx_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool resid = u_out != nullptr;
  if (slices) {
    if (adaptive) {
      if (bf16) {
        return resid ? launch_slices<true, true, true>(p, slices, sv0,
                                                       split_ms, st)
                     : launch_slices<true, false, true>(p, slices, sv0,
                                                        split_ms, st);
      }
      return resid ? launch_slices<true, true, false>(p, slices, sv0,
                                                      split_ms, st)
                   : launch_slices<true, false, false>(p, slices, sv0,
                                                       split_ms, st);
    }
    if (bf16) {
      return resid ? launch_slices<false, true, true>(p, slices, sv0,
                                                      split_ms, st)
                   : launch_slices<false, false, true>(p, slices, sv0,
                                                       split_ms, st);
    }
    return resid ? launch_slices<false, true, false>(p, slices, sv0,
                                                     split_ms, st)
                 : launch_slices<false, false, false>(p, slices, sv0,
                                                      split_ms, st);
  }
  if (split_ms) return (int)cudaErrorInvalidValue;
  if (bf16) return launch_form<true>(p, adaptive, resid, npt, plan, st);
  return launch_form<false>(static_cast<FwdArgs&>(p), adaptive, resid, npt,
                            plan, st);
}
