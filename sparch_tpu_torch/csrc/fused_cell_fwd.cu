// Fused spiking-cell forward for Hopper (sm_90a): LIF, adLIF, RLIF and
// RadLIF in one template, with the batchnorm affine applied on load.
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_fwd_kernel`, the TPU kernel
// behind lif/adlif/rlif/radlif_pallas, in two forms:
// the serving form (save_residuals=False, no dropout; entry point
// sparch_fused_cell_fwd) and the training form (entry point
// sparch_fused_cell_fwd_train), which has two more compile-time switches:
// RESID also writes the membrane series u, and DROPOUT drops the stored
// output with the mask of dropout_hash.cuh. Each form has two stream
// modes (BF): float32 streams, and the TPU kernel's mxu_bf16 mode, in which
// the spike output is bf16, V is bf16 (rounded once by the wrapper), Wx is
// float32 or bf16 as the projection emitted it and is promoted on load, and
// the membrane series, all state and all arithmetic stay float32.
//
// Per step, for one batch row (previous-step u, w and s on the right):
//   drive = scale*Wx_t + shift               (AFFINE)
//   drive = drive + s @ V                    (RECURRENT; V zero-diagonal)
//   w     = beta*w + a*u + b*s ; drive -= w  (ADAPTIVE)
//   u     = alpha*(u - s) + (1-alpha)*drive
//   s     = u > threshold
//   out_t = keep ? s * 1/(1-p) : 0           (DROPOUT; else out_t = s)
//   u_t stored                               (RESID)
//
// Residuals: the u series is the only one. The backward kernel
// (fused_cell_bwd.cu) re-thresholds exactly these float32 values to get
// the spikes back, and it needs no w series at all: neither stored (26 MB
// per layer at the training shape, written and read) nor unwound as the
// TPU kernel does (w_{t-1} = (w_t - a*u_{t-1} - b*s_{t-1})/beta, which
// amplifies rounding by 1/beta per step and needs boundary states every
// few steps). The one gradient that reads w, dbeta = sum_t B_t*w_{t-1},
// is taken there in an equivalent form that reads only u, s and w0. With
// dropout the raw spike stays in the recurrence and only the stored
// output is dropped, so the mask needs no storage either.
//
// What bounds it on this card (measured, PERF.md section 6): the T
// dependent steps, each of which needs the whole spike vector of the step
// before. The layout of one block a batch row read every spiking row of V
// over all H columns in every block, from L2, in 4-byte requests: at (256,
// 100, 1024) ~145 MB of L2 a step and 3.04 ms a call, the bf16 mode (half
// the bytes) 3.06: requests and their latency, not bytes. The recurrent
// forms therefore run the column-slice layout of spike_slices.cuh: a block
// holds a slice of V's columns in shared memory for all T and serves a
// group of batch rows with it, so V is read from L2 once a call and every
// element loaded from shared memory serves each row whose spike word has
// its bit; the blocks of a row group exchange their spike words through
// global memory, one arrival a block and step. The plan (ops/fused_cells.py
// `_fwd_plan`) comes from the wrapper and is checked here. Past the widest
// width whose slice fits in shared memory (H > ~1600), and for LIF and
// adLIF, which have no product, the layout below runs:
//
// Design (the layout of one block a batch row):
// - One block owns one batch row for the whole sequence. Blocks run in no
//   order, so the TPU kernel's sequential grid over time chunks becomes a
//   loop over T inside the block, and nothing carries between blocks.
//   Each thread owns NPT neurons j = threadIdx.x + i*blockDim.x; u, w and s
//   stay in registers.
// - Spikes are 0/1, so (s @ V)[j] is the sum of the rows k of V at which s
//   spiked. Each warp publishes its spikes as one __ballot_sync word in
//   shared memory, double-buffered so that one barrier per step suffices;
//   after the barrier every thread walks the words in ascending k and adds
//   V[k, j] for the set bits, four loads in flight at a time. A row of V is
//   read coalesced across the warp, from L2.
// - The next step's Wx is loaded before the barrier, so its latency hides
//   behind the gather.
// - Edges are masked: threads with j >= H hold no spike and never load or
//   store. B and H are not padded, and there are no sentinel lanes.
// - Rounding: every update uses __fmul_rn/__fadd_rn/__fsub_rn in the
//   order of the TPU kernel, so no FMA contraction changes a result and
//   the kernel rounds step for step like its plain PyTorch version
//   (ops/fused_cells.py fused_cell_plain). With V on a dyadic grid the sum
//   s@V is exact in any order and the spike trains are bit-identical;
//   otherwise only the summation order of s@V differs.
// - The initial state s0 need not be 0/1 (a uniform state init draws it
//   from U[0,1)), so the first s0 @ V is a dense dot over k, ascending.
// - bf16 mode: a spike is 0 or 1, so s @ V is the same gather-sum over
//   bf16 rows of V, summed in float32. Only the first product sees a
//   rounding: s0 is rounded to bf16 for that product alone, while the state
//   that enters u - s and b*s keeps the float32 s0. A kept output under
//   dropout is bf16(s / (1-p)). A product of two bf16 values is exact in
//   float32, so float32 adds of float32 products compute the bf16 product
//   with a float32 sum.
//
// Both layouts add the same spiking rows in the same ascending order from
// 0.f and take the same first product, so their outputs are equal bit for
// bit on any V.
//
// C interface, bound with ctypes: sparch_fused_cell_fwd returns
// cudaGetLastError() after the launch (or an invalid-value error for a
// shape or a plan it does not take) and never synchronises, unless it is
// given split_ms (the column-slice layout only): then it records CUDA
// events around its two launches (the first product, the time loop) and
// waits for them; so does sparch_fused_cell_fwd_train.
// sparch_fused_cell_fwd_slice_blocks reports the column-slice kernel's
// blocks an SM for the wrapper's plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "spike_slices.cuh"
#include "tile_stream.cuh"

namespace {

using sparch::Elem;
using sparch::from_float;
using sparch::load_stream;
using sparch::round_bf16;
using sparch::to_float;

constexpr int kMaxThreads = 512;
constexpr int kMaxNpt = 8;  // so H <= kMaxThreads * kMaxNpt = 4096

struct Args {
  const void* wx;       // float, or bf16 where wx_bf16 (bf16 mode only)
  const float* scale;
  const float* shift;
  const float* alpha;
  const float* beta;
  const float* a;
  const float* b;
  const void* V;        // float, bf16 in the bf16 mode
  const float* u0;
  const float* w0;
  const float* s0;
  void* s_out;          // float, bf16 in the bf16 mode
  int T;
  int H;
  float threshold;
  // training form only
  float* u_out;         // RESID: the membrane series (B, T, H)
  const int* seed;      // DROPOUT: two int32 in device memory
  uint32_t keep_u32;    // DROPOUT: keep where hash bits < keep_u32
  float inv_keep;       // DROPOUT: float32(1/(1-p))
  sparch::DropRows drop;  // DROPOUT: the hash's batch tile and row map
};

// The bf16 mode's one more flag rides in a struct of its own, so that the
// float32 kernels' parameter block, and with it their code, stays what it
// was before the mode existed (an int appended to Args changed how the
// float32 time loops compiled).
struct ArgsBf16 : Args {
  int wx_bf16;  // the Wx stream is bf16, not float
};
template <bool BF>
struct ModeArgs {
  using type = Args;
};
template <>
struct ModeArgs<true> {
  using type = ArgsBf16;
};

template <bool RECURRENT, bool ADAPTIVE, bool AFFINE, bool RESID,
          bool DROPOUT, int NPT, bool BF>
__global__ void __launch_bounds__(kMaxThreads)
fused_cell_fwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;  // spikes out, V
  // dynamic shared memory: the s0 row (H floats), then two buffers of
  // n_words spike masks
  extern __shared__ float smem[];
  const int H = p.H;
  const int T = p.T;
  const int warps = blockDim.x >> 5;
  const int n_words = NPT * warps;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + H);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  float al[NPT], oma[NPT], be[NPT], aa[NPT], bb[NPT], sc[NPT], sh[NPT];
  float u[NPT], w[NPT], s[NPT], sv[NPT], x[NPT];
  int col[NPT];
  bool live[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    live[i] = j < H;
    col[i] = live[i] ? j : 0;
    const int c = col[i];
    al[i] = p.alpha[c];
    oma[i] = __fsub_rn(1.0f, al[i]);
    be[i] = ADAPTIVE ? p.beta[c] : 0.f;
    aa[i] = ADAPTIVE ? p.a[c] : 0.f;
    bb[i] = ADAPTIVE ? p.b[c] : 0.f;
    sc[i] = AFFINE ? p.scale[c] : 0.f;
    sh[i] = AFFINE ? p.shift[c] : 0.f;
    u[i] = p.u0[row * H + c];
    w[i] = ADAPTIVE ? p.w0[row * H + c] : 0.f;
    s[i] = live[i] ? p.s0[row * H + c] : 0.f;
    sv[i] = 0.f;
    if (RECURRENT && live[i]) smem[j] = s[i];
  }

  if (RECURRENT) {
    __syncthreads();
    for (int k = 0; k < H; ++k) {
      // bf16 mode: rounded for this product only, the state keeps s0
      const float sk = BF ? round_bf16(smem[k]) : smem[k];
      if (sk != 0.f) {
        const ST* vrow = static_cast<const ST*>(p.V) + (size_t)k * H;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          if (live[i]) {
            sv[i] = __fadd_rn(sv[i], __fmul_rn(sk, to_float(vrow[col[i]])));
          }
        }
      }
    }
  }

  const size_t wx_row = row * T * H;  // first element of the row's Wx
  ST* s_row = static_cast<ST*>(p.s_out) + row * T * H;
  float* u_row = RESID ? p.u_out + row * T * H : nullptr;
  const uint32_t drop_base =
      DROPOUT ? sparch::dropout_row_base(p.seed, (int)row, p.drop) : 0u;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    x[i] = live[i] ? load_stream<BF>(p.wx, wx_row + col[i], wx_bf16) : 0.f;
  }

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      float d = x[i];
      if (AFFINE) d = __fadd_rn(__fmul_rn(sc[i], d), sh[i]);
      if (RECURRENT) d = __fadd_rn(d, sv[i]);
      if (ADAPTIVE) {
        w[i] = __fadd_rn(__fadd_rn(__fmul_rn(be[i], w[i]),
                                   __fmul_rn(aa[i], u[i])),
                         __fmul_rn(bb[i], s[i]));
        d = __fsub_rn(d, w[i]);
      }
      u[i] = __fadd_rn(__fmul_rn(al[i], __fsub_rn(u[i], s[i])),
                       __fmul_rn(oma[i], d));
      s[i] = u[i] > p.threshold ? 1.f : 0.f;
      if (live[i]) {
        float stored = s[i];
        if (DROPOUT) {
          // the raw spike stays in the recurrence
          stored = sparch::dropout_keep(drop_base, col[i], t, p.keep_u32)
                       ? __fmul_rn(s[i], p.inv_keep)
                       : 0.f;
        }
        s_row[(size_t)t * H + col[i]] = from_float<ST>(stored);
        if (RESID) u_row[(size_t)t * H + col[i]] = u[i];
      }
    }
    if (t + 1 < T) {
      const size_t wx_next = wx_row + (size_t)(t + 1) * H;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        x[i] = live[i] ? load_stream<BF>(p.wx, wx_next + col[i], wx_bf16)
                       : 0.f;
      }
    }
    if (RECURRENT) {
      uint32_t* buf = masks + (t & 1) * n_words;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const uint32_t m = __ballot_sync(0xffffffffu, live[i] && s[i] != 0.f);
        if (lane == 0) buf[i * warps + warp] = m;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPT; ++i) sv[i] = 0.f;
      for (int wd = 0; wd < n_words; ++wd) {
        uint32_t m = buf[wd];
        const ST* vbase = static_cast<const ST*>(p.V) + (size_t)wd * 32 * H;
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
            if (!live[i]) continue;
            const ST* vc = vbase + col[i];
            const float v0 = to_float(vc[(size_t)k0 * H]);
            const float v1 = k1 >= 0 ? to_float(vc[(size_t)k1 * H]) : 0.f;
            const float v2 = k2 >= 0 ? to_float(vc[(size_t)k2 * H]) : 0.f;
            const float v3 = k3 >= 0 ? to_float(vc[(size_t)k3 * H]) : 0.f;
            sv[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sv[i], v0), v1),
                                        v2),
                              v3);
          }
        }
      }
    }
  }
}

template <bool R, bool A, bool F, bool RS, bool DR, bool BF>
void launch_mode(const ArgsBf16& p, int B, int npt, int threads, size_t smem,
                 cudaStream_t stream) {
  switch (npt) {
    case 1:
      fused_cell_fwd_kernel<R, A, F, RS, DR, 1, BF>
          <<<B, threads, smem, stream>>>(p);
      break;
    case 2:
      fused_cell_fwd_kernel<R, A, F, RS, DR, 2, BF>
          <<<B, threads, smem, stream>>>(p);
      break;
    case 4:
      fused_cell_fwd_kernel<R, A, F, RS, DR, 4, BF>
          <<<B, threads, smem, stream>>>(p);
      break;
    default:
      fused_cell_fwd_kernel<R, A, F, RS, DR, 8, BF>
          <<<B, threads, smem, stream>>>(p);
      break;
  }
}

template <bool R, bool A, bool F, bool RS, bool DR>
void launch_npt(const ArgsBf16& p, bool bf16, int B, int npt, int threads,
                size_t smem, cudaStream_t stream) {
  if (bf16) {
    launch_mode<R, A, F, RS, DR, true>(p, B, npt, threads, smem, stream);
  } else {
    launch_mode<R, A, F, RS, DR, false>(p, B, npt, threads, smem, stream);
  }
}

template <bool R, bool A, bool F>
void launch_train(const ArgsBf16& p, bool bf16, int B, bool resid, bool dropout,
                  int npt, int threads, size_t smem, cudaStream_t stream) {
  if (resid && dropout) {
    launch_npt<R, A, F, true, true>(p, bf16, B, npt, threads, smem, stream);
  } else if (resid) {
    launch_npt<R, A, F, true, false>(p, bf16, B, npt, threads, smem, stream);
  } else if (dropout) {
    launch_npt<R, A, F, false, true>(p, bf16, B, npt, threads, smem, stream);
  } else {
    launch_npt<R, A, F, false, false>(p, bf16, B, npt, threads, smem,
                                      stream);
  }
}

template <bool R, bool A>
void launch_affine(const ArgsBf16& p, bool bf16, int B, bool affine, bool resid,
                   bool dropout, int npt, int threads, size_t smem,
                   cudaStream_t stream) {
  if (affine) {
    launch_train<R, A, true>(p, bf16, B, resid, dropout, npt, threads, smem,
                             stream);
  } else {
    launch_train<R, A, false>(p, bf16, B, resid, dropout, npt, threads, smem,
                              stream);
  }
}

// Checks the arguments both entry points share and launches the form.
int launch_form(const ArgsBf16& p, int B, int recurrent, int adaptive,
                int affine, int bf16, void* stream) {
  const int T = p.T, H = p.H;
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxThreads * kMaxNpt ||
      !p.wx || !p.alpha || !p.u0 || !p.s0 || !p.s_out ||
      (recurrent && !p.V) ||
      (adaptive && (!p.beta || !p.a || !p.b || !p.w0)) ||
      (affine && (!p.scale || !p.shift))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool resid = p.u_out != nullptr;
  const bool dropout = p.seed != nullptr;
  if (dropout && !sparch::drop_rows_ok(p.drop)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.wx_bf16 && !bf16) return (int)cudaErrorInvalidValue;
  // fewest neurons per thread that keep the block within kMaxThreads
  int npt = 1;
  while ((H + npt - 1) / npt > kMaxThreads) npt *= 2;
  const int threads = (((H + npt - 1) / npt) + 31) / 32 * 32;
  const int n_words = npt * (threads / 32);
  const size_t smem = (size_t)H * sizeof(float) + 2 * n_words * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (recurrent && adaptive) {
    launch_affine<true, true>(p, bf16 != 0, B, affine, resid, dropout, npt,
                              threads, smem, st);
  } else if (recurrent) {
    launch_affine<true, false>(p, bf16 != 0, B, affine, resid, dropout, npt,
                               threads, smem, st);
  } else if (adaptive) {
    launch_affine<false, true>(p, bf16 != 0, B, affine, resid, dropout, npt,
                               threads, smem, st);
  } else {
    launch_affine<false, false>(p, bf16 != 0, B, affine, resid, dropout, npt,
                                threads, smem, st);
  }
  return (int)cudaGetLastError();
}

// The recurrent forms in the column-slice layout (spike_slices.cuh): the
// plan {cols, rows, n_res, n_groups, threads} checked, the first product
// into sv0, the time loop over slices of V, the tagged spike words
// through slots ([2][B][ceil(H/32)] u64).
template <bool A, bool F, bool RS, bool DR, bool BF>
int launch_slices(const ArgsBf16& p, int B, const int* plan, float* sv0,
                  void* slots, float* split_ms, cudaStream_t st) {
  sparch::slices::Args s{};
  s.wx = p.wx;
  s.scale = p.scale;
  s.shift = p.shift;
  s.alpha = p.alpha;
  s.beta = p.beta;
  s.a = p.a;
  s.b = p.b;
  s.V = p.V;
  s.sv0 = sv0;
  s.u0 = p.u0;
  s.w0 = p.w0;
  s.s0f = p.s0;
  s.s_out = p.s_out;
  s.u_out = p.u_out;
  s.seed = p.seed;
  s.keep_u32 = p.keep_u32;
  s.inv_keep = p.inv_keep;
  s.drop = p.drop;
  s.peers.slots[0] = slots;
  s.B = B;
  s.T = p.T;
  s.H = p.H;
  s.W = (p.H + 31) / 32;
  s.P = 1;
  s.rank0 = 0;
  s.n_local = 1;
  s.Hl = p.H;
  s.ld = p.H;
  s.cols = plan[0];
  s.rows = plan[1];
  s.n_res = plan[2];
  s.n_groups = plan[3];
  s.S_r = s.cols > 0 ? (p.H + s.cols - 1) / s.cols : 0;
  s.threshold = p.threshold;
  s.wx_bf16 = p.wx_bf16;
  const int threads = plan[4];
  if (!sv0 || !slots || !sparch::slices::check_plan(s, threads, BF)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)sparch::slices::launch<A, F, RS, DR, BF>(s, sv0, threads,
                                                        split_ms, st);
}

template <bool A, bool F>
int slices_form(const ArgsBf16& p, int B, bool resid, bool dropout, bool bf16,
                const int* plan, float* sv0, void* slots, float* split_ms,
                cudaStream_t st) {
#define SPARCH_SLICES(RS, DR)                                              \
  return bf16 ? launch_slices<A, F, RS, DR, true>(p, B, plan, sv0, slots,  \
                                                  split_ms, st)            \
              : launch_slices<A, F, RS, DR, false>(p, B, plan, sv0, slots, \
                                                   split_ms, st)
  if (resid && dropout) SPARCH_SLICES(true, true);
  if (resid) SPARCH_SLICES(true, false);
  if (dropout) SPARCH_SLICES(false, true);
  SPARCH_SLICES(false, false);
#undef SPARCH_SLICES
}

// Both entry points: the column-slice layout where the caller passes a
// plan (recurrent forms only), else the layout of one block a batch row.
int launch_any(const ArgsBf16& p, int B, int recurrent, int adaptive,
               int affine, int bf16, const int* plan, float* sv0,
               void* slots, float* split_ms, void* stream) {
  if (!plan) {
    if (split_ms) return (int)cudaErrorInvalidValue;
    return launch_form(p, B, recurrent, adaptive, affine, bf16, stream);
  }
  const int T = p.T, H = p.H;
  if (!recurrent || B <= 0 || T <= 0 || H <= 0 || !p.wx || !p.alpha ||
      !p.u0 || !p.s0 || !p.s_out || !p.V ||
      (adaptive && (!p.beta || !p.a || !p.b || !p.w0)) ||
      (affine && (!p.scale || !p.shift)) || (p.wx_bf16 && !bf16) ||
      (p.seed && !sparch::drop_rows_ok(p.drop))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool resid = p.u_out != nullptr, dropout = p.seed != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (adaptive) {
    return affine ? slices_form<true, true>(p, B, resid, dropout, bf16, plan,
                                            sv0, slots, split_ms, st)
                  : slices_form<true, false>(p, B, resid, dropout, bf16, plan,
                                             sv0, slots, split_ms, st);
  }
  return affine ? slices_form<false, true>(p, B, resid, dropout, bf16, plan,
                                           sv0, slots, split_ms, st)
                : slices_form<false, false>(p, B, resid, dropout, bf16, plan,
                                            sv0, slots, split_ms, st);
}

}  // namespace

// Blocks of the column-slice time loop an SM holds at the plan (cols, rows,
// threads) of a recurrent form; 0 where that plan cannot run.
extern "C" int sparch_fused_cell_fwd_slice_blocks(int adaptive, int affine,
                                                  int resid, int dropout,
                                                  int bf16, int H, int cols,
                                                  int rows, int threads) {
  using sparch::slices::blocks_per_sm;
#define SPARCH_OCC(A, F)                                                     \
  {                                                                          \
    if (bf16) {                                                              \
      if (resid && dropout)                                                  \
        return blocks_per_sm<A, F, true, true, true>(H, cols, rows, threads); \
      if (resid)                                                             \
        return blocks_per_sm<A, F, true, false, true>(H, cols, rows, threads);\
      if (dropout)                                                           \
        return blocks_per_sm<A, F, false, true, true>(H, cols, rows, threads);\
      return blocks_per_sm<A, F, false, false, true>(H, cols, rows, threads); \
    }                                                                        \
    if (resid && dropout)                                                    \
      return blocks_per_sm<A, F, true, true, false>(H, cols, rows, threads);  \
    if (resid)                                                               \
      return blocks_per_sm<A, F, true, false, false>(H, cols, rows, threads); \
    if (dropout)                                                             \
      return blocks_per_sm<A, F, false, true, false>(H, cols, rows, threads); \
    return blocks_per_sm<A, F, false, false, false>(H, cols, rows, threads);  \
  }
  if (adaptive && affine) SPARCH_OCC(true, true)
  if (adaptive) SPARCH_OCC(true, false)
  if (affine) SPARCH_OCC(false, true)
  SPARCH_OCC(false, false)
#undef SPARCH_OCC
}

// Serving form: spikes only. bf16 selects the bf16-stream mode (s_out and V
// bf16; wx bf16 where wx_bf16, else float).
extern "C" int sparch_fused_cell_fwd(
    const void* wx, const float* scale, const float* shift,
    const float* alpha, const float* beta, const float* a, const float* b,
    const void* V, const float* u0, const float* w0, const float* s0,
    void* s_out, int B, int T, int H, float threshold, int recurrent,
    int adaptive, int affine, int bf16, int wx_bf16, const int* plan,
    float* sv0, void* slots, float* split_ms, void* stream) {
  const ArgsBf16 p{{wx, scale, shift, alpha, beta, a, b, V, u0, w0, s0, s_out,
                    T, H, threshold, nullptr, nullptr, 0u, 1.f, {1, 1, 1, 0}},
                   wx_bf16};
  return launch_any(p, B, recurrent, adaptive, affine, bf16, plan, sv0,
                    slots, split_ms, stream);
}

// Training form: u_out non-null writes the membrane series, seed non-null
// drops the stored output (keep_u32, inv_keep, tile_rows and the row map
// row_seg, row_stride, row_off of dropout_hash.cuh are then read).
// The membrane series stays float in both modes.
extern "C" int sparch_fused_cell_fwd_train(
    const void* wx, const float* scale, const float* shift,
    const float* alpha, const float* beta, const float* a, const float* b,
    const void* V, const float* u0, const float* w0, const float* s0,
    void* s_out, float* u_out, const int* seed, int B, int T, int H,
    float threshold, int recurrent, int adaptive, int affine,
    unsigned int keep_u32, float inv_keep, int tile_rows, int row_seg,
    int row_stride, int row_off, int bf16, int wx_bf16, const int* plan,
    float* sv0, void* slots, float* split_ms, void* stream) {
  const ArgsBf16 p{{wx, scale, shift, alpha, beta, a, b, V, u0, w0, s0, s_out,
                    T, H, threshold, u_out, seed, keep_u32, inv_keep,
                    sparch::DropRows{tile_rows, row_seg, row_stride, row_off}},
                   wx_bf16};
  return launch_any(p, B, recurrent, adaptive, affine, bf16, plan, sv0,
                    slots, split_ms, stream);
}
