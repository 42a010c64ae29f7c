// Fused spiking-cell backward for Hopper (sm_90a): reverse-time BPTT with
// the boxcar surrogate for LIF, adLIF, RLIF and RadLIF in one template,
// with the batchnorm affine and the output dropout of the forward.
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_bwd_kernel`, the TPU kernel
// behind the VJP of lif/adlif/rlif/radlif_pallas, in two stream modes (BF):
// float32 streams, and the TPU kernel's mxu_bf16 mode. In that mode the
// cotangent g and dWx are bf16 streams, V^T is bf16 (rounded once by the
// wrapper), Wx (read with the affine) is float32 or bf16 as the forward
// got it, dDrive is rounded to bf16 where it enters a product (the adjoint
// product and dV, so the scratch series the dV kernel reads is stored in
// bf16) and dWx = bf16(dDrive*scale); the membrane series, all adjoint
// state and every reduced gradient (dscale and dshift from the float32
// dDrive) stay float32 and keep their fixed order.
//
// With A_t = dL/du_t, B_t = dL/dw_t and g_t the output cotangent (masked
// and scaled like the forward's output under DROPOUT), walking t = T..1:
//   C_t = g_t - alpha*A_{t+1} + ((1-alpha)*A_{t+1}) @ V^T + b*B_{t+1}
//   A_t = window(u_t - thr)*C_t + alpha*A_{t+1} + a*B_{t+1}
//   B_t = beta*B_{t+1} - (1-alpha)*A_t
//   dDrive_t = (1-alpha)*A_t ;  dWx_t = dDrive_t * scale
//   dscale = sum dDrive_t*Wx_t ;  dshift = sum dDrive_t
//   dV     = sum s_{t-1}^T dDrive_t
//   dalpha = sum A_t*(u_{t-1} - s_{t-1} - u_t) / (1-alpha)
//   da     = sum B_t*u_{t-1} ;  db = sum B_t*s_{t-1}
//   dbeta  = sum B_t*w_{t-1}
//          = sum w_0*P_1 + sum (a*u_{t-1} + b*s_{t-1})*P_{t+1},
//            P_t = B_t + beta*P_{t+1}
//   du_0 = alpha*A_1 + a*B_1 ;  dw_0 = beta*B_1
//   ds_0 = -alpha*A_1 + ((1-alpha)*A_1) @ V^T + b*B_1
// window(x) = -0.5 < x <= 0.5. s_t = u_t > thr is recomputed from the saved
// u series (the same float32 values the forward thresholded); at t = 1 the
// previous state is u0, s0 as given (s0 need not be 0/1). The second form
// of dbeta writes w_{t-1} out as beta^{t-1}*w_0 + sum_k beta^{t-2-k}*(a*u_k +
// b*s_k) and exchanges the sums, so the kernel needs no w series: none is
// stored by the forward and none is unwound here. All gradients are with
// respect to the clamped constants and the masked V; the clamp and the
// mask are pulled back by autograd outside.
//
// What bounds it on this card: for the recurrent forms the dense product
// ((1-alpha)*A) @ V^T of every step, 2*B*H*H FLOP against a V that does
// not fit in shared memory (1 MB at H=512), T times in sequence; then the
// dV product, 2*B*T*H*H FLOP. At (128, 100, 512) that is 6.7 GFLOP each,
// 0.2 ms at the float32 peak, against 105 MB of streams (31 us at HBM
// rate): operations bound it, and in this version the L2 traffic of V per
// step does (1 MB per block and step).
//
// Design:
// - Main kernel. One block owns BT batch rows for the whole sequence and
//   loops over T in reverse; thread j owns NPT neurons for all BT rows
//   (BT*NPT = kWork, BT = 2 at H <= 512), with A, B, P and the carried
//   product in registers. Every block reads all of V^T from L2 per step,
//   so more rows per block mean less traffic but fewer busy SMs: measured
//   at (128, 100, 512) on an H100, 2 rows (64 blocks) beat 4 and 8. Each
//   step the block publishes dDrive in shared memory
//   ([neuron][row], double-buffered) and every thread accumulates its
//   columns of dDrive @ V^T over all H. V^T (the wrapper transposes V
//   once and pads its rows to 16 bytes) streams from L2 through shared
//   memory in tiles of up to 64 KB, kStages stages deep and one barrier
//   per tile: one thread starts each tile as a bulk copy (TMA) that
//   reports to an mbarrier (tile_stream.cuh, shared with the ANN kernels;
//   the same stream built from per-thread cp.async was a quarter slower
//   at every block size). The stream runs
//   on across the steps, so the next step's first tiles arrive during
//   this step's elementwise work. (A first version read V^T straight into registers, eight loads
//   in flight per thread, and waited on L2 latency: 39 us per step at
//   H=512, 8 rows per block.) dDrive is read as broadcasts from shared
//   memory.
// - Reductions are in a fixed order, so two runs give the same bits: each
//   thread sums its neurons' parameter gradients over its rows and all T
//   in registers, writes them to partials[block][6][H], and a second
//   kernel adds the blocks in ascending order (and divides dalpha by
//   1-alpha). No atomics.
// - dV is a third kernel after the time loop (dv_product.cuh, shared with
//   tp_cell_bwd.cu): one (H, B*T) x (B*T, H)
//   product whose left operand is recomputed from the u series (s0 for
//   the first step of each row) and whose right operand is the stored
//   dDrive (dWx itself without the affine, else a scratch stream written
//   beside it). 64x64 tiles, 4x4 per thread, split over B*T into
//   partials that a fourth kernel adds in ascending order.
// - Edges are masked: rows >= B and neurons >= H load nothing, hold zero
//   adjoints and store nothing.
//
// C interface, bound with ctypes: sparch_fused_cell_bwd enqueues all the
// kernels on the stream, returns cudaGetLastError() (or an invalid-value
// error for arguments it does not take) and never synchronises. n_blocks
// and ksplit size the caller's partials buffers and are checked against
// the plan here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "dv_product.cuh"
#include "tile_stream.cuh"

namespace {

using namespace sparch;

constexpr int kThreads = 512;
// The rows a block owns times the neurons a thread owns; a macro so that
// chip_profile.py can time other values side by side (-DSPARCH_BWD_WORK=n;
// ops/fused_cells.py _BWD_WORK must say the same).
#ifndef SPARCH_BWD_WORK
#define SPARCH_BWD_WORK 2
#endif
constexpr int kWork = SPARCH_BWD_WORK;
constexpr int kMaxNpt = 8;  // so H <= kThreads * kMaxNpt = 4096
constexpr int kVecs = 6;  // dalpha, dbeta, da, db, dscale, dshift

struct Args {
  const void* g;    // the streams g, dwx, dd and VT: float, bf16 in bf16 mode
  const void* wx;   // float, or bf16 where wx_bf16 (bf16 mode only)
  const float* u_seq;
  const float* scale;
  const float* alpha;
  const float* beta;
  const float* a;
  const float* b;
  const void* VT;
  const float* u0;
  const float* w0;
  const float* s0;
  const int* seed;
  void* dwx;
  void* dd;
  float* partials;
  float* du0;
  float* dw0;
  float* ds0;
  int B;
  int T;
  int H;
  float threshold;
  uint32_t keep_u32;
  float inv_keep;
  int tile_rows;
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

template <bool RECURRENT, bool ADAPTIVE, bool AFFINE, bool DROPOUT, int NPT,
          bool BF>
__global__ void __launch_bounds__(kThreads)
fused_cell_bwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  // RECURRENT: two buffers of H*BT floats, dDrive as [neuron][row], then
  // kStages tiles of V^T
  extern __shared__ __align__(16) float dd_s[];
  const int H = p.H;
  const int T = p.T;
  const int row0 = blockIdx.x * BT;
  const float thr = p.threshold;
  __shared__ uint64_t full[kStages];  // one mbarrier per stage
  // the cyclic stream of V^T's tiles, T times over; the stages start
  // 16-byte aligned behind the dDrive buffers
  TileStream<ST> vt = stream_over(
      static_cast<const ST*>(p.VT),
      reinterpret_cast<ST*>(dd_s + ((2 * H * BT + 3) & ~3)), full, H, 1, T);
  const ST* g_in = static_cast<const ST*>(p.g);
  ST* dwx_out = static_cast<ST*>(p.dwx);
  ST* dd_out = static_cast<ST*>(p.dd);
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  float al[NPT], oma[NPT], be[NPT], aa[NPT], bb[NPT], sc[NPT];
  float dal[NPT], dbe[NPT], daa[NPT], dbb[NPT], dsc[NPT], dsh[NPT];
  float A[NPT][BT], Bw[NPT][BT], P[NPT][BT], AV[NPT][BT], up[NPT][BT];
  int col[NPT];
  bool live[NPT];
  bool rowlive[BT];
  uint32_t drop_base[BT];

#pragma unroll
  for (int r = 0; r < BT; ++r) {
    rowlive[r] = row0 + r < p.B;
    drop_base[r] = (DROPOUT && rowlive[r])
                       ? sparch::dropout_row_base(p.seed, row0 + r,
                                                  p.tile_rows)
                       : 0u;
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    live[i] = j < H;
    col[i] = live[i] ? j : 0;
    const int c = col[i];
    al[i] = p.alpha[c];
    oma[i] = 1.0f - al[i];
    be[i] = ADAPTIVE ? p.beta[c] : 0.f;
    aa[i] = ADAPTIVE ? p.a[c] : 0.f;
    bb[i] = ADAPTIVE ? p.b[c] : 0.f;
    sc[i] = AFFINE ? p.scale[c] : 1.f;
    dal[i] = dbe[i] = daa[i] = dbb[i] = dsc[i] = dsh[i] = 0.f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      A[i][r] = Bw[i][r] = P[i][r] = AV[i][r] = 0.f;
      // u_t of the first step walked, carried from step to step as the
      // next one's u_t
      const bool ok = live[i] && rowlive[r];
      up[i][r] = ok ? p.u_seq[((size_t)(row0 + r) * T + (T - 1)) * H + c]
                    : 0.f;
    }
  }
  if (RECURRENT) stream_open(vt);

  for (int t = T - 1; t >= 0; --t) {
    float* buf = dd_s + (t & 1) * H * BT;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int c = col[i];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const bool ok = live[i] && rowlive[r];
        const size_t row = (size_t)(row0 + r);
        const size_t at = (row * T + t) * H + c;
        float g_t = ok ? to_float(g_in[at]) : 0.f;
        if (DROPOUT) {
          g_t = sparch::dropout_keep(drop_base[r], c, t, p.keep_u32)
                    ? g_t * p.inv_keep
                    : 0.f;
        }
        const float u_t = up[i][r];
        float u_p = 0.f, s_p = 0.f;
        if (ok) {
          if (t > 0) {
            u_p = p.u_seq[at - H];
            s_p = u_p > thr ? 1.f : 0.f;
          } else {
            u_p = p.u0[row * H + c];
            s_p = p.s0[row * H + c];
          }
        }
        up[i][r] = u_p;
        const float alphaA = al[i] * A[i][r];
        float C = g_t - alphaA;
        if (RECURRENT) C += AV[i][r];
        if (ADAPTIVE) C += bb[i] * Bw[i][r];
        const float wsub = u_t - thr;
        const bool window = ok && wsub > -0.5f && wsub <= 0.5f;
        float A_new = (window ? C : 0.f) + alphaA;
        if (ADAPTIVE) A_new += aa[i] * Bw[i][r];
        const float dd = oma[i] * A_new;
        if (AFFINE) {
          const float wx_t = ok ? load_stream<BF>(p.wx, at, wx_bf16) : 0.f;
          dsc[i] += dd * wx_t;
          dsh[i] += dd;
        }
        if (ok) {
          dwx_out[at] = from_float<ST>(AFFINE ? dd * sc[i] : dd);
          if (RECURRENT && AFFINE) dd_out[at] = from_float<ST>(dd);
        }
        // bf16 mode: rounded where it enters the adjoint product
        if (RECURRENT && live[i]) buf[c * BT + r] = BF ? round_bf16(dd) : dd;
        dal[i] += A_new * (u_p - s_p - u_t);
        if (ADAPTIVE) {
          const float B_new = be[i] * Bw[i][r] - dd;
          dbe[i] += (aa[i] * u_p + bb[i] * s_p) * P[i][r];
          P[i][r] = B_new + be[i] * P[i][r];
          daa[i] += B_new * u_p;
          dbb[i] += B_new * s_p;
          Bw[i][r] = B_new;
        }
        A[i][r] = A_new;
      }
    }
    if (RECURRENT) {
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) AV[i][r] = 0.f;
      }
      // AV[b][k] = sum_j dDrive[b][j] * V[k][j] = sum_j dDrive[b][j] *
      // VT[j][k], j ascending, tile by tile
      stream_matrix<NPT, BT>(vt, buf, col, AV);
    }
  }

  // initial-state gradients and this block's parameter partials
  float* part = p.partials + (size_t)blockIdx.x * kVecs * H;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (!live[i]) continue;
    const int c = col[i];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (!rowlive[r]) continue;
      const size_t at = (size_t)(row0 + r) * H + c;
      float du0 = al[i] * A[i][r];
      float ds0 = -(al[i] * A[i][r]);
      if (RECURRENT) ds0 += AV[i][r];
      if (ADAPTIVE) {
        du0 += aa[i] * Bw[i][r];
        ds0 += bb[i] * Bw[i][r];
        p.dw0[at] = be[i] * Bw[i][r];
        dbe[i] += p.w0[at] * P[i][r];
      }
      p.du0[at] = du0;
      p.ds0[at] = ds0;
    }
    part[0 * H + c] = dal[i];
    part[1 * H + c] = dbe[i];
    part[2 * H + c] = daa[i];
    part[3 * H + c] = dbb[i];
    part[4 * H + c] = dsc[i];
    part[5 * H + c] = dsh[i];
  }
}

// out[q][j] = sum over blocks, ascending, of partials[block][q][j]; the
// dalpha row (q = 0) is divided by 1 - alpha, hoisted out of the time loop.
__global__ void vec_reduce_kernel(const float* __restrict__ partials,
                                  const float* __restrict__ alpha,
                                  float* __restrict__ out, int n_blocks,
                                  int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kVecs * H) return;
  float sum = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    sum += partials[(size_t)k * kVecs * H + idx];
  }
  if (idx < H) sum = sum / (1.0f - alpha[idx]);
  out[idx] = sum;
}

// More than 48 KB of dynamic shared memory has to be asked for, per
// instantiation.
template <bool R, bool A, bool F, bool D, int NPT, bool BF>
void launch_one(const ArgsBf16& p, int n_blocks, int threads, size_t smem,
                cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fused_cell_bwd_kernel<R, A, F, D, NPT, BF>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  fused_cell_bwd_kernel<R, A, F, D, NPT, BF>
      <<<n_blocks, threads, smem, st>>>(p);
}

template <bool R, bool A, bool F, bool D, bool BF>
void launch_mode(const ArgsBf16& p, int n_blocks, int npt, int threads,
                 size_t smem, cudaStream_t st) {
  switch (npt) {
    case 1:
      launch_one<R, A, F, D, 1, BF>(p, n_blocks, threads, smem, st);
      break;
    case 2:
      launch_one<R, A, F, D, 2, BF>(p, n_blocks, threads, smem, st);
      break;
    case 4:
      launch_one<R, A, F, D, 4, BF>(p, n_blocks, threads, smem, st);
      break;
    default:
      launch_one<R, A, F, D, 8, BF>(p, n_blocks, threads, smem, st);
      break;
  }
}

template <bool R, bool A, bool F, bool D>
void launch_npt(const ArgsBf16& p, bool bf16, int n_blocks, int npt, int threads,
                size_t smem, cudaStream_t st) {
  if (bf16) {
    launch_mode<R, A, F, D, true>(p, n_blocks, npt, threads, smem, st);
  } else {
    launch_mode<R, A, F, D, false>(p, n_blocks, npt, threads, smem, st);
  }
}

template <bool R, bool A>
void launch_affine(const ArgsBf16& p, bool bf16, bool affine, bool dropout,
                   int n_blocks, int npt, int threads, size_t smem,
                   cudaStream_t st) {
  if (affine && dropout) {
    launch_npt<R, A, true, true>(p, bf16, n_blocks, npt, threads, smem, st);
  } else if (affine) {
    launch_npt<R, A, true, false>(p, bf16, n_blocks, npt, threads, smem, st);
  } else if (dropout) {
    launch_npt<R, A, false, true>(p, bf16, n_blocks, npt, threads, smem, st);
  } else {
    launch_npt<R, A, false, false>(p, bf16, n_blocks, npt, threads, smem,
                                   st);
  }
}

}  // namespace

// bf16 selects the bf16-stream mode: g, dwx, dd and VT are then bf16 (VT's
// rows padded to eight elements), and wx is bf16 where wx_bf16.
extern "C" int sparch_fused_cell_bwd(
    const void* g, const void* wx, const float* u_seq, const float* scale,
    const float* alpha, const float* beta, const float* a, const float* b,
    const void* VT, const float* u0, const float* w0, const float* s0,
    const int* seed, void* dwx, void* dd, float* partials, float* vecs,
    float* dV, float* dv_partials, float* du0, float* dw0, float* ds0,
    int B, int T, int H, float threshold, int recurrent, int adaptive,
    int affine, unsigned int keep_u32, float inv_keep, int tile_rows,
    int n_blocks, int ksplit, int bf16, int wx_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kThreads * kMaxNpt || !g || !u_seq ||
      !alpha || !u0 || !s0 || !dwx || !partials || !vecs || !du0 || !ds0 ||
      (recurrent && (!VT || !dV || !dv_partials)) ||
      (adaptive && (!beta || !a || !b || !w0 || !dw0)) ||
      (affine && (!wx || !scale)) || (affine && recurrent && !dd) ||
      (seed && tile_rows <= 0) || (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  // fewest neurons per thread that keep the block within kThreads
  int npt = 1;
  while ((H + npt - 1) / npt > kThreads) npt *= 2;
  const int bt = kWork / npt > 0 ? kWork / npt : 1;
  const int tiles = (H + kTile - 1) / kTile;
  if (n_blocks != (B + bt - 1) / bt || ksplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (((H + npt - 1) / npt) + 31) / 32 * 32;
  // the two dDrive buffers, then the stages of the V^T stream
  const size_t smem =
      recurrent ? (((2 * (size_t)H * bt + 3) & ~(size_t)3) +
                   (size_t)kStages * kTileFloats) * sizeof(float)
                : 0;
  const ArgsBf16 p{{g, wx, u_seq, scale, alpha, beta, a, b, VT, u0, w0, s0,
                    seed, dwx, dd, partials, du0, dw0, ds0, B, T, H,
                    threshold, keep_u32, inv_keep, tile_rows},
                   wx_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = seed != nullptr;
  if (recurrent && adaptive) {
    launch_affine<true, true>(p, bf16 != 0, affine, dropout, n_blocks, npt,
                              threads, smem, st);
  } else if (recurrent) {
    launch_affine<true, false>(p, bf16 != 0, affine, dropout, n_blocks, npt,
                               threads, smem, st);
  } else if (adaptive) {
    launch_affine<false, true>(p, bf16 != 0, affine, dropout, n_blocks, npt,
                               threads, smem, st);
  } else {
    launch_affine<false, false>(p, bf16 != 0, affine, dropout, n_blocks, npt,
                                threads, smem, st);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  const int n_vec = kVecs * H;
  vec_reduce_kernel<<<(n_vec + 255) / 256, 256, 0, st>>>(partials, alpha,
                                                         vecs, n_blocks, H);
  err = (int)cudaGetLastError();
  if (err != 0 || !recurrent) return err;

  const int R = B * T;
  // rows per split, a multiple of the stage depth
  int rows_per_split = (R + ksplit - 1) / ksplit;
  rows_per_split = (rows_per_split + kBK - 1) / kBK * kBK;
  const dim3 grid(tiles, tiles, ksplit);
  const void* dd_series = affine ? dd : dwx;
  if (bf16) {
    dv_kernel<__nv_bfloat16><<<grid, kDvThreads, 0, st>>>(
        u_seq, s0, static_cast<const __nv_bfloat16*>(dd_series), dv_partials,
        T, H, R, rows_per_split, threshold);
  } else {
    dv_kernel<float><<<grid, kDvThreads, 0, st>>>(
        u_seq, s0, static_cast<const float*>(dd_series), dv_partials, T, H,
        R, rows_per_split, threshold);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = H * H;
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(dv_partials, dV, ksplit,
                                                    n);
  return (int)cudaGetLastError();
}
