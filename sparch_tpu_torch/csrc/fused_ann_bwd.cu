// Fused non-spiking recurrent cell, backward, for Hopper (sm_90a):
// reverse-time BPTT of the sigmoid RNN, the LiGRU and the GRU in one
// template, with the per-gate batchnorm affine and the output dropout of
// the forward.
//
// Replaces: sparch_tpu/ops/pallas_ann.py `_ann_bwd_kernel`, the TPU kernel
// behind the VJP of rnn/ligru/gru_pallas, in two stream modes (BF):
// float32 streams, and the TPU kernel's mxu_bf16 mode. In that mode g, the
// residual series (raw y, z, r, c) and the per-gate dWx are bf16 streams,
// the packed transposed matrices are bf16, each raw input stream (read with
// the affine) is float32 or bf16 as the forward got it, every dpre is
// rounded to bf16 where it enters a product (the adjoint product and dV, so
// the scratch series the dV kernel reads are bf16), the dV products' left
// operands are rounded too (y0 and r*y_p; a stored y is bf16 already), and
// dWx = bf16(dpre*scale); dscale and dshift (from the float32 dpre), dV and
// dy0 stay float32 in their fixed order.
//
// With G_t the total adjoint of y_t (the output cotangent, masked and
// scaled like the forward's output under dropout, plus what step t+1
// carries back) and y_p = y_{t-1} (y0 at the first step), walking
// t = T..1 (gate 0 is the candidate with V, gate 1 the update z with Vz,
// gate 2 the reset r with Vr):
//   RNN:   dpre  = G*y_t*(1-y_t)
//          G_{t-1} += dpre @ V^T
//   LiGRU: dcpre = c > 0 ? G*(1-z) : 0 ;  dzpre = G*(y_p-c)*z*(1-z)
//          G_{t-1} += G*z + dcpre @ V^T + dzpre @ Vz^T
//   GRU:   dcpre = G*(1-z)*(1-c^2) ;  dzpre = G*(y_p-c)*z*(1-z)
//          dry   = dcpre @ V^T ;  drpre = dry*y_p*r*(1-r)
//          G_{t-1} += G*z + dry*r + dzpre @ Vz^T + drpre @ Vr^T
//   per gate: dWx_t = dpre*scale ; dscale = sum dpre*wx ; dshift = sum dpre
//             dV = sum y_p^T dpre   (the GRU's candidate: (r*y_p)^T dcpre)
//   dy0 = G_0
// It reads the residual series of the forward (the raw y, z[, r], c) and
// regenerates the dropout mask from the seed.
//
// What bounds it on this card: as in the forward, the dense products on
// the chain, one adjoint product per gate and step against a V^T that fits
// no SM, two of the GRU's three dependent (dcpre @ V^T -> drpre ->
// drpre @ Vr^T); then the dV outer products, 2*B*T*H*H FLOP per gate. At
// (128, 100, 512) the GRU does 40 GFLOP (0.60 ms at the float32 peak
// outside the tensor cores) on 290 MB of streams (87 us at HBM rate):
// operations bound it, and in this version the L2 traffic of the time
// loop does.
//
// Design:
// - Time loop: that of fused_ann_fwd.cu in reverse. One block owns BT
//   batch rows for all T, thread j owns NPT neurons with the carried
//   adjoint in registers, each gate's dpre is published in shared memory
//   as [neuron][row], and the transposed matrices (V^T, Vz^T, Vr^T,
//   transposed, row-padded and packed once by the wrapper) stream from L2
//   in 64 KB bulk-copy tiles behind mbarriers (tile_stream.cuh), summed in
//   ascending order with FMAs.
// - Reductions are in a fixed order, so two runs give the same bits, and
//   use no atomics. dscale and dshift: each thread sums its neurons over
//   its rows and all T in registers and writes partials[block][2*gates][H];
//   a second kernel adds the blocks in ascending order. dV: a product
//   kernel after the time loop, per gate one (H, B*T) x (B*T, H) product
//   of the y series shifted by one step (times r for the GRU's candidate)
//   with the stored dpre series (dWx itself without the affine, else a
//   scratch series written beside it, since dWx is then dpre*scale).
//   64x64 tiles, 4x4 per thread, split over B*T into partials that the
//   same second kernel adds in ascending order (dv_product.cuh, shared
//   with tp_ann_bwd.cu).
// - Edges are masked: rows >= B and neurons >= H load nothing, hold zero
//   adjoints and store nothing.
//
// C interface, bound with ctypes: sparch_fused_ann_bwd enqueues all the
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
constexpr int kWork = 2;    // rows a block owns times neurons a thread owns
constexpr int kMaxNpt = 4;  // so H <= kThreads * kMaxNpt = 2048
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

struct Args {
  const void* g;       // g and the residual series: float, bf16 in bf16 mode
  const void* wx[3];   // the raw input streams, read only with the affine;
                       // float, or bf16 where wx_bf16 (bf16 mode only)
  const void* y_seq;
  const void* z;
  const void* r;
  const void* c;
  const float* scale;  // (gates, H), or null for no affine
  const void* VT;      // the packed transposed matrices, by gate
  const float* y0;
  const int* seed;     // null for no dropout
  void* dwx[3];        // float, bf16 in the bf16 mode, like dd
  void* dd[3];         // dpre before the scale, written only with the affine
  float* partials;
  float* dy0;
  int B;
  int T;
  int H;
  uint32_t keep_u32;
  float inv_keep;
  int tile_rows;
};

// The bf16 mode's one more flag rides in a struct of its own, so that the
// float32 kernels' parameter block, and with it their code, stays what it
// was before the mode existed (an int appended to Args changed how the
// float32 time loops compiled).
struct ArgsBf16 : Args {
  int wx_bf16;  // the input streams are bf16, not float
};
template <bool BF>
struct ModeArgs {
  using type = Args;
};
template <>
struct ModeArgs<true> {
  using type = ArgsBf16;
};

template <int NPT, int BT>
__device__ __forceinline__ void clear(float (&acc)[NPT][BT]) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[i][r] = 0.f;
  }
}

template <int MODE, int NPT, bool BF>
__global__ void __launch_bounds__(kThreads)
fused_ann_bwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  constexpr int G = MODE + 1;
  // one published dpre per gate (H*BT floats each), then the stream's
  // stages
  extern __shared__ __align__(16) float pub[];
  __shared__ uint64_t full[kStages];
  const int H = p.H;
  const int T = p.T;
  const int row0 = blockIdx.x * BT;
  const bool affine = p.scale != nullptr;
  const bool dropout = p.seed != nullptr;

  TileStream<ST> s = stream_over(
      static_cast<const ST*>(p.VT),
      reinterpret_cast<ST*>(pub + ((G * H * BT + 3) & ~3)), full, H, G, T);
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;
  const ST* g_in = static_cast<const ST*>(p.g);
  const ST* y_seq = static_cast<const ST*>(p.y_seq);
  const ST* z_in = static_cast<const ST*>(p.z);
  const ST* r_in = static_cast<const ST*>(p.r);
  const ST* c_in = static_cast<const ST*>(p.c);

  float sc[G][NPT], dsc[G][NPT], dsh[G][NPT];
  float D[NPT][BT];
  int col[NPT];
  bool live[NPT];
  bool rowlive[BT];
  uint32_t drop_base[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    rowlive[r] = row0 + r < p.B;
    drop_base[r] = (dropout && rowlive[r])
                       ? dropout_row_base(p.seed, row0 + r, p.tile_rows)
                       : 0u;
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    live[i] = j < H;
    col[i] = live[i] ? j : 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g][i] = affine ? p.scale[g * H + col[i]] : 1.f;
      dsc[g][i] = dsh[g][i] = 0.f;
    }
  }
  clear<NPT, BT>(D);
  stream_open(s);

  for (int t = T - 1; t >= 0; --t) {
    float Gt[NPT][BT], yp[NPT][BT], z[NPT][BT], rr[NPT][BT], c[NPT][BT];
    float dpre[G][NPT][BT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const bool ok = live[i] && rowlive[r];
        const size_t row = (size_t)(row0 + r);
        const size_t at = (row * T + t) * H + col[i];
        float g_t = ok ? to_float(g_in[at]) : 0.f;
        if (dropout) {
          g_t = dropout_keep(drop_base[r], col[i], t, p.keep_u32)
                    ? g_t * p.inv_keep
                    : 0.f;
        }
        Gt[i][r] = g_t + D[i][r];
        if constexpr (MODE == kRnn) {
          const float y_t = ok ? to_float(y_seq[at]) : 0.f;
          dpre[0][i][r] = Gt[i][r] * y_t * (1.0f - y_t);
        } else {
          yp[i][r] = !ok ? 0.f
                         : (t > 0 ? to_float(y_seq[at - H])
                                  : p.y0[row * H + col[i]]);
          z[i][r] = ok ? to_float(z_in[at]) : 0.f;
          c[i][r] = ok ? to_float(c_in[at]) : 0.f;
          const float omz = 1.0f - z[i][r];
          dpre[1][i][r] = Gt[i][r] * (yp[i][r] - c[i][r]) * z[i][r] * omz;
          if constexpr (MODE == kLigru) {
            dpre[0][i][r] = c[i][r] > 0.f ? Gt[i][r] * omz : 0.f;
          } else {
            rr[i][r] = ok ? to_float(r_in[at]) : 0.f;
            dpre[0][i][r] = Gt[i][r] * omz * (1.0f - c[i][r] * c[i][r]);
          }
        }
      }
    }
    // the step before left its last product behind a barrier, so the
    // buffers are free
    float acc[G][NPT][BT];
    publish<NPT, BT, BF>(pub, dpre[0], col, live);
    clear<NPT, BT>(acc[0]);
    if constexpr (MODE != kRnn) {
      publish<NPT, BT, BF>(pub + H * BT, dpre[1], col, live);
      clear<NPT, BT>(acc[1]);
    }
    stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // dpre_0 @ V^T
    if constexpr (MODE == kGru) {
      // acc[0] is dry, the adjoint of r*y_p
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          dpre[2][i][r] =
              acc[0][i][r] * yp[i][r] * rr[i][r] * (1.0f - rr[i][r]);
        }
      }
      publish<NPT, BT, BF>(pub + 2 * H * BT, dpre[2], col, live);
      clear<NPT, BT>(acc[2]);
    }
    if constexpr (MODE != kRnn) {
      stream_matrix<NPT, BT>(s, pub + H * BT, col, acc[1]);  // @ Vz^T
    }
    if constexpr (MODE == kGru) {
      stream_matrix<NPT, BT>(s, pub + 2 * H * BT, col, acc[2]);  // @ Vr^T
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
        const bool ok = live[i] && rowlive[r];
        const size_t at = ((size_t)(row0 + r) * T + t) * H + col[i];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float dp = dpre[g][i][r];
          if (affine) {
            const float wx_t =
                ok ? load_stream<BF>(p.wx[g], at, wx_bf16) : 0.f;
            dsc[g][i] += dp * wx_t;
            dsh[g][i] += dp;
            if (ok) {
              static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dp * sc[g][i]);
              static_cast<ST*>(p.dd[g])[at] = from_float<ST>(dp);
            }
          } else if (ok) {
            static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dp);
          }
        }
      }
    }
  }

  float* part = p.partials + (size_t)blockIdx.x * 2 * G * H;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (rowlive[r]) p.dy0[(size_t)(row0 + r) * H + col[i]] = D[i][r];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      part[g * H + col[i]] = dsc[g][i];
      part[(G + g) * H + col[i]] = dsh[g][i];
    }
  }
}

template <int MODE, int NPT, bool BF>
void launch_one(const ArgsBf16& p, int n_blocks, int threads, cudaStream_t st) {
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  constexpr int G = MODE + 1;
  const size_t smem = ((((size_t)G * p.H * BT + 3) & ~(size_t)3) +
                       (size_t)kStages * kTileFloats) * sizeof(float);
  // more than 48 KB of dynamic shared memory has to be asked for
  cudaFuncSetAttribute(fused_ann_bwd_kernel<MODE, NPT, BF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_ann_bwd_kernel<MODE, NPT, BF><<<n_blocks, threads, smem, st>>>(p);
}

template <int MODE, bool BF>
void launch_mode(const ArgsBf16& p, int n_blocks, int npt, int threads,
                 cudaStream_t st) {
  switch (npt) {
    case 1: launch_one<MODE, 1, BF>(p, n_blocks, threads, st); break;
    case 2: launch_one<MODE, 2, BF>(p, n_blocks, threads, st); break;
    default: launch_one<MODE, 4, BF>(p, n_blocks, threads, st); break;
  }
}

template <int MODE>
void launch_npt(const ArgsBf16& p, bool bf16, int n_blocks, int npt, int threads,
                cudaStream_t st) {
  if (bf16) {
    launch_mode<MODE, true>(p, n_blocks, npt, threads, st);
  } else {
    launch_mode<MODE, false>(p, n_blocks, npt, threads, st);
  }
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU. Null pointers switch parts off: scale (no
// affine: wx, dd and vecs are then not touched) and seed (no dropout).
// Operands of gates the mode lacks are ignored. vecs is (2*gates, H):
// dscale by gate, then dshift by gate. bf16 selects the bf16-stream mode:
// g, the residual series, dwx, dd and VT (rows padded to eight elements) are
// then bf16, and the raw input streams are bf16 where wx_bf16.
extern "C" int sparch_fused_ann_bwd(
    const void* g, const void* wx0, const void* wx1, const void* wx2,
    const void* y_seq, const void* z, const void* r, const void* c,
    const float* scale, const void* VT, const float* y0, const int* seed,
    void* dwx0, void* dwx1, void* dwx2, void* dd0, void* dd1,
    void* dd2, float* partials, float* vecs, float* dV, float* dv_partials,
    float* dy0, int B, int T, int H, int mode, unsigned int keep_u32,
    float inv_keep, int tile_rows, int n_blocks, int ksplit, int bf16,
    int wx_bf16, void* stream) {
  const void* wx[3] = {wx0, wx1, wx2};
  void* dwx[3] = {dwx0, dwx1, dwx2};
  void* dd[3] = {dd0, dd1, dd2};
  if (B <= 0 || T <= 0 || H <= 0 || H > kThreads * kMaxNpt || mode < kRnn ||
      mode > kGru || !g || !y_seq || !VT || !y0 || !partials || !vecs ||
      !dV || !dv_partials || !dy0 || (mode >= kLigru && (!z || !c)) ||
      (mode == kGru && !r) || (seed && tile_rows <= 0) || ksplit < 1 ||
      (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = mode + 1;
  const bool affine = scale != nullptr;
  for (int k = 0; k < G; ++k) {
    if (!dwx[k] || (affine && (!wx[k] || !dd[k]))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  // fewest neurons per thread that keep the block within kThreads
  int npt = 1;
  while ((H + npt - 1) / npt > kThreads) npt *= 2;
  const int bt = kWork / npt > 0 ? kWork / npt : 1;
  if (n_blocks != (B + bt - 1) / bt) return (int)cudaErrorInvalidValue;
  const int threads = (((H + npt - 1) / npt) + 31) / 32 * 32;
  const ArgsBf16 p{{g, {wx0, wx1, wx2}, y_seq, z, r, c, scale, VT, y0, seed,
                    {dwx0, dwx1, dwx2}, {dd0, dd1, dd2}, partials, dy0, B, T,
                    H, keep_u32, inv_keep, tile_rows},
                   wx_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRnn:
      launch_npt<kRnn>(p, bf16 != 0, n_blocks, npt, threads, st);
      break;
    case kLigru:
      launch_npt<kLigru>(p, bf16 != 0, n_blocks, npt, threads, st);
      break;
    default:
      launch_npt<kGru>(p, bf16 != 0, n_blocks, npt, threads, st);
      break;
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  if (affine) {
    const int n_vec = 2 * G * H;
    sum_parts_kernel<<<(n_vec + 255) / 256, 256, 0, st>>>(partials, vecs,
                                                          n_blocks, n_vec);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }

  const int R = B * T;
  // rows per split, a multiple of the stage depth
  int rows_per_split = (R + ksplit - 1) / ksplit;
  rows_per_split = (rows_per_split + kBK - 1) / kBK * kBK;
  AnnDvArgs a{y_seq, y0, mode == kGru ? r : nullptr, {}, dv_partials, T, H,
              R, rows_per_split, G};
  for (int k = 0; k < 3; ++k) a.dpre[k] = affine ? dd[k] : dwx[k];
  const int tiles = (H + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, G * ksplit);
  if (bf16) {
    ann_dv_kernel<__nv_bfloat16><<<grid, kDvThreads, 0, st>>>(a);
  } else {
    ann_dv_kernel<float><<<grid, kDvThreads, 0, st>>>(a);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = G * H * H;
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(dv_partials, dV, ksplit,
                                                    n);
  return (int)cudaGetLastError();
}
