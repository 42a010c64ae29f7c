// Fused non-spiking recurrent cell, forward, for Hopper (sm_90a): the
// sigmoid RNN, the LiGRU and the GRU in one template, with the per-gate
// batchnorm affine applied on load and the output dropout of
// dropout_hash.cuh.
//
// Replaces: sparch_tpu/ops/pallas_ann.py `_ann_fwd_kernel`, the TPU kernel
// behind rnn/ligru/gru_pallas, in its serving form (the output alone) and
// its training form (the residual series too), each in two stream modes
// (BF): float32 streams, and the TPU kernel's mxu_bf16 mode. In that mode
// the output, the raw-y series and the gate residuals are bf16 streams, the
// packed matrices are bf16 (rounded once by the wrapper), each input stream
// is float32 or bf16 as the projection emitted it, both operands of every
// product are rounded to bf16 (y, or r*y, where it is published) and summed
// in float32, and the carried y and all elementwise arithmetic stay float32.
//
// Per step, for one batch row (y is the previous step's state; gate 0 is
// the candidate with Wx and V, gate 1 the update z, gate 2 the reset r):
//   d_g   = scale_g*wx_g[t] + shift_g                 (with the affine)
//   RNN:    y = sigmoid(d_0 + y @ V)
//   LiGRU:  z = sigmoid(d_1 + y @ Vz);  c = relu(d_0 + y @ V)
//           y = z*y + (1-z)*c
//   GRU:    z = sigmoid(d_1 + y @ Vz);  r = sigmoid(d_2 + y @ Vr)
//           c = tanh(d_0 + (r*y) @ V);  y = z*y + (1-z)*c
//   out_t = keep ? y * 1/(1-p) : 0                    (dropout; else y)
// The raw y stays in the recurrence. Residuals, written only when asked
// for: the gate series (z[, r], c) and, under dropout, the raw y series
// beside the dropped output (without dropout the output is that series).
//
// What bounds it on this card: the dense products on the chain. Every
// step is a (rows, H) x (H, H) float32 product per gate against matrices
// that fit no SM (1 MB each at H = 512, 3 MB for the GRU), T steps one
// after another, and the GRU has two dependent products per step
// (y @ Vr -> r -> (r*y) @ V). At (128, 100, 512) the GRU does 20 GFLOP
// (0.30 ms at the float32 peak outside the tensor cores) on 105 MB of
// streams (31 us at HBM rate): operations bound it, and in this version
// the L2 traffic does, since every block reads every matrix at every
// step.
//
// Design (that of fused_cell_bwd.cu, whose adjoint product has the same
// shape):
// - One block owns BT batch rows for the whole sequence and loops over T;
//   thread j owns NPT neurons for all BT rows (BT*NPT = kWork, BT = 2 at
//   H <= 512) and keeps y in registers. Blocks run in no order and share
//   nothing, so the TPU kernel's sequential grid over time chunks, its
//   carried-product scratches and its padded tail have no counterpart.
// - The left operand of a product (y, or r*y) is published in shared
//   memory as [neuron][row] and read back as broadcasts; the matrices
//   stream from L2 through shared memory in 64 KB bulk-copy tiles behind
//   mbarriers (tile_stream.cuh), in the order a step reads them (RNN: V;
//   LiGRU: V, Vz; GRU: Vz, Vr, then V), packed so by the wrapper. Each
//   thread accumulates its columns over all H in ascending order with
//   FMAs: float32 outside the tensor cores, one fixed summation order.
// - The step's input streams are loaded before its products, so their
//   latency hides behind the stream.
// - Edges are masked: rows >= B and neurons >= H load nothing and store
//   nothing; nothing is padded but the rows of the packed matrices.
//
// C interface, bound with ctypes: sparch_fused_ann_fwd returns
// cudaGetLastError() after the launch (or an invalid-value error for
// arguments it does not take) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tile_stream.cuh"

namespace {

using namespace sparch;

constexpr int kThreads = 512;
constexpr int kWork = 2;    // rows a block owns times neurons a thread owns
constexpr int kMaxNpt = 4;  // so H <= kThreads * kMaxNpt = 2048
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

struct Args {
  const void* wx[3];   // float, or bf16 where wx_bf16 (bf16 mode only)
  const float* scale;  // (gates, H), or null for no affine
  const float* shift;
  const void* V;       // the packed matrices, in the step's order; bf16 in
                       // the bf16 mode, like the five output series
  const float* y0;
  const int* seed;     // null for no dropout
  void* y_out;
  void* yraw_out;      // null unless residuals under dropout
  void* z_out;         // the gate series, null without residuals
  void* r_out;
  void* c_out;
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

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int MODE, int NPT, bool BF>
__global__ void __launch_bounds__(kThreads)
fused_ann_fwd_kernel(const typename ModeArgs<BF>::type p) {
  using ST = typename Elem<BF>::type;
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  constexpr int G = MODE + 1;
  // the published left operand (H*BT floats), then the stream's stages
  extern __shared__ __align__(16) float pub[];
  __shared__ uint64_t full[kStages];
  const int H = p.H;
  const int T = p.T;
  const int row0 = blockIdx.x * BT;
  const bool affine = p.scale != nullptr;
  const bool dropout = p.seed != nullptr;

  TileStream<ST> s = stream_over(
      static_cast<const ST*>(p.V),
      reinterpret_cast<ST*>(pub + ((H * BT + 3) & ~3)), full, H, G, T);
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  float sc[G][NPT], sh[G][NPT];
  float y[NPT][BT];
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
      sh[g][i] = affine ? p.shift[g * H + col[i]] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      y[i][r] = (live[i] && rowlive[r])
                    ? p.y0[(size_t)(row0 + r) * H + col[i]]
                    : 0.f;
    }
  }
  publish<NPT, BT, BF>(pub, y, col, live);
  stream_open(s);

  for (int t = 0; t < T; ++t) {
    float d[G][NPT][BT];
    float acc[G][NPT][BT];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const size_t at = ((size_t)(row0 + r) * T + t) * H + col[i];
          const float x = (live[i] && rowlive[r])
                              ? load_stream<BF>(p.wx[g], at, wx_bf16)
                              : 0.f;
          d[g][i][r] = affine ? sc[g][i] * x + sh[g][i] : x;
          acc[g][i][r] = 0.f;
        }
      }
    }
    float z[NPT][BT], rr[NPT][BT], c[NPT][BT];
    if constexpr (MODE == kGru) {
      stream_matrix<NPT, BT>(s, pub, col, acc[1]);  // y @ Vz
      stream_matrix<NPT, BT>(s, pub, col, acc[2]);  // y @ Vr
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
      publish<NPT, BT, BF>(pub, ry, col, live);
      stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // (r*y) @ V
    } else {
      stream_matrix<NPT, BT>(s, pub, col, acc[0]);  // y @ V
      if constexpr (MODE == kLigru) {
        stream_matrix<NPT, BT>(s, pub, col, acc[1]);  // y @ Vz
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
        if (!(live[i] && rowlive[r])) continue;
        const size_t at = ((size_t)(row0 + r) * T + t) * H + col[i];
        float stored = y[i][r];
        if (dropout) {
          stored = dropout_keep(drop_base[r], col[i], t, p.keep_u32)
                       ? y[i][r] * p.inv_keep
                       : 0.f;
        }
        static_cast<ST*>(p.y_out)[at] = from_float<ST>(stored);
        if (p.yraw_out) {
          static_cast<ST*>(p.yraw_out)[at] = from_float<ST>(y[i][r]);
        }
        if constexpr (MODE != kRnn) {
          if (p.c_out) {
            static_cast<ST*>(p.z_out)[at] = from_float<ST>(z[i][r]);
            static_cast<ST*>(p.c_out)[at] = from_float<ST>(c[i][r]);
            if constexpr (MODE == kGru) {
              static_cast<ST*>(p.r_out)[at] = from_float<ST>(rr[i][r]);
            }
          }
        }
      }
    }
    // every thread left the last product behind its closing barrier, so
    // the buffer is free for the next step's left operand
    publish<NPT, BT, BF>(pub, y, col, live);
  }
}

template <int MODE, int NPT, bool BF>
void launch_one(const ArgsBf16& p, int threads, cudaStream_t st) {
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  const int n_blocks = (p.B + BT - 1) / BT;
  const size_t smem = ((((size_t)p.H * BT + 3) & ~(size_t)3) +
                       (size_t)kStages * kTileFloats) * sizeof(float);
  // more than 48 KB of dynamic shared memory has to be asked for
  cudaFuncSetAttribute(fused_ann_fwd_kernel<MODE, NPT, BF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_ann_fwd_kernel<MODE, NPT, BF><<<n_blocks, threads, smem, st>>>(p);
}

template <int MODE, bool BF>
void launch_mode(const ArgsBf16& p, int npt, int threads, cudaStream_t st) {
  switch (npt) {
    case 1: launch_one<MODE, 1, BF>(p, threads, st); break;
    case 2: launch_one<MODE, 2, BF>(p, threads, st); break;
    default: launch_one<MODE, 4, BF>(p, threads, st); break;
  }
}

template <int MODE>
void launch_npt(const ArgsBf16& p, bool bf16, int npt, int threads,
                cudaStream_t st) {
  if (bf16) {
    launch_mode<MODE, true>(p, npt, threads, st);
  } else {
    launch_mode<MODE, false>(p, npt, threads, st);
  }
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU. Null pointers switch parts off: scale and
// shift (no affine), seed (no dropout), yraw_out and the gate series (no
// residuals). wx1/wx2 and the gate series of gates the mode lacks are
// ignored. bf16 selects the bf16-stream mode: V (rows padded to eight
// elements) and the five output series are then bf16, and the input streams
// are bf16 where wx_bf16.
extern "C" int sparch_fused_ann_fwd(
    const void* wx0, const void* wx1, const void* wx2, const float* scale,
    const float* shift, const void* V, const float* y0, const int* seed,
    void* y_out, void* yraw_out, void* z_out, void* r_out, void* c_out,
    int B, int T, int H, int mode, unsigned int keep_u32, float inv_keep,
    int tile_rows, int bf16, int wx_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kThreads * kMaxNpt || mode < kRnn ||
      mode > kGru || !wx0 || (mode >= kLigru && !wx1) ||
      (mode == kGru && !wx2) || !V || !y0 || !y_out ||
      ((scale == nullptr) != (shift == nullptr)) ||
      (seed && tile_rows <= 0) || (wx_bf16 && !bf16) ||
      (mode >= kLigru && ((z_out == nullptr) != (c_out == nullptr))) ||
      (mode == kGru && ((r_out == nullptr) != (c_out == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  // fewest neurons per thread that keep the block within kThreads
  int npt = 1;
  while ((H + npt - 1) / npt > kThreads) npt *= 2;
  const int threads = (((H + npt - 1) / npt) + 31) / 32 * 32;
  const ArgsBf16 p{{{wx0, wx1, wx2}, scale, shift, V, y0, seed, y_out,
                    yraw_out, z_out, r_out, c_out, B, T, H, keep_u32,
                    inv_keep, tile_rows},
                   wx_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRnn: launch_npt<kRnn>(p, bf16 != 0, npt, threads, st); break;
    case kLigru: launch_npt<kLigru>(p, bf16 != 0, npt, threads, st); break;
    default: launch_npt<kGru>(p, bf16 != 0, npt, threads, st); break;
  }
  return (int)cudaGetLastError();
}
