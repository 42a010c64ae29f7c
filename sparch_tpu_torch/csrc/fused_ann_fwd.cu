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
// product are rounded to bf16 (y, or r*y, where it is exchanged) and summed
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
// What bounds it on this card: the dense products on the chain, a (rows,
// H) x (H, H) float32 product per gate and step, T steps one after another,
// and the GRU's two dependent products per step (y @ Vr -> r -> (r*y) @ V).
// At (128, 100, 512) the GRU does 20 GFLOP (0.30 ms at the float32 peak
// outside the tensor cores) on 105 MB of streams (31 us at HBM rate):
// operations bound it.
//
// Design (cluster_slice.cuh): a thread-block cluster of C blocks owns R
// batch rows for the whole sequence, block k the column slice k*Hs ..
// k*Hs+Hs-1 of every matrix; thread (tx, ty) owns neuron k*Hs + tx for four
// of the rows, every gate, y in registers. A step runs its products in
// passes (RNN: V; LiGRU: [V | Vz]; GRU: [Vz | Vr], then V), each thread
// summing its column over all H rows in ascending order with FMAs, one
// shared-memory load of a matrix element for four rows. After each pass
// that feeds another (the GRU's r*y, every step's y but the last) each
// block stores its columns into every block's operand buffer through
// distributed shared memory and the cluster crosses one barrier; the GRU's
// r*y lands on parity 0 and y on parity 1, the RNN's and LiGRU's y of step
// t on parity (t+1) & 1. The slice stays in shared memory where it fits
// beside the operands, else it streams from L2 once per cluster and step.
// - The step's input streams are loaded before its products, so their
//   latency hides behind them.
// - Edges are masked: rows >= B and neurons >= H load nothing and store
//   nothing; the packed slices are zero past H.
// - The sums and the elementwise code are those of the kernel this design
//   replaced (one block for whole rows, streaming every matrix), so the
//   outputs are its outputs bit for bit, and those of tp_ann_fwd.cu
//   without the affine and the dropout.
//
// C interface, bound with ctypes: sparch_fused_ann_fwd checks the plan it
// is given (ops/fused_ann.py `_fwd_plan`) against its own, launches the
// clusters with cudaLaunchKernelEx, returns the launch's error (or an
// invalid-value error for arguments it does not take) and never
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slice.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace sparch;
using slice::kRt;

constexpr int kMaxH = 2048;
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

struct Args {
  const void* wx[3];   // float, or bf16 where wx_bf16 (bf16 mode only)
  const float* scale;  // (gates, H), or null for no affine
  const float* shift;
  const void* V;       // the packed slices, [cluster][passes]; bf16 in the
                       // bf16 mode, like the five output series
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
  DropRows drop;
  int wx_bf16;         // the input streams are bf16, not float
  slice::Plan plan;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int MODE, bool BF>
__global__ void __launch_bounds__(slice::kMaxThreads, 1)
fused_ann_fwd_kernel(const Args p) {
  using ST = typename Elem<BF>::type;
  constexpr int G = MODE + 1;
  // the gates of the first pass (the GRU's second pass holds V)
  constexpr int NA = MODE == kRnn ? 1 : 2;
  // two parities of the [j][row] operand (R*H floats each), then the
  // resident slice or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const int H = p.H, T = p.T, R = pl.rows, Hs = pl.cols, C = pl.cluster;
  const int k = (int)(blockIdx.x % C);
  const int row_base = (int)(blockIdx.x / C) * R;
  const size_t RH = (size_t)R * H;
  float* const op0 = smem;  // the two parities of the operand
  float* const op1 = smem + RH;

  const int tx = threadIdx.x % Hs;
  const int ty_raw = threadIdx.x / Hs;
  const bool thread_live = ty_raw < R / kRt;
  const int ry0 = thread_live ? ty_raw * kRt : 0;
  const int row0 = row_base + ry0;
  const int col = k * Hs + tx;
  const bool live = thread_live && col < H;
  const bool affine = p.scale != nullptr;
  const bool dropout = p.seed != nullptr;
  const bool wx_bf16 = BF && p.wx_bf16;

  const int gates[2] = {NA, MODE == kGru ? 1 : 0};
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.V) + (size_t)k * G * H * Hs,
      reinterpret_cast<ST*>(smem + 2 * RH), full, pl, H, Hs, gates, T);
  slice::begin(s);

  float sc[G], sh[G];
  float y[kRt];
  bool rowlive[kRt];
  uint32_t drop_base[kRt];
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    rowlive[r] = thread_live && row0 + r < p.B;
    drop_base[r] = (dropout && rowlive[r])
                       ? dropout_row_base(p.seed, row0 + r, p.drop)
                       : 0u;
  }
  const int c0 = live ? col : 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sc[g] = affine ? p.scale[g * H + c0] : 1.f;
    sh[g] = affine ? p.shift[g * H + c0] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    y[r] = (live && rowlive[r]) ? p.y0[(size_t)(row0 + r) * H + col] : 0.f;
  }
  // the first left operand, the cluster's rows of y0: the GRU reads y
  // from parity 1, the others y of step t from parity t & 1
  slice::load_state<BF>(MODE == kGru ? op1 : op0, p.y0, p.B, H, R,
                        row_base);
  // every block of the cluster runs, and its operand is in place
  slice::cluster_barrier();
  slice::await_resident(s);

  for (int t = 0; t < T; ++t) {
    float d[G][kRt];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        const size_t at = ((size_t)(row0 + r) * T + t) * H + col;
        const float x = (live && rowlive[r])
                            ? load_stream<BF>(p.wx[g], at, wx_bf16)
                            : 0.f;
        d[g][r] = affine ? sc[g] * x + sh[g] : x;
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
      if (live) slice::to_cluster<BF>(op0, (size_t)col * R + ry0, ry, C);
      slice::cluster_barrier();
      float ac[1][kRt] = {};
      slice::pass<1, true>(s, 1, op0 + ry0, 0, R, tx, Hs, ac);  // (r*y) @ V
#pragma unroll
      for (int r = 0; r < kRt; ++r) pre[r] = d[0][r] + ac[0][r];
    } else {
      slice::pass<NA, true>(s, 0, ((t & 1) ? op1 : op0) + ry0, 0, R, tx, Hs,
                            a);
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
      if (!(live && rowlive[r])) continue;
      const size_t at = ((size_t)(row0 + r) * T + t) * H + col;
      float stored = y[r];
      if (dropout) {
        stored = dropout_keep(drop_base[r], col, t, p.keep_u32)
                     ? y[r] * p.inv_keep
                     : 0.f;
      }
      static_cast<ST*>(p.y_out)[at] = from_float<ST>(stored);
      if (p.yraw_out) {
        static_cast<ST*>(p.yraw_out)[at] = from_float<ST>(y[r]);
      }
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
    if (t + 1 == T) break;  // the last step's y feeds nothing
    float* next = (MODE == kGru || !(t & 1)) ? op1 : op0;
    if (live) slice::to_cluster<BF>(next, (size_t)col * R + ry0, y, C);
    slice::cluster_barrier();
  }
}

using Kernel = void (*)(Args);

template <int MODE>
Kernel kernel_of(int bf16) {
  return bf16 ? fused_ann_fwd_kernel<MODE, true>
              : fused_ann_fwd_kernel<MODE, false>;
}

// The instantiation that a launch of the mode takes.
Kernel kernel_for(int mode, int bf16) {
  switch (mode) {
    case kRnn: return kernel_of<kRnn>(bf16);
    case kLigru: return kernel_of<kLigru>(bf16);
    default: return kernel_of<kGru>(bf16);
  }
}

slice::Plan fwd_plan(int B, int H, int mode, int bf16) {
  return slice::make_plan(B, H, mode + 1, bf16 ? 2 : 4, 1);
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU. Null pointers switch parts off: scale and
// shift (no affine), seed (no dropout), yraw_out and the gate series (no
// residuals). wx1/wx2 and the gate series of gates the mode lacks are
// ignored. bf16 selects the bf16-stream mode: V and the five output series
// are then bf16, and the input streams are bf16 where wx_bf16. V: every
// block's slice of the step's matrices (ops/fused_ann.py `_pack_slices`);
// cluster, rows and resident: the plan the wrapper packed it for.
extern "C" int sparch_fused_ann_fwd(
    const void* wx0, const void* wx1, const void* wx2, const float* scale,
    const float* shift, const void* V, const float* y0, const int* seed,
    void* y_out, void* yraw_out, void* z_out, void* r_out, void* c_out,
    int B, int T, int H, int mode, unsigned int keep_u32, float inv_keep,
    int tile_rows, int row_seg, int row_stride, int row_off, int bf16,
    int wx_bf16, int cluster, int rows, int resident, void* stream) {
  const DropRows drop{tile_rows, row_seg, row_stride, row_off};
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxH || mode < kRnn ||
      mode > kGru || !wx0 || (mode >= kLigru && !wx1) ||
      (mode == kGru && !wx2) || !V || !y0 || !y_out ||
      ((scale == nullptr) != (shift == nullptr)) ||
      (seed && !drop_rows_ok(drop)) || (wx_bf16 && !bf16) ||
      (mode >= kLigru && ((z_out == nullptr) != (c_out == nullptr))) ||
      (mode == kGru && ((r_out == nullptr) != (c_out == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  const slice::Plan pl = fwd_plan(B, H, mode, bf16);
  if (cluster != pl.cluster || rows != pl.rows || resident != pl.resident ||
      pl.threads > slice::kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const Args p{{wx0, wx1, wx2}, scale, shift, V, y0, seed, y_out, yraw_out,
               z_out, r_out, c_out, B, T, H, keep_u32, inv_keep, drop,
               wx_bf16, pl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = (int)slice::launch(kernel_for(mode, bf16), pl, p, st);
  return err != 0 ? err : (int)cudaGetLastError();
}

// How many clusters of the forward's plan for (B, H, mode, bf16) the card
// holds at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int sparch_fused_ann_fwd_max_clusters(int B, int H, int mode,
                                                 int bf16) {
  if (B <= 0 || H <= 0 || H > kMaxH || mode < kRnn || mode > kGru) return -1;
  const slice::Plan pl = fwd_plan(B, H, mode, bf16);
  return slice::max_active_clusters(kernel_for(mode, bf16), pl);
}
