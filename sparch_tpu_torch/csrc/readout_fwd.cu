// Leaky cumulative-softmax readout forward for Hopper (sm_90a).
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_readout_fwd_kernel`, the TPU
// kernel behind readout_pallas. With a non-null u_out it also writes the
// membrane series (save_residuals=True), which the backward kernel
// (readout_bwd.cu) recomputes the softmax from.
//
// Per step, for one batch row over the C classes:
//   u_t = alpha*u_{t-1} + (1-alpha)*Wx_t
//   out += softmax(u_t)        (max-subtracted, e / sum(e))
//
// What bounds it on this card: latency again. At the serving shape
// (B=128, T=100, C=35) the kernel reads 1.8 MB and writes 18 KB, under a
// microsecond at HBM rate, but each row walks T dependent steps, each
// with two warp reductions (max and sum) and an exp.
//
// Design: one warp per batch row, looping over T; lane l holds classes
// l, l+32, ... (VPL values per lane: two at C=35). Max and sum are taken
// with __shfl_xor_sync butterflies, so every lane ends with both without
// shared memory or a barrier. Dead lanes (c >= C) take no part in the max
// and contribute e = 0. The next step's Wx is loaded before the
// reductions of this one. Updates use __fmul_rn/__fadd_rn and expf, as
// the plain PyTorch version (ops/fused_cells.py readout_plain) rounds;
// only the order of the class sum differs from it.
//
// C interface, bound with ctypes: sparch_readout_fwd returns
// cudaGetLastError() after the launch (or an invalid-value error for a
// shape it does not take) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxVpl = 8;  // so C <= 256

template <int VPL>
__global__ void __launch_bounds__(32)
readout_fwd_kernel(const float* __restrict__ wx,
                   const float* __restrict__ alpha,
                   const float* __restrict__ u0, float* __restrict__ out,
                   float* __restrict__ u_out, int T, int C) {
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* wx_row = wx + row * T * C;

  float al[VPL], oma[VPL], u[VPL], acc[VPL], x[VPL];
  bool live[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = lane + 32 * v;
    live[v] = c < C;
    al[v] = live[v] ? alpha[c] : 0.f;
    oma[v] = __fsub_rn(1.0f, al[v]);
    u[v] = live[v] ? u0[row * C + c] : 0.f;
    acc[v] = 0.f;
    x[v] = live[v] ? wx_row[c] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    float m = -INFINITY;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      u[v] = __fadd_rn(__fmul_rn(al[v], u[v]), __fmul_rn(oma[v], x[v]));
      if (live[v]) m = fmaxf(m, u[v]);
    }
    if (u_out) {
      float* u_row = u_out + (row * T + t) * C;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (live[v]) u_row[lane + 32 * v] = u[v];
      }
    }
    if (t + 1 < T) {
      const float* wx_next = wx_row + (size_t)(t + 1) * C;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        x[v] = live[v] ? wx_next[lane + 32 * v] : 0.f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float e[VPL];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      e[v] = live[v] ? expf(__fsub_rn(u[v], m)) : 0.f;
      sum = __fadd_rn(sum, e[v]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
    }
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      acc[v] = __fadd_rn(acc[v], __fdiv_rn(e[v], sum));
    }
  }

#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    if (live[v]) out[row * C + lane + 32 * v] = acc[v];
  }
}

}  // namespace

extern "C" int sparch_readout_fwd(const float* wx, const float* alpha,
                                  const float* u0, float* out, float* u_out,
                                  int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C > 32 * kMaxVpl || !wx || !alpha ||
      !u0 || !out) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vpl = (C + 31) / 32;
  if (vpl == 1) {
    readout_fwd_kernel<1><<<B, 32, 0, st>>>(wx, alpha, u0, out, u_out, T,
                                        C);
  } else if (vpl == 2) {
    readout_fwd_kernel<2><<<B, 32, 0, st>>>(wx, alpha, u0, out, u_out, T,
                                        C);
  } else if (vpl <= 4) {
    readout_fwd_kernel<4><<<B, 32, 0, st>>>(wx, alpha, u0, out, u_out, T,
                                        C);
  } else {
    readout_fwd_kernel<8><<<B, 32, 0, st>>>(wx, alpha, u0, out, u_out, T,
                                        C);
  }
  return (int)cudaGetLastError();
}
