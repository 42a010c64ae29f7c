// Leaky cumulative-softmax readout backward for Hopper (sm_90a).
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_readout_bwd_kernel`, the TPU
// kernel behind the VJP of readout_pallas.
//
// out = sum_t softmax(u_t) with u_t = alpha*u_{t-1} + (1-alpha)*Wx_t, and
// gout its cotangent, constant over t. With p_t = softmax(u_t) recomputed
// from the saved u series, for one batch row, walking t = T..1:
//   G_t    = p_t * (gout - <p_t, gout>) + alpha*G_{t+1}
//   dWx_t  = (1-alpha) * G_t
//   dalpha = sum_{b,t} G_t * (u_{t-1} - u_t) / (1-alpha)
//   du_0   = alpha * G_1
// (u_{t-1} - Wx_t = (u_{t-1} - u_t)/(1-alpha), the divide hoisted out of
// the loop; u_0 as given.)
//
// What bounds it on this card: latency, like the forward. At the training
// shape (B=128, T=100, C=35) it reads 1.8 MB and writes 1.8 MB, about a
// microsecond at HBM rate, but each row walks T dependent steps with three
// warp reductions (max, sum, <p, gout>) and an exp.
//
// Design: one warp per batch row, looping over T in reverse; lane l holds
// classes l, l+32, ... (VPL values per lane). The reductions are
// __shfl_xor_sync butterflies. The previous step's u is loaded before the
// reductions of this one. Each row writes its dalpha sum over T to
// partials[row][C]; a second kernel adds the rows in ascending order and
// divides by 1-alpha, so two runs give the same bits (no atomics).
//
// C interface, bound with ctypes: sparch_readout_bwd enqueues both kernels,
// returns cudaGetLastError() (or an invalid-value error for a shape it
// does not take) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxVpl = 8;  // so C <= 256

template <int VPL>
__global__ void __launch_bounds__(32)
readout_bwd_kernel(const float* __restrict__ gout,
                   const float* __restrict__ u_seq,
                   const float* __restrict__ alpha,
                   const float* __restrict__ u0, float* __restrict__ dwx,
                   float* __restrict__ partials, float* __restrict__ du0,
                   int T, int C) {
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* u_row = u_seq + row * T * C;
  float* dwx_row = dwx + row * T * C;

  float al[VPL], oma[VPL], go[VPL], G[VPL], dal[VPL], ut[VPL], up[VPL];
  bool live[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = lane + 32 * v;
    live[v] = c < C;
    al[v] = live[v] ? alpha[c] : 0.f;
    oma[v] = 1.0f - al[v];
    go[v] = live[v] ? gout[row * C + c] : 0.f;
    G[v] = 0.f;
    dal[v] = 0.f;
    ut[v] = live[v] ? u_row[(size_t)(T - 1) * C + c] : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const float* prev = t > 0 ? u_row + (size_t)(t - 1) * C : u0 + row * C;
    float m = -INFINITY;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      up[v] = live[v] ? prev[lane + 32 * v] : 0.f;
      if (live[v]) m = fmaxf(m, ut[v]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float e[VPL];
    float sum = 0.f, dot = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      e[v] = live[v] ? expf(ut[v] - m) : 0.f;
      sum += e[v];
      dot += e[v] * go[v];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
      dot += __shfl_xor_sync(kFull, dot, off);
    }
    // <p, gout> = <e, gout> / sum(e)
    const float pg = dot / sum;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const float pv = e[v] / sum;
      G[v] = pv * (go[v] - pg) + al[v] * G[v];
      if (live[v]) dwx_row[(size_t)t * C + lane + 32 * v] = oma[v] * G[v];
      dal[v] += G[v] * (up[v] - ut[v]);
      ut[v] = up[v];
    }
  }

#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = lane + 32 * v;
    if (live[v]) {
      partials[row * C + c] = dal[v];
      du0[row * C + c] = al[v] * G[v];
    }
  }
}

__global__ void dalpha_reduce_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ dalpha, int B,
                                     int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f;
  for (int row = 0; row < B; ++row) sum += partials[(size_t)row * C + c];
  dalpha[c] = sum / (1.0f - alpha[c]);
}

}  // namespace

extern "C" int sparch_readout_bwd(const float* gout, const float* u_seq,
                                  const float* alpha, const float* u0,
                                  float* dwx, float* partials, float* dalpha,
                                  float* du0, int B, int T, int C,
                                  void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C > 32 * kMaxVpl || !gout || !u_seq ||
      !alpha || !u0 || !dwx || !partials || !dalpha || !du0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vpl = (C + 31) / 32;
  if (vpl == 1) {
    readout_bwd_kernel<1><<<B, 32, 0, st>>>(gout, u_seq, alpha, u0, dwx,
                                            partials, du0, T, C);
  } else if (vpl == 2) {
    readout_bwd_kernel<2><<<B, 32, 0, st>>>(gout, u_seq, alpha, u0, dwx,
                                            partials, du0, T, C);
  } else if (vpl <= 4) {
    readout_bwd_kernel<4><<<B, 32, 0, st>>>(gout, u_seq, alpha, u0, dwx,
                                            partials, du0, T, C);
  } else {
    readout_bwd_kernel<8><<<B, 32, 0, st>>>(gout, u_seq, alpha, u0, dwx,
                                            partials, du0, T, C);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dalpha_reduce_kernel<<<(C + 127) / 128, 128, 0, st>>>(partials, alpha,
                                                        dalpha, B, C);
  return (int)cudaGetLastError();
}
