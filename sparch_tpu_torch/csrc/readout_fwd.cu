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
// What bounds it on this card: latency. At the serving shape (B=128, T=100,
// C=35) the kernel reads 1.8 MB and writes 18 KB, under a microsecond at
// HBM rate. Only the recurrence is sequential (two dependent float
// operations a step); each softmax depends only on its u_t.
//
// Design (readout.cuh): a block owns `rows` batch rows (ceil(B / SMs): one
// at B = 128) and walks T in chunks. Per chunk it stages the rows' Wx into
// shared memory with cp.async, then
//   1. one thread a (row, class) runs u_t over the chunk, overwriting Wx_t
//      with u_t in shared memory and, in the training form (a template
//      parameter), writing u_out; eight steps' loads ahead of their updates;
//   2. the warps take the (row, t) softmaxes, two at a time a warp, each in
//      the lane layout of one warp a row (lane l: classes l, l+32, ...),
//      overwriting u_t with p_t;
//   3. one thread a (row, class) adds p_t over the chunk in ascending t.
// u and the sum are carried in registers from chunk to chunk. Every value
// is rounded as the kernel of one warp a row rounded it (__fmul_rn /
// __fadd_rn, expf, __fdiv_rn, the butterfly order), so the outputs keep
// its bits; the plain PyTorch version (ops/fused_cells.py readout_plain)
// differs from them only by the order of the class sum.
//
// Past 32 * kMaxVpl classes the wide form runs (readout_fwd_wide_kernel):
// a block a row; its threads run u_t a class at a time over all of T into
// u_out (which the wrapper then always passes); per chunk of steps a warp
// a step takes the max and the class sum of e (readout.cuh wide_stats)
// into shared memory, and the threads add e / sum over the chunk's steps
// in ascending t onto out, a class at a time. The recurrence rounds as
// above, so the membrane series is the plain version's bit for bit.
//
// C interface, bound with ctypes: sparch_readout_fwd returns
// cudaGetLastError() after the launch (or an invalid-value error for a
// shape or plan it does not take) and never synchronises.

#include "readout.cuh"

namespace {

using readout::kMaxVpl;

// Steps of the recurrence whose loads are issued as a group.
constexpr int kGroup = 8;

template <int VPL, bool kResid>
__global__ void __launch_bounds__(readout::kThreads)
readout_fwd_kernel(const float* __restrict__ wx,
                   const float* __restrict__ alpha,
                   const float* __restrict__ u0, float* __restrict__ out,
                   float* __restrict__ u_out, int B, int T, int C, int rows,
                   int tc) {
  constexpr int G = kGroup;
  extern __shared__ __align__(16) float s[];  // rows x tc x C
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int row0 = blockIdx.x * rows;
  const int nr = min(rows, B - row0);
  // this thread's (row, class) in phases 1 and 3
  const bool mine = tid < nr * C;
  const int r = mine ? tid / C : 0;
  const int c = mine ? tid - r * C : 0;
  const size_t grow = (size_t)(row0 + r);
  float al = 0.f, oma = 0.f, u = 0.f, acc = 0.f;
  if (mine) {
    al = alpha[c];
    oma = __fsub_rn(1.0f, al);
    u = u0[grow * C + c];
  }
  int at[VPL];
  bool live[VPL];
  readout::class_slots<VPL>(lane, C, at, live);

  for (int t0 = 0; t0 < T; t0 += tc) {
    const int n = min(tc, T - t0);
    for (int q = 0; q < nr; ++q) {
      readout::stage(s + (size_t)q * tc * C,
                     wx + ((size_t)(row0 + q) * T + t0) * C, n * C);
    }
    readout::stage_wait();

    // 1. the recurrence, G steps a group: the next group's loads go out
    // before this group's stores, so the chain waits on shared memory once
    if (mine) {
      float* sr = s + (size_t)r * tc * C + c;
      float* ur = kResid ? u_out + (grow * T + t0) * C + c : nullptr;
      // loads past the chunk read its last step (no branch); unused
      float x[G];
#pragma unroll
      for (int k = 0; k < G; ++k) x[k] = sr[min(k, n - 1) * C];
      int t = 0;
      for (; t + G <= n; t += G) {
        float y[G];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          u = __fadd_rn(__fmul_rn(al, u), __fmul_rn(oma, x[k]));
          y[k] = u;
        }
#pragma unroll
        for (int k = 0; k < G; ++k) x[k] = sr[min(t + G + k, n - 1) * C];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          sr[(t + k) * C] = y[k];
          if (kResid) ur[(size_t)(t + k) * C] = y[k];
        }
      }
      for (; t < n; ++t) {
        u = __fadd_rn(__fmul_rn(al, u), __fmul_rn(oma, sr[t * C]));
        sr[t * C] = u;
        if (kResid) ur[(size_t)t * C] = u;
      }
    }
    __syncthreads();

    // 2. the softmaxes, two a warp at a time (the second repeats the first
    // where none is left: the same values to the same place)
    const int total = nr * n;
    for (int j = warp; j < total; j += 2 * nw) {
      const int jj[2] = {j, j + nw < total ? j + nw : j};
      float* p[2];
      float x[2][VPL];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = jj[k] / n;
        p[k] = s + ((size_t)q * tc + (jj[k] - q * n)) * C;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const float xv = p[k][at[v]];
          x[k][v] = live[v] ? xv : 0.f;
        }
      }
      float sum[2];
      readout::exp_sum<VPL, 2>(x, live, sum);
      readout::warp_sum<2>(sum);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          // a dead class divides 1 (0 / sum would take the divide's
          // slow path), and is not stored
          const float pv = __fdiv_rn(live[v] ? x[k][v] : 1.f, sum[k]);
          if (live[v]) p[k][at[v]] = pv;
        }
      }
    }
    __syncthreads();

    // 3. the sum over t, in ascending order
    if (mine) {
      acc = readout::ordered_sum(s + (size_t)r * tc * C + c, C, n, acc);
    }
    __syncthreads();  // before the next chunk is staged over this one
  }
  if (mine) out[grow * C + c] = acc;
}

// The wide form (C past the lane layout): one block a row, u_out required.
__global__ void __launch_bounds__(readout::kThreads)
readout_fwd_wide_kernel(const float* __restrict__ wx,
                        const float* __restrict__ alpha,
                        const float* __restrict__ u0, float* __restrict__ out,
                        float* __restrict__ u_out, int T, int C, int tc) {
  extern __shared__ __align__(16) float s[];  // tc maxes, tc sums
  float* sm = s;
  float* ss = s + tc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const float* x = wx + row * T * C;
  float* u = u_out + row * T * C;
  float* o = out + row * C;

  // 1. the recurrence over all of T, a class at a time
  for (int c = tid; c < C; c += nt) {
    const float al = alpha[c], oma = __fsub_rn(1.0f, al);
    float v = u0[row * C + c];
    for (int t = 0; t < T; ++t) {
      v = __fadd_rn(__fmul_rn(al, v), __fmul_rn(oma, x[(size_t)t * C + c]));
      u[(size_t)t * C + c] = v;
    }
    o[c] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += tc) {
    const int n = min(tc, T - t0);
    // 2. each step's max and class sum, a warp a step
    for (int j = warp; j < n; j += nw) {
      float m, sum, dot;
      readout::wide_stats(u + (size_t)(t0 + j) * C, nullptr, C, m, sum, dot);
      if ((tid & 31) == 0) {
        sm[j] = m;
        ss[j] = sum;
      }
    }
    __syncthreads();
    // 3. the sum over the chunk's steps in ascending t, a class at a time
    // (each thread the classes it took in 1)
    for (int c = tid; c < C; c += nt) {
      const float* uc = u + (size_t)t0 * C + c;
      float acc = o[c];
      for (int t = 0; t < n; ++t) {
        acc = __fadd_rn(acc, __fdiv_rn(expf(__fsub_rn(uc[(size_t)t * C],
                                                      sm[t])),
                                       ss[t]));
      }
      o[c] = acc;
    }
    __syncthreads();  // before the next chunk's statistics
  }
}

template <int VPL>
int launch(const float* wx, const float* alpha, const float* u0, float* out,
           float* u_out, int B, int T, int C, const readout::Plan& p,
           cudaStream_t st) {
  auto* kernel = u_out ? readout_fwd_kernel<VPL, true>
                       : readout_fwd_kernel<VPL, false>;
  const int err = readout::allow_smem(kernel, p.smem);
  if (err != 0) return err;
  const int blocks = (B + p.rows - 1) / p.rows;
  kernel<<<blocks, 32 * p.warps, p.smem, st>>>(wx, alpha, u0, out, u_out, B,
                                               T, C, p.rows, p.t_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// rows, warps, t_chunk: the plan (readout.cuh `plan`), checked against the
// current card's.
extern "C" int sparch_readout_fwd(const float* wx, const float* alpha,
                                  const float* u0, float* out, float* u_out,
                                  int B, int T, int C, int rows, int warps,
                                  int t_chunk, void* stream) {
  readout::Plan p;
  if (B <= 0 || T <= 0 || C <= 0 || !wx || !alpha ||
      !u0 || !out ||
      !readout::plan_ok(B, T, C, false, rows, warps, t_chunk, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 32 * kMaxVpl) {
    if (!u_out) return (int)cudaErrorInvalidValue;
    readout_fwd_wide_kernel<<<B, 32 * p.warps, p.smem, st>>>(
        wx, alpha, u0, out, u_out, T, C, p.t_chunk);
    return (int)cudaGetLastError();
  }
  const int vpl = (C + 31) / 32;
  if (vpl == 1) return launch<1>(wx, alpha, u0, out, u_out, B, T, C, p, st);
  if (vpl == 2) return launch<2>(wx, alpha, u0, out, u_out, B, T, C, p, st);
  if (vpl <= 4) return launch<4>(wx, alpha, u0, out, u_out, B, T, C, p, st);
  return launch<8>(wx, alpha, u0, out, u_out, B, T, C, p, st);
}
