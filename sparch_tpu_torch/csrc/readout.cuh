// What the two readout kernels (readout_fwd.cu, readout_bwd.cu) share: the
// launch plan, the staging of a block's rows into shared memory, and the
// softmax of one step of one row in the lane layout whose bits both keep.
//
// A readout launch gives each block `rows` batch rows and walks T in chunks
// of `t_chunk` steps. Per chunk the block stages each row's series into
// shared memory with cp.async and runs three phases between barriers: one
// thread a (row, class) for the recurrence over t, the warps for the (row,
// t) softmaxes (independent of each other), one thread a (row, class) for
// the sum over t. Only the recurrences are sequential, one or two dependent
// float operations a step.
//
// Past 32 * kMaxVpl classes (the widest row the lane layout holds) the
// wide forms run instead: a block a row, its threads each a class at a
// time for the recurrences and sums, a warp a step for the softmax's max,
// sum and dot over all C (the lanes strided over the classes), only those
// statistics in shared memory; the row's series stays in global memory
// (the forward writes u there in both forms).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace readout {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxVpl = 8;  // classes a lane holds: C <= 256, else wide
constexpr int kSmem = 96 * 1024;
constexpr int kThreads = 1024;
constexpr int kSoftmaxWarps = 16;
constexpr int kWideChunk = 1024;  // steps whose statistics a wide block holds

struct Plan {
  int rows;     // batch rows of a block
  int warps;    // warps of a block
  int t_chunk;  // steps of each row staged at once
  int smem;     // dynamic shared memory of a block, bytes
};

// The plan (ops/fused_cells.py `_readout_plan` computes the same): a block
// owns ceil(B / sms) rows, at most kThreads / C (a thread a row and
// class); it stages t_chunk steps of each row in kSmem bytes (forward: C
// floats a row and step; backward: 2C + 1, beside 2C a row), in equal
// chunks where T does not fit; its warps take the softmaxes, up to
// kSoftmaxWarps unless the (row, class) threads need more. Past
// 32 * kMaxVpl classes (the wide forms): one row a block, a warp per 32
// classes up to kThreads, and the statistics of t_chunk <= kWideChunk
// steps (forward: max and sum; backward: those and <p, gout>).
inline Plan plan(int B, int T, int C, int sms, bool backward) {
  if (C > 32 * kMaxVpl) {
    const int warps = C < kThreads ? (C + 31) / 32 : kThreads / 32;
    const int t_chunk = T < kWideChunk ? T : kWideChunk;
    return Plan{1, warps, t_chunk, 4 * t_chunk * (backward ? 3 : 2)};
  }
  const int step = backward ? 2 * C + 1 : C;
  const int fixed = backward ? 2 * C : 0;
  int rows = (B + sms - 1) / sms;
  if (rows > kThreads / C) rows = kThreads / C;
  if (rows > B) rows = B;
  if (rows < 1) rows = 1;
  const int fit = (kSmem / 4 - rows * fixed) / (rows * step);
  const int most = T < fit ? T : fit;
  const int chunks = (T + most - 1) / most;
  const int t_chunk = (T + chunks - 1) / chunks;
  int warps = rows * t_chunk < kSoftmaxWarps ? rows * t_chunk : kSoftmaxWarps;
  if (warps < (rows * C + 31) / 32) warps = (rows * C + 31) / 32;
  if (warps > kThreads / 32) warps = kThreads / 32;
  return Plan{rows, warps, t_chunk, 4 * rows * (fixed + t_chunk * step)};
}

// Whether (rows, warps, t_chunk) is the plan for this shape on the current
// card (the wrappers compute it from torch's count of the card's SMs).
inline bool plan_ok(int B, int T, int C, bool backward, int rows, int warps,
                    int t_chunk, Plan* out) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms <= 0) {
    return false;
  }
  *out = plan(B, T, C, sms, backward);
  return out->rows == rows && out->warps == warps && out->t_chunk == t_chunk;
}

// Issues the copy of n floats from src (global) to dst (shared) by the
// block's threads: 16 bytes a copy where both ends are 16-byte aligned and
// n allows, else 4. The caller commits and waits.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nt) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    }
    done = n4 << 2;
  }
  for (int i = done + tid; i < n; i += nt) {
    __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The first half of the softmax of K steps at once (independent chains the
// scheduler interleaves), warp-wide, as the parent kernels took it: lane l
// holds classes l, l+32, ... (x[k][v] for class l + 32v); dead classes (c
// >= C) take no part in the max and give e = 0. On return x[k][v] holds e =
// expf(x - max) and sum[k] the class sum: each lane's values added in v
// order from 0.f, then a butterfly over offsets 16 .. 1, so every lane ends
// with the same bits.
template <int VPL, int K>
__device__ __forceinline__ void exp_sum(float (&x)[K][VPL],
                                        const bool (&live)[VPL],
                                        float (&sum)[K]) {
  float m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = -INFINITY;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (live[v]) m[k] = fmaxf(m[k], x[k][v]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m[k] = fmaxf(m[k], __shfl_xor_sync(kFull, m[k], off));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sum[k] = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const float e = expf(__fsub_rn(x[k][v], m[k]));
      x[k][v] = live[v] ? e : 0.f;
      sum[k] = __fadd_rn(sum[k], x[k][v]);
    }
  }
}

// Where lane `lane` reads class lane + 32v of a row: that class, or for a
// dead one (past C) the last class, so that every lane loads without a
// branch and a dead value is dropped by a select.
template <int VPL>
__device__ __forceinline__ void class_slots(int lane, int C, int (&at)[VPL],
                                            bool (&live)[VPL]) {
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    live[v] = lane + 32 * v < C;
    at[v] = live[v] ? lane + 32 * v : C - 1;
  }
}

// acc + x[0] + x[stride] + ... + x[(n-1)*stride], added in that order with
// __fadd_rn (the loads of eight steps issued ahead of their adds).
__device__ __forceinline__ float ordered_sum(const float* x, int stride,
                                             int n, float acc) {
#pragma unroll 8
  for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, x[t * stride]);
  return acc;
}

// The butterfly of a class sum (offsets 16 .. 1), every lane ending with
// the same bits.
template <int K>
__device__ __forceinline__ void warp_sum(float (&s)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = __fadd_rn(s[k], __shfl_xor_sync(kFull, s[k], off));
    }
  }
}

// The max and the sum of e = expf(x - max) of the C values x[0 .. C-1]
// (one step of one row), warp-wide, as in exp_sum but the lane walking
// classes lane, lane+32, ... for any C; with g non-null also the FFMA
// chain of e * g from 0.f, butterflied alike. Every lane ends with the same
// bits.
__device__ __forceinline__ void wide_stats(const float* x, const float* g,
                                           int C, float& m, float& sum,
                                           float& dot) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int c = lane; c < C; c += 32) mx = fmaxf(mx, x[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  float s[2] = {0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    const float e = expf(__fsub_rn(x[c], mx));
    s[0] = __fadd_rn(s[0], e);
    if (g) s[1] = __fmaf_rn(e, g[c], s[1]);
  }
  warp_sum<2>(s);
  m = mx;
  sum = s[0];
  dot = s[1];
}

// Sets the dynamic shared memory limit of `kernel` where a plan needs more
// than the default 48 KB.
template <typename F>
inline int allow_smem(F* kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace readout
