// The dV products of the recurrent backward kernels for Hopper (sm_90a),
// run after their time loops: dv_kernel for the spiking ones
// (fused_cell_bwd.cu, tp_cell_bwd.cu), ann_dv_kernel for the non-spiking
// ones (fused_ann_bwd.cu, tp_ann_bwd.cu).
//
// dV = sum over (b, t) of left_t[b]^T dpre_t[b]: an (H, B*T) x (B*T, H)
// product whose left operand is recomputed from the forward's series (the
// spikes s_{t-1} from the membrane series, s0 for the first step of each
// row; the non-spiking y_{t-1}, times r_t for the GRU's candidate, y0 for
// the first step) and whose right operand is the stored dDrive or dpre
// series. 64x64 output tiles, 4x4 per thread, split over B*T into partials
// that sum_parts_kernel (tile_stream.cuh) adds in ascending order, so two
// runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace sparch {

constexpr int kTile = 64;  // dV output tile
constexpr int kBK = 16;    // dV depth per shared-memory stage
constexpr int kDvThreads = 256;

// partial[z][m][n] = sum over rows r = (b, t) of this split, ascending, of
// s_{t-1}[b][m] * dDrive_t[b][n]. DT is the element type of the dDrive
// series; with bf16 both operands are bf16 values (s0, which need not be
// 0/1, is rounded here) and the sum is float32.
template <typename DT>
__global__ void __launch_bounds__(kDvThreads)
dv_kernel(const float* __restrict__ u_seq, const float* __restrict__ s0,
          const DT* __restrict__ dd, float* __restrict__ partial, int T,
          int H, int R, int rows_per_split, float thr) {
  constexpr bool kRound = sizeof(DT) == 2;
  __shared__ __align__(16) float As[kBK][kTile];
  __shared__ __align__(16) float Bs[kBK][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int lr = tid / 16;        // row of the stage this thread loads
  const int lc = (tid % 16) * 4;  // first of its four columns

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    const int r = r0 + lr;
    const bool row_ok = r < r_end;
    const int t = row_ok ? r % T : 0;
    const int brow = row_ok ? r / T : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + lc + q;
      float sp = 0.f;
      if (row_ok && m < H) {
        sp = t == 0 ? s0[(size_t)brow * H + m]
                    : (u_seq[(size_t)(r - 1) * H + m] > thr ? 1.f : 0.f);
        if (kRound) sp = round_bf16(sp);
      }
      As[lr][lc + q] = sp;
      const int n = n0 + lc + q;
      Bs[lr][lc + q] =
          (row_ok && n < H) ? to_float(dd[(size_t)r * H + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = partial + (size_t)blockIdx.z * H * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < H && n < H) out[(size_t)m * H + n] = acc[i][j];
    }
  }
}

struct AnnDvArgs {
  const void* y_seq;     // y_seq, r and dpre: float, bf16 in the bf16 mode
  const float* y0;
  const void* r;         // the GRU's reset series, else null
  const void* dpre[3];   // the right operand, by gate
  float* partial;        // (ksplit, gates, H, H)
  int T;
  int H;
  int R;                 // B*T
  int rows_per_split;
  int G;
};

// partial[split][gate][m][n] = sum over rows q = (b, t) of this split,
// ascending, of left[q][m] * dpre_gate[q][n], with left = y_{t-1}[b] (y0
// at t = 0), times r_t[b] for the GRU's candidate (gate 0). ST is the
// element type of the series; with bf16 the left operand is rounded to bf16
// too, and the sum is float32.
template <typename ST>
__global__ void __launch_bounds__(kDvThreads)
ann_dv_kernel(const AnnDvArgs a) {
  constexpr bool kRound = sizeof(ST) == 2;
  __shared__ __align__(16) float As[kBK][kTile];
  __shared__ __align__(16) float Bs[kBK][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int gate = blockIdx.z % a.G;
  const int split = blockIdx.z / a.G;
  const int H = a.H;
  const int T = a.T;
  const ST* dd = static_cast<const ST*>(a.dpre[gate]);
  const ST* y_seq = static_cast<const ST*>(a.y_seq);
  const ST* r_in = static_cast<const ST*>(a.r);
  const bool gated = a.r != nullptr && gate == 0;
  const int q_begin = split * a.rows_per_split;
  const int q_end = min(a.R, q_begin + a.rows_per_split);
  const int lr = tid / 16;        // row of the stage this thread loads
  const int lc = (tid % 16) * 4;  // first of its four columns

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int q0 = q_begin; q0 < q_end; q0 += kBK) {
    const int q = q0 + lr;
    const bool row_ok = q < q_end;
    const int t = row_ok ? q % T : 0;
    const int brow = row_ok ? q / T : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = m0 + lc + k;
      float left = 0.f;
      if (row_ok && m < H) {
        left = t == 0 ? a.y0[(size_t)brow * H + m]
                      : to_float(y_seq[(size_t)(q - 1) * H + m]);
        if (gated) left *= to_float(r_in[(size_t)q * H + m]);
        if (kRound) left = round_bf16(left);
      }
      As[lr][lc + k] = left;
      const int n = n0 + lc + k;
      Bs[lr][lc + k] =
          (row_ok && n < H) ? to_float(dd[(size_t)q * H + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = a.partial + ((size_t)split * a.G + gate) * H * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < H && n < H) out[(size_t)m * H + n] = acc[i][j];
    }
  }
}

// CUDA events around the launches of one backward call, where the caller
// asks for their milliseconds (split_ms): mark(i) before launch i, mark(n)
// after the last; report() waits for the last and writes the n times.
struct Split {
  cudaEvent_t ev[4] = {nullptr, nullptr, nullptr, nullptr};
  bool on = false;
  explicit Split(bool want) : on(want) {
    if (!on) return;
    for (auto& e : ev) cudaEventCreate(&e);
  }
  ~Split() {
    if (!on) return;
    for (auto& e : ev) cudaEventDestroy(e);
  }
  void mark(int i, cudaStream_t st) {
    if (on) cudaEventRecord(ev[i], st);
  }
  void report(float* ms, int n) {
    if (!on) return;
    cudaEventSynchronize(ev[n]);
    for (int i = 0; i < n; ++i) cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  }
};

}  // namespace sparch
