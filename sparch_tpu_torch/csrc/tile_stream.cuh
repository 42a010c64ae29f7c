// Pieces that the cell kernels with a dense product on their time loop
// share (sm_90a): the element type of a stream mode, its rounding, bulk
// copies (the Tensor Memory Accelerator, no tensor map) that report the
// bytes that have landed to an mbarrier, and the fixed-order second pass
// of a reduction over partials. cluster_slice.cuh streams its column
// slices through kStages stages of at most kTileBytes with them.
//
// The matrix element type is float, or __nv_bfloat16 in the bf16-stream
// mode. Left operands stay float in shared memory (rounded to bf16 where
// they are published), and every product is an FMA in float32: the
// product of two bf16 values is exact there, so a sum is that of a bf16
// product with a float32 accumulator, in ascending order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparch {

constexpr int kStages = 3;          // tiles in flight
constexpr int kTileBytes = 65536;   // bytes per stage

// The element type of the streams and matrices of a mode.
template <bool BF>
struct Elem {
  using type = float;
};
template <>
struct Elem<true> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// Element idx of an input stream that is float, or (bf16-stream mode only,
// where the caller's projection may have emitted either) bf16.
template <bool BF>
__device__ __forceinline__ float load_stream(const void* p, size_t idx,
                                             bool is_bf16) {
  if constexpr (BF) {
    if (is_bf16) {
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
    }
  }
  return static_cast<const float*>(p)[idx];
}

// N consecutive floats as one load.
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float* d) {
  if constexpr (N == 8) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
    d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
  } else if constexpr (N == 4) {
    const float4 v = reinterpret_cast<const float4*>(p)[0];
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = reinterpret_cast<const float2*>(p)[0];
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = p[0];
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// out[idx] = sum over k = 0..n_parts-1, ascending, of parts[k][idx]: the
// fixed-order second pass of a reduction over blocks or splits.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, int n_parts,
                                 int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float sum = 0.f;
  for (int k = 0; k < n_parts; ++k) sum += parts[(size_t)k * n + idx];
  out[idx] = sum;
}

}  // namespace sparch
