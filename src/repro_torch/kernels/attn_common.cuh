// Shared device helpers for the port's attention kernels (flash,
// selective, paged decode).  Every kernel reads its inputs as fp32 or
// bf16, accumulates scores and sums in fp32, and uses the JAX package's
// numeric conventions: the finite mask constant -1e30 (exp underflows to
// exactly 0, a fully masked row stays finite), probabilities rounded to
// the value dtype before the PV product, denominators clamped at 1e-30.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float kNegInf = -1e30f;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision (identity for fp32).
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Calls f(T{}) with T the element type named by a dtype code; an unknown
// code is an invalid-value error.
template <typename F> cudaError_t with_dtype(int code, F&& f) {
  if (code == kF32) return f(float{});
  if (code == kBF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace rt

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
