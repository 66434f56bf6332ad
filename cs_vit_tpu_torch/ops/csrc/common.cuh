// Helpers shared by the SwinV2 block kernels (fused_block.cu, fused_block_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// value as it reads after a round trip through the compute dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// four adjacent elements of a row (the first at an index that is a multiple
// of 4, rows a multiple of 8 long, the base 16-byte aligned: a 16-byte f32
// chunk, an 8-byte bf16 one) widened to f32, and four f32 values each
// rounded once and stored as such a chunk
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes = zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
