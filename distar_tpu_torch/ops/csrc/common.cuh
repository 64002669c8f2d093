// Shared helpers for the port's kernels: element loads/stores between the
// storage dtype (float32 or bfloat16) and float32 arithmetic, and the scatter
// kernels' vector helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The scatter kernels' vector types: float4 (16-byte loads and stores) or
// float. vadd adds lane by lane, in the same order as a scalar loop.
template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// the bits of a warp mask for the lanes below `lane`
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// a hint: bring the 128-byte line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 16- or 4-byte asynchronous copies from global to shared memory (no
// registers held while they are in flight), and the wait for all of them
__device__ __forceinline__ void copy_async(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }
