// Shared helpers for the port's kernels: element stores and adds between the
// storage dtype (float32 or bfloat16) and float32 arithmetic, the scatter
// kernels' vector helpers, asynchronous copies, and the attention kernel's
// tensor-core fragments (mma.sync) with their float32 and bfloat16 splits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc + x rounded to x's precision: the add of two values of x's type as
// PyTorch's and XLA's kernels do it (in float32, then rounded)
__device__ __forceinline__ float add_as(float acc, float x) { return acc + x; }
__device__ __forceinline__ float add_as(float acc, __nv_bfloat16 x) {
  return __bfloat162float(__float2bfloat16(acc + __bfloat162float(x)));
}

// eight bfloat16 values, one 16-byte vector
struct __align__(16) bf16x8 {
  __nv_bfloat16 v[8];
};

// The scatter kernels' vector types: float4 or bf16x8 (16-byte loads and
// stores), or one float or bfloat16. vadd adds lane by lane with add_as, in
// the same order as a scalar loop.
template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 vzero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ bf16x8 vzero<bf16x8>() {
  bf16x8 z;
#pragma unroll
  for (int i = 0; i < 8; ++i) z.v[i] = __float2bfloat16(0.f);
  return z;
}

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(__nv_bfloat16& a, __nv_bfloat16 b) {
  a = __float2bfloat16(add_as(__bfloat162float(a), b));
}
__device__ __forceinline__ void vadd(bf16x8& a, const bf16x8& b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) vadd(a.v[i], b.v[i]);
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
__device__ __forceinline__ void copy_async(bf16x8* dst, const bf16x8* src) {
  copy_async(reinterpret_cast<float4*>(dst), reinterpret_cast<const float4*>(src));
}
// cp.async has no 2-byte form: one bfloat16 goes through a register
__device__ __forceinline__ void copy_async(__nv_bfloat16* dst, const __nv_bfloat16* src) { *dst = *src; }
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// An asynchronous copy of `bytes` (16, 8 or 4) from global to shared memory
// that writes zeros instead when `valid` is false (src is then not read, but
// must still be a mapped address); copy_async_wait waits for it.
__device__ __forceinline__ void copy_async_zfill(void* dst, const void* src, int bytes, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(n));
}

// ---- tensor-core fragments (mma.sync), lane = 4 * group + thread-in-group
//
// m16n8k8 tf32 (A row-major 16x8, B col-major 8x8, C 16x8 f32):
//   a[0] (g, t)  a[1] (g+8, t)  a[2] (g, t+4)  a[3] (g+8, t+4)
//   b[0] (k=t, n=g)  b[1] (k=t+4, n=g)
// m16n8k16 bf16 (each register two values, the lower index in the low half):
//   a[0] (g, 2t..2t+1)  a[1] (g+8, 2t..)  a[2] (g, 2t+8..)  a[3] (g+8, 2t+8..)
//   b[0] (k=2t..2t+1, n=g)  b[1] (k=2t+8.., n=g)
// C of both: c[0] (g, 2t)  c[1] (g, 2t+1)  c[2] (g+8, 2t)  c[3] (g+8, 2t+1)

// The operands of 3xTF32: hi is x with its low 13 mantissa bits cleared (a
// tf32 value) and lo = x - hi, exact in f32. A tf32 mma reads only the top 19
// bits of each operand, so lo goes in as it is and counts to its leading 11
// bits: x = hi + lo + O(2^-20 |x|). Two integer/float instructions where a
// cvt.rna.tf32.f32 pair costs more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// (x, y) = hi + lo + O(2^-16 |x|), hi and lo both bfloat16 pairs packed in
// one register each, x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += a b on tensor cores, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// four 8x8 bfloat16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8; r[m] holds matrix m's (2t..2t+1, g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
