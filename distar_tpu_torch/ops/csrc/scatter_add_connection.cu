// Per-batch scatter-add of entity rows onto the flattened map:
// out[b] = 0; for i in 0..N-1: out[b, idx[b, i], :] += emb[b, i, :].
//
// Replaces: distar_tpu/ops/pallas_kernels.py scatter_add_connection
// (:156-172), whose pallas_call is _scatter_add_fwd_kernel (:180-195) over
// the body _scatter_kernel (:142-153): zero the [hw, D] tile, then a
// fori_loop of dynamic row updates in entity order.
//
// Bound on the H100: the bytes. At the flagship serve shape (B = 32, N = 512,
// D = 32, hw = 24,320) the kernel writes a 99.6 MB map and reads 2.2 MB of
// rows and indices: 30 us at 3.35 TB/s. It does 0.5 M additions.
//
// Design (simple first): the sum must be deterministic and equal to the
// entity-order loop bit for bit (the JAX loop adds in entity order, and step
// replays compare reruns bit-equal), so there are no float atomics. One
// block of 1024 threads per batch zeroes its [hw, D] slab with 16-byte
// stores, synchronises, then walks the N entities in order with one thread
// per embedding lane (D = 32 is one warp). Only B blocks are busy and the
// walk is a serial chain of read-modify-writes: the first thing a later
// redesign replaces (e.g. a per-cell owner that sums its colliding rows in
// entity order, which stays bit-equal).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
scatter_add_connection_kernel(const float* __restrict__ emb, const int* __restrict__ idx,
                              float* __restrict__ out, int N, int D, int hw) {
  const int b = blockIdx.x;
  float* o = out + (size_t)b * hw * D;
  const size_t total = (size_t)hw * D;
  if (total % 4 == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    for (size_t i = threadIdx.x; i < total / 4; i += THREADS) o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t i = threadIdx.x; i < total; i += THREADS) o[i] = 0.f;
  }
  __syncthreads();  // the zeroed slab is visible to every thread of the block
  const float* e = emb + (size_t)b * N * D;
  const int* ix = idx + (size_t)b * N;
  for (int d = threadIdx.x; d < D; d += THREADS)
    for (int i = 0; i < N; ++i) o[(size_t)ix[i] * D + d] += e[(size_t)i * D + d];
}

}  // namespace

// emb: [B, N, D] float32; idx: [B, N] int32 already clipped to [0, hw);
// out: [B, hw, D] float32. All contiguous. Returns the CUDA error code.
extern "C" int scatter_add_connection_fwd(const void* emb, const void* idx, void* out, int B,
                                          int N, int D, int hw, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  scatter_add_connection_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const int*>(idx), static_cast<float*>(out), N,
      D, hw);
  return (int)cudaGetLastError();
}
