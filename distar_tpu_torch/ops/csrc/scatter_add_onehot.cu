// The same per-batch scatter-add as scatter_add_connection.cu, formulated per
// output cell: out[b, cell, d] = sum over i in entity order of
// emb[b, i, d] * (idx[b, i] == cell), i.e. onehot(idx)^T . emb.
//
// Replaces: distar_tpu/ops/pallas_kernels.py scatter_add_onehot (:231-245),
// whose pallas_call is _scatter_onehot_fwd_kernel (:253-280) over the body
// _scatter_onehot_kernel (:214-228): a (batch, cell chunk <= 2048) grid whose
// one-hot tile is built on chip and fed to the MXU.
//
// Bound on the H100: the bytes, as for the loop kernel (99.6 MB written at
// the flagship serve shape, 30 us at 3.35 TB/s). As a dense matmul the
// one-hot product is 2*N*hw*D = 0.80 GFLOP per sample, which the data never
// needs: each entity row lands in exactly one cell.
//
// Design (simple first): one block of 1024 threads per (batch, 2048-cell
// chunk) stages idx[b] (2 KB) and emb[b] (64 KB f32, dynamic shared memory)
// in shared memory. Each thread owns (cell, d) outputs and sums, in entity
// order from 0.0f, the rows whose index is its cell; with D = 32 a warp
// owns one cell, so the index test is uniform across it. Starting from zero
// and adding in entity order gives bit for bit the f32 result of the loop
// kernel. The ragged last chunk is masked (hw = 24,320 is not a multiple of
// 2,048). The cost is N index tests per output; a later redesign sorts the
// rows by cell, or uses tensor cores on the one-hot tile.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int CHUNK = 2048;

__global__ void __launch_bounds__(THREADS)
scatter_add_onehot_kernel(const float* __restrict__ emb, const int* __restrict__ idx,
                          float* __restrict__ out, int N, int D, int hw) {
  extern __shared__ float smem[];
  float* sEmb = smem;                                  // [N][D]
  int* sIdx = reinterpret_cast<int*>(sEmb + (size_t)N * D);  // [N]
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CHUNK;
  const int ncell = min(CHUNK, hw - c0);
  const float* e = emb + (size_t)b * N * D;
  for (int i = threadIdx.x; i < N * D; i += THREADS) sEmb[i] = e[i];
  for (int i = threadIdx.x; i < N; i += THREADS) sIdx[i] = idx[(size_t)b * N + i];
  __syncthreads();
  float* o = out + ((size_t)b * hw + c0) * D;
  for (int t = threadIdx.x; t < ncell * D; t += THREADS) {
    const int cell = c0 + t / D;
    const int d = t % D;
    float acc = 0.f;
    for (int i = 0; i < N; ++i)
      if (sIdx[i] == cell) acc += sEmb[i * D + d];
    o[t] = acc;
  }
}

}  // namespace

// emb: [B, N, D] float32; idx: [B, N] int32 already clipped to [0, hw);
// out: [B, hw, D] float32. All contiguous. Returns the CUDA error code.
extern "C" int scatter_add_onehot_fwd(const void* emb, const void* idx, void* out, int B, int N,
                                      int D, int hw, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || hw <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * D + sizeof(int) * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(scatter_add_onehot_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + CHUNK - 1) / CHUNK, B);
  scatter_add_onehot_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const int*>(idx), static_cast<float*>(out), N,
      D, hw);
  return (int)cudaGetLastError();
}
