// Masked set attention over <= 512 entities: out = softmax(mask(q k^T * scale, -1e9)) v
// per (batch, head), with key-validity mask [B, N].
//
// Replaces: distar_tpu/ops/pallas_kernels.py masked_attention (:62-74), whose
// pallas_call is _masked_attention_fwd_kernel (:77-102) over the body
// _attention_kernel (:41-59). The Pallas kernel keeps one (b, h) program's
// whole [N, N] score tile in VMEM; at N = 512 that tile is 1 MiB of f32, far
// over the 227 KB a Hopper block can hold, so this kernel tiles the keys.
//
// Bound on the H100: at the flagship serve shape [32, 2, 512, 128] the work is
// 4*B*H*N^2*Dh = 8.6 GFLOP on 67 MB of q, k, v and out. In f32 at the
// CUDA-core peak (67 TFLOP/s) that is 128 us against 20 us of memory traffic
// at 3.35 TB/s, so arithmetic bounds it; in bf16 on tensor cores (989
// TFLOP/s) it would be 9 us against 10 us, a memory bound.
//
// Design (simple first): one block of 256 threads per (b, h, 64-query tile)
// walks 64-key tiles of K and V staged in shared memory as f32, with an
// online softmax in f32 (running max m, running sum l, rescaled
// accumulator). Four threads own one query row: each computes 16 of the
// tile's 64 scores and accumulates Dh/4 output dims in registers. Masked
// keys score exactly -1e9 after the scale, as in the reference, so a row
// with no valid key comes out as mean(V); keys past N (the ragged last tile)
// score -inf and weigh nothing. Products run on CUDA cores from shared
// memory; tensor cores (wgmma) and TMA staging are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr int MAX_DH = 128;
constexpr float MASK_FILL = -1e9f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ mask,
                        T* __restrict__ out, int H, int N, int Dh, float scale) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;  // padded row stride: rows land on distinct banks
  float* sQ = smem;                 // [BQ][ld]
  float* sK = sQ + BQ * ld;         // [BK][ld]
  float* sV = sK + BK * ld;         // [BK][Dh]
  float* sP = sV + BK * Dh;         // [BQ][BK + 1]
  int* sState = reinterpret_cast<int*>(sP + BQ * (BK + 1));  // [BK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * N * Dh;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int nq = min(BQ, N - q0);
  const int nd = Dh / 4;

  for (int i = tid; i < BQ * Dh; i += THREADS) {
    const int r = i / Dh, d = i - r * Dh;
    sQ[r * ld + d] = r < nq ? to_f32(q[base + (size_t)(q0 + r) * Dh + d]) : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[MAX_DH / 4];
#pragma unroll
  for (int j = 0; j < MAX_DH / 4; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    const int nk = min(BK, N - k0);
    __syncthreads();  // the previous tile's readers are done with sK/sV/sState
    for (int i = tid; i < BK * Dh; i += THREADS) {
      const int r = i / Dh, d = i - r * Dh;
      float kv = 0.f, vv = 0.f;
      if (r < nk) {
        const size_t off = base + (size_t)(k0 + r) * Dh + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sK[r * ld + d] = kv;
      sV[r * Dh + d] = vv;
    }
    // 0: past N (excluded), 1: valid key, 2: masked key (scores -1e9)
    for (int c = tid; c < BK; c += THREADS)
      sState[c] = c < nk ? (mask[(size_t)b * N + k0 + c] ? 1 : 2) : 0;
    __syncthreads();

    float s[BK / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = sub + 4 * j;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot += sQ[row * ld + d] * sK[c * ld + d];
      const int st = sState[c];
      const float sc = st == 1 ? dot * scale : (st == 2 ? MASK_FILL : -INFINITY);
      s[j] = sc;
      tmax = fmaxf(tmax, sc);
    }
    // the four threads of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: every tile has a key < N
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      sP[row * (BK + 1) + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row of sP is written and read by the same four lanes

#pragma unroll
    for (int j = 0; j < MAX_DH / 4; ++j) {
      if (j < nd) {
        const int d = sub + 4 * j;
        float a = acc[j] * alpha;
        for (int c = 0; c < nk; ++c) a += sP[row * (BK + 1) + c] * sV[c * Dh + d];
        acc[j] = a;
      }
    }
  }

  if (row < nq) {
    const float inv = 1.f / l;
    T* o = out + base + (size_t)(q0 + row) * Dh;
#pragma unroll
    for (int j = 0; j < MAX_DH / 4; ++j)
      if (j < nd) o[sub + 4 * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int H, int N, int Dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (Dh + 1) + (size_t)BK * (Dh + 1) +
                                       (size_t)BK * Dh + (size_t)BQ * (BK + 1)) +
                      sizeof(int) * BK;
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  masked_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), H, N, Dh, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, N, Dh] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); mask: [B, N] bytes, nonzero = valid key. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int H, int N, int Dh,
                                    float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || Dh <= 0 || Dh > MAX_DH || Dh % 4 != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, out, B, H, N, Dh, scale, s)
                       : launch<float>(q, k, v, mask, out, B, H, N, Dh, scale, s));
}
