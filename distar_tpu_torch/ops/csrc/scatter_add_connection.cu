// Per-batch scatter-add of entity rows onto the flattened map:
// out[b] = 0; for i in 0..N-1: out[b, idx[b, i], :] += emb[b, i, :].
//
// Replaces: distar_tpu/ops/pallas_kernels.py:156 (scatter_add_connection),
// whose pallas_call at :185 runs the body _scatter_kernel (:142): zero the
// [hw, D] tile, then a fori_loop of dynamic row updates in entity order.
//
// Bound on the H100: the map's bytes. At the flagship serve shape (B = 32,
// N = 512, D = 32, hw = 24,320) the kernel writes a 99.6 MB map and reads
// 2.2 MB of rows and indices: 30 us at 3.35 TB/s. It does 0.5 M additions.
//
// Design: the loop made parallel, in two stream-ordered launches.
//   Pass 1 zeroes the whole [B, hw, D] map: a grid-stride loop of 16-byte
//   stores from every SM (8 blocks of 256 threads per SM), each block
//   writing 4 neighbouring 4 KB runs per step.
//   Pass 2 gives each occupied cell one owner, lane per entity (one warp
//   a block, 16 blocks a sample at N = 512). Entity i's lane tests, in shared memory
//   over idx[b] (16-byte reads, 4 indices each), whether an earlier entity
//   has its cell (then i is no owner and stops) and whether a later one has
//   (then the cell is a chain). An owner alone in its cell writes 0.0f + its
//   row at once, with 16-byte loads and stores. The owners of chains are
//   walked by their warp in turn: per window of 256 entities, the lanes of
//   the rows at the cell copy them whole into shared memory (asynchronous
//   16-byte copies, all in flight at once) at their rank in entity order
//   (ballot and popc), and lane = d adds them in that order from 0.0f; the
//   cell is written once, over pass 1's zeros. Each block first asks for its
//   own rows in L2, where pass 1 has just written the map.
// The old kernel ran B = 32 blocks on 132 SMs; each zeroed its 3.1 MB slab
// alone and then walked the N entities as a serial chain of global
// read-modify-writes with 32 busy threads. Here pass 1 spreads the bytes over
// the card, and pass 2's only long chain is a cell's own rows (padded
// entities all land on cell 0: up to N - 1 rows, 256 rows a window). Summing
// each cell's rows in entity order from +0.0f is the entity-order loop's
// sequence of f32 adds, so the result is bit-equal to scatter_add_plain and
// to scatter_add_onehot.cu. No float atomics.
// bfloat16 rows (the 'bfloat16' compute dtype) are added as the Pallas loop
// kernel adds them, in bfloat16: each add in f32, rounded to bfloat16 at
// once (add_as), in entity order from +0.0, so the map is bit-equal to
// scatter_add_plain on the bfloat16 rows. The zero pass writes the same
// zero bits; the vectors are 8 bfloat16 (16 bytes) where D % 8 == 0.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int ZERO_THREADS = 256;
constexpr int ZERO_BLOCKS_PER_SM = 8;
constexpr int ZERO_UNROLL = 4;
constexpr int OWNER_THREADS = 32;  // one warp, 32 entities a block: 16 blocks a sample at N = 512
constexpr int WINDOW = 256;  // entities a chain's warp scans, and whose rows it stages, at a time
constexpr int COPY = 8;      // vectors of a one-row cell loaded before they are stored
constexpr unsigned FULL = 0xffffffffu;

// pass 1: out4[0, n4) and the elements out[n4 * 16 / sizeof(T), n) = 0
template <typename T>
__global__ void __launch_bounds__(ZERO_THREADS)
zero_map_kernel(float4* __restrict__ out4, size_t n4, T* __restrict__ out, size_t n) {
  const size_t run = (size_t)ZERO_UNROLL * ZERO_THREADS;
  for (size_t base = blockIdx.x * run; base < n4; base += (size_t)gridDim.x * run) {
#pragma unroll
    for (int u = 0; u < ZERO_UNROLL; ++u) {
      const size_t i = base + u * ZERO_THREADS + threadIdx.x;
      if (i < n4) out4[i] = vzero<float4>();
    }
  }
  constexpr int PER = sizeof(float4) / sizeof(T);
  for (size_t i = PER * n4 + blockIdx.x * ZERO_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * ZERO_THREADS)
    out[i] = from_f32<T>(0.f);
}

// pass 2: grid (ceil(N / OWNER_THREADS), B); lane = entity. T is float or
// bfloat16; V a 16-byte vector of T (D * sizeof(T) % 16 == 0, aligned) or T.
template <typename T, typename V>
__global__ void __launch_bounds__(OWNER_THREADS)
scatter_owner_kernel(const T* __restrict__ emb, const int* __restrict__ idx,
                     T* __restrict__ out, int N, int D, int hw) {
  extern __shared__ int4 smem[];
  const int n4 = (N + 3) / 4;
  int* sIdx = reinterpret_cast<int*>(smem);  // idx[b], padded with -2 to a multiple of 4
  T* win = reinterpret_cast<T*>(smem + n4);  // [WINDOW][D] staged rows of a chain
  const int b = blockIdx.y;
  const int i = blockIdx.x * OWNER_THREADS + threadIdx.x;
  const int* ix = idx + (size_t)b * N;
  for (int j = threadIdx.x; j < 4 * n4; j += OWNER_THREADS) sIdx[j] = j < N ? ix[j] : -2;
  // Pass 1 has just filled L2 with the map: ask for this block's rows now, so
  // that they are in L2 when this block (or a chain's warp) reads them.
  if (i < N) {
    const char* row = reinterpret_cast<const char*>(emb + ((size_t)b * N + i) * D);
    for (int l = 0; l < D * (int)sizeof(T); l += 128) prefetch_l2(row + l);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = i - lane;  // the warp's first entity, a multiple of 32
  const int c = i < N ? sIdx[i] : -1;
  // an earlier row at c makes entity i no owner; a later one makes its cell a
  // chain. Before the warp's entities every row is earlier, after them later:
  // those runs are read 4 indices at a time.
  bool earlier = false, later = false;
#pragma unroll 4
  for (int q = 0; q < w / 4; ++q) {
    const int4 a = smem[q];
    earlier |= (a.x == c) | (a.y == c) | (a.z == c) | (a.w == c);
  }
#pragma unroll 8
  for (int j = w; j < min(w + 32, N); ++j) {
    const bool hit = sIdx[j] == c;
    earlier |= hit && j < i;
    later |= hit && j > i;
  }
#pragma unroll 4
  for (int q = (w + 32) / 4; q < n4; ++q) {
    const int4 a = smem[q];
    later |= (a.x == c) | (a.y == c) | (a.z == c) | (a.w == c);
  }
  const bool owner = i < N && !earlier;
  const int DV = D * (int)sizeof(T) / (int)sizeof(V);
  const V* e = reinterpret_cast<const V*>(emb + (size_t)b * N * D);
  T* o = out + (size_t)b * hw * D;
  if (owner && !later) {
    // the cell's one row, added to 0.0 as the loop adds it (0.0 + -0.0 is +0.0)
    const V* ei = e + (size_t)i * DV;
    V* oc = reinterpret_cast<V*>(o + (size_t)c * D);
    for (int v0 = 0; v0 < DV; v0 += COPY) {
      V a[COPY];
#pragma unroll
      for (int u = 0; u < COPY; ++u) {
        a[u] = vzero<V>();
        if (v0 + u < DV) vadd(a[u], ei[v0 + u]);
      }
#pragma unroll
      for (int u = 0; u < COPY; ++u)
        if (v0 + u < DV) oc[v0 + u] = a[u];
    }
  }
  // Cells with more rows: the warp walks each owner's rows in turn. Per
  // window of entities, the lane of each row at the cell copies it whole
  // (16-byte asynchronous copies) into shared memory, at its rank in entity
  // order (ballot and popc); then lane = d adds them, in that order.
  unsigned chains = __ballot_sync(FULL, owner && later);
  while (chains) {
    const int src = __ffs(chains) - 1;
    chains &= chains - 1;
    const int co = __shfl_sync(FULL, c, src);
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j0 = w + src; j0 < N; j0 += WINDOW) {
        int n = 0;
#pragma unroll
        for (int h = 0; h < WINDOW / 32; ++h) {
          const int j = j0 + 32 * h + lane;
          const bool hit = j < N && sIdx[j] == co;
          const unsigned m = __ballot_sync(FULL, hit);
          if (hit) {
            const V* from = e + (size_t)j * DV;
            V* to = reinterpret_cast<V*>(win + (size_t)(n + __popc(m & lanes_below(lane))) * D);
            for (int v = 0; v < DV; ++v) copy_async(to + v, from + v);
          }
          n += __popc(m);
        }
        if (n == 0) continue;
        copy_async_wait();
        __syncwarp();
        if (d < D) {
#pragma unroll 8
          for (int k = 0; k < n; ++k) acc = add_as(acc, win[k * D + d]);
        }
        __syncwarp();  // the rows are restaged by the next window
      }
      if (d < D) o[(size_t)co * D + d] = from_f32<T>(acc);
    }
  }
}

template <typename T, typename V16>
cudaError_t launch(const void* emb, const void* idx, void* out, int B, int N, int D, int hw,
                   size_t smem, int sms, cudaStream_t s) {
  const size_t n = (size_t)B * hw * D;
  constexpr int PER = sizeof(float4) / sizeof(T);
  const size_t n4 = reinterpret_cast<uintptr_t>(out) % 16 == 0 ? n / PER : 0;
  zero_map_kernel<T><<<sms * ZERO_BLOCKS_PER_SM, ZERO_THREADS, 0, s>>>(static_cast<float4*>(out), n4,
                                                                        static_cast<T*>(out), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool vec = D % PER == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto owner = vec ? scatter_owner_kernel<T, V16> : scatter_owner_kernel<T, T>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(owner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + OWNER_THREADS - 1) / OWNER_THREADS, B);
  owner<<<grid, OWNER_THREADS, smem, s>>>(static_cast<const T*>(emb), static_cast<const int*>(idx),
                                          static_cast<T*>(out), N, D, hw);
  return cudaGetLastError();
}

}  // namespace

// emb: [B, N, D] float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1), D <= 128
// in the wrapper; idx: [B, N] int32 already clipped to [0, hw); out: [B, hw,
// D] in emb's dtype. All contiguous. Two launches on `stream`; returns the
// CUDA error code.
extern "C" int scatter_add_connection_fwd(const void* emb, const void* idx, void* out, int B,
                                          int N, int D, int hw, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || hw <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t esize = is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = sizeof(int4) * (size_t)((N + 3) / 4) + esize * WINDOW * D;
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // a Hopper block's shared memory
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? launch<__nv_bfloat16, bf16x8>(emb, idx, out, B, N, D, hw, smem, sms, s)
                       : launch<float, float4>(emb, idx, out, B, N, D, hw, smem, sms, s));
}
