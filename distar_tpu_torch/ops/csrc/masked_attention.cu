// Masked set attention over the entities: out = softmax(mask(q k^T * scale, -1e9)) v
// per (batch, head), with key-validity mask [B, N] shared by the heads.
//
// Replaces: distar_tpu/ops/pallas_kernels.py masked_attention (:62-74), whose
// pallas_call is _masked_attention_fwd_kernel (:77-102) over the body
// _attention_kernel (:41-59). The Pallas kernel keeps one (b, h) program's
// whole [N, N] score tile in VMEM and runs both products on the MXU with f32
// accumulation; at N = 512 that tile is 1 MiB of f32, far over the 227 KB a
// Hopper block holds, so this kernel tiles the keys with an online softmax.
//
// Bound on the H100: at the flagship serve shape [32, 2, 512, 128], with
// about half of the 512 keys valid at serve traffic, the function reads q and
// the valid keys' K and V rows and writes out: 51 MB in f32 (15 us at 3.35
// TB/s), and does 4.4 GFLOP of products against the valid keys. Run as
// 3xTF32 on the tensor cores (495 TFLOP/s) that is 26 us; in bf16 the bytes
// halve (8 us) and the products take 1.5 passes at 989 TFLOP/s (7 us).
// Either way it sits near the ridge: both products must run on tensor cores,
// the loads must overlap them, and masked work must go.
//
// Design:
// - Two launches. A plan kernel (one block) reads the [B, N] mask once and
//   lists, per sample, the 32-key tiles to compute with their validity
//   words: the tiles with a valid key, or every tile when the sample has
//   none. It also orders the samples by their count of kept tiles, most
//   first. The attention kernel's blocks, one per (sample, head, 64-query
//   tile), take the samples in that order, so the longest blocks are
//   dispatched first and the short ones fill the SMs at the end.
// - Skipping tiles is exact: a masked key scores -1e9 and weighs
//   exp(-1e9 - max) = 0 in f32 whenever the row has a valid key (with a
//   score above -1e9 + 104). When the sample has no valid key every tile is
//   kept, so the row still comes out as mean(V). Partly valid tiles compute
//   their masked keys with the -1e9 fill, so any mask works, not only a
//   prefix. Keys past N score -inf and weigh nothing.
// - 4 warps a block; warp w owns queries 16w..16w+15. Both products on
//   tensor cores with mma.sync and f32 accumulation.
//   bf16: S = Q K^T in one m16n8k16 pass (bf16 x bf16 products are exact in
//   f32, as the Pallas kernel's preferred_element_type=f32); P V with P
//   split into bf16 hi + lo, two passes, so P stays near f32 as in the
//   Pallas kernel's f32 p @ v; V's B fragments come by ldmatrix.trans.
//   f32: 3xTF32 (a_hi b_hi + a_hi b_lo + a_lo b_hi; hi is x cut to tf32, lo
//   the exact rest, see split_tf32), which keeps about 20 bits where one
//   TF32 pass keeps 11, enough for a 1e-4 gate on outputs of order 1. The
//   split is a mask and a subtraction, which the H100 runs faster than a
//   cvt.rna.tf32 pair. The small cross terms of Q K^T sum in their own
//   accumulators, which doubles the independent mma chains.
//   mma.sync m16n8k8 tf32 and not wgmma: wgmma takes a transposed (MN-major)
//   shared-memory operand only for 16-bit types, and V [key][d] is MN-major
//   for P V. With mma.sync the S accumulator becomes P's A fragment in
//   registers with no shuffle by reading the contraction dim in a permuted
//   order: A's k = t holds key 2t, k = t + 4 key 2t + 1, and V's B fragment
//   reads the same keys. Q K^T permutes its contraction (head dims) the same
//   way, so each Q and K fragment pair is one 8-byte load.
// - K and V tiles stream through a two-stage ring of shared memory with
//   cp.async (16-byte copies where rows allow): the next tile is in flight
//   while one is computed, and one __syncthreads per tile both
//   publishes a landed tile and frees the slot computed before it. Rows
//   past N are zero-filled by the copy itself, and head dims are padded to
//   32, 64 or 128 with zeros written once, so the inner loops have no edge
//   branches. Row strides of HD+8 (Q, K) and HD+4 floats (f32 V) or HD+8
//   bf16 keep fragment reads and ldmatrix free of bank conflicts.
// - Shared memory: 103 KB (f32, HD 128) or 52 KB (bf16), and at most 168
//   registers a thread, so two blocks (f32) or three (bf16) fit on an SM and
//   one block's math covers another's barrier wait; the flagship's 512
//   blocks fill the 132 SMs.
// attention_variants.py (repo root) times this kernel against variants of
// it on the card: launch order instead of longest first, 8 warps a block,
// the cvt.rna split, a division per copy, bf16 P in one pass.
// Scores are kept in log2 units (scale * log2 e folded in) for exp2f.
#include "common.cuh"

#include <climits>
#include <type_traits>

namespace {

constexpr int BQ = 64;  // queries per block, 16 per warp
constexpr int BK = 32;  // keys per tile: one 32-bit word of validity
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;  // the K/V ring: one tile computed, the next in flight
constexpr int MAX_DH = 128;
constexpr int PLAN_THREADS = 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e9f * LOG2E;  // a masked key's score, -1e9 after the scale
constexpr unsigned FULL = 0xffffffffu;

// The plan, B * (2 + 2 * ntiles) ints: order[B] (samples, most kept tiles
// first), count[B], then per sample its kept tiles[ntiles] and their
// validity words[ntiles], in key order.
struct Plan {
  int* order;
  int* count;
  int* tiles;
  unsigned* words;
  __device__ Plan(int* p, int B, int ntiles)
      : order(p), count(p + B), tiles(p + 2 * B),
        words(reinterpret_cast<unsigned*>(p + 2 * B + (size_t)B * ntiles)) {}
};

// bit j: key tile * BK + j is below N and valid
__device__ __forceinline__ unsigned tile_word(const unsigned char* row, int N, int tile) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const int key = tile * BK + j;
    if (key < N && row[key]) w |= 1u << j;
  }
  return w;
}

__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const unsigned char* __restrict__ mask, int B, int N, int ntiles, int* __restrict__ p) {
  const Plan plan(p, B, ntiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < B; b += PLAN_THREADS / 32) {  // a warp per sample, a lane per tile
    const unsigned char* row = mask + (size_t)b * N;
    const unsigned first = tile_word(row, N, lane);  // the words of tiles 0..31, kept
    bool any = first != 0;
    for (int c = 32; c < ntiles; c += 32) any |= tile_word(row, N, c + lane) != 0;
    const bool keep_all = !__any_sync(FULL, any);
    int n = 0;
    for (int c = 0; c < ntiles; c += 32) {
      const int tile = c + lane;
      const unsigned w = c == 0 ? first : tile_word(row, N, tile);
      const unsigned kept = __ballot_sync(FULL, tile < ntiles && (keep_all || w != 0));
      if (kept >> lane & 1u) {
        const size_t i = (size_t)b * ntiles + n + __popc(kept & lanes_below(lane));
        plan.tiles[i] = tile;
        plan.words[i] = w;
      }
      n += __popc(kept);
    }
    if (lane == 0) plan.count[b] = n;
  }
  __syncthreads();  // every count written and visible to the block
  // a stable rank by count, most first: a warp per sample, a lane per rival
  for (int i = warp; i < B; i += PLAN_THREADS / 32) {
    const int ci = plan.count[i];
    int r = 0;
    for (int s = lane; s - lane < B; s += 32) {
      const int cs = s < B ? plan.count[s] : -1;
      r += __popc(__ballot_sync(FULL, cs > ci || (cs == ci && s < i)));
    }
    if (lane == 0) plan.order[r] = i;
  }
}

// Shared memory: BQ rows of Q, then STAGES tiles of K, then of V; head dims
// padded to HD, rows LDQK (Q, K) or LDV (V) elements apart.
template <typename T, int HD>
struct Smem {
  static constexpr int LDQK = HD + 8;
  static constexpr int LDV = std::is_same<T, float>::value ? HD + 4 : HD + 8;
  static constexpr size_t BYTES = sizeof(T) * (BQ * LDQK + STAGES * BK * (LDQK + LDV));
};

// rows [r0, r0 + rows) of a [N, Dh] matrix into shared rows LD apart, in
// copies of `cbytes`; rows past N are zero-filled
// (copy i = threadIdx.x + n * THREADS walks row r = i / cpr, copy c = i % cpr;
// the division is taken once and the walk steps by THREADS)
template <typename T, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int rows, int N, int Dh,
                                      int cbytes) {
  const int per = cbytes / (int)sizeof(T);
  const int cpr = Dh / per, dr = THREADS / cpr, dc = THREADS % cpr;
  for (int r = threadIdx.x / cpr, c = threadIdx.x % cpr; r < rows;) {
    const bool ok = r0 + r < N;
    copy_async_zfill(dst + r * LD + c * per, src + (size_t)(ok ? r0 + r : 0) * Dh + c * per,
                     cbytes, ok);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// columns Dh..HD of `rows` shared rows LD apart = 0
template <typename T, int HD, int LD>
__device__ __forceinline__ void zero_pad(T* dst, int rows, int Dh) {
  for (int i = threadIdx.x; i < rows * (HD - Dh); i += THREADS)
    dst[i / (HD - Dh) * LD + Dh + i % (HD - Dh)] = from_f32<T>(0.f);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// s[j] += this warp's 16 query rows (qw) times keys 8j..8j+7 of the tile (kt)
template <typename T, int HD, int LD>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const T* qw, const T* kt, int g, int t) {
  if constexpr (std::is_same<T, float>::value) {
    // k = t is head dim 8kk + 2t, k = t + 4 dim 8kk + 2t + 1: one float2 each
    float sc[BK / 8][4] = {};  // the cross terms a_lo b_hi + a_hi b_lo
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 q0 = *reinterpret_cast<const float2*>(qw + g * LD + kk * 8 + 2 * t);
      const float2 q1 = *reinterpret_cast<const float2*>(qw + (g + 8) * LD + kk * 8 + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(q0.x, ah[0], al[0]);
      split_tf32(q1.x, ah[1], al[1]);
      split_tf32(q0.y, ah[2], al[2]);
      split_tf32(q1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(kt + (8 * j + g) * LD + kk * 8 + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        mma_tf32(sc[j], al, bh);
        mma_tf32(sc[j], ah, bl);
        mma_tf32(s[j], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] += sc[j][c];
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const T* qa = qw + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa + g * LD), ld32(qa + (g + 8) * LD), ld32(qa + g * LD + 8),
                             ld32(qa + (g + 8) * LD + 8)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const T* kb = kt + (8 * j + g) * LD + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(s[j], a, b);
      }
    }
  }
}

// o += p (this warp's 16 rows x the tile's 32 keys, C fragments) times the
// tile of V (vt)
template <typename T, int HD, int LD>
__device__ __forceinline__ void weigh_values(float (&o)[HD / 8][4], const float (&p)[BK / 8][4],
                                             const T* vt, int lane, int g, int t) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      // A's k = t is key 8j + 2t (C columns 2t), k = t + 4 key 8j + 2t + 1
      uint32_t ph[4], pl[4];
      split_tf32(p[j][0], ph[0], pl[0]);
      split_tf32(p[j][2], ph[1], pl[1]);
      split_tf32(p[j][1], ph[2], pl[2]);
      split_tf32(p[j][3], ph[3], pl[3]);
      const float* vb = vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(vb[nt * 8], bh[0], bl[0]);
        split_tf32(vb[LD + nt * 8], bh[1], bl[1]);
        mma_tf32(o[nt], pl, bh);
        mma_tf32(o[nt], ph, bl);
        mma_tf32(o[nt], ph, bh);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
      // matrix m = lane / 8: keys 16kk + 8(m % 2) + lane % 8, dims 8(m / 2)
      const T* vrow = vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int nt2 = 0; nt2 < HD / 16; ++nt2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + nt2 * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(o[2 * nt2], pl, b0);
        mma_bf16(o[2 * nt2], ph, b0);
        mma_bf16(o[2 * nt2 + 1], pl, b1);
        mma_bf16(o[2 * nt2 + 1], ph, b1);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// grid: one block per (sample in plan order, head, 64-query tile), the
// query tile fastest
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ p, T* __restrict__ out, int B, int H, int N,
                        int Dh, float scale_log2, int cbytes) {
  using S = Smem<T, HD>;
  constexpr int LDQK = S::LDQK, LDV = S::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][LDQK]
  T* sK = sQ + BQ * LDQK;                  // [STAGES][BK][LDQK]
  T* sV = sK + STAGES * BK * LDQK;         // [STAGES][BK][LDV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (N + BK - 1) / BK, qtiles = (N + BQ - 1) / BQ;
  const Plan plan(const_cast<int*>(p), B, ntiles);
  const int r = blockIdx.x / (H * qtiles), rest = blockIdx.x - r * H * qtiles;
  const int b = plan.order[r], h = rest / qtiles, q0 = (rest - h * qtiles) * BQ;
  const size_t base = ((size_t)b * H + h) * N * Dh;
  const int count = plan.count[b];  // >= 1: a sample keeps at least one tile
  const int* tiles = plan.tiles + (size_t)b * ntiles;
  const unsigned* words = plan.words + (size_t)b * ntiles;

  // head dims Dh..HD are zero in every row (no copy writes them)
  if (Dh < HD) {
    zero_pad<T, HD, LDQK>(sQ, BQ + STAGES * BK, Dh);
    zero_pad<T, HD, LDV>(sV, STAGES * BK, Dh);
  }
  stage<T, LDQK>(sQ, q + base, q0, BQ, N, Dh, cbytes);
  stage<T, LDQK>(sK, k + base, tiles[0] * BK, BK, N, Dh, cbytes);
  stage<T, LDV>(sV, v + base, tiles[0] * BK, BK, N, Dh, cbytes);

  float o[HD / 8][4] = {};                     // rows g and g+8 of this warp, C fragments
  float m[2] = {-INFINITY, -INFINITY};         // running max of rows g, g+8 (log2 units)
  float l[2] = {0.f, 0.f};                     // this thread's part of their running sums
  const T* qw = sQ + warp * 16 * LDQK;

  for (int it = 0; it < count; ++it) {
    copy_async_wait();  // tile it (and Q) has landed
    __syncthreads();    // for every thread; and every warp is done with tile it - 1
    const int st = it % STAGES, tile = tiles[it];
    const unsigned word = words[it];
    if (it + 1 < count) {  // tile it + 1 into the slot of tile it - 1
      const int nx = tiles[it + 1] * BK;
      stage<T, LDQK>(sK + (st ^ 1) * BK * LDQK, k + base, nx, BK, N, Dh, cbytes);
      stage<T, LDV>(sV + (st ^ 1) * BK * LDV, v + base, nx, BK, N, Dh, cbytes);
    }

    float s[BK / 8][4] = {};
    scores<T, HD, LDQK>(s, qw, sK + st * BK * LDQK, g, t);

    // scale and mask; the tile's row max over the quad that holds the row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = 8 * j + 2 * t + (c & 1);
        const float x = (word >> key) & 1u ? s[j][c] * scale_log2
                                           : (tile * BK + key < N ? MASKED : -INFINITY);
        s[j][c] = x;
        mx[c / 2] = fmaxf(mx[c / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);  // finite mx: the tile has a key < N
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c / 2]);
        l[c / 2] += s[j][c];
      }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nt][c] *= alpha[c / 2];
    weigh_values<T, HD, LDV>(o, s, sV + st * BK * LDV, lane, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    l[i] = 1.f / l[i];
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;  // Dh is even: both columns or neither
    if (col >= Dh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < N)
        store2(out + base + (size_t)(row0 + 8 * i) * Dh + col, o[nt][2 * i] * l[i],
               o[nt][2 * i + 1] * l[i]);
  }
}

// the widest copy that every row start allows: 16, 8 or 4 bytes
int copy_bytes(int row_bytes, const void* const* ptrs, int n) {
  for (int c = 16; c > 4; c /= 2) {
    bool ok = row_bytes % c == 0;
    for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % c == 0;
    if (ok) return c;
  }
  return 4;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* plan, void* out, int B,
                   int H, int N, int Dh, float scale, int blocks, cudaStream_t stream) {
  const auto kernel = masked_attention_kernel<T, HD>;
  const size_t smem = Smem<T, HD>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const void* ptrs[] = {q, k, v, out};
  const int cbytes = copy_bytes(Dh * (int)sizeof(T), ptrs, 4);
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), plan,
      static_cast<T*>(out), B, H, N, Dh, scale * LOG2E, cbytes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const int* plan, void* out,
                      int B, int H, int N, int Dh, float scale, int blocks, cudaStream_t s) {
  if (Dh <= 32) return launch<T, 32>(q, k, v, plan, out, B, H, N, Dh, scale, blocks, s);
  if (Dh <= 64) return launch<T, 64>(q, k, v, plan, out, B, H, N, Dh, scale, blocks, s);
  return launch<T, 128>(q, k, v, plan, out, B, H, N, Dh, scale, blocks, s);
}

}  // namespace

// q, k, v, out: [B, H, N, Dh] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); mask: [B, N] bytes, nonzero = valid key; plan: scratch of
// B * (2 + 2 * ceil(N / 32)) int32. Two launches on `stream` (the plan, then
// the attention); returns the CUDA error code (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* plan, void* out, int B, int H, int N,
                                    int Dh, float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || Dh <= 0 || Dh > MAX_DH || Dh % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * ((N + BQ - 1) / BQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* p = static_cast<int*>(plan);
  plan_kernel<<<1, PLAN_THREADS, 0, s>>>(static_cast<const unsigned char*>(mask), B, N,
                                         (N + BK - 1) / BK, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, p, out, B, H, N, Dh, scale, (int)blocks, s)
                       : launch_dh<float>(q, k, v, p, out, B, H, N, Dh, scale, (int)blocks, s));
}
