// The same per-batch scatter-add as scatter_add_connection.cu, formulated per
// output tile: out[b, cell, :] = sum over i in entity order of emb[b, i, :]
// where idx[b, i] == cell, i.e. onehot(idx)^T . emb, computed without forming
// or testing the one-hot tile.
//
// Replaces: distar_tpu/ops/pallas_kernels.py:231 (scatter_add_onehot), whose
// pallas_call at :269 runs the body _scatter_onehot_kernel (:214) over a
// (batch, cell chunk <= 2048) grid: the one-hot tile is built in VMEM and fed
// to the MXU.
//
// Bound on the H100: the map's bytes. At the flagship serve shape (B = 32,
// N = 512, D = 32, hw = 24,320) the kernel writes a 99.6 MB map and reads
// 2.2 MB of rows and indices: 30 us at 3.35 TB/s. Each row lands in one cell,
// so the sum is 0.5 M additions; a dense one-hot product would be 0.8 GFLOP
// per sample that the data never needs.
//
// Design: write-once tiles over the whole card. The grid is (batch, tile of
// 2,048 map vectors: 256 cells at D = 32), 3,040 blocks at the flagship
// shape, with the batch fastest so that every batch's tile 0 (where padded
// entity rows land) starts in the first wave. Each block
//   1. compacts, in entity order, the rows whose cell lies in its tile (warp
//      ballot and popc prefix, no atomics);
//   2. ranks each compacted row among the earlier rows of its cell (one warp,
//      __match_any_sync, in order) and counts each cell's rows;
//   3. scans the counts and places the rows: a stable counting sort, so each
//      cell's rows sit together in entity order;
//   4. has each cell's owner (8 threads with one float4 each at D = 32) add
//      only its own rows, in order, from 0.0f, out of shared memory. The
//      rows are copied there from emb by all threads with asynchronous
//      16-byte copies issued before step 2, so that the sort hides their
//      latency (a tile with more than 256 rows stages them after the sort,
//      256 at a time);
//   5. writes every vector of its tile once, with 16-byte stores from
//      neighbouring threads; empty cells get their zeros here.
// The old kernel tested all N indices for every output (0.4 G tests per
// sample) and restaged the whole 64 KB emb[b] in each of 12 chunk blocks; here
// the work per output is its own rows only, and each row is read once. A
// cell with hundreds of rows (padding sends every padded entity to cell 0)
// costs its owner one shared-memory add per row, with the global reads done
// by the whole block. Summing each cell's rows in entity order from +0.0f is
// the entity-order loop's sequence of f32 adds, so the result is bit-equal to
// scatter_add_plain and to scatter_add_connection.cu. No float atomics.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;                    // map vectors each thread writes
constexpr int TILE_VECS = THREADS * PER_THREAD;  // map vectors per block
constexpr int STAGE_VECS = 2048;                 // row vectors staged at a time
constexpr unsigned FULL = 0xffffffffu;

// V is float4 (D % 4 == 0, aligned) or float; DV = D in units of V.
// tile = TILE_VECS / DV cells; rows = max(1, STAGE_VECS / DV) staged rows.
template <typename V>
__global__ void __launch_bounds__(THREADS)
scatter_add_onehot_kernel(const V* __restrict__ emb, const int* __restrict__ idx,
                          V* __restrict__ out, int N, int DV, int hw, int tile, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* sRows = reinterpret_cast<V*>(smem_raw);           // [rows * DV] staged rows
  int* sEnt = reinterpret_cast<int*>(sRows + rows * DV);  // [N] compacted: entity
  int* sCell = sEnt + N;                                 // [N] compacted: cell in tile
  int* sRank = sCell + N;                                // [N] rank within its cell
  int* sSorted = sRank + N;                              // [N] idx[b], then rows k by cell
  int* sCnt = sSorted + N;                               // [tile] rows per cell
  int* sStart = sCnt + tile;                             // [tile] first sorted slot
  int* sWarp = sStart + tile;                            // [WARPS] per-warp totals

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int ncell = min(tile, hw - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* ix = idx + (size_t)b * N;
  const int nvec = ncell * DV;
  V* o = out + ((size_t)b * hw + c0) * DV;
  const int lines = (DV * (int)sizeof(V) + 127) / 128;  // 128-byte lines of a row

  for (int i = threadIdx.x; i < N; i += THREADS) sSorted[i] = ix[i];
  for (int c = threadIdx.x; c < tile; c += THREADS) sCnt[c] = 0;
  __syncthreads();

  // 1. ordered compaction of the rows whose cell is in this tile
  int m = 0;  // rows compacted so far; the same in every thread
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    const int c = i < N ? sSorted[i] - c0 : -1;
    const bool in = (unsigned)c < (unsigned)ncell;
    const unsigned ball = __ballot_sync(FULL, in);
    if (lane == 0) sWarp[warp] = __popc(ball);
    __syncthreads();
    int before = m, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = sWarp[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (in) {
      const int k = before + __popc(ball & lanes_below(lane));
      sEnt[k] = i;
      sCell[k] = c;
    }
    m += total;
    __syncthreads();  // sWarp is rewritten by the next chunk
  }
  // The rows are summed after the sort below. If they all fit in sRows (256
  // rows at D = 32: every tile but a crowded one), they are copied there now,
  // in compacted order and asynchronously, so that the sort runs while they
  // are in flight; a crowded tile's rows are asked for in L2 now and staged
  // after the sort, chunk by chunk in sorted order.
  const V* e = emb + (size_t)b * N * DV;
  const bool direct = m <= rows;
  for (int t = threadIdx.x; direct && t < m * DV; t += THREADS)
    copy_async(sRows + t, e + (size_t)sEnt[t / DV] * DV + t % DV);
  for (int t = threadIdx.x; !direct && t < m * lines; t += THREADS) {
    const char* row = reinterpret_cast<const char*>(e + (size_t)sEnt[t / lines] * DV);
    prefetch_l2(row + 128 * (t % lines));
  }
  if (m > 0) {
    // 2. rank within the cell and count, one warp walking the rows in order
    if (warp == 0) {
      for (int k0 = 0; k0 < m; k0 += 32) {
        const int k = k0 + lane;
        const int c = k < m ? sCell[k] : -1;
        const unsigned grp = __match_any_sync(FULL, c);
        const int base = k < m ? sCnt[c] : 0;
        __syncwarp();  // every lane has read its count before the group's last lane updates it
        if (k < m) {
          sRank[k] = base + __popc(grp & lanes_below(lane));
          if (lane == 31 - __clz(grp)) sCnt[c] = base + __popc(grp);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // 3. exclusive scan of the counts (each thread a run of `per` cells), then
    //    the stable placement
    const int per = (tile + THREADS - 1) / THREADS;
    const int lo = min((int)threadIdx.x * per, tile), hi = min(lo + per, tile);
    int sum = 0;
    for (int c = lo; c < hi; ++c) sum += sCnt[c];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) sWarp[warp] = incl;
    __syncthreads();
    int off = incl - sum;
    for (int w = 0; w < warp; ++w) off += sWarp[w];
    for (int c = lo; c < hi; ++c) {
      sStart[c] = off;
      off += sCnt[c];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += THREADS) sSorted[sStart[sCell[k]] + sRank[k]] = k;
    __syncthreads();
  }

  // 4. sum each cell's rows in entity order, a staged chunk of rows at a time
  V acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc[j] = vzero<V>();
  for (int r0 = 0; r0 < m; r0 += rows) {
    const int nr = min(rows, m - r0);
    for (int t = threadIdx.x; !direct && t < nr * DV; t += THREADS) {
      const int r = t / DV;
      copy_async(sRows + t, e + (size_t)sEnt[sSorted[r0 + r]] * DV + (t - r * DV));
    }
    copy_async_wait();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int t = threadIdx.x + j * THREADS;
      if (t < nvec) {
        const int c = t / DV, v = t - c * DV;
        const int s = sStart[c], n = sCnt[c];
        const int end = min(s + n, r0 + nr);
#pragma unroll 8
        for (int r = max(s, r0); r < end; ++r)
          vadd(acc[j], sRows[(direct ? sSorted[r] : r - r0) * DV + v]);
      }
    }
    __syncthreads();  // sRows is restaged by the next chunk
  }

  // 5. write the tile once
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int t = threadIdx.x + j * THREADS;
    if (t < nvec) o[t] = acc[j];
  }
}

template <typename V>
int launch(const void* emb, const void* idx, void* out, int B, int N, int DV, int hw,
           cudaStream_t stream) {
  if (DV > TILE_VECS) return (int)cudaErrorInvalidValue;
  const int tile = TILE_VECS / DV;
  const int rows = max(1, STAGE_VECS / DV);
  const long long tiles = ((long long)hw + tile - 1) / tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(V) * (size_t)rows * DV + sizeof(int) * (4 * (size_t)N + 2 * tile + WARPS);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // a Hopper block's shared memory
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_add_onehot_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scatter_add_onehot_kernel<V><<<dim3(B, (unsigned)tiles), THREADS, smem, stream>>>(
      static_cast<const V*>(emb), static_cast<const int*>(idx), static_cast<V*>(out), N, DV, hw,
      tile, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// emb: [B, N, D] float32; idx: [B, N] int32 already clipped to [0, hw);
// out: [B, hw, D] float32. All contiguous. Returns the CUDA error code.
extern "C" int scatter_add_onehot_fwd(const void* emb, const void* idx, void* out, int B, int N,
                                      int D, int hw, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<float4>(emb, idx, out, B, N, D / 4, hw, s)
             : launch<float>(emb, idx, out, B, N, D, hw, s);
}
