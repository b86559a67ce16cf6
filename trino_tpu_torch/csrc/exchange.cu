// K35: the exchange pack, and K36: heavy-key detection.
//
// K35 replaces trino_tpu/parallel/exchange.py _partition_of, _is_heavy,
// all_to_all_by_key and all_to_all_replicate (:46-:247): each source
// shard's rows get their destinations (mix64 of the join-key word mod n;
// a NULL key goes to 0; in spread mode a heavy key's row goes to
// (mix64(key) + row) mod n; in replicate mode a heavy non-NULL row goes to
// every destination), then every column moves into fixed per-destination
// buckets, rows of one destination in source order.
//
// Launches of exchange_count (before the host knows the bucket):
//   1. dest_kernel — one thread per row: the key word (csrc/common.cuh
//      join_key, K5's), the destination as int32 (-1: every destination,
//      n: a dead row), the heavy set held in shared memory;
//   2. tile_dest_count_kernel — per tile of TILE rows, each destination's
//      rows (a replicated row counts in every destination);
//   3. csrc/tile.cuh tile_scan_kernel over the destination-major counts:
//      each (destination, tile) gets its first rank, and the total;
//   4. dest_counts_kernel — each destination's rows.
// The host reads the n x n counts of all sources in one fetch, sizes the
// bucket as the reference's capacity ladder ends, and launches
// exchange_scatter: per tile and destination a block scan ranks the
// tile's rows of that destination, and each row with rank < bucket lands
// at d * bucket + rank of every array (a missing validity written as
// true). Slots past a destination's count are not written. The receive
// (K2, csrc/concat.cu) concatenates min(count, bucket) rows of each
// source's bucket for a destination, in source order.
//
// K36 replaces detect_heavy_keys (:70-:110) after its sort (K10 sorts the
// masked key words): heavy_local keeps the k largest run lengths of one
// shard's sorted words by (count descending, position ascending), the
// order lax.top_k gives; heavy_merge sums the n x k candidates' counts
// over equal keys, keeps each key's first occurrence, drops those under
// min_global_count and keeps the k best by (score descending, index
// ascending), the sentinel 2^64 - 1 past them.
//
// Bound on this card: bytes. K35 reads the key columns once for the
// destinations and every column once, and writes every moved row once;
// K36 reads the sorted words once (a run's length is a binary search).
#include "tile.cuh"

namespace {
constexpr uint64_t SENT = 0xFFFFFFFFFFFFFFFFULL;
constexpr int MAX_HEAVY = 64;  // ops: skew_heavy_key_limit's ceiling here
constexpr int MAX_N = 64;      // destinations of one exchange
enum { MODE_HASH = 0, MODE_SPREAD = 1, MODE_REPLICATE = 2 };

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__global__ void dest_kernel(const int32_t* __restrict__ n_ptr, int64_t cap,
                            int64_t nkeys, const __grid_constant__ Table keys,
                            int64_t n, int mode,
                            const uint64_t* __restrict__ heavy, int64_t k,
                            int32_t* __restrict__ dest) {
  __shared__ uint64_t hv[MAX_HEAVY];
  for (int j = threadIdx.x; j < k; j += blockDim.x) hv[j] = heavy[j];
  __syncthreads();
  const int64_t live = live_rows(n_ptr, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i >= live) {
      dest[i] = (int32_t)n;
      continue;
    }
    bool null;
    const uint64_t key = join_key(keys.v, nkeys, i, &null);
    const uint64_t h = mix64(key);
    int32_t d = null ? 0 : (int32_t)(h % (uint64_t)n);
    if (mode != MODE_HASH && !null) {
      bool is_heavy = false;
      for (int64_t j = 0; j < k; ++j)
        is_heavy |= hv[j] == key && hv[j] != SENT;
      if (is_heavy)
        d = mode == MODE_SPREAD ? (int32_t)((h + (uint64_t)i) % (uint64_t)n)
                                : -1;
    }
    dest[i] = d;
  }
}

__device__ __forceinline__ bool member(int32_t d_row, int64_t d) {
  return d_row == d || d_row == -1;
}

// counts[d * ntiles + tile] = rows of the tile bound for destination d.
__global__ void tile_dest_count_kernel(const int32_t* __restrict__ dest,
                                       int64_t cap, int64_t n,
                                       int64_t ntiles,
                                       int64_t* __restrict__ counts) {
  __shared__ int hist[MAX_N];
  for (int b = threadIdx.x; b < n; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    const int64_t i = base + r;
    if (i >= cap) break;
    const int32_t d = dest[i];
    if (d == -1) {
      for (int64_t q = 0; q < n; ++q) atomicAdd(&hist[q], 1);
    } else if (d < n) {
      atomicAdd(&hist[d], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += blockDim.x)
    counts[(int64_t)b * ntiles + blockIdx.x] = hist[b];
}

__global__ void dest_counts_kernel(const int64_t* __restrict__ offsets,
                                   int64_t ntiles, int64_t n,
                                   int64_t* __restrict__ counts) {
  const int64_t d = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (d < n) counts[d] = offsets[(d + 1) * ntiles] - offsets[d * ntiles];
}

// `cols`: 3 words per array (source ptr or 0 for an absent validity,
// destination ptr, row bytes).
__global__ void scatter_kernel(const int32_t* __restrict__ dest, int64_t cap,
                               int64_t n, int64_t ntiles,
                               const int64_t* __restrict__ offsets,
                               int64_t bucket,
                               const __grid_constant__ Table cols,
                               int64_t ncols) {
  __shared__ int warp_sums[32];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int64_t d = 0; d < n; ++d) {
    // this tile's first rank within destination d
    int64_t rank0 = offsets[d * ntiles + blockIdx.x] - offsets[d * ntiles];
    for (int r = 0; r < TILE; r += blockDim.x) {
      const int64_t i = base + r + threadIdx.x;
      const int f = i < cap && member(dest[i], d) ? 1 : 0;
      int total;
      const int ex = block_exclusive_scan(f, warp_sums, &total);
      const int64_t rank = rank0 + ex;
      if (f && rank < bucket) {
        const int64_t slot = d * bucket + rank;
        for (int64_t c = 0; c < ncols; ++c) {
          const void* src = reinterpret_cast<const void*>(cols.v[3 * c]);
          void* dst = reinterpret_cast<void*>(cols.v[3 * c + 1]);
          if (src == nullptr)
            static_cast<uint8_t*>(dst)[slot] = 1;
          else
            copy_elem(src, i, dst, slot, cols.v[3 * c + 2]);
        }
      }
      rank0 += total;
    }
  }
}

// ------------------------------------------------------------------ K36

// Candidate score: larger is better; (count, -position) in one word.
__device__ __forceinline__ uint64_t score_of(uint64_t count, uint64_t pos) {
  return (count << 32) | (0xFFFFFFFFULL - pos);
}

// Insert v into a descending list of k (kept in registers or local
// memory); the smallest falls off.
__device__ __forceinline__ void keep_top(uint64_t* top, int k, uint64_t v) {
  if (v <= top[k - 1]) return;
  int j = k - 1;
  while (j > 0 && top[j - 1] < v) {
    top[j] = top[j - 1];
    --j;
  }
  top[j] = v;
}

// One block's k best of each thread's descending list `top` (scores are
// distinct: they carry the position): k rounds of a block max.
__device__ void block_top(const uint64_t* top, int k, uint64_t* out) {
  __shared__ uint64_t best[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int at = 0;
  for (int round = 0; round < k; ++round) {
    uint64_t v = at < k ? top[at] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w > v ? w : v;
    }
    if (lane == 0) best[warp] = v;
    __syncthreads();
    uint64_t m = 0;
    for (int w = 0; w < nwarps; ++w) m = best[w] > m ? best[w] : m;
    if (at < k && top[at] == m && m != 0) ++at;
    if (threadIdx.x == 0) out[round] = m;
    __syncthreads();
  }
}

// sorted: u64 words ascending (as unsigned); per block its k best scores
// of cand_count = the run length at a run start of a non-sentinel word,
// else 0 (a zero still ranks, by position, as in lax.top_k).
__global__ void heavy_local_kernel(const uint64_t* __restrict__ sorted,
                                   int64_t cap, int k,
                                   uint64_t* __restrict__ partial) {
  uint64_t top[MAX_HEAVY];
  for (int j = 0; j < k; ++j) top[j] = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t s = sorted[i];
    uint64_t count = 0;
    if (s != SENT && (i == 0 || sorted[i - 1] != s)) {
      int64_t lo = i, hi = cap;  // first word past s
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (sorted[mid] <= s) lo = mid + 1;
        else hi = mid;
      }
      count = (uint64_t)(lo - i);
    }
    keep_top(top, k, score_of(count, (uint64_t)i) + 1);
  }
  block_top(top, k, partial + (int64_t)blockIdx.x * k);
}

// One block: the k best of the partial lists; counts and keys out.
__global__ void heavy_local_final_kernel(const uint64_t* __restrict__ partial,
                                         int64_t m, int k,
                                         const uint64_t* __restrict__ sorted,
                                         int64_t cap,
                                         int64_t* __restrict__ counts,
                                         uint64_t* __restrict__ keys) {
  __shared__ uint64_t out[MAX_HEAVY];
  uint64_t top[MAX_HEAVY];
  for (int j = 0; j < k; ++j) top[j] = 0;
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x)
    keep_top(top, k, partial[i]);
  block_top(top, k, out);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint64_t v = out[j];
    if (v == 0) {  // fewer than k rows: a sentinel with no count
      counts[j] = 0;
      keys[j] = SENT;
      continue;
    }
    const uint64_t sc = v - 1;
    const int64_t pos = (int64_t)(0xFFFFFFFFULL - (sc & 0xFFFFFFFFULL));
    counts[j] = (int64_t)(sc >> 32);
    keys[j] = pos < cap ? sorted[pos] : SENT;
  }
}

// One block over m = n * k candidates (shard-major).
__global__ void heavy_merge_kernel(const uint64_t* __restrict__ keys,
                                   const int64_t* __restrict__ counts,
                                   int64_t m, int k, int64_t min_count,
                                   uint64_t* __restrict__ heavy) {
  __shared__ uint64_t out[MAX_HEAVY];
  uint64_t top[MAX_HEAVY];
  for (int j = 0; j < k; ++j) top[j] = 0;
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
    const uint64_t key = keys[i];
    int64_t glob = 0;
    bool first = true;
    for (int64_t j = 0; j < m; ++j) {
      if (keys[j] != key) continue;
      glob += counts[j];
      first &= j >= i;
    }
    // score + 1 in the high bits (-1 -> 0), the index in the low 20
    const int64_t score = key != SENT && first && glob >= min_count ? glob
                                                                     : -1;
    keep_top(top, k, ((uint64_t)(score + 1) << 20) |
                         (0xFFFFFULL - (uint64_t)i));
  }
  block_top(top, k, out);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint64_t v = out[j];
    const int64_t score = (int64_t)(v >> 20) - 1;
    const int64_t idx = (int64_t)(0xFFFFFULL - (v & 0xFFFFFULL));
    heavy[j] = score > 0 && idx < m ? keys[idx] : SENT;
  }
}

int grid_for(int64_t rows, int threads) {
  int64_t blocks = (rows + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 4224 ? 4224 : blocks);  // grid-stride beyond
}
}  // namespace

// keys: int64 HOST array, 4 words per key column (values ptr, valid ptr
// or 0, element size, is_float); n destinations in [1, 64]; mode 0 hash,
// 1 spread, 2 replicate; heavy: k u64 words on the device (k <= 64; 0
// with k 0 in hash mode). dest: int32[max(cap, 1)] out; hist:
// int64[n * tile_blocks(cap) + 1] out (the scanned offsets, kept for
// exchange_scatter); counts: int64[n] out. Returns cudaGetLastError(), or
// -1 on a bad table or argument.
TT_EXPORT int exchange_count(const void* keys, int64_t nkeys, int64_t cap,
                             const void* num_rows, int64_t n, int64_t mode,
                             const void* heavy, int64_t k, void* dest,
                             void* hist, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table kt;
  if (n < 1 || n > MAX_N || k < 0 || k > MAX_HEAVY || nkeys < 1 ||
      load_table(keys, 4 * nkeys, &kt))
    return -1;
  auto* d = static_cast<int32_t*>(dest);
  auto* offs = static_cast<int64_t*>(hist);
  if (cap > 0)
    dest_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
        static_cast<const int32_t*>(num_rows), cap, nkeys, kt, n, (int)mode,
        static_cast<const uint64_t*>(heavy), k, d);
  const int64_t ntiles = tile_blocks(cap);
  tile_dest_count_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, s>>>(
      d, cap, n, ntiles, offs);
  tile_scan_kernel<<<1, 1024, 0, s>>>(offs, n * ntiles, offs + n * ntiles);
  dest_counts_kernel<<<1, 64, 0, s>>>(offs, ntiles, n,
                                      static_cast<int64_t*>(counts));
  return (int)cudaGetLastError();
}

// dest, hist: exchange_count's outputs for this page; cols: int64 HOST
// array, 3 words per moved array (source ptr or 0 for a validity to write
// as true, destination ptr of n * bucket rows, row bytes). Returns
// cudaGetLastError(), or -1 on a bad table.
TT_EXPORT int exchange_scatter(const void* dest, int64_t cap, int64_t n,
                               const void* hist, int64_t bucket,
                               const void* cols, int64_t ncols,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table ct;
  if (n < 1 || n > MAX_N || bucket < 1 || load_table(cols, 3 * ncols, &ct))
    return -1;
  if (cap > 0 && ncols > 0)
    scatter_kernel<<<(unsigned)tile_blocks(cap), TILE_THREADS, 0, s>>>(
        static_cast<const int32_t*>(dest), cap, n, tile_blocks(cap),
        static_cast<const int64_t*>(hist), bucket, ct, ncols);
  return (int)cudaGetLastError();
}

// sorted: u64[cap] ascending (NULL and dead rows the sentinel); partial:
// u64[64 * k] scratch; counts: int64[k] out, keys: u64[k] out. k in
// [1, 64], cap < 2^32.
TT_EXPORT int heavy_local(const void* sorted, int64_t cap, int64_t k,
                          void* partial, void* counts, void* keys,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > MAX_HEAVY || cap < 0 || cap >= (1LL << 32)) return -1;
  const int64_t blocks = grid_for(cap, 256) < 64 ? grid_for(cap, 256) : 64;
  heavy_local_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const uint64_t*>(sorted), cap, (int)k,
      static_cast<uint64_t*>(partial));
  heavy_local_final_kernel<<<1, 256, 0, s>>>(
      static_cast<const uint64_t*>(partial), blocks * k, (int)k,
      static_cast<const uint64_t*>(sorted), cap,
      static_cast<int64_t*>(counts), static_cast<uint64_t*>(keys));
  return (int)cudaGetLastError();
}

// keys: u64[m], counts: int64[m] (the shards' candidates, shard-major);
// heavy: u64[k] out. m < 2^20, k in [1, 64].
TT_EXPORT int heavy_merge(const void* keys, const void* counts, int64_t m,
                          int64_t k, int64_t min_count, void* heavy,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > MAX_HEAVY || m < 0 || m >= (1LL << 20)) return -1;
  heavy_merge_kernel<<<1, 256, 0, s>>>(
      static_cast<const uint64_t*>(keys), static_cast<const int64_t*>(counts),
      m, (int)k, min_count, static_cast<uint64_t*>(heavy));
  return (int)cudaGetLastError();
}
