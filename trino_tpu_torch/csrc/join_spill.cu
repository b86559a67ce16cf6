// K16 and K17: the spilled join's build keys and its probe.
//
// Replaces trino_tpu/ops/join.py prepare_build_spilled (:485),
// spilled_dense_probe (:533), _searchsorted_anchored (:559) and
// spilled_unique_probe (:584). A build past join_spill_threshold_bytes
// keeps only its sorted keys and their permutation on the device (about
// 12 bytes a row; its payload columns move to host memory), or, for a
// dense key span, a table of build rows (4 bytes a slot, K5's dense mode
// with the permutation as payload: csrc/join_build.cu join_dense).
//
// K16 (prep mode), three launches of work around K10's radix passes:
//   1. spill_prep — one thread per build row: its 64-bit join key
//      (common.cuh join_key: the reference's _key_u64), dead (past
//      num_rows) and NULL-keyed rows masked to u64::MAX, written as two
//      order-preserving words (key, dead) for csrc/sort.cu's sort_radix;
//      the statistics by atomics: live non-NULL rows, live rows, any NULL
//      key, and the unsigned min/max of the live keys.
//   2. sort_radix (K10, launched by ops/join.py) — a stable LSD sort by
//      (key, dead), so a live key of -1 sorts before the masked rows.
//   3. spill_prep_finish — the sorted keys, gathered through the
//      permutation, and is_unique: no live position holds its
//      predecessor's key.
// K17 (probe modes), one thread per probe row: in dense mode one table
// read (the build row or INT32_MAX); in search mode a lower bound over the
// sorted key array (the reference's anchored search computes the same
// position: its anchor subsample only bounds the TPU's sort workspace).
// found needs a live, non-NULL probe key (and, searching, a position
// below the live count); the match count is one atomic per block.
//
// Bound on this card: bytes. K16 reads the key columns once and writes
// the sorted keys and permutation once (12 bytes a row); its radix passes
// re-read 16 bytes a row per digit pass, nine passes. K17 reads the probe
// key columns once, writes found and brow (9 bytes a row); its lookups are
// random reads of the table or of log2(n) key words, L2-resident below
// 50 MB.
#include "common.cuh"

namespace {
constexpr uint64_t SIGN = 0x8000000000000000ULL;
constexpr int THREADS = 256;
// statistic slots (ops/join.py: N_LIVE, N_ROWS, HAS_NULL, then
// SPILL_UNIQUE in K5's MAX_RUN slot, KMIN, KMAX)
enum { N_LIVE = 0, N_ROWS = 1, HAS_NULL = 2, UNIQUE = 3, KMIN = 4,
       KMAX = 5 };
enum { MODE_DENSE = 0, MODE_SEARCH = 1 };

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__global__ void prep_init_kernel(const int32_t* __restrict__ n_ptr,
                                 int64_t cap,
                                 unsigned long long* __restrict__ stats) {
  stats[N_LIVE] = 0;
  stats[N_ROWS] = (unsigned long long)live_rows(n_ptr, cap);
  stats[HAS_NULL] = 0;
  stats[UNIQUE] = 1;
  stats[KMIN] = ~0ULL;
  stats[KMAX] = 0;
}

__global__ void prep_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                            int64_t cap, const int32_t* __restrict__ n_ptr,
                            int64_t* __restrict__ words,
                            unsigned long long* __restrict__ stats) {
  __shared__ int warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  int live_count = 0;
  bool any_null = false;
  uint64_t lo = ~0ULL, hi = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null = false;
    uint64_t key = join_key(tbl.v, nkeys, i, &null);
    const bool live = i < n;
    const bool dead = !live || null;
    if (live && null) any_null = true;
    if (dead) {
      key = ~0ULL;
    } else {
      ++live_count;
      lo = key < lo ? key : lo;
      hi = key > hi ? key : hi;
    }
    words[i] = (int64_t)(key ^ SIGN);
    words[cap + i] = (int64_t)((dead ? SIGN : 0ULL) ^ SIGN);
  }
  int total;
  block_exclusive_scan(live_count, warp_sums, &total);
  if (threadIdx.x == 0 && total)
    atomicAdd(&stats[N_LIVE], (unsigned long long)total);
  if (any_null) stats[HAS_NULL] = 1;
  if (lo != ~0ULL) atomicMin(&stats[KMIN], (unsigned long long)lo);
  if (hi != 0) atomicMax(&stats[KMAX], (unsigned long long)hi);
}

__global__ void finish_kernel(int64_t cap, const int64_t* __restrict__ words,
                              const int32_t* __restrict__ perm,
                              int64_t* __restrict__ keys,
                              unsigned long long* __restrict__ stats) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t r = perm[i];
    const uint64_t key = (uint64_t)words[r] ^ SIGN;
    keys[i] = (int64_t)key;
    // a live position (the live rows sort first) equal to its predecessor
    const bool dead = ((uint64_t)words[cap + r] ^ SIGN) != 0;
    if (i > 0 && !dead && ((uint64_t)words[perm[i - 1]] ^ SIGN) == key)
      stats[UNIQUE] = 0;
  }
}

// The first position of the sorted array `keys` (n words, unsigned order)
// holding a key >= `key`.
__device__ __forceinline__ int64_t lower_bound(const uint64_t* keys,
                                               int64_t n, uint64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void probe_kernel(const __grid_constant__ Table tbl,
                             int64_t nkeys, int64_t cap,
                             const int32_t* __restrict__ n_ptr, int mode,
                             const int32_t* __restrict__ table, int64_t size,
                             const uint64_t* __restrict__ bkeys,
                             const int32_t* __restrict__ bperm,
                             int64_t nbuild,
                             const unsigned long long* __restrict__ stats,
                             bool* __restrict__ found,
                             int64_t* __restrict__ brow,
                             unsigned long long* __restrict__ count) {
  __shared__ int warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  const uint64_t kmin = stats[KMIN];
  const int64_t n_live = (int64_t)stats[N_LIVE];
  int hits = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null = false;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    const bool dead = i >= n || null;
    bool f;
    int64_t b;
    if (mode == MODE_DENSE) {
      const int32_t r = dense_find(key, kmin, table, size);
      f = !dead && r != 0x7fffffff;
      b = f ? r : 0;
    } else {
      const int64_t lo = lower_bound(bkeys, nbuild, key);
      const int64_t lc = lo < nbuild - 1 ? lo : (nbuild > 0 ? nbuild - 1 : 0);
      f = !dead && lo < n_live && nbuild > 0 && bkeys[lc] == key;
      b = nbuild > 0 ? bperm[lc] : 0;
    }
    found[i] = f;
    brow[i] = b;
    hits += f ? 1 : 0;
  }
  int total;
  block_exclusive_scan(hits, warp_sums, &total);
  if (threadIdx.x == 0 && total)
    atomicAdd(count, (unsigned long long)total);
}

int grid_for(int64_t rows) {
  int64_t blocks = (rows + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 4224 ? 4224 : blocks);  // grid-stride beyond
}
}  // namespace

// table: int64 HOST array, 4 words per key column (values ptr, valid ptr
// or 0, element size, is_float); words: int64[2 * cap] out (the key word
// then the dead word of every row, each stored with its sign bit flipped,
// as csrc/sort.cu reads them); stats: int64[10] out (N_LIVE, N_ROWS,
// HAS_NULL, UNIQUE (is_unique, set by spill_prep_finish), KMIN, KMAX).
// Returns cudaGetLastError(), or -1 on a bad table.
TT_EXPORT int spill_prep(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, void* words, void* stats,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, 4 * nkeys, &t)) return -1;
  const auto* n_ptr = static_cast<const int32_t*>(num_rows);
  auto* st = static_cast<unsigned long long*>(stats);
  prep_init_kernel<<<1, 1, 0, s>>>(n_ptr, cap, st);
  if (cap > 0)
    prep_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        t, nkeys, cap, n_ptr, static_cast<int64_t*>(words), st);
  return (int)cudaGetLastError();
}

// words and stats as spill_prep wrote them; perm: int32[cap], the stable
// order of (key, dead) from sort_radix; keys: int64[cap] out, the sorted
// key words (unsigned order). Returns cudaGetLastError().
TT_EXPORT int spill_prep_finish(int64_t cap, const void* words,
                                const void* perm, void* keys, void* stats,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap > 0)
    finish_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        cap, static_cast<const int64_t*>(words),
        static_cast<const int32_t*>(perm), static_cast<int64_t*>(keys),
        static_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// table: the probe key columns (as spill_prep); mode 0 dense (dense:
// int32[size], kmin from stats), 1 search (bkeys: int64[nbuild] sorted
// unsigned, bperm: int32[nbuild], the live count from stats); found:
// bool[cap], brow: int64[cap], count: int64 scalar, all out. Returns
// cudaGetLastError(), or -1 on a bad table.
TT_EXPORT int spill_probe(const void* table, int64_t nkeys, int64_t cap,
                          const void* num_rows, int64_t mode,
                          const void* dense, int64_t size, const void* bkeys,
                          const void* bperm, int64_t nbuild,
                          const void* stats, void* found, void* brow,
                          void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, 4 * nkeys, &t)) return -1;
  cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  if (cap > 0)
    probe_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const int32_t*>(num_rows), (int)mode,
        static_cast<const int32_t*>(dense), size,
        static_cast<const uint64_t*>(bkeys),
        static_cast<const int32_t*>(bperm), nbuild,
        static_cast<const unsigned long long*>(stats),
        static_cast<bool*>(found), static_cast<int64_t*>(brow),
        static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}
