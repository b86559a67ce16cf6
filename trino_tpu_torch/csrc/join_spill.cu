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
// K16 (prep mode), two launches of work around K10's radix passes:
//   1. spill_prep — one thread per live row (below num_rows): its 64-bit
//      join key (common.cuh join_key: the reference's _key_u64), a
//      NULL-keyed row masked to u64::MAX, written as two order-preserving
//      words (key, dead) for csrc/sort.cu's sort_radix. Rows past
//      num_rows are not written: K10 reads only the live prefix. Each
//      block adds its count of keyed rows to N_LIVE with one atomic and
//      marks HAS_NULL with one store; block 0 writes N_ROWS and UNIQUE's
//      starting 1. No thread makes an atomic of its own.
//   2. sort_radix (K10, launched by ops/join.py) over the live prefix — a
//      stable LSD sort by (key, dead), so a live key of -1 sorts before
//      the NULL-keyed rows. The dead word's pass is trivial (skipped on
//      the device) unless some live row has a NULL key; K10's last
//      informative pass writes the sorted keys (the key word's top bytes
//      are trivial for keys below 2^56; when every key pass is, K10's
//      finish gathers them through the permutation), and rows past
//      num_rows keep their places, which is where the stable order over
//      the whole capacity puts them.
//   3. spill_prep_finish — coalesced over the sorted keys: u64::MAX from
//      num_rows on, UNIQUE 0 when a position in [1, N_LIVE) holds its
//      predecessor's key (one store per block that finds one), and KMIN
//      and KMAX from the sorted ends (the live keys come first).
// K17 (probe modes), ONE launch a call in either mode: in dense mode one
// table read (the build row or INT32_MAX); in search mode a lower bound
// over the sorted key array (the reference's anchored search computes the
// same position: its anchor subsample only bounds the TPU's sort
// workspace). found needs a live, non-NULL probe key (and, searching, a
// position below the live count). A probe page holds its live rows in a
// larger buffer (q3 sf1: about 3.05 M live rows of 5.24 M), so the blocks
// walk the live prefix only: rows at and past num_rows are neither read
// nor written (the executor's K1 compaction keeps i < num_rows, and
// attach_build_host fetches brow[:num_rows]). A block walks tiles of
// THREADS x R rows, thread t taking rows t, t + THREADS, ... of a tile,
// so every load and store of a warp is coalesced; in dense mode R = 2 and
// a thread's two rows go through each phase together (their key reads,
// then their table reads), so their loads overlap; searching, R = 1 (the
// probe loop leaves nothing to overlap). No memset: each block adds its
// match count and one ticket to a per-device word in one atomic (K6's
// word, ops/join.py _probe_scratch), and the block whose ticket is the
// last writes the total to the call's own count word and zeroes the
// per-device word. The key columns travel in a parameter block of 8, 64
// or TABLE_MAX words (common.cuh ParamBlock), sized to the call.
//
// Bound on this card: bytes. K16 reads the key columns of the live rows
// once and writes the sorted keys and permutation once (12 bytes a row);
// its radix passes re-read 12 bytes a row and write them per informative
// digit pass (the key's eight bytes where they differ; the dead word's
// byte only with NULL keys). K17 reads the live probe rows' key columns
// once and writes their found and brow (9 bytes a row); its lookups are
// random reads of the table or of log2(n) key words, L2-resident below
// 50 MB.
#include "common.cuh"

namespace {
constexpr uint64_t SIGN = 0x8000000000000000ULL;
constexpr int THREADS = 256;
// statistic slots (ops/join.py: N_LIVE, N_ROWS, HAS_NULL, then
// SPILL_UNIQUE in K5's MAX_RUN slot, KMIN, KMAX)
enum { N_LIVE = 0, N_ROWS = 1, HAS_NULL = 2, UNIQUE = 3, KMIN = 4,
       KMAX = 5, N_STATS = 10 };
enum { MODE_DENSE = 0, MODE_SEARCH = 1 };
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
constexpr int DENSE_ROWS = 2;   // R of the dense mode
constexpr int SEARCH_ROWS = 1;  // R of the search mode
// the per-device word: tickets taken << TICKET_SHIFT | matches so far
constexpr int TICKET_SHIFT = 40;
constexpr unsigned long long MATCH_MASK = (1ULL << TICKET_SHIFT) - 1;
int64_t probe_enqueues = 0;  // stream operations spill_probe enqueued

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__global__ void prep_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                            int64_t cap, const int32_t* __restrict__ n_ptr,
                            int64_t* __restrict__ words,
                            unsigned long long* __restrict__ stats) {
  __shared__ int warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[N_ROWS] = (unsigned long long)n;
    stats[UNIQUE] = 1;
  }
  int keyed = 0;
  bool any_null = false;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null = false;
    uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) {
      key = ~0ULL;
      any_null = true;
    } else {
      ++keyed;
    }
    words[i] = (int64_t)(key ^ SIGN);
    words[cap + i] = (int64_t)((null ? SIGN : 0ULL) ^ SIGN);
  }
  int total;
  block_exclusive_scan(keyed, warp_sums, &total);
  if (threadIdx.x == 0 && total)
    atomicAdd(&stats[N_LIVE], (unsigned long long)total);
  if (__syncthreads_or(any_null) && threadIdx.x == 0) stats[HAS_NULL] = 1;
}

__global__ void spill_finish_kernel(int64_t cap,
                                    const int32_t* __restrict__ n_ptr,
                                    int64_t* __restrict__ keys,
                                    unsigned long long* __restrict__ stats) {
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t n_live = (int64_t)stats[N_LIVE];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[KMIN] = n_live > 0 ? (unsigned long long)keys[0] : ~0ULL;
    stats[KMAX] = n_live > 0 ? (unsigned long long)keys[n_live - 1] : 0ULL;
  }
  bool dup = false;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i >= n) keys[i] = -1;
    else if (i > 0 && i < n_live && keys[i] == keys[i - 1]) dup = true;
  }
  if (__syncthreads_or(dup) && threadIdx.x == 0) stats[UNIQUE] = 0;
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

// ticket: the per-device word, 0 between calls; count: this call's own
// word.
template <int W, int MODE>
__global__ void __launch_bounds__(THREADS)
    probe_kernel(const __grid_constant__ ParamBlock<W> tbl, int nkeys,
                 int64_t cap, const int32_t* __restrict__ n_ptr,
                 const int32_t* __restrict__ table, int64_t size,
                 const uint64_t* __restrict__ bkeys,
                 const int32_t* __restrict__ bperm, int64_t nbuild,
                 const unsigned long long* __restrict__ stats,
                 uint8_t* __restrict__ found, int64_t* __restrict__ brow,
                 unsigned long long* __restrict__ ticket,
                 unsigned long long* __restrict__ count) {
  constexpr int R = MODE == MODE_DENSE ? DENSE_ROWS : SEARCH_ROWS;
  __shared__ unsigned long long warp_hits[THREADS / 32];
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t step = (int64_t)gridDim.x * THREADS * R;
  unsigned long long hits = 0;
  for (int64_t base = (int64_t)blockIdx.x * THREADS * R + threadIdx.x;
       base < n; base += step) {
    uint64_t key[R];
    bool keyed[R];  // a live row with a non-NULL key
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = base + r * THREADS;
      bool null = true;
      key[r] = i < n ? join_key(tbl.v, nkeys, i, &null) : 0;
      keyed[r] = !null;
    }
    bool f[R];
    int64_t b[R];
    if constexpr (MODE == MODE_DENSE) {
      const uint64_t kmin = stats[KMIN];
      int32_t r32[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        r32[r] = keyed[r] ? dense_find(key[r], kmin, table, size)
                          : 0x7fffffff;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        f[r] = r32[r] != 0x7fffffff;
        b[r] = f[r] ? r32[r] : 0;
      }
    } else {
      // brow is the permutation at the clamped lower bound for every live
      // row, NULL-keyed or not, as the reference leaves it
      const int64_t n_live = (int64_t)stats[N_LIVE];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t lo = lower_bound(bkeys, nbuild, key[r]);
        const int64_t lc =
            lo < nbuild - 1 ? lo : (nbuild > 0 ? nbuild - 1 : 0);
        f[r] = keyed[r] && lo < n_live && nbuild > 0 && bkeys[lc] == key[r];
        b[r] = nbuild > 0 ? bperm[lc] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = base + r * THREADS;
      if (i < n) {
        found[i] = f[r] ? 1 : 0;
        brow[i] = b[r];
        hits += f[r] ? 1ULL : 0ULL;
      }
    }
  }
  hits = warp_sum(hits);
  if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += warp_hits[w];
    const unsigned long long old =
        atomicAdd(ticket, (1ULL << TICKET_SHIFT) + sum);
    if ((old >> TICKET_SHIFT) == gridDim.x - 1) {  // every other block added
      *count = (old & MATCH_MASK) + sum;
      *ticket = 0;
    }
  }
}

template <int W, int MODE>
int launch_mode(const ParamBlock<W>& t, int64_t nkeys, int64_t cap,
                const void* num_rows, const void* dense, int64_t size,
                const void* bkeys, const void* bperm, int64_t nbuild,
                const void* stats, void* found, void* brow, void* count,
                void* ticket, int64_t grid, cudaStream_t s) {
  probe_kernel<W, MODE><<<(unsigned)grid, THREADS, 0, s>>>(
      t, (int)nkeys, cap, static_cast<const int32_t*>(num_rows),
      static_cast<const int32_t*>(dense), size,
      static_cast<const uint64_t*>(bkeys),
      static_cast<const int32_t*>(bperm), nbuild,
      static_cast<const unsigned long long*>(stats),
      static_cast<uint8_t*>(found), static_cast<int64_t*>(brow),
      static_cast<unsigned long long*>(ticket),
      static_cast<unsigned long long*>(count));
  ++probe_enqueues;
  return (int)cudaGetLastError();
}

template <int W>
int launch_probe(const void* table, int64_t nkeys, int64_t cap,
                 const void* num_rows, int64_t mode, const void* dense,
                 int64_t size, const void* bkeys, const void* bperm,
                 int64_t nbuild, const void* stats, void* found, void* brow,
                 void* count, void* ticket, int64_t grid, cudaStream_t s) {
  thread_local static ParamBlock<W> t;  // each launch copies it
  load_block(table, KEY_FIELDS * nkeys, &t);
  if (mode == MODE_DENSE)
    return launch_mode<W, MODE_DENSE>(t, nkeys, cap, num_rows, dense, size,
                                      bkeys, bperm, nbuild, stats, found,
                                      brow, count, ticket, grid, s);
  return launch_mode<W, MODE_SEARCH>(t, nkeys, cap, num_rows, dense, size,
                                     bkeys, bperm, nbuild, stats, found,
                                     brow, count, ticket, grid, s);
}

int grid_for(int64_t rows) {
  int64_t blocks = (rows + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 4224 ? 4224 : blocks);  // grid-stride beyond
}
}  // namespace

// table: int64 HOST array, 4 words per key column (values ptr, valid ptr
// or 0, element size, is_float); words: int64[2 * cap] out (the key word
// then the dead word of every live row, each stored with its sign bit
// flipped, as csrc/sort.cu reads them); stats: int64[10] out (N_LIVE,
// N_ROWS, HAS_NULL, UNIQUE (finished by spill_prep_finish), KMIN and KMAX
// (written by spill_prep_finish)), zeroed here. Returns
// cudaGetLastError(), or -1 on a bad table.
TT_EXPORT int spill_prep(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, void* words, void* stats,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, 4 * nkeys, &t)) return -1;
  cudaMemsetAsync(stats, 0, N_STATS * sizeof(int64_t), s);
  prep_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, static_cast<const int32_t*>(num_rows),
      static_cast<int64_t*>(words), static_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// num_rows and stats as spill_prep had them; keys: int64[cap], the
// sorted unsigned key words sort_radix wrote over the live prefix, in
// place: u64::MAX from num_rows on; stats' UNIQUE, KMIN and KMAX. Returns
// cudaGetLastError().
TT_EXPORT int spill_prep_finish(int64_t cap, const void* num_rows, void* keys,
                                void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spill_finish_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      cap, static_cast<const int32_t*>(num_rows), static_cast<int64_t*>(keys),
      static_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// table: int64 HOST array, KEY_FIELDS words per probe key column (as
// spill_prep); mode 0 dense (dense: int32[size], kmin from stats), 1
// search (bkeys: int64[nbuild] sorted unsigned, bperm: int32[nbuild], the
// live count from stats); the pointers the other mode reads may be 0;
// found: uint8[cap], brow: int64[cap] (both written below num_rows only);
// count: int64, written (no zeroing needed); ticket: the per-device
// uint64, 0 between calls (left 0); grid >= 1 blocks. One launch. Returns
// cudaGetLastError(), or -1 on a bad mode, grid or table.
TT_EXPORT int spill_probe(const void* table, int64_t nkeys, int64_t cap,
                          const void* num_rows, int64_t mode,
                          const void* dense, int64_t size, const void* bkeys,
                          const void* bperm, int64_t nbuild,
                          const void* stats, void* found, void* brow,
                          void* count, void* ticket, int64_t grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkeys < 1 || grid < 1 || (mode != MODE_DENSE && mode != MODE_SEARCH))
    return -1;
  switch (param_block_words(KEY_FIELDS * nkeys)) {
    case 8:
      return launch_probe<8>(table, nkeys, cap, num_rows, mode, dense, size,
                             bkeys, bperm, nbuild, stats, found, brow, count,
                             ticket, grid, s);
    case 64:
      return launch_probe<64>(table, nkeys, cap, num_rows, mode, dense, size,
                              bkeys, bperm, nbuild, stats, found, brow,
                              count, ticket, grid, s);
    case TABLE_MAX:
      return launch_probe<TABLE_MAX>(table, nkeys, cap, num_rows, mode,
                                     dense, size, bkeys, bperm, nbuild,
                                     stats, found, brow, count, ticket, grid,
                                     s);
    default:
      return -1;
  }
}

// The stream operations spill_probe has enqueued in this process
// (chip_smoke.py counts them per call).
TT_EXPORT int64_t spill_probe_enqueues() { return probe_enqueues; }
