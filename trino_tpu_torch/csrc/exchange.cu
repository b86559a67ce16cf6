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
// exchange_scatter once (below): each live row with rank < bucket within
// its destination lands at d * bucket + rank of every array (a missing
// validity written as true), from one read of each destination word,
// ranks from warp ballots, and stores staged in shared memory so that
// consecutive threads write consecutive slots of a bucket. Slots past a
// destination's count are not written. The receive (K2, csrc/concat.cu)
// concatenates min(count, bucket) rows of each source's bucket for a
// destination, in source order.
//
// K36 replaces detect_heavy_keys (:70-:110) after its sort (K10 sorts the
// masked key words): heavy_local keeps the k largest run lengths of one
// shard's sorted words by (count descending, position ascending), the
// order lax.top_k gives, in one launch over the live prefix (below);
// heavy_merge sums the n x k candidates' counts
// over equal keys, keeps each key's first occurrence, drops those under
// min_global_count and keeps the k best by (score descending, index
// ascending), the sentinel 2^64 - 1 past them.
//
// Bound on this card: bytes. K35 reads the key columns once for the
// destinations, and the scatter the live destination words and every
// live row of every column once and writes every moved row once;
// K36's local mode reads the live prefix of the sorted words once (and
// a few words past each tile), the sentinel tail not at all: a run's
// length is the distance to the next run start.
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

// ---------------------------------------------------------- K35 scatter
//
// Replaces all_to_all_by_key's stable argsort by destination, ranks within
// a run and .at[slot].set of every column (trino_tpu/parallel/exchange.py
// :161-191), and all_to_all_replicate's per-destination cumsum ranks and
// scatters (:202-235). One launch, one block of SC_THREADS per TILE-row
// tile of the capacity; a block whose tile starts at or past num_rows
// (read on the device) returns at once, and no dest word or source row
// past num_rows is read.
//   1. Ranks. Warp w takes the tile's rows [512 w, 512 w + 512) in 16
//      rounds of 32 and reads each destination word once, coalesced. Per
//      destination d a __ballot_sync of the round's members (a replicated
//      row, -1, is a member of every destination, as the count pass
//      counts it) and __popc of the lanes below give each row its rank
//      among the warp's members of d; the warp's count of d goes to
//      shared memory.
//   2. One scan over (destination, warp) in warp 0: each warp's first rank
//      of d in the tile, each destination's first position in the tile's
//      destination-major order (sbase), the tile's member total. The
//      tile's first rank within d comes from the count pass's offsets, so
//      a position p of d has the slot d * bucket + rank0[d] + p - sbase[d]
//      (dropped when that rank reaches the bucket; the host reruns with a
//      larger one).
//   3. Stores, in windows of SC_STAGE positions (one window unless
//      replicated rows make the tile's member total larger): each window
//      position gets its tile row (srow) and destination (sdst, SC_DROP for
//      a dropped rank) — a hashed row from its own rank, a replicated row
//      by redoing its destinations' ballots, only those whose positions
//      meet the window. Then array by array: a row of 1, 2, 4 or 8 bytes
//      is staged in shared memory in source order (the tile read with
//      16-byte loads, coalesced) and written in destination-major order,
//      so consecutive threads write consecutive slots of one bucket; a
//      wider row (K32's list planes) goes from source to slot directly; a
//      missing validity is written as true without a read. (Staging
//      several narrow arrays together, one barrier pair for all, measured
//      slower on the card.)
// Shared memory: 32 KB of staged rows, 12 KB of window positions, 3 KB of
// counts and bases (under the 48 KB of static shared memory a block has).
constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_WARP_ROWS = TILE / SC_WARPS;  // 512 rows a warp
constexpr int SC_ROUNDS = SC_WARP_ROWS / 32;   // of 32 rows each
constexpr int SC_STAGE = TILE;                 // positions of a window
constexpr uint8_t SC_DROP = 0xFF;              // sdst of a dropped rank
int64_t scatter_enqueues = 0;  // launches exchange_scatter enqueued

// Stage rows [base, base + rows) of `src` (T-sized rows) in `stage`.
template <class T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int64_t base, int rows,
                                           uint64_t* stage) {
  const char* s = reinterpret_cast<const char*>(src + base);
  char* d = reinterpret_cast<char*>(stage);
  const int bytes = rows * (int)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    const int words = bytes >> 4;
    for (int w = threadIdx.x; w < words; w += SC_THREADS)
      reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(s)[w];
    for (int b = (words << 4) + threadIdx.x; b < bytes; b += SC_THREADS)
      d[b] = s[b];
  } else {
    T* st = reinterpret_cast<T*>(stage);
    for (int t = threadIdx.x; t < rows; t += SC_THREADS) st[t] = src[base + t];
  }
}

// Write the window's staged rows to their slots: position q of the
// window (tile position w0 + q) of destination d goes to dslot0[d] + w0 + q.
template <class T>
__device__ __forceinline__ void store_window(const uint64_t* stage,
                                             const uint16_t* srow,
                                             const uint8_t* sdst,
                                             const int64_t* dslot0, int w0,
                                             int wlen, T* __restrict__ dst) {
  const T* sv = reinterpret_cast<const T*>(stage);
  for (int q = threadIdx.x; q < wlen; q += SC_THREADS) {
    const int d = sdst[q];
    if (d != SC_DROP) dst[dslot0[d] + w0 + q] = sv[srow[q]];
  }
}

// cols: 3 words per array (source ptr or 0 for an absent validity,
// destination ptr of n * bucket rows, row bytes).
template <int W, bool REPL>
__global__ void __launch_bounds__(SC_THREADS) scatter_kernel(
    const int32_t* __restrict__ dest, const int32_t* __restrict__ n_ptr,
    int64_t cap, int n, int64_t ntiles, const int64_t* __restrict__ offsets,
    int64_t bucket, const __grid_constant__ ParamBlock<W> cols, int ncols) {
  __shared__ __align__(16) uint64_t stage[SC_STAGE];
  __shared__ uint16_t srow[SC_STAGE];
  __shared__ uint8_t sdst[SC_STAGE];
  __shared__ int wbase[SC_WARPS][MAX_N];  // a warp's count of d, then base
  __shared__ int sbase[MAX_N + 1];        // d's first tile position; total
  __shared__ int64_t rank0[MAX_N];        // the tile's first rank within d
  __shared__ int64_t dslot0[MAX_N];       // d * bucket + rank0[d] - sbase[d]
  const int64_t live = live_rows(n_ptr, cap);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  if (base >= live) return;
  const int rows = (int)(live - base < TILE ? live - base : TILE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int row0 = warp * SC_WARP_ROWS + lane;  // this thread's round-0 row
  int dv[SC_ROUNDS];    // destination words (n: no destination)
  int pos[SC_ROUNDS];   // a hashed row's rank, then its tile position
  unsigned rep[SC_ROUNDS];
  bool mine_rep = false;
#pragma unroll
  for (int r = 0; r < SC_ROUNDS; ++r) {
    const int t = row0 + 32 * r;
    pos[r] = 0;
    dv[r] = t < rows ? dest[base + t] : n;
    if (REPL) {
      rep[r] = __ballot_sync(0xffffffffu, dv[r] == -1);
      mine_rep |= dv[r] == -1;
    }
  }
  // 1. each row's rank among the warp's members of its destination
  for (int d = 0; d < n; ++d) {
    int run = 0;
#pragma unroll
    for (int r = 0; r < SC_ROUNDS; ++r) {
      unsigned m = __ballot_sync(0xffffffffu, dv[r] == d);
      if (REPL) m |= rep[r];
      if (dv[r] == d) pos[r] = run + __popc(m & below);
      run += __popc(m);
    }
    if (lane == 0) wbase[warp][d] = run;
  }
  const bool any_rep = REPL ? __syncthreads_or(mine_rep) : false;
  if (!REPL) __syncthreads();
  // 2. the scan over (destination, warp), lane l taking d = l and l + 32
  if (warp == 0) {
    int c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = lane + 32 * h;
      int acc = 0;
      if (d < n)
        for (int w = 0; w < SC_WARPS; ++w) {
          const int x = wbase[w][d];
          wbase[w][d] = acc;
          acc += x;
        }
      c[h] = acc;
    }
    int inc[2] = {c[0], c[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc[h], o);
        if (lane >= o) inc[h] += y;
      }
    const int lo_total = __shfl_sync(0xffffffffu, inc[0], 31);
    const int total = lo_total + __shfl_sync(0xffffffffu, inc[1], 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = lane + 32 * h;
      if (d < n) {
        const int sb = (h ? lo_total : 0) + inc[h] - c[h];
        const int64_t r0 =
            offsets[(int64_t)d * ntiles + blockIdx.x] -
            offsets[(int64_t)d * ntiles];
        sbase[d] = sb;
        rank0[d] = r0;
        dslot0[d] = (int64_t)d * bucket + r0 - sb;
      }
    }
    if (lane == 0) sbase[n] = total;
  }
  __syncthreads();
  const int total = sbase[n];
#pragma unroll
  for (int r = 0; r < SC_ROUNDS; ++r)
    pos[r] = dv[r] >= 0 && dv[r] < n
                 ? sbase[dv[r]] + wbase[warp][dv[r]] + pos[r] : -1;
  // 3. windows of positions
  for (int w0 = 0; w0 < total; w0 += SC_STAGE) {
    const int wlen = total - w0 < SC_STAGE ? total - w0 : SC_STAGE;
#pragma unroll
    for (int r = 0; r < SC_ROUNDS; ++r) {
      const int q = pos[r] - w0;
      if (pos[r] >= 0 && q >= 0 && q < wlen) {
        const int d = dv[r];
        srow[q] = (uint16_t)(row0 + 32 * r);
        sdst[q] = rank0[d] + (pos[r] - sbase[d]) < bucket ? (uint8_t)d
                                                           : SC_DROP;
      }
    }
    if (REPL && any_rep) {
      for (int d = 0; d < n; ++d) {
        if (sbase[d + 1] <= w0 || sbase[d] >= w0 + wlen) continue;
        int run = wbase[warp][d];
#pragma unroll
        for (int r = 0; r < SC_ROUNDS; ++r) {
          const unsigned m = __ballot_sync(0xffffffffu, dv[r] == d) | rep[r];
          if (dv[r] == -1) {
            const int p = sbase[d] + run + __popc(m & below);
            const int q = p - w0;
            if (q >= 0 && q < wlen) {
              srow[q] = (uint16_t)(row0 + 32 * r);
              sdst[q] = rank0[d] + (p - sbase[d]) < bucket ? (uint8_t)d
                                                           : SC_DROP;
            }
          }
          run += __popc(m);
        }
      }
    }
    __syncthreads();
    for (int c = 0; c < ncols; ++c) {
      const void* src = reinterpret_cast<const void*>(cols.v[3 * c]);
      void* dst = reinterpret_cast<void*>(cols.v[3 * c + 1]);
      const int64_t rb = cols.v[3 * c + 2];
      if (src == nullptr) {  // a missing validity: true
        for (int q = threadIdx.x; q < wlen; q += SC_THREADS) {
          const int d = sdst[q];
          if (d != SC_DROP)
            static_cast<uint8_t*>(dst)[dslot0[d] + w0 + q] = 1;
        }
        continue;
      }
      switch (rb) {
        case 8:
          stage_tile(static_cast<const uint64_t*>(src), base, rows, stage);
          break;
        case 4:
          stage_tile(static_cast<const uint32_t*>(src), base, rows, stage);
          break;
        case 2:
          stage_tile(static_cast<const uint16_t*>(src), base, rows, stage);
          break;
        case 1:
          stage_tile(static_cast<const uint8_t*>(src), base, rows, stage);
          break;
        default:  // a wide row (K32's list planes): source to slot
          for (int q = threadIdx.x; q < wlen; q += SC_THREADS) {
            const int d = sdst[q];
            if (d != SC_DROP)
              copy_elem(src, base + srow[q], dst, dslot0[d] + w0 + q, rb);
          }
          continue;
      }
      __syncthreads();
      switch (rb) {
        case 8:
          store_window(stage, srow, sdst, dslot0, w0, wlen,
                       static_cast<uint64_t*>(dst));
          break;
        case 4:
          store_window(stage, srow, sdst, dslot0, w0, wlen,
                       static_cast<uint32_t*>(dst));
          break;
        case 2:
          store_window(stage, srow, sdst, dslot0, w0, wlen,
                       static_cast<uint16_t*>(dst));
          break;
        default:
          store_window(stage, srow, sdst, dslot0, w0, wlen,
                       static_cast<uint8_t*>(dst));
          break;
      }
      __syncthreads();  // the stage is the next array's
    }
    __syncthreads();    // the window's positions are the next window's
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

// Local mode, one launch (HL_* below). The grid (ops: heavy_grid) depends
// on the capacity alone: min(HL_GRID_MAX, tiles of the capacity) blocks.
// Every block finds the live prefix [0, L) itself (L = the first sentinel
// word, warp 0's 32-way search: about five rounds of 32 reads that stay in
// L2) and walks the tiles b, b + grid, ... that start below L, each of
// HL_TILE words, thread t holding the HL_W words from t * HL_W:
//   * a word starts a run where it differs from its predecessor (the
//     thread's first word compares with the word before it);
//   * a run ends at the next run start: within a thread by a backward
//     pass over its words, past them at the first start of a later
//     thread (a block scan, suffix min, over the threads' first starts),
//     and past the tile at the end of the run holding the tile's last
//     word — warp 0's search, once a tile, from the 32 words after it;
//   * every position of the tile is a candidate scored (count << 32 |
//     2^32 - 1 - pos) + 1, count the run length at a run start and 0
//     elsewhere, as lax.top_k ranks zeros by position; a run belongs to
//     the tile it starts in, so a key spanning many tiles counts once;
//   * the block keeps its k best so far one per thread (thread r the r-th,
//     in a register): a tile whose best candidate beats none of them is
//     skipped, else k rounds of a block max over the held entries and the
//     tile's candidates pick the new k. No array is indexed by k.
// Each block writes its k entries to the scratch, takes a ticket after a
// barrier and thread 0's fence, and the last block merges the grid's
// descending lists with the sentinel tail (positions L, L + 1, ... with
// count 0: the lowest-positioned zero-count entries when fewer than k
// runs rank): thread j holds list j's head, k rounds of a block max, the
// owner advancing its head (partials read with __ldcg). It writes counts
// and keys (the word at the winning position) and resets the ticket. The
// scratch and ticket are shared by the device's calls, which the executor
// issues from one host thread on one stream (the mesh's shards over one
// card call it one after another), so calls never overlap.
constexpr int HL_THREADS = 512;
constexpr int HL_W = 8;
constexpr int64_t HL_TILE = (int64_t)HL_THREADS * HL_W;  // 4,096 words
constexpr int HL_WARPS = HL_THREADS / 32;
constexpr int HL_GRID_MAX = 256;  // < HL_THREADS: one list head a thread
constexpr uint32_t NO_START = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// The block's max of v, in every thread. red: 2 x HL_WARPS shared words;
// calls alternate halves (`par`), so one barrier a call is enough.
__device__ __forceinline__ uint64_t block_max(uint64_t v,
                                              uint64_t (*red)[HL_WARPS],
                                              int& par) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max64(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[par][threadIdx.x >> 5] = v;
  __syncthreads();
  uint64_t m = red[par][0];
#pragma unroll
  for (int w = 1; w < HL_WARPS; ++w) m = max64(m, red[par][w]);
  par ^= 1;
  return m;
}

// The first position p in [lo, hi) with s[p] > v, or hi (s ascending).
// Called by a whole warp; each round probes 32 positions at once and
// narrows the range 32-fold.
__device__ int64_t warp_first_above(const uint64_t* __restrict__ s,
                                    int64_t lo, int64_t hi, uint64_t v) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t n = hi - lo;
    const int64_t step = (n + 31) / 32;
    const int64_t q = lo + lane * step;
    const unsigned m = __ballot_sync(0xffffffffu, q < hi && s[q] > v);
    if (m == 0) {
      lo += (n - 1) / step * step + 1;  // past the last probe
      continue;
    }
    const int f = __ffs(m) - 1;
    if (f == 0) return lo;
    hi = lo + f * step;
    lo += (int64_t)(f - 1) * step + 1;
  }
  return hi;
}

// The end of the run of v that reaches position `from` - 1: the 32 words
// from `from` first (most runs are short), then a search up to L.
__device__ __forceinline__ int64_t warp_run_end(const uint64_t* __restrict__ s,
                                                int64_t from, int64_t L,
                                                uint64_t v) {
  const int lane = threadIdx.x & 31;
  const int64_t q = from + lane;
  const unsigned m = __ballot_sync(0xffffffffu, q < L && s[q] > v);
  if (m) return from + __ffs(m) - 1;
  return from + 32 >= L ? L : warp_first_above(s, from + 32, L, v);
}

// The first run start of the threads after this one (tile offsets;
// NO_START when there is none): a suffix min over the block.
__device__ __forceinline__ uint32_t next_start_after(uint32_t first,
                                                     uint32_t* wmin) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t v = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t w = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v = w < v ? w : v;
  }
  uint32_t ex = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) ex = NO_START;
  if (lane == 0) wmin[warp] = v;
  __syncthreads();
  for (int w = warp + 1; w < HL_WARPS; ++w) ex = wmin[w] < ex ? wmin[w] : ex;
  return ex;
}

// sorted: u64[cap] ascending, the sentinel last; partial: u64[grid * k];
// ticket: 0 between calls; out: int64[2k], counts then keys.
__global__ void __launch_bounds__(HL_THREADS, 2) heavy_local_kernel(
    const uint64_t* __restrict__ s, int64_t cap, int k,
    unsigned long long* __restrict__ partial, unsigned* __restrict__ ticket,
    int64_t* __restrict__ out) {
  __shared__ uint64_t red[2][HL_WARPS];
  __shared__ uint32_t wmin[HL_WARPS];
  __shared__ int64_t lim[2];  // L; the end of the run past the tile
  __shared__ bool last;
  const int tid = (int)threadIdx.x;
  int par = 0;
  if (tid < 32) lim[0] = warp_first_above(s, 0, cap, SENT - 1);
  __syncthreads();
  const int64_t L = lim[0];
  uint64_t mine = 0;  // the block's (threadIdx.x)-th best so far
  uint64_t kth = 0;   // its k-th best, 0 while it holds fewer than k
  for (int64_t t0 = blockIdx.x * HL_TILE; t0 < L;
       t0 += (int64_t)gridDim.x * HL_TILE) {
    const int64_t t1 = t0 + HL_TILE < L ? t0 + HL_TILE : L;
    const int64_t p0 = t0 + (int64_t)tid * HL_W;
    uint64_t w[HL_W];
#pragma unroll
    for (int j = 0; j < HL_W; ++j) w[j] = p0 + j < t1 ? s[p0 + j] : 0;
    const uint64_t before = p0 > 0 && p0 < t1 ? s[p0 - 1] : 0;
    unsigned flags = 0;
#pragma unroll
    for (int j = 0; j < HL_W; ++j) {
      const uint64_t prev = j ? w[j - 1] : before;
      if (p0 + j < t1 && (p0 + j == 0 || w[j] != prev)) flags |= 1u << j;
    }
    // warp 0: the end of the run holding the tile's last word, read
    // after next_start_after's barrier
    if (tid < 32)
      lim[1] = t1 == L ? L : warp_run_end(s, t1, L, s[t1 - 1]);
    const uint32_t first =
        flags ? (uint32_t)(p0 - t0) + (uint32_t)(__ffs(flags) - 1)
              : NO_START;
    const uint32_t after = next_start_after(first, wmin);
    int64_t end = after != NO_START ? t0 + after : lim[1];
    uint64_t sc[HL_W];
    uint64_t cur = 0;
#pragma unroll
    for (int j = HL_W - 1; j >= 0; --j) {
      const int64_t pos = p0 + j;
      uint64_t count = 0;
      if ((flags >> j) & 1u) {
        count = (uint64_t)(end - pos);
        end = pos;
      }
      sc[j] = pos < t1 ? score_of(count, (uint64_t)pos) + 1 : 0;
      cur = max64(cur, sc[j]);
    }
    if (!__syncthreads_or(cur > kth)) continue;  // the tile beats no held
    cur = max64(cur, mine);
    uint64_t next = 0, m = 0;
    int r = 0;
    for (; r < k; ++r) {
      m = block_max(cur, red, par);
      if (m == 0) break;
      if (tid == r) next = m;
      if (cur == m) {  // this thread held it: drop it, find its next best
        mine = mine == m ? 0 : mine;
        cur = mine;
#pragma unroll
        for (int j = 0; j < HL_W; ++j) {
          sc[j] = sc[j] == m ? 0 : sc[j];
          cur = max64(cur, sc[j]);
        }
      }
    }
    mine = next;
    kth = r == k ? m : 0;
  }
  if (tid < k) partial[(int64_t)blockIdx.x * k + tid] = mine;
  // the block's entries are visible before the ticket counts it: the
  // barrier orders them before thread 0's fence
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int G = (int)gridDim.x;
  // list i's entry i of this thread's list: block tid's partials, or for
  // thread G the sentinel tail (count 0 at positions L, L + 1, ...)
  auto entry = [&](int i) -> uint64_t {
    if (i >= k) return 0;
    if (tid < G) return __ldcg(partial + (int64_t)tid * k + i);
    return tid == G && L + i < cap ? score_of(0, (uint64_t)(L + i)) + 1 : 0;
  };
  int h = 0;
  uint64_t v = entry(0), nx = entry(1);  // the head, and the next in flight
  uint64_t got = 0;
  for (int r = 0; r < k; ++r) {
    const uint64_t m = block_max(v, red, par);
    if (m == 0) break;
    if (tid == r) got = m;
    if (v == m) {
      v = nx;
      nx = entry(++h + 1);
    }
  }
  if (tid < k) {  // got == 0: fewer than k positions, a sentinel, count 0
    const uint64_t word = got - 1;
    const int64_t pos = (int64_t)(0xFFFFFFFFULL - (word & 0xFFFFFFFFULL));
    out[tid] = got ? (int64_t)(word >> 32) : 0;
    out[k + tid] = got ? (int64_t)s[pos] : -1;
  }
  if (tid == 0) *ticket = 0;
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

namespace {
template <int W, bool REPL>
int scatter_launch(const void* dest, int64_t cap, int64_t n, const void* hist,
                   const void* num_rows, int64_t bucket, const void* cols,
                   int64_t ncols, cudaStream_t s) {
  thread_local static ParamBlock<W> t;  // each launch copies it
  load_block(cols, 3 * ncols, &t);
  const int64_t ntiles = tile_blocks(cap);
  scatter_kernel<W, REPL><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(
      static_cast<const int32_t*>(dest),
      static_cast<const int32_t*>(num_rows), cap, (int)n, ntiles,
      static_cast<const int64_t*>(hist), bucket, t, (int)ncols);
  ++scatter_enqueues;
  return (int)cudaGetLastError();
}

template <int W>
int scatter_mode(int64_t mode, const void* dest, int64_t cap, int64_t n,
                 const void* hist, const void* num_rows, int64_t bucket,
                 const void* cols, int64_t ncols, cudaStream_t s) {
  return mode == MODE_REPLICATE
             ? scatter_launch<W, true>(dest, cap, n, hist, num_rows, bucket,
                                       cols, ncols, s)
             : scatter_launch<W, false>(dest, cap, n, hist, num_rows, bucket,
                                        cols, ncols, s);
}
}  // namespace

// dest, hist: exchange_count's outputs for this page, num_rows its
// device-side row count and mode its mode (the same as the count pass
// had); cols: int64 HOST array, 3 words per moved array (source ptr or 0
// for a validity to write as true, destination ptr of n * bucket rows,
// row bytes), in a parameter block of 8, 64 or TABLE_MAX words. One
// launch (scatter_kernel). Returns cudaGetLastError(), or -1 on a bad
// table or argument.
TT_EXPORT int exchange_scatter(const void* dest, int64_t cap, int64_t n,
                               const void* hist, const void* num_rows,
                               int64_t mode, int64_t bucket, const void* cols,
                               int64_t ncols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAX_N || bucket < 1 || ncols < 0 || cap < 0) return -1;
  switch (param_block_words(3 * ncols)) {
    case 8:
      return scatter_mode<8>(mode, dest, cap, n, hist, num_rows, bucket,
                             cols, ncols, s);
    case 64:
      return scatter_mode<64>(mode, dest, cap, n, hist, num_rows, bucket,
                              cols, ncols, s);
    case TABLE_MAX:
      return scatter_mode<TABLE_MAX>(mode, dest, cap, n, hist, num_rows,
                                     bucket, cols, ncols, s);
    default:
      return -1;
  }
}

// The launches exchange_scatter has enqueued in this process
// (chip_smoke.py counts them per call).
TT_EXPORT int64_t exchange_scatter_enqueues() { return scatter_enqueues; }

// sorted: u64[cap] ascending (NULL and dead rows the sentinel, last);
// scratch: u64[HL_GRID_MAX * 64] partials, then the ticket (uint32, 0,
// left 0); out: int64[2k], counts then keys; grid in [1, HL_GRID_MAX]
// (ops: heavy_grid(cap)). k in [1, 64], cap < 2^32. One launch.
TT_EXPORT int heavy_local(const void* sorted, int64_t cap, int64_t k,
                          void* scratch, void* out, int64_t grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > MAX_HEAVY || cap < 0 || cap >= (1LL << 32) || grid < 1 ||
      grid > HL_GRID_MAX)
    return -1;
  auto* part = static_cast<unsigned long long*>(scratch);
  heavy_local_kernel<<<(unsigned)grid, HL_THREADS, 0, s>>>(
      static_cast<const uint64_t*>(sorted), cap, (int)k, part,
      reinterpret_cast<unsigned*>(part + (int64_t)HL_GRID_MAX * MAX_HEAVY),
      static_cast<int64_t*>(out));
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
