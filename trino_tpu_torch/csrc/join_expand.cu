// K9: the expanding probe of an equi-join, every kind.
//
// Replaces trino_tpu/ops/join.py hash_join (INNER with duplicate build
// keys, LEFT, FULL with its build_matched mask, SEMI, ANTI and MARK, null-
// aware or EXISTS semantics), _mark_page, and the probe half of
// unmatched_build_page (the FULL join's matched mask). The reference probes
// the sorted build keys with searchsorted, turns per-row match counts into
// output slots with a cumsum, maps each of `output_capacity` slots back to
// its probe row with a second searchsorted over the offsets, gathers every
// candidate, and then filters composite-key hash collisions out of the
// output (rescuing LEFT/FULL rows whose every candidate collided). The
// capacity is a guess: a page whose total overflows it runs again.
//
// Here the count is exact and comes first, so nothing is guessed or re-run:
//   launch A (expand_count) — per live probe row its key (csrc/common.cuh
//     join_key), one lookup shared with K6 (dense_find on the `dense`
//     route, whose table holds the key's slot; hash_find on `search`),
//     which names the key's run in K5's runs mode (start, count). For a
//     composite key the run is walked and only candidates equal column by
//     column are counted, so collisions never reach the output. emit =
//     that count, or max(count, 1) for a live LEFT/FULL row (a NULL key or
//     no match: one null-extended row). The per-tile sums of emit are
//     scanned to tile offsets and an int64 total on the device
//     (csrc/tile.cuh tile_scan_kernel); the executor reads the totals of a
//     whole batch of pages in one host read.
//   launch B (expand_write) — per tile, a block scan of emit gives each
//     probe row its first output slot; the row writes (probe row, build
//     row) for each verified candidate of its run (in the run's ascending
//     build-row order, so the output order is the reference's), or (probe
//     row, -1) for a null-extended row, and for FULL sets
//     build_matched[build row] = 1, a plain byte store. The columns then
//     move in two K7 gathers (csrc/gather.cu).
//   verdict (SEMI, ANTI, MARK) — no expansion: one launch writes per probe
//     row the reference's answer from "some verified candidate exists",
//     the probe key's NULL flag and K5's live-row and NULL-key statistics:
//     SEMI keeps matched rows; ANTI keeps unmatched rows (null-aware: only
//     against a NULL-free build, and a NULL probe key only against an empty
//     build; EXISTS: every unmatched live row); MARK writes the 3-valued
//     IN (TRUE on a match; NULL for a NULL key against a non-empty build or
//     no match against a build holding a NULL key; FALSE otherwise).
//
// Bound on this card: bytes — the live probe keys read once, one lookup
// entry per live probe row, the verified candidates' key columns for a
// composite key, and 16 bytes of (probe row, build row) per output row
// written once (SEMI/ANTI/MARK: 1 byte of verdict a row instead). One
// thread walks one probe row's run, so a skewed build key serialises the
// rows that hit it; the executor records max_run per join.
#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
// csrc/join_build.cu enum Stat
constexpr int STAT_N_ROWS = 1, STAT_HAS_NULL = 2, STAT_KMIN = 4;
// trino_tpu_torch/ops/join.py JOIN_KIND_CODE
enum Kind { INNER = 0, LEFT = 1, FULL = 2, SEMI = 3, ANTI = 4, MARK = 5 };

// Where a probe key's candidates lie: K5's lookup (dense table of slots or
// the hash table) and its runs.
struct Runs {
  int dense_route;
  const int32_t* dense;
  int64_t size;
  const int64_t* stats;
  const int64_t* slot_keys;
  const int32_t* slot_rows;
  int64_t slots;
  const int32_t* slot_start;
  const int32_t* slot_counts;
  const int32_t* runs;

  // The run of `key`: its length (0 when absent), *start its first place.
  __device__ __forceinline__ int32_t find(uint64_t key, int32_t* start) const {
    int64_t s;
    if (dense_route) {
      const int32_t d = dense_find(key, (uint64_t)stats[STAT_KMIN], dense,
                                   size);
      if (d == 0x7fffffff) return 0;
      s = d;
    } else {
      s = hash_find(key, slot_keys, slot_rows, slots);
      if (s < 0) return 0;
    }
    *start = slot_start[s];
    return slot_counts[s];
  }
};

__device__ __forceinline__ int64_t live_rows(const int32_t* num_rows,
                                             int64_t cap) {
  const int64_t n = *num_rows;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// Launch A, one block per tile of TILE probe rows: each row's run (start,
// length), its emit count, and the tile's sum of emit.
__global__ void expand_count_kernel(const __grid_constant__ Table tbl,
                                    int64_t nkeys, int64_t cap,
                                    const int32_t* __restrict__ num_rows,
                                    int kind, const Runs R,
                                    int32_t* __restrict__ cand_start,
                                    int32_t* __restrict__ cand_len,
                                    int32_t* __restrict__ emit,
                                    int64_t* __restrict__ tile_sums) {
  __shared__ long long warp_sums[32];
  const int64_t* pcols = tbl.v;
  const int64_t* bcols = tbl.v + KEY_FIELDS * nkeys;
  const int64_t n = live_rows(num_rows, cap);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  long long sum = 0;
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    const int64_t i = base + r;
    if (i >= cap) break;
    int32_t start = 0, len = 0, e = 0;
    if (i < n) {
      bool null;
      const uint64_t key = join_key(pcols, nkeys, i, &null);
      if (!null) {
        len = R.find(key, &start);
        e = len;
        if (nkeys > 1) {
          e = 0;
          for (int32_t q = 0; q < len; ++q)
            e += same_keys(pcols, bcols, nkeys, i, R.runs[start + q]) ? 1 : 0;
        }
      }
      if (kind != INNER && e == 0) e = 1;  // LEFT/FULL: null-extended row
    }
    cand_start[i] = start;
    cand_len[i] = len;
    emit[i] = e;
    sum += e;
  }
  long long total;
  block_exclusive_scan(sum, warp_sums, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Launch B, one block per tile: each probe row's output slots.
__global__ void expand_write_kernel(const __grid_constant__ Table tbl,
                                    int64_t nkeys, int64_t cap, int kind,
                                    const int32_t* __restrict__ runs,
                                    const int32_t* __restrict__ cand_start,
                                    const int32_t* __restrict__ cand_len,
                                    const int32_t* __restrict__ emit,
                                    const int64_t* __restrict__ offsets,
                                    int64_t out_cap,
                                    int64_t* __restrict__ prow,
                                    int64_t* __restrict__ brow,
                                    uint8_t* __restrict__ build_matched) {
  __shared__ long long warp_sums[32];
  const int64_t* pcols = tbl.v;
  const int64_t* bcols = tbl.v + KEY_FIELDS * nkeys;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  long long out = offsets[blockIdx.x];
  for (int r = 0; r < TILE; r += blockDim.x) {
    const int64_t i = base + r + threadIdx.x;
    const long long e = i < cap ? (long long)emit[i] : 0LL;
    long long total;
    const long long first = out + block_exclusive_scan(e, warp_sums, &total);
    out += total;
    if (e == 0) continue;
    const int32_t start = cand_start[i], len = cand_len[i];
    long long o = first;
    for (int32_t q = 0; q < len; ++q) {
      const int32_t b = runs[start + q];
      if (nkeys > 1 && !same_keys(pcols, bcols, nkeys, i, b)) continue;
      if (o < out_cap) {
        prow[o] = i;
        brow[o] = b;
      }
      if (kind == FULL) build_matched[b] = 1;
      ++o;
    }
    if (o == first && first < out_cap) {  // LEFT/FULL: no verified match
      prow[first] = i;
      brow[first] = -1;
    }
  }
}

// SEMI/ANTI/MARK: flag (SEMI/ANTI keep, MARK value) and, for MARK, flag2
// (the value's validity) per probe row of the capacity.
__global__ void verdict_kernel(const __grid_constant__ Table tbl,
                               int64_t nkeys, int64_t cap,
                               const int32_t* __restrict__ num_rows,
                               int kind, int null_aware, const Runs R,
                               uint8_t* __restrict__ flag,
                               uint8_t* __restrict__ flag2) {
  const int64_t* pcols = tbl.v;
  const int64_t* bcols = tbl.v + KEY_FIELDS * nkeys;
  const int64_t n = live_rows(num_rows, cap);
  const bool empty_build = R.stats[STAT_N_ROWS] == 0;
  const bool build_null = R.stats[STAT_HAS_NULL] != 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool live = i < n;
    bool null;
    const uint64_t key = join_key(pcols, nkeys, i, &null);
    bool matched = false;
    if (live && !null) {
      int32_t start = 0;
      const int32_t len = R.find(key, &start);
      matched = len > 0;
      if (nkeys > 1) {
        matched = false;
        for (int32_t q = 0; q < len && !matched; ++q)
          matched = same_keys(pcols, bcols, nkeys, i, R.runs[start + q]);
      }
    }
    bool f;
    if (kind == SEMI) {
      f = matched;
    } else if (kind == ANTI) {
      f = null_aware ? live && (null ? empty_build : !matched && !build_null)
                     : live && !matched;
    } else {
      f = matched;
      flag2[i] = (matched || (null ? empty_build : !build_null)) ? 1 : 0;
    }
    flag[i] = f ? 1 : 0;
  }
}

Runs make_runs(int64_t dense_route, const void* dense, int64_t size,
               const void* stats, const void* slot_keys,
               const void* slot_rows, int64_t slots, const void* slot_start,
               const void* slot_counts, const void* runs) {
  return Runs{(int)dense_route,
              static_cast<const int32_t*>(dense),
              size,
              static_cast<const int64_t*>(stats),
              static_cast<const int64_t*>(slot_keys),
              static_cast<const int32_t*>(slot_rows),
              slots,
              static_cast<const int32_t*>(slot_start),
              static_cast<const int32_t*>(slot_counts),
              static_cast<const int32_t*>(runs)};
}
}  // namespace

// Shared arguments: table: int64 HOST array, KEY_FIELDS words per probe key
// column, then as many per build key column (values ptr, valid ptr or 0,
// element size, is_float); num_rows: the probe's int32 live-row scalar;
// dense_route 1: dense int32[size] maps key kmin + d to its slot (K5
// join_runs), else slot_keys int64[slots] / slot_rows int32[slots] (K5
// join_build) are searched; stats: K5's int64[10]; slot_start,
// slot_counts: int32[slots]; runs: int32 build rows (K5 join_runs).
//
// Launch A: cand_start, cand_len, emit: int32[cap]; tile_offsets:
// int64[ceil(cap / 4096)] (left as each tile's first output slot, for
// launch B); total: int64 scalar. Returns cudaGetLastError(), or -1 when
// the table exceeds TABLE_MAX.
TT_EXPORT int expand_count(const void* table, int64_t nkeys, int64_t cap,
                           const void* num_rows, int64_t kind,
                           int64_t dense_route, const void* dense,
                           int64_t size, const void* stats,
                           const void* slot_keys, const void* slot_rows,
                           int64_t slots, const void* slot_start,
                           const void* slot_counts, const void* runs,
                           void* cand_start, void* cand_len, void* emit,
                           void* tile_offsets, void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nkeys < 1 || load_table(table, 2 * KEY_FIELDS * nkeys, &t)) return -1;
  const Runs R = make_runs(dense_route, dense, size, stats, slot_keys,
                           slot_rows, slots, slot_start, slot_counts, runs);
  const int64_t nblocks = tile_blocks(cap);
  auto* offsets = static_cast<int64_t*>(tile_offsets);
  if (cap > 0) {
    expand_count_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const int32_t*>(num_rows), (int)kind, R,
        static_cast<int32_t*>(cand_start), static_cast<int32_t*>(cand_len),
        static_cast<int32_t*>(emit), offsets);
  } else {
    cudaMemsetAsync(offsets, 0, sizeof(int64_t), s);
  }
  tile_scan_kernel<<<1, 1024, 0, s>>>(offsets, nblocks,
                                      static_cast<int64_t*>(total));
  return (int)cudaGetLastError();
}

// Launch B over launch A's arrays: prow, brow: int64[out_cap] (brow -1 on a
// null-extended row); build_matched: uint8 per build row, or null unless
// kind is FULL (only ever set to 1 here, so one mask serves every probe
// page of a join).
TT_EXPORT int expand_write(const void* table, int64_t nkeys, int64_t cap,
                           int64_t kind, const void* runs,
                           const void* cand_start, const void* cand_len,
                           const void* emit, const void* tile_offsets,
                           int64_t out_cap, void* prow, void* brow,
                           void* build_matched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, 2 * KEY_FIELDS * nkeys, &t)) return -1;
  if (cap > 0 && out_cap > 0) {
    expand_write_kernel<<<(unsigned)tile_blocks(cap), TILE_THREADS, 0, s>>>(
        t, nkeys, cap, (int)kind, static_cast<const int32_t*>(runs),
        static_cast<const int32_t*>(cand_start),
        static_cast<const int32_t*>(cand_len),
        static_cast<const int32_t*>(emit),
        static_cast<const int64_t*>(tile_offsets), out_cap,
        static_cast<int64_t*>(prow), static_cast<int64_t*>(brow),
        static_cast<uint8_t*>(build_matched));
  }
  return (int)cudaGetLastError();
}

// SEMI/ANTI/MARK: flag: uint8[cap]; flag2: uint8[cap] (MARK only, else
// null). Lookup arguments as expand_count.
TT_EXPORT int probe_verdict(const void* table, int64_t nkeys, int64_t cap,
                            const void* num_rows, int64_t kind,
                            int64_t null_aware, int64_t dense_route,
                            const void* dense, int64_t size,
                            const void* stats, const void* slot_keys,
                            const void* slot_rows, int64_t slots,
                            const void* slot_start, const void* slot_counts,
                            const void* runs, void* flag, void* flag2,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, 2 * KEY_FIELDS * nkeys, &t)) return -1;
  const Runs R = make_runs(dense_route, dense, size, stats, slot_keys,
                           slot_rows, slots, slot_start, slot_counts, runs);
  if (cap > 0) {
    int64_t blocks = (cap + THREADS - 1) / THREADS;
    blocks = blocks > 4224 ? 4224 : blocks;
    verdict_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const int32_t*>(num_rows), (int)kind,
        (int)null_aware, R, static_cast<uint8_t*>(flag),
        static_cast<uint8_t*>(flag2));
  }
  return (int)cudaGetLastError();
}
