// K6: the probe of an INNER equi-join against a UNIQUE build side.
//
// Replaces trino_tpu/ops/join.py unique_inner_probe (with _key_u64/_mix64
// and, on the dense route, _dense_lo): per probe row, its 64-bit key, dead
// or NULL rows excluded, one lookup in the structure K5 built, the `found`
// mask, `brow` = the matching build ROW (0 where not found), and the number
// of matches. The reference's `search` route is a searchsorted over the
// sorted build keys (log n passes of the sort engine) plus a gather through
// the sort permutation, its `mxu` route a blocked one-hot matmul against
// the per-key (count, first) table; here every route is one kernel:
//   dense  — one 4-byte read of the direct-address table at key - kmin;
//   mxu    — K13 (csrc/common.cuh mxu_find): one 8-byte read of K12's
//            (count, first) table at key - kmin, the table (at most 32 KB
//            at the default mxu_join_max_slots) staged once per block in
//            shared memory; `first` is the build row of the unique build;
//   search — linear probing of K5's open-addressing hash table from
//            mix64(key): a slot is a hit when its stored key equals the
//            probe key, and the first empty slot ends the probe (the table
//            is at most half full).
// Composite keys are mixed into one 64-bit key, so two distinct key tuples
// can meet on one slot: a hit on a composite key is always verified
// column by column against the build row, as the reference's
// verify_composite (on by default) does.
//
// Bound on this card: bytes — the live probe rows' key columns read once,
// found (1 byte) and brow (8 bytes) written once a live row, and the
// build's live keys and rows (12 bytes each) read once. The kernel also
// writes the padding rows up to capacity, and each lookup is a random 4- or
// 16-byte access (from L2 while the table fits its 50 MB, otherwise a DRAM
// sector per row).
//
// At the main path's calls (the mxu route: 150,000 live rows against a
// 128-slot table) the device work is a few microseconds, so the call is
// its host enqueue. Hence one launch and nothing else: no memset of the
// count, a parameter block sized to the key columns (8, 64 or TABLE_MAX
// words), a grid sized to the card by the wrapper (ops/join.py
// probe_grid: a few blocks per SM, fewer where each block stages a large
// mxu table). A block walks tiles of THREADS x R rows, thread t taking
// rows t, t + THREADS, ... of a tile, so every load and store of a warp is
// coalesced, and a thread's R rows go through each phase together (their
// key reads, then their table reads) so their loads overlap: R =
// LOOKUP_ROWS on the dense and mxu routes, SEARCH_ROWS (one) on the search
// route, where each row's probe loop leaves nothing to overlap and more
// rows a thread only cost registers. The match count: each block adds its
// count and one ticket to a per-device word in ONE atomic (the ticket in
// the high bits); the block whose ticket is the last reads the grid's
// total in what the atomic returned, writes it to the call's own count
// word and zeroes the per-device word, so calls ordered on one stream
// share that word and each count lands in its own output.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int LOOKUP_ROWS = 2;  // R of the dense and mxu routes
constexpr int SEARCH_ROWS = 1;  // R of the search route
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
constexpr int STAT_KMIN = 4;   // csrc/join_build.cu enum Stat
// the per-device word: tickets taken << TICKET_SHIFT | matches so far
constexpr int TICKET_SHIFT = 40;
constexpr unsigned long long MATCH_MASK = (1ULL << TICKET_SHIFT) - 1;
int64_t probe_enqueues = 0;  // stream operations join_probe enqueued

// The join keys of rows base, base + THREADS, ... (null from row `end`:
// the dead rows past num_rows are not read).
template <int R>
__device__ __forceinline__ void load_keys(const int64_t* pcols, int nkeys,
                                          int64_t base, int64_t end,
                                          uint64_t* key, bool* null) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = base + r * THREADS;
    null[r] = true;
    key[r] = i < end ? join_key(pcols, nkeys, i, &null[r]) : 0;
  }
}

// ticket: the per-device word, 0 between calls; count: this call's own
// word.
template <int W, int R>
__global__ void __launch_bounds__(THREADS)
    probe_kernel(const __grid_constant__ ParamBlock<W> tbl, int nkeys,
                 int64_t cap, const int32_t* __restrict__ num_rows,
                 int route, const int32_t* __restrict__ dense, int64_t size,
                 const int64_t* __restrict__ stats,
                 const int64_t* __restrict__ slot_keys,
                 const int32_t* __restrict__ slot_rows, int64_t slots,
                 uint8_t* __restrict__ found, int64_t* __restrict__ brow,
                 unsigned long long* __restrict__ ticket,
                 unsigned long long* __restrict__ count) {
  __shared__ unsigned long long warp_hits[THREADS / 32];
  extern __shared__ int32_t smem[];
  const int64_t* pcols = tbl.v;
  const int64_t* bcols = tbl.v + KEY_FIELDS * nkeys;
  const int64_t step = (int64_t)gridDim.x * THREADS * R;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t kmin = (uint64_t)stats[STAT_KMIN];
  const int32_t* mxu =
      route == ROUTE_MXU ? mxu_stage(dense, size, smem) : nullptr;
  unsigned long long hits = 0;
  for (int64_t base = (int64_t)blockIdx.x * THREADS * R + threadIdx.x;
       base < cap; base += step) {
    uint64_t key[R];
    bool null[R];
    load_keys<R>(pcols, nkeys, base, n, key, null);
    bool live[R];
    int64_t row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      live[r] = !null[r];
      row[r] = -1;
    }
    if (route == ROUTE_SEARCH) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const int64_t hs = hash_find(key[r], slot_keys, slot_rows, slots);
        if (hs >= 0) row[r] = slot_rows[hs];
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        if (route == ROUTE_DENSE) {
          const int32_t b = dense_find(key[r], kmin, dense, size);
          if (b != 0x7fffffff) row[r] = b;
        } else {
          int32_t first_row = 0;
          if (mxu_find(key[r], kmin, mxu, size, &first_row))
            row[r] = first_row;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = base + r * THREADS;
      if (row[r] >= 0 && nkeys > 1 &&
          !same_keys(pcols, bcols, nkeys, i, row[r]))
        row[r] = -1;
      hits += row[r] >= 0 ? 1ULL : 0ULL;
      if (i < cap) {
        found[i] = row[r] >= 0 ? 1 : 0;
        brow[i] = row[r] >= 0 ? row[r] : 0;
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

template <int W, int R>
int launch_rows(const ParamBlock<W>& t, int64_t nkeys, int64_t cap,
                const void* num_rows, int64_t route, const void* dense,
                int64_t size, const void* stats, const void* slot_keys,
                const void* slot_rows, int64_t slots, void* found,
                void* brow, void* count, void* ticket, int64_t grid,
                cudaStream_t s) {
  probe_kernel<W, R><<<(unsigned)grid, THREADS,
                       mxu_smem_bytes((int)route, size), s>>>(
      t, (int)nkeys, cap, static_cast<const int32_t*>(num_rows), (int)route,
      static_cast<const int32_t*>(dense), size,
      static_cast<const int64_t*>(stats),
      static_cast<const int64_t*>(slot_keys),
      static_cast<const int32_t*>(slot_rows), slots,
      static_cast<uint8_t*>(found), static_cast<int64_t*>(brow),
      static_cast<unsigned long long*>(ticket),
      static_cast<unsigned long long*>(count));
  ++probe_enqueues;
  return (int)cudaGetLastError();
}

template <int W>
int launch(const void* table, int64_t nkeys, int64_t cap,
           const void* num_rows, int64_t route, const void* dense,
           int64_t size, const void* stats, const void* slot_keys,
           const void* slot_rows, int64_t slots, void* found, void* brow,
           void* count, void* ticket, int64_t grid, cudaStream_t s) {
  thread_local static ParamBlock<W> t;  // each launch copies it
  load_block(table, 2 * KEY_FIELDS * nkeys, &t);
  if (route == ROUTE_SEARCH)
    return launch_rows<W, SEARCH_ROWS>(t, nkeys, cap, num_rows, route, dense,
                                       size, stats, slot_keys, slot_rows,
                                       slots, found, brow, count, ticket,
                                       grid, s);
  return launch_rows<W, LOOKUP_ROWS>(t, nkeys, cap, num_rows, route, dense,
                                     size, stats, slot_keys, slot_rows,
                                     slots, found, brow, count, ticket,
                                     grid, s);
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per probe key column, then as
// many per build key column (values ptr, valid ptr or 0, element size,
// is_float); route (enum Route) ROUTE_DENSE: `dense` int32[size] (K5
// join_dense); ROUTE_MXU: `dense` is K12's int32[size][2] (count, first)
// table (csrc/join_mxu.cu); ROUTE_SEARCH: the hash table slot_keys
// int64[slots] / slot_rows int32[slots] (K5 join_build); stats: K5's
// int64[10]; found: uint8[cap]; brow: int64[cap] (both written up to cap);
// count: int64, written (no zeroing needed); ticket: the per-device
// uint64, 0 between calls (left 0); grid >= 1 blocks. Returns
// cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int join_probe(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, int64_t route,
                         const void* dense, int64_t size, const void* stats,
                         const void* slot_keys, const void* slot_rows,
                         int64_t slots, void* found, void* brow, void* count,
                         void* ticket, int64_t grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkeys < 1 || grid < 1) return -1;
  switch (param_block_words(2 * KEY_FIELDS * nkeys)) {
    case 8:
      return launch<8>(table, nkeys, cap, num_rows, route, dense, size,
                       stats, slot_keys, slot_rows, slots, found, brow, count,
                       ticket, grid, s);
    case 64:
      return launch<64>(table, nkeys, cap, num_rows, route, dense, size,
                        stats, slot_keys, slot_rows, slots, found, brow,
                        count, ticket, grid, s);
    case TABLE_MAX:
      return launch<TABLE_MAX>(table, nkeys, cap, num_rows, route, dense,
                               size, stats, slot_keys, slot_rows, slots,
                               found, brow, count, ticket, grid, s);
    default:
      return -1;
  }
}

// The stream operations (kernels and memsets) join_probe has enqueued in
// this process (chip_smoke.py counts them per call).
TT_EXPORT int64_t join_probe_enqueues() { return probe_enqueues; }
