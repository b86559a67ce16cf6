// K5: the build side of an equi-join.
//
// Replaces trino_tpu/ops/join.py prepare_build (+ _key_u64/_mix64),
// build_dense_table/_dense_scatter and build_key_bounds. The reference
// sorts the build keys (a multi-operand lax.sort, the TPU's data-movement
// engine), derives run lengths with cummax/cummin scans, and probes the
// sorted array with searchsorted or, for a dense key span, a direct-address
// table of sorted positions. A sort moves every key log n times; here the
// build is one pass that needs no order:
//
//   build_kernel — per live build row: its 64-bit key (one column sign-
//     extended, or the splitmix mix of several, -0.0 made +0.0 — the
//     reference's _key_u64 bit for bit), then the statistics the executor
//     reads once per join (live non-NULL rows, live rows, any NULL key, the
//     key min/max compared as UNSIGNED 64-bit as the reference's uint64
//     keys are, and build_key_bounds' min/max of the first key column in
//     its own type, and the distinct live keys: the router's density
//     numerator, the reference's join_mxu.distinct_live_keys, counted as
//     the rows that claim a new slot), and an insert into an
//     open-addressing hash table:
//     power-of-two slots >= 2 x capacity, linear probing, a slot claimed by
//     atomicCAS on its row (the key of a claimed slot is checked against
//     the claiming row's key, recomputed from the immutable columns, so no
//     thread ever reads a half-written slot), and a per-slot count whose
//     running maximum is max_run (1 = unique build, the reference's
//     max_run_live). This table is the `search` lookup (ROADMAP B4's
//     Hopper form).
//   dense_kernel — for a key span the router accepts (`dense`): a direct-
//     address table [next_pow2(span)] holding the build ROW of key
//     kmin + s, INT32_MAX where no key is present (the reference stores
//     the first sorted position; for the unique build both name the same
//     row). With a payload it stores the payload instead: the spilled
//     join's build row of each sorted key (K16's permutation).
//
// Bound on this card: bytes — the live rows' key columns read once and a
// lookup written once: for the hash table, the live keys and rows it must
// hold (12 bytes a row; this design initialises and writes 2x slots of 16
// bytes, about 2.7x that), for the dense one its table (4 bytes a slot).
// The inserts are random 4-to-16-byte accesses, so a table past the 50 MB
// L2 pays a DRAM sector per row.
//
// Runs mode (join_runs) replaces the part of prepare_build the expanding
// probe (K9, csrc/join_expand.cu) reads: the sort permutation `bperm`
// with `run_len`, every key's build rows laid out together. The slot
// counts are already there, so a count -> exclusive scan -> scatter pass
// over the slots (csrc/tile.cuh, each slot weighted by its count) gives
// each slot's start in a `runs` array; each live row then takes a place in
// its run (an atomic cursor per slot) and a second pass puts every run in
// ascending build-row order (each row's rank is the number of smaller rows
// in its run), so the probe's output order, and the float sums above it,
// are the same from run to run. A skewed key serialises that rank count
// (its cost grows with the square of the run; executor logs record
// max_run). The dense table of this mode holds a key's SLOT (its run's
// start and count), as the reference's table holds a first sorted position
// that run_len completes. Bound: the slot counts read once and 4 bytes of
// row per live build row read and written once (plus the dense table).
#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
enum Stat {
  N_LIVE = 0, N_ROWS, HAS_NULL, MAX_RUN, KMIN, KMAX, LO, HI, LO_NAN,
  NDISTINCT, N_STATS
};

// Identities of the first key's min (lo) and max (hi): int64 values, or
// order keys (csrc/common.cuh) for a float key.
__device__ __forceinline__ long long lo_identity(int is_float) {
  return is_float ? key_pos_inf() : 0x7fffffffffffffffLL;
}

__device__ __forceinline__ long long hi_identity(int is_float) {
  return is_float ? key_neg_inf() : (long long)0x8000000000000000ULL;
}

template <class T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_down_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}

template <class T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_down_sync(0xffffffffu, v, o);
    v = y > v ? y : v;
  }
  return v;
}

__global__ void init_kernel(int32_t* __restrict__ slot_rows,
                            int32_t* __restrict__ slot_counts, int64_t slots,
                            unsigned long long* __restrict__ stats,
                            int first_is_float) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t s = t; s < slots; s += (int64_t)gridDim.x * blockDim.x) {
    slot_rows[s] = -1;
    slot_counts[s] = 0;
  }
  if (t < N_STATS) {
    unsigned long long v = 0ULL;
    if (t == KMIN) v = ~0ULL;
    if (t == LO) v = (unsigned long long)lo_identity(first_is_float);
    if (t == HI) v = (unsigned long long)hi_identity(first_is_float);
    stats[t] = v;
  }
}

__global__ void build_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                             int64_t cap, const int32_t* __restrict__ num_rows,
                             int64_t* __restrict__ slot_keys,
                             int32_t* __restrict__ slot_rows,
                             int32_t* __restrict__ slot_counts, int64_t slots,
                             unsigned long long* __restrict__ stats) {
  const int64_t* cols = tbl.v;
  const void* first = reinterpret_cast<const void*>(cols[0]);
  const uint8_t* first_valid = reinterpret_cast<const uint8_t*>(cols[1]);
  const int first_esz = (int)cols[2], first_float = (int)cols[3];
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t mask = (uint64_t)slots - 1;
  unsigned long long n_live = 0, n_rows = 0, has_null = 0, max_run = 0,
                     bnan = 0, ndistinct = 0;
  unsigned long long kmin = ~0ULL, kmax = 0ULL;
  long long lo = lo_identity(first_float), hi = hi_identity(first_float);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    ++n_rows;
    if (first_valid == nullptr || first_valid[i]) {
      long long b;
      if (first_float) {
        const double x = load_float(first, i, first_esz);
        if (x != x) bnan = 1;
        b = ordered_key(x);
      } else {
        b = load_int(first, i, first_esz);
      }
      if (!(first_float && bnan)) {
        lo = b < lo ? b : lo;
        hi = b > hi ? b : hi;
      }
    }
    bool null;
    const uint64_t key = join_key(cols, nkeys, i, &null);
    if (null) {
      has_null = 1;
      continue;
    }
    ++n_live;
    kmin = key < kmin ? key : kmin;
    kmax = key > kmax ? key : kmax;
    uint64_t s = mix64(key) & mask;
    while (true) {
      int r = slot_rows[s];
      if (r == -1) {
        const int prev = atomicCAS(&slot_rows[s], -1, (int)i);
        if (prev == -1) {  // the first row of its key: one more key
          slot_keys[s] = (int64_t)key;
          r = (int)i;
          ++ndistinct;
        } else {
          r = prev;
        }
      }
      bool rnull;
      if (r == (int)i || join_key(cols, nkeys, r, &rnull) == key) {
        const unsigned long long c =
            (unsigned long long)atomicAdd(&slot_counts[s], 1) + 1ULL;
        max_run = c > max_run ? c : max_run;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  n_live = warp_sum(n_live);
  n_rows = warp_sum(n_rows);
  ndistinct = warp_sum(ndistinct);
  has_null = warp_max(has_null);
  max_run = warp_max(max_run);
  bnan = warp_max(bnan);
  kmin = warp_min(kmin);
  kmax = warp_max(kmax);
  lo = warp_min(lo);
  hi = warp_max(hi);
  if ((threadIdx.x & 31) == 0) {
    if (n_live) atomicAdd(&stats[N_LIVE], n_live);
    if (n_rows) atomicAdd(&stats[N_ROWS], n_rows);
    if (ndistinct) atomicAdd(&stats[NDISTINCT], ndistinct);
    if (has_null) atomicMax(&stats[HAS_NULL], has_null);
    if (bnan) atomicMax(&stats[LO_NAN], bnan);
    atomicMax(&stats[MAX_RUN], max_run);
    atomicMin(&stats[KMIN], kmin);
    atomicMax(&stats[KMAX], kmax);
    atomicMin(reinterpret_cast<long long*>(&stats[LO]), lo);
    atomicMax(reinterpret_cast<long long*>(&stats[HI]), hi);
  }
}

// lo/hi of a float first key back from order keys to float64 bits (NaN
// when any live valid key is NaN: jnp.min/max propagate it).
__global__ void finish_kernel(unsigned long long* __restrict__ stats,
                              int first_is_float) {
  if (!first_is_float) return;
  const long long nan = 0x7ff8000000000000LL;
  const bool any_nan = stats[LO_NAN] != 0ULL;
  stats[LO] = (unsigned long long)(any_nan ? nan : __double_as_longlong(
      from_key((long long)stats[LO])));
  stats[HI] = (unsigned long long)(any_nan ? nan : __double_as_longlong(
      from_key((long long)stats[HI])));
}

__global__ void dense_init_kernel(int32_t* __restrict__ table, int64_t size) {
  for (int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; s < size;
       s += (int64_t)gridDim.x * blockDim.x)
    table[s] = 0x7fffffff;
}

__global__ void dense_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                             int64_t cap, const int32_t* __restrict__ num_rows,
                             const unsigned long long* __restrict__ stats,
                             const int32_t* __restrict__ payload,
                             int32_t* __restrict__ table, int64_t size) {
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t kmin = stats[KMIN];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) continue;
    const int64_t raw = (int64_t)(key - kmin);
    if (raw >= 0 && raw < size)
      atomicMin(&table[raw], payload ? payload[i] : (int32_t)i);
  }
}

// Runs mode. The slot counts as tile weights: a slot's run takes as many
// places as rows hold its key (0 for an empty slot).
struct SlotCount {
  const int32_t* counts;
  int64_t slots;

  __device__ __forceinline__ int64_t limit() const { return slots; }
  __device__ __forceinline__ int operator()(int64_t s) const {
    return counts[s];
  }
};

__global__ void runs_start_kernel(const SlotCount sc,
                                  const int64_t* __restrict__ offsets,
                                  int32_t* __restrict__ slot_start) {
  tile_scatter(sc, sc.slots, offsets, [&](int64_t s, int64_t pos) {
    slot_start[s] = (int32_t)pos;
  });
}

// Each live non-NULL row takes the next place of its slot's run (any
// order); runs_order_kernel then sorts each run.
__global__ void runs_place_kernel(const __grid_constant__ Table tbl,
                                  int64_t nkeys, int64_t cap,
                                  const int32_t* __restrict__ num_rows,
                                  const int64_t* __restrict__ slot_keys,
                                  const int32_t* __restrict__ slot_rows,
                                  int64_t slots,
                                  const int32_t* __restrict__ slot_start,
                                  int32_t* __restrict__ cursor,
                                  int32_t* __restrict__ placed) {
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) continue;
    const int64_t s = hash_find(key, slot_keys, slot_rows, slots);
    placed[slot_start[s] + atomicAdd(&cursor[s], 1)] = (int32_t)i;
  }
}

// Row i's final place: its run's start plus the number of rows of the run
// below i, so every run ends in ascending row order.
__global__ void runs_order_kernel(const __grid_constant__ Table tbl,
                                  int64_t nkeys, int64_t cap,
                                  const int32_t* __restrict__ num_rows,
                                  const int64_t* __restrict__ slot_keys,
                                  const int32_t* __restrict__ slot_rows,
                                  const int32_t* __restrict__ slot_counts,
                                  int64_t slots,
                                  const int32_t* __restrict__ slot_start,
                                  const int32_t* __restrict__ placed,
                                  int32_t* __restrict__ runs) {
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) continue;
    const int64_t s = hash_find(key, slot_keys, slot_rows, slots);
    const int32_t start = slot_start[s], count = slot_counts[s];
    int32_t rank = 0;
    for (int32_t q = 0; count > 1 && q < count; ++q)
      rank += placed[start + q] < (int32_t)i ? 1 : 0;
    runs[start + rank] = (int32_t)i;
  }
}

// The dense table of runs mode: key kmin + d -> the slot holding it.
__global__ void runs_dense_kernel(const int64_t* __restrict__ slot_keys,
                                  const int32_t* __restrict__ slot_rows,
                                  int64_t slots,
                                  const unsigned long long* __restrict__ stats,
                                  int32_t* __restrict__ table, int64_t size) {
  const uint64_t kmin = stats[KMIN];
  for (int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; s < slots;
       s += (int64_t)gridDim.x * blockDim.x) {
    if (slot_rows[s] == -1) continue;
    const int64_t raw = (int64_t)((uint64_t)slot_keys[s] - kmin);
    if (raw >= 0 && raw < size) table[raw] = (int32_t)s;
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per key column (values ptr,
// valid ptr or 0, element size, is_float); num_rows: int32 scalar;
// slot_keys: int64[slots]; slot_rows, slot_counts: int32[slots] with
// `slots` a power of two above the live rows; stats: int64[10] (layout in
// enum Stat). All but the table on the device. Returns cudaGetLastError(),
// or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int join_build(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, void* slot_keys,
                         void* slot_rows, void* slot_counts, int64_t slots,
                         void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  const int first_float = (int)t.v[3];
  auto* st = static_cast<unsigned long long*>(stats);
  init_kernel<<<grid_for(slots), THREADS, 0, s>>>(
      static_cast<int32_t*>(slot_rows), static_cast<int32_t*>(slot_counts),
      slots, st, first_float);
  build_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, static_cast<const int32_t*>(num_rows),
      static_cast<int64_t*>(slot_keys), static_cast<int32_t*>(slot_rows),
      static_cast<int32_t*>(slot_counts), slots, st);
  finish_kernel<<<1, 1, 0, s>>>(st, first_float);
  return (int)cudaGetLastError();
}

// The direct-address table of the dense route: dense: int32[size], key
// kmin + s -> its build row, INT32_MAX when absent; stats as join_build
// wrote it (kmin is read on the device). With a payload (int32[cap] or
// null) a slot holds the smallest payload of its key's rows instead of
// the row: the spilled join's table over the sorted keys with their
// permutation (trino_tpu/ops/join.py build_dense_table_rows).
TT_EXPORT int join_dense(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, const void* stats,
                         const void* payload, void* dense, int64_t size,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  dense_init_kernel<<<grid_for(size), THREADS, 0, s>>>(
      static_cast<int32_t*>(dense), size);
  dense_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, static_cast<const int32_t*>(num_rows),
      static_cast<const unsigned long long*>(stats),
      static_cast<const int32_t*>(payload), static_cast<int32_t*>(dense),
      size);
  return (int)cudaGetLastError();
}

// Runs mode (after join_build on the same columns): runs: int32[cap], the
// live non-NULL build rows grouped by key, each key's rows in ascending
// order; slot_start: int32[slots], an occupied slot's first place in runs
// (slot_counts, from join_build, its length); cursor: int32[slots] and
// placed: int32[cap] scratch; scratch: int64[ceil(slots / 4096)]; total:
// int32 scalar (the rows laid out). With size > 0 also the dense table
// dense: int32[size], key kmin + d -> its slot, INT32_MAX when absent.
// Returns cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int join_runs(const void* table, int64_t nkeys, int64_t cap,
                        const void* num_rows, const void* stats,
                        const void* slot_keys, const void* slot_rows,
                        const void* slot_counts, int64_t slots,
                        void* slot_start, void* cursor, void* placed,
                        void* scratch, void* total, void* runs, void* dense,
                        int64_t size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  const auto* keys = static_cast<const int64_t*>(slot_keys);
  const auto* rows = static_cast<const int32_t*>(slot_rows);
  const auto* counts = static_cast<const int32_t*>(slot_counts);
  auto* start = static_cast<int32_t*>(slot_start);
  auto* offsets = static_cast<int64_t*>(scratch);
  const auto* nr = static_cast<const int32_t*>(num_rows);
  cudaMemsetAsync(cursor, 0, slots * sizeof(int32_t), s);
  const SlotCount sc{counts, slots};
  const int64_t nblocks = tile_offsets(sc, slots, offsets,
                                       static_cast<int32_t*>(total), s);
  runs_start_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(sc, offsets,
                                                               start);
  runs_place_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, nr, keys, rows, slots, start,
      static_cast<int32_t*>(cursor), static_cast<int32_t*>(placed));
  runs_order_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, nr, keys, rows, counts, slots, start,
      static_cast<const int32_t*>(placed), static_cast<int32_t*>(runs));
  if (size > 0) {
    dense_init_kernel<<<grid_for(size), THREADS, 0, s>>>(
        static_cast<int32_t*>(dense), size);
    runs_dense_kernel<<<grid_for(slots), THREADS, 0, s>>>(
        keys, rows, slots, static_cast<const unsigned long long*>(stats),
        static_cast<int32_t*>(dense), size);
  }
  return (int)cudaGetLastError();
}
