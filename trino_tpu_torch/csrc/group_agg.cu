// K8: GROUP BY on any key columns (the general path of hash_aggregate).
//
// Replaces the sorted path of trino_tpu/ops/aggregate.py hash_aggregate:
// _sort_key_arrays (dead flag, then a NULL flag and a NULL-zeroed value per
// key), one multi-operand lax.sort, _boundary_scan (NaN == NaN), a cumsum
// of group starts, and _accumulate/_final_state_contribs reducing every
// state with segment_sum/min/max. A sort moves every key and every state
// log n times; this kernel moves each once, with a global open-addressing
// table (the "global hash tables" design of PAPERS.md):
//
//   1. accumulate_kernel — per live row, its canonical key: per key column
//      a NULL flag and a value with NULL -> 0, -0.0 -> +0.0 and every NaN
//      -> one bit pattern (so NULLs form one group, NaNs one group, and
//      -0.0 joins +0.0, as the sort + boundary scan groups them; a
//      dictionary key groups by its code). Its hash picks a start slot of
//      a power-of-two table >= 2 x capacity; linear probing claims an empty
//      slot with atomicCAS on the slot's representative row, or joins the
//      slot whose representative row has the same canonical key, checked
//      column by column (two distinct keys can share a hash). The row's
//      states then fold into the slot with atomics: int64 sums and counts
//      as wrapping 64-bit adds (exact), float64 sums with atomicAdd(double)
//      (order varies from run to run: held to 1e-9 relative), min/max as
//      atomicMin/Max on K3's order-preserving int64 keys with NaN as a
//      separate flag.
//   2. count / scan / scatter over 4096-slot tiles, K1's passes
//      (csrc/tile.cuh): the occupied slots, in slot order, become the
//      output page — each
//      group's key columns (values and validity) copied from its
//      representative row, then its states (min/max decoded back to float
//      bits, NaN where flagged).
//
// Groups come out in slot order, not the reference's sorted order (SQL
// promises none; a TopN or ORDER BY above orders them). The representative
// row is whichever row claimed the slot, where the reference emits the
// group's first sorted row: in a group holding both -0.0 and +0.0 the
// reference emits -0.0 and this kernel either; the two compare equal.
//
// Distinct mode (group_distinct) replaces trino_tpu/ops/aggregate.py
// _distinct_first_mask, the MarkDistinct of a DISTINCT aggregate: one more
// lexicographic sort on (group keys, argument) and a boundary scan mark the
// first eligible row of each distinct pair. Here the same table does it in
// one pass: each eligible row (live, non-NULL argument, passing the
// aggregate's FILTER) inserts its canonical (keys, argument) key, and the
// row that claims a slot is the marked one (any one row of its pair; they
// are equal under the canonical rules, so the aggregate above cannot tell
// which). Bound: the live keys and the argument read once and 1 byte of
// mask written per row.
//
// Bound on this card: bytes — every live row's key and state columns read
// once and each group's output written once. The table (row, states, NaN
// flags) is written once at init; the atomics are random 8-byte accesses,
// served from L2 while the table fits its 50 MB.
#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
// per key: values ptr, valid ptr, element size, is_float, out values ptr,
// out valid ptr (0 when the input has no validity); per state: as K3
// (STATE_FIELDS, csrc/common.cuh)
constexpr int KEY_FIELDS = 6;
constexpr uint64_t CANON_NAN = 0x7ff8000000000000ULL;

// Canonical value of key column `k` at row i; *null set for a NULL key.
__device__ __forceinline__ uint64_t canon(const int64_t* k, int64_t i,
                                          bool* null) {
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(k[1]);
  if (valid != nullptr && !valid[i]) {
    *null = true;
    return 0ULL;
  }
  *null = false;
  const void* p = reinterpret_cast<const void*>(k[0]);
  if (k[3]) {
    const double x = load_float(p, i, (int)k[2]);
    if (x != x) return CANON_NAN;
    return (uint64_t)__double_as_longlong(x == 0.0 ? 0.0 : x);
  }
  return (uint64_t)load_int(p, i, (int)k[2]);
}

__device__ __forceinline__ uint64_t key_hash(const int64_t* keys,
                                             int64_t nkeys, int64_t i) {
  uint64_t acc = 0;
  for (int64_t q = 0; q < nkeys; ++q) {
    bool null;
    const uint64_t v = canon(keys + KEY_FIELDS * q, i, &null);
    acc = mix64(acc ^ mix64(v + (null ? 0x5bd1e995ULL : 0ULL)) ^
                (acc * KEY_MIX));
  }
  return acc;
}

__device__ __forceinline__ bool same_key(const int64_t* keys, int64_t nkeys,
                                         int64_t i, int64_t r) {
  for (int64_t q = 0; q < nkeys; ++q) {
    bool ni, nr;
    const uint64_t a = canon(keys + KEY_FIELDS * q, i, &ni);
    const uint64_t b = canon(keys + KEY_FIELDS * q, r, &nr);
    if (ni != nr || a != b) return false;
  }
  return true;
}

__global__ void init_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                            int64_t k, int64_t slots,
                            int32_t* __restrict__ slot_rows,
                            unsigned long long* __restrict__ acc,
                            int32_t* __restrict__ nan) {
  const int64_t* st = tbl.v + KEY_FIELDS * nkeys;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t s = t; s < slots; s += stride) slot_rows[s] = -1;
  for (int64_t e = t; e < slots * k; e += stride) {
    const int64_t j = e % k;
    acc[e] = agg_identity((int)st[j * STATE_FIELDS + 3],
                          (int)st[j * STATE_FIELDS + 4]);
    nan[e] = 0;
  }
}

__global__ void accumulate_kernel(const __grid_constant__ Table tbl,
                                  int64_t nkeys, int64_t k, int64_t cap,
                                  const int32_t* __restrict__ num_rows,
                                  int64_t slots,
                                  int32_t* __restrict__ slot_rows,
                                  unsigned long long* __restrict__ acc,
                                  int32_t* __restrict__ nan) {
  const int64_t* keys = tbl.v;
  const int64_t* st = tbl.v + KEY_FIELDS * nkeys;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t mask = (uint64_t)slots - 1;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t s = key_hash(keys, nkeys, i) & mask;
    while (true) {
      int32_t r = slot_rows[s];
      if (r == -1) {
        r = atomicCAS(&slot_rows[s], -1, (int32_t)i);
        if (r == -1) break;  // claimed
      }
      if (same_key(keys, nkeys, i, r)) break;
      s = (s + 1) & mask;
    }
    agg_fold_row(st, k, i, acc + s * k, nan + s * k);
  }
}

// The occupied slots: every slot of the table, kept when a row claimed it.
struct Occupied {
  const int32_t* slot_rows;
  int64_t slots;

  __device__ __forceinline__ int64_t limit() const { return slots; }
  __device__ __forceinline__ bool operator()(int64_t s) const {
    return slot_rows[s] != -1;
  }
};

// Each occupied slot of this block's tile becomes output row `pos`: its
// key columns copied from the representative row, then its states.
__global__ void group_scatter_kernel(const __grid_constant__ Table tbl,
                                     int64_t nkeys, int64_t k,
                                     int64_t out_cap, const Occupied occ,
                                     const unsigned long long* __restrict__ acc,
                                     const int32_t* __restrict__ nan,
                                     const int64_t* __restrict__ offsets,
                                     unsigned long long* __restrict__ out) {
  const int64_t* keys = tbl.v;
  const int64_t* st = tbl.v + KEY_FIELDS * nkeys;
  tile_scatter(occ, occ.slots, offsets, [&](int64_t s, int64_t pos) {
    const int32_t row = occ.slot_rows[s];
    for (int64_t q = 0; q < nkeys; ++q) {
      const int64_t* kq = keys + KEY_FIELDS * q;
      copy_elem(reinterpret_cast<const void*>(kq[0]), row,
                reinterpret_cast<void*>(kq[4]), pos, (int)kq[2]);
      if (kq[5] != 0)
        reinterpret_cast<uint8_t*>(kq[5])[pos] =
            reinterpret_cast<const uint8_t*>(kq[1])[row];
    }
    for (int64_t j = 0; j < k; ++j)
      out[j * out_cap + pos] = agg_result(
          (int)st[j * STATE_FIELDS + 3], (int)st[j * STATE_FIELDS + 4],
          acc[s * k + j], nan[s * k + j]);
  });
}

// Distinct mode: mark[i] = 1 for the eligible row that claims its
// canonical key's slot, 0 for every other row of the capacity.
__global__ void distinct_kernel(const __grid_constant__ Table tbl,
                                int64_t nkeys, int64_t cap,
                                const uint8_t* __restrict__ eligible,
                                int64_t slots,
                                int32_t* __restrict__ slot_rows,
                                uint8_t* __restrict__ mark) {
  const int64_t* keys = tbl.v;
  const uint64_t mask = (uint64_t)slots - 1;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint8_t first = 0;
    if (eligible[i]) {
      uint64_t s = key_hash(keys, nkeys, i) & mask;
      while (true) {
        int32_t r = slot_rows[s];
        if (r == -1) {
          r = atomicCAS(&slot_rows[s], -1, (int32_t)i);
          if (r == -1) {
            first = 1;
            break;
          }
        }
        if (same_key(keys, nkeys, i, r)) break;
        s = (s + 1) & mask;
      }
    }
    mark[i] = first;
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per key column then
// STATE_FIELDS per state (layouts above); slot_rows: int32[slots], acc:
// 8-byte words [slots, k], nan: int32[slots, k] (scratch, `slots` a power
// of two >= 2 x cap); scratch: int64[ceil(slots / 4096)]; out: 8-byte words
// [k, out_cap]; key outputs hold out_cap elements; num_groups: int32
// scalar. All but the table on the device. Returns cudaGetLastError(), or
// -1 when the table exceeds TABLE_MAX.
TT_EXPORT int group_aggregate(const void* table, int64_t nkeys, int64_t k,
                              int64_t cap, const void* num_rows,
                              int64_t slots, void* slot_rows, void* acc,
                              void* nan, void* scratch, void* out,
                              int64_t out_cap, void* num_groups,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, KEY_FIELDS * nkeys + STATE_FIELDS * k, &t))
    return -1;
  auto* rows = static_cast<int32_t*>(slot_rows);
  auto* a = static_cast<unsigned long long*>(acc);
  auto* fl = static_cast<int32_t*>(nan);
  auto* offs = static_cast<int64_t*>(scratch);
  const unsigned init_grid = grid_for(k > 1 ? slots * k : slots);
  init_kernel<<<init_grid, THREADS, 0, s>>>(
      t, nkeys, k, slots, rows, a, fl);
  accumulate_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, k, cap, static_cast<const int32_t*>(num_rows), slots, rows, a,
      fl);
  const Occupied occ{rows, slots};
  const int64_t nblocks = tile_offsets(occ, slots, offs,
                                       static_cast<int32_t*>(num_groups), s);
  group_scatter_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
      t, nkeys, k, out_cap, occ, a, fl, offs,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// Distinct mode: keys as group_aggregate's (the group keys, then the
// aggregate's argument; output pointers unused); eligible: uint8[cap];
// slot_rows: int32[slots] scratch (`slots` a power of two >= 2 x cap);
// mark: uint8[cap]. Returns cudaGetLastError(), or -1 when the table
// exceeds TABLE_MAX.
TT_EXPORT int group_distinct(const void* table, int64_t nkeys, int64_t cap,
                             const void* eligible, int64_t slots,
                             void* slot_rows, void* mark, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  cudaMemsetAsync(slot_rows, 0xff, slots * sizeof(int32_t), s);  // all -1
  if (cap > 0)
    distinct_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const uint8_t*>(eligible), slots,
        static_cast<int32_t*>(slot_rows), static_cast<uint8_t*>(mark));
  return (int)cudaGetLastError();
}
