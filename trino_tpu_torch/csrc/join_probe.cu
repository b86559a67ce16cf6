// K6: the probe of an INNER equi-join against a UNIQUE build side.
//
// Replaces trino_tpu/ops/join.py unique_inner_probe (with _key_u64/_mix64
// and, on the dense route, _dense_lo): per probe row, its 64-bit key, dead
// or NULL rows excluded, one lookup in the structure K5 built, the `found`
// mask, `brow` = the matching build ROW (0 where not found), and the number
// of matches. The reference's `search` route is a searchsorted over the
// sorted build keys (log n passes of the sort engine) plus a gather through
// the sort permutation; here both routes are one kernel:
//   dense  — one 4-byte read of the direct-address table at key - kmin;
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
// sector per row). The match
// count is reduced in registers and a warp shuffle, one atomic per warp.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
constexpr int STAT_KMIN = 4;   // csrc/join_build.cu enum Stat

__global__ void probe_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                             int64_t cap, const int32_t* __restrict__ num_rows,
                             int dense_route,
                             const int32_t* __restrict__ dense, int64_t size,
                             const int64_t* __restrict__ stats,
                             const int64_t* __restrict__ slot_keys,
                             const int32_t* __restrict__ slot_rows,
                             int64_t slots, uint8_t* __restrict__ found,
                             int64_t* __restrict__ brow,
                             unsigned long long* __restrict__ count) {
  const int64_t* pcols = tbl.v;
  const int64_t* bcols = tbl.v + KEY_FIELDS * nkeys;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t kmin = (uint64_t)stats[STAT_KMIN];
  unsigned long long hits = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool f = false;
    int64_t b = 0;
    if (i < n) {
      bool null;
      const uint64_t key = join_key(pcols, nkeys, i, &null);
      if (!null) {
        if (dense_route) {
          const int32_t r = dense_find(key, kmin, dense, size);
          if (r != 0x7fffffff) {
            f = true;
            b = r;
          }
        } else {
          const int64_t s = hash_find(key, slot_keys, slot_rows, slots);
          if (s >= 0) {
            f = true;
            b = slot_rows[s];
          }
        }
        if (f && nkeys > 1) f = same_keys(pcols, bcols, nkeys, i, b);
      }
    }
    found[i] = f ? 1 : 0;
    brow[i] = f ? b : 0;
    hits += f ? 1ULL : 0ULL;
  }
  hits = warp_sum(hits);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(count, hits);
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per probe key column, then as
// many per build key column (values ptr, valid ptr or 0, element size,
// is_float); dense_route 1: `dense` int32[size] (K5 join_dense), else the
// hash table slot_keys int64[slots] / slot_rows int32[slots] (K5
// join_build); stats: K5's int64[10]; found: uint8[cap]; brow: int64[cap];
// count: int64 scalar (zeroed here). Returns cudaGetLastError(), or -1 when
// the table exceeds TABLE_MAX.
TT_EXPORT int join_probe(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, int64_t dense_route,
                         const void* dense, int64_t size, const void* stats,
                         const void* slot_keys, const void* slot_rows,
                         int64_t slots, void* found,
                         void* brow, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nkeys < 1 || load_table(table, 2 * KEY_FIELDS * nkeys, &t)) return -1;
  cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (cap > 0) {
    int64_t blocks = (cap + THREADS - 1) / THREADS;
    blocks = blocks > 4224 ? 4224 : blocks;
    probe_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const int32_t*>(num_rows),
        (int)dense_route, static_cast<const int32_t*>(dense), size,
        static_cast<const int64_t*>(stats),
        static_cast<const int64_t*>(slot_keys),
        static_cast<const int32_t*>(slot_rows), slots,
        static_cast<uint8_t*>(found), static_cast<int64_t*>(brow),
        static_cast<unsigned long long*>(count));
  }
  return (int)cudaGetLastError();
}
