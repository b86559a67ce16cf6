// K12: the build side of the `mxu` join route, the per-key table.
//
// Replaces trino_tpu/ops/join_mxu.py build_count_pos_table (and, with K5's
// NDISTINCT statistic, distinct_live_keys). The reference materializes the
// right-hand operand of its blocked one-hot matmul: per key slot of the
// dense span [kmin, kmin + size), the live match count and the first
// sorted build position, as float32 (exact below 2^24), scattered with
// .add/.min over the sorted keys. The function the probe then computes is
// a table lookup, so here the table stays int32 (size, 2) = (count, first)
// and the probe side (K13, the `mxu` mode of K6 in csrc/join_probe.cu and
// of K9 in csrc/join_expand.cu) stages it in shared memory and reads one
// entry per probe row; no matrix unit is needed for exactness.
//
//   mxu_table_kernel — per live non-NULL build row: its key (csrc/
//     common.cuh join_key), slot key - kmin (a key outside the span goes to
//     no slot), atomicAdd of the count and atomicMin of the row's position
//     into a table initialised to (0, INT32_MAX). The position is the
//     port's order of the build: the build ROW for a unique build (what K6
//     attaches), and for a build with K5's runs the start of the key's run
//     in `runs` (what K9 walks, in ascending row order), so the output rows
//     and their order are the reference's.
//
// Bound on this card: bytes — the live build rows' key columns read once
// and the table (8 bytes a slot) written once; the build is at most a few
// thousand rows on the main path (nation 25, region 5; the span is at most
// mxu_join_max_slots), so a launch is latency, not bandwidth.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
constexpr int STAT_KMIN = 4;   // csrc/join_build.cu enum Stat

__global__ void mxu_init_kernel(int32_t* __restrict__ table, int64_t size) {
  for (int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; s < size;
       s += (int64_t)gridDim.x * blockDim.x) {
    table[2 * s] = 0;
    table[2 * s + 1] = 0x7fffffff;
  }
}

__global__ void mxu_table_kernel(const __grid_constant__ Table tbl,
                                 int64_t nkeys, int64_t cap,
                                 const int32_t* __restrict__ num_rows,
                                 const int64_t* __restrict__ stats,
                                 const int64_t* __restrict__ slot_keys,
                                 const int32_t* __restrict__ slot_rows,
                                 int64_t slots,
                                 const int32_t* __restrict__ slot_start,
                                 int32_t* __restrict__ table, int64_t size) {
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t kmin = (uint64_t)stats[STAT_KMIN];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) continue;
    const int64_t raw = (int64_t)(key - kmin);
    if (raw < 0 || raw >= size) continue;
    const int32_t pos =
        slot_start == nullptr
            ? (int32_t)i
            : slot_start[hash_find(key, slot_keys, slot_rows, slots)];
    atomicAdd(&table[2 * raw], 1);
    atomicMin(&table[2 * raw + 1], pos);
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per build key column (values
// ptr, valid ptr or 0, element size, is_float); num_rows: int32 scalar;
// stats: K5's int64[10] (kmin read on the device); slot_keys int64[slots]
// / slot_rows int32[slots]: K5's hash table; slot_start: int32[slots] of
// K5's runs mode, or null for positions that are build rows; out:
// int32[size][2]. Returns cudaGetLastError(), or -1 when the table
// exceeds TABLE_MAX.
TT_EXPORT int mxu_table(const void* table, int64_t nkeys, int64_t cap,
                        const void* num_rows, const void* stats,
                        const void* slot_keys, const void* slot_rows,
                        int64_t slots, const void* slot_start, void* out,
                        int64_t size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  auto* tab = static_cast<int32_t*>(out);
  mxu_init_kernel<<<grid_for(size), THREADS, 0, s>>>(tab, size);
  if (cap > 0)
    mxu_table_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        t, nkeys, cap, static_cast<const int32_t*>(num_rows),
        static_cast<const int64_t*>(stats),
        static_cast<const int64_t*>(slot_keys),
        static_cast<const int32_t*>(slot_rows), slots,
        static_cast<const int32_t*>(slot_start), tab, size);
  return (int)cudaGetLastError();
}
