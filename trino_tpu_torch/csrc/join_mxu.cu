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
// K24, K25 and K27: the aggregating join (B11b), below.
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

// ------------------------------------------------------------------ K24
//
// Replaces trino_tpu/ops/join_mxu.py scatter_agg_table (:149): per build
// row in the key span, one scatter-add per vector into the (slots x C)
// table — the pair count, the sum of a build column over its valid values,
// the count of those values — then the distinct occupied slots and the
// magnitude gate. The reference accumulates in float64 (its CPU) or
// float32 (gated at 2^24); here counts and integer sums are int64 atomics
// (exact, wrapping like int64) and float sums float64 atomics, so the
// results are the reference CPU's and only the order of float additions
// differs.
//
//   agg_table_kernel — one thread per build row, 64-bit atomicAdd into the
//     global table (mode 1, and mode 0 past SUB_WORDS).
//   agg_table_shared_kernel — the same rows added into a per-block copy of
//     the table in shared memory, merged into the global table with one
//     atomic per non-zero entry at the block's end (mode 0): few slots
//     under many build rows (G3: 1.5M rows on 256 slots) serialise global
//     atomics on the same few addresses, the block copy takes them on the
//     SM instead.
//   agg_finish_kernel — one block: distinct occupied slots, live rows and
//     mag_ok (every integer sum inside +-2^53, and the integer values'
//     absolute total, summed per block in float64, under 2^63, so no int64
//     sum wrapped).
//
// Bound on this card: bytes — the build's key and vector columns read once,
// the table written once; the atomics on a few hot slots bound it in
// practice (G3), which the shared mode addresses.
//
// ------------------------------------------------------------------ K25
//
// Replaces trino_tpu/ops/join_mxu.py agg_join_lookup (:218) with its
// blocked one-hot matmul blocked_lookup (:114): per probe row the key's
// table row (zeros outside the span), its pair count cnt, and each derived
// column — cnt, cnt where the probe value is valid, value * cnt (int64,
// wrapping, or float64), or a table column — plus the live mask (row live,
// key not NULL, cnt > 0) that K1 compacts by. A table of at most 6,144
// words (48 KB) is staged in each block's shared memory, as K13 stages its
// table; a larger one (G2 at sf1: 32,768 slots x 4 = 1 MiB) is read where
// it lies, through L2. Bound on this card: bytes — the probe key and value
// columns read once, every derived column and the mask written once.
namespace {
enum Vec { VEC_CNT = 0, VEC_SUM_I = 1, VEC_SUM_F = 2, VEC_VALIDCNT = 3 };
enum Op {
  OP_PAIRS = 0, OP_CNTP = 1, OP_SUMP_I = 2, OP_SUMP_F = 3, OP_TABLE_I = 4,
  OP_TABLE_F = 5
};
constexpr int VEC_FIELDS = 5;   // kind, values ptr, valid ptr, esz, is_float
constexpr int OUT_FIELDS = 7;   // op, table column, values, valid, esz,
                                // is_float, out ptr
constexpr int64_t SMEM_WORDS = 6144;   // 48 KB of 8-byte table words
constexpr int64_t SUB_WORDS = 6080;    // K24's copy, beside 256 B of its own
constexpr int SHARED_BLOCKS = 264;     // two blocks per SM for the copy
constexpr long long EXACT = 1LL << 53; // MAX_EXACT_INT_SUM
enum Info { INFO_DISTINCT = 0, INFO_MAG_OK = 1, INFO_LIVE = 2, INFO_ABSUM = 3 };

__device__ __forceinline__ int64_t clamp_rows(const int32_t* num_rows,
                                              int64_t cap) {
  const int64_t n = *num_rows;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__device__ __forceinline__ double block_sum_double(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;  // valid in thread 0
}

// One build row's vectors added at `row` (global or shared table); returns
// |x| summed over its integer-sum values.
__device__ __forceinline__ double add_row(const int64_t* vecs, int64_t nvec,
                                          int64_t i,
                                          unsigned long long* row) {
  double absum = 0;
  for (int64_t q = 0; q < nvec; ++q) {
    const int64_t* v = vecs + VEC_FIELDS * q;
    const int kind = (int)v[0];
    if (kind == VEC_CNT) {
      atomicAdd(&row[q], 1ULL);
      continue;
    }
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(v[2]);
    if (valid != nullptr && !valid[i]) continue;
    const void* p = reinterpret_cast<const void*>(v[1]);
    if (kind == VEC_VALIDCNT) {
      atomicAdd(&row[q], 1ULL);
    } else if (kind == VEC_SUM_I) {
      const int64_t x = load_int(p, i, (int)v[3]);
      atomicAdd(&row[q], (unsigned long long)x);
      absum += fabs((double)x);
    } else {
      atomicAdd(reinterpret_cast<double*>(&row[q]),
                load_float(p, i, (int)v[3]));
    }
  }
  return absum;
}

__global__ void agg_zero_kernel(unsigned long long* __restrict__ table,
                                int64_t words, int64_t* __restrict__ info) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       j < words; j += (int64_t)gridDim.x * blockDim.x)
    table[j] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) info[INFO_ABSUM] = 0;  // +0.0
}

__global__ void agg_table_kernel(const __grid_constant__ Table tbl,
                                 int64_t nvec, int64_t cap,
                                 const int32_t* __restrict__ num_rows,
                                 const int64_t* __restrict__ kmin_p,
                                 unsigned long long* __restrict__ table,
                                 int64_t slots, int64_t* __restrict__ info) {
  __shared__ double red[32];
  const int64_t n = clamp_rows(num_rows, cap);
  const uint64_t kmin = (uint64_t)*kmin_p;
  double absum = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, 1, i, &null);
    const int64_t raw = (int64_t)(key - kmin);
    if (null || raw < 0 || raw >= slots) continue;
    absum += add_row(tbl.v + KEY_FIELDS, nvec, i, table + raw * nvec);
  }
  const double total = block_sum_double(absum, red);
  if (threadIdx.x == 0 && total != 0)
    atomicAdd(reinterpret_cast<double*>(&info[INFO_ABSUM]), total);
}

__global__ void agg_table_shared_kernel(const __grid_constant__ Table tbl,
                                        int64_t nvec, int64_t cap,
                                        const int32_t* __restrict__ num_rows,
                                        const int64_t* __restrict__ kmin_p,
                                        unsigned long long* __restrict__ table,
                                        int64_t slots,
                                        int64_t* __restrict__ info) {
  extern __shared__ unsigned long long sub[];
  __shared__ double red[32];
  const int64_t words = slots * nvec;
  for (int64_t j = threadIdx.x; j < words; j += blockDim.x) sub[j] = 0;
  __syncthreads();
  const int64_t n = clamp_rows(num_rows, cap);
  const uint64_t kmin = (uint64_t)*kmin_p;
  double absum = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool null;
    const uint64_t key = join_key(tbl.v, 1, i, &null);
    const int64_t raw = (int64_t)(key - kmin);
    if (null || raw < 0 || raw >= slots) continue;
    absum += add_row(tbl.v + KEY_FIELDS, nvec, i, sub + raw * nvec);
  }
  const double total = block_sum_double(absum, red);  // syncs the block
  const int64_t* vecs = tbl.v + KEY_FIELDS;
  for (int64_t j = threadIdx.x; j < words; j += blockDim.x) {
    const unsigned long long v = sub[j];
    if (v == 0) continue;
    if (vecs[VEC_FIELDS * (j % nvec)] == VEC_SUM_F)
      atomicAdd(reinterpret_cast<double*>(&table[j]), __longlong_as_double(v));
    else
      atomicAdd(&table[j], v);
  }
  if (threadIdx.x == 0 && total != 0)
    atomicAdd(reinterpret_cast<double*>(&info[INFO_ABSUM]), total);
}

__global__ void agg_finish_kernel(const __grid_constant__ Table tbl,
                                  int64_t nvec,
                                  const long long* __restrict__ table,
                                  int64_t slots, int64_t* __restrict__ info) {
  __shared__ unsigned long long red[2][32];
  const int64_t* vecs = tbl.v + KEY_FIELDS;
  unsigned long long distinct = 0, live = 0;
  int bad = 0;
  for (int64_t s = threadIdx.x; s < slots; s += blockDim.x) {
    const long long c = table[s * nvec];
    distinct += c > 0;
    live += (unsigned long long)c;
    for (int64_t q = 1; q < nvec; ++q) {
      if (vecs[VEC_FIELDS * q] != VEC_SUM_I) continue;
      const long long x = table[s * nvec + q];
      if (x <= -EXACT || x >= EXACT) bad = 1;
    }
  }
  bad = __syncthreads_or(bad);
  distinct = warp_sum(distinct);
  live = warp_sum(live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = distinct;
    red[1][warp] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long d = 0, l = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      d += red[0][w];
      l += red[1][w];
    }
    const double absum = __longlong_as_double(info[INFO_ABSUM]);
    info[INFO_DISTINCT] = (int64_t)d;
    info[INFO_MAG_OK] = !bad && absum < 9223372036854775808.0;
    info[INFO_LIVE] = (int64_t)l;
  }
}

__global__ void agg_lookup_kernel(const __grid_constant__ Table tbl,
                                  int64_t nout, int64_t cap,
                                  const int32_t* __restrict__ num_rows,
                                  const long long* __restrict__ table,
                                  int64_t slots, int64_t ncols,
                                  const int64_t* __restrict__ kmin_p,
                                  bool* __restrict__ live_out) {
  extern __shared__ long long stab[];
  const long long* t = table;
  const int64_t words = slots * ncols;
  if (words <= SMEM_WORDS) {
    for (int64_t j = threadIdx.x; j < words; j += blockDim.x)
      stab[j] = table[j];
    __syncthreads();
    t = stab;
  }
  const int64_t n = clamp_rows(num_rows, cap);
  const uint64_t kmin = (uint64_t)*kmin_p;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    // every row is looked up, as the reference's matmul looks up every row;
    // liveness only decides what K1 keeps
    bool null;
    const uint64_t key = join_key(tbl.v, 1, i, &null);
    const int64_t raw = (int64_t)(key - kmin);
    const bool inb = raw >= 0 && raw < slots;
    const long long* row = t + (inb ? raw : 0) * ncols;
    const long long cnt = inb ? row[0] : 0;
    live_out[i] = i < n && !null && cnt > 0;
    for (int64_t q = 0; q < nout; ++q) {
      const int64_t* o = tbl.v + KEY_FIELDS + OUT_FIELDS * q;
      const void* p = reinterpret_cast<const void*>(o[2]);
      long long* out = reinterpret_cast<long long*>(o[6]);
      switch ((int)o[0]) {
        case OP_PAIRS:
          out[i] = cnt;
          break;
        case OP_CNTP: {
          const uint8_t* valid = reinterpret_cast<const uint8_t*>(o[3]);
          out[i] = (valid == nullptr || valid[i]) ? cnt : 0;
          break;
        }
        case OP_SUMP_I:
          out[i] = (long long)((unsigned long long)load_int(p, i, (int)o[4]) *
                               (unsigned long long)cnt);
          break;
        case OP_SUMP_F:
          reinterpret_cast<double*>(out)[i] =
              load_float(p, i, (int)o[4]) * (double)cnt;
          break;
        default:  // OP_TABLE_I, OP_TABLE_F: the word, float64 bits as they are
          out[i] = inb ? row[o[1]] : 0;
          break;
      }
    }
  }
}
}  // namespace

// table: int64 HOST array: the key column's KEY_FIELDS words, then
// VEC_FIELDS words per vector (kind, values ptr or 0, valid ptr or 0,
// element size, is_float), the first VEC_CNT; num_rows: int32 scalar; kmin:
// one int64 word on the device; out: int64[slots][nvec] (float sums as
// float64 bits); info: int64[4] (distinct, mag_ok, live rows, the absolute
// total's float64 bits); mode 1: global atomics, 0: the per-block shared
// copy when the table fits SUB_WORDS, else global atomics. Returns
// cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int agg_table(const void* table, int64_t nvec, int64_t cap,
                        const void* num_rows, const void* kmin, void* out,
                        int64_t slots, void* info, int64_t mode,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nvec < 1 || load_table(table, KEY_FIELDS + VEC_FIELDS * nvec, &t))
    return -1;
  auto* tab = static_cast<unsigned long long*>(out);
  auto* inf = static_cast<int64_t*>(info);
  const int64_t words = slots * nvec;
  agg_zero_kernel<<<grid_for(words), THREADS, 0, s>>>(tab, words, inf);
  const bool shared = words <= SUB_WORDS && mode != 1;
  if (cap > 0) {
    const auto* nr = static_cast<const int32_t*>(num_rows);
    const auto* km = static_cast<const int64_t*>(kmin);
    if (shared) {
      unsigned blocks = grid_for(cap);
      if (blocks > SHARED_BLOCKS) blocks = SHARED_BLOCKS;
      agg_table_shared_kernel<<<blocks, THREADS, (size_t)(8 * words), s>>>(
          t, nvec, cap, nr, km, tab, slots, inf);
    } else {
      agg_table_kernel<<<grid_for(cap), THREADS, 0, s>>>(t, nvec, cap, nr,
                                                          km, tab, slots, inf);
    }
  }
  agg_finish_kernel<<<1, 1024, 0, s>>>(
      t, nvec, reinterpret_cast<const long long*>(tab), slots, inf);
  return (int)cudaGetLastError();
}

// table: int64 HOST array: the probe key column's KEY_FIELDS words, then
// OUT_FIELDS words per output column (op, table column, values ptr or 0,
// valid ptr or 0, element size, is_float, out ptr: int64 or float64
// [cap]); tab: K24's int64[slots][ncols]; kmin: one int64 word on the
// device; live: bool[cap]. Returns cudaGetLastError(), or -1 when the
// table exceeds TABLE_MAX.
TT_EXPORT int agg_lookup(const void* table, int64_t nout, int64_t cap,
                         const void* num_rows, const void* tab, int64_t slots,
                         int64_t ncols, const void* kmin, void* live,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, KEY_FIELDS + OUT_FIELDS * nout, &t)) return -1;
  const int64_t words = slots * ncols;
  const size_t smem = words <= SMEM_WORDS ? (size_t)(8 * words) : 0;
  if (cap > 0)
    agg_lookup_kernel<<<grid_for(cap), THREADS, smem, s>>>(
        t, nout, cap, static_cast<const int32_t*>(num_rows),
        static_cast<const long long*>(tab), slots, ncols,
        static_cast<const int64_t*>(kmin), static_cast<bool*>(live));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K27
//
// Replaces trino_tpu/ops/join_mxu.py agg_join_post (:287), whose masks XLA
// fuses into one elementwise pass: per summed #valid-w helper column of
// the aggregated page, helper > 0 on its live rows, the validity of the
// build-side SUM it guards (the padding past num_rows is left unwritten).
// Bound on this card: bytes, each helper read once and each mask written
// once over the live rows — at the main path's call (G3: 16 live rows)
// a few hundred bytes, so the call is its host enqueue and one launch.
// So: one launch for any number of helpers, the (helper, mask) pointer
// pairs in a by-value parameter block sized to the call (8, 64 or 1,024
// helpers), a grid fixed by the capacity (ops: agg_post_grid) whose
// blocks stride the live rows read from num_rows on the device.
namespace {
constexpr int POST_THREADS = 256;

template <int H>
struct PostPairs {
  int64_t v[2 * H];  // helper ptr (int64 [cap]), mask ptr (bool [cap])
};

template <int H>
__global__ void __launch_bounds__(POST_THREADS)
    agg_post_kernel(const __grid_constant__ PostPairs<H> p, int nhelpers,
                    const int32_t* __restrict__ num_rows, int64_t cap) {
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  for (int64_t i = blockIdx.x * (int64_t)POST_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * POST_THREADS)
    for (int j = 0; j < nhelpers; ++j)
      reinterpret_cast<bool*>(p.v[2 * j + 1])[i] =
          reinterpret_cast<const int64_t*>(p.v[2 * j])[i] > 0;
}

template <int H>
int post_launch(const void* table, int64_t nhelpers, const void* num_rows,
                int64_t cap, int64_t grid, cudaStream_t s) {
  thread_local static PostPairs<H> p;  // each launch copies it
  const int64_t* src = static_cast<const int64_t*>(table);
  for (int64_t i = 0; i < 2 * nhelpers; ++i) p.v[i] = src[i];
  agg_post_kernel<H><<<(unsigned)grid, POST_THREADS, 0, s>>>(
      p, (int)nhelpers, static_cast<const int32_t*>(num_rows), cap);
  return (int)cudaGetLastError();
}
}  // namespace

// table: int64 HOST array, 2 words per helper (helper ptr: int64 [cap];
// mask ptr: bool [cap]); num_rows: int32 on the device; grid >= 1 blocks.
// Returns cudaGetLastError(), or -1 for no helper or more than
// TABLE_MAX / 2.
TT_EXPORT int agg_post(const void* table, int64_t nhelpers,
                       const void* num_rows, int64_t cap, int64_t grid,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhelpers < 1 || grid < 1) return -1;
  if (nhelpers <= 8)
    return post_launch<8>(table, nhelpers, num_rows, cap, grid, s);
  if (nhelpers <= 64)
    return post_launch<64>(table, nhelpers, num_rows, cap, grid, s);
  if (nhelpers <= TABLE_MAX / 2)
    return post_launch<TABLE_MAX / 2>(table, nhelpers, num_rows, cap, grid,
                                      s);
  return -1;
}
