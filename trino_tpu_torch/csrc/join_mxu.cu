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
// K24, K25, K26 and K27: the aggregating join (B11b), below.
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
// key not NULL, cnt > 0) that K1 compacts by. Bound on this card: bytes —
// the live rows' probe key and value columns read once, every derived
// column and the mask written once over the live rows.
//
// One launch (agg_lookup_kernel, below): only the rows below num_rows (read
// on the device) are computed, outputs and mask alike; the padding past
// them is left unwritten, as K27's is, since K1 reads i < num_rows only
// (csrc/compact.cu Keep). The grid is fixed by the capacity and the SM
// count (ops: agg_lookup_grid) and its blocks stride the live rows, two
// consecutive rows a thread (an integer pair of the key or a probe column
// read in one load), so a table of at most SMEM_WORDS words (48 KB)
// is staged in shared memory once per resident block, as K13 stages its
// table; a larger one (G2 at sf1: 32,768 slots x 4 = 1 MiB) is read where
// it lies, through L2. The outputs are the rows of one int64 (nout,
// stride) block (a float64 column holds its bits), stride even, so a
// thread stores its two rows of an output as one 16-byte word. The key
// column and the output descriptors travel in a by-value block sized to
// the call (LookupDesc of 8, 64 or LK_MAX outputs); an output's op is the
// same for every thread.
namespace {
enum Vec { VEC_CNT = 0, VEC_SUM_I = 1, VEC_SUM_F = 2, VEC_VALIDCNT = 3 };
enum Op {
  OP_PAIRS = 0, OP_CNTP = 1, OP_SUMP_I = 2, OP_SUMP_F = 3, OP_TABLE_I = 4,
  OP_TABLE_F = 5
};
constexpr int VEC_FIELDS = 5;   // kind, values ptr, valid ptr, esz, is_float
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

namespace {
constexpr int LK_THREADS = 256;
constexpr int LK_ROWS = 2;       // consecutive rows a thread
constexpr int LK_FIELDS = 6;     // op, table column, values, valid, esz,
                                 // is_float
constexpr int LK_MAX = (TABLE_MAX - KEY_FIELDS) / LK_FIELDS;  // 340 outputs
int64_t lookup_enqueues = 0;     // launches agg_lookup enqueued

template <int H>
struct LookupDesc {
  int64_t key[KEY_FIELDS];
  int64_t out[LK_FIELDS * H];
};

// Elements i0 and i0 + 1 (i0 even) of an integer column of `esz` bytes,
// sign-extended: one 16- or 8-byte load where the column is aligned so.
__device__ __forceinline__ void load_int_pair(const void* p, int64_t i0,
                                              int esz, int64_t* a,
                                              int64_t* b) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (esz == 8 && (at & 15) == 0) {
    const longlong2 v = reinterpret_cast<const longlong2*>(p)[i0 >> 1];
    *a = v.x;
    *b = v.y;
  } else if (esz == 4 && (at & 7) == 0) {
    const int2 v = reinterpret_cast<const int2*>(p)[i0 >> 1];
    *a = v.x;
    *b = v.y;
  } else {
    *a = load_int(p, i0, esz);
    *b = load_int(p, i0 + 1, esz);
  }
}

// Bytes i0 and i0 + 1 (i0 even) of a validity column.
__device__ __forceinline__ void load_valid_pair(const uint8_t* v, int64_t i0,
                                                bool* a, bool* b) {
  if ((reinterpret_cast<uintptr_t>(v) & 1) == 0) {
    const uchar2 x = reinterpret_cast<const uchar2*>(v)[i0 >> 1];
    *a = x.x;
    *b = x.y;
  } else {
    *a = v[i0];
    *b = v[i0 + 1];
  }
}

// The join keys of probe rows i0 and i0 + 1 over one key column (join_key
// of csrc/common.cuh), an integer pair in one load; `two` false: row i0
// alone (the second NULL).
__device__ __forceinline__ void key_pair(const int64_t* c, int64_t i0,
                                         bool two, uint64_t* k, bool* null) {
  if (!two) {
    k[0] = join_key(c, 1, i0, &null[0]);
    k[1] = 0;
    null[1] = true;
    return;
  }
  const void* v = reinterpret_cast<const void*>(c[0]);
  if (c[3]) {
    k[0] = key_bits(v, i0, (int)c[2], 1);
    k[1] = key_bits(v, i0 + 1, (int)c[2], 1);
  } else {
    int64_t a, b;
    load_int_pair(v, i0, (int)c[2], &a, &b);
    k[0] = (uint64_t)a;
    k[1] = (uint64_t)b;
  }
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  bool va = true, vb = true;
  if (valid != nullptr) load_valid_pair(valid, i0, &va, &vb);
  null[0] = !va;
  null[1] = !vb;
}

// One output's values at probe rows i0 and i0 + 1 (the second only when
// `two`), given their table rows and counts.
__device__ __forceinline__ void lookup_pair(const int64_t* o, int64_t i0,
                                            bool two, const long long* cnt,
                                            const long long* const* row,
                                            const bool* inb, long long* v) {
  const void* p = reinterpret_cast<const void*>(o[2]);
  const int esz = (int)o[4];
  switch ((int)o[0]) {
    case OP_PAIRS:
      v[0] = cnt[0];
      v[1] = cnt[1];
      return;
    case OP_CNTP: {
      const uint8_t* valid = reinterpret_cast<const uint8_t*>(o[3]);
      bool a = true, b = true;
      if (valid != nullptr) {
        if (two)
          load_valid_pair(valid, i0, &a, &b);
        else
          a = valid[i0];
      }
      v[0] = a ? cnt[0] : 0;
      v[1] = b ? cnt[1] : 0;
      return;
    }
    case OP_SUMP_I: {
      int64_t a, b = 0;
      if (two)
        load_int_pair(p, i0, esz, &a, &b);
      else
        a = load_int(p, i0, esz);
      v[0] = (long long)((unsigned long long)a * (unsigned long long)cnt[0]);
      v[1] = (long long)((unsigned long long)b * (unsigned long long)cnt[1]);
      return;
    }
    case OP_SUMP_F:
      v[0] = __double_as_longlong(load_float(p, i0, esz) * (double)cnt[0]);
      v[1] = two ? __double_as_longlong(load_float(p, i0 + 1, esz) *
                                        (double)cnt[1])
                 : 0;
      return;
    default:  // OP_TABLE_I, OP_TABLE_F: the word, float64 bits as they are
      v[0] = inb[0] ? row[0][o[1]] : 0;
      v[1] = inb[1] ? row[1][o[1]] : 0;
      return;
  }
}

// outs: int64 [nout][stride] (stride even, outs 16-byte aligned); live:
// bool [cap]. Rows at and past num_rows are not written.
template <int H>
__global__ void __launch_bounds__(LK_THREADS) agg_lookup_kernel(
    const __grid_constant__ LookupDesc<H> p, int nout, int64_t cap,
    const int32_t* __restrict__ num_rows, const long long* __restrict__ table,
    int64_t slots, int64_t ncols, const int64_t* __restrict__ kmin_p,
    long long* __restrict__ outs, int64_t stride, bool* __restrict__ live) {
  extern __shared__ long long stab[];
  const int64_t n = clamp_rows(num_rows, cap);
  const int64_t step = (int64_t)LK_THREADS * LK_ROWS;
  if ((int64_t)blockIdx.x * step >= n) return;  // no live row for the block
  const long long* t = table;
  const int64_t words = slots * ncols;
  if (words <= SMEM_WORDS) {
    for (int64_t j = threadIdx.x; j < words; j += LK_THREADS)
      stab[j] = table[j];
    __syncthreads();
    t = stab;
  }
  const uint64_t kmin = (uint64_t)*kmin_p;
  for (int64_t i0 = ((int64_t)blockIdx.x * LK_THREADS + threadIdx.x) *
                    LK_ROWS;
       i0 < n; i0 += (int64_t)gridDim.x * step) {
    const bool two = i0 + 1 < n;
    uint64_t key[LK_ROWS];
    long long cnt[LK_ROWS];
    const long long* row[LK_ROWS];
    bool null[LK_ROWS], inb[LK_ROWS], ok[LK_ROWS];
    key_pair(p.key, i0, two, key, null);
#pragma unroll
    for (int k = 0; k < LK_ROWS; ++k) {
      const int64_t raw = (int64_t)(key[k] - kmin);
      inb[k] = raw >= 0 && raw < slots;
      row[k] = t + (inb[k] ? raw : 0) * ncols;
      cnt[k] = inb[k] ? row[k][0] : 0;
      ok[k] = !null[k] && cnt[k] > 0;
    }
    if (two) {
      reinterpret_cast<uchar2*>(live)[i0 >> 1] =
          make_uchar2(ok[0], ok[1]);
    } else {
      live[i0] = ok[0];
    }
    for (int q = 0; q < nout; ++q) {
      const int64_t* o = p.out + LK_FIELDS * q;
      long long* out = outs + q * stride;
      long long v[LK_ROWS];
      lookup_pair(o, i0, two, cnt, row, inb, v);
      if (two) {
        reinterpret_cast<longlong2*>(out)[i0 >> 1] = make_longlong2(v[0],
                                                                    v[1]);
      } else {
        out[i0] = v[0];
      }
    }
  }
}

template <int H>
int lookup_launch(const void* host, int64_t nout, int64_t cap,
                  const void* num_rows, const void* tab, int64_t slots,
                  int64_t ncols, const void* kmin, void* outs, int64_t stride,
                  void* live, int64_t grid, cudaStream_t s) {
  thread_local static LookupDesc<H> d;  // each launch copies it
  const int64_t* src = static_cast<const int64_t*>(host);
  for (int f = 0; f < KEY_FIELDS; ++f) d.key[f] = src[f];
  for (int64_t i = 0; i < LK_FIELDS * nout; ++i)
    d.out[i] = src[KEY_FIELDS + i];
  const int64_t words = slots * ncols;
  const size_t smem = words <= SMEM_WORDS ? (size_t)(8 * words) : 0;
  agg_lookup_kernel<H><<<(unsigned)grid, LK_THREADS, smem, s>>>(
      d, (int)nout, cap, static_cast<const int32_t*>(num_rows),
      static_cast<const long long*>(tab), slots, ncols,
      static_cast<const int64_t*>(kmin), static_cast<long long*>(outs),
      stride, static_cast<bool*>(live));
  ++lookup_enqueues;
  return (int)cudaGetLastError();
}
}  // namespace

// table: int64 HOST array: the probe key column's KEY_FIELDS words, then
// LK_FIELDS words per output column (op, table column, values ptr or 0,
// valid ptr or 0, element size, is_float); tab: K24's int64[slots][ncols];
// kmin: one int64 word on the device; outs: int64 [nout][stride] on the
// device (stride even, outs 16-byte aligned: output q is row q, a float64
// column as its bits); live: bool[cap], 2-byte aligned; grid >= 1 blocks
// (ops: agg_lookup_grid). One launch. Returns cudaGetLastError(), or -1
// for more than LK_MAX outputs or a bad layout.
TT_EXPORT int agg_lookup(const void* table, int64_t nout, int64_t cap,
                         const void* num_rows, const void* tab, int64_t slots,
                         int64_t ncols, const void* kmin, void* outs,
                         int64_t stride, void* live, int64_t grid,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nout < 0 || nout > LK_MAX || grid < 1 || stride < cap ||
      (stride & 1) || (reinterpret_cast<uintptr_t>(outs) & 15) ||
      (reinterpret_cast<uintptr_t>(live) & 1))
    return -1;
  if (nout <= 8)
    return lookup_launch<8>(table, nout, cap, num_rows, tab, slots, ncols,
                            kmin, outs, stride, live, grid, s);
  if (nout <= 64)
    return lookup_launch<64>(table, nout, cap, num_rows, tab, slots, ncols,
                             kmin, outs, stride, live, grid, s);
  return lookup_launch<LK_MAX>(table, nout, cap, num_rows, tab, slots, ncols,
                               kmin, outs, stride, live, grid, s);
}

// The launches agg_lookup has enqueued in this process (chip_smoke.py
// counts them per call).
TT_EXPORT int64_t agg_lookup_enqueues() { return lookup_enqueues; }

// ------------------------------------------------------------------ K26
//
// Replaces trino_tpu/ops/join_mxu.py key_bounds (:201), a masked jnp.min
// and max over the key in uint64, and trino_tpu/ops/join.py
// build_key_bounds (:742), the dynamic filter's min and max in the key's
// own type, which the fused join reads from the same five words: over the
// live (below num_rows), non-NULL keys, B_KMIN and B_KMAX of the join key
// encoding in unsigned order (common.cuh key_bits: an integer
// sign-extended, a float as its float64 bits with -0.0 made +0.0), B_LO and
// B_HI in the column's own order (a float's over its non-NaN values, as
// float64 bits; NaN bits where it holds a NaN) and B_LO_NAN. Bound on this
// card: bytes, the live rows' key and validity read once, five words
// written. At the main path's call (G3's build: 1,500,000 live int64 keys,
// 12 MB) that is 3.6 us, so the call is its launches and the host's
// enqueue, and the design is ONE launch: a grid fixed by the capacity and
// the SM count (ops: key_bounds_grid, two blocks an SM: the fastest of
// one to four at G3's build) whose blocks stride the live prefix (rows
// past num_rows are never read), each thread taking KB_ROWS rows a round
// (their loads issued together) in the key's own width (1, 2, 4 or 8
// bytes; a float32 widened to float64 in a register) and reducing the
// five values in registers; then warp shuffles and one shared-memory step
// per block, whose thread 0 folds each of the block's five values that
// left its identity into per-device words (ops: _key_bounds_scratch) with
// one atomic min, max or or each, fences and takes a ticket; the block
// that takes the last writes the call's own five words from them and sets
// them and the ticket back. Min and max do not depend on the order of
// folding, so the words are exact in any block order. (On the card the
// atomics measured faster than per-block partials folded by the last
// block, and 16-byte loads of int64 pairs no faster than 8-byte ones.)
namespace {
constexpr int KB_THREADS = 256;
constexpr int KB_ROWS = 8;    // rows a thread reads a round
constexpr int KB_WORDS = 5;   // B_KMIN, B_KMAX, B_LO, B_HI, B_LO_NAN
constexpr long long KB_LO0 = 0x7fffffffffffffffLL;   // lo's identity
constexpr long long KB_HI0 = (long long)0x8000000000000000ULL;
int64_t bounds_enqueues = 0;  // launches key_bounds enqueued

struct Bounds {
  unsigned long long umin, umax;  // the join key encoding
  long long lo, hi;               // the value, or a float's order key
  int nan;
};

__device__ __forceinline__ void bounds_fold(Bounds& a, const Bounds& b) {
  a.umin = b.umin < a.umin ? b.umin : a.umin;
  a.umax = b.umax > a.umax ? b.umax : a.umax;
  a.lo = b.lo < a.lo ? b.lo : a.lo;
  a.hi = b.hi > a.hi ? b.hi : a.hi;
  a.nan |= b.nan;
}

// One live, non-NULL row into a: `bits` holds an integer, or a float's
// value widened to float64 (whose order keys lie strictly between the
// integer identities KB_HI0 and KB_LO0).
template <bool FLOAT>
__device__ __forceinline__ void bounds_add(Bounds& a, long long bits) {
  unsigned long long key = (unsigned long long)bits;
  long long own = bits;
  bool nan = false;
  if (FLOAT) {
    const double x = __longlong_as_double(bits);
    key = (unsigned long long)__double_as_longlong(x == 0.0 ? 0.0 : x);
    nan = x != x;
    own = nan ? a.lo : ordered_key(x);
  }
  a.umin = key < a.umin ? key : a.umin;
  a.umax = key > a.umax ? key : a.umax;
  if (nan) {
    a.nan = 1;
    return;
  }
  a.lo = own < a.lo ? own : a.lo;
  a.hi = own > a.hi ? own : a.hi;
}

// The fold of one Bounds per thread over the block, valid in thread 0.
__device__ __forceinline__ Bounds bounds_block(Bounds a, Bounds* warp_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Bounds b;
    b.umin = __shfl_xor_sync(0xffffffffu, a.umin, o);
    b.umax = __shfl_xor_sync(0xffffffffu, a.umax, o);
    b.lo = __shfl_xor_sync(0xffffffffu, a.lo, o);
    b.hi = __shfl_xor_sync(0xffffffffu, a.hi, o);
    b.nan = __shfl_xor_sync(0xffffffffu, a.nan, o);
    bounds_fold(a, b);
  }
  if (lane == 0) warp_b[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < KB_THREADS / 32; ++w) bounds_fold(a, warp_b[w]);
  return a;
}

// acc: the per-device words (the ticket in word 0's low half, then umin,
// umax, lo, hi and the NaN flag at their identities ~0, 0, KB_LO0, KB_HI0
// and 0) between calls; out: int64 [KB_WORDS].
template <bool FLOAT>
__global__ void __launch_bounds__(KB_THREADS)
    key_bounds_kernel(const void* __restrict__ values,
                      const uint8_t* __restrict__ valid, int esz,
                      const int32_t* __restrict__ num_rows, int64_t cap,
                      long long* __restrict__ acc,
                      long long* __restrict__ out) {
  __shared__ Bounds warp_b[KB_THREADS / 32];
  __shared__ bool last;
  const int64_t n = clamp_rows(num_rows, cap);
  const int64_t grid = gridDim.x;
  Bounds a = {~0ULL, 0ULL, KB_LO0, KB_HI0, 0};
  for (int64_t base = (int64_t)blockIdx.x * KB_THREADS * KB_ROWS +
                      threadIdx.x;
       base < n; base += grid * KB_THREADS * KB_ROWS) {
    long long bits[KB_ROWS];
#pragma unroll
    for (int r = 0; r < KB_ROWS; ++r) {
      const int64_t i = base + r * KB_THREADS;
      bits[r] = i >= n ? 0
                : FLOAT ? __double_as_longlong(load_float(values, i, esz))
                        : load_int(values, i, esz);
    }
#pragma unroll
    for (int r = 0; r < KB_ROWS; ++r) {
      const int64_t i = base + r * KB_THREADS;
      if (i < n && (valid == nullptr || valid[i]))
        bounds_add<FLOAT>(a, bits[r]);
    }
  }
  a = bounds_block(a, warp_b);
  unsigned* ticket = reinterpret_cast<unsigned*>(acc);
  unsigned long long* uacc = reinterpret_cast<unsigned long long*>(acc);
  if (threadIdx.x == 0) {
    // fire-and-forget reductions; a word at its identity is left alone
    if (a.umin != ~0ULL) atomicMin(uacc + 1, a.umin);
    if (a.umax) atomicMax(uacc + 2, a.umax);
    if (a.lo != KB_LO0) atomicMin(acc + 3, a.lo);
    if (a.hi != KB_HI0) atomicMax(acc + 4, a.hi);
    if (a.nan) atomicOr(uacc + 5, 1ULL);
    // the reductions are performed before the ticket counts this block
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)grid - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const unsigned long long umin = __ldcg(uacc + 1), umax = __ldcg(uacc + 2);
  const long long lo = __ldcg(acc + 3), hi = __ldcg(acc + 4);
  const long long nan = __ldcg(acc + 5);
  out[0] = (long long)umin;
  out[1] = (long long)umax;
  if (FLOAT) {
    // no non-NaN value: lo +inf, hi -inf; a NaN: NaN bits for both
    const long long nan_bits = 0x7ff8000000000000LL;
    out[2] = nan ? nan_bits
             : lo == KB_LO0 ? 0x7ff0000000000000LL
                            : __double_as_longlong(from_key(lo));
    out[3] = nan ? nan_bits
             : hi == KB_HI0 ? (long long)0xfff0000000000000ULL
                            : __double_as_longlong(from_key(hi));
  } else {
    out[2] = lo;
    out[3] = hi;
  }
  out[4] = nan;
  acc[1] = ~0LL;
  acc[2] = 0;
  acc[3] = KB_LO0;
  acc[4] = KB_HI0;
  acc[5] = 0;
  *ticket = 0;
}
}  // namespace

// values: the key column [cap] (1, 2, 4 or 8 bytes a value; bool as a
// byte; is_float: float32 or float64); valid: bool [cap] or 0; num_rows:
// int32 on the device; acc: the per-device int64 [6] on the
// device (word 0's low half the ticket, 0 between calls, then the five
// reductions at their identities; the last block resets all six); out:
// int64 [KB_WORDS]; grid >= 1 blocks. One launch. Returns
// cudaGetLastError(), or -1 on a bad element size or grid.
TT_EXPORT int key_bounds(const void* values, const void* valid, int64_t esz,
                         int64_t is_float, const void* num_rows, int64_t cap,
                         void* acc, void* out, int64_t grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || (esz != 1 && esz != 2 && esz != 4 && esz != 8) ||
      (is_float && esz < 4))
    return -1;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* nr = static_cast<const int32_t*>(num_rows);
  long long* a = static_cast<long long*>(acc);
  long long* o = static_cast<long long*>(out);
  if (is_float)
    key_bounds_kernel<true><<<(unsigned)grid, KB_THREADS, 0, s>>>(
        values, v, (int)esz, nr, cap, a, o);
  else
    key_bounds_kernel<false><<<(unsigned)grid, KB_THREADS, 0, s>>>(
        values, v, (int)esz, nr, cap, a, o);
  ++bounds_enqueues;
  return (int)cudaGetLastError();
}

// The launches key_bounds has enqueued in this process (chip_smoke.py
// counts them per call).
TT_EXPORT int64_t key_bounds_enqueues() { return bounds_enqueues; }

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
