// Shared helpers of the package's CUDA kernels (plain C interface, no
// PyTorch headers: each .cu builds with nvcc alone in seconds).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

// Pointer and size tables travel by value as a kernel parameter (CUDA 12.1+
// accepts 32,764 bytes of parameters): a host-to-device copy of the table
// would make every launch wait for the stream, and pinning a staging buffer
// per launch costs more host time than the kernels themselves. Kernels take
// it as `const __grid_constant__ Table`, so indexing reads parameter space
// in place.
constexpr int TABLE_MAX = 2048;
struct Table {
  int64_t v[TABLE_MAX];
};

// Fill `t` from a host array; non-zero when it does not fit.
inline int load_table(const void* host, int64_t len, Table* t) {
  if (len < 0 || len > TABLE_MAX) return 1;
  const int64_t* src = static_cast<const int64_t*>(host);
  for (int64_t i = 0; i < len; ++i) t->v[i] = src[i];
  return 0;
}

// A by-value parameter block of N words, for launchers that size it to
// the call (8, 64 or TABLE_MAX words: an empty kernel with 2,048 words
// costs the host about twice what one with a few words does).
template <int N>
struct ParamBlock {
  int64_t v[N];
};

// The smallest block of 8, 64 or TABLE_MAX words that holds `len` words,
// 0 past TABLE_MAX.
inline int param_block_words(int64_t len) {
  if (len <= 8) return 8;
  if (len <= 64) return 64;
  return len <= TABLE_MAX ? TABLE_MAX : 0;
}

template <int N>
inline void load_block(const void* host, int64_t len, ParamBlock<N>* b) {
  const int64_t* src = static_cast<const int64_t*>(host);
  for (int64_t i = 0; i < len; ++i) b->v[i] = src[i];
}

// Copy one row of `rb` bytes: an element of 1, 2, 4 or 8 bytes, or (K32)
// one row of a [cap, L] list plane, moved in the widest word that divides
// the row (16 bytes for 8-byte elements at even L). Rows start at
// multiples of rb inside 256-byte-aligned allocations, so every word is
// aligned.
__device__ __forceinline__ void copy_elem(const void* src, int64_t si,
                                          void* dst, int64_t di, int64_t rb) {
  switch (rb) {
    case 8: static_cast<uint64_t*>(dst)[di] =
        static_cast<const uint64_t*>(src)[si]; return;
    case 4: static_cast<uint32_t*>(dst)[di] =
        static_cast<const uint32_t*>(src)[si]; return;
    case 2: static_cast<uint16_t*>(dst)[di] =
        static_cast<const uint16_t*>(src)[si]; return;
    case 1: static_cast<uint8_t*>(dst)[di] =
        static_cast<const uint8_t*>(src)[si]; return;
    default: break;
  }
  const char* s = static_cast<const char*>(src) + si * rb;
  char* d = static_cast<char*>(dst) + di * rb;
  if ((rb & 15) == 0) {
    for (int64_t w = 0; w < rb / 16; ++w)
      reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(s)[w];
  } else if ((rb & 7) == 0) {
    for (int64_t w = 0; w < rb / 8; ++w)
      reinterpret_cast<uint64_t*>(d)[w] =
          reinterpret_cast<const uint64_t*>(s)[w];
  } else if ((rb & 3) == 0) {
    for (int64_t w = 0; w < rb / 4; ++w)
      reinterpret_cast<uint32_t*>(d)[w] =
          reinterpret_cast<const uint32_t*>(s)[w];
  } else {
    for (int64_t w = 0; w < rb; ++w) d[w] = s[w];
  }
}

// K2's padded row copy: a source row of `srb` bytes into a destination row
// of `drb` >= srb bytes (a narrower page's plane), zeros past the source.
// Row widths of one column share their element size, so both are
// multiples of it.
__device__ __forceinline__ void copy_row_padded(const void* src, int64_t si,
                                                int64_t srb, void* dst,
                                                int64_t di, int64_t drb) {
  if (srb == drb) {
    copy_elem(src, si, dst, di, drb);
    return;
  }
  const char* s = static_cast<const char*>(src) + si * srb;
  char* d = static_cast<char*>(dst) + di * drb;
  if (((srb | drb) & 7) == 0) {
    for (int64_t w = 0; w < drb / 8; ++w)
      reinterpret_cast<uint64_t*>(d)[w] =
          8 * w < srb ? reinterpret_cast<const uint64_t*>(s)[w] : 0;
  } else if (((srb | drb) & 3) == 0) {
    for (int64_t w = 0; w < drb / 4; ++w)
      reinterpret_cast<uint32_t*>(d)[w] =
          4 * w < srb ? reinterpret_cast<const uint32_t*>(s)[w] : 0;
  } else {
    for (int64_t w = 0; w < drb; ++w) d[w] = w < srb ? s[w] : 0;
  }
}

// Exclusive prefix sum of one value per thread (int or long long) across a
// block whose size is a multiple of 32 (at most 1024). `warp_sums` holds 32
// values of shared memory. Returns the thread's exclusive prefix; *total
// gets the block sum.
template <class T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_sums,
                                                  T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive prefix of warp totals
  }
  __syncthreads();
  const T before = warp ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums may be reused by the caller's next round
  return before + x - v;
}

// Element i of an integer column of `esz` bytes, sign-extended to int64
// (bool columns are 1-byte 0/1).
__device__ __forceinline__ int64_t load_int(const void* p, int64_t i,
                                            int esz) {
  switch (esz) {
    case 8: return static_cast<const int64_t*>(p)[i];
    case 4: return static_cast<const int32_t*>(p)[i];
    case 2: return static_cast<const int16_t*>(p)[i];
    default: return static_cast<const int8_t*>(p)[i];
  }
}

// Element i of a float32 (esz 4) or float64 column, as a double.
__device__ __forceinline__ double load_float(const void* p, int64_t i,
                                             int esz) {
  return esz == 4 ? (double)static_cast<const float*>(p)[i]
                  : static_cast<const double*>(p)[i];
}

// splitmix64 finalizer: trino_tpu/ops/join.py _mix64.
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

constexpr uint64_t KEY_MIX = 0x9E3779B97F4A7C15ULL;

// One join-key column as trino_tpu/ops/join.py _key_u64 widens it: an
// integer sign-extended to 64 bits, a float as its float64 bits with -0.0
// made +0.0 (NaN keeps its bits).
__device__ __forceinline__ uint64_t key_bits(const void* p, int64_t i,
                                             int esz, int is_float) {
  if (is_float) {
    const double x = load_float(p, i, esz);
    return (uint64_t)__double_as_longlong(x == 0.0 ? 0.0 : x);
  }
  return (uint64_t)load_int(p, i, esz);
}

// The join key of row i over `nkeys` columns described by `cols` (4 words
// each: values ptr, valid ptr (0 = none), element size, is_float): one
// column's bits, or the reference's mix of several. *null is set when any
// column is NULL.
__device__ __forceinline__ uint64_t join_key(const int64_t* cols,
                                             int64_t nkeys, int64_t i,
                                             bool* null) {
  bool isnull = false;
  uint64_t acc = 0;
  for (int64_t q = 0; q < nkeys; ++q) {
    const int64_t* c = cols + 4 * q;
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
    if (valid != nullptr && !valid[i]) isnull = true;
    const uint64_t k = key_bits(reinterpret_cast<const void*>(c[0]), i,
                                (int)c[2], (int)c[3]);
    if (nkeys == 1) {
      acc = k;
    } else {
      acc = mix64(acc ^ mix64(k) ^ (acc * KEY_MIX));
    }
  }
  *null = isnull;
  return acc;
}

// Probe column value at row i == build column value at row b, compared as
// the reference's `==` on the two value arrays (numeric, so -0.0 == +0.0
// and NaN matches nothing); columns described as in join_key.
__device__ __forceinline__ double key_as_double(const int64_t* c, int64_t i) {
  const void* p = reinterpret_cast<const void*>(c[0]);
  return c[3] ? load_float(p, i, (int)c[2])
               : (double)load_int(p, i, (int)c[2]);
}

__device__ __forceinline__ bool same_value(const int64_t* pc, int64_t i,
                                           const int64_t* bc, int64_t b) {
  if (pc[3] || bc[3]) return key_as_double(pc, i) == key_as_double(bc, b);
  return load_int(reinterpret_cast<const void*>(pc[0]), i, (int)pc[2]) ==
         load_int(reinterpret_cast<const void*>(bc[0]), b, (int)bc[2]);
}

// Every key column of probe row i equals build row b (the composite-key
// check: the mixed 64-bit key of two distinct tuples can coincide).
__device__ __forceinline__ bool same_keys(const int64_t* pcols,
                                          const int64_t* bcols, int64_t nkeys,
                                          int64_t i, int64_t b) {
  for (int64_t q = 0; q < nkeys; ++q)
    if (!same_value(pcols + 4 * q, i, bcols + 4 * q, b)) return false;
  return true;
}

// The slot holding `key` in K5's open-addressing table (csrc/join_build.cu:
// power-of-two slots, linear probing from mix64(key), row -1 = empty), or
// -1 when the key is absent. Read only after the build kernel has ended.
__device__ __forceinline__ int64_t hash_find(uint64_t key,
                                             const int64_t* slot_keys,
                                             const int32_t* slot_rows,
                                             int64_t slots) {
  const uint64_t mask = (uint64_t)slots - 1;
  uint64_t s = mix64(key) & mask;
  while (true) {
    if (slot_rows[s] == -1) return -1;
    if ((uint64_t)slot_keys[s] == key) return (int64_t)s;
    s = (s + 1) & mask;
  }
}

// The entry of a direct-address table of `size` slots from kmin for `key`
// (K5's dense mode), INT32_MAX when the key lies outside the span.
__device__ __forceinline__ int32_t dense_find(uint64_t key, uint64_t kmin,
                                              const int32_t* dense,
                                              int64_t size) {
  const int64_t raw = (int64_t)(key - kmin);
  return (raw >= 0 && raw < size) ? dense[raw] : 0x7fffffff;
}

// The lookup a probe takes (trino_tpu_torch/ops/join.py ROUTE_CODE): K5's
// hash table, a direct-address table, or the `mxu` route's table of
// (count, first) pairs (csrc/join_mxu.cu).
enum Route { ROUTE_SEARCH = 0, ROUTE_DENSE = 1, ROUTE_MXU = 2 };

// K13, the `mxu` route's lookup (trino_tpu/ops/join_mxu.py matmul_lookup):
// the match count of `key` in a table of `size` (count, first) pairs from
// kmin, 0 outside the span (a key below kmin wraps to a huge difference);
// *first gets the entry's first position when the count is not 0.
__device__ __forceinline__ int32_t mxu_find(uint64_t key, uint64_t kmin,
                                            const int32_t* table,
                                            int64_t size, int32_t* first) {
  const int64_t raw = (int64_t)(key - kmin);
  if (raw < 0 || raw >= size) return 0;
  const int32_t c = table[2 * raw];
  if (c) *first = table[2 * raw + 1];
  return c;
}

// Tables of at most this many slots (48 KB of pairs: the default
// mxu_join_max_slots of 4,096 gives 32 KB) are staged into each block's
// dynamic shared memory; a larger one is read where it lies (L2).
constexpr int64_t MXU_SMEM_SLOTS = 6144;

inline size_t mxu_smem_bytes(int route, int64_t size) {
  return route == ROUTE_MXU && size <= MXU_SMEM_SLOTS
             ? (size_t)(8 * size) : 0;
}

// Every thread of the block calls it: the table the block reads — `smem`
// filled from `table` when it fits, else `table` itself.
__device__ __forceinline__ const int32_t* mxu_stage(const int32_t* table,
                                                    int64_t size,
                                                    int32_t* smem) {
  if (size > MXU_SMEM_SLOTS) return table;
  for (int64_t j = threadIdx.x; j < 2 * size; j += blockDim.x)
    smem[j] = table[j];
  __syncthreads();
  return smem;
}

// Sum of a 64-bit value over the warp (result valid in lane 0).
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- order keys

// float64 -> int64 with the same order (-0.0 < +0.0; NaN is handled apart
// by each caller), so min/max of floats run as atomicMin/atomicMax on
// integers. trino_tpu_torch/ops/aggregate.py ordered_key is the same map.
__device__ __forceinline__ long long ordered_key(double x) {
  long long b = __double_as_longlong(x);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double from_key(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ 0x7fffffffffffffffLL));
}

// Order keys of +inf and -inf: the identities of a float min and max.
__device__ __forceinline__ long long key_pos_inf() {
  return ordered_key(__longlong_as_double(0x7ff0000000000000LL));
}
__device__ __forceinline__ long long key_neg_inf() {
  return ordered_key(__longlong_as_double((long long)0xfff0000000000000ULL));
}

// ------------------------------------------------- aggregate states (K3, K8)

enum AggKind { SUM = 0, COUNT = 1, MIN = 2, MAX = 3 };
// per state in a pointer table: value ptr (int64/float64 bits; unused by
// COUNT), valid ptr, mask ptr (0 = none), kind, is_float
constexpr int STATE_FIELDS = 5;

// Initial 8-byte word of a state: sums and counts 0 (0.0 has all bits
// zero), min/max the largest/smallest value (an order key for floats).
__device__ __forceinline__ unsigned long long agg_identity(int kind,
                                                           int is_float) {
  if (kind == MIN)
    return is_float ? (unsigned long long)key_pos_inf()
                    : 0x7fffffffffffffffULL;
  if (kind == MAX)
    return is_float ? (unsigned long long)key_neg_inf()
                    : 0x8000000000000000ULL;
  return 0ULL;
}

// One reduction step of `kind` into the 8-byte word at `dst`: int64 sums
// and counts as wrapping adds (exact), float64 sums with atomicAdd(double),
// min/max on int64 values or order keys.
__device__ __forceinline__ void agg_fold(unsigned long long* dst, int kind,
                                         int is_float, unsigned long long v) {
  if (kind == MIN)
    atomicMin(reinterpret_cast<long long*>(dst), (long long)v);
  else if (kind == MAX)
    atomicMax(reinterpret_cast<long long*>(dst), (long long)v);
  else if (kind == SUM && is_float)
    atomicAdd(reinterpret_cast<double*>(dst),
              __longlong_as_double((long long)v));
  else
    atomicAdd(dst, v);
}

// Folds row i of the k states described by `st` into the slot's words
// `acc` (k of them); a NaN in a float min/max sets its flag in `nan`
// instead (the reference's segment_min/max propagate NaN).
__device__ __forceinline__ void agg_fold_row(const int64_t* st, int64_t k,
                                             int64_t i,
                                             unsigned long long* acc,
                                             int32_t* nan) {
  for (int64_t j = 0; j < k; ++j) {
    const int64_t* s = st + j * STATE_FIELDS;
    const uint8_t* v = reinterpret_cast<const uint8_t*>(s[1]);
    const uint8_t* m = reinterpret_cast<const uint8_t*>(s[2]);
    if ((v != nullptr && !v[i]) || (m != nullptr && !m[i])) continue;
    const int kind = (int)s[3];
    if (kind == COUNT) {
      atomicAdd(acc + j, 1ULL);
      continue;
    }
    const int is_float = (int)s[4];
    const int64_t bits = reinterpret_cast<const int64_t*>(s[0])[i];
    if (kind != SUM && is_float) {
      const double x = __longlong_as_double(bits);
      if (x != x) {
        nan[j] = 1;
        continue;
      }
      agg_fold(acc + j, kind, 0, (unsigned long long)ordered_key(x));
    } else {
      agg_fold(acc + j, kind, is_float, (unsigned long long)bits);
    }
  }
}

// A state's final word: a float min/max decoded from its order key, NaN
// where flagged; every other state as accumulated.
__device__ __forceinline__ unsigned long long agg_result(
    int kind, int is_float, unsigned long long v, int32_t nan) {
  if (!is_float || (kind != MIN && kind != MAX)) return v;
  return nan ? 0x7ff8000000000000ULL
             : (unsigned long long)__double_as_longlong(from_key((long long)v));
}
