// K33 and K34: the list layouts' kernels (ARRAY and MAP).
//
// K33 (collect_*) replaces trino_tpu/ops/aggregate.py group_max_size and
// _collect_grouped: array_agg, histogram and map_agg per group, packed
// into a list column (values [rows, L] + lengths, a MAP's values in an aux
// plane [rows, L]). Every launch reads the row -> group map of K8's
// group-id mode (K28, csrc/group_agg.cu), so a group's list lands on K8's
// output row. A row takes part when it is live (below num_rows) and every
// mask holds (the argument's validity, a second argument's, FILTER); the
// reference skips NULL inputs the same way. Three modes:
// * size: each group's live row count by atomics, and its maximum and
//   the group count in one two-number output (one fetch sizes the
//   aggregation's L and list rows);
// * array (array_agg): the reference ranks each eligible row among its
//   group's eligible rows in row order through its sort. Here the words
//   launch packs (group, not eligible) into K10's order-preserving word,
//   K10 sorts the live prefix stably (an atomic slot counter would
//   scramble the order), the bounds launch finds each group's first and
//   one-past-last eligible sorted position, and the pack launch writes
//   each eligible row's value at (group, position - first) while that is
//   below L; lengths = min(count, L);
// * map (histogram, map_agg): one entry per distinct key of a group in
//   ascending key order (NaN as +inf, -0.0 as +0.0: the reference's
//   _nan_as_largest and its `!=`, under which +-0.0 are one key), the
//   key its first row's value (NaN as +inf, the sign of a zero kept),
//   with histogram's count or map_agg's value of the key's first row in
//   the aux plane. Integer keys of a narrow span take a direct-address
//   (group, key - kmin) table in one launch; floats and wide spans sort
//   (group, key - kmin) packed into the bits they use with K10 between
//   two launches (see "map mode" below).
// Planes are zeroed past each list, as the reference's are.
//
// K34 (unnest_*) replaces trino_tpu/exec/local_planner.py _exec_UnnestNode's
// count and expand ops. Count: the live, non-NULL rows' lengths summed by
// the tiled count and scan (one number, fetched once per page to size the
// output at the next power of two). Expand: the same scan gives each row
// its exclusive offset, and each row writes its own range of output
// slots: source row, ordinal (1-based) and element (and the MAP value).
// The reference searchsorts each output slot into the offsets instead;
// the output is the same.
//
// Bound on this card: bytes. K33 reads the group ids, masks and the
// argument once per pass and writes each list once; K10's passes are
// K10's. The direct route reads them twice (the span, then the table)
// and writes the [rows, L] planes once. K34 reads the lengths twice (count, expand) and the live
// elements once, and writes 4 + 8 + the element bytes per output slot.
#include <cooperative_groups.h>

#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int MAX_MASKS = 6;
constexpr uint64_t SIGN = 0x8000000000000000ULL;

struct Masks {
  const uint8_t* m[MAX_MASKS];
  int count;
};

__device__ __forceinline__ bool passes(const Masks& mk, int64_t i) {
  for (int q = 0; q < mk.count; ++q)
    if (!mk.m[q][i]) return false;
  return true;
}

__device__ __forceinline__ int64_t clamp_rows(const int32_t* n_ptr,
                                              int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// The order key of an element: an integer as itself, a float (NaN as
// +inf, -0.0 as +0.0) through ordered_key.
__device__ __forceinline__ long long elem_key(const void* p, int64_t i,
                                              int esz, int is_float) {
  if (!is_float) return (long long)load_int(p, i, esz);
  double x = load_float(p, i, esz);
  if (x != x) x = __longlong_as_double(0x7FF0000000000000LL);
  if (x == 0.0) x = 0.0;
  return ordered_key(x);
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 2112 ? 2112 : blocks));
}

int masks_from(const void* host, int64_t count, Masks* mk) {
  if (count < 0 || count > MAX_MASKS) return 1;
  const int64_t* ptrs = static_cast<const int64_t*>(host);
  mk->count = (int)count;
  for (int q = 0; q < MAX_MASKS; ++q)
    mk->m[q] = q < count ? reinterpret_cast<const uint8_t*>(ptrs[q])
                         : nullptr;
  return 0;
}

// ------------------------------------------------------------ size mode

__global__ void sizes_kernel(const int32_t* gid, int64_t cap,
                             const int32_t* num_rows,
                             const int32_t* num_groups, int32_t* counts,
                             unsigned long long* out) {
  const int64_t n = clamp_rows(num_rows, cap);
  const int64_t G = *num_groups;
  int best = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = gid[i];
    if (g >= 0 && g < G) {
      const int c = atomicAdd(&counts[g], 1) + 1;
      best = c > best ? c : best;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, best, o);
    best = y > best ? y : best;
  }
  if ((threadIdx.x & 31) == 0 && best > 0)
    atomicMax(&out[0], (unsigned long long)best);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[1] = (unsigned long long)(G < 0 ? 0 : G);
}

// ------------------------------------------------- array and map modes

// words[i] = ((group << 32) | (not eligible << 31)) ^ SIGN.
__global__ void words_kernel(int64_t cap, const int32_t* num_rows,
                             const Masks mk, const int32_t* gid,
                             long long* words) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool elig = passes(mk, i);
    const uint64_t w0 = ((uint64_t)(uint32_t)gid[i] << 32) |
                        ((uint64_t)(elig ? 0 : 1) << 31);
    words[i] = (long long)(w0 ^ SIGN);
  }
}

__global__ void fill_kernel(long long* p, const int32_t* num_groups,
                            long long v) {
  const int64_t G = *num_groups;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x)
    p[g] = v;
}

// Over the sorted positions: start[g] and endp[g], the first and one past
// the last sorted position of the group's eligible rows (they lead the
// group: the not-eligible flag sorts after them).
__global__ void bounds_kernel(const int32_t* perm, int64_t cap,
                              const int32_t* num_rows, const Masks mk,
                              const int32_t* gid, long long* start,
                              long long* endp) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = perm[i];
    if (!passes(mk, r)) continue;
    const int32_t g = gid[r];
    if (i == 0 || gid[perm[i - 1]] != g) start[g] = i;
    if (i + 1 == n || gid[perm[i + 1]] != g || !passes(mk, perm[i + 1]))
      endp[g] = i + 1;
  }
}

__global__ void array_pack_kernel(const int32_t* perm, int64_t cap,
                                  const int32_t* num_rows, const Masks mk,
                                  const int32_t* gid, const long long* start,
                                  const void* x, int esz, int64_t L,
                                  void* plane) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = perm[i];
    if (!passes(mk, r)) continue;
    const int64_t g = gid[r];
    const int64_t ord = i - start[g];
    if (ord < L) copy_elem(x, r, plane, g * L + ord, esz);
  }
}

__global__ void lengths_kernel(const int32_t* num_groups,
                               const long long* start, const long long* endp,
                               int64_t L, int32_t* lengths) {
  const int64_t G = *num_groups;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    const long long c = endp[g] - start[g];
    lengths[g] = (int32_t)(c < L ? c : L);
  }
}

// The run's key (its first row's value; NaN as +inf, a zero's sign kept).
__device__ __forceinline__ void write_key(const void* x, int64_t r, int esz,
                                          int is_float, void* out,
                                          int64_t o) {
  if (is_float && esz == 8) {
    double v = static_cast<const double*>(x)[r];
    static_cast<double*>(out)[o] =
        v != v ? __longlong_as_double(0x7FF0000000000000LL) : v;
  } else if (is_float) {
    float v = static_cast<const float*>(x)[r];
    static_cast<float*>(out)[o] = v != v ? __int_as_float(0x7F800000) : v;
  } else {
    copy_elem(x, r, out, o, esz);
  }
}

// ------------------------------------------------------------ map mode
//
// Two cooperative kernels. map_prep_kernel folds the eligible keys' order
// keys to (kmin, kmax) over a grid barrier, then takes one of two routes
// for the whole call:
// * direct (integer keys, span = kmax - kmin + 1 at most MAP_DIRECT_SPAN
//   and G x span entries within the table; where the host knows the span,
//   a dictionary's codes, it passes kmin and the span and the fold is
//   skipped): the table [G, span] is set to its identity (0 counts for
//   histogram, INT32_MAX first rows for map_agg), every eligible row adds
//   one to its entry or takes the smallest row into it (one global atomic
//   per warp and entry by __match_any_sync), and after a barrier a warp
//   per output row walks
//   its group's span in key order, writes each present key (kmin + d) and
//   its count or map_agg's value at its first row, zeros past the list
//   and the length: a list row is written once, and K10 sorts nothing
//   (sort_n = 0);
// * sort (floats, wide spans): each live row's word (code = the group, G
//   for a row that takes no part; d = order key - kmin), packed as
//   (code << kbits) | d in one word when the bits fit, else d and code in
//   two; sort_n = num_rows. K10 then sorts the live prefix over the bytes
//   the host can bound (its passes over bytes no row sets return at once),
//   and map_pack_kernel walks the sorted positions in tiles of
//   MAP_TILE: a run of equal (code, d) is one entry, its index from a
//   block scan and the tiles before it; the run's end writes the key (its
//   first row's value, NaN as +inf, a zero's sign kept), the run length
//   or map_agg's value of its first row, and the group's length; a last
//   pass zeros each list row past its length.
// The host picks the route where it can (a dictionary's size bounds the
// span: one launch), else launches all three and the one that does not
// apply returns at once.
constexpr int MAP_THREADS = 256;
constexpr int64_t MAP_DIRECT_SPAN = 4096;
constexpr int MAP_MAX_GRID = 2048;
constexpr int MAP_RUN = 4;      // consecutive sorted positions a thread takes
constexpr int MAP_TILE = MAP_THREADS * MAP_RUN;  // positions a pack tile takes
constexpr int64_t MAP_ITEMS = 4;  // rows a thread takes a round
enum MapRoute { ROUTE_DIRECT = 0, ROUTE_AUTO = 1, ROUTE_SORT = 2 };
enum MapInfo { INFO_SORTED = 0, INFO_KMIN, INFO_KBITS, INFO_PACKED,
               INFO_WORDS };

// The order key map mode compares: an integer as itself; a float with NaN
// as +inf and -0.0 as +0.0, a float32 through its own 32 bits (so its
// span fits 32 bits), a float64 through ordered_key.
__device__ __forceinline__ long long map_key(const void* x, int64_t i,
                                             int esz, int is_float) {
  if (!is_float) return (long long)load_int(x, i, esz);
  if (esz == 4) {
    float f = static_cast<const float*>(x)[i];
    if (f != f) f = __int_as_float(0x7F800000);
    if (f == 0.0f) f = 0.0f;
    const int b = __float_as_int(f);
    return (long long)(b >= 0 ? b : b ^ 0x7fffffff);
  }
  return elem_key(x, i, 8, 1);
}

__device__ __forceinline__ void store_int(void* p, int64_t o, int esz,
                                          long long v) {
  switch (esz) {
    case 8: static_cast<long long*>(p)[o] = v; return;
    case 4: static_cast<int32_t*>(p)[o] = (int32_t)v; return;
    case 2: static_cast<int16_t*>(p)[o] = (int16_t)v; return;
    default: static_cast<int8_t*>(p)[o] = (int8_t)v; return;
  }
}

__device__ __forceinline__ int bits_of(unsigned long long v) {
  return v ? 64 - __clzll((long long)v) : 0;
}

// Zeros over bytes [lo, hi) of `p` (16-byte aligned) by the 32 lanes of
// a warp: 16-byte stores between the aligned ends, bytes at the ends.
__device__ __forceinline__ void zero_bytes(char* p, int64_t lo, int64_t hi,
                                           int lane) {
  const int64_t a = (lo + 15) & ~(int64_t)15, b = hi & ~(int64_t)15;
  const int64_t head = a < hi ? a : hi;
  for (int64_t x = lo + lane; x < head; x += 32) p[x] = 0;
  for (int64_t x = a + 16 * lane; x < b; x += 512)
    *reinterpret_cast<uint4*>(p + x) = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t x = (b > a ? b : a) + lane; x < hi; x += 32) p[x] = 0;
}

// (min, max) of the block into lo and hi of thread 0.
__device__ __forceinline__ void block_minmax(long long* lo, long long* hi,
                                             long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long a = __shfl_xor_sync(0xffffffffu, *lo, o);
    const long long b = __shfl_xor_sync(0xffffffffu, *hi, o);
    *lo = a < *lo ? a : *lo;
    *hi = b > *hi ? b : *hi;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh[2 * warp] = *lo;
    sh[2 * warp + 1] = *hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      *lo = sh[2 * w] < *lo ? sh[2 * w] : *lo;
      *hi = sh[2 * w + 1] > *hi ? sh[2 * w + 1] : *hi;
    }
  }
  __syncthreads();
}

struct MapArgs {
  const void* x;
  int esz, is_float;
  const void* x2;  // null for histogram
  int esz2;
  int64_t cap;
  const int32_t* num_rows;
  Masks mk;
  const int32_t* gid;
  const int32_t* num_groups;
  int64_t L, rows;
  int route;
  long long kmin, span;  // the host's span on the direct route
  int32_t* table;  // [table_cap] (direct route)
  int64_t table_cap;
  long long* words;  // [nw, cap] (sort route)
  int nw;
  int32_t* sort_n;
  long long* info;      // MapInfo words
  long long* partials;  // 2 per block
  void* keys;
  void* aux;
  int32_t* lengths;
};

__global__ void __launch_bounds__(MAP_THREADS)
    map_prep_kernel(const __grid_constant__ MapArgs a) {
  __shared__ long long sh[64];
  __shared__ long long bounds[2];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t t = blockIdx.x * (int64_t)MAP_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * MAP_THREADS;
  const int64_t n = clamp_rows(a.num_rows, a.cap);
  int64_t G = *a.num_groups;
  G = G < 0 ? 0 : (G > a.rows ? a.rows : G);
  const bool hist = a.x2 == nullptr;

  // the eligible keys' (kmin, kmax), or on the direct route the span the
  // host knows ([kmin, kmin + span): a dictionary's codes)
  long long lo = 0x7fffffffffffffffLL, hi = (long long)0x8000000000000000ULL;
  if (a.route == ROUTE_DIRECT) {
    lo = a.kmin;
    hi = a.kmin + a.span - 1;
  }
  for (int64_t first = a.route == ROUTE_DIRECT ? n : t; first < n;
       first += MAP_ITEMS * stride) {
#pragma unroll
    for (int k = 0; k < MAP_ITEMS; ++k) {
      const int64_t i = first + k * stride;
      if (i >= n) continue;
      const int64_t g = a.gid[i];
      if (g < 0 || g >= G || !passes(a.mk, i)) continue;
      const long long v = map_key(a.x, i, a.esz, a.is_float);
      lo = v < lo ? v : lo;
      hi = v > hi ? v : hi;
    }
  }
  if (a.route != ROUTE_DIRECT) {
    block_minmax(&lo, &hi, sh);
    if (threadIdx.x == 0) {
      a.partials[2 * blockIdx.x] = lo;
      a.partials[2 * blockIdx.x + 1] = hi;
    }
    grid.sync();
    lo = 0x7fffffffffffffffLL;
    hi = (long long)0x8000000000000000ULL;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += MAP_THREADS) {
      lo = a.partials[2 * b] < lo ? a.partials[2 * b] : lo;
      hi = a.partials[2 * b + 1] > hi ? a.partials[2 * b + 1] : hi;
    }
    block_minmax(&lo, &hi, sh);
  }
  if (threadIdx.x == 0) {
    bounds[0] = lo;
    bounds[1] = hi;
  }
  __syncthreads();
  const long long kmin = bounds[0], kmax = bounds[1];
  // kmax - kmin: the span less one (0 when no row takes part)
  const unsigned long long spanm1 =
      kmin > kmax ? 0ULL : (unsigned long long)kmax - (unsigned long long)kmin;
  const bool direct =
      a.route == ROUTE_DIRECT ||
      (a.route == ROUTE_AUTO && spanm1 < (unsigned long long)MAP_DIRECT_SPAN &&
       (unsigned long long)G * (spanm1 + 1ULL) <=
           (unsigned long long)a.table_cap);

  if (!direct) {  // the sort route's words
    const int kbits = bits_of(spanm1);  // d < 2^kbits
    const bool packed = kbits + bits_of((unsigned long long)G) <= 64;
    if (t == 0) {
      a.info[INFO_SORTED] = 1;
      a.info[INFO_KMIN] = kmin;
      a.info[INFO_KBITS] = kbits;
      a.info[INFO_PACKED] = packed ? 1 : 0;
      *a.sort_n = (int32_t)n;
    }
    const unsigned long long sign = 0x8000000000000000ULL;
    for (int64_t i = t; i < n; i += stride) {
      const int64_t g = a.gid[i];
      const bool elig = g >= 0 && g < G && passes(a.mk, i);
      const unsigned long long code =
          elig ? (unsigned long long)g : (unsigned long long)G;
      const unsigned long long d =
          elig ? (unsigned long long)(map_key(a.x, i, a.esz, a.is_float) -
                                      kmin)
               : 0ULL;
      if (packed) {
        const unsigned long long w = (kbits < 64 ? code << kbits : 0ULL) | d;
        a.words[i] = (long long)(w ^ sign);
        if (a.nw == 2) a.words[a.cap + i] = (long long)sign;
      } else {
        a.words[i] = (long long)(d ^ sign);
        a.words[a.cap + i] = (long long)(code ^ sign);
      }
    }
    return;
  }

  // the direct route
  if (t == 0) {
    a.info[INFO_SORTED] = 0;
    if (a.sort_n != nullptr) *a.sort_n = 0;
  }
  const int64_t sp = kmin > kmax ? 0 : (int64_t)spanm1 + 1;
  int64_t entries = G * sp;
  entries = entries > a.table_cap ? a.table_cap : entries;
  const int32_t ident = hist ? 0 : 0x7fffffff;
  for (int64_t e = t; e < entries; e += stride) a.table[e] = ident;
  grid.sync();
  const int lane = threadIdx.x & 31;
  for (int64_t first = blockIdx.x * (int64_t)MAP_THREADS; first < n;
       first += MAP_ITEMS * stride) {
    int idx[MAP_ITEMS];
#pragma unroll
    for (int k = 0; k < MAP_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      idx[k] = -1;
      if (i < n) {
        const int64_t g = a.gid[i];
        if (g >= 0 && g < G && passes(a.mk, i)) {
          const unsigned long long d =
              (unsigned long long)(map_key(a.x, i, a.esz, a.is_float) - kmin);
          const int64_t e = g * sp + (int64_t)d;
          idx[k] = d < (unsigned long long)sp && e < entries ? (int)e : -1;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAP_ITEMS; ++k) {
      const int32_t i = (int32_t)(first + threadIdx.x + k * stride);
      const unsigned active = __ballot_sync(0xffffffffu, idx[k] >= 0);
      if (idx[k] < 0) continue;
      const unsigned peers = __match_any_sync(active, idx[k]);
      if (lane != __ffs(peers) - 1) continue;  // the lowest lane: the first row
      if (hist) atomicAdd(&a.table[idx[k]], __popc(peers));
      else if (i < a.table[idx[k]]) atomicMin(&a.table[idx[k]], i);
    }
  }
  grid.sync();
  // a warp per list row: its group's entries in key order, then zeros
  const int64_t warps = stride >> 5;
  const int64_t aux_esz = hist ? 8 : a.esz2;
  for (int64_t g = t >> 5; g < a.rows; g += warps) {
    int64_t len = 0;
    if (g < G) {
      for (int64_t c0 = 0; c0 < sp; c0 += 32) {
        const int64_t d = c0 + lane;
        const int32_t v = d < sp && g * sp + d < entries
                              ? a.table[g * sp + d] : ident;
        const bool present = v != ident;
        const unsigned m = __ballot_sync(0xffffffffu, present);
        const int64_t ord = len + __popc(m & ((1u << lane) - 1u));
        if (present && ord < a.L) {
          const int64_t o = g * a.L + ord;
          store_int(a.keys, o, a.esz, kmin + d);
          if (hist) static_cast<long long*>(a.aux)[o] = v;
          else copy_elem(a.x2, v, a.aux, o, a.esz2);
        }
        len += __popc(m);
      }
    }
    len = len < a.L ? len : a.L;
    zero_bytes(static_cast<char*>(a.keys), (g * a.L + len) * a.esz,
               (g + 1) * a.L * a.esz, lane);
    zero_bytes(static_cast<char*>(a.aux), (g * a.L + len) * aux_esz,
               (g + 1) * a.L * aux_esz, lane);
    if (lane == 0) a.lengths[g] = (int32_t)len;
  }
}

// A sorted position's (code, d) as the pack stages it: the packed word
// (code << kbits | d) in lo, or d in lo and code in hi.
struct Sorted {
  unsigned long long lo, hi;
};

struct PackArgs {
  const int32_t* perm;
  const long long* words;
  int64_t cap;
  const int32_t* sort_n;
  const long long* info;
  const void* x;
  int esz, is_float;
  const void* x2;
  int esz2;
  const int32_t* num_groups;
  int64_t L, rows;
  unsigned long long* lo;  // [cap] the staged words
  unsigned long long* hi;  // [cap] (two-word layout)
  int32_t* run_pos;    // [cap + 1]
  int32_t* first_run;  // [rows]
  int32_t* tile_runs;  // [tiles]
  void* keys;
  void* aux;
  int32_t* lengths;
};

struct PackView {
  const PackArgs* a;
  int packed, kbits;

  __device__ __forceinline__ Sorted gather(int64_t i) const {
    const int64_t r = a->perm[i];
    Sorted w;
    w.lo = (unsigned long long)a->words[r] ^ 0x8000000000000000ULL;
    w.hi = packed ? 0ULL
                  : (unsigned long long)a->words[a->cap + r] ^
                        0x8000000000000000ULL;
    return w;
  }
  __device__ __forceinline__ Sorted staged(int64_t i) const {
    Sorted w;
    w.lo = a->lo[i];
    w.hi = packed ? 0ULL : a->hi[i];
    return w;
  }
  __device__ __forceinline__ long long code(const Sorted& w) const {
    if (!packed) return (long long)w.hi;
    return kbits < 64 ? (long long)(w.lo >> kbits) : 0LL;
  }
};

__device__ __forceinline__ bool same_run(const Sorted& p, const Sorted& q) {
  return p.lo == q.lo && p.hi == q.hi;
}

// Phases between grid barriers, each over tiles of MAP_TILE sorted
// positions (block b takes the tiles b, b + grid, ...), thread j of a
// block the MAP_RUN consecutive positions j x MAP_RUN, ... of a tile:
//   0. each position's words gathered once through the permutation and
//      staged (coalesced for the later phases), its run start found from
//      the previous position (the previous thread's last through shared
//      memory; the tile's first gathers its previous one), each tile's
//      run starts counted; every length 0;
//   1. run k's first position and each group's first run, k from the
//      tiles before (every block sums them) and a block scan
//      (one past the last eligible position closes the last run);
//   2. at each run's first position its entry: the key (its first row's
//      value, NaN as +inf, a zero's sign kept), the run length (the next
//      run's first position less its own) or map_agg's value of its first
//      row; at a group's last position its length;
//   3. zeros past each list, a warp a list row.
__global__ void __launch_bounds__(MAP_THREADS)
    map_pack_kernel(const __grid_constant__ PackArgs a) {
  __shared__ int warp_sums[32];
  __shared__ Sorted last_w[MAP_THREADS];
  if (a.info[INFO_SORTED] == 0) return;  // the direct route wrote the lists
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t t = blockIdx.x * (int64_t)MAP_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * MAP_THREADS;
  const int64_t n = clamp_rows(a.sort_n, a.cap);
  int64_t G = *a.num_groups;
  G = G < 0 ? 0 : (G > a.rows ? a.rows : G);
  const PackView v{&a, (int)a.info[INFO_PACKED], (int)a.info[INFO_KBITS]};
  const bool hist = a.x2 == nullptr;
  const int64_t tiles = (n + MAP_TILE - 1) / MAP_TILE;

  for (int64_t g = t; g < a.rows; g += stride) a.lengths[g] = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t i0 = tile * MAP_TILE + threadIdx.x * MAP_RUN;
    Sorted w[MAP_RUN];
#pragma unroll
    for (int j = 0; j < MAP_RUN; ++j) {
      const int64_t i = i0 + j;
      w[j] = i < n ? v.gather(i) : Sorted{0ULL, 0ULL};
    }
#pragma unroll
    for (int j = 0; j < MAP_RUN; ++j) {
      const int64_t i = i0 + j;
      if (i >= n) continue;
      a.lo[i] = w[j].lo;
      if (!v.packed) a.hi[i] = w[j].hi;
    }
    last_w[threadIdx.x] = w[MAP_RUN - 1];
    __syncthreads();
    Sorted p = threadIdx.x ? last_w[threadIdx.x - 1]
                           : (i0 > 0 && i0 < n ? v.gather(i0 - 1)
                                               : Sorted{0ULL, 0ULL});
    int c = 0;
#pragma unroll
    for (int j = 0; j < MAP_RUN; ++j) {
      const int64_t i = i0 + j;
      if (i < n && v.code(w[j]) < G && (i == 0 || !same_run(p, w[j]))) ++c;
      p = w[j];
    }
    int total;
    block_exclusive_scan(c, warp_sums, &total);  // syncs: last_w reusable
    if (threadIdx.x == 0) a.tile_runs[tile] = total;
  }
  grid.sync();

  for (int pass = 0; pass < 2; ++pass) {
    int acc = 0;       // the runs of the tiles before `done`
    int64_t done = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int part = 0;
      for (int64_t u = done + threadIdx.x; u < tile; u += MAP_THREADS)
        part += a.tile_runs[u];
      int sum;
      block_exclusive_scan(part, warp_sums, &sum);
      acc += sum;
      const int64_t i0 = tile * MAP_TILE + threadIdx.x * MAP_RUN;
      Sorted w[MAP_RUN + 2];  // positions i0 - 1 .. i0 + MAP_RUN
#pragma unroll
      for (int j = 0; j < MAP_RUN + 2; ++j) {
        const int64_t i = i0 - 1 + j;
        w[j] = i >= 0 && i < n ? v.staged(i) : Sorted{0ULL, 0ULL};
      }
      int starts = 0;
#pragma unroll
      for (int j = 1; j <= MAP_RUN; ++j) {
        const int64_t i = i0 - 1 + j;
        starts += i < n && v.code(w[j]) < G &&
                  (i == 0 || !same_run(w[j - 1], w[j])) ? 1 : 0;
      }
      int round;
      int k = acc + block_exclusive_scan(starts, warp_sums, &round) - 1;
#pragma unroll
      for (int j = 1; j <= MAP_RUN; ++j) {
        const int64_t i = i0 - 1 + j;
        const long long code = i < n ? v.code(w[j]) : G;
        if (code >= G) continue;
        const bool start = i == 0 || !same_run(w[j - 1], w[j]);
        k += start ? 1 : 0;  // this position's run
        const bool last = i + 1 == n;
        const bool group_end = last || v.code(w[j + 1]) != code;
        if (pass == 0) {
          if (start) {
            a.run_pos[k] = (int32_t)i;
            if (i == 0 || v.code(w[j - 1]) != code) a.first_run[code] = k;
          }
          // the last eligible position: one past it closes the last run
          if (group_end && (last || v.code(w[j + 1]) >= G))
            a.run_pos[k + 1] = (int32_t)(i + 1);
          continue;
        }
        const int64_t ord = k - a.first_run[code];
        if (start && ord < a.L) {  // the entry, from the run's first row
          const int64_t r0 = a.perm[i];
          const int64_t o = code * a.L + ord;
          write_key(a.x, r0, a.esz, a.is_float, a.keys, o);
          if (hist)
            static_cast<long long*>(a.aux)[o] = a.run_pos[k + 1] - i;
          else
            copy_elem(a.x2, r0, a.aux, o, a.esz2);
        }
        if (group_end)
          a.lengths[code] = (int32_t)(ord + 1 < a.L ? ord + 1 : a.L);
      }
      acc += round;
      done = tile + 1;
    }
    grid.sync();
  }

  // zeros past each list, a warp a list row
  const int64_t aux_esz = hist ? 8 : a.esz2;
  const int lane = threadIdx.x & 31;
  for (int64_t g = t >> 5; g < a.rows; g += stride >> 5) {
    const int64_t len = a.lengths[g];
    zero_bytes(static_cast<char*>(a.keys), (g * a.L + len) * a.esz,
               (g + 1) * a.L * a.esz, lane);
    zero_bytes(static_cast<char*>(a.aux), (g * a.L + len) * aux_esz,
               (g + 1) * a.L * aux_esz, lane);
  }
}

// ----------------------------------------------------------------- K34

// A row's output slots: its length when live and not NULL.
struct Slots {
  const int32_t* lengths;
  const uint8_t* valid;
  const int32_t* num_rows;
  int64_t cap;

  __device__ __forceinline__ int64_t limit() const {
    return clamp_rows(num_rows, cap);
  }

  __device__ __forceinline__ int operator()(int64_t i) const {
    if (valid != nullptr && !valid[i]) return 0;
    const int l = lengths[i];
    return l > 0 ? l : 0;
  }
};

__global__ void unnest_scatter_kernel(const Slots keep,
                                      const int64_t* __restrict__ offsets,
                                      int64_t out_cap, int64_t L,
                                      const void* plane, int esz,
                                      const void* aux, int aux_esz,
                                      int32_t* src_row, long long* ordinal,
                                      void* elem, void* aux_out) {
  const int64_t n = keep.limit();
  if ((int64_t)blockIdx.x * TILE >= n) return;  // uniform across the block
  tile_scatter(keep, n, offsets, [&](int64_t i, int64_t pos) {
    const int len = keep(i);
    for (int k = 0; k < len && pos + k < out_cap; ++k) {
      const int64_t o = pos + k;
      src_row[o] = (int32_t)i;
      if (ordinal != nullptr) ordinal[o] = k + 1;
      copy_elem(plane, i * L + k, elem, o, esz);
      if (aux != nullptr) copy_elem(aux, i * L + k, aux_out, o, aux_esz);
    }
  });
}
}  // namespace

// K33 size mode. gid: int32 [cap] (K28); num_rows, num_groups: int32
// scalars (device); counts: int32 [cap + 1] scratch; out: int64 [2] =
// (largest live group, groups).
TT_EXPORT int collect_sizes(const void* gid, int64_t cap,
                            const void* num_rows, const void* num_groups,
                            void* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, (size_t)(cap + 1) * 4, s);
  cudaMemsetAsync(out, 0, 16, s);
  sizes_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      static_cast<const int32_t*>(gid), cap,
      static_cast<const int32_t*>(num_rows),
      static_cast<const int32_t*>(num_groups),
      static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// K33 array mode's words launch: words int64 [cap]; masks: host array
// of nmasks uint8 [cap] pointers.
TT_EXPORT int collect_words(int64_t cap, const void* num_rows,
                            const void* masks, int64_t nmasks,
                            const void* gid, void* words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(masks, nmasks, &mk)) return -1;
  if (cap > 0)
    words_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        cap, static_cast<const int32_t*>(num_rows), mk,
        static_cast<const int32_t*>(gid), static_cast<long long*>(words));
  return (int)cudaGetLastError();
}

// K33 array-mode pack over K10's permutation perm (int32 [cap]): plane
// [rows, L] of esz bytes and lengths int32 [rows] (rows >= groups), both
// zeroed first; scratch int64 [2 * rows] (start, endp).
TT_EXPORT int collect_array(const void* perm, int64_t cap,
                            const void* num_rows, const void* masks,
                            int64_t nmasks, const void* gid,
                            const void* num_groups, const void* x,
                            int64_t esz, int64_t L, int64_t rows,
                            void* scratch, void* plane, void* lengths,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(masks, nmasks, &mk) || L < 1 || rows < 1) return -1;
  cudaMemsetAsync(plane, 0, (size_t)(rows * L * esz), s);
  cudaMemsetAsync(lengths, 0, (size_t)rows * 4, s);
  auto* start = static_cast<long long*>(scratch);
  auto* endp = start + rows;
  const auto* ng = static_cast<const int32_t*>(num_groups);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(start, ng, 0);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(endp, ng, 0);
  const auto* pm = static_cast<const int32_t*>(perm);
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* gd = static_cast<const int32_t*>(gid);
  if (cap > 0) {
    bounds_kernel<<<grid_for(cap), THREADS, 0, s>>>(pm, cap, nr, mk, gd,
                                                    start, endp);
    array_pack_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        pm, cap, nr, mk, gd, start, x, (int)esz, L, plane);
  }
  lengths_kernel<<<grid_for(rows), THREADS, 0, s>>>(
      ng, start, endp, L, static_cast<int32_t*>(lengths));
  return (int)cudaGetLastError();
}

namespace {
int64_t map_enqueues_ = 0;  // stream operations collect_map* enqueued

template <class K>
int64_t coop_grid(K kernel, int64_t work) {
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  MAP_THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t most =
      resident[dev] < MAP_MAX_GRID ? resident[dev] : MAP_MAX_GRID;
  const int64_t per_block = MAP_THREADS * MAP_ITEMS;
  const int64_t blocks = (work + per_block - 1) / per_block;
  return blocks < 1 ? 1 : (blocks > most ? most : blocks);
}
}  // namespace

// K33 map mode, its first launch. x: [cap] key column (esz bytes, an
// integer or a 4- or 8-byte float); x2: map_agg's values (esz2 bytes) or
// null for histogram; masks: host array of nmasks uint8 [cap] pointers;
// gid: int32 [cap] (K28); num_rows, num_groups: int32 scalars; keys [rows,
// L] of esz bytes, aux [rows, L] (int64 counts or esz2 bytes), lengths
// int32 [rows]. route: 0 direct (every eligible key lies in [kmin, kmin +
// span), span at most MAP_DIRECT_SPAN, rows x span at most table_cap),
// 1 chosen on the device, 2 sort.
// table: int32 [table_cap] (routes 0 and 1); words: int64 [nw, cap],
// sort_n: int32 scalar (K10's row count), info: int64 [INFO_WORDS]
// (routes 1 and 2; sort_n may be null on route 0); partials: int64
// [2 * MAP_MAX_GRID]. One cooperative launch.
TT_EXPORT int collect_map(const void* x, int64_t esz, int64_t is_float,
                          const void* x2, int64_t esz2, int64_t cap,
                          const void* num_rows, const void* masks,
                          int64_t nmasks, const void* gid,
                          const void* num_groups, int64_t L, int64_t rows,
                          int64_t route, int64_t kmin, int64_t span,
                          void* table, int64_t table_cap,
                          void* words, int64_t nw, void* sort_n, void* info,
                          void* partials, void* keys, void* aux,
                          void* lengths, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MapArgs a;
  if (masks_from(masks, nmasks, &a.mk) || L < 1 || rows < 1) return -1;
  a.x = x;
  a.esz = (int)esz;
  a.is_float = (int)is_float;
  a.x2 = x2;
  a.esz2 = (int)esz2;
  a.cap = cap;
  a.num_rows = static_cast<const int32_t*>(num_rows);
  a.gid = static_cast<const int32_t*>(gid);
  a.num_groups = static_cast<const int32_t*>(num_groups);
  a.L = L;
  a.rows = rows;
  a.route = (int)route;
  a.kmin = kmin;
  a.span = span < 1 ? 1 : span;
  a.table = static_cast<int32_t*>(table);
  a.table_cap = table_cap;
  a.words = static_cast<long long*>(words);
  a.nw = (int)nw;
  a.sort_n = static_cast<int32_t*>(sort_n);
  a.info = static_cast<long long*>(info);
  a.partials = static_cast<long long*>(partials);
  a.keys = keys;
  a.aux = aux;
  a.lengths = static_cast<int32_t*>(lengths);
  const int64_t cells = rows * L;
  const int64_t blocks = coop_grid(map_prep_kernel,
                                   cap > cells / 8 ? cap : cells / 8);
  if (blocks < 0) return -1;
  void* args[] = {&a};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(map_prep_kernel), dim3((unsigned)blocks),
      dim3(MAP_THREADS), args, 0, s);
  ++map_enqueues_;
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}

// K33 map mode's pack after K10 sorted collect_map's words (routes 1 and
// 2): perm int32 [cap]; scratch: int64 [2 cap] (the staged words), then
// int32 [cap + 1 + rows + ceil(cap / MAP_TILE)] (run positions, each
// group's first run, each tile's runs); the rest as
// collect_map took them. Returns at once on the device when collect_map
// took the direct route. One cooperative launch.
TT_EXPORT int collect_map_pack(const void* perm, const void* words,
                               int64_t cap, const void* sort_n,
                               const void* info, const void* x, int64_t esz,
                               int64_t is_float, const void* x2,
                               int64_t esz2, const void* num_groups,
                               int64_t L, int64_t rows, void* scratch,
                               void* keys, void* aux, void* lengths,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || rows < 1) return -1;
  PackArgs a;
  a.perm = static_cast<const int32_t*>(perm);
  a.words = static_cast<const long long*>(words);
  a.cap = cap;
  a.sort_n = static_cast<const int32_t*>(sort_n);
  a.info = static_cast<const long long*>(info);
  a.x = x;
  a.esz = (int)esz;
  a.is_float = (int)is_float;
  a.x2 = x2;
  a.esz2 = (int)esz2;
  a.num_groups = static_cast<const int32_t*>(num_groups);
  a.L = L;
  a.rows = rows;
  a.lo = static_cast<unsigned long long*>(scratch);
  a.hi = a.lo + cap;
  a.run_pos = reinterpret_cast<int32_t*>(a.hi + cap);
  a.first_run = a.run_pos + cap + 1;
  a.tile_runs = a.first_run + rows;
  a.keys = keys;
  a.aux = aux;
  a.lengths = static_cast<int32_t*>(lengths);
  const int64_t cells = rows * L;
  const int64_t blocks = coop_grid(map_pack_kernel,
                                   cap > cells / 8 ? cap : cells / 8);
  if (blocks < 0) return -1;
  void* args[] = {&a};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(map_pack_kernel), dim3((unsigned)blocks),
      dim3(MAP_THREADS), args, 0, s);
  ++map_enqueues_;
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}

// The stream operations collect_map and collect_map_pack have enqueued in
// this process (chip_smoke.py counts them per call).
TT_EXPORT int64_t collect_map_enqueues() { return map_enqueues_; }

// K34 count: total (int32 scalar, device) = the live non-NULL rows'
// lengths; scratch int64 [tiles].
TT_EXPORT int unnest_count(const void* lengths, const void* valid,
                           const void* num_rows, int64_t cap, void* scratch,
                           void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Slots keep{static_cast<const int32_t*>(lengths),
             static_cast<const uint8_t*>(valid),
             static_cast<const int32_t*>(num_rows), cap};
  tile_offsets(keep, cap, static_cast<int64_t*>(scratch),
               static_cast<int32_t*>(total), s);
  return (int)cudaGetLastError();
}

// K34 expand: plane [cap, L] of esz bytes (aux the same shape of aux_esz
// bytes, or null); outputs [out_cap]: src_row int32, ordinal int64 (or
// null), elem, aux_out; total int32 scalar (device) = the slots written
// (at most out_cap are); scratch int64 [tiles].
TT_EXPORT int unnest_expand(const void* lengths, const void* valid,
                            const void* num_rows, int64_t cap, int64_t L,
                            const void* plane, int64_t esz, const void* aux,
                            int64_t aux_esz, int64_t out_cap, void* scratch,
                            void* total, void* src_row, void* ordinal,
                            void* elem, void* aux_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Slots keep{static_cast<const int32_t*>(lengths),
             static_cast<const uint8_t*>(valid),
             static_cast<const int32_t*>(num_rows), cap};
  auto* offsets = static_cast<int64_t*>(scratch);
  const int64_t nblocks = tile_offsets(keep, cap, offsets,
                                       static_cast<int32_t*>(total), s);
  unnest_scatter_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
      keep, offsets, out_cap, L, plane, (int)esz, aux, (int)aux_esz,
      static_cast<int32_t*>(src_row), static_cast<long long*>(ordinal),
      elem, aux_out);
  return (int)cudaGetLastError();
}
