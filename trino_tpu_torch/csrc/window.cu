// K20, K22, K23: the window operator's kernels over a page already sorted
// by (partition, order) keys (trino_tpu_torch/ops/window.py; K21 is Triton
// there).
//
// Replaces trino_tpu/ops/window.py:
//   K20 window_bounds — `window` (:81-114): the change flags of the
//       partition and order columns, then seg/peer start (a cummax of the
//       flagged index), id (cumsum - 1) and live length (a scatter-add).
//       Four launches, no host sync: per tile of WTILE rows the two flag
//       counts packed in one int64 (tile.cuh's count); one exclusive scan
//       over the tiles (tile.cuh's tile_scan_kernel, the packed sums never
//       carry between halves); per tile a block scan that writes each
//       row's ids and each group's first row; per row the start and the
//       length read back from the first rows of its group and the next.
//   K22 window_scan — `_segmented_scan` (:255), `_bounded_counts` (:266)
//       and `_eval_aggregate` (:276): sum/count/min/max as a segmented
//       inclusive scan of (value, count) pairs with the segment-start flag
//       carried, forward or (for a min/max frame with an unbounded end)
//       reversed, in three launches (per tile its aggregate; one block
//       scans the tiles; per tile the rows' prefixes written), then one
//       launch per row reading the prefixes at the frame's ends: the row
//       (ROWS), the peer group's end (RANGE), the segment's end (whole),
//       a prefix difference (bounded sum/avg/count), the forward scan at
//       hi or the reversed one at lo (bounded min/max). Integers and
//       decimals accumulate in int64 (wrapping: exact), doubles in
//       float64; the decimal avg rounds half away from zero.
//   K23 window_minmax — `_bounded_minmax` (:372) for a two-sided bounded
//       ROWS frame, its values and its validity (a frame holding a non-NULL
//       row; the reference's `_bounded_counts` > 0): up to MINMAX_NARROW
//       rows wide, each block stages its tile and the frame's halo in
//       shared memory and every row folds its frame; wider, the
//       reference's doubling table (level k: the min over [i, i + 2^k)
//       inside the segment, beside the OR of the rows' validity), one
//       launch per level, then two reads per row. Both exact: min, max and
//       OR do not round, and two overlapping reads change none of them.
//       `window_minmax_levels` says how many table levels a frame needs
//       (0: the halo serves it); this file alone owns that threshold.
//
// Bound on this card: bytes. K20 reads the key columns once and writes
// 40 bytes a row; K22 reads the argument and its validity and writes the
// output (the prefixes are scratch: 16 bytes a row written once and read
// about twice); K23 reads the argument once (the halo re-reads at most
// MINMAX_NARROW rows per tile from shared memory) and writes the values
// and validity.
#include "tile.cuh"

namespace {
constexpr int WTILE = 4096;      // rows per tile (ops/window.py WINDOW_TILE)
constexpr int WTHREADS = 256;    // threads per tile block
constexpr int PER_THREAD = WTILE / WTHREADS;
constexpr int MINMAX_NARROW = 64;   // widest frame K23's halo path takes
constexpr int MINMAX_ROWS = 1024;   // rows per block of K23's halo path

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

int grid_for(int64_t rows, int threads) {
  int64_t blocks = (rows + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 8192 ? 8192 : blocks);  // grid-stride beyond
}

// ------------------------------------------------------------------ K20

// Row i (>= 1) differs from row i - 1 in key column `c` (4 words: values
// ptr, valid ptr or 0, element size, is_float): values compared where both
// rows are valid (as doubles for floats, so -0.0 == +0.0 and NaN differs
// from everything), a NULL equal to a NULL.
__device__ __forceinline__ bool key_differs(const int64_t* c, int64_t i) {
  const void* vals = reinterpret_cast<const void*>(c[0]);
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  const int esz = (int)c[2];
  bool d = c[3] ? load_float(vals, i, esz) != load_float(vals, i - 1, esz)
                : load_int(vals, i, esz) != load_int(vals, i - 1, esz);
  if (valid != nullptr) {
    const bool a = valid[i] != 0, b = valid[i - 1] != 0;
    d = (d && a && b) || (a != b);
  }
  return d;
}

// The two flags of row i packed: bit 0 the segment (partition) start, bit
// 32 the peer start. Dead rows (i >= n) start their own segment.
__device__ __forceinline__ long long row_flags(const int64_t* keys,
                                               int64_t npart, int64_t norder,
                                               int64_t i, int64_t n) {
  bool seg = i == 0 || ((i >= n) != (i - 1 >= n));
  for (int64_t k = 0; k < npart && !seg; ++k)
    seg = key_differs(keys + 4 * k, i);
  bool peer = seg;
  for (int64_t k = 0; k < norder && !peer; ++k)
    peer = key_differs(keys + 4 * (npart + k), i);
  return (long long)seg | ((long long)peer << 32);
}

__global__ void bounds_count_kernel(const int32_t* __restrict__ n_ptr,
                                    int64_t cap, int64_t npart,
                                    int64_t norder,
                                    const __grid_constant__ Table keys,
                                    int64_t* __restrict__ counts) {
  __shared__ long long warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t base = (int64_t)blockIdx.x * WTILE;
  long long c = 0;
  for (int r = threadIdx.x; r < WTILE; r += blockDim.x) {
    const int64_t i = base + r;
    if (i < cap) c += row_flags(keys.v, npart, norder, i, n);
  }
  long long total;
  block_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Per tile: each row's segment and peer ids (inclusive flag count - 1) and,
// at a group's first row, that row into seg_first / peer_first.
__global__ void bounds_ids_kernel(const int32_t* __restrict__ n_ptr,
                                  int64_t cap, int64_t npart, int64_t norder,
                                  const __grid_constant__ Table keys,
                                  const int64_t* __restrict__ offsets,
                                  int64_t* __restrict__ seg_first,
                                  int64_t* __restrict__ peer_first,
                                  int32_t* __restrict__ seg_id,
                                  int32_t* __restrict__ peer_id) {
  __shared__ long long warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t base = (int64_t)blockIdx.x * WTILE;
  long long carry = offsets[blockIdx.x];
  for (int r = 0; r < WTILE; r += blockDim.x) {
    const int64_t i = base + r + threadIdx.x;
    const long long f =
        i < cap ? row_flags(keys.v, npart, norder, i, n) : 0LL;
    long long total;
    const long long ex = block_exclusive_scan(f, warp_sums, &total);
    if (i < cap) {
      const long long inc = carry + ex + f;
      const int64_t sid = (inc & 0xffffffffLL) - 1;
      const int64_t pid = (inc >> 32) - 1;
      seg_id[i] = (int32_t)sid;
      peer_id[i] = (int32_t)pid;
      if (f & 1) seg_first[sid] = i;
      if (f >> 32) peer_first[pid] = i;
    }
    carry += total;
  }
}

// Per row: the group's first row and its live length (the next group's
// first row, or the capacity, less the first; 0 for a dead row).
__global__ void bounds_len_kernel(const int32_t* __restrict__ n_ptr,
                                  int64_t cap,
                                  const int64_t* __restrict__ totals,
                                  const int64_t* __restrict__ seg_first,
                                  const int64_t* __restrict__ peer_first,
                                  const int32_t* __restrict__ seg_id,
                                  const int32_t* __restrict__ peer_id,
                                  int64_t* __restrict__ seg_start,
                                  int64_t* __restrict__ seg_len,
                                  int64_t* __restrict__ peer_start,
                                  int64_t* __restrict__ peer_len) {
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t nseg = *totals & 0xffffffffLL;
  const int64_t npeer = *totals >> 32;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = seg_id[i], p = peer_id[i];
    const int64_t ss = seg_first[s], ps = peer_first[p];
    const int64_t se = s + 1 < nseg ? seg_first[s + 1] : cap;
    const int64_t pe = p + 1 < npeer ? peer_first[p + 1] : cap;
    const bool live = i < n;
    seg_start[i] = ss;
    seg_len[i] = live ? se - ss : 0;
    peer_start[i] = ps;
    peer_len[i] = live ? pe - ps : 0;
  }
}

// ------------------------------------------------------------------ K22

enum ScanOp { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_COUNT = 3 };
enum Read {
  R_ROWS = 0, R_RANGE = 1, R_WHOLE = 2, R_BOUNDED = 3, R_AT_HI = 4,
  R_REV_AT_LO = 5
};

// A scan element: the segment-start flag, the value word (int64, or the
// bits of a double) and the row count.
struct Elem {
  bool f;
  long long v;
  long long c;
};

__device__ __forceinline__ double as_f(long long w) {
  return __longlong_as_double(w);
}
__device__ __forceinline__ long long as_w(double d) {
  return __double_as_longlong(d);
}

// min/max of doubles that propagate NaN (jnp.minimum / torch.minimum)
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

template <int OP, bool FLT>
__device__ __forceinline__ long long fold(long long a, long long b) {
  if (OP == OP_SUM)
    return FLT ? as_w(as_f(a) + as_f(b))
               : (long long)((unsigned long long)a + (unsigned long long)b);
  if (OP == OP_MIN) return FLT ? as_w(min_nan(as_f(a), as_f(b))) : (b < a ? b : a);
  if (OP == OP_MAX) return FLT ? as_w(max_nan(as_f(a), as_f(b))) : (b > a ? b : a);
  return 0;
}

// (a then b): b alone where b holds a segment start, else both folded
template <int OP, bool FLT>
__device__ __forceinline__ Elem seg_fold(const Elem& a, const Elem& b) {
  if (b.f) return b;
  return Elem{a.f, fold<OP, FLT>(a.v, b.v), a.c + b.c};
}

struct ScanArgs {
  const int32_t* n_ptr;
  int64_t cap;
  const void* x;         // nullptr: count(*)
  const uint8_t* xv;     // nullptr: no NULLs
  int esz;
  int rev;               // scan from the last row to the first
  long long neutral;     // the fold's identity word
  const int64_t* seg_start;
};

// The element at scan position p (row p, or cap - 1 - p reversed): the row
// contributes where it is live and not NULL; its flag marks a segment start
// (reversed: a segment end).
template <int OP, bool FLT>
__device__ __forceinline__ Elem element(const ScanArgs& a, int64_t p,
                                        int64_t n) {
  const int64_t r = a.rev ? a.cap - 1 - p : p;
  const bool f = a.rev ? (r == a.cap - 1 || a.seg_start[r + 1] == r + 1)
                       : a.seg_start[r] == r;
  const bool ok = r < n && (a.xv == nullptr || a.xv[r] != 0);
  long long v = a.neutral;
  if (ok && OP != OP_COUNT && a.x != nullptr)
    v = FLT ? as_w(load_float(a.x, r, a.esz)) : load_int(a.x, r, a.esz);
  return Elem{f, v, ok ? 1LL : 0LL};
}

// Inclusive segmented scan of one element per thread across the block
// (Hillis-Steele over shared memory; blockDim.x threads).
template <int OP, bool FLT>
__device__ __forceinline__ Elem block_seg_scan(Elem e, bool* sf,
                                               long long* sv,
                                               long long* sc) {
  const int t = threadIdx.x;
  sf[t] = e.f;
  sv[t] = e.v;
  sc[t] = e.c;
  __syncthreads();
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    Elem cur = e;
    if (t >= d) cur = seg_fold<OP, FLT>(Elem{sf[t - d], sv[t - d], sc[t - d]}, e);
    __syncthreads();
    sf[t] = cur.f;
    sv[t] = cur.v;
    sc[t] = cur.c;
    e = cur;
    __syncthreads();
  }
  return e;
}

// The fold of this thread's PER_THREAD consecutive positions of the tile.
template <int OP, bool FLT>
__device__ __forceinline__ Elem thread_fold(const ScanArgs& a, int64_t base,
                                            int64_t n) {
  Elem e{false, a.neutral, 0};
  const int64_t p0 = base + (int64_t)threadIdx.x * PER_THREAD;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t p = p0 + k;
    if (p < a.cap) e = seg_fold<OP, FLT>(e, element<OP, FLT>(a, p, n));
  }
  return e;
}

// Launch 1: each tile's aggregate (flag, value, count) into tiles[0..2].
template <int OP, bool FLT>
__global__ void scan_reduce_kernel(const ScanArgs a, int64_t ntiles,
                                   int64_t* __restrict__ tiles) {
  __shared__ bool sf[WTHREADS];
  __shared__ long long sv[WTHREADS], sc[WTHREADS];
  const int64_t n = live_rows(a.n_ptr, a.cap);
  const Elem e = block_seg_scan<OP, FLT>(
      thread_fold<OP, FLT>(a, (int64_t)blockIdx.x * WTILE, n), sf, sv, sc);
  if (threadIdx.x == blockDim.x - 1) {
    tiles[blockIdx.x] = e.f;
    tiles[ntiles + blockIdx.x] = e.v;
    tiles[2 * ntiles + blockIdx.x] = e.c;
  }
}

// Launch 2 (one block): each tile's aggregate replaced in place by the
// fold of every tile before it (its carry in).
template <int OP, bool FLT>
__global__ void scan_tiles_kernel(int64_t ntiles, long long neutral,
                                  int64_t* __restrict__ tiles) {
  __shared__ bool sf[1024];
  __shared__ long long sv[1024], sc[1024];
  const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = (int64_t)threadIdx.x * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  Elem e{false, neutral, 0};
  for (int64_t t = lo; t < hi; ++t)
    e = seg_fold<OP, FLT>(e, Elem{tiles[t] != 0, tiles[ntiles + t],
                                  tiles[2 * ntiles + t]});
  block_seg_scan<OP, FLT>(e, sf, sv, sc);
  Elem carry = threadIdx.x == 0
                   ? Elem{false, neutral, 0}
                   : Elem{sf[threadIdx.x - 1], sv[threadIdx.x - 1],
                          sc[threadIdx.x - 1]};
  for (int64_t t = lo; t < hi; ++t) {
    const Elem agg{tiles[t] != 0, tiles[ntiles + t], tiles[2 * ntiles + t]};
    tiles[t] = carry.f;
    tiles[ntiles + t] = carry.v;
    tiles[2 * ntiles + t] = carry.c;
    carry = seg_fold<OP, FLT>(carry, agg);
  }
}

// Launch 3: every row's inclusive prefix (value word, count) at its row.
template <int OP, bool FLT>
__global__ void scan_write_kernel(const ScanArgs a, int64_t ntiles,
                                  const int64_t* __restrict__ tiles,
                                  int64_t* __restrict__ pref_v,
                                  int64_t* __restrict__ pref_c) {
  __shared__ bool sf[WTHREADS];
  __shared__ long long sv[WTHREADS], sc[WTHREADS];
  const int64_t n = live_rows(a.n_ptr, a.cap);
  const int64_t base = (int64_t)blockIdx.x * WTILE;
  block_seg_scan<OP, FLT>(thread_fold<OP, FLT>(a, base, n), sf, sv, sc);
  const int t = threadIdx.x;
  const Elem carry{tiles[blockIdx.x] != 0, tiles[ntiles + blockIdx.x],
                   tiles[2 * ntiles + blockIdx.x]};
  Elem run = t == 0 ? carry
                    : seg_fold<OP, FLT>(carry,
                                        Elem{sf[t - 1], sv[t - 1], sc[t - 1]});
  const int64_t p0 = base + (int64_t)t * PER_THREAD;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t p = p0 + k;
    if (p >= a.cap) break;
    run = seg_fold<OP, FLT>(run, element<OP, FLT>(a, p, n));
    const int64_t r = a.rev ? a.cap - 1 - p : p;
    pref_v[r] = run.v;
    pref_c[r] = run.c;
  }
}

struct ReadArgs {
  const int32_t* n_ptr;
  int64_t cap;
  int read;
  int has_bs, has_be;
  int64_t bs, be;
  long long neutral;
  int avg;            // 0 none, 1 a float average, 2 a decimal average
  int out_esz;
  int out_float;
  const int64_t* seg_start;
  const int64_t* seg_len;
  const int64_t* peer_start;
  const int64_t* peer_len;
  const int64_t* pref_v;
  const int64_t* pref_c;
  void* out;
  uint8_t* valid;     // nullptr: count (no NULLs)
};

__device__ __forceinline__ int64_t clip(int64_t i, int64_t cap) {
  return i < 0 ? 0 : (i >= cap ? cap - 1 : i);
}

__device__ __forceinline__ void store_out(void* out, int64_t i, int esz,
                                          int is_float, long long w,
                                          bool w_float) {
  if (is_float) {
    const double d = w_float ? as_f(w) : (double)w;
    if (esz == 4)
      static_cast<float*>(out)[i] = (float)d;
    else
      static_cast<double*>(out)[i] = d;
    return;
  }
  switch (esz) {
    case 8: static_cast<int64_t*>(out)[i] = w; break;
    case 4: static_cast<int32_t*>(out)[i] = (int32_t)w; break;
    case 2: static_cast<int16_t*>(out)[i] = (int16_t)w; break;
    default: static_cast<int8_t*>(out)[i] = (int8_t)w; break;
  }
}

// Launch 4: each row's frame value and count from the prefixes, then the
// output (count; sum; float or decimal avg; min/max) and its validity.
template <int OP, bool FLT>
__global__ void scan_read_kernel(const ReadArgs a) {
  const int64_t n = live_rows(a.n_ptr, a.cap);
  const int64_t cap = a.cap;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = a.seg_start[i], len = a.seg_len[i];
    const bool live = i < n;
    long long v = a.neutral, c = 0;
    if (a.read == R_ROWS) {
      v = a.pref_v[i];
      c = a.pref_c[i];
    } else if (a.read == R_RANGE) {
      const int64_t at = clip(a.peer_start[i] + a.peer_len[i] - 1, cap);
      v = a.pref_v[at];
      c = a.pref_c[at];
    } else if (a.read == R_WHOLE) {
      if (len > 0) {
        v = a.pref_v[s + len - 1];
        c = a.pref_c[s + len - 1];
      }
    } else {
      const int64_t seg_end = s + len - 1;
      int64_t lo = s, hi = seg_end;
      if (a.has_bs && i + a.bs > lo) lo = i + a.bs;
      if (a.has_be && i + a.be < hi) hi = i + a.be;
      if (hi >= lo && live) {
        if (a.read == R_BOUNDED) {
          v = a.pref_v[clip(hi, cap)];
          c = a.pref_c[clip(hi, cap)];
          if (lo > s) {
            const int64_t at = clip(lo - 1, cap);
            v = FLT ? as_w(as_f(v) - as_f(a.pref_v[at]))
                    : (long long)((unsigned long long)v -
                                  (unsigned long long)a.pref_v[at]);
            c -= a.pref_c[at];
          }
        } else {
          const int64_t at = clip(a.read == R_AT_HI ? hi : lo, cap);
          v = a.pref_v[at];
          c = a.pref_c[at];
        }
      }
    }
    if (a.valid != nullptr) a.valid[i] = c > 0;
    if (OP == OP_COUNT) {
      store_out(a.out, i, a.out_esz, 0, c, false);
    } else if (a.avg == 1) {
      const double cd = (double)(c > 1 ? c : 1);
      store_out(a.out, i, a.out_esz, 1, as_w((FLT ? as_f(v) : (double)v) / cd),
                true);
    } else if (a.avg == 2) {
      const long long cc = c > 1 ? c : 1;
      const unsigned long long mag =
          v < 0 ? 0ULL - (unsigned long long)v : (unsigned long long)v;
      const long long q = (long long)((mag + (unsigned long long)(cc / 2)) /
                                      (unsigned long long)cc);
      store_out(a.out, i, a.out_esz, 0, v < 0 ? -q : q, false);
    } else {
      store_out(a.out, i, a.out_esz, a.out_float, v, FLT);
    }
  }
}

template <int OP, bool FLT>
void scan_launch(const ScanArgs& s, const ReadArgs& r, int64_t* tiles,
                 cudaStream_t st) {
  const int64_t ntiles = (s.cap + WTILE - 1) / WTILE;
  scan_reduce_kernel<OP, FLT><<<(unsigned)ntiles, WTHREADS, 0, st>>>(
      s, ntiles, tiles);
  scan_tiles_kernel<OP, FLT><<<1, 1024, 0, st>>>(ntiles, s.neutral, tiles);
  scan_write_kernel<OP, FLT><<<(unsigned)ntiles, WTHREADS, 0, st>>>(
      s, ntiles, tiles, const_cast<int64_t*>(r.pref_v),
      const_cast<int64_t*>(r.pref_c));
  scan_read_kernel<OP, FLT><<<grid_for(s.cap, 256), 256, 0, st>>>(r);
}

// ------------------------------------------------------------------ K23

struct MinmaxArgs {
  const int32_t* n_ptr;
  int64_t cap;
  const void* x;
  const uint8_t* xv;
  int esz;
  int64_t bs, be;
  long long neutral;
  const int64_t* seg_start;
  const int64_t* seg_len;
  const int32_t* seg_id;
  int64_t* levels;       // the doubling table: nlevels levels of values
  uint8_t* any_levels;   // and of "holds a non-NULL row"
  void* out;
  uint8_t* valid;
};

template <bool MAX, bool FLT>
__device__ __forceinline__ long long mm(long long a, long long b) {
  return fold<MAX ? OP_MAX : OP_MIN, FLT>(a, b);
}

// Row r contributes: it is live and not NULL.
__device__ __forceinline__ bool row_ok(const MinmaxArgs& a, int64_t r,
                                       int64_t n) {
  return r >= 0 && r < n && (a.xv == nullptr || a.xv[r] != 0);
}

// The contribution of row r: its value where it contributes, else the
// neutral word.
template <bool FLT>
__device__ __forceinline__ long long contrib(const MinmaxArgs& a, int64_t r,
                                             int64_t n) {
  if (!row_ok(a, r, n)) return a.neutral;
  return FLT ? as_w(load_float(a.x, r, a.esz)) : load_int(a.x, r, a.esz);
}

// The frame [lo, hi] of row i clipped to its segment; false when empty.
__device__ __forceinline__ bool frame_of(const MinmaxArgs& a, int64_t i,
                                         int64_t n, int64_t* lo,
                                         int64_t* hi) {
  const int64_t s = a.seg_start[i], e = s + a.seg_len[i] - 1;
  *lo = i + a.bs > s ? i + a.bs : s;
  *hi = i + a.be < e ? i + a.be : e;
  return *hi >= *lo && i < n;
}

// Narrow frames: a block's MINMAX_ROWS rows and the halo [base + bs,
// base + MINMAX_ROWS - 1 + be] staged in dynamic shared memory (the
// contributions, then one byte a row: contributes or not).
template <bool MAX, bool FLT>
__global__ void minmax_halo_kernel(const MinmaxArgs a) {
  extern __shared__ long long halo[];
  const int64_t n = live_rows(a.n_ptr, a.cap);
  const int64_t base = (int64_t)blockIdx.x * MINMAX_ROWS;
  const int64_t width = a.be - a.bs + 1 > 0 ? a.be - a.bs + 1 : 1;
  const int64_t len = MINMAX_ROWS + width - 1;
  uint8_t* ok = reinterpret_cast<uint8_t*>(halo + len);
  const int64_t h0 = base + a.bs;
  for (int64_t j = threadIdx.x; j < len; j += blockDim.x) {
    halo[j] = contrib<FLT>(a, h0 + j, n);
    ok[j] = row_ok(a, h0 + j, n);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < MINMAX_ROWS; r += blockDim.x) {
    const int64_t i = base + r;
    if (i >= a.cap) break;
    int64_t lo, hi;
    long long res = a.neutral;
    bool any = false;
    if (frame_of(a, i, n, &lo, &hi))
      for (int64_t j = lo; j <= hi; ++j) {
        res = mm<MAX, FLT>(res, halo[j - h0]);
        any = any || ok[j - h0];
      }
    store_out(a.out, i, a.esz, FLT, res, FLT);
    a.valid[i] = any;
  }
}

// Wide frames, level 0: every row's contribution.
template <bool FLT>
__global__ void minmax_level0_kernel(const MinmaxArgs a) {
  const int64_t n = live_rows(a.n_ptr, a.cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    a.levels[i] = contrib<FLT>(a, i, n);
    a.any_levels[i] = row_ok(a, i, n);
  }
}

// Level k from level k - 1: the fold over [i, i + 2^k) inside the segment.
template <bool MAX, bool FLT>
__global__ void minmax_level_kernel(const MinmaxArgs a, int k) {
  const int64_t step = 1LL << (k - 1);
  const int64_t* prev = a.levels + (int64_t)(k - 1) * a.cap;
  int64_t* cur = a.levels + (int64_t)k * a.cap;
  const uint8_t* prev_any = a.any_levels + (int64_t)(k - 1) * a.cap;
  uint8_t* cur_any = a.any_levels + (int64_t)k * a.cap;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = i + step;
    const bool same = j < a.cap && a.seg_id[j] == a.seg_id[i];
    cur[i] = mm<MAX, FLT>(prev[i], same ? prev[j] : a.neutral);
    cur_any[i] = prev_any[i] | (same ? prev_any[j] : 0);
  }
}

// Two level-k reads per row, k the largest level that fits the frame.
template <bool MAX, bool FLT>
__global__ void minmax_query_kernel(const MinmaxArgs a, int kmax) {
  const int64_t n = live_rows(a.n_ptr, a.cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t lo, hi;
    long long res = a.neutral;
    bool any = false;
    if (frame_of(a, i, n, &lo, &hi)) {
      const int64_t length = hi - lo + 1;
      int k = 0;
      while (k < kmax && length >= (2LL << k)) ++k;
      const int64_t p1 = clip(lo, a.cap);
      const int64_t p2 = clip(hi - (1LL << k) + 1, a.cap);
      const int64_t* lev = a.levels + (int64_t)k * a.cap;
      const uint8_t* lev_any = a.any_levels + (int64_t)k * a.cap;
      res = mm<MAX, FLT>(lev[p1], lev[p2]);
      any = lev_any[p1] || lev_any[p2];
    }
    store_out(a.out, i, a.esz, FLT, res, FLT);
    a.valid[i] = any;
  }
}

// Levels of the doubling table a frame of `width` rows needs: floor(log2
// width) + 1, so that two level-k reads cover any clipped frame.
int64_t table_levels(int64_t width) {
  int64_t levels = 1;
  while (width >= (2LL << (levels - 1))) ++levels;
  return levels;
}

// nlevels == 0: the halo path; else the doubling table with that many
// levels.
template <bool MAX, bool FLT>
void minmax_launch(const MinmaxArgs& a, int nlevels, cudaStream_t st) {
  const int64_t width = a.be - a.bs + 1;
  if (nlevels == 0) {
    const int64_t blocks = (a.cap + MINMAX_ROWS - 1) / MINMAX_ROWS;
    const size_t smem = (sizeof(long long) + 1) *
                        (MINMAX_ROWS + (width > 1 ? width : 1) - 1);
    minmax_halo_kernel<MAX, FLT><<<(unsigned)blocks, 256, smem, st>>>(a);
    return;
  }
  const int kmax = nlevels - 1;
  minmax_level0_kernel<FLT><<<grid_for(a.cap, 256), 256, 0, st>>>(a);
  for (int k = 1; k <= kmax; ++k)
    minmax_level_kernel<MAX, FLT><<<grid_for(a.cap, 256), 256, 0, st>>>(a,
                                                                          k);
  minmax_query_kernel<MAX, FLT><<<grid_for(a.cap, 256), 256, 0, st>>>(a,
                                                                        kmax);
}
}  // namespace

// K20. num_rows: int32 scalar (device); table: int64 HOST array, 4 words
// per key (values ptr, valid ptr or 0, element size, is_float), the npart
// partition keys then the norder order keys; counts: int64[ntiles + 1]
// scratch (the last entry ends as the packed totals); first: int64[2 *
// cap] scratch (each segment's, then each peer group's first row); seg_id,
// peer_id: int32[cap]; seg_start, seg_len, peer_start, peer_len:
// int64[cap]. Returns cudaGetLastError(), or -1 when the table exceeds
// TABLE_MAX.
TT_EXPORT int window_bounds(const void* num_rows, int64_t cap, int64_t npart,
                            int64_t norder, const void* table, void* counts,
                            void* first, void* seg_id, void* peer_id,
                            void* seg_start, void* seg_len, void* peer_start,
                            void* peer_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, 4 * (npart + norder), &t)) return -1;
  if (cap == 0) return (int)cudaGetLastError();
  const auto* n_ptr = static_cast<const int32_t*>(num_rows);
  const int64_t ntiles = (cap + WTILE - 1) / WTILE;
  auto* cnt = static_cast<int64_t*>(counts);
  auto* f = static_cast<int64_t*>(first);
  bounds_count_kernel<<<(unsigned)ntiles, WTHREADS, 0, s>>>(
      n_ptr, cap, npart, norder, t, cnt);
  tile_scan_kernel<<<1, 1024, 0, s>>>(cnt, ntiles,
                                      reinterpret_cast<long long*>(cnt + ntiles));
  bounds_ids_kernel<<<(unsigned)ntiles, WTHREADS, 0, s>>>(
      n_ptr, cap, npart, norder, t, cnt, f, f + cap,
      static_cast<int32_t*>(seg_id), static_cast<int32_t*>(peer_id));
  bounds_len_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      n_ptr, cap, cnt + ntiles, f, f + cap,
      static_cast<const int32_t*>(seg_id),
      static_cast<const int32_t*>(peer_id), static_cast<int64_t*>(seg_start),
      static_cast<int64_t*>(seg_len), static_cast<int64_t*>(peer_start),
      static_cast<int64_t*>(peer_len));
  return (int)cudaGetLastError();
}

// K22. x: the argument (0 for count(*)), x_valid its validity (0: none);
// op: ScanOp; read: Read; bs/be: the bounded frame's offsets where has_bs /
// has_be (a two-sided min/max frame is K23's); neutral: the fold's
// identity word (int64, or a double's bits); avg: 0, 1 (float) or 2
// (decimal); seg/peer arrays: K20's; tiles: int64[3 * ntiles] scratch;
// pref: int64[2 * cap]
// scratch; out: [cap] of out_esz bytes; valid: bool[cap] or 0. Returns
// cudaGetLastError(), or -1 for an unknown op.
TT_EXPORT int window_scan(const void* num_rows, int64_t cap, const void* x,
                          const void* x_valid, int64_t x_esz,
                          int64_t x_float, int64_t op, int64_t read,
                          int64_t has_bs, int64_t bs, int64_t has_be,
                          int64_t be, int64_t neutral, int64_t avg,
                          int64_t out_esz, int64_t out_float,
                          const void* seg_start, const void* seg_len,
                          const void* peer_start, const void* peer_len,
                          void* tiles, void* pref, void* out, void* valid,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op < OP_SUM || op > OP_COUNT || read < R_ROWS || read > R_REV_AT_LO)
    return -1;
  if (cap == 0) return (int)cudaGetLastError();
  auto* pv = static_cast<int64_t*>(pref);
  const ScanArgs s{static_cast<const int32_t*>(num_rows), cap, x,
                   static_cast<const uint8_t*>(x_valid), (int)x_esz,
                   (int)(read == R_REV_AT_LO), (long long)neutral,
                   static_cast<const int64_t*>(seg_start)};
  const ReadArgs r{static_cast<const int32_t*>(num_rows), cap, (int)read,
                   (int)has_bs, (int)has_be, bs, be, (long long)neutral,
                   (int)avg, (int)out_esz, (int)out_float,
                   static_cast<const int64_t*>(seg_start),
                   static_cast<const int64_t*>(seg_len),
                   static_cast<const int64_t*>(peer_start),
                   static_cast<const int64_t*>(peer_len), pv, pv + cap, out,
                   static_cast<uint8_t*>(valid)};
  auto* tl = static_cast<int64_t*>(tiles);
  const bool flt = x_float != 0;
  switch (op) {
    case OP_SUM:
      if (flt) scan_launch<OP_SUM, true>(s, r, tl, st);
      else scan_launch<OP_SUM, false>(s, r, tl, st);
      break;
    case OP_MIN:
      if (flt) scan_launch<OP_MIN, true>(s, r, tl, st);
      else scan_launch<OP_MIN, false>(s, r, tl, st);
      break;
    case OP_MAX:
      if (flt) scan_launch<OP_MAX, true>(s, r, tl, st);
      else scan_launch<OP_MAX, false>(s, r, tl, st);
      break;
    default:
      scan_launch<OP_COUNT, false>(s, r, tl, st);
      break;
  }
  return (int)cudaGetLastError();
}

// The doubling-table levels K23 runs a bounded frame [bs, be] with: 0
// where the frame is at most MINMAX_NARROW rows wide (the halo path),
// else table_levels(width).
TT_EXPORT int window_minmax_levels(int64_t bs, int64_t be) {
  const int64_t width = be - bs + 1;
  return width <= MINMAX_NARROW ? 0 : (int)table_levels(width);
}

// K23. x: the argument, x_valid its validity (0: none); is_max; bs <= be
// not required (an inverted frame is empty everywhere); neutral: the
// identity word; seg arrays: K20's; nlevels: 0 for the halo path (a frame
// of at most MINMAX_NARROW rows), else the doubling table's levels, at
// least table_levels(width), with levels: int64[nlevels * cap] and
// any_levels: uint8[nlevels * cap] scratch; out: [cap] in x's type;
// valid: bool[cap]. Returns cudaGetLastError(), or -1 when the halo is
// asked for a wide frame or the table has too few levels.
TT_EXPORT int window_minmax(const void* num_rows, int64_t cap, const void* x,
                            const void* x_valid, int64_t x_esz,
                            int64_t x_float, int64_t is_max, int64_t bs,
                            int64_t be, int64_t neutral,
                            const void* seg_start, const void* seg_len,
                            const void* seg_id, void* levels,
                            void* any_levels, int64_t nlevels, void* out,
                            void* valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t width = be - bs + 1;
  if (nlevels == 0 ? width > MINMAX_NARROW
                   : (levels == nullptr || any_levels == nullptr ||
                      nlevels < table_levels(width)))
    return -1;
  if (cap == 0) return (int)cudaGetLastError();
  const MinmaxArgs a{static_cast<const int32_t*>(num_rows), cap, x,
                     static_cast<const uint8_t*>(x_valid), (int)x_esz, bs, be,
                     (long long)neutral, static_cast<const int64_t*>(seg_start),
                     static_cast<const int64_t*>(seg_len),
                     static_cast<const int32_t*>(seg_id),
                     static_cast<int64_t*>(levels),
                     static_cast<uint8_t*>(any_levels), out,
                     static_cast<uint8_t*>(valid)};
  if (is_max) {
    if (x_float) minmax_launch<true, true>(a, (int)nlevels, st);
    else minmax_launch<true, false>(a, (int)nlevels, st);
  } else {
    if (x_float) minmax_launch<false, true>(a, (int)nlevels, st);
    else minmax_launch<false, false>(a, (int)nlevels, st);
  }
  return (int)cudaGetLastError();
}
