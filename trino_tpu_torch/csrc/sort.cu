// K10: stable sort of a page's rows by its ORDER BY keys.
//
// Replaces trino_tpu/ops/sort.py order_by / top_n_masked (:71/:86), one
// multi-operand stable lax.sort whose leading operands are the dead-row
// flag and, per key, a null flag and a NaN flag before the value.
//
// Two launches of work:
//   1. sort_encode — one thread per live row packs those operands, most
//      significant first, into order-preserving 64-bit words (the layout
//      of trino_tpu_torch/ops/sort.py sort_layout: a field never straddles
//      two words). A word is stored as int64 with its sign bit flipped, as
//      ops/sort.py encode_sort_keys (its plain twin) stores it.
//   2. sort_radix — an LSD radix sort of the live prefix [0, num_rows)
//      over 8-bit digits that carries an int32 permutation; only the bytes
//      a field occupies get a pass. Up to ONE_BLOCK_ROWS rows one block
//      runs every pass in one launch (a digit histogram, a 256-bin scan and
//      a stable scatter per pass, the permutation ping-ponging through
//      global memory); above that each pass is three launches of
//      csrc/tile.cuh's binned tiles (per-tile histogram, one exclusive scan
//      in digit-major order, a stable scatter per tile).
//
// Bound on this card: bytes — the key columns of the live rows read once
// and the int32 permutation written once. The design reads each row's key
// words once per digit pass (a gather through the permutation, L2-resident
// for the main path's sorts of at most ~1e5 rows) and favours few launches
// over bandwidth: the main path's sorts are small (4 rows in q1, 18,314 in
// q16, ~12k groups in q3 at sf1), where launch count, not bytes, sets the
// time.
#include "tile.cuh"

namespace {
constexpr int ONE_BLOCK_ROWS = 1 << 16;  // ops/sort.py ONE_BLOCK_ROWS
constexpr int ONE_BLOCK_THREADS = 1024;
constexpr uint64_t SIGN = 0x8000000000000000ULL;

// field kinds, as ops/sort.py
enum { DEAD = 0, NULLF = 1, NANF = 2, VALUE = 3 };

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// The unsigned, order-preserving value of one field of row i. Key k is
// described by 4 words of `cols`: values ptr, valid ptr (0 = none),
// element size, flags (1 float, 2 ascending, 4 nulls first, 8 bool).
__device__ __forceinline__ uint64_t field_value(const int64_t* cols, int kind,
                                                int key, int64_t i,
                                                int64_t n) {
  if (kind == DEAD) return i >= n ? 1ULL : 0ULL;
  const int64_t* c = cols + 4 * key;
  const void* vals = reinterpret_cast<const void*>(c[0]);
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  const int esz = (int)c[2];
  const int flags = (int)c[3];
  const bool is_float = flags & 1, asc = flags & 2, nulls_first = flags & 4;
  const bool is_bool = flags & 8;
  const bool ok = valid == nullptr || valid[i];
  if (kind == NULLF) return (nulls_first ? ok : !ok) ? 1ULL : 0ULL;
  if (is_float) {
    double x = ok ? load_float(vals, i, esz) : 0.0;
    const bool nan = x != x;
    if (kind == NANF) return (asc ? nan : !nan) ? 1ULL : 0ULL;
    if (nan) x = 0.0;
    if (!asc) x = -x;
    if (x == 0.0) x = 0.0;  // the reference's comparator: -0.0 == +0.0
    return (uint64_t)ordered_key(x) ^ SIGN;
  }
  if (is_bool) {
    const bool b = ok && static_cast<const uint8_t*>(vals)[i] != 0;
    return (asc ? b : !b) ? 1ULL : 0ULL;
  }
  int64_t v = ok ? load_int(vals, i, esz) : 0;
  if (esz == 8) {
    // the reference's negation wraps: INT64_MIN stays INT64_MIN
    if (!asc) v = (int64_t)(0ULL - (uint64_t)v);
    return (uint64_t)v ^ SIGN;
  }
  if (!asc) {  // negated in the column's own width, wrapping
    if (esz == 4) v = (int32_t)(0u - (uint32_t)v);
    else if (esz == 2) v = (int16_t)(uint16_t)(0u - (uint32_t)v);
    else v = (int8_t)(uint8_t)(0u - (uint32_t)v);
  }
  return (uint64_t)((uint32_t)(int32_t)v ^ 0x80000000u);
}

// One thread per live row: every word of the row, written in order.
// `tbl` holds the key table (4 words per key) then the fields (kind, key,
// word, shift, width per field, ordered by word).
__global__ void encode_kernel(const int32_t* __restrict__ n_ptr, int64_t cap,
                              int64_t nkeys, int64_t nfields,
                              const __grid_constant__ Table tbl,
                              int64_t* __restrict__ words) {
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t* cols = tbl.v;
  const int64_t* fields = tbl.v + 4 * nkeys;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t cur = fields[2];
    uint64_t acc = 0;
    for (int64_t f = 0; f < nfields; ++f) {
      const int64_t* fd = fields + 5 * f;
      if (fd[2] != cur) {
        words[cur * cap + i] = (int64_t)(acc ^ SIGN);
        cur = fd[2];
        acc = 0;
      }
      const int width = (int)fd[4];
      uint64_t u = field_value(cols, (int)fd[0], (int)fd[1], i, n);
      if (width < 64) u &= (1ULL << width) - 1ULL;
      acc |= u << fd[3];
    }
    words[cur * cap + i] = (int64_t)(acc ^ SIGN);
  }
}

// The 8-bit digit at `shift` of row perm[i]'s word (the stored word with
// its sign bit flipped back: the unsigned value).
struct Digit {
  const int64_t* word;
  const int32_t* perm;
  int shift;
  __device__ __forceinline__ int operator()(int64_t i) const {
    const uint64_t u = (uint64_t)word[perm[i]] ^ SIGN;
    return (int)((u >> shift) & 0xFFu);
  }
};

struct Passes {
  int32_t word[256];
  int32_t shift[256];
};

// perm[i] = i over [from, cap) of one or two buffers.
__global__ void iota_kernel(int32_t* a, int32_t* b, const int32_t* n_ptr,
                            int64_t cap) {
  const int64_t n = live_rows(n_ptr, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    a[i] = (int32_t)i;
    if (b != nullptr && i >= n) b[i] = (int32_t)i;
  }
}

// Every pass in one block: the permutation ping-pongs between src and dst
// (global memory, visible to the whole block after each __syncthreads);
// the caller picks the first buffer so that the last pass writes `out`.
__global__ void one_block_kernel(const int32_t* __restrict__ n_ptr,
                                 int64_t cap,
                                 const int64_t* __restrict__ words,
                                 int npasses, const __grid_constant__ Passes p,
                                 int32_t* first, int32_t* second) {
  __shared__ int hist[NBINS];
  __shared__ long long base[NBINS];
  __shared__ int warp_sums[32];
  const int64_t n = live_rows(n_ptr, cap);
  int32_t* src = first;
  int32_t* dst = second;
  for (int q = 0; q < npasses; ++q) {
    const Digit digit{words + (int64_t)p.word[q] * cap, src, p.shift[q]};
    for (int b = threadIdx.x; b < NBINS; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
      atomicAdd(&hist[digit(i)], 1);
    __syncthreads();
    const int v = threadIdx.x < NBINS ? hist[threadIdx.x] : 0;
    int total;
    const int ex = block_exclusive_scan(v, warp_sums, &total);
    if (threadIdx.x < NBINS) base[threadIdx.x] = ex;
    __syncthreads();
    block_bin_scatter(digit, 0, n, base,
                      [&](int64_t i, int64_t pos) { dst[pos] = src[i]; });
    __syncthreads();
    int32_t* t = src;
    src = dst;
    dst = t;
  }
}

// One multi-block pass, launch 3: each tile's rows to their places.
__global__ void tile_digit_scatter_kernel(const Digit digit,
                                          const int32_t* __restrict__ n_ptr,
                                          int64_t cap, int64_t ntiles,
                                          const int64_t* __restrict__ offsets,
                                          int32_t* dst) {
  __shared__ long long base[NBINS];
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t lo = (int64_t)blockIdx.x * TILE;
  if (lo >= n) return;  // uniform across the block
  const int64_t hi = lo + TILE < n ? lo + TILE : n;
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x)
    base[b] = offsets[(int64_t)b * ntiles + blockIdx.x];
  __syncthreads();
  const int32_t* src = digit.perm;
  block_bin_scatter(digit, lo, hi, base,
                    [&](int64_t i, int64_t pos) { dst[pos] = src[i]; });
}

int grid_for(int64_t rows, int threads) {
  int64_t blocks = (rows + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 4224 ? 4224 : blocks);  // grid-stride beyond
}
}  // namespace

// num_rows: int32 scalar (device); table: int64 HOST array, 4 words per
// key (values ptr, valid ptr or 0, element size, flags) then 5 per field
// (kind, key, word, shift, width) in layout order; words: int64[nwords *
// cap], word w of row i at w * cap + i (rows past num_rows untouched).
// Returns cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int sort_encode(const void* num_rows, int64_t cap, int64_t nkeys,
                          int64_t nfields, const void* table, void* words,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nfields < 1 || load_table(table, 4 * nkeys + 5 * nfields, &t))
    return -1;
  if (cap > 0)
    encode_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
        static_cast<const int32_t*>(num_rows), cap, nkeys, nfields, t,
        static_cast<int64_t*>(words));
  return (int)cudaGetLastError();
}

// words: as sort_encode wrote them; passes: int64 HOST array [word of each
// pass (npasses), shift of each pass (npasses)], least significant first;
// perm: int32[cap] out (the live prefix sorted, rows past num_rows in
// place); tmp: int32[cap] scratch; hist: int64[256 * ceil(cap / 4096) + 1]
// scratch (multi-block only); one_block: cap <= ONE_BLOCK_ROWS. Returns
// cudaGetLastError(), or -1 for more than 256 passes.
TT_EXPORT int sort_radix(const void* num_rows, int64_t cap, const void* words,
                         int64_t npasses, const void* passes, void* perm,
                         void* tmp, void* hist, int64_t one_block,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npasses < 0 || npasses > 256) return -1;
  if (one_block && cap > ONE_BLOCK_ROWS) return -1;
  if (cap == 0) return (int)cudaGetLastError();
  Passes p;
  const int64_t* pt = static_cast<const int64_t*>(passes);
  for (int64_t q = 0; q < npasses; ++q) {
    p.word[q] = (int32_t)pt[q];
    p.shift[q] = (int32_t)pt[npasses + q];
  }
  const auto* n_ptr = static_cast<const int32_t*>(num_rows);
  const auto* w = static_cast<const int64_t*>(words);
  auto* out = static_cast<int32_t*>(perm);
  auto* other = static_cast<int32_t*>(tmp);
  // the pass count's parity picks the first buffer: the last pass writes
  // `out`, whose tail past num_rows stays the identity
  int32_t* first = (npasses % 2 == 0) ? out : other;
  int32_t* second = (npasses % 2 == 0) ? other : out;
  iota_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      first, first == out ? nullptr : out, n_ptr, cap);
  if (one_block) {
    one_block_kernel<<<1, ONE_BLOCK_THREADS, 0, s>>>(n_ptr, cap, w,
                                                     (int)npasses, p, first,
                                                     second);
    return (int)cudaGetLastError();
  }
  const int64_t ntiles = tile_blocks(cap);
  auto* counts = static_cast<int64_t*>(hist);
  int32_t* src = first;
  int32_t* dst = second;
  for (int64_t q = 0; q < npasses; ++q) {
    const Digit digit{w + (int64_t)p.word[q] * cap, src, p.shift[q]};
    tile_bin_count_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, s>>>(
        digit, n_ptr, cap, ntiles, counts);
    tile_scan_kernel<<<1, 1024, 0, s>>>(counts, NBINS * ntiles,
                                        counts + NBINS * ntiles);
    tile_digit_scatter_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, s>>>(
        digit, n_ptr, cap, ntiles, counts, dst);
    int32_t* t = src;
    src = dst;
    dst = t;
  }
  return (int)cudaGetLastError();
}
