// K10: stable sort of a page's rows by its ORDER BY keys.
//
// Replaces trino_tpu/ops/sort.py order_by / top_n_masked (:71/:86), one
// multi-operand stable lax.sort whose leading operands are the dead-row
// flag and, per key, a null flag and a NaN flag before the value.
//
// sort_encode — one thread per live row packs those operands, most
// significant first, into order-preserving 64-bit words (the layout of
// trino_tpu_torch/ops/sort.py sort_layout: a field never straddles two
// words). A word is stored as int64 with its sign bit flipped, as
// ops/sort.py encode_sort_keys (its plain twin) stores it.
//
// sort_radix — an LSD radix sort of the live prefix [0, num_rows) over the
// 8-bit digit passes it is given (least significant first), giving the
// int32 permutation; rows past num_rows stay in place. Every sort of the
// port goes through it (ORDER BY/TopN, windows, K16, K31, K33, the u64
// sort of detect_heavy_keys and rank_bounds).
//
// Bound on this card: bytes — the key words of the live rows read once and
// the int32 permutation written once. An LSD pass that moves (u64 key,
// int32 index) pairs reads and writes 24 B a row; what the design spends
// beyond the bound is one such pass per informative digit and one gather
// per word. What it does about the four limits of the earlier design:
//   1. One launch per digit pass ("onesweep", Adinets and Merrill, 2022),
//      not a per-tile histogram, a one-block scan of 256 x ntiles counts
//      and a scatter. The digit counts of every pass come from one
//      histogram launch up front (the counts of a byte do not depend on the
//      order of the rows), whose last block turns them into digit bases.
//      A tile of TILE_ROWS rows takes its id from an atomic counter, ranks
//      its rows by digit in shared memory (__match_any_sync per warp, then
//      per-digit warp prefixes), publishes per digit its count and then its
//      inclusive prefix in 64-bit status words (2-bit flag, 62-bit count)
//      and finds its own prefix by decoupled look-back over the tiles
//      before it. Its rows leave through shared memory, each digit's run as
//      one contiguous, ordered stretch. Tiles hold consecutive rows and
//      ranks keep row order, so the sort is stable.
//   2. Keys move with the permutation: per word (least significant first)
//      one gather reads the word through the current permutation, and that
//      word's passes then move (key, index) pairs read in order. No pass
//      reads word[perm[i]].
//   3. A pass whose digit is the same in every live row (one bin holds all
//      of them) changes nothing in a stable sort. The histogram launch marks
//      it, and its launch returns at once; a word whose passes are all
//      trivial skips its gather. Which pair buffer is current follows from
//      the number of informative passes before a pass (plan.order), on the
//      device, so nothing waits for the host.
//   4. A live prefix of at most SMALL_ROWS rows is sorted by one block in
//      shared memory over every informative pass (both pair buffers fit in
//      its 227 KB), with no global ping-pong, in one launch when the
//      capacity is that small (else the multi-block launches see the live
//      count on the device and do nothing). SMALL_ROWS is what two buffers
//      of 12-byte pairs and the per-warp counters leave room for; on an
//      H100 one block at 8,192 rows is faster than the multi-block passes
//      at 8,193 (chip_smoke.py phase 4 prints both), so the shared-memory
//      bound is the threshold.
// Scratch (allocated by the wrapper): two u64 key buffers and one int32
// index buffer of the capacity (the other index buffer is `perm`), the
// plan (counts and bases, order, counters) and two status buffers of
// 256 words per tile.
#include "common.cuh"

namespace {
constexpr uint64_t SIGN = 0x8000000000000000ULL;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int RADIX = 256;
constexpr int MAX_PASSES = 256;
constexpr int GROUP_PASSES = 8;       // passes per gather (ops/sort.py)

constexpr int SMALL_ROWS = 8192;      // ops/sort.py SMALL_ROWS
constexpr int SMALL_THREADS = 1024;
constexpr int SMALL_IPT = SMALL_ROWS / SMALL_THREADS;
constexpr int HIST_ROWS = 8;          // consecutive rows a thread counts
constexpr int SMALL_WARPS = SMALL_THREADS / 32;
static_assert(SMALL_THREADS * HIST_ROWS >= SMALL_ROWS,
              "one count_runs call per thread covers the one-block rows");
constexpr size_t SMALL_SMEM =
    2 * SMALL_ROWS * (sizeof(uint64_t) + sizeof(int32_t)) +
    SMALL_WARPS * RADIX * sizeof(unsigned short) +
    GROUP_PASSES * RADIX * sizeof(int) + RADIX * sizeof(int);

// A tile is 256 threads of 16 keys: on an H100 tiles of 4,096 rows sort
// 8,388,608 rows faster than tiles of 2,048 or 3,072 (`python3 -m
// trino_tpu_torch.k10_tiles` times them; 16 keys a thread reach the 128
// registers that two blocks per SM allow).
constexpr int PASS_THREADS = 256;     // one thread per digit
constexpr int PASS_IPT = 16;
constexpr int TILE_ROWS = PASS_THREADS * PASS_IPT;   // ops/sort.py SORT_TILE
constexpr int PASS_WARPS = PASS_THREADS / 32;
constexpr size_t PASS_SMEM =
    TILE_ROWS * (sizeof(uint64_t) + sizeof(int32_t)) +
    PASS_WARPS * RADIX * sizeof(int) + RADIX * sizeof(int) +
    RADIX * sizeof(long long);

constexpr int HIST_THREADS = 256;     // one thread per digit in the plan
constexpr int HIST_PASSES = 32;       // passes counted per block (y chunk)
constexpr int HIST_BLOCKS = 264;      // two per SM

constexpr uint64_t FLAG_AGGREGATE = 1ULL << 62;
constexpr uint64_t FLAG_PREFIX = 2ULL << 62;
constexpr uint64_t COUNT_MASK = (1ULL << 62) - 1;

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

// ------------------------------------------------------------ radix sort

// The digit passes (word, shift; least significant first) and their
// groups: runs of passes over one word, at most GROUP_PASSES long, each
// preceded by one gather of that word (group g is passes
// [start[g], start[g + 1])).
struct Passes {
  int32_t word[MAX_PASSES];
  int32_t shift[MAX_PASSES];
  int32_t start[MAX_PASSES + 1];
  int32_t ngroups;
};

// The device-side plan of one multi-block sort, in one int64 scratch
// array zeroed before the histogram launch: base[q][d] (the counts of
// pass q's digit d, then their exclusive scan), order[q] (the number of
// informative passes before q, or -1 for a trivial pass; order[npasses]
// is their total), the histogram's finished-block counter and one tile
// counter per status buffer.
struct Plan {
  long long* base;
  long long* order;
  unsigned long long* done;
  unsigned long long* tiles;
};

Plan make_plan(void* p, int npasses) {
  long long* b = static_cast<long long*>(p);
  long long* o = b + (int64_t)npasses * RADIX;
  auto* c = reinterpret_cast<unsigned long long*>(o + npasses + 1);
  return Plan{b, o, c, c + 1};
}

int64_t plan_words(int64_t npasses) {
  return npasses * RADIX + npasses + 1 + 3;
}

__device__ __forceinline__ int digit_of(uint64_t u, int shift) {
  return (int)((u >> shift) & 0xFFu);
}

// Status words are read and written by tiles running at once.
__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The lanes of `act` whose 8-bit digit equals this lane's, by one ballot
// per bit or by __match_any_sync (kMatch). Every lane calls it.
template <bool kMatch = false>
__device__ __forceinline__ unsigned digit_peers(int d, unsigned act) {
  if (kMatch) return __match_any_sync(FULL_MASK, d) & act;
  unsigned peers = act;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned v = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? v : ~v;
  }
  return peers;
}

// h[d] += the rows of digit d among this thread's HIST_ROWS consecutive
// rows u[0, nvalid): one shared atomic per run of one digit, and one for
// the whole warp when all its rows share one digit. Every lane calls it.
__device__ __forceinline__ void count_runs(int* h, const uint64_t* u,
                                           int nvalid, int shift) {
  int prev = digit_of(u[0], shift), cnt = nvalid > 0;
  bool one_run = true;
#pragma unroll
  for (int j = 1; j < HIST_ROWS; ++j) {
    const int d = digit_of(u[j], shift);
    if (j < nvalid) {
      if (d == prev) {
        ++cnt;
      } else {
        atomicAdd(&h[prev], cnt);
        prev = d;
        cnt = 1;
        one_run = false;
      }
    }
  }
  const int d0 = __shfl_sync(FULL_MASK, prev, 0);
  if (__all_sync(FULL_MASK, one_run && (cnt == 0 || prev == d0))) {
    const int total = (int)__reduce_add_sync(FULL_MASK, (unsigned)cnt);
    if ((threadIdx.x & 31) == 0 && total) atomicAdd(&h[d0], total);
  } else if (cnt) {
    atomicAdd(&h[prev], cnt);
  }
}

// The rank of this lane's row among the warp's rows of digit d so far
// (lanes in order), advancing the warp's count of d in wc. Every lane
// calls it; `valid` false takes no part.
template <bool kMatch, class Count>
__device__ __forceinline__ int warp_rank(Count* wc, int d, bool valid) {
  const int lane = threadIdx.x & 31;
  const unsigned peers =
      digit_peers<kMatch>(d, __ballot_sync(FULL_MASK, valid));
  const int before = valid ? (int)wc[d] : 0;
  __syncwarp();
  if (valid && lane == __ffs(peers) - 1)
    wc[d] = (Count)(before + __popc(peers));
  __syncwarp();
  return before + __popc(peers & ((1u << lane) - 1u));
}

// Launch 1 of a multi-block sort: the digit counts of every pass over the
// live rows (blockIdx.y picks HIST_PASSES passes; each thread reads
// HIST_ROWS consecutive rows of their words once, two rows per 16-byte
// load where the word is aligned), then, in the last block to finish, the
// digit bases and the order of the informative passes. It also zeroes the
// first status buffer over the live tiles. A live prefix of at most
// SMALL_ROWS rows is the one-block kernel's: every pass is then marked
// trivial here.
__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const int32_t* __restrict__ n_ptr, int64_t cap,
    const int64_t* __restrict__ words, int npasses,
    const __grid_constant__ Passes p, Plan plan,
    uint64_t* __restrict__ status0) {
  __shared__ int hist[HIST_PASSES][RADIX];
  __shared__ bool trivial_pass[MAX_PASSES];
  __shared__ bool last;
  const int64_t n = live_rows(n_ptr, cap);
  if (n <= SMALL_ROWS) {
    if (blockIdx.x == 0 && blockIdx.y == 0)
      for (int q = threadIdx.x; q <= npasses; q += blockDim.x)
        plan.order[q] = q < npasses ? -1 : 0;
    return;
  }
  if (blockIdx.y == 0) {
    const int64_t m = (n + TILE_ROWS - 1) / TILE_ROWS * RADIX;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
         i += (int64_t)gridDim.x * blockDim.x)
      status0[i] = 0;
  }
  const int q0 = blockIdx.y * HIST_PASSES;
  const int nq = min(HIST_PASSES, npasses - q0);
  for (int i = threadIdx.x; i < nq * RADIX; i += blockDim.x)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int64_t b = blockIdx.x * (int64_t)blockDim.x; b * HIST_ROWS < n;
       b += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r0 = (b + threadIdx.x) * HIST_ROWS;
    const int nvalid = (int)max((int64_t)0, min((int64_t)HIST_ROWS, n - r0));
    int w = -1;
    uint64_t u[HIST_ROWS];
    for (int qi = 0; qi < nq; ++qi) {
      const int q = q0 + qi;
      if (p.word[q] != w) {
        w = p.word[q];
        const int64_t* wp = words + (int64_t)w * cap + r0;
        if ((reinterpret_cast<uintptr_t>(wp) & 15) == 0 &&
            nvalid == HIST_ROWS) {
#pragma unroll
          for (int j = 0; j < HIST_ROWS; j += 2) {
            const longlong2 v = reinterpret_cast<const longlong2*>(wp)[j / 2];
            u[j] = (uint64_t)v.x ^ SIGN;
            u[j + 1] = (uint64_t)v.y ^ SIGN;
          }
        } else {
#pragma unroll
          for (int j = 0; j < HIST_ROWS; ++j)
            u[j] = j < nvalid ? (uint64_t)wp[j] ^ SIGN : 0;
        }
      }
      count_runs(hist[qi], u, nvalid, p.shift[q]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * RADIX; i += blockDim.x) {
    const int c = (&hist[0][0])[i];
    if (c)
      atomicAdd(reinterpret_cast<unsigned long long*>(plan.base) +
                    (int64_t)q0 * RADIX + i,
                (unsigned long long)c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(plan.done, 1ULL) ==
           (unsigned long long)gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the plan, one warp per pass: the digit bases (8 digits a lane) and
  // whether one digit holds every live row (trivial); then the
  // informative passes numbered in order
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < npasses; q += HIST_THREADS / 32) {
    long long* c = plan.base + (int64_t)q * RADIX + 8 * lane;
    long long v[8], sum = 0;
    bool full = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __ldcg(c + j);
      sum += v[j];
      full |= v[j] == n;
    }
    long long x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL_MASK, x, o);
      if (lane >= o) x += y;
    }
    long long ex = x - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = ex;
      ex += v[j];
    }
    const bool trivial = __any_sync(FULL_MASK, full);
    if (lane == 0) trivial_pass[q] = trivial;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long k = 0;
    for (int q = 0; q < npasses; ++q) {
      plan.order[q] = trivial_pass[q] ? -1 : k;
      k += !trivial_pass[q];
    }
    plan.order[npasses] = k;
  }
}

// The number of informative passes before the first informative pass of
// [q0, q1), or -1 when every pass of the range is trivial.
__device__ __forceinline__ long long first_order(const long long* order,
                                                 int q0, int q1) {
  for (int q = q0; q < q1; ++q)
    if (order[q] >= 0) return order[q];
  return -1;
}

// The two (key, index) buffers and the two status buffers; idx0 is
// `perm`. Buffer k & 1 is picked by select, not by indexing a parameter
// array (which would copy it to local memory).
struct Pairs {
  uint64_t* keys0;     // the unsigned words
  uint64_t* keys1;
  int32_t* idx0;
  int32_t* idx1;
  uint64_t* status0;
  uint64_t* status1;
  __device__ uint64_t* keys(long long k) const {
    return (k & 1) ? keys1 : keys0;
  }
  __device__ int32_t* idx(long long k) const { return (k & 1) ? idx1 : idx0; }
  __device__ uint64_t* status(long long k) const {
    return (k & 1) ? status1 : status0;
  }
};

// One gather per word group: the current key buffer gets the word of each
// current row (the identity before the first informative pass). Returns
// at once when every pass of the group is trivial.
__global__ void gather_kernel(const int32_t* __restrict__ n_ptr, int64_t cap,
                              const int64_t* __restrict__ word, int q0,
                              int q1, const long long* __restrict__ order,
                              Pairs a) {
  const long long k = first_order(order, q0, q1);
  if (k < 0) return;
  const int64_t n = live_rows(n_ptr, cap);
  uint64_t* keys = a.keys(k);
  const int32_t* idx = a.idx(k);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    keys[i] = (uint64_t)word[k == 0 ? i : (int64_t)idx[i]] ^ SIGN;
}

// One digit pass over the (key, index) pairs: see the note at the top.
// The pass's rank k among the informative passes picks the buffers
// (source k & 1, destination the other), its status buffer and tile
// counter; it zeroes the other status buffer's words of its tile and the
// other counter for the next informative pass. Keys are not written by
// the last informative pass of a group that another gather follows (its
// keys are never read again) unless the caller wants the sorted keys.
__global__ void __launch_bounds__(PASS_THREADS, 2) pass_kernel(
    const int32_t* __restrict__ n_ptr, int64_t cap, int q, int q_end,
    int shift, int keep_keys, Plan plan, Pairs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* s_keys = reinterpret_cast<uint64_t*>(smem);
  auto* s_idx = reinterpret_cast<int32_t*>(s_keys + TILE_ROWS);
  int* s_wcnt = s_idx + TILE_ROWS;                 // [PASS_WARPS][RADIX]
  int* s_local = s_wcnt + PASS_WARPS * RADIX;      // tile's digit starts
  auto* s_out = reinterpret_cast<long long*>(s_local + RADIX);
  __shared__ long long s_tile;
  __shared__ int warp_sums[32];
  const long long k = plan.order[q];
  if (k < 0) return;  // trivial: a stable pass over one digit moves nothing
  const int64_t n = live_rows(n_ptr, cap);
  const int par = (int)(k & 1);
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd(&plan.tiles[par], 1ULL);
  __syncthreads();
  const int64_t t = s_tile;
  if (t == 0 && threadIdx.x == 0) plan.tiles[par ^ 1] = 0;
  if (t * TILE_ROWS >= n) return;
  a.status(k + 1)[t * RADIX + threadIdx.x] = 0;
  const bool write_keys =
      keep_keys || first_order(plan.order, q + 1, q_end) >= 0;
  const uint64_t* src_k = a.keys(k);
  const int32_t* src_i = a.idx(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = t * TILE_ROWS + warp * (32 * PASS_IPT) + lane;
  uint64_t key[PASS_IPT];
  int32_t id[PASS_IPT];
#pragma unroll
  for (int j = 0; j < PASS_IPT; ++j) {
    const int64_t r = row0 + 32 * j;
    key[j] = r < n ? src_k[r] : 0;
    id[j] = r < n ? (k == 0 ? (int32_t)r : src_i[r]) : 0;
  }
  for (int i = threadIdx.x; i < PASS_WARPS * RADIX; i += PASS_THREADS)
    s_wcnt[i] = 0;
  __syncthreads();
  // rank within the warp: rows in order (j, then lane)
  int rank[PASS_IPT];
  int* wc = s_wcnt + warp * RADIX;
#pragma unroll
  for (int j = 0; j < PASS_IPT; ++j)
    rank[j] = warp_rank<false>(wc, digit_of(key[j], shift),
                               row0 + 32 * j < n);
  __syncthreads();
  // thread d: digit d's warp prefixes and its count in this tile, which
  // it publishes at once (tile 0's count is already its prefix), then its
  // start in the tile's digit order
  const int d = threadIdx.x;
  int count = 0;
  for (int w = 0; w < PASS_WARPS; ++w) {
    const int c = s_wcnt[w * RADIX + d];
    s_wcnt[w * RADIX + d] = count;
    count += c;
  }
  uint64_t* st = a.status(k) + t * RADIX + d;
  store_status(st, (t == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) | (uint64_t)count);
  int tile_total;
  const int local = block_exclusive_scan(count, warp_sums, &tile_total);
  s_local[d] = local;
  __syncthreads();
  // the tile's rows in digit order into shared memory
#pragma unroll
  for (int j = 0; j < PASS_IPT; ++j) {
    if (row0 + 32 * j < n) {
      const int dj = digit_of(key[j], shift);
      const int pos = s_local[dj] + s_wcnt[warp * RADIX + dj] + rank[j];
      s_keys[pos] = key[j];
      s_idx[pos] = id[j];
    }
  }
  // decoupled look-back over the tiles before this one, then the
  // inclusive prefix published
  long long before = 0;
  if (t > 0) {
    for (int64_t u = 1; u <= t; ++u) {
      uint64_t s;
      do {
        s = load_status(st - u * RADIX);
      } while (s == 0);
      before += (long long)(s & COUNT_MASK);
      if (s & FLAG_PREFIX) break;
    }
    store_status(st, FLAG_PREFIX | (uint64_t)(before + count));
  }
  s_out[d] = plan.base[(int64_t)q * RADIX + d] + before - local;
  __syncthreads();
  const int live = (int)min((int64_t)TILE_ROWS, n - t * TILE_ROWS);
  uint64_t* dst_k = a.keys(k + 1);
  int32_t* dst_i = a.idx(k + 1);
  for (int i = threadIdx.x; i < live; i += PASS_THREADS) {
    const uint64_t kk = s_keys[i];
    const int64_t out = s_out[digit_of(kk, shift)] + i;
    if (write_keys) dst_k[out] = kk;
    dst_i[out] = s_idx[i];
  }
}

// The last launch of a multi-block sort: perm gets the current index
// buffer over the live rows (the identity when no pass was informative)
// and the identity past them; keys_out (when given) the sorted unsigned
// words of the last group's word. A live prefix of at most SMALL_ROWS rows
// was written by the one-block kernel: only the tail is left.
__global__ void finish_kernel(const int32_t* __restrict__ n_ptr, int64_t cap,
                              int npasses, int q_last,
                              const long long* __restrict__ order, Pairs a,
                              const int64_t* __restrict__ last_word,
                              int64_t* __restrict__ keys_out) {
  const int64_t n = live_rows(n_ptr, cap);
  const long long total = order[npasses];
  const bool gathered = first_order(order, q_last, npasses) >= 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i >= n) {
      a.idx0[i] = (int32_t)i;
      continue;
    }
    if (n <= SMALL_ROWS) continue;
    const int32_t id = total == 0 ? (int32_t)i : a.idx(total)[i];
    if (total == 0 || (total & 1)) a.idx0[i] = id;
    if (keys_out != nullptr)
      keys_out[i] = (int64_t)(gathered ? a.keys(total)[i]
                                       : (uint64_t)last_word[id] ^ SIGN);
  }
}

// Every pass of a live prefix of at most SMALL_ROWS rows in one block:
// per group, the digit counts of its passes (read from the word in row
// order), its trivial passes marked, one gather of the word into shared
// memory, then each informative pass ranks the rows as pass_kernel does
// (one warp per SMALL_IPT x 32 rows) and moves the pairs between the two
// shared buffers. Writes perm and keys_out over the live rows, and the
// identity tail when `write_tail` (capacity at most SMALL_ROWS).
__global__ void __launch_bounds__(SMALL_THREADS, 1) small_kernel(
    const int32_t* __restrict__ n_ptr, int64_t cap,
    const int64_t* __restrict__ words, const __grid_constant__ Passes p,
    int32_t* __restrict__ perm, int64_t* __restrict__ keys_out,
    int write_tail) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* s_keys = reinterpret_cast<uint64_t*>(smem);       // [2][SMALL_ROWS]
  auto* s_idx = reinterpret_cast<int32_t*>(s_keys + 2 * SMALL_ROWS);
  auto* s_wcnt = reinterpret_cast<unsigned short*>(s_idx + 2 * SMALL_ROWS);
  auto* s_hist = reinterpret_cast<int*>(s_wcnt + SMALL_WARPS * RADIX);
  int* s_base = s_hist + GROUP_PASSES * RADIX;
  __shared__ int warp_sums[32];
  __shared__ int s_trivial;
  const int64_t n = live_rows(n_ptr, cap);
  if (n > SMALL_ROWS) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int used_warps = (int)((n + 32 * SMALL_IPT - 1) / (32 * SMALL_IPT));
  int cur = 0, k = 0;
  bool gathered = false;
  for (int g = 0; g < p.ngroups; ++g) {
    const int q0 = p.start[g], nq = p.start[g + 1] - q0;
    const int64_t* word = words + (int64_t)p.word[q0] * cap;
    for (int i = tid; i < nq * RADIX; i += SMALL_THREADS) s_hist[i] = 0;
    if (tid == 0) s_trivial = 0;
    __syncthreads();
    if ((tid & ~31) * HIST_ROWS < n) {   // a warp with a live row
      const int nvalid = max(0, min(HIST_ROWS, (int)n - tid * HIST_ROWS));
      uint64_t u[HIST_ROWS];
#pragma unroll
      for (int j = 0; j < HIST_ROWS; ++j)
        u[j] = j < nvalid ? (uint64_t)word[tid * HIST_ROWS + j] ^ SIGN : 0;
      for (int qi = 0; qi < nq; ++qi)
        count_runs(s_hist + qi * RADIX, u, nvalid, p.shift[q0 + qi]);
    }
    __syncthreads();
    for (int i = tid; i < nq * RADIX; i += SMALL_THREADS)
      if (s_hist[i] == n) atomicOr(&s_trivial, 1 << (i / RADIX));
    __syncthreads();
    const int trivial = s_trivial;
    gathered = trivial != (1 << nq) - 1;
    if (gathered) {
      uint64_t* kc = s_keys + cur * SMALL_ROWS;
      const int32_t* ic = s_idx + cur * SMALL_ROWS;
      for (int r = tid; r < n; r += SMALL_THREADS)
        kc[r] = (uint64_t)word[k == 0 ? r : ic[r]] ^ SIGN;
    }
    for (int qi = 0; qi < nq; ++qi) {
      if ((trivial >> qi) & 1) continue;
      const int shift = p.shift[q0 + qi];
      const int v = tid < RADIX ? s_hist[qi * RADIX + tid] : 0;
      int total;
      const int ex = block_exclusive_scan(v, warp_sums, &total);
      if (tid < RADIX) s_base[tid] = ex;
      for (int i = tid; i < used_warps * RADIX; i += SMALL_THREADS)
        s_wcnt[i] = 0;
      __syncthreads();
      const uint64_t* kc = s_keys + cur * SMALL_ROWS;
      const int32_t* ic = s_idx + cur * SMALL_ROWS;
      uint64_t* kd = s_keys + (cur ^ 1) * SMALL_ROWS;
      int32_t* id = s_idx + (cur ^ 1) * SMALL_ROWS;
      const int row0 = warp * (32 * SMALL_IPT) + lane;
      int rank[SMALL_IPT] = {};
      unsigned short* wc = s_wcnt + warp * RADIX;
#pragma unroll
      for (int j = 0; j < SMALL_IPT; ++j) {
        const int r = row0 + 32 * j;
        // one block is latency-bound: __match_any_sync ranks faster here
        // than the ballots of the throughput-bound pass kernel
        if (r - lane < n)   // warp-uniform: a step with a live row
          rank[j] = warp_rank<true>(
              wc, r < n ? digit_of(kc[r], shift) : 0, r < n);
      }
      __syncthreads();
      if (tid < RADIX) {
        int run = 0;
        for (int w = 0; w < used_warps; ++w) {
          const int c = s_wcnt[w * RADIX + tid];
          s_wcnt[w * RADIX + tid] = (unsigned short)run;
          run += c;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SMALL_IPT; ++j) {
        const int r = row0 + 32 * j;
        if (r < n) {
          const uint64_t kk = kc[r];
          const int dj = digit_of(kk, shift);
          const int pos = s_base[dj] + s_wcnt[warp * RADIX + dj] + rank[j];
          kd[pos] = kk;
          id[pos] = k == 0 ? r : ic[r];
        }
      }
      __syncthreads();
      cur ^= 1;
      ++k;
    }
    __syncthreads();
  }
  const int64_t* last_word =
      words + (int64_t)p.word[p.start[p.ngroups - 1]] * cap;
  for (int r = tid; r < n; r += SMALL_THREADS) {
    const int32_t i = k == 0 ? r : s_idx[cur * SMALL_ROWS + r];
    perm[r] = i;
    if (keys_out != nullptr)
      keys_out[r] = (int64_t)(gathered ? s_keys[cur * SMALL_ROWS + r]
                                       : (uint64_t)last_word[i] ^ SIGN);
  }
  if (write_tail)
    for (int64_t r = n + tid; r < cap; r += SMALL_THREADS)
      perm[r] = (int32_t)r;
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

// The one-block threshold and the tile of the multi-block passes, which
// ops/sort.py's SMALL_ROWS and SORT_TILE must equal (chip_smoke.py checks).
TT_EXPORT int64_t sort_small_rows() { return SMALL_ROWS; }
TT_EXPORT int64_t sort_tile_rows() { return TILE_ROWS; }

// words: as sort_encode wrote them; passes: int64 HOST array [word of each
// pass (npasses), shift of each pass (npasses)], least significant first;
// perm: int32[cap] out (the live prefix sorted, rows past num_rows in
// place); keys_out: int64[cap] or null, out: the sorted unsigned words of
// the most significant pass's word over the live rows (the u64 sort's
// result); scratch above SMALL_ROWS rows of capacity (else unused): keys
// int64[2 * cap], idx int32[cap], plan int64[257 * npasses + 4], status
// int64[2 * 256 * ceil(cap / TILE_ROWS)]. Returns cudaGetLastError(), or -1
// for no pass or more than 256, or a capacity past int32.
TT_EXPORT int sort_radix(const void* num_rows, int64_t cap, const void* words,
                         int64_t npasses, const void* passes, void* perm,
                         void* keys_out, void* keys, void* idx, void* plan,
                         void* status, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npasses < 1 || npasses > MAX_PASSES || cap > INT32_MAX) return -1;
  if (cap == 0) return (int)cudaGetLastError();
  const auto* n_ptr = static_cast<const int32_t*>(num_rows);
  const auto* w = static_cast<const int64_t*>(words);
  auto* out = static_cast<int32_t*>(perm);
  auto* kout = static_cast<int64_t*>(keys_out);
  thread_local static Passes p;  // each launch copies it as a parameter
  const int64_t* pt = static_cast<const int64_t*>(passes);
  p.ngroups = 0;
  for (int q = 0; q < npasses; ++q) {
    p.word[q] = (int32_t)pt[q];
    p.shift[q] = (int32_t)pt[npasses + q];
    if (q == 0 || p.word[q] != p.word[q - 1] ||
        q - p.start[p.ngroups - 1] == GROUP_PASSES)
      p.start[p.ngroups++] = q;
  }
  p.start[p.ngroups] = (int32_t)npasses;
  static bool attrs = false;
  if (!attrs) {
    cudaFuncSetAttribute(small_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMALL_SMEM);
    cudaFuncSetAttribute(pass_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)PASS_SMEM);
    attrs = true;
  }
  if (cap <= SMALL_ROWS) {
    small_kernel<<<1, SMALL_THREADS, SMALL_SMEM, s>>>(n_ptr, cap, w, p, out,
                                                       kout, 1);
    return (int)cudaGetLastError();
  }
  const int np = (int)npasses;
  Plan pl = make_plan(plan, np);
  Pairs a;
  a.keys0 = static_cast<uint64_t*>(keys);
  a.keys1 = a.keys0 + cap;
  a.idx0 = out;
  a.idx1 = static_cast<int32_t*>(idx);
  const int64_t ntiles = (cap + TILE_ROWS - 1) / TILE_ROWS;
  a.status0 = static_cast<uint64_t*>(status);
  a.status1 = a.status0 + ntiles * RADIX;
  cudaMemsetAsync(plan, 0, plan_words(np) * sizeof(int64_t), s);
  const int64_t hx = (cap + HIST_THREADS * HIST_ROWS - 1) /
                     (HIST_THREADS * HIST_ROWS);
  const dim3 hgrid((unsigned)(hx < HIST_BLOCKS ? hx : HIST_BLOCKS),
                   (unsigned)((np + HIST_PASSES - 1) / HIST_PASSES));
  hist_kernel<<<hgrid, HIST_THREADS, 0, s>>>(n_ptr, cap, w, np, p, pl,
                                             a.status0);
  for (int g = 0; g < p.ngroups; ++g) {
    const int q0 = p.start[g], q1 = p.start[g + 1];
    gather_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
        n_ptr, cap, w + (int64_t)p.word[q0] * cap, q0, q1, pl.order, a);
    const int keep = kout != nullptr && g == p.ngroups - 1;
    for (int q = q0; q < q1; ++q)
      pass_kernel<<<(unsigned)ntiles, PASS_THREADS, PASS_SMEM, s>>>(
          n_ptr, cap, q, q1, p.shift[q], keep, pl, a);
  }
  small_kernel<<<1, SMALL_THREADS, SMALL_SMEM, s>>>(n_ptr, cap, w, p, out,
                                                     kout, 0);
  const int q_last = p.start[p.ngroups - 1];
  finish_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      n_ptr, cap, np, q_last, pl.order, a,
      w + (int64_t)p.word[q_last] * cap, kout);
  return (int)cudaGetLastError();
}
