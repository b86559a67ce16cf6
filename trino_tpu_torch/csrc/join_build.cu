// K5: the build side of an equi-join.
//
// Replaces trino_tpu/ops/join.py prepare_build (+ _key_u64/_mix64),
// build_dense_table/_dense_scatter and build_key_bounds. The reference
// sorts the build keys (a multi-operand lax.sort, the TPU's data-movement
// engine), derives run lengths with cummax/cummin scans, and probes the
// sorted array with searchsorted or, for a dense key span, a direct-address
// table of sorted positions. A sort moves every key log n times; here the
// build is one pass that needs no order:
//
//   build_kernel — per live build row: its 64-bit key (one column sign-
//     extended, or the splitmix mix of several, -0.0 made +0.0 — the
//     reference's _key_u64 bit for bit), then the statistics the executor
//     reads once per join (live non-NULL rows, live rows, any NULL key, the
//     key min/max compared as UNSIGNED 64-bit as the reference's uint64
//     keys are, and build_key_bounds' min/max of the first key column in
//     its own type, and the distinct live keys: the router's density
//     numerator, the reference's join_mxu.distinct_live_keys, counted as
//     the rows that claim a new slot), and an insert into an
//     open-addressing hash table:
//     power-of-two slots >= 2 x capacity, linear probing, a slot claimed by
//     atomicCAS on its row (the key of a claimed slot is checked against
//     the claiming row's key, recomputed from the immutable columns, so no
//     thread ever reads a half-written slot), and a per-slot count whose
//     running maximum is max_run (1 = unique build, the reference's
//     max_run_live). This table is the `search` lookup (ROADMAP B4's
//     Hopper form).
//   dense_kernel — for a key span the router accepts (`dense`): a direct-
//     address table [next_pow2(span)] holding the build ROW of key
//     kmin + s, INT32_MAX where no key is present (the reference stores
//     the first sorted position; for the unique build both name the same
//     row). With a payload it stores the payload instead: the spilled
//     join's build row of each sorted key (K16's permutation). At the main
//     path's call (q3 sf1: 30,136 rows into 262,144 slots) the device work
//     is a few microseconds behind the host's enqueue, so the mode is ONE
//     cooperative launch: the fill, a grid barrier, the atomicMin scatter,
//     the key columns in a parameter block of 8, 64 or TABLE_MAX words.
//
// Bound on this card: bytes — the live rows' key columns read once and a
// lookup written once: for the hash table, the live keys and rows it must
// hold (12 bytes a row; this design initialises and writes 2x slots of 16
// bytes, about 2.7x that), for the dense one its table (4 bytes a slot).
// The inserts are random 4-to-16-byte accesses, so a table past the 50 MB
// L2 pays a DRAM sector per row.
//
// Runs mode (join_runs) replaces the part of prepare_build the expanding
// probe (K9, csrc/join_expand.cu) reads: the sort permutation `bperm`
// with `run_len`, every key's build rows laid out together. It is ONE
// cooperative launch (runs_kernel below): each live row finds its slot
// once and keeps it in a row stash the later phases read coalesced; the
// row that claimed the slot in join_build (its owner) takes the run's
// start from a block scan over the owners' counts and one atomic a block
// and round on a per-device counter (no memset, no walk over empty
// slots, no atomic a run on one word) and writes slot_start once; the
// other rows take places counted down from a cursor at the owner's row
// (the owner's row is what their probe read in slot_rows), and each owner
// then orders its run in place by row: a rank per row up to 32 rows, a
// block's bitonic sorts and merge passes past that, so a skewed key costs
// c log c and not c^2 (executor logs record max_run). The runs lie in the
// order the blocks' rounds took their starts; every consumer reads a run
// through its slot's (start, count). The dense table of this mode holds a
// key's SLOT (its run's start and count), as the reference's table holds
// a first sorted position that run_len completes; it is filled over its
// `size` words and written by the owners. Bound: the slot counts read
// once and 4 bytes of row per live build row read and written once (plus
// the dense table); this design moves about 40 bytes a live row (the
// key, the stash written once and read twice, the cursor, the row written
// at its place and read and written once more by its run's order) and two
// random 32-byte sectors of the slot table (slot_rows; then slot_counts
// and a slot_start write for an owner, slot_keys for the other rows,
// whose one atomic falls on the row-sized cursor), but no byte of an
// empty slot.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;  // values ptr, valid ptr, element size, is_float
enum Stat {
  N_LIVE = 0, N_ROWS, HAS_NULL, MAX_RUN, KMIN, KMAX, LO, HI, LO_NAN,
  NDISTINCT, N_STATS
};

// Identities of the first key's min (lo) and max (hi): int64 values, or
// order keys (csrc/common.cuh) for a float key.
__device__ __forceinline__ long long lo_identity(int is_float) {
  return is_float ? key_pos_inf() : 0x7fffffffffffffffLL;
}

__device__ __forceinline__ long long hi_identity(int is_float) {
  return is_float ? key_neg_inf() : (long long)0x8000000000000000ULL;
}

template <class T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_down_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}

template <class T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_down_sync(0xffffffffu, v, o);
    v = y > v ? y : v;
  }
  return v;
}

__global__ void init_kernel(int32_t* __restrict__ slot_rows,
                            int32_t* __restrict__ slot_counts, int64_t slots,
                            unsigned long long* __restrict__ stats,
                            int first_is_float) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t s = t; s < slots; s += (int64_t)gridDim.x * blockDim.x) {
    slot_rows[s] = -1;
    slot_counts[s] = 0;
  }
  if (t < N_STATS) {
    unsigned long long v = 0ULL;
    if (t == KMIN) v = ~0ULL;
    if (t == LO) v = (unsigned long long)lo_identity(first_is_float);
    if (t == HI) v = (unsigned long long)hi_identity(first_is_float);
    stats[t] = v;
  }
}

__global__ void build_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                             int64_t cap, const int32_t* __restrict__ num_rows,
                             int64_t* __restrict__ slot_keys,
                             int32_t* __restrict__ slot_rows,
                             int32_t* __restrict__ slot_counts, int64_t slots,
                             unsigned long long* __restrict__ stats) {
  const int64_t* cols = tbl.v;
  const void* first = reinterpret_cast<const void*>(cols[0]);
  const uint8_t* first_valid = reinterpret_cast<const uint8_t*>(cols[1]);
  const int first_esz = (int)cols[2], first_float = (int)cols[3];
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t mask = (uint64_t)slots - 1;
  unsigned long long n_live = 0, n_rows = 0, has_null = 0, max_run = 0,
                     bnan = 0, ndistinct = 0;
  unsigned long long kmin = ~0ULL, kmax = 0ULL;
  long long lo = lo_identity(first_float), hi = hi_identity(first_float);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    ++n_rows;
    if (first_valid == nullptr || first_valid[i]) {
      long long b;
      if (first_float) {
        const double x = load_float(first, i, first_esz);
        if (x != x) bnan = 1;
        b = ordered_key(x);
      } else {
        b = load_int(first, i, first_esz);
      }
      if (!(first_float && bnan)) {
        lo = b < lo ? b : lo;
        hi = b > hi ? b : hi;
      }
    }
    bool null;
    const uint64_t key = join_key(cols, nkeys, i, &null);
    if (null) {
      has_null = 1;
      continue;
    }
    ++n_live;
    kmin = key < kmin ? key : kmin;
    kmax = key > kmax ? key : kmax;
    uint64_t s = mix64(key) & mask;
    while (true) {
      int r = slot_rows[s];
      if (r == -1) {
        const int prev = atomicCAS(&slot_rows[s], -1, (int)i);
        if (prev == -1) {  // the first row of its key: one more key
          slot_keys[s] = (int64_t)key;
          r = (int)i;
          ++ndistinct;
        } else {
          r = prev;
        }
      }
      bool rnull;
      if (r == (int)i || join_key(cols, nkeys, r, &rnull) == key) {
        const unsigned long long c =
            (unsigned long long)atomicAdd(&slot_counts[s], 1) + 1ULL;
        max_run = c > max_run ? c : max_run;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  n_live = warp_sum(n_live);
  n_rows = warp_sum(n_rows);
  ndistinct = warp_sum(ndistinct);
  has_null = warp_max(has_null);
  max_run = warp_max(max_run);
  bnan = warp_max(bnan);
  kmin = warp_min(kmin);
  kmax = warp_max(kmax);
  lo = warp_min(lo);
  hi = warp_max(hi);
  if ((threadIdx.x & 31) == 0) {
    if (n_live) atomicAdd(&stats[N_LIVE], n_live);
    if (n_rows) atomicAdd(&stats[N_ROWS], n_rows);
    if (ndistinct) atomicAdd(&stats[NDISTINCT], ndistinct);
    if (has_null) atomicMax(&stats[HAS_NULL], has_null);
    if (bnan) atomicMax(&stats[LO_NAN], bnan);
    atomicMax(&stats[MAX_RUN], max_run);
    atomicMin(&stats[KMIN], kmin);
    atomicMax(&stats[KMAX], kmax);
    atomicMin(reinterpret_cast<long long*>(&stats[LO]), lo);
    atomicMax(reinterpret_cast<long long*>(&stats[HI]), hi);
  }
}

// lo/hi of a float first key back from order keys to float64 bits (NaN
// when any live valid key is NaN: jnp.min/max propagate it).
__global__ void finish_kernel(unsigned long long* __restrict__ stats,
                              int first_is_float) {
  if (!first_is_float) return;
  const long long nan = 0x7ff8000000000000LL;
  const bool any_nan = stats[LO_NAN] != 0ULL;
  stats[LO] = (unsigned long long)(any_nan ? nan : __double_as_longlong(
      from_key((long long)stats[LO])));
  stats[HI] = (unsigned long long)(any_nan ? nan : __double_as_longlong(
      from_key((long long)stats[HI])));
}

// K5's dense mode in one cooperative launch: the blocks (all resident on
// the card) fill the table with INT32_MAX, 16 bytes a store where the
// table is 16-byte aligned, wait at one grid barrier, then scatter the
// live non-NULL rows with atomicMin. tbl: KEY_FIELDS words per key column.
template <int W>
__global__ void __launch_bounds__(THREADS)
    dense_kernel(const __grid_constant__ ParamBlock<W> tbl, int nkeys,
                 int64_t cap, const int32_t* __restrict__ num_rows,
                 const unsigned long long* __restrict__ stats,
                 const int32_t* __restrict__ payload,
                 int32_t* __restrict__ table, int64_t size, int vec) {
  const int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t quads = vec ? size / 4 : 0;
  const int4 absent = make_int4(0x7fffffff, 0x7fffffff, 0x7fffffff,
                                0x7fffffff);
  for (int64_t q = t; q < quads; q += stride)
    reinterpret_cast<int4*>(table)[q] = absent;
  for (int64_t s = 4 * quads + t; s < size; s += stride) table[s] = 0x7fffffff;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t kmin = stats[KMIN];
  cooperative_groups::this_grid().sync();
  for (int64_t i = t; i < n; i += stride) {
    bool null;
    const uint64_t key = join_key(tbl.v, nkeys, i, &null);
    if (null) continue;
    const int64_t raw = (int64_t)(key - kmin);
    if (raw >= 0 && raw < size)
      atomicMin(&table[raw], payload ? payload[i] : (int32_t)i);
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}
}  // namespace

// table: int64 HOST array, KEY_FIELDS words per key column (values ptr,
// valid ptr or 0, element size, is_float); num_rows: int32 scalar;
// slot_keys: int64[slots]; slot_rows, slot_counts: int32[slots] with
// `slots` a power of two above the live rows; stats: int64[10] (layout in
// enum Stat). All but the table on the device. Returns cudaGetLastError(),
// or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int join_build(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, void* slot_keys,
                         void* slot_rows, void* slot_counts, int64_t slots,
                         void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (nkeys < 1 || load_table(table, KEY_FIELDS * nkeys, &t)) return -1;
  const int first_float = (int)t.v[3];
  auto* st = static_cast<unsigned long long*>(stats);
  init_kernel<<<grid_for(slots), THREADS, 0, s>>>(
      static_cast<int32_t*>(slot_rows), static_cast<int32_t*>(slot_counts),
      slots, st, first_float);
  build_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      t, nkeys, cap, static_cast<const int32_t*>(num_rows),
      static_cast<int64_t*>(slot_keys), static_cast<int32_t*>(slot_rows),
      static_cast<int32_t*>(slot_counts), slots, st);
  finish_kernel<<<1, 1, 0, s>>>(st, first_float);
  return (int)cudaGetLastError();
}

namespace {
// Rows (or slots, 4 to a store) a thread takes in K5's dense mode before
// the grid grows by a block; the grid is capped by the blocks the card
// holds at once (a cooperative launch needs every block resident).
constexpr int64_t DENSE_ITEMS = 4;
constexpr int MAX_DEVICES = 64;
int64_t dense_enqueues = 0;  // stream operations join_dense enqueued

template <int W>
int dense_launch(const void* host, int64_t nkeys, int64_t cap,
                 const void* num_rows, const void* stats, const void* payload,
                 void* dense, int64_t size, cudaStream_t s) {
  thread_local static ParamBlock<W> t;  // each launch copies it
  load_block(host, KEY_FIELDS * nkeys, &t);
  // co-resident blocks of this kernel on each device, asked once
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_kernel<W>,
                                                  THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t work = size / 4 > cap ? size / 4 : cap;
  const int64_t per_block = THREADS * DENSE_ITEMS;
  int64_t blocks = (work + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > resident[dev] ? resident[dev] : blocks);
  int nk = (int)nkeys;
  const int32_t* nr = static_cast<const int32_t*>(num_rows);
  const auto* st = static_cast<const unsigned long long*>(stats);
  const int32_t* pay = static_cast<const int32_t*>(payload);
  int32_t* table = static_cast<int32_t*>(dense);
  int vec = (reinterpret_cast<uintptr_t>(dense) & 15) == 0;
  void* args[] = {&t, &nk, &cap, &nr, &st, &pay, &table, &size, &vec};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dense_kernel<W>), dim3((unsigned)blocks),
      dim3(THREADS), args, 0, s);
  ++dense_enqueues;
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}
}  // namespace

// The direct-address table of the dense route: dense: int32[size], key
// kmin + s -> its build row, INT32_MAX when absent; stats as join_build
// wrote it (kmin is read on the device). With a payload (int32[cap] or
// null) a slot holds the smallest payload of its key's rows instead of
// the row: the spilled join's table over the sorted keys with their
// permutation (trino_tpu/ops/join.py build_dense_table_rows). One
// cooperative launch (dense_kernel); the table is KEY_FIELDS words per key
// column in a block of 8, 64 or TABLE_MAX words. Returns the launch's
// error, or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int join_dense(const void* table, int64_t nkeys, int64_t cap,
                         const void* num_rows, const void* stats,
                         const void* payload, void* dense, int64_t size,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkeys < 1) return -1;
  switch (param_block_words(KEY_FIELDS * nkeys)) {
    case 8:
      return dense_launch<8>(table, nkeys, cap, num_rows, stats, payload,
                             dense, size, s);
    case 64:
      return dense_launch<64>(table, nkeys, cap, num_rows, stats, payload,
                              dense, size, s);
    case TABLE_MAX:
      return dense_launch<TABLE_MAX>(table, nkeys, cap, num_rows, stats,
                                     payload, dense, size, s);
    default:
      return -1;
  }
}

// The stream operations (kernels and memsets) join_dense has enqueued in
// this process (chip_smoke.py counts them per call).
TT_EXPORT int64_t join_dense_enqueues() { return dense_enqueues; }

// Runs mode in one cooperative launch (runs_kernel), three phases between
// two grid barriers; block b takes the rows b x THREADS + m x grid x
// THREADS below num_rows, RUN_ITEMS of them a thread a round:
//   0. the dense table's fill (`size` words only); per live non-NULL row
//      one hash_find (the row that owns the slot, the one that claimed
//      it in join_build, reads no key: slot_rows names it), kept in
//      `stash` as (slot, count) for the owner and (owner row, 0) for
//      another row of the run, read coalesced by the later phases; each
//      owner's run start from a block scan of the round's owners' counts
//      and one atomicAdd a block and round on the per-device counter (so
//      the runs lie in the order the rounds reach it; no atomic a run on
//      one word); the owner writes slot_start (an atomicExch: the sector
//      is fetched whole into the L2, not merged in DRAM), its row at the
//      run's first place and the run's last place into `cursor` at its
//      own row;
//   1. every other row takes a place counted down from its owner's
//      cursor (a 15 MB array at sf1's build, not the slot table), one
//      atomicSub per run a warp (__match_any_sync), so the cursor ends at
//      the run's start; the owners write their dense entries; the counter
//      is set back to 0;
//   2. each owner puts its run in ascending row order in place: a run of
//      at most SHORT_RUN rows by each row's rank (in registers up to
//      TINY_RUN rows), a longer one by the owner's block (bitonic sorts of
//      CHUNK rows in shared memory, then merge passes with `spare` as
//      scratch: `cursor` is still read by other owners), so the work
//      grows as c log c and not c^2.
namespace {
constexpr int SHORT_RUN = 32;
constexpr int TINY_RUN = 8;          // a run ordered in registers
constexpr int RUN_ITEMS = 4;        // rows a thread takes a round
constexpr int CHUNK = 2048;          // rows a block sorts in shared memory
constexpr int RUNS_MAX_GRID = 2048;  // blocks of one launch at most

__device__ __forceinline__ int ceil_log2(int64_t v) {
  int b = 0;
  while (((int64_t)1 << b) < v) ++b;
  return b;
}

// Sort buf[0, n) ascending in shared memory, n a power of two (every
// thread of the block calls it).
__device__ void bitonic_sort(int32_t* buf, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = threadIdx.x; x < n; x += blockDim.x) {
        const int y = x ^ j;
        if (y > x) {
          const int32_t a = buf[x], b = buf[y];
          if ((a > b) == ((x & k) == 0)) {
            buf[x] = b;
            buf[y] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// run[0, c) sorted in place by the whole block (c > SHORT_RUN), with
// scratch[0, c): one chunk in shared memory, or chunks of CHUNK then
// ceil(log2(chunks)) merge passes, each output place found by a
// merge-path search; the chunks land in `run` or `scratch` so that the
// last pass writes `run`.
__device__ void block_sort_run(int32_t* run, int32_t* scratch, int64_t c,
                               int32_t* buf) {
  const int32_t* src = run;
  const int64_t chunks = (c + CHUNK - 1) / CHUNK;
  const int passes = ceil_log2(chunks);
  int32_t* from = (passes & 1) ? scratch : run;
  for (int64_t k = 0; k < chunks; ++k) {
    const int64_t lo = k * CHUNK;
    const int m = (int)(c - lo < CHUNK ? c - lo : CHUNK);
    const int n = 1 << ceil_log2(m < 2 ? 2 : m);
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      buf[x] = x < m ? src[lo + x] : 0x7fffffff;
    __syncthreads();
    bitonic_sort(buf, n);
    for (int x = threadIdx.x; x < m; x += blockDim.x) from[lo + x] = buf[x];
    __syncthreads();
  }
  int32_t* to = from == run ? scratch : run;
  for (int64_t w = CHUNK; w < c; w <<= 1) {
    for (int64_t k = threadIdx.x; k < c; k += blockDim.x) {
      const int64_t lo = k / (2 * w) * (2 * w);
      const int64_t na = c - lo < w ? c - lo : w;
      int64_t nb = c - lo - w;
      nb = nb < 0 ? 0 : (nb > w ? w : nb);
      const int32_t* A = from + lo;
      const int32_t* B = A + w;
      const int64_t kk = k - lo;
      if (nb == 0) {
        to[k] = A[kk];
        continue;
      }
      int64_t a = kk - nb > 0 ? kk - nb : 0, b = kk < na ? kk : na;
      while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (A[mid] < B[kk - mid - 1]) a = mid + 1; else b = mid;
      }
      const int64_t j = kk - a;
      to[k] = (j >= nb || (a < na && A[a] < B[j])) ? A[a] : B[j];
    }
    __syncthreads();
    int32_t* t = from;
    from = to;
    to = t;
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS)
    runs_kernel(const __grid_constant__ ParamBlock<W> tbl, int nkeys,
                int64_t cap, const int32_t* __restrict__ num_rows,
                const unsigned long long* __restrict__ stats,
                const int64_t* __restrict__ slot_keys,
                const int32_t* __restrict__ slot_rows,
                const int32_t* __restrict__ slot_counts, int64_t slots,
                int32_t* __restrict__ slot_start, int2* __restrict__ stash,
                int32_t* __restrict__ cursor, int32_t* __restrict__ spare,
                int32_t* __restrict__ counter, int32_t* __restrict__ runs,
                int32_t* __restrict__ dense, int64_t size, int vec) {
  __shared__ int warp_sums[32];
  __shared__ int block_base;
  __shared__ int nlong;
  __shared__ int2 longs[THREADS];
  __shared__ int32_t buf[CHUNK];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int lane = threadIdx.x & 31;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const uint64_t mask = (uint64_t)slots - 1;

  // phase 0: the dense fill; each row's slot; each owner's run: a block
  // scan a round of RUN_ITEMS rows a thread (rows first + t + k x stride,
  // their probes in flight together) and one atomic on the per-device
  // counter a block and round
  const int64_t quads = vec ? size / 4 : 0;
  const int4 absent = make_int4(0x7fffffff, 0x7fffffff, 0x7fffffff,
                                0x7fffffff);
  for (int64_t q = t; q < quads; q += stride)
    reinterpret_cast<int4*>(dense)[q] = absent;
  for (int64_t s = 4 * quads + t; s < size; s += stride) dense[s] = 0x7fffffff;
  const int64_t round = RUN_ITEMS * stride;
  for (int64_t first = blockIdx.x * (int64_t)THREADS; first < n;
       first += round) {
    uint64_t key[RUN_ITEMS], s[RUN_ITEMS];
    int32_t r[RUN_ITEMS];
    bool live[RUN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      bool null = true;
      if (i < n) key[k] = join_key(tbl.v, nkeys, i, &null);
      live[k] = !null;
      s[k] = live[k] ? mix64(key[k]) & mask : 0;
      r[k] = live[k] ? slot_rows[s[k]] : -1;
    }
    int2 st[RUN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      // (slot, c) for the owner (its own slot: no key read), (owner row,
      // 0) for another row of the run, y -1 for no slot
      st[k] = make_int2((int)s[k], -1);
      if (r[k] == (int32_t)(first + threadIdx.x + k * stride))
        st[k].y = slot_counts[s[k]];
      else if (r[k] != -1 && (uint64_t)slot_keys[s[k]] == key[k])
        st[k] = make_int2(r[k], 0);
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      if (i < n && live[k] && st[k].y < 0 && r[k] != -1) {  // past the
        uint64_t q = s[k];                                 // first slot
        while (true) {
          q = (q + 1) & mask;
          const int32_t rq = slot_rows[q];
          if (rq == -1) break;  // absent: not a row join_build inserted
          if (rq == (int32_t)i) {
            st[k] = make_int2((int)q, slot_counts[q]);
            break;
          }
          if ((uint64_t)slot_keys[q] == key[k]) {
            st[k] = make_int2(rq, 0);
            break;
          }
        }
      }
      mine += st[k].y > 0 ? st[k].y : 0;
    }
    int sum;
    int start = block_exclusive_scan(mine, warp_sums, &sum);
    if (threadIdx.x == 0) block_base = sum ? atomicAdd(counter, sum) : 0;
    __syncthreads();
    start += block_base;
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      if (i >= n) continue;
      stash[i] = st[k];
      const int c = st[k].y;
      if (c <= 0) continue;
      atomicExch(&slot_start[st[k].x], start);  // a full sector in L2
      runs[start] = (int32_t)i;
      // the run's last place, at the owner's row: each other row of the
      // run takes one place below it, so the cursor ends at the start
      cursor[i] = start + c - 1;
      start += c;
    }
    __syncthreads();  // block_base is read before the next round sets it
  }
  grid.sync();

  // phase 1: the other rows' places, counted down from the run's last
  // place at the owner's row, one atomic per run a warp; the owners'
  // dense entries
  if (t == 0) *counter = 0;  // every start is taken: ready for the next call
  const uint64_t kmin = stats[KMIN];
  for (int64_t first = blockIdx.x * (int64_t)THREADS; first < n;
       first += round) {
    int2 st[RUN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      st[k] = i < n ? stash[i] : make_int2(0, -1);
    }
    int last[RUN_ITEMS];
    unsigned peers[RUN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const bool member = st[k].y == 0;
      const unsigned active = __ballot_sync(0xffffffffu, member);
      peers[k] = 0u;
      last[k] = 0;
      if (member) {
        peers[k] = __match_any_sync(active, st[k].x);
        if (lane == __ffs(peers[k]) - 1)
          last[k] = atomicSub(&cursor[st[k].x], __popc(peers[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < RUN_ITEMS; ++k) {
      const int64_t i = first + threadIdx.x + k * stride;
      if (st[k].y > 0 && size > 0) {
        bool null;
        const int64_t raw =
            (int64_t)(join_key(tbl.v, nkeys, i, &null) - kmin);
        if (raw >= 0 && raw < size) dense[raw] = st[k].x;
      }
      if (st[k].y != 0) continue;
      const int l = __shfl_sync(peers[k], last[k], __ffs(peers[k]) - 1);
      runs[l - __popc(peers[k] & ((1u << lane) - 1u))] = (int32_t)i;
    }
  }
  grid.sync();

  // phase 2: each run of two or more rows in ascending row order
  if (threadIdx.x == 0) nlong = 0;
  __syncthreads();
  for (int64_t first = blockIdx.x * (int64_t)THREADS; first < n;
       first += stride) {
    const int64_t i = first + threadIdx.x;
    int2 st = i < n ? stash[i] : make_int2(0, -1);
    if (st.y > 1) st.x = cursor[i];  // the owner's cursor ended at the start
    if (st.y > SHORT_RUN) {
      longs[atomicAdd(&nlong, 1)] = st;
    } else if (st.y > TINY_RUN) {
      int32_t a[SHORT_RUN];
      for (int q = 0; q < st.y; ++q) a[q] = runs[st.x + q];
      for (int q = 0; q < st.y; ++q) {
        int r = 0;
        for (int p = 0; p < st.y; ++p) r += a[p] < a[q] ? 1 : 0;
        runs[st.x + r] = a[q];
      }
    } else if (st.y > 1) {  // in registers: fixed indices, padded
      int32_t a[TINY_RUN];
#pragma unroll
      for (int q = 0; q < TINY_RUN; ++q)
        a[q] = q < st.y ? runs[st.x + q] : 0x7fffffff;
#pragma unroll
      for (int q = 0; q < TINY_RUN; ++q) {
        int r = 0;
#pragma unroll
        for (int p = 0; p < TINY_RUN; ++p) r += a[p] < a[q] ? 1 : 0;
        if (q < st.y) runs[st.x + r] = a[q];
      }
    }
    __syncthreads();
    for (int l = 0; l < nlong; ++l)
      block_sort_run(runs + longs[l].x, spare + longs[l].x, longs[l].y,
                     buf);
    __syncthreads();
    if (threadIdx.x == 0) nlong = 0;
    __syncthreads();
  }
}
}  // namespace

// Runs mode (after join_build on the same columns): runs: int32[cap], the
// live non-NULL build rows grouped by key, each key's rows in ascending
// row order, the runs in any order (every consumer reads a run through
// its slot's start and count); slot_start: int32[slots], an occupied
// slot's first place in runs (slot_counts, from join_build, its length;
// an empty slot's entry is not written); scratch: int64[runs_scratch_words
// (cap)] (the row stash, the cursors, a long run's sort scratch);
// counter: the per-device int32
// word, 0 between calls (the launch sets it back after its last use);
// with size > 0 also the dense table dense: int32[size], key kmin + d ->
// its slot, INT32_MAX when absent. One cooperative launch (runs_kernel);
// the key columns in a parameter block of 8, 64 or TABLE_MAX words.
// Returns the launch's error, or -1 when the table exceeds TABLE_MAX.
namespace {
int64_t runs_enqueues_ = 0;  // stream operations join_runs enqueued

template <int W>
int runs_launch(const void* host, int64_t nkeys, int64_t cap,
                const void* num_rows, const void* stats,
                const void* slot_keys, const void* slot_rows,
                const void* slot_counts, int64_t slots, void* slot_start,
                void* scratch, void* counter, void* runs, void* dense,
                int64_t size, cudaStream_t s) {
  thread_local static ParamBlock<W> t;  // each launch copies it
  load_block(host, KEY_FIELDS * nkeys, &t);
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, runs_kernel<W>,
                                                  THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t work = size / 4 > cap ? size / 4 : cap;
  const int64_t per_block = THREADS * DENSE_ITEMS;
  int64_t blocks = (work + per_block - 1) / per_block;
  const int64_t most = resident[dev] < RUNS_MAX_GRID ? resident[dev]
                                                      : RUNS_MAX_GRID;
  blocks = blocks < 1 ? 1 : (blocks > most ? most : blocks);
  int nk = (int)nkeys;
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* st = static_cast<const unsigned long long*>(stats);
  const auto* keys = static_cast<const int64_t*>(slot_keys);
  const auto* rows = static_cast<const int32_t*>(slot_rows);
  const auto* counts = static_cast<const int32_t*>(slot_counts);
  auto* start = static_cast<int32_t*>(slot_start);
  auto* stash = static_cast<int2*>(scratch);
  auto* cursor = reinterpret_cast<int32_t*>(stash + cap);
  int32_t* spare = cursor + ((cap + 1) / 2) * 2;
  auto* count_word = static_cast<int32_t*>(counter);
  auto* out = static_cast<int32_t*>(runs);
  auto* table = static_cast<int32_t*>(dense);
  int vec = (reinterpret_cast<uintptr_t>(dense) & 15) == 0;
  void* args[] = {&t,      &nk,    &cap,  &nr,       &st,    &keys,
                  &rows,   &counts, &slots, &start,  &stash,
                  &cursor, &spare, &count_word, &out, &table, &size, &vec};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(runs_kernel<W>), dim3((unsigned)blocks),
      dim3(THREADS), args, 0, s);
  ++runs_enqueues_;
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}
}  // namespace

TT_EXPORT int join_runs(const void* table, int64_t nkeys, int64_t cap,
                        const void* num_rows, const void* stats,
                        const void* slot_keys, const void* slot_rows,
                        const void* slot_counts, int64_t slots,
                        void* slot_start, void* scratch, void* counter,
                        void* runs, void* dense, int64_t size,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkeys < 1) return -1;
  switch (param_block_words(KEY_FIELDS * nkeys)) {
    case 8:
      return runs_launch<8>(table, nkeys, cap, num_rows, stats, slot_keys,
                            slot_rows, slot_counts, slots, slot_start,
                            scratch, counter, runs, dense, size, s);
    case 64:
      return runs_launch<64>(table, nkeys, cap, num_rows, stats, slot_keys,
                             slot_rows, slot_counts, slots, slot_start,
                             scratch, counter, runs, dense, size, s);
    case TABLE_MAX:
      return runs_launch<TABLE_MAX>(table, nkeys, cap, num_rows, stats,
                                    slot_keys, slot_rows, slot_counts, slots,
                                    slot_start, scratch, counter, runs, dense,
                                    size, s);
    default:
      return -1;
  }
}

// The stream operations join_runs has enqueued in this process
// (chip_smoke.py counts them per call).
TT_EXPORT int64_t join_runs_enqueues() { return runs_enqueues_; }
