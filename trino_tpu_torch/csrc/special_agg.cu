// K29-K31: the special aggregates (centered moments, min_by/max_by/
// arbitrary, approx_distinct, approx_percentile, checksum).
//
// Every kernel here reads a group id per row: K8's group-id mode (K28,
// csrc/group_agg.cu) writes it for a GROUP BY, as the row's position in
// K8's own output page, so the per-group results below line up with K8's
// rows; a global aggregation passes no ids and uses group 0. A row takes
// part when it is live (below num_rows) and every mask of its `Masks`
// holds (the argument's validity, FILTER, the DISTINCT mark).
//
// K29 (special_hash) replaces trino_tpu/ops/aggregate.py _hash64,
// _checksum_state and _hll_register_inputs: splitmix64 over the value's
// bits, bit for bit. Floats are widened to float64 and -0.0 is made +0.0
// while a NaN keeps its bits (the reference's `+ 0.0` on the CPU); a
// float32 NaN widens as the CPU's conversion does (payload kept, quiet bit
// set); integers, dates, decimals and dictionary codes are sign-extended;
// booleans hash as 0/1. Checksum mode writes the masked int64
// contribution that K3/K4/K8/K19 sum as a wrapping add. HLL mode writes
// the pair (group << 11 | bucket) with bucket = h >> 53, and rho = 53 -
// floor(log2(w)) for w = h & (2^53 - 1), which is clz(w) - 10 for w > 0
// and 54 for w == 0 (the integer form; the reference's float log2 agrees
// wherever it is exact). Bound: bytes (the column and masks read once, 8
// or 16 bytes a row written); the hash is 2 multiplies a row.
//
// K30 (special_centered, special_positional, special_hll), three modes:
// * centered, replacing _centered_grouped/_centered_global and
//   _centered_finalize: pass 1 sums the count, Σa and Σb per group; pass
//   2 sums Σda², Σdb² and Σda·db centered on each group's mean; then the
//   finalize per group. Float64 atomics add in another order than the
//   reference (the results agree to about 1e-12 of Σ|x|).
// * positional, replacing _positional_grouped/_positional_global: pass 1
//   the y-extremum per group on order-preserving keys (-0.0 made +0.0 and
//   NaN +inf, so NaN and +inf tie as under the reference's
//   _nan_as_largest), pass 2 the lowest row index among the eligible rows
//   at it (arbitrary: among the rows whose x is not NULL) — the row the
//   reference's stable sort puts first — then x and its validity from
//   that row.
// * HLL fold, replacing _hll_grouped/_hll_global and _hll_estimate: over
//   K8's output grouped on the pair (one row per (group, bucket) with the
//   MAX of rho), each group's Σ2^-reg and its count of present buckets.
//   The sum is exact: 2^(54 - reg) in units of 2^-54 summed as two
//   integer halves (bits 32-63 and 0-31 of each term), joined in one
//   rounding; the reference's float sum is exact whenever its own order
//   cannot round it (every register below 43). A group has at most 2^11
//   pairs, so its low halves sum below 2^43 and the count of present
//   buckets rides in bits 44-63 of the same word: two atomics a pair (K8's
//   page comes in hash-slot order, so a group's pairs are scattered and
//   their atomics rarely meet). One launch over a grid fixed by the
//   capacity; its last block (a ticket taken after a barrier and
//   __threadfence, the sums read with __ldcg) runs the estimate of up to
//   `last_max` groups and resets the ticket; more groups take a second
//   launch. The estimate returns each group's two words to zero as it
//   reads them, so the per-device scratch (ops/aggregate.py _hll_scratch)
//   is zero between calls and no launch fills it. The estimate then
//   repeats the reference's float64 steps.
// Groups are few in the contention case (TPC-H's 4 flag groups): when
// num_groups <= SMEM_GROUPS each block reduces into a shared copy and
// merges it once, as K24 does (csrc/join_mxu.cu).
//
// K31 (special_percentile_words, special_percentile_pick) replaces
// _percentile_grouped/_percentile_global with K10's radix passes between
// its two launches: the words launch packs (group, not eligible) and the
// value (NaN as +inf, -0.0 as +0.0) into K10's order-preserving words;
// K10 sorts the live prefix stably;
// the pick launch finds each group's start and eligible count and p_g,
// the maximum of p over the group's live rows, and gathers the original
// value at start + clip(ceil(p_g * cnt), 1, max(cnt, 1)) - 1. Ties at
// the picked rank (NaN against +inf, -0.0 against +0.0) resolve by row
// order, as in the reference's stable sort.
//
// Grouped outputs have the page's capacity, as K8's; only the first
// num_groups entries are initialised and written (the rest is never
// read), so a page of 2^26 rows in 4 groups costs 4 entries, not 2^26.
//
// Bound on this card: bytes for all three (each input column read once
// per pass, per-group outputs written once); the atomics of the few-group
// case are the contention that the shared copy absorbs.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int MAX_MASKS = 6;
constexpr int SMEM_GROUPS = 1024;
constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t SIGN = 0x8000000000000000ULL;
constexpr int HLL_P = 11;

// The masks a row must pass (0 = none), by value.
struct Masks {
  const uint8_t* m[MAX_MASKS];
  int count;
};

__device__ __forceinline__ bool passes(const Masks& mk, int64_t i) {
  for (int q = 0; q < mk.count; ++q)
    if (mk.m[q] != nullptr && !mk.m[q][i]) return false;
  return true;
}

__device__ __forceinline__ int64_t live_rows(const int32_t* num_rows,
                                             int64_t cap) {
  if (num_rows == nullptr) return cap;
  int64_t n = *num_rows;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__device__ __forceinline__ int64_t group_of(const int32_t* gid, int64_t i) {
  return gid == nullptr ? 0 : (int64_t)gid[i];
}

// The word _hash64 mixes: see the header.
__device__ __forceinline__ uint64_t hash_input(const void* p, int64_t i,
                                               int esz, int is_float) {
  if (!is_float) return (uint64_t)load_int(p, i, esz);
  if (esz == 4) {
    const float f = static_cast<const float*>(p)[i];
    if (f != f) {
      const uint32_t u = static_cast<const uint32_t*>(p)[i];
      return ((uint64_t)(u & 0x80000000u) << 32) | 0x7FF8000000000000ULL |
             ((uint64_t)(u & 0x7FFFFFu) << 29);
    }
    return f == 0.0f ? 0ULL : (uint64_t)__double_as_longlong((double)f);
  }
  const double x = static_cast<const double*>(p)[i];
  return x == 0.0 ? 0ULL : (uint64_t)__double_as_longlong(x);
}

__device__ __forceinline__ uint64_t hash64(uint64_t x) {
  return mix64(x + GOLDEN);
}

// K29: mode 0 checksum (out0 = contribution), mode 1 HLL (out0 = pair or
// -1, out1 = rho or 0).
__global__ void hash_kernel(int mode, const void* values, int esz,
                            int is_float, int64_t cap,
                            const int32_t* num_rows, const Masks mk,
                            const int32_t* gid, int64_t* out0,
                            int64_t* out1) {
  const int64_t n = live_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool elig = i < n && passes(mk, i);
    const uint64_t h = elig ? hash64(hash_input(values, i, esz, is_float))
                            : 0ULL;
    if (mode == 0) {
      out0[i] = elig ? (int64_t)h : 0;
      continue;
    }
    const uint64_t w = h & ((1ULL << 53) - 1);
    out0[i] = elig ? ((group_of(gid, i) << HLL_P) | (int64_t)(h >> 53)) : -1;
    out1[i] = elig ? (w ? (int64_t)(__clzll((long long)w) - 10) : 54) : 0;
  }
}

// ------------------------------------------------------------ centered

enum CenteredKind {
  VAR_POP = 0, STDDEV_POP, VAR_SAMP, STDDEV_SAMP, COVAR_POP, COVAR_SAMP,
  CORR, REGR_SLOPE, REGR_INTERCEPT
};

// A numeric argument as the reference's _to_double: float64, a decimal's
// unscaled value divided by 10^scale (`div` 0 = no division).
struct Arg {
  const void* p;
  int esz;
  int is_float;
  double div;
};

__device__ __forceinline__ double arg_value(const Arg& a, int64_t i) {
  double x = a.is_float ? load_float(a.p, i, a.esz)
                        : (double)load_int(a.p, i, a.esz);
  return a.div != 0.0 ? x / a.div : x;
}

// Per-group accumulators, [nseg] each: cnt (u64), sa, sb, caa, cbb, cab.
struct Moments {
  unsigned long long* cnt;
  double* sa;
  double* sb;
  double* caa;
  double* cbb;
  double* cab;
};

__device__ __forceinline__ int64_t groups_here(const int32_t* num_groups,
                                               int64_t nseg) {
  if (num_groups == nullptr) return nseg;
  const int64_t g = *num_groups;
  return g < 0 ? 0 : (g > nseg ? nseg : g);
}

// Pass 1 (pass == 1): cnt, Σa, Σb; pass 2: the centered products.
__global__ void centered_kernel(int pass, Arg a, Arg b, int bivar,
                                int64_t cap, const int32_t* num_rows,
                                const Masks mk, const int32_t* gid,
                                const int32_t* num_groups, int64_t nseg,
                                Moments mo) {
  __shared__ double sh[5 * SMEM_GROUPS];
  const int64_t n = live_rows(num_rows, cap);
  const int64_t G = groups_here(num_groups, nseg);
  const bool local = G <= SMEM_GROUPS;
  double* s0 = sh;                     // pass 1: cnt (as double), Σa, Σb
  double* s1 = sh + SMEM_GROUPS;       // pass 2: Σda², Σdb², Σda·db, then
  double* s2 = sh + 2 * SMEM_GROUPS;   // the means of a and b
  double* ma = sh + 3 * SMEM_GROUPS;
  double* mb = sh + 4 * SMEM_GROUPS;
  if (local) {
    for (int64_t g = threadIdx.x; g < G; g += blockDim.x) {
      s0[g] = s1[g] = s2[g] = 0.0;
      if (pass == 2) {
        const double nf = fmax((double)mo.cnt[g], 1.0);
        ma[g] = mo.sa[g] / nf;
        mb[g] = bivar ? mo.sb[g] / nf : 0.0;
      }
    }
    __syncthreads();
  }
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!passes(mk, i)) continue;
    const int64_t g = group_of(gid, i);
    const double x = arg_value(a, i);
    const double y = bivar ? arg_value(b, i) : 0.0;
    if (pass == 1) {
      if (local) {
        atomicAdd(&s0[g], 1.0);
        atomicAdd(&s1[g], x);
        if (bivar) atomicAdd(&s2[g], y);
      } else {
        atomicAdd(&mo.cnt[g], 1ULL);
        atomicAdd(&mo.sa[g], x);
        if (bivar) atomicAdd(&mo.sb[g], y);
      }
      continue;
    }
    double mx, my;
    if (local) {
      mx = ma[g];
      my = mb[g];
    } else {
      const double nf = fmax((double)mo.cnt[g], 1.0);
      mx = mo.sa[g] / nf;
      my = bivar ? mo.sb[g] / nf : 0.0;
    }
    const double da = x - mx;
    double* caa = local ? &s0[g] : &mo.caa[g];
    atomicAdd(caa, da * da);
    if (bivar) {
      const double db = y - my;
      atomicAdd(local ? &s1[g] : &mo.cbb[g], db * db);
      atomicAdd(local ? &s2[g] : &mo.cab[g], da * db);
    }
  }
  if (!local) return;
  __syncthreads();
  for (int64_t g = threadIdx.x; g < G; g += blockDim.x) {
    if (pass == 1) {
      if (s0[g] == 0.0) continue;
      atomicAdd(&mo.cnt[g], (unsigned long long)s0[g]);
      atomicAdd(&mo.sa[g], s1[g]);
      if (bivar) atomicAdd(&mo.sb[g], s2[g]);
    } else {
      if (mo.cnt[g] == 0) continue;
      atomicAdd(&mo.caa[g], s0[g]);
      if (bivar) {
        atomicAdd(&mo.cbb[g], s1[g]);
        atomicAdd(&mo.cab[g], s2[g]);
      }
    }
  }
}

// _centered_finalize per group.
__global__ void centered_finalize_kernel(int kind,
                                         const int32_t* num_groups,
                                         int64_t nseg, Moments mo,
                                         double* out, uint8_t* valid) {
  const int64_t G = groups_here(num_groups, nseg);
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    const unsigned long long cnt = mo.cnt[g];
    const double nf = fmax((double)cnt, 1.0);
    const double caa = mo.caa[g], cbb = mo.cbb[g], cab = mo.cab[g];
    double v;
    bool ok;
    switch (kind) {
      case VAR_POP: case STDDEV_POP:
        v = caa / nf; ok = cnt > 0; break;
      case VAR_SAMP: case STDDEV_SAMP:
        v = caa / fmax(nf - 1.0, 1.0); ok = cnt > 1; break;
      case COVAR_POP:
        v = cab / nf; ok = cnt > 0; break;
      case COVAR_SAMP:
        v = cab / fmax(nf - 1.0, 1.0); ok = cnt > 1; break;
      case CORR: {
        const double denom = sqrt(caa * cbb);
        v = cab / (denom > 0.0 ? denom : 1.0);
        ok = cnt > 1 && denom > 0.0;
        break;
      }
      case REGR_SLOPE:
        v = cab / (cbb > 0.0 ? cbb : 1.0); ok = cnt > 0 && cbb > 0.0; break;
      default: {  // REGR_INTERCEPT = mean(a) - slope * mean(b)
        const double slope = cab / (cbb > 0.0 ? cbb : 1.0);
        v = mo.sa[g] / nf - slope * mo.sb[g] / nf;
        ok = cnt > 0 && cbb > 0.0;
      }
    }
    // jnp.maximum(v, 0) keeps a NaN, where fmax would drop it
    if (kind == STDDEV_POP || kind == STDDEV_SAMP)
      v = sqrt(v > 0.0 || v != v ? v : 0.0);
    out[g] = v;
    valid[g] = ok;
  }
}

// ---------------------------------------------------------- positional

enum PositionalKind { ARBITRARY = 0, MIN_BY = 1, MAX_BY = 2 };

// y as an order key: -0.0 made +0.0 and NaN +inf before the float map.
__device__ __forceinline__ long long y_key(const void* p, int64_t i,
                                           int esz, int is_float) {
  if (!is_float) return load_int(p, i, esz);
  double x = load_float(p, i, esz);
  if (x != x) x = __longlong_as_double(0x7ff0000000000000LL);
  return ordered_key(x == 0.0 ? 0.0 : x);
}

constexpr long long NO_ROW = 0x7fffffffffffffffLL;

// Pass 1 (min_by/max_by): ext[g] = the extremum of y over eligible rows.
// Pass 2: first[g] = the lowest eligible row at it (arbitrary: lowest
// eligible row).
__global__ void positional_kernel(int pass, int kind, const void* y,
                                  int y_esz, int y_float, int64_t cap,
                                  const int32_t* num_rows, const Masks mk,
                                  const int32_t* gid,
                                  const int32_t* num_groups, int64_t nseg,
                                  long long* ext, long long* first) {
  __shared__ long long sh[2 * SMEM_GROUPS];
  const int64_t n = live_rows(num_rows, cap);
  const int64_t G = groups_here(num_groups, nseg);
  const bool local = G <= SMEM_GROUPS;
  const bool is_min = kind == MIN_BY;
  long long* sx = sh;                  // the extremum (pass 1: partial)
  long long* sf = sh + SMEM_GROUPS;    // pass 2: the first row
  if (local) {
    for (int64_t g = threadIdx.x; g < G; g += blockDim.x) {
      if (pass == 1)
        sx[g] = is_min ? NO_ROW : (long long)SIGN;
      else if (kind != ARBITRARY)
        sx[g] = ext[g];
      sf[g] = NO_ROW;
    }
    __syncthreads();
  }
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!passes(mk, i)) continue;
    const int64_t g = group_of(gid, i);
    if (pass == 1) {
      const long long k = y_key(y, i, y_esz, y_float);
      long long* dst = local ? &sx[g] : &ext[g];
      if (is_min) atomicMin(dst, k); else atomicMax(dst, k);
      continue;
    }
    if (kind != ARBITRARY &&
        y_key(y, i, y_esz, y_float) != (local ? sx[g] : ext[g]))
      continue;
    atomicMin(local ? &sf[g] : &first[g], (long long)i);
  }
  if (!local) return;
  __syncthreads();
  for (int64_t g = threadIdx.x; g < G; g += blockDim.x) {
    if (pass == 1) {
      if (sx[g] == (is_min ? NO_ROW : (long long)SIGN)) continue;
      if (is_min) atomicMin(&ext[g], sx[g]); else atomicMax(&ext[g], sx[g]);
    } else if (sf[g] != NO_ROW) {
      atomicMin(&first[g], sf[g]);
    }
  }
}

// out[g] = x[first[g]] (esz bytes), valid[g] = a row was found and its x
// is not NULL; 0 and false where none was.
__global__ void positional_finalize_kernel(const void* x, int x_esz,
                                           const uint8_t* x_valid,
                                           const int32_t* num_groups,
                                           int64_t nseg,
                                           const long long* first,
                                           void* out, uint8_t* valid) {
  const int64_t G = groups_here(num_groups, nseg);
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    const long long r = first[g];
    if (r == NO_ROW) {
      const uint64_t zero = 0;
      copy_elem(&zero, 0, out, g, x_esz);
      valid[g] = 0;
      continue;
    }
    copy_elem(x, r, out, g, x_esz);
    valid[g] = x_valid == nullptr ? 1 : x_valid[r];
  }
}

// ------------------------------------------------------------ HLL fold

constexpr int HLL_THREADS = 1024;                 // ops/aggregate.py
constexpr unsigned long long HLL_COUNT_ONE = 1ULL << 44;

// _hll_estimate of group g from its two scratch words, which it returns
// to zero: raw estimator + small-range linear counting, rounded half to
// even. alpha_mm = alpha * m * m as the host computes it.
__device__ __forceinline__ void hll_estimate(int64_t g, double alpha_mm,
                                             unsigned long long* hi,
                                             unsigned long long* lo,
                                             int64_t* out) {
  const unsigned long long h = __ldcg(hi + g), l = __ldcg(lo + g);
  hi[g] = 0;
  lo[g] = 0;
  const double m = (double)(1 << HLL_P);
  const double units = __dadd_rn(__dmul_rn((double)h, 4294967296.0),
                                 (double)(l & (HLL_COUNT_ONE - 1)));
  const double sum_present = __dmul_rn(units, 0x1p-54);
  const double cnt_present = (double)(l >> 44);
  const double sum_full = __dadd_rn(sum_present, __dsub_rn(m, cnt_present));
  const double est = __ddiv_rn(alpha_mm, fmax(sum_full, 1e-12));
  const double zeros = __dsub_rn(m, cnt_present);
  const double lc = __dmul_rn(m, log(__ddiv_rn(m, fmax(zeros, 1.0))));
  const bool use_lc = est <= 2.5 * m && zeros > 0.0;
  out[g] = (int64_t)rint(use_lc ? lc : est);
}

// Over K8's pair page: hi the high halves of Σ 2^(54 - reg) per group, lo
// the low halves plus the present buckets << 44; then, in the last block
// to finish, the estimates when the groups are at most last_max.
__global__ void __launch_bounds__(HLL_THREADS) hll_fold_kernel(
    const int64_t* __restrict__ pairs, const int64_t* __restrict__ regs,
    const int32_t* __restrict__ num_pairs, int64_t cap,
    const int32_t* __restrict__ num_groups, int64_t nseg, int64_t last_max,
    double alpha_mm, unsigned long long* __restrict__ hi,
    unsigned long long* __restrict__ lo, unsigned* __restrict__ ticket,
    int64_t* __restrict__ out) {
  __shared__ bool last;
  const int64_t n = live_rows(num_pairs, cap);
  const int64_t G = groups_here(num_groups, nseg);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t pair = pairs[i], reg = regs[i];
    if (pair < 0 || reg <= 0 || (pair >> HLL_P) >= G) continue;
    const int64_t g = pair >> HLL_P, sh = 54 - reg;
    const unsigned long long t = 1ULL << (sh < 0 ? 0 : (sh > 53 ? 53 : sh));
    if (t >> 32) atomicAdd(&hi[g], t >> 32);
    atomicAdd(&lo[g], (t & 0xffffffffULL) + HLL_COUNT_ONE);
  }
  // the block's sums are visible before the ticket counts it: the
  // barrier orders them before thread 0's fence (the pattern of
  // cooperative groups' grid sync), so no thread waits on a fence of its own
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (G <= last_max)
    for (int64_t g = threadIdx.x; g < G; g += blockDim.x)
      hll_estimate(g, alpha_mm, hi, lo, out);
  if (threadIdx.x == 0) *ticket = 0;
}

// The estimates when the groups are more than the fold's last block takes
// (else it returns at once).
__global__ void hll_finalize_kernel(const int32_t* __restrict__ num_groups,
                                    int64_t nseg, int64_t last_max,
                                    double alpha_mm,
                                    unsigned long long* __restrict__ hi,
                                    unsigned long long* __restrict__ lo,
                                    int64_t* __restrict__ out) {
  const int64_t G = groups_here(num_groups, nseg);
  if (G <= last_max) return;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x)
    hll_estimate(g, alpha_mm, hi, lo, out);
}

// ---------------------------------------------------------- percentile

// The value's K10 word (stored form: signed order = the field's order).
__device__ __forceinline__ long long value_word(const void* p, int64_t i,
                                                int esz, int is_float) {
  return y_key(p, i, esz, is_float);
}

// words[0][i] = ((group << 32) | (not eligible << 31)) ^ SIGN,
// words[1][i] = the value's order key; live rows only.
__global__ void percentile_words_kernel(const void* x, int esz,
                                        int is_float, int64_t cap,
                                        const int32_t* num_rows,
                                        const Masks mk, const int32_t* gid,
                                        long long* words) {
  const int64_t n = live_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool elig = passes(mk, i);
    const uint64_t w0 = ((uint64_t)group_of(gid, i) << 32) |
                        ((uint64_t)(elig ? 0 : 1) << 31);
    words[i] = (long long)(w0 ^ SIGN);
    words[cap + i] = elig ? value_word(x, i, esz, is_float) : 0LL;
  }
}

// Over the sorted positions: start[g] (the group's first position), endp[g]
// (one past its last eligible position; -1 when none), pmax[g] (the order
// key of p's maximum over the group's live rows).
__global__ void percentile_scan_kernel(const int32_t* perm, int64_t cap,
                                       const int32_t* num_rows,
                                       const Masks mk, const int32_t* gid,
                                       const void* p, int p_esz,
                                       int p_float, long long* start,
                                       long long* endp, long long* pmax) {
  const int64_t n = live_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = perm[i];
    const int64_t g = group_of(gid, r);
    if (i == 0 || group_of(gid, perm[i - 1]) != g) start[g] = i;
    const bool elig = passes(mk, r);
    if (elig) {
      bool last = i + 1 == n;
      if (!last) {
        const int64_t r2 = perm[i + 1];
        last = group_of(gid, r2) != g || !passes(mk, r2);
      }
      if (last) endp[g] = i + 1;
    }
    const double pv = p_float ? load_float(p, r, p_esz)
                              : (double)load_int(p, r, p_esz);
    atomicMax(&pmax[g], ordered_key(pv));
  }
}

__global__ void percentile_pick_kernel(const int32_t* perm, int64_t cap,
                                       const int32_t* num_groups,
                                       int64_t nseg, const void* x, int esz,
                                       const long long* start,
                                       const long long* endp,
                                       const long long* pmax, void* out,
                                       uint8_t* valid) {
  const int64_t G = groups_here(num_groups, nseg);
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    const long long e = endp[g];
    const long long cnt = e >= 0 ? e - start[g] : 0;
    if (cnt == 0) {
      const uint64_t zero = 0;
      copy_elem(&zero, 0, out, g, esz);
      valid[g] = 0;
      continue;
    }
    const double pg = from_key(pmax[g]);
    int k = (int)ceil(__dmul_rn(pg, (double)cnt));
    const long long hi = cnt > 1 ? cnt : 1;
    long long kk = k < 1 ? 1 : (k > hi ? hi : k);
    long long idx = start[g] + kk - 1;
    idx = idx < 0 ? 0 : (idx > cap - 1 ? cap - 1 : idx);
    copy_elem(x, perm[idx], out, g, esz);
    valid[g] = 1;
  }
}

// p[g] = v for the groups that exist (g < num_groups): a grouped output
// has the page's capacity, and only its first num_groups rows are read.
__global__ void fill_kernel(long long* p, const int32_t* num_groups,
                            int64_t nseg, long long v) {
  const int64_t G = groups_here(num_groups, nseg);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < G;
       i += (int64_t)gridDim.x * blockDim.x)
    p[i] = v;
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}

int masks_from(const int64_t* ptrs, int64_t count, Masks* mk) {
  if (count < 0 || count > MAX_MASKS) return 1;
  mk->count = (int)count;
  for (int q = 0; q < MAX_MASKS; ++q)
    mk->m[q] = q < count ? reinterpret_cast<const uint8_t*>(ptrs[q])
                         : nullptr;
  return 0;
}
}  // namespace

// K29. mode 0: out0 = checksum contributions; mode 1: out0 = HLL pairs,
// out1 = rho. values: [cap] column of esz bytes; num_rows: int32 scalar or
// null (every row live); masks: host array of `nmasks` uint8 [cap]
// pointers (0 = none); gid: int32 [cap] or null. Returns
// cudaGetLastError(), -1 on a bad argument.
TT_EXPORT int special_hash(int64_t mode, const void* values, int64_t esz,
                           int64_t is_float, int64_t cap,
                           const void* num_rows, const void* masks,
                           int64_t nmasks, const void* gid, void* out0,
                           void* out1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(static_cast<const int64_t*>(masks), nmasks, &mk)) return -1;
  if (cap > 0)
    hash_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        (int)mode, values, (int)esz, (int)is_float, cap,
        static_cast<const int32_t*>(num_rows), mk,
        static_cast<const int32_t*>(gid), static_cast<int64_t*>(out0),
        static_cast<int64_t*>(out1));
  return (int)cudaGetLastError();
}

// K30 centered mode. a/b: [cap] columns (esz, is_float, divisor 0 = none;
// b unused unless bivar); moments: 6 x nseg 8-byte words (cnt, sa, sb,
// caa, cbb, cab), zeroed here; out: float64 [nseg]; valid: uint8 [nseg].
TT_EXPORT int special_centered(int64_t kind, const void* a, int64_t a_esz,
                               int64_t a_float, double a_div, const void* b,
                               int64_t b_esz, int64_t b_float, double b_div,
                               int64_t bivar, int64_t cap,
                               const void* num_rows, const void* masks,
                               int64_t nmasks, const void* gid,
                               const void* num_groups, int64_t nseg,
                               void* moments, void* out, void* valid,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (nseg < 1 ||
      masks_from(static_cast<const int64_t*>(masks), nmasks, &mk))
    return -1;
  auto* w = static_cast<double*>(moments);
  const Moments mo{reinterpret_cast<unsigned long long*>(w), w + nseg,
                   w + 2 * nseg, w + 3 * nseg, w + 4 * nseg, w + 5 * nseg};
  const Arg aa{a, (int)a_esz, (int)a_float, a_div};
  const Arg bb{bivar ? b : a, (int)b_esz, (int)b_float, b_div};
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* g = static_cast<const int32_t*>(gid);
  const auto* ng = static_cast<const int32_t*>(num_groups);
  for (int q = 0; q < 6; ++q)  // 0 and 0.0 share their bits
    fill_kernel<<<grid_for(nseg), THREADS, 0, s>>>(
        reinterpret_cast<long long*>(w + q * nseg), ng, nseg, 0);
  for (int pass = 1; pass <= 2; ++pass)
    centered_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        pass, aa, bb, (int)bivar, cap, nr, mk, g, ng, nseg, mo);
  centered_finalize_kernel<<<grid_for(nseg), THREADS, 0, s>>>(
      (int)kind, ng, nseg, mo, static_cast<double*>(out),
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

// K30 positional mode. kind: 0 arbitrary, 1 min_by, 2 max_by; y unused for
// arbitrary; scratch: 2 x nseg int64 (ext, first); out: [nseg] of x_esz
// bytes; valid: uint8 [nseg].
TT_EXPORT int special_positional(int64_t kind, const void* x, int64_t x_esz,
                                 const void* x_valid, const void* y,
                                 int64_t y_esz, int64_t y_float, int64_t cap,
                                 const void* num_rows, const void* masks,
                                 int64_t nmasks, const void* gid,
                                 const void* num_groups, int64_t nseg,
                                 void* scratch, void* out, void* valid,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (nseg < 1 ||
      masks_from(static_cast<const int64_t*>(masks), nmasks, &mk))
    return -1;
  auto* ext = static_cast<long long*>(scratch);
  auto* first = ext + nseg;
  const unsigned gs = grid_for(nseg);
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* g = static_cast<const int32_t*>(gid);
  const auto* ng = static_cast<const int32_t*>(num_groups);
  fill_kernel<<<gs, THREADS, 0, s>>>(
      ext, ng, nseg, kind == MAX_BY ? (long long)SIGN : NO_ROW);
  fill_kernel<<<gs, THREADS, 0, s>>>(first, ng, nseg, NO_ROW);
  for (int pass = kind == ARBITRARY ? 2 : 1; pass <= 2; ++pass)
    positional_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        pass, (int)kind, y, (int)y_esz, (int)y_float, cap, nr, mk, g, ng,
        nseg, ext, first);
  positional_finalize_kernel<<<gs, THREADS, 0, s>>>(
      x, (int)x_esz, static_cast<const uint8_t*>(x_valid), ng, nseg, first,
      out, static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

static int64_t hll_kernels = 0;   // launched by special_hll, for the count

// K30 HLL mode. pairs/regs: K8's output over the (group, bucket) pairs
// (int64 [cap] each, num_pairs live); num_groups: int32 scalar or null
// (nseg groups); hi, lo: u64 [at least nseg] each, zero, and left zero;
// ticket: uint32, 0, and left 0; out: int64 [nseg] estimates (the first
// num_groups written); grid: the fold's blocks; last_max: the most groups
// the fold's last block finalizes (above, and only when nseg exceeds it,
// a second launch does). Returns cudaGetLastError(), -1 on a bad
// argument.
TT_EXPORT int special_hll(const void* pairs, const void* regs,
                          const void* num_pairs, int64_t cap,
                          const void* num_groups, int64_t nseg,
                          double alpha_mm, void* hi, void* lo, void* ticket,
                          void* out, int64_t grid, int64_t last_max,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nseg < 1 || grid < 1 || grid > INT32_MAX) return -1;
  const auto* ng = static_cast<const int32_t*>(num_groups);
  auto* h = static_cast<unsigned long long*>(hi);
  auto* l = static_cast<unsigned long long*>(lo);
  auto* o = static_cast<int64_t*>(out);
  hll_fold_kernel<<<(unsigned)grid, HLL_THREADS, 0, s>>>(
      static_cast<const int64_t*>(pairs), static_cast<const int64_t*>(regs),
      static_cast<const int32_t*>(num_pairs), cap, ng, nseg, last_max,
      alpha_mm, h, l, static_cast<unsigned*>(ticket), o);
  ++hll_kernels;
  if (nseg > last_max) {
    hll_finalize_kernel<<<grid_for(nseg), THREADS, 0, s>>>(
        ng, nseg, last_max, alpha_mm, h, l, o);
    ++hll_kernels;
  }
  return (int)cudaGetLastError();
}

// The kernels special_hll has launched in this process (chip_smoke.py
// counts them per call).
TT_EXPORT int64_t special_hll_kernels() { return hll_kernels; }

// K31 words launch: words int64 [2, cap] in K10's stored form (live rows).
TT_EXPORT int special_percentile_words(const void* x, int64_t esz,
                                       int64_t is_float, int64_t cap,
                                       const void* num_rows,
                                       const void* masks, int64_t nmasks,
                                       const void* gid, void* words,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(static_cast<const int64_t*>(masks), nmasks, &mk)) return -1;
  if (cap > 0)
    percentile_words_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        x, (int)esz, (int)is_float, cap,
        static_cast<const int32_t*>(num_rows), mk,
        static_cast<const int32_t*>(gid), static_cast<long long*>(words));
  return (int)cudaGetLastError();
}

// K31 pick launch over K10's permutation perm (int32 [cap]): num_groups
// int32 scalar or null (nseg groups); scratch 3 x nseg int64 (start, endp,
// pmax); p: [cap] column; out: [nseg] of x's esz bytes; valid: uint8
// [nseg] (the first num_groups written).
TT_EXPORT int special_percentile_pick(const void* perm, int64_t cap,
                                      const void* num_rows, const void* masks,
                                      int64_t nmasks, const void* gid,
                                      const void* num_groups, const void* p,
                                      int64_t p_esz, int64_t p_float,
                                      const void* x, int64_t esz,
                                      int64_t nseg, void* scratch, void* out,
                                      void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (nseg < 1 ||
      masks_from(static_cast<const int64_t*>(masks), nmasks, &mk))
    return -1;
  auto* start = static_cast<long long*>(scratch);
  auto* endp = start + nseg;
  auto* pmax = endp + nseg;
  const unsigned gs = grid_for(nseg);
  const auto* ng = static_cast<const int32_t*>(num_groups);
  fill_kernel<<<gs, THREADS, 0, s>>>(start, ng, nseg, 0);
  fill_kernel<<<gs, THREADS, 0, s>>>(endp, ng, nseg, -1);
  fill_kernel<<<gs, THREADS, 0, s>>>(pmax, ng, nseg, (long long)SIGN);
  const auto* pm = static_cast<const int32_t*>(perm);
  if (cap > 0)
    percentile_scan_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        pm, cap, static_cast<const int32_t*>(num_rows), mk,
        static_cast<const int32_t*>(gid), p, (int)p_esz, (int)p_float, start,
        endp, pmax);
  percentile_pick_kernel<<<gs, THREADS, 0, s>>>(
      pm, cap, ng, nseg, x, (int)esz, start, endp, pmax, out,
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}
