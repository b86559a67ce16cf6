// K4: the global aggregation's reduction of every state column to one row.
//
// Replaces trino_tpu/ops/aggregate.py _global_aggregate (:1229), whose
// per-state jnp.sum/min/max over the page XLA fuses into reductions: rows
// past num_rows, and rows whose validity or FILTER mask is false,
// contribute the reducer's identity.
//
// Bound on this card: bytes — each state column (and its validity and
// FILTER mask) read once over the live rows, one word per state written.
// At the main path's calls (q6 sf1: 85,646 live rows, 2 states) the call
// is bound by the host's enqueue, so the design is one launch for any
// number of states, through the package's ctypes binding, with a
// parameter block sized to the call (one 5-word descriptor per state:
// values, validity and mask pointers, kind, float flag):
//   * a fixed persistent grid whose size depends on the capacity alone
//     (ops/aggregate.py global_grid), so the reduction order is fixed for
//     a given page: block b's thread t folds rows b * 256 + t + k * 256 *
//     grid (k = 0, 1, ...) below the device-side num_rows, in that order,
//     for every state in turn, then the block folds its 256 values in a
//     fixed tree (warp shuffles, then the 8 warp values);
//   * per-block partials (the value word and a NaN flag per state) go to
//     a scratch buffer; each block then fences and takes a ticket, and the
//     last block folds the partials of each state in block order (thread t
//     blocks t, t + 256, ..., then the same tree), writes one word per
//     state and resets the ticket for the next call.
// So float64 sums repeat bit for bit from run to run. min/max reduce
// order-preserving int64 keys of the floats (-0.0 < +0.0) with NaN carried
// as a separate flag, as jnp.min/max propagate NaN; sums propagate NaN and
// infinities as the float adds do.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int S>
struct Descs {
  int64_t v[S * STATE_FIELDS];
};

struct Acc {
  long long i;  // int64 sum, count, min/max value or order key
  double f;     // float64 sum
  int nan;      // a float min/max saw an eligible NaN
};

__device__ __forceinline__ void combine(Acc& a, const Acc& b, int kind) {
  if (kind == MIN)
    a.i = b.i < a.i ? b.i : a.i;
  else if (kind == MAX)
    a.i = b.i > a.i ? b.i : a.i;
  else
    a.i = (long long)((unsigned long long)a.i + (unsigned long long)b.i);
  a.f += b.f;
  a.nan |= b.nan;
}

// The block's fold of one Acc per thread, in a fixed tree: lane 0 of each
// warp holds its warp's fold after shuffles down by 16, 8, 4, 2, 1; warp 0
// folds the 8 warp values the same way (lanes past them hold the
// identity). The result is valid in thread 0.
__device__ __forceinline__ Acc block_fold(Acc a, int kind, Acc ident,
                                          Acc* warp_acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Acc b;
    b.i = __shfl_down_sync(0xffffffffu, a.i, o);
    b.f = __shfl_down_sync(0xffffffffu, a.f, o);
    b.nan = __shfl_down_sync(0xffffffffu, a.nan, o);
    if (lane + o < 32) combine(a, b, kind);
  }
  if (lane == 0) warp_acc[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < WARPS ? warp_acc[lane] : ident;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      Acc b;
      b.i = __shfl_down_sync(0xffffffffu, a.i, o);
      b.f = __shfl_down_sync(0xffffffffu, a.f, o);
      b.nan = __shfl_down_sync(0xffffffffu, a.nan, o);
      if (lane + o < 32) combine(a, b, kind);
    }
  }
  __syncthreads();  // warp_acc is reused by the next state
  return a;
}

// part: int64 [2 * nstates * grid] (value words, then NaN flags, state by
// state); ticket: one uint32, 0 between calls; out: int64 [nstates].
template <int S>
__global__ void __launch_bounds__(THREADS)
    global_kernel(const __grid_constant__ Descs<S> d, int nstates,
                  const int32_t* __restrict__ num_rows, int64_t cap,
                  long long* __restrict__ part, unsigned* __restrict__ ticket,
                  unsigned long long* __restrict__ out) {
  __shared__ Acc warp_acc[WARPS];
  __shared__ bool last;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const int64_t grid = gridDim.x;
  const int64_t stride = grid * THREADS;
  for (int j = 0; j < nstates; ++j) {
    const int64_t* s = d.v + (int64_t)j * STATE_FIELDS;
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(s[1]);
    const uint8_t* mask = reinterpret_cast<const uint8_t*>(s[2]);
    const int kind = (int)s[3], is_float = (int)s[4];
    const Acc ident = {(long long)agg_identity(kind, is_float), 0.0, 0};
    Acc a = ident;
    for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
         i += stride) {
      if ((valid != nullptr && !valid[i]) || (mask != nullptr && !mask[i]))
        continue;
      if (kind == COUNT) {
        a.i += 1;
        continue;
      }
      const long long bits = reinterpret_cast<const long long*>(s[0])[i];
      if (!is_float) {
        const Acc b = {bits, 0.0, 0};
        combine(a, b, kind);
      } else if (kind == SUM) {
        a.f += __longlong_as_double(bits);
      } else {
        const double x = __longlong_as_double(bits);
        if (x != x) {
          a.nan = 1;
        } else {
          const Acc b = {ordered_key(x), 0.0, 0};
          combine(a, b, kind);
        }
      }
    }
    a = block_fold(a, kind, ident, warp_acc);
    if (threadIdx.x == 0) {
      const int64_t slot = (int64_t)j * grid + blockIdx.x;
      part[slot] = kind == SUM && is_float ? __double_as_longlong(a.f) : a.i;
      part[(int64_t)nstates * grid + slot] = a.nan;
    }
  }
  // the partials are visible before the ticket counts this block
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)grid - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = 0; j < nstates; ++j) {
    const int64_t* s = d.v + (int64_t)j * STATE_FIELDS;
    const int kind = (int)s[3], is_float = (int)s[4];
    const bool fsum = kind == SUM && is_float;
    const Acc ident = {(long long)agg_identity(kind, is_float), 0.0, 0};
    Acc a = ident;
    for (int64_t b = threadIdx.x; b < grid; b += THREADS) {
      const int64_t slot = (int64_t)j * grid + b;
      const long long w = __ldcg(part + slot);
      Acc x = ident;
      if (fsum)
        x.f = __longlong_as_double(w);
      else
        x.i = w;
      x.nan = (int)__ldcg(part + (int64_t)nstates * grid + slot);
      combine(a, x, kind);
    }
    a = block_fold(a, kind, ident, warp_acc);
    if (threadIdx.x == 0)
      out[j] = fsum ? (unsigned long long)__double_as_longlong(a.f)
                    : agg_result(kind, is_float, (unsigned long long)a.i,
                                 a.nan);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int S>
int launch(const void* table, int64_t nstates, const void* num_rows,
           int64_t cap, void* part, void* ticket, void* out, int64_t grid,
           cudaStream_t s) {
  thread_local static Descs<S> d;  // each launch copies it as a parameter
  const int64_t* src = static_cast<const int64_t*>(table);
  for (int64_t i = 0; i < nstates * STATE_FIELDS; ++i) d.v[i] = src[i];
  global_kernel<S><<<(unsigned)grid, THREADS, 0, s>>>(
      d, (int)nstates, static_cast<const int32_t*>(num_rows), cap,
      static_cast<long long*>(part), static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
}  // namespace

// table: int64 host array of STATE_FIELDS words per state (common.cuh);
// num_rows: int32; part: int64 [2 * nstates * grid]; ticket: uint32, 0;
// out: int64 [nstates]. Returns cudaGetLastError(), or -1 past
// TABLE_MAX / STATE_FIELDS states.
TT_EXPORT int global_reduce(const void* table, int64_t nstates,
                            const void* num_rows, int64_t cap, void* part,
                            void* ticket, void* out, int64_t grid,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1) grid = 1;
  if (nstates <= 8)
    return launch<8>(table, nstates, num_rows, cap, part, ticket, out, grid,
                     s);
  if (nstates <= 64)
    return launch<64>(table, nstates, num_rows, cap, part, ticket, out,
                      grid, s);
  if (nstates <= TABLE_MAX / STATE_FIELDS)
    return launch<TABLE_MAX / STATE_FIELDS>(table, nstates, num_rows, cap,
                                            part, ticket, out, grid, s);
  return -1;
}
