// K3: GROUP BY over a small static key space of dictionary codes.
//
// Replaces trino_tpu/ops/aggregate.py _direct_aggregate (+ _segment_reduce):
// per-row slot = mixed-radix combination of the key codes (a NULL key takes
// the last code of its key), dead rows drop out, every state is reduced per
// slot with jax.ops.segment_{sum,min,max}, and the present slots (live
// count > 0) are compacted in slot order with a cumsum over <= 4096 slots.
//
// Bound on this card: bytes — each key code, validity byte and state value
// is read once; the output is nseg * k words. The design keeps the slot
// table on chip:
//   1. accumulate_kernel — each block folds a grid-stride share of the rows
//      into [nseg, k + 1] tables in shared memory with shared atomics (the
//      extra column is the live count): 32 copies, one per lane, when they
//      fit, so a warp's lanes on one hot slot (q1 has 4 live slots) do not
//      serialise on one word; then it merges the copies of the slots it saw
//      into the global table with global atomics. A table too large for
//      shared memory runs its atomics on the global table directly.
//   2. finalize_kernel   — one block scans the present flags and writes the
//      compacted slot ids, the compacted states and num_groups.
// int64 sums are atomicAdd on unsigned 64-bit words, which wrap exactly as
// the reference's int64 does. float64 sums are atomicAdd(double), whose
// order varies from run to run (held to 1e-9 relative). min/max run on
// order-preserving int64 keys (a float's bits with the magnitude flipped
// when negative, so -0.0 < +0.0), as atomicMin/atomicMax, and NaN is a
// separate per-slot flag: the reference's segment_min/segment_max
// propagate NaN and pick -0.0 for min and +0.0 for max in any order.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int KEY_FIELDS = 4;    // codes ptr, valid ptr, size, stride
// per state: STATE_FIELDS words (csrc/common.cuh)

__global__ void init_kernel(const __grid_constant__ Table tbl, int64_t nkeys,
                            int64_t k, int64_t nseg,
                            unsigned long long* __restrict__ acc,
                            int* __restrict__ nan) {
  const int64_t* table = tbl.v;
  const int64_t* st = table + KEY_FIELDS * nkeys;
  const int64_t w = k + 1;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       e < nseg * w; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = e % w;
    acc[e] = j == k ? 0ULL
                    : agg_identity((int)st[j * STATE_FIELDS + 3],
                                   (int)st[j * STATE_FIELDS + 4]);
  }
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       e < nseg * k; e += (int64_t)gridDim.x * blockDim.x)
    nan[e] = 0;
}

// COPIES slot tables per block (one per lane class when they fit): lane l
// folds into copy l % COPIES, so the lanes of a warp that hit one hot slot
// touch distinct words instead of serialising on one. `stride` (8-byte
// words between copies) is odd, so the 16 lanes of a half-warp fall in
// distinct shared-memory banks. COPIES == 0 runs the atomics on the global
// table directly (a table too large for shared memory).
template <int COPIES>
__global__ void accumulate_kernel(const __grid_constant__ Table tbl,
                                  int64_t nkeys, int64_t k, int64_t nseg,
                                  int64_t stride, int64_t cap,
                                  const int32_t* __restrict__ num_rows,
                                  unsigned long long* __restrict__ gacc,
                                  int* __restrict__ gnan) {
  extern __shared__ unsigned long long smem[];
  const int64_t* table = tbl.v;
  const int64_t* keys = table;
  const int64_t* st = table + KEY_FIELDS * nkeys;
  const int64_t w = k + 1;
  unsigned long long* acc = COPIES ? smem : gacc;
  int* nan = COPIES ? reinterpret_cast<int*>(smem + COPIES * stride) : gnan;
  if (COPIES) {
    for (int64_t e = threadIdx.x; e < COPIES * stride; e += blockDim.x) {
      const int64_t j = (e % stride) % w;
      acc[e] = j == k ? 0ULL
                      : agg_identity((int)st[j * STATE_FIELDS + 3],
                                     (int)st[j * STATE_FIELDS + 4]);
    }
    for (int64_t e = threadIdx.x; e < nseg * k; e += blockDim.x) nan[e] = 0;
    __syncthreads();
  }
  const int64_t copy = COPIES ? (threadIdx.x & 31) % COPIES : 0;
  int64_t n = *num_rows;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t slot = 0;
    for (int64_t q = 0; q < nkeys; ++q) {
      const int32_t* codes = reinterpret_cast<const int32_t*>(keys[q * 4]);
      const uint8_t* kv = reinterpret_cast<const uint8_t*>(keys[q * 4 + 1]);
      const int64_t size = keys[q * 4 + 2];
      int64_t code = codes[i];
      code = code < 0 ? 0 : (code > size - 2 ? size - 2 : code);
      if (kv != nullptr && !kv[i]) code = size - 1;
      slot += code * keys[q * 4 + 3];
    }
    unsigned long long* row = acc + copy * stride + slot * w;
    atomicAdd(row + k, 1ULL);
    agg_fold_row(st, k, i, row, nan + slot * k);
  }
  if (!COPIES) return;
  __syncthreads();
  // merge the copies of each slot seen by this block into the global table
  for (int64_t e = threadIdx.x; e < nseg * w; e += blockDim.x) {
    const int64_t slot = e / w, j = e % w;
    unsigned long long seen = 0ULL;
    for (int c = 0; c < COPIES; ++c) seen += acc[c * stride + slot * w + k];
    if (seen == 0ULL) continue;
    if (j == k) {
      atomicAdd(gacc + e, seen);
      continue;
    }
    const int kind = (int)st[j * STATE_FIELDS + 3];
    const int is_float = (int)st[j * STATE_FIELDS + 4];
    if (nan[slot * k + j]) gnan[slot * k + j] = 1;
    for (int c = 0; c < COPIES; ++c) {
      const unsigned long long v = acc[c * stride + e];
      if (v != agg_identity(kind, is_float))
        agg_fold(gacc + e, kind, is_float, v);
    }
  }
}

__global__ void finalize_kernel(const __grid_constant__ Table tbl,
                                int64_t nkeys, int64_t k, int64_t nseg,
                                const unsigned long long* __restrict__ acc,
                                const int* __restrict__ nan,
                                int32_t* __restrict__ group_slots,
                                unsigned long long* __restrict__ out,
                                int32_t* __restrict__ num_groups) {
  __shared__ int warp_sums[32];
  const int64_t* st = tbl.v + KEY_FIELDS * nkeys;
  const int64_t w = k + 1;
  int64_t carry = 0;
  for (int64_t start = 0; start < nseg; start += blockDim.x) {
    const int64_t s = start + threadIdx.x;
    const int present = (s < nseg && acc[s * w + k] > 0ULL) ? 1 : 0;
    int total;
    const int ex = block_exclusive_scan(present, warp_sums, &total);
    if (present) {
      const int64_t pos = carry + ex;
      group_slots[pos] = (int32_t)s;
      for (int64_t j = 0; j < k; ++j) {
        const int kind = (int)st[j * STATE_FIELDS + 3];
        const int is_float = (int)st[j * STATE_FIELDS + 4];
        out[j * nseg + pos] = agg_result(kind, is_float, acc[s * w + j],
                                         nan[s * k + j]);
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) *num_groups = (int32_t)carry;
}
}  // namespace

// table: int64 HOST array [per key: codes ptr, valid ptr (0 = none),
// code-space size (dictionary size + 1), stride] then [per state: value
// ptr (int64/float64 bits; unused by COUNT), valid ptr, mask ptr (0 =
// none), kind (0 sum, 1 count, 2 min, 3 max), is_float].
// acc: 8-byte words [nseg, k + 1]; nan: int32 [nseg, k];
// group_slots: int32 [nseg]; out: 8-byte words [k, nseg];
// num_groups: int32 scalar. All but the table on the device. Returns
// cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int direct_aggregate(const void* table, int64_t nkeys, int64_t k,
                               int64_t nseg, int64_t cap,
                               const void* num_rows, void* acc, void* nan,
                               void* group_slots, void* out,
                               void* num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, KEY_FIELDS * nkeys + STATE_FIELDS * k, &t))
    return -1;
  auto* gacc = static_cast<unsigned long long*>(acc);
  auto* gnan = static_cast<int*>(nan);
  init_kernel<<<64, THREADS, 0, s>>>(t, nkeys, k, nseg, gacc, gnan);
  int64_t blocks = (cap + THREADS * 16 - 1) / (THREADS * 16);
  blocks = blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks);
  const int64_t stride = (nseg * (k + 1)) | 1;  // odd: no bank conflicts
  const size_t nan_bytes = (size_t)nseg * k * 4;
  const size_t limit = 96 * 1024;
  const int32_t* nr = static_cast<const int32_t*>(num_rows);
  auto launch = [&](auto kernel, int copies) {
    const size_t smem = copies ? (size_t)copies * stride * 8 + nan_bytes : 0;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kernel<<<(unsigned)blocks, THREADS, smem, s>>>(t, nkeys, k, nseg, stride,
                                                   cap, nr, gacc, gnan);
  };
  if ((size_t)32 * stride * 8 + nan_bytes <= limit)
    launch(accumulate_kernel<32>, 32);
  else if ((size_t)stride * 8 + nan_bytes <= limit)
    launch(accumulate_kernel<1>, 1);
  else
    launch(accumulate_kernel<0>, 0);
  finalize_kernel<<<1, 1024, 0, s>>>(
      t, nkeys, k, nseg, gacc, gnan, static_cast<int32_t*>(group_slots),
      static_cast<unsigned long long*>(out),
      static_cast<int32_t*>(num_groups));
  return (int)cudaGetLastError();
}
