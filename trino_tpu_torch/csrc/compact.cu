// K1: stable stream compaction of a page.
//
// Replaces trino_tpu/page.py Page.filter, which moves the selected live
// rows of every column to the front with ONE stable lax.sort on the drop
// flag (a sort is the TPU's fast data-movement engine).
//
// Bound on this card: bytes. Each row's mask byte and every column are
// read once and the selected rows written once; a q6 scan page of
// 4,194,304 rows with three int64 columns, one int32 column and the mask
// is ~122 MB read, ~36 us at 3.35 TB/s. A sort would move each byte
// log2(n) times, so the design is the bandwidth-optimal three passes:
//   1. count_kernel   — one count of selected rows per 4096-row tile
//                       (reads only the mask);
//   2. scan_kernel    — one block turns the tile counts into exclusive
//                       offsets and writes the total to the device-side
//                       num_rows (no host sync);
//   3. scatter_kernel — each tile re-derives its in-tile ranks with warp
//                       ballots + a block scan and copies every column of
//                       every selected row to offset + rank, so order is
//                       stable. Columns travel through one pointer table
//                       (element sizes 1, 2, 4 or 8 bytes) in one launch.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int TILE = 4096;  // rows per block; trino_tpu_torch/page.py COMPACT_TILE

__device__ __forceinline__ int64_t live_rows(const int32_t* num_rows,
                                             int64_t cap) {
  int64_t n = *num_rows;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__global__ void count_kernel(const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ num_rows,
                             int64_t cap, int64_t* __restrict__ counts) {
  __shared__ int warp_sums[32];
  const int64_t n = live_rows(num_rows, cap);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int c = 0;
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int64_t i = base + r;
    c += (i < n && mask[i]) ? 1 : 0;
  }
  int total;
  block_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void scan_kernel(int64_t* __restrict__ counts, int64_t nblocks,
                            int32_t* __restrict__ count_out) {
  __shared__ int warp_sums[32];
  int64_t carry = 0;
  for (int64_t start = 0; start < nblocks; start += blockDim.x) {
    const int64_t i = start + threadIdx.x;
    const int v = i < nblocks ? (int)counts[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, warp_sums, &total);
    if (i < nblocks) counts[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *count_out = (int32_t)carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask,
                               const int32_t* __restrict__ num_rows,
                               int64_t cap,
                               const int64_t* __restrict__ offsets,
                               int64_t ncols,
                               const __grid_constant__ Table tbl) {
  __shared__ int warp_sums[32];
  const int64_t* table = tbl.v;
  const int64_t n = live_rows(num_rows, cap);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  if (base >= n) return;  // uniform across the block
  const int64_t* src = table;
  const int64_t* dst = table + ncols;
  const int64_t* esz = table + 2 * ncols;
  int64_t out = offsets[blockIdx.x];
  for (int r = 0; r < TILE; r += THREADS) {
    const int64_t i = base + r + threadIdx.x;
    const int f = (i < n && mask[i]) ? 1 : 0;
    int total;
    const int ex = block_exclusive_scan(f, warp_sums, &total);
    if (f) {
      const int64_t pos = out + ex;
      for (int64_t c = 0; c < ncols; ++c)
        copy_elem(reinterpret_cast<const void*>(src[c]), i,
                  reinterpret_cast<void*>(dst[c]), pos, (int)esz[c]);
    }
    out += total;
  }
}
}  // namespace

// mask: uint8[cap]; num_rows: int32 scalar (device); table: int64 HOST
// array [src ptrs (ncols), dst ptrs (ncols), element sizes (ncols)];
// scratch: int64[ceil(cap / 4096)]; count_out: int32 scalar (device).
// Returns cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int compact_rows(const void* mask, const void* num_rows,
                           int64_t cap, int64_t ncols, const void* table,
                           void* scratch, void* count_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, 3 * ncols, &t)) return -1;
  const int64_t nblocks = cap > 0 ? (cap + TILE - 1) / TILE : 1;
  count_kernel<<<(unsigned)nblocks, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(num_rows),
      cap, static_cast<int64_t*>(scratch));
  scan_kernel<<<1, 1024, 0, s>>>(static_cast<int64_t*>(scratch), nblocks,
                                 static_cast<int32_t*>(count_out));
  if (ncols > 0)
    scatter_kernel<<<(unsigned)nblocks, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(num_rows), cap,
        static_cast<const int64_t*>(scratch), ncols, t);
  return (int)cudaGetLastError();
}
