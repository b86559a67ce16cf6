// K2: device-side concatenation of the live prefixes of N pages.
//
// Replaces trino_tpu/page.py device_concat, which writes each page's
// full-capacity columns with lax.dynamic_update_slice at a traced running
// offset, page after page (the next page overwrites the previous page's
// padding tail).
//
// Bound on this card: bytes — each live row of each column is read once
// and written once. The design never reads the counts on the host:
//   1. offsets_kernel — one thread forms the N running offsets and the
//                       total (written to the output num_rows) from the
//                       device-side counts;
//   2. copy_kernel    — grid (row tiles, pages): each block copies its
//                       tile of one page's live prefix, column by column
//                       (coalesced reads and writes), to offset + row.
// Only live rows move, so padding costs nothing; a page whose validity is
// absent while another page's is present has a null source and writes
// "valid" bytes. Empty pages and capacities that are not a multiple of the
// tile are handled by the per-block bounds. K32: a list plane [cap, L]
// moves as rows of element size x L bytes; a page whose plane is narrower
// than the output's (a smaller L) writes zeros past its row.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int TILE = 2048;

__global__ void offsets_kernel(const __grid_constant__ Table tbl,
                               int64_t npages, int64_t* __restrict__ offsets,
                               int32_t* __restrict__ total) {
  if (threadIdx.x != 0) return;
  const int64_t* table = tbl.v;
  const int64_t* counts = table;
  const int64_t* caps = table + npages;
  int64_t run = 0;
  for (int64_t p = 0; p < npages; ++p) {
    offsets[p] = run;
    int64_t c = *reinterpret_cast<const int32_t*>(counts[p]);
    c = c < 0 ? 0 : (c > caps[p] ? caps[p] : c);
    run += c;
  }
  *total = (int32_t)run;
}

__global__ void copy_kernel(const __grid_constant__ Table tbl,
                            int64_t npages, int64_t ncols, int with_srb,
                            const int64_t* __restrict__ offsets) {
  const int64_t* table = tbl.v;
  const int64_t p = blockIdx.y;
  const int64_t* counts = table;
  const int64_t* caps = table + npages;
  const int64_t* srcs = table + 2 * npages;
  const int64_t* dsts = srcs + npages * ncols;
  const int64_t* drb = dsts + ncols;
  const int64_t* srb = drb + ncols;
  int64_t cnt = *reinterpret_cast<const int32_t*>(counts[p]);
  cnt = cnt < 0 ? 0 : (cnt > caps[p] ? caps[p] : cnt);
  const int64_t r0 = (int64_t)blockIdx.x * TILE;
  if (r0 >= cnt) return;
  const int64_t r1 = r0 + TILE < cnt ? r0 + TILE : cnt;
  const int64_t off = offsets[p];
  for (int64_t c = 0; c < ncols; ++c) {
    const void* src = reinterpret_cast<const void*>(srcs[p * ncols + c]);
    void* dst = reinterpret_cast<void*>(dsts[c]);
    const int64_t d = drb[c], sr = with_srb ? srb[p * ncols + c] : d;
    for (int64_t r = r0 + threadIdx.x; r < r1; r += THREADS) {
      if (src == nullptr)
        static_cast<uint8_t*>(dst)[off + r] = 1;
      else
        copy_row_padded(src, r, sr, dst, off + r, d);
    }
  }
}
}  // namespace

// table: int64 HOST array [count ptrs (npages), capacities (npages),
// src ptrs (npages * ncols, 0 = all-valid bytes), dst ptrs (ncols),
// dst row sizes in bytes (ncols), then, when with_srb, src row sizes in
// bytes (npages * ncols, at most the dst's; without them each page's rows
// are the dst's)]; offsets: int64[npages] scratch; total: int32.
// Returns cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int concat_rows(int64_t npages, int64_t ncols, int64_t max_cap,
                          int64_t with_srb, const void* table, void* offsets,
                          void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table,
                 2 * npages + (1 + (with_srb != 0)) * npages * ncols +
                     2 * ncols,
                 &t))
    return -1;
  offsets_kernel<<<1, 32, 0, s>>>(t, npages, static_cast<int64_t*>(offsets),
                                  static_cast<int32_t*>(total));
  const int64_t tiles = max_cap > 0 ? (max_cap + TILE - 1) / TILE : 0;
  if (tiles > 0 && ncols > 0)
    copy_kernel<<<dim3((unsigned)tiles, (unsigned)npages), THREADS, 0, s>>>(
        t, npages, ncols, (int)(with_srb != 0),
        static_cast<const int64_t*>(offsets));
  return (int)cudaGetLastError();
}
