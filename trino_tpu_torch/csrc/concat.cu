// K2: device-side concatenation of the live prefixes of N pages.
//
// Replaces trino_tpu/page.py device_concat, which writes each page's
// full-capacity columns with lax.dynamic_update_slice at a traced running
// offset, page after page (the next page overwrites the previous page's
// padding tail), and the receive of trino_tpu/parallel/exchange.py
// (_exchange_compact, broadcast_page, gather_page), which is the same
// concatenation of the sources' slices.
//
// Bound on this card: bytes — each live row of each column is read once
// and written once. At the main path's calls the data is small (q1's
// partial buffer moves 8 rows) and the call is bound by the host's
// enqueue, so the design is one launch with a parameter block sized to
// the call:
//   * one kernel: every block reads the device-side counts of all pages
//     (clamped to each page's capacity) and forms the pages' row offsets
//     and first (page, tile) items with two block scans; block 0 writes
//     the total to num_rows. The counts are never read on the host.
//   * a persistent grid of at most a small multiple of the SMs (the host
//     caps it by the most items the capacities allow): blocks walk the
//     (page, tile) items of the live rows by grid stride, so padding
//     launches no block (an exchange receive of 8 slices of 2,097,152
//     rows with 161,549 live rows has about 80 items, where a grid over
//     the capacities had 8,192 blocks). Within an item the threads take
//     its (column, row) pairs column by column: coalesced rows, and a
//     short item (q1's 4-row pages) copies every column at once.
//   * the pointer table travels by value in a parameter block of 256 or
//     TABLE_MAX words, the smaller one when the call fits it.
// A page whose validity is absent while another page's is present has a
// null source and writes "valid" bytes. K32: a list plane [cap, L] moves
// as rows of element size x L bytes; a page whose plane is narrower than
// the output's (a smaller L) writes zeros past its row.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int TILE = 2048;  // rows of one (page, tile) item

template <int W>
struct Words {
  int64_t v[W];
};

// Table layout (int64 words): count ptrs (npages), capacities (npages),
// src ptrs (npages * ncols, 0 = all-valid bytes), dst ptrs (ncols), dst
// row sizes in bytes (ncols), then, when with_srb, src row sizes in bytes
// (npages * ncols, at most the dst's). npages <= W / 2.
template <int W>
__global__ void __launch_bounds__(THREADS)
    concat_kernel(const __grid_constant__ Words<W> tbl, int npages,
                  int ncols, int with_srb, int32_t* __restrict__ total) {
  constexpr int MAXP = W / 2;
  __shared__ int64_t row_off[MAXP + 1];   // first output row of page p
  __shared__ int64_t item_off[MAXP + 1];  // first (page, tile) item of p
  __shared__ int64_t warp_sums[32];
  const int64_t* t = tbl.v;
  const int64_t* counts = t;
  const int64_t* caps = t + npages;
  const int64_t* srcs = t + 2 * npages;
  const int64_t* dsts = srcs + (int64_t)npages * ncols;
  const int64_t* drb = dsts + ncols;
  const int64_t* srb = drb + ncols;

  int64_t rows = 0, items = 0;
  for (int base = 0; base < npages; base += THREADS) {
    const int p = base + threadIdx.x;
    int64_t c = 0;
    if (p < npages) {
      c = *reinterpret_cast<const int32_t*>(counts[p]);
      c = c < 0 ? 0 : (c > caps[p] ? caps[p] : c);
    }
    int64_t sum_rows, sum_items;
    const int64_t r = block_exclusive_scan<int64_t>(c, warp_sums, &sum_rows);
    const int64_t it = block_exclusive_scan<int64_t>((c + TILE - 1) / TILE,
                                                     warp_sums, &sum_items);
    if (p < npages) {
      row_off[p] = rows + r;
      item_off[p] = items + it;
    }
    rows += sum_rows;
    items += sum_items;
  }
  if (threadIdx.x == 0) {
    row_off[npages] = rows;
    item_off[npages] = items;
    if (blockIdx.x == 0) *total = (int32_t)rows;
  }
  __syncthreads();

  int p = 0;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    while (item_off[p + 1] <= item) ++p;
    const int64_t r0 = (item - item_off[p]) * TILE;
    const int64_t live = row_off[p + 1] - row_off[p];
    const int n = (int)((r0 + TILE < live ? r0 + TILE : live) - r0);
    const int64_t off = row_off[p] + r0;
    // the item's (column, row) pairs, column by column: consecutive
    // threads copy consecutive rows of one column, and a short item
    // copies all its columns at once
    for (int f = threadIdx.x; f < n * ncols; f += THREADS) {
      const int c = f / n;
      const int r = f - c * n;
      const int64_t k = (int64_t)p * ncols + c;
      const void* src = reinterpret_cast<const void*>(srcs[k]);
      void* dst = reinterpret_cast<void*>(dsts[c]);
      const int64_t d = drb[c];
      if (src == nullptr)
        static_cast<uint8_t*>(dst)[off + r] = 1;
      else
        copy_row_padded(src, r0 + r, with_srb ? srb[k] : d, dst, off + r, d);
    }
  }
}

template <int W>
int launch(const void* table, int64_t len, int npages, int ncols,
           int with_srb, void* total, int grid, cudaStream_t s) {
  thread_local static Words<W> t;  // each launch copies it as a parameter
  const int64_t* src = static_cast<const int64_t*>(table);
  for (int64_t i = 0; i < len; ++i) t.v[i] = src[i];
  concat_kernel<W><<<grid, THREADS, 0, s>>>(t, npages, ncols, with_srb,
                                            static_cast<int32_t*>(total));
  return (int)cudaGetLastError();
}
}  // namespace

// table: the int64 host array above, of `len` words; total: int32; grid:
// the number of blocks (at least 1). Returns cudaGetLastError(), or -1
// when the table exceeds TABLE_MAX words or npages exceeds TABLE_MAX / 2.
TT_EXPORT int concat_rows(int64_t npages, int64_t ncols, int64_t with_srb,
                          const void* table, int64_t len, void* total,
                          int64_t grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1) grid = 1;
  if (len <= 256 && npages <= 128)
    return launch<256>(table, len, (int)npages, (int)ncols,
                       (int)(with_srb != 0), total, (int)grid, s);
  if (len <= TABLE_MAX && npages <= TABLE_MAX / 2)
    return launch<TABLE_MAX>(table, len, (int)npages, (int)ncols,
                             (int)(with_srb != 0), total, (int)grid, s);
  return -1;
}
