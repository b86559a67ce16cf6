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
// log2(n) times, so the design is the bandwidth-optimal three passes of
// csrc/tile.cuh:
//   1. tile_count_kernel      — one count of selected rows per 4096-row
//                               tile (reads only the mask);
//   2. tile_scan_kernel       — one block turns the tile counts into
//                               exclusive offsets and writes the total to
//                               the device-side num_rows (no host sync);
//   3. compact_scatter_kernel — each tile re-derives its in-tile ranks
//                               with a block scan and copies every column
//                               of every selected row to offset + rank, so
//                               order is stable. Columns travel through one
//                               pointer table (row sizes in bytes: 1, 2, 4
//                               or 8 for a column, element size x L for a
//                               list plane, K32) in one launch.
//
// Range mode replaces trino_tpu/ops/join.py range_prefilter, the join's
// dynamic filter: a row is kept when its key lies in [lo, hi] of the build
// side and is not NULL. The reference builds that mask elementwise and then
// runs Page.filter; here the same three passes evaluate it in place of the
// mask read, so the keep flag never goes through device memory. lo and hi
// stay on the device (no host read).
#include "tile.cuh"

namespace {
// Which rows a launch keeps: the live rows (i < *num_rows) with mask[i] in
// mask mode (mask non-null), else with key[i] in [lo, hi] and valid (range
// mode, the key's own type).
struct Keep {
  const uint8_t* mask;
  const void* key;
  const uint8_t* key_valid;
  const void* lo;
  const void* hi;
  int esz;
  int is_float;
  const int32_t* num_rows;
  int64_t cap;

  __device__ __forceinline__ int64_t limit() const {
    const int64_t n = *num_rows;
    return n < 0 ? 0 : (n > cap ? cap : n);
  }

  __device__ __forceinline__ bool operator()(int64_t i) const {
    if (mask != nullptr) return mask[i] != 0;
    if (key_valid != nullptr && !key_valid[i]) return false;
    if (is_float) {
      const double v = load_float(key, i, esz);
      return v >= load_float(lo, 0, esz) && v <= load_float(hi, 0, esz);
    }
    const int64_t v = load_int(key, i, esz);
    return v >= load_int(lo, 0, esz) && v <= load_int(hi, 0, esz);
  }
};

// Copies every column of each kept row of this block's tile to its
// output row; columns travel through one pointer table (src ptrs, dst
// ptrs, row sizes in bytes).
__global__ void compact_scatter_kernel(const Keep keep,
                                       const int64_t* __restrict__ offsets,
                                       int64_t ncols,
                                       const __grid_constant__ Table tbl) {
  const int64_t n = keep.limit();
  if ((int64_t)blockIdx.x * TILE >= n) return;  // uniform across the block
  const int64_t* src = tbl.v;
  const int64_t* dst = tbl.v + ncols;
  const int64_t* rb = tbl.v + 2 * ncols;
  tile_scatter(keep, n, offsets, [&](int64_t i, int64_t pos) {
    for (int64_t c = 0; c < ncols; ++c)
      copy_elem(reinterpret_cast<const void*>(src[c]), i,
                reinterpret_cast<void*>(dst[c]), pos, rb[c]);
  });
}

int launch(Keep keep, const void* num_rows, int64_t cap, int64_t ncols,
           const void* table, void* scratch, void* count_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, 3 * ncols, &t)) return -1;
  keep.num_rows = static_cast<const int32_t*>(num_rows);
  keep.cap = cap;
  auto* offsets = static_cast<int64_t*>(scratch);
  const int64_t nblocks = tile_offsets(
      keep, cap, offsets, static_cast<int32_t*>(count_out), s);
  if (ncols > 0)
    compact_scatter_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
        keep, offsets, ncols, t);
  return (int)cudaGetLastError();
}
}  // namespace

// mask: uint8[cap]; num_rows: int32 scalar (device); table: int64 HOST
// array [src ptrs (ncols), dst ptrs (ncols), row sizes in bytes (ncols)];
// scratch: int64[ceil(cap / 4096)]; count_out: int32 scalar (device).
// Returns cudaGetLastError(), or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int compact_rows(const void* mask, const void* num_rows,
                           int64_t cap, int64_t ncols, const void* table,
                           void* scratch, void* count_out, void* stream) {
  Keep keep{static_cast<const uint8_t*>(mask), nullptr, nullptr, nullptr,
            nullptr, 1, 0, nullptr, 0};
  return launch(keep, num_rows, cap, ncols, table, scratch, count_out,
                stream);
}

// Range mode: key: [cap] elements of `esz` bytes (is_float: float32 or
// float64); key_valid: uint8[cap] or null; lo, hi: one element each of the
// key's type (device). The rest as compact_rows.
TT_EXPORT int compact_rows_range(const void* key, const void* key_valid,
                                 int64_t esz, int64_t is_float,
                                 const void* lo, const void* hi,
                                 const void* num_rows, int64_t cap,
                                 int64_t ncols, const void* table,
                                 void* scratch, void* count_out,
                                 void* stream) {
  Keep keep{nullptr, key, static_cast<const uint8_t*>(key_valid), lo, hi,
            (int)esz, (int)is_float, nullptr, 0};
  return launch(keep, num_rows, cap, ncols, table, scratch, count_out,
                stream);
}
