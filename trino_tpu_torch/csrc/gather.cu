// K7: row gather of a page at one index vector.
//
// Replaces trino_tpu/page.py Column.gather / Page.gather (a jnp.take with
// mode="clip" per column: the sort/TopN permutation, OFFSET) and
// trino_tpu/ops/join.py attach_build (the build columns a join emits,
// gathered at the matched build rows).
//
// Bound on this card: bytes — the index vector read once, and for each of
// the N arrays one element read and one written per index. The reference
// runs one take per column; here every array of the page (values and
// validity, element sizes 1, 2, 4 or 8 bytes; K32: a [cap, L] list plane as
// rows of element size x L bytes) travels in one pointer table and one
// launch, so the index is read once for all of them. A thread owns
// one output row: the writes of a warp are contiguous in every array and
// the reads land wherever the index points (random for a join, a
// permutation for a sort). Indices clip to [0, src_cap - 1], as mode="clip"
// does.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;

__global__ void gather_kernel(const int64_t* __restrict__ idx, int64_t n,
                              int64_t src_cap, int64_t ncols,
                              const __grid_constant__ Table tbl) {
  const int64_t* src = tbl.v;
  const int64_t* dst = tbl.v + ncols;
  const int64_t* rb = tbl.v + 2 * ncols;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t j = idx[i];
    j = j < 0 ? 0 : (j >= src_cap ? src_cap - 1 : j);
    for (int64_t c = 0; c < ncols; ++c)
      copy_elem(reinterpret_cast<const void*>(src[c]), j,
                reinterpret_cast<void*>(dst[c]), i, rb[c]);
  }
}
}  // namespace

// idx: int64[n] (device); src_cap >= 1: rows of every source array;
// table: int64 HOST array [src ptrs (ncols), dst ptrs (ncols), row sizes
// in bytes (ncols)], each dst holding n rows. Returns cudaGetLastError(),
// or -1 when the table exceeds TABLE_MAX.
TT_EXPORT int gather_rows(const void* idx, int64_t n, int64_t src_cap,
                          int64_t ncols, const void* table, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table t;  // each launch copies it as a parameter
  if (load_table(table, 3 * ncols, &t)) return -1;
  if (n > 0 && ncols > 0) {
    int64_t blocks = (n + THREADS - 1) / THREADS;
    blocks = blocks > 4224 ? 4224 : blocks;  // 32 blocks per SM, grid-stride
    gather_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const int64_t*>(idx), n, src_cap, ncols, t);
  }
  return (int)cudaGetLastError();
}
