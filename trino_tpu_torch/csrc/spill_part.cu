// K18: the spill partitioner — a partition id per row, then one stable
// move of every column by partition id.
//
// Replaces trino_tpu/exec/spill.py _canonical_key_hash, partition_by_hash,
// leading_rank, partition_by_range and _partition_sort (:43-:177): a
// per-row u64 hash (or rank), then ONE stable multi-operand lax.sort by
// partition id that carries every column, and a segment_sum of the live
// rows per partition.
//
// Launches of spill_partition:
//   1. pid_kernel — one thread per row: in hash mode the canonical key
//      hash (every NULL of a column hashes to NULL_TAG, a float as its
//      float64 bits with -0.0 folded into +0.0, a bool 0/1), the salt
//      mixed in, pid = h mod npart (unsigned); in range mode the leading
//      key's rank and pid = the count of bounds <= rank. Rows past
//      num_rows take pid npart.
//   2-4. csrc/tile.cuh's binned tiles over the live prefix: a per-tile
//      histogram of pids, one exclusive scan in pid-major order, then a
//      stable scatter of every column's values and validity (rows of one
//      partition keep their order). Rows past num_rows are copied in
//      place, as the reference's stable sort leaves them.
//   5. counts_kernel — each partition's live rows from the scanned
//      offsets.
// spill_rank is the rank mode alone (rank_bounds sorts its output).
//
// Bound on this card: bytes — every moved column read once and written
// once, the key columns read once more for the pid. The design reads the
// key columns in one pass, keeps the pid as int32 (4 bytes a row) and
// moves all columns in the same scatter pass, so a page's columns cross
// the memory once each way after the pid pass.
#include "tile.cuh"

namespace {
constexpr uint64_t SIGN = 0x8000000000000000ULL;
constexpr uint64_t NULL_TAG = 0x9E3779B97F4A7C15ULL;
enum { MODE_HASH = 0, MODE_RANGE = 1 };

__device__ __forceinline__ int64_t live_rows(const int32_t* n_ptr,
                                             int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// Key column k of `keys`: 4 words (values ptr, valid ptr or 0, element
// size, flags: 1 float, 8 bool).
__device__ __forceinline__ bool key_valid(const int64_t* c, int64_t i) {
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  return valid == nullptr || valid[i] != 0;
}

// exec/spill.py _canonical_key_hash's word of one column at row i.
__device__ __forceinline__ uint64_t hash_word(const int64_t* c, int64_t i) {
  const void* vals = reinterpret_cast<const void*>(c[0]);
  const int esz = (int)c[2];
  const int flags = (int)c[3];
  if (!key_valid(c, i)) return NULL_TAG;
  if (flags & 8) return static_cast<const uint8_t*>(vals)[i] != 0 ? 1 : 0;
  if (flags & 1) {
    // x + 0.0 without the arithmetic: -0.0 becomes +0.0, NaN keeps its
    // bits (the CPU's add keeps a quiet NaN's payload)
    const double x = load_float(vals, i, esz);
    return x == 0.0 ? 0ULL : (uint64_t)__double_as_longlong(x);
  }
  return (uint64_t)load_int(vals, i, esz);
}

// exec/spill.py leading_rank at row i.
__device__ __forceinline__ uint64_t rank_of(const int64_t* c, int64_t i,
                                            bool asc, bool nulls_first) {
  if (!key_valid(c, i)) return nulls_first ? 0ULL : ~0ULL;
  const void* vals = reinterpret_cast<const void*>(c[0]);
  const int esz = (int)c[2];
  const int flags = (int)c[3];
  uint64_t u;
  if (flags & 8) {
    u = static_cast<const uint8_t*>(vals)[i] != 0 ? 1 : 0;
  } else if (flags & 1) {
    double x = load_float(vals, i, esz);
    if (x != x) x = __longlong_as_double(0x7FF0000000000000LL);  // +inf
    const uint64_t bits = x == 0.0 ? 0ULL : (uint64_t)__double_as_longlong(x);
    u = (bits >> 63) ? ~bits : (bits | SIGN);
  } else {
    u = (uint64_t)load_int(vals, i, esz) ^ SIGN;
  }
  if (!asc) u = ~u;
  return (u >> 2) + 1;  // the extremes stay free for NULLs
}

__global__ void pid_kernel(const int32_t* __restrict__ n_ptr, int64_t cap,
                           int64_t nkeys, const __grid_constant__ Table keys,
                           int mode, uint64_t salt_mix, int has_salt,
                           int64_t npart, int asc, int nulls_first,
                           const uint64_t* __restrict__ bounds,
                           int64_t nbounds, int32_t* __restrict__ pid) {
  const int64_t n = live_rows(n_ptr, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i >= n) {
      pid[i] = (int32_t)npart;
      continue;
    }
    int64_t p;
    if (mode == MODE_HASH) {
      uint64_t acc = 0;
      for (int64_t k = 0; k < nkeys; ++k)
        acc = mix64(acc ^ mix64(hash_word(keys.v + 4 * k, i)));
      if (has_salt) acc = mix64(acc ^ salt_mix);
      p = (int64_t)(acc % (uint64_t)npart);
    } else {
      const uint64_t r = rank_of(keys.v, i, asc, nulls_first);
      int64_t lo = 0, hi = nbounds;  // upper bound: bounds <= r
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (bounds[mid] <= r) lo = mid + 1;
        else hi = mid;
      }
      p = lo;
    }
    pid[i] = (int32_t)p;
  }
}

__global__ void rank_kernel(int64_t cap, const __grid_constant__ Table keys,
                            int asc, int nulls_first,
                            uint64_t* __restrict__ rank) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x)
    rank[i] = rank_of(keys.v, i, asc, nulls_first);
}

struct PidBin {
  const int32_t* pid;
  __device__ __forceinline__ int operator()(int64_t i) const {
    return pid[i];
  }
};

// `cols`: 3 words per array (source ptr, destination ptr, element size).
__global__ void part_scatter_kernel(const PidBin bin,
                                    const int32_t* __restrict__ n_ptr,
                                    int64_t cap, int64_t ntiles,
                                    const int64_t* __restrict__ offsets,
                                    const __grid_constant__ Table cols,
                                    int64_t ncols) {
  __shared__ long long base[NBINS];
  const int64_t n = live_rows(n_ptr, cap);
  const int64_t lo = (int64_t)blockIdx.x * TILE;
  const int64_t tile_hi = lo + TILE < cap ? lo + TILE : cap;
  // rows past num_rows stay where they are
  for (int64_t i = (lo > n ? lo : n) + threadIdx.x; i < tile_hi;
       i += blockDim.x)
    for (int64_t c = 0; c < ncols; ++c)
      copy_elem(reinterpret_cast<const void*>(cols.v[3 * c]), i,
                reinterpret_cast<void*>(cols.v[3 * c + 1]), i,
                (int)cols.v[3 * c + 2]);
  if (lo >= n) return;  // uniform across the block
  const int64_t hi = lo + TILE < n ? lo + TILE : n;
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x)
    base[b] = offsets[(int64_t)b * ntiles + blockIdx.x];
  __syncthreads();
  block_bin_scatter(bin, lo, hi, base, [&](int64_t i, int64_t pos) {
    for (int64_t c = 0; c < ncols; ++c)
      copy_elem(reinterpret_cast<const void*>(cols.v[3 * c]), i,
                reinterpret_cast<void*>(cols.v[3 * c + 1]), pos,
                (int)cols.v[3 * c + 2]);
  });
}

// counts[p] = the start of bin p + 1 minus the start of bin p; the scan
// wrote the live total after the last bin's offsets.
__global__ void counts_kernel(const int64_t* __restrict__ offsets,
                              int64_t ntiles, int64_t npart,
                              int64_t* __restrict__ counts) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p < npart)
    counts[p] = offsets[(p + 1) * ntiles] - offsets[p * ntiles];
}

int grid_for(int64_t rows, int threads) {
  int64_t blocks = (rows + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > 4224 ? 4224 : blocks);  // grid-stride beyond
}
}  // namespace

// keys: int64 HOST array, 4 words per key column (values ptr, valid ptr
// or 0, element size, flags 1 float / 8 bool); mode 0 hash (salt_mix
// mixed in when has_salt), 1 range (asc, nulls_first of the one key;
// bounds: nbounds u64 words on the device, ascending); cols: int64 HOST
// array, 3 words per moved array (source, destination, element size);
// pid: int32[max(cap, 1)] scratch; hist: int64[256 * ceil(cap / 4096) +
// 1] scratch; counts: int64[npart] out. npart in [1, 255]. Returns
// cudaGetLastError(), or -1 when a table exceeds TABLE_MAX or npart is
// out of range.
TT_EXPORT int spill_partition(const void* keys, int64_t nkeys, int64_t cap,
                              const void* num_rows, int64_t mode,
                              int64_t salt_mix, int64_t has_salt,
                              int64_t asc, int64_t nulls_first,
                              const void* bounds, int64_t nbounds,
                              const void* cols, int64_t ncols, int64_t npart,
                              void* pid, void* hist, void* counts,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table kt, ct;  // each launch copies them
  if (npart < 1 || npart >= NBINS || nkeys < 1 ||
      load_table(keys, 4 * nkeys, &kt) || load_table(cols, 3 * ncols, &ct))
    return -1;
  const auto* n_ptr = static_cast<const int32_t*>(num_rows);
  auto* p = static_cast<int32_t*>(pid);
  auto* offs = static_cast<int64_t*>(hist);
  if (cap > 0)
    pid_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
        n_ptr, cap, nkeys, kt, (int)mode, (uint64_t)salt_mix,
        (int)has_salt, npart, (int)asc, (int)nulls_first,
        static_cast<const uint64_t*>(bounds), nbounds, p);
  const int64_t ntiles = tile_blocks(cap);
  const PidBin bin{p};
  tile_bin_count_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, s>>>(
      bin, n_ptr, cap, ntiles, offs);
  tile_scan_kernel<<<1, 1024, 0, s>>>(offs, NBINS * ntiles,
                                      offs + NBINS * ntiles);
  if (cap > 0)
    part_scatter_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, s>>>(
        bin, n_ptr, cap, ntiles, offs, ct, ncols);
  counts_kernel<<<(unsigned)((npart + 255) / 256), 256, 0, s>>>(
      offs, ntiles, npart, static_cast<int64_t*>(counts));
  return (int)cudaGetLastError();
}

// keys: one key column (4 words, as above); rank: u64[cap] out (every row,
// dead ones included, as the reference's leading_rank). Returns
// cudaGetLastError(), or -1 on a bad table.
TT_EXPORT int spill_rank(const void* keys, int64_t cap, int64_t asc,
                         int64_t nulls_first, void* rank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  thread_local static Table kt;
  if (load_table(keys, 4, &kt)) return -1;
  if (cap > 0)
    rank_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
        cap, kt, (int)asc, (int)nulls_first, static_cast<uint64_t*>(rank));
  return (int)cudaGetLastError();
}
