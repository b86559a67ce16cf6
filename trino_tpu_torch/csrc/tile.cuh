#pragma once
#include "common.cuh"

// Tiled stream compaction, shared by K1 (csrc/compact.cu), K8
// (csrc/group_agg.cu) and K34 (csrc/list.cu).
//
// Keeps the chosen rows of [0, n) in order, in three passes over tiles of
// TILE rows and no sort: tile_count_kernel counts each tile's kept rows,
// tile_scan_kernel turns the counts into exclusive offsets (and writes the
// total to the device, no host sync), and the caller's scatter kernel
// calls tile_scatter, which re-derives each kept row's in-tile rank with a
// block scan and hands the body its output position. `Keep` is a by-value
// functor with `int64_t limit() const` (n, read on the device) and
// `operator()(int64_t i) const` for i < n returning a bool (kept or not)
// or an int weight (the row's number of output slots: K34 lays out each
// list's elements this way; a tile's weights sum to at most 2^31 - 1).
constexpr int TILE = 4096;  // trino_tpu_torch/page.py COMPACT_TILE
constexpr int TILE_THREADS = 256;  // threads of a tile's block

template <class Keep>
__global__ void tile_count_kernel(const Keep keep,
                                  int64_t* __restrict__ counts) {
  __shared__ int warp_sums[32];
  const int64_t n = keep.limit();
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int c = 0;
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    const int64_t i = base + r;
    c += i < n ? (int)keep(i) : 0;
  }
  int total;
  block_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One block: counts[] -> exclusive offsets in place, *total_out = the sum
// (an int32 row count, or K9's int64 output total).
template <class Total>
__global__ void tile_scan_kernel(int64_t* __restrict__ counts,
                                 int64_t nblocks,
                                 Total* __restrict__ total_out) {
  __shared__ long long warp_sums[32];
  long long carry = 0;
  for (int64_t start = 0; start < nblocks; start += blockDim.x) {
    const int64_t i = start + threadIdx.x;
    const long long v = i < nblocks ? (long long)counts[i] : 0LL;
    long long total;
    const long long ex = block_exclusive_scan(v, warp_sums, &total);
    if (i < nblocks) counts[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = (Total)carry;
}

// Inside the scatter kernel (one block per tile, every thread of the block
// calling it): body(i, pos) for each kept row i of this block's tile, pos
// being its output row (the first of its slots for a weight), so the
// output keeps the input's order.
template <class Keep, class Body>
__device__ __forceinline__ void tile_scatter(const Keep& keep, int64_t n,
                                             const int64_t* offsets,
                                             Body body) {
  __shared__ int warp_sums[32];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int64_t out = offsets[blockIdx.x];
  for (int r = 0; r < TILE; r += blockDim.x) {
    const int64_t i = base + r + threadIdx.x;
    const int f = i < n ? (int)keep(i) : 0;
    int total;
    const int ex = block_exclusive_scan(f, warp_sums, &total);
    if (f) body(i, out + ex);
    out += total;
  }
}

// Blocks for n rows in tiles (at least one, so the scan always runs).
inline int64_t tile_blocks(int64_t n) {
  return n > 0 ? (n + TILE - 1) / TILE : 1;
}

// Passes 1 and 2 over `cap` candidate rows: scratch (int64[tile_blocks(cap)])
// ends as each tile's output offset and *total_out as the kept rows.
// Returns the number of tiles, the scatter kernel's grid.
template <class Keep>
int64_t tile_offsets(const Keep& keep, int64_t cap, int64_t* scratch,
                     int32_t* total_out, cudaStream_t s) {
  const int64_t nblocks = tile_blocks(cap);
  tile_count_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(keep,
                                                               scratch);
  tile_scan_kernel<<<1, 1024, 0, s>>>(scratch, nblocks, total_out);
  return nblocks;
}

// ------------------------------------------------------------ binned tiles
//
// The same count -> scan -> stable scatter with NBINS bins in place of one
// keep flag: K18's partition moves (csrc/spill_part.cu). `Bin` is a by-value functor
// with `int operator()(int64_t i) const` in [0, NBINS). Counts are laid out
// bin-major (counts[b * ntiles + tile]), so tile_scan_kernel over the whole
// array gives each (bin, tile) its first output row, and a stable scatter
// keeps the input order within a bin.
constexpr int NBINS = 256;

// counts[b * ntiles + blockIdx.x] = rows of this block's tile in bin b;
// rows past n count nowhere.
template <class Bin>
__global__ void tile_bin_count_kernel(const Bin bin, const int32_t* n_ptr,
                                      int64_t cap, int64_t ntiles,
                                      int64_t* __restrict__ counts) {
  __shared__ int hist[NBINS];
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  int64_t n = *n_ptr;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    const int64_t i = base + r;
    if (i < n) atomicAdd(&hist[bin(i)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x)
    counts[(int64_t)b * ntiles + blockIdx.x] = hist[b];
}

// Inside a block (every thread calling it): body(i, pos) for each row i of
// [lo, hi), pos = base[bin(i)] + the rows of that bin before i in [lo, hi),
// so rows of one bin keep their order. `base` (shared, NBINS entries) holds
// each bin's first output row on entry and is advanced past [lo, hi). Rows
// go in rounds of blockDim.x (a multiple of 32, at most 1024): a warp ranks
// its equal bins with __match_any_sync, and per bin an exclusive scan over
// the warps (in warp order) places each warp's run.
template <class Bin, class Body>
__device__ __forceinline__ void block_bin_scatter(const Bin& bin, int64_t lo,
                                                  int64_t hi,
                                                  long long* base,
                                                  Body body) {
  __shared__ int wcount[32 * NBINS];  // [warp][bin] this round
  __shared__ int round_total[NBINS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t start = lo; start < hi; start += blockDim.x) {
    for (int j = threadIdx.x; j < nwarps * NBINS; j += blockDim.x)
      wcount[j] = 0;
    __syncthreads();
    const int64_t i = start + threadIdx.x;
    const bool in = i < hi;
    const int b = in ? bin(i) : 0;
    const unsigned active = __ballot_sync(0xffffffffu, in);
    int rank = 0;
    if (in) {
      const unsigned peers = __match_any_sync(active, b);
      rank = __popc(peers & ((1u << lane) - 1u));
      if (rank == 0) wcount[warp * NBINS + b] = __popc(peers);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < NBINS; d += blockDim.x) {
      int run = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int c = wcount[w * NBINS + d];
        wcount[w * NBINS + d] = run;
        run += c;
      }
      round_total[d] = run;
    }
    __syncthreads();
    if (in) body(i, (int64_t)(base[b] + wcount[warp * NBINS + b] + rank));
    __syncthreads();
    for (int d = threadIdx.x; d < NBINS; d += blockDim.x)
      base[d] += round_total[d];
    __syncthreads();
  }
}
