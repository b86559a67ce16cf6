// Shared helpers of the package's CUDA kernels (plain C interface, no
// PyTorch headers: each .cu builds with nvcc alone in seconds).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

// Pointer and size tables travel by value as a kernel parameter (CUDA 12.1+
// accepts 32,764 bytes of parameters): a host-to-device copy of the table
// would make every launch wait for the stream, and pinning a staging buffer
// per launch costs more host time than the kernels themselves. Kernels take
// it as `const __grid_constant__ Table`, so indexing reads parameter space
// in place.
constexpr int TABLE_MAX = 2048;
struct Table {
  int64_t v[TABLE_MAX];
};

// Fill `t` from a host array; non-zero when it does not fit.
inline int load_table(const void* host, int64_t len, Table* t) {
  if (len < 0 || len > TABLE_MAX) return 1;
  const int64_t* src = static_cast<const int64_t*>(host);
  for (int64_t i = 0; i < len; ++i) t->v[i] = src[i];
  return 0;
}

// Copy one element of `esz` bytes (1, 2, 4 or 8).
__device__ __forceinline__ void copy_elem(const void* src, int64_t si,
                                          void* dst, int64_t di, int esz) {
  switch (esz) {
    case 8: static_cast<uint64_t*>(dst)[di] =
        static_cast<const uint64_t*>(src)[si]; break;
    case 4: static_cast<uint32_t*>(dst)[di] =
        static_cast<const uint32_t*>(src)[si]; break;
    case 2: static_cast<uint16_t*>(dst)[di] =
        static_cast<const uint16_t*>(src)[si]; break;
    default: static_cast<uint8_t*>(dst)[di] =
        static_cast<const uint8_t*>(src)[si]; break;
  }
}

// Exclusive prefix sum of one int per thread across a block whose size is
// a multiple of 32 (at most 1024). `warp_sums` holds 32 ints of shared
// memory. Returns the thread's exclusive prefix; *total gets the block sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive prefix of warp totals
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums may be reused by the caller's next round
  return before + x - v;
}
