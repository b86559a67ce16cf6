// The launch floor: empty kernels that measure what one launch through the
// package's ctypes binding costs the host, with a parameter block of a few
// words and with a by-value pointer table of 256 words or of common.cuh's
// TABLE_MAX words (16 KB), and one launched cooperatively (K5's dense mode
// launches so). They replace no TPU kernel and do no work;
// `python3 -m trino_tpu_torch.launch_trace` and chip_smoke.py's phase 4
// time them beside K2 and K4 as the yardstick of a launch-bound call.
#include "common.cuh"

namespace {
template <int N>
struct Words {
  int64_t v[N];
};

__global__ void empty_small(int64_t a, int64_t b, void* c) {}

template <int N>
__global__ void empty_table(const __grid_constant__ Words<N> t) {}

template <int N>
int launch_table(const int64_t* src, cudaStream_t s) {
  thread_local static Words<N> t;  // filled as the launchers fill theirs
  for (int i = 0; i < N; ++i) t.v[i] = src[i];
  empty_table<N><<<1, 32, 0, s>>>(t);
  return (int)cudaGetLastError();
}
}  // namespace

TT_EXPORT int launch_floor_small(void* stream) {
  empty_small<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(0, 0, nullptr);
  return (int)cudaGetLastError();
}

// the small kernel as one cooperative launch of one block
TT_EXPORT int launch_floor_coop(void* stream) {
  int64_t a = 0, b = 0;
  void* c = nullptr;
  void* args[] = {&a, &b, &c};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(empty_small), dim3(1), dim3(32), args, 0,
      static_cast<cudaStream_t>(stream));
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}

// words: 256 or TABLE_MAX int64 of `host` become the launch's parameters
TT_EXPORT int launch_floor_table(const void* host, int64_t words,
                                 void* stream) {
  const int64_t* src = static_cast<const int64_t*>(host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words == 256) return launch_table<256>(src, s);
  if (words == TABLE_MAX) return launch_table<TABLE_MAX>(src, s);
  return -1;
}
