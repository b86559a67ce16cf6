// K33 and K34: the list layouts' kernels (ARRAY and MAP).
//
// K33 (collect_*) replaces trino_tpu/ops/aggregate.py group_max_size and
// _collect_grouped: array_agg, histogram and map_agg per group, packed
// into a list column (values [rows, L] + lengths, a MAP's values in an aux
// plane [rows, L]). Every launch reads the row -> group map of K8's
// group-id mode (K28, csrc/group_agg.cu), so a group's list lands on K8's
// output row. A row takes part when it is live (below num_rows) and every
// mask holds (the argument's validity, a second argument's, FILTER); the
// reference skips NULL inputs the same way. Three modes:
// * size: each group's live row count by atomics, and its maximum and
//   the group count in one two-number output (one fetch sizes the
//   aggregation's L and list rows);
// * array (array_agg): the reference ranks each eligible row among its
//   group's eligible rows in row order through its sort. Here the words
//   launch packs (group, not eligible) into K10's order-preserving word,
//   K10 sorts the live prefix stably (an atomic slot counter would
//   scramble the order), the bounds launch finds each group's first and
//   one-past-last eligible sorted position, and the pack launch writes
//   each eligible row's value at (group, position - first) while that is
//   below L; lengths = min(count, L);
// * map (histogram, map_agg): the words add the key's order key (NaN as
//   +inf, -0.0 as +0.0: the reference's _nan_as_largest and its `!=`,
//   under which +-0.0 are one key), K10 sorts by (group, not eligible,
//   key) stably, a run of equal keys is one entry, and a tiled count,
//   scan and scatter (csrc/tile.cuh) gives each run its index; the pack
//   launch writes the run's key (its first row's value, NaN as +inf, the
//   sign of a zero kept) at (group, run index - the group's first run
//   index), with histogram's count (run length) or map_agg's value of the
//   run's first row in the aux plane.
// Planes are zeroed past each list, as the reference's are.
//
// K34 (unnest_*) replaces trino_tpu/exec/local_planner.py _exec_UnnestNode's
// count and expand ops. Count: the live, non-NULL rows' lengths summed by
// the tiled count and scan (one number, fetched once per page to size the
// output at the next power of two). Expand: the same scan gives each row
// its exclusive offset, and each row writes its own range of output
// slots: source row, ordinal (1-based) and element (and the MAP value).
// The reference searchsorts each output slot into the offsets instead;
// the output is the same.
//
// Bound on this card: bytes. K33 reads the group ids, masks and the
// argument once per pass and writes each list once; K10's passes are
// K10's. K34 reads the lengths twice (count, expand) and the live
// elements once, and writes 4 + 8 + the element bytes per output slot.
#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int MAX_MASKS = 6;
constexpr uint64_t SIGN = 0x8000000000000000ULL;

struct Masks {
  const uint8_t* m[MAX_MASKS];
  int count;
};

__device__ __forceinline__ bool passes(const Masks& mk, int64_t i) {
  for (int q = 0; q < mk.count; ++q)
    if (!mk.m[q][i]) return false;
  return true;
}

__device__ __forceinline__ int64_t clamp_rows(const int32_t* n_ptr,
                                              int64_t cap) {
  const int64_t n = *n_ptr;
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// The order key of an element: an integer as itself, a float (NaN as
// +inf, -0.0 as +0.0) through ordered_key.
__device__ __forceinline__ long long elem_key(const void* p, int64_t i,
                                              int esz, int is_float) {
  if (!is_float) return (long long)load_int(p, i, esz);
  double x = load_float(p, i, esz);
  if (x != x) x = __longlong_as_double(0x7FF0000000000000LL);
  if (x == 0.0) x = 0.0;
  return ordered_key(x);
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 2112 ? 2112 : blocks));
}

int masks_from(const void* host, int64_t count, Masks* mk) {
  if (count < 0 || count > MAX_MASKS) return 1;
  const int64_t* ptrs = static_cast<const int64_t*>(host);
  mk->count = (int)count;
  for (int q = 0; q < MAX_MASKS; ++q)
    mk->m[q] = q < count ? reinterpret_cast<const uint8_t*>(ptrs[q])
                         : nullptr;
  return 0;
}

// ------------------------------------------------------------ size mode

__global__ void sizes_kernel(const int32_t* gid, int64_t cap,
                             const int32_t* num_rows,
                             const int32_t* num_groups, int32_t* counts,
                             unsigned long long* out) {
  const int64_t n = clamp_rows(num_rows, cap);
  const int64_t G = *num_groups;
  int best = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = gid[i];
    if (g >= 0 && g < G) {
      const int c = atomicAdd(&counts[g], 1) + 1;
      best = c > best ? c : best;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, best, o);
    best = y > best ? y : best;
  }
  if ((threadIdx.x & 31) == 0 && best > 0)
    atomicMax(&out[0], (unsigned long long)best);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[1] = (unsigned long long)(G < 0 ? 0 : G);
}

// ------------------------------------------------- array and map modes

// words[0][i] = ((group << 32) | (not eligible << 31)) ^ SIGN; in map mode
// words[1][i] = the key's order key (0 for a row that takes no part).
__global__ void words_kernel(int with_key, const void* x, int esz,
                             int is_float, int64_t cap,
                             const int32_t* num_rows, const Masks mk,
                             const int32_t* gid, long long* words) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool elig = passes(mk, i);
    const uint64_t w0 = ((uint64_t)(uint32_t)gid[i] << 32) |
                        ((uint64_t)(elig ? 0 : 1) << 31);
    words[i] = (long long)(w0 ^ SIGN);
    if (with_key)
      words[cap + i] = elig ? elem_key(x, i, esz, is_float) : 0;
  }
}

__global__ void fill_kernel(long long* p, const int32_t* num_groups,
                            long long v) {
  const int64_t G = *num_groups;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x)
    p[g] = v;
}

// Over the sorted positions: start[g] and endp[g], the first and one past
// the last sorted position of the group's eligible rows (they lead the
// group: the not-eligible flag sorts after them).
__global__ void bounds_kernel(const int32_t* perm, int64_t cap,
                              const int32_t* num_rows, const Masks mk,
                              const int32_t* gid, long long* start,
                              long long* endp) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = perm[i];
    if (!passes(mk, r)) continue;
    const int32_t g = gid[r];
    if (i == 0 || gid[perm[i - 1]] != g) start[g] = i;
    if (i + 1 == n || gid[perm[i + 1]] != g || !passes(mk, perm[i + 1]))
      endp[g] = i + 1;
  }
}

__global__ void array_pack_kernel(const int32_t* perm, int64_t cap,
                                  const int32_t* num_rows, const Masks mk,
                                  const int32_t* gid, const long long* start,
                                  const void* x, int esz, int64_t L,
                                  void* plane) {
  const int64_t n = clamp_rows(num_rows, cap);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = perm[i];
    if (!passes(mk, r)) continue;
    const int64_t g = gid[r];
    const int64_t ord = i - start[g];
    if (ord < L) copy_elem(x, r, plane, g * L + ord, esz);
  }
}

__global__ void lengths_kernel(const int32_t* num_groups,
                               const long long* start, const long long* endp,
                               int64_t L, int32_t* lengths) {
  const int64_t G = *num_groups;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    const long long c = endp[g] - start[g];
    lengths[g] = (int32_t)(c < L ? c : L);
  }
}

// Map mode: a sorted position starts a run when it is eligible and is its
// group's first eligible position or its key differs from the previous
// position's.
struct RunStart {
  const int32_t* perm;
  const int32_t* gid;
  const long long* keys;   // words[1]
  const long long* start;
  Masks mk;
  const int32_t* num_rows;
  int64_t cap;

  __device__ __forceinline__ int64_t limit() const {
    return clamp_rows(num_rows, cap);
  }

  __device__ __forceinline__ bool operator()(int64_t i) const {
    const int64_t r = perm[i];
    if (!passes(mk, r)) return false;
    return i == start[gid[r]] || keys[perm[i - 1]] != keys[r];
  }
};

// run_pos[k] = the sorted position of run k; first_run[g] = the index of
// the group's first run.
__global__ void runs_scatter_kernel(const RunStart keep,
                                    const int64_t* __restrict__ offsets,
                                    long long* run_pos,
                                    long long* first_run) {
  const int64_t n = keep.limit();
  if ((int64_t)blockIdx.x * TILE >= n) return;  // uniform across the block
  tile_scatter(keep, n, offsets, [&](int64_t i, int64_t pos) {
    run_pos[pos] = i;
    const int32_t g = keep.gid[keep.perm[i]];
    if (i == keep.start[g]) first_run[g] = pos;
  });
}

// The run's key (its first row's value; NaN as +inf, a zero's sign kept).
__device__ __forceinline__ void write_key(const void* x, int64_t r, int esz,
                                          int is_float, void* out,
                                          int64_t o) {
  if (is_float && esz == 8) {
    double v = static_cast<const double*>(x)[r];
    static_cast<double*>(out)[o] =
        v != v ? __longlong_as_double(0x7FF0000000000000LL) : v;
  } else if (is_float) {
    float v = static_cast<const float*>(x)[r];
    static_cast<float*>(out)[o] = v != v ? __int_as_float(0x7F800000) : v;
  } else {
    copy_elem(x, r, out, o, esz);
  }
}

__global__ void map_pack_kernel(const int32_t* perm, const int32_t* gid,
                                const long long* run_pos,
                                const int32_t* nruns, int64_t cap,
                                const long long* first_run,
                                const long long* endp, int64_t L,
                                const void* x, int esz, int is_float,
                                const void* x2, int esz2, void* keys_plane,
                                void* aux_plane, int32_t* lengths) {
  const int64_t R = clamp_rows(nruns, cap);
  for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k < R;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = run_pos[k];
    const int64_t r = perm[i];
    const int64_t g = gid[r];
    const int64_t ord = k - first_run[g];
    const bool last = k + 1 == R || gid[perm[run_pos[k + 1]]] != g;
    const int64_t end = last ? endp[g] : run_pos[k + 1];
    if (ord < L) {
      const int64_t o = g * L + ord;
      write_key(x, r, esz, is_float, keys_plane, o);
      if (x2 == nullptr)
        static_cast<long long*>(aux_plane)[o] = end - i;   // histogram
      else
        copy_elem(x2, r, aux_plane, o, esz2);               // map_agg
    }
    if (last) lengths[g] = (int32_t)(ord + 1 < L ? ord + 1 : L);
  }
}

// ----------------------------------------------------------------- K34

// A row's output slots: its length when live and not NULL.
struct Slots {
  const int32_t* lengths;
  const uint8_t* valid;
  const int32_t* num_rows;
  int64_t cap;

  __device__ __forceinline__ int64_t limit() const {
    return clamp_rows(num_rows, cap);
  }

  __device__ __forceinline__ int operator()(int64_t i) const {
    if (valid != nullptr && !valid[i]) return 0;
    const int l = lengths[i];
    return l > 0 ? l : 0;
  }
};

__global__ void unnest_scatter_kernel(const Slots keep,
                                      const int64_t* __restrict__ offsets,
                                      int64_t out_cap, int64_t L,
                                      const void* plane, int esz,
                                      const void* aux, int aux_esz,
                                      int32_t* src_row, long long* ordinal,
                                      void* elem, void* aux_out) {
  const int64_t n = keep.limit();
  if ((int64_t)blockIdx.x * TILE >= n) return;  // uniform across the block
  tile_scatter(keep, n, offsets, [&](int64_t i, int64_t pos) {
    const int len = keep(i);
    for (int k = 0; k < len && pos + k < out_cap; ++k) {
      const int64_t o = pos + k;
      src_row[o] = (int32_t)i;
      if (ordinal != nullptr) ordinal[o] = k + 1;
      copy_elem(plane, i * L + k, elem, o, esz);
      if (aux != nullptr) copy_elem(aux, i * L + k, aux_out, o, aux_esz);
    }
  });
}
}  // namespace

// K33 size mode. gid: int32 [cap] (K28); num_rows, num_groups: int32
// scalars (device); counts: int32 [cap + 1] scratch; out: int64 [2] =
// (largest live group, groups).
TT_EXPORT int collect_sizes(const void* gid, int64_t cap,
                            const void* num_rows, const void* num_groups,
                            void* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, (size_t)(cap + 1) * 4, s);
  cudaMemsetAsync(out, 0, 16, s);
  sizes_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      static_cast<const int32_t*>(gid), cap,
      static_cast<const int32_t*>(num_rows),
      static_cast<const int32_t*>(num_groups),
      static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// K33 words launch (array mode: with_key 0, words int64 [cap]; map mode:
// with_key 1, words int64 [2, cap]). x: [cap] column of esz bytes;
// masks: host array of nmasks uint8 [cap] pointers.
TT_EXPORT int collect_words(int64_t with_key, const void* x, int64_t esz,
                            int64_t is_float, int64_t cap,
                            const void* num_rows, const void* masks,
                            int64_t nmasks, const void* gid, void* words,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(masks, nmasks, &mk)) return -1;
  if (cap > 0)
    words_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        (int)with_key, x, (int)esz, (int)is_float, cap,
        static_cast<const int32_t*>(num_rows), mk,
        static_cast<const int32_t*>(gid), static_cast<long long*>(words));
  return (int)cudaGetLastError();
}

// K33 array-mode pack over K10's permutation perm (int32 [cap]): plane
// [rows, L] of esz bytes and lengths int32 [rows] (rows >= groups), both
// zeroed first; scratch int64 [2 * rows] (start, endp).
TT_EXPORT int collect_array(const void* perm, int64_t cap,
                            const void* num_rows, const void* masks,
                            int64_t nmasks, const void* gid,
                            const void* num_groups, const void* x,
                            int64_t esz, int64_t L, int64_t rows,
                            void* scratch, void* plane, void* lengths,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(masks, nmasks, &mk) || L < 1 || rows < 1) return -1;
  cudaMemsetAsync(plane, 0, (size_t)(rows * L * esz), s);
  cudaMemsetAsync(lengths, 0, (size_t)rows * 4, s);
  auto* start = static_cast<long long*>(scratch);
  auto* endp = start + rows;
  const auto* ng = static_cast<const int32_t*>(num_groups);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(start, ng, 0);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(endp, ng, 0);
  const auto* pm = static_cast<const int32_t*>(perm);
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* gd = static_cast<const int32_t*>(gid);
  if (cap > 0) {
    bounds_kernel<<<grid_for(cap), THREADS, 0, s>>>(pm, cap, nr, mk, gd,
                                                    start, endp);
    array_pack_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        pm, cap, nr, mk, gd, start, x, (int)esz, L, plane);
  }
  lengths_kernel<<<grid_for(rows), THREADS, 0, s>>>(
      ng, start, endp, L, static_cast<int32_t*>(lengths));
  return (int)cudaGetLastError();
}

// K33 map-mode pack over K10's permutation of words [2, cap]: x2 null for
// histogram (aux int64 counts), else map_agg's values (esz2 bytes). keys
// [rows, L] of esz bytes, aux [rows, L], lengths int32 [rows], zeroed
// first; scratch int64 [3 * rows + 2 * cap + tiles] (start, endp,
// first_run, run_pos, tile offsets); nruns int32 scalar scratch.
TT_EXPORT int collect_map(const void* perm, const void* words, int64_t cap,
                          const void* num_rows, const void* masks,
                          int64_t nmasks, const void* gid,
                          const void* num_groups, const void* x, int64_t esz,
                          int64_t is_float, const void* x2, int64_t esz2,
                          int64_t L, int64_t rows, void* scratch,
                          void* nruns, void* keys, void* aux, void* lengths,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Masks mk;
  if (masks_from(masks, nmasks, &mk) || L < 1 || rows < 1) return -1;
  const int64_t aux_esz = x2 == nullptr ? 8 : esz2;
  cudaMemsetAsync(keys, 0, (size_t)(rows * L * esz), s);
  cudaMemsetAsync(aux, 0, (size_t)(rows * L * aux_esz), s);
  cudaMemsetAsync(lengths, 0, (size_t)rows * 4, s);
  auto* start = static_cast<long long*>(scratch);
  auto* endp = start + rows;
  auto* first_run = endp + rows;
  auto* run_pos = first_run + rows;
  auto* offsets = reinterpret_cast<int64_t*>(run_pos + cap);
  const auto* ng = static_cast<const int32_t*>(num_groups);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(start, ng, 0);
  fill_kernel<<<grid_for(rows), THREADS, 0, s>>>(endp, ng, 0);
  const auto* pm = static_cast<const int32_t*>(perm);
  const auto* nr = static_cast<const int32_t*>(num_rows);
  const auto* gd = static_cast<const int32_t*>(gid);
  if (cap > 0)
    bounds_kernel<<<grid_for(cap), THREADS, 0, s>>>(pm, cap, nr, mk, gd,
                                                    start, endp);
  RunStart keep{pm, gd, static_cast<const long long*>(words) + cap, start,
                mk, nr, cap};
  auto* nrun = static_cast<int32_t*>(nruns);
  const int64_t nblocks = tile_offsets(keep, cap, offsets, nrun, s);
  runs_scatter_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
      keep, offsets, run_pos, first_run);
  map_pack_kernel<<<grid_for(cap), THREADS, 0, s>>>(
      pm, gd, run_pos, nrun, cap, first_run, endp, L, x, (int)esz,
      (int)is_float, x2, (int)esz2, keys, aux,
      static_cast<int32_t*>(lengths));
  return (int)cudaGetLastError();
}

// K34 count: total (int32 scalar, device) = the live non-NULL rows'
// lengths; scratch int64 [tiles].
TT_EXPORT int unnest_count(const void* lengths, const void* valid,
                           const void* num_rows, int64_t cap, void* scratch,
                           void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Slots keep{static_cast<const int32_t*>(lengths),
             static_cast<const uint8_t*>(valid),
             static_cast<const int32_t*>(num_rows), cap};
  tile_offsets(keep, cap, static_cast<int64_t*>(scratch),
               static_cast<int32_t*>(total), s);
  return (int)cudaGetLastError();
}

// K34 expand: plane [cap, L] of esz bytes (aux the same shape of aux_esz
// bytes, or null); outputs [out_cap]: src_row int32, ordinal int64 (or
// null), elem, aux_out; total int32 scalar (device) = the slots written
// (at most out_cap are); scratch int64 [tiles].
TT_EXPORT int unnest_expand(const void* lengths, const void* valid,
                            const void* num_rows, int64_t cap, int64_t L,
                            const void* plane, int64_t esz, const void* aux,
                            int64_t aux_esz, int64_t out_cap, void* scratch,
                            void* total, void* src_row, void* ordinal,
                            void* elem, void* aux_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Slots keep{static_cast<const int32_t*>(lengths),
             static_cast<const uint8_t*>(valid),
             static_cast<const int32_t*>(num_rows), cap};
  auto* offsets = static_cast<int64_t*>(scratch);
  const int64_t nblocks = tile_offsets(keep, cap, offsets,
                                       static_cast<int32_t*>(total), s);
  unnest_scatter_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
      keep, offsets, out_cap, L, plane, (int)esz, aux, (int)aux_esz,
      static_cast<int32_t*>(src_row), static_cast<long long*>(ordinal),
      elem, aux_out);
  return (int)cudaGetLastError();
}
