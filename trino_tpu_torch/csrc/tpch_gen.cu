// K14, K15: TPC-H columns generated on the card.
//
// Replaces trino_tpu/connector/tpch_dev.py: _chunk_fn (tpch_gen's
// column_stream / code_stream jitted over one chunk of row indexes) and
// _oidx_fn (lineitem's order index rebuilt on the device). Every column is
// a stateless counter hash of its row index (splitmix64 of (row + 1) *
// golden + a per-column seed), so a chunk needs nothing from the host but
// a few scalars: the seeds, ranges and counts of
// trino_tpu_torch/connector/tpch_gen.py device_recipe, and for lineitem
// the order covering the chunk's first row and that order's first row.
//
//   column_kernel (K14) — one thread per row of [start, start + n): the
//     recipe's formula (a `switch` on the recipe id, uniform over the
//     launch) in native uint64 arithmetic — a uniform draw lo + (u64 %
//     span), the spec formulas (retail price, partsupp's supplier spread,
//     o_custkey's skipped third), lineitem's dates from the order date
//     of the row's order (recomputed per row from the order index: ship =
//     order date + a draw, receipt = ship + a draw, the flags from those)
//     — then, for a pooled string column, the raw pool index mapped
//     through the pool's LUT (clipped, as the reference's take(mode=
//     "clip")). Rows from n to the capacity are written 0, as the host
//     path's padding leaves them.
//   order index (K15) — the per-order line count is itself a hash stream
//     (1 + mix64(order) % 7), so the orders covering a chunk are counted,
//     scanned and scattered with csrc/tile.cuh's three passes (each order
//     weighted by its line count): each order writes its index into its
//     1-7 rows that fall in the chunk.
//
// Bound on this card: bytes — each output row written once (K14 also
// reads the order index, 8 bytes a row, for the six order-correlated
// lineitem columns). The hashing is 64-bit integer work (two 64-bit
// multiplies per draw and a 64-bit modulo), which the card emulates with
// 32-bit multiply-adds, so a column with three draws may run above its
// byte bound.
#include "tile.cuh"

namespace {
constexpr int THREADS = 256;
constexpr uint64_t GOLD = 0x9E3779B97F4A7C15ULL;

// trino_tpu_torch/connector/tpch_gen.py R_* and P_*
enum Recipe {
  ROWKEY = 0, UI, RETAIL, PS_SUPPKEY, CONST, O_CUSTKEY, O_ORDERSTATUS,
  L_ORDERKEY, L_SUPPKEY, L_EXTENDEDPRICE, L_DATE, L_RETURNFLAG,
  L_LINESTATUS
};
enum Param {
  S0 = 0, LO0, SPAN0, MUL, S1, LO1, SPAN1, ARG, OD_S, OD_LO, OD_SPAN,
  CURRENT, COIN, N_PARAMS = 16
};

struct Params {
  int64_t v[N_PARAMS];
};

// tpch_gen._u64: the hash stream of one column at row `idx`.
__device__ __forceinline__ uint64_t stream_u64(int64_t seed, uint64_t idx) {
  return mix64((idx + 1ULL) * GOLD + (uint64_t)seed);
}

// tpch_gen._ui: lo + (u64 % span) as int64 (span > 0).
__device__ __forceinline__ int64_t draw(int64_t seed, int64_t lo,
                                        int64_t span, uint64_t idx) {
  return lo + (int64_t)(stream_u64(seed, idx) % (uint64_t)span);
}

// tpch_gen._retail_price (pk >= 1, so C division is Python's).
__device__ __forceinline__ int64_t retail(int64_t pk) {
  return 90000 + (pk / 10) % 20001 + 100 * (pk % 1000);
}

// tpch_gen._ps_suppkey (positive operands).
__device__ __forceinline__ int64_t ps_supp(int64_t pk, int64_t i,
                                          int64_t nsupp) {
  return (pk + i * (nsupp / 4 + (pk - 1) / nsupp)) % nsupp + 1;
}

__device__ __forceinline__ bool coin(int64_t seed, uint64_t idx) {
  return (stream_u64(seed, idx) & 1ULL) == 0ULL;
}

// One row's value (a raw pool index for a pooled column).
__device__ __forceinline__ int64_t value(int kind, const int64_t* p,
                                         uint64_t idx, int64_t oidx) {
  switch (kind) {
    case ROWKEY:
      return (int64_t)idx / p[ARG] + 1;
    case UI: {
      int64_t v = draw(p[S0], p[LO0], p[SPAN0], idx) * p[MUL];
      if (p[SPAN1]) v += draw(p[S1], p[LO1], p[SPAN1], idx);
      return v;
    }
    case RETAIL:
      return retail((int64_t)idx + 1);
    case PS_SUPPKEY:
      return ps_supp((int64_t)idx / 4 + 1, (int64_t)idx % 4, p[ARG]);
    case CONST:
      return p[ARG];
    case O_CUSTKEY: {
      const int64_t ck = draw(p[S0], p[LO0], p[SPAN0], idx);
      if (ck % 3 != 0) return ck;
      const int64_t r = (ck + 1) % (p[ARG] + 1);
      return r > 1 ? r : 1;
    }
    case O_ORDERSTATUS: {
      const int64_t od = draw(p[OD_S], p[OD_LO], p[OD_SPAN], idx);
      if (od + 151 < p[CURRENT]) return 0;  // F
      return coin(p[COIN], idx) ? 1 : 2;    // O or P
    }
    case L_ORDERKEY:
      return oidx + 1;
    case L_SUPPKEY:
      return ps_supp(draw(p[S0], p[LO0], p[SPAN0], idx),
                     draw(p[S1], p[LO1], p[SPAN1], idx), p[ARG]);
    case L_EXTENDEDPRICE:
      return draw(p[S0], p[LO0], p[SPAN0], idx) *
             retail(draw(p[S1], p[LO1], p[SPAN1], idx));
    default: {  // L_DATE, L_RETURNFLAG, L_LINESTATUS
      // the order's date, then the ship (or commit) date, then receipt
      int64_t d = draw(p[OD_S], p[OD_LO], p[OD_SPAN], (uint64_t)oidx) +
                  draw(p[S0], p[LO0], p[SPAN0], idx);
      if (p[SPAN1]) d += draw(p[S1], p[LO1], p[SPAN1], idx);
      if (kind == L_DATE) return d;
      if (kind == L_LINESTATUS) return d > p[CURRENT] ? 1 : 0;  // O / F
      if (d <= p[CURRENT]) return coin(p[COIN], idx) ? 2 : 0;   // R / A
      return 1;                                                 // N
    }
  }
}

__global__ void column_kernel(int kind, const Params P, int64_t start,
                              int64_t n, int64_t cap,
                              const int64_t* __restrict__ oidx,
                              const int32_t* __restrict__ lut,
                              int64_t lut_len, void* __restrict__ out,
                              int out_esz) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t v = 0;
    if (i < n) {
      v = value(kind, P.v, (uint64_t)(start + i),
                oidx != nullptr ? oidx[i] : 0);
      if (lut != nullptr)
        v = lut[v < 0 ? 0 : (v >= lut_len ? lut_len - 1 : v)];
    }
    if (out_esz == 8)
      static_cast<int64_t*>(out)[i] = v;
    else
      static_cast<int32_t*>(out)[i] = (int32_t)v;
  }
}

// K15's tile weight: order o_first + j has 1 + mix64 % 7 lines.
struct OrderLines {
  int64_t seed;
  int64_t o_first;
  int64_t norders;

  __device__ __forceinline__ int64_t limit() const { return norders; }
  __device__ __forceinline__ int operator()(int64_t j) const {
    return 1 + (int)(stream_u64(seed, (uint64_t)(o_first + j)) % 7ULL);
  }
};

// Each order of the chunk writes its index into its rows in [0, n): its
// first row is rel0 (the first order's first row minus the chunk's start,
// <= 0) plus the lines of the orders before it.
__global__ void order_fill_kernel(const OrderLines ol,
                                  const int64_t* __restrict__ offsets,
                                  int64_t rel0, int64_t n,
                                  int64_t* __restrict__ oidx) {
  tile_scatter(ol, ol.norders, offsets, [&](int64_t j, int64_t pos) {
    const int lines = ol(j);
    for (int r = 0; r < lines; ++r) {
      const int64_t row = rel0 + pos + r;
      if (row >= 0 && row < n) oidx[row] = ol.o_first + j;
    }
  });
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 4224 ? 4224 : blocks));
}
}  // namespace

// K14. params: int64 HOST array of N_PARAMS words (device_recipe); rows
// [start, start + n) into out[cap] (int32 for out_esz 4, int64 for 8; rows
// n..cap written 0); oidx: int64[cap] order index per row, or null; lut:
// int32[lut_len] pool LUT on the device, or null. Returns
// cudaGetLastError().
TT_EXPORT int tpch_column(int64_t kind, const void* params, int64_t start,
                          int64_t n, int64_t cap, const void* oidx,
                          const void* lut, int64_t lut_len, void* out,
                          int64_t out_esz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P;
  const int64_t* src = static_cast<const int64_t*>(params);
  for (int k = 0; k < N_PARAMS; ++k) P.v[k] = src[k];
  if (cap > 0)
    column_kernel<<<grid_for(cap), THREADS, 0, s>>>(
        (int)kind, P, start, n, cap, static_cast<const int64_t*>(oidx),
        static_cast<const int32_t*>(lut), lut_len, out, (int)out_esz);
  return (int)cudaGetLastError();
}

// K15. oidx: int64[cap], the order index of rows [start, start + n) of
// lineitem (rows n..cap 0), from the line-count seed, the order o_first
// covering row `start` and its first row s0; norders: the orders to lay
// out (at most n: each has a line); scratch: int64[ceil(norders / 4096)];
// total: int32 scalar (the lines laid out). Returns cudaGetLastError().
TT_EXPORT int tpch_order_index(int64_t seed, int64_t o_first, int64_t s0,
                               int64_t start, int64_t n, int64_t norders,
                               void* scratch, void* total, int64_t cap,
                               void* oidx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(oidx, 0, cap * sizeof(int64_t), s);
  if (norders > 0) {
    const OrderLines ol{seed, o_first, norders};
    auto* offsets = static_cast<int64_t*>(scratch);
    const int64_t nblocks = tile_offsets(ol, norders, offsets,
                                         static_cast<int32_t*>(total), s);
    order_fill_kernel<<<(unsigned)nblocks, TILE_THREADS, 0, s>>>(
        ol, offsets, s0 - start, n, static_cast<int64_t*>(oidx));
  }
  return (int)cudaGetLastError();
}
