"""Where the host and device time of a K2, K4, K16, K30 HLL, K36, K27, K5
dense-mode, K6, K35 scatter, K25, K26 or K17 call goes, and the launch
floor.

For each call below it traces 1,000 calls with cProfile and splits each
call's host time over what the wrapper calls directly (the checks and
glue in the wrapper itself, each allocation, the pointer-table build,
the stream lookup, the ctypes call with its launches, a Triton
launcher), beside the call's host enqueue time without the profiler and
its CUDA-event time on an idle stream; for all but K2 and K4 also the
profiler's device time per call of each kernel and the kernels a call
launches:

* K2 (`page.concat_rows_cuda`) at q1 sf1's partial buffer, captured from
  a run of q1 on the card;
* K2 at an exchange receive of 8 slices of 2,097,152 rows and 12 arrays
  (six value columns and their validity), 161,549 live rows;
* K4 (`ops/aggregate.py`'s CUDA wrapper) at q6 sf1's partial, captured
  from a run of q6;
* K16 (`ops/join.py` `spill_prep_cuda`) at the shape of sf1's spilled
  orders build: capacity 2,097,152, 1,500,000 live rows, two int64 key
  columns (TPC-H's sparse order keys and the key mod 1000), no NULL;
* K30's HLL fold (`ops/aggregate.py` `hll_fold_cuda`) at the shape of
  S5's fold: 784,367 (group, bucket) pairs of 10,000 groups in a random
  order (K8 emits groups in hash-slot order) on a pair page of 8,388,608
  rows, nseg the page's capacity; then a ladder
  of group counts with the fold's last-block finalize and with the
  second finalize launch, which is how HLL_LAST_BLOCK_GROUPS was chosen;
* K36's local mode (`parallel/exchange.py` `heavy_local_cuda`) at the
  shape of a D4 sf10 q9 shard's sorted key words: 3,805,999 live words of
  about a million distinct keys (runs of 3.8 on average) on 8,388,608,
  the sentinel after them, at k 8 (the session's default) and k 64;
* K27 (`ops/join_mxu.py`'s CUDA wrapper, or the Triton one of a tree
  that has it) at G3's aggregated page: 16 live rows of 8,388,608, one
  helper, and at nine helpers;
* K5's dense mode (`ops/join.py` `join_dense_cuda`) at q3 sf1's dense
  build: 30,136 live customer keys of 150,000 on a 32,768-row page into
  262,144 slots, and the same build into 1,048,576 slots;
* K6 (`ops/join.py` `unique_probe_cuda`) on the mxu route at the main
  path's K13 call: 150,000 live rows of 262,144 against a 128-slot
  (count, first) table of 25 keyed build rows, and against a 4,096-slot
  table; on the dense route at q3 sf1's first probe: 777,211 live
  customer keys of 1,048,576 against the dense build above (262,144
  slots); and on the search route at q3 sf1's second probe: 3,049,501
  live order keys of 5,242,880, each order's lines together as lineitem
  has them, against K5's hash table of 157,563 build rows (262,144
  capacity), about 1% matching;
* K35's scatter (`parallel/exchange.py` `exchange_scatter_cuda`) at the
  shape of a D4 sf10 q9 shard's lineitem page: 7,503,144 live rows of
  8,388,608 in hash mode over 8 destinations into buckets of 1,048,576,
  seven columns and their validity (14 arrays, 63 bytes a row), the
  state from K35's count pass on the card; beside it the library call
  `argsort(dest, stable=True)` + one `index_select` per array;
* K25 (`ops/join_mxu.py` `agg_lookup_cuda`) at G3's probe: 5,999,956
  live lineitem rows of 8,388,608, an int64 key of 256 values
  (l_orderkey % 256), an int32 value (l_linenumber), a (256, 3) table
  (pair count, sum of the build column, its valid count) and G3's four
  outputs (the pairs, value x pairs, two table columns); beside it the
  library call `index_select` of each live row's table row;
* K26 (`ops/join_mxu.py` `key_bounds_words`, split over its CUDA wrapper,
  or the Triton one of a tree that has it) at G3's build: 1,500,000 live
  int64 keys o_orderkey % 256 of 2,097,152, no NULL; beside it
  `torch.aminmax` of the live keys;
* K17's dense mode (`ops/join.py` `spill_probe`, split over
  `spill_probe_cuda`) at q3 sf1's spill-dense probe: the search probe's
  3,049,501 live lineitem order keys of 5,242,880 against K5's dense row
  table over K16's keys of its 157,563 orders (8,388,608 slots); beside
  it `index_select` of the row table at the live rows' offsets;
* K5's runs mode (`ops/join.py` `join_runs_cuda`) at the shape of sf1's
  largest expanding build: 3,793,276 live lineitem rows (63.2% of the
  lines of 1,500,000 orders, 1 to 7 lines each, TPC-H's sparse order
  keys) on a page of 8,388,608, K5's hash table of 16,777,216 slots, a
  dense table of 2,097,152 slots, max_run 7; and at q13's build (orders
  by o_custkey at sf1: 1,500,000 live rows of 2,097,152, keys drawn as
  TPC-H draws them, from the 100,000 customers whose key is not a
  multiple of 3, so runs of about 15 rows, most of 9 to 32; no dense
  table); beside each `torch.argsort(stable=True)` of the build keys;
* K33's map mode (`ops/lists.py` `collect_map_cuda`) at L3's call
  (`histogram(l_shipmode) ... GROUP BY l_suppkey`: 5,999,956 live rows of
  8,388,608, int32 dictionary codes of 7 values with the dictionary's
  size as the span bound, 10,000 groups, L 1,024, 16,384 list rows) and
  at L4's (`map_agg(ps_partkey, ps_supplycost) GROUP BY ps_suppkey`:
  800,000 live partsupp rows of 1,048,576, int64 part keys, float64
  costs, 10,000 groups, L 128, 16,384 list rows); beside each
  `torch.sort(stable=True)` of (group, key) and one `index_put_`.

The launch floor is an empty kernel (`csrc/floor.cu`) launched through
the package's ctypes binding with a parameter block of three words, of
256 words and of 2,048 words (common.cuh's 16 KB `Table`), the
three-word one also as a cooperative launch (a tree without it skips
it), and an empty `@triton.jit` kernel of 30 arguments: host
microseconds per launch over 1,000 launches, and CUDA-event milliseconds
per launch. Needs the card:

    python3 -m trino_tpu_torch.launch_trace [--calls 1000]
        [--only floor,main,spill,hll,ladder,heavy,post,dense,probe,
                scatter,lookup,bounds,spillprobe,runs,map]
"""

from __future__ import annotations

import argparse
import cProfile
import contextlib
import ctypes
import os
import pstats
import statistics
import time

import torch

from trino_tpu_torch import native

Q1 = ("\nSELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,\n"
      "       sum(l_extendedprice) AS sum_base_price,\n"
      "       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,\n"
      "       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS "
      "sum_charge,\n"
      "       avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS "
      "avg_price,\n"
      "       count(*) AS count_order\nFROM lineitem\n"
      "WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY\n"
      "GROUP BY l_returnflag, l_linestatus\n"
      "ORDER BY l_returnflag, l_linestatus")
Q6 = ("\nSELECT sum(l_extendedprice * l_discount) AS revenue\n"
      "FROM lineitem\nWHERE l_shipdate >= DATE '1994-01-01'\n"
      "  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR\n"
      "  AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01\n"
      "  AND l_quantity < 24")

RECEIVE_SLICES = 8
RECEIVE_CAP = 2_097_152
RECEIVE_LIVE = 161_549
RECEIVE_DTYPES = (torch.int64, torch.int64, torch.float64, torch.int32,
                  torch.int64, torch.float64)
SPILL_CAP = 2_097_152        # sf1's spilled orders build
SPILL_LIVE = 1_500_000
HLL_CAP = 8_388_608          # S5's pair page
HLL_PAIRS = 784_367
HLL_GROUPS = 10_000
HLL_LADDER = (1, 512, 1024, 2048, 3072, 4096, 8192, 65536)
# launches queued by one measured run of calls stay below the device's
# queue, so a host time per call is not a wait for a full queue
QUEUE_LAUNCHES = 900
HEAVY_CAP = 8_388_608        # a D4 sf10 q9 shard's masked key words
HEAVY_LIVE = 3_805_999
HEAVY_KEYS = 1_000_000
POST_CAP = 8_388_608         # G3's aggregated page
POST_LIVE = 16
DENSE_CAP = 32_768           # q3 sf1's dense build (customer)
DENSE_LIVE = 30_136
DENSE_KEYS = 150_000
DENSE_SIZES = (262_144, 1_048_576)
MXU_CAP = 262_144            # the main path's K13 call in K6
MXU_LIVE = 150_000
MXU_BUILD = 25
MXU_SPAN = 25                # a 128-slot table
MXU_BIG = (3_000, 4_096)     # keyed build rows, span: a 4,096-slot table
DENSE_PROBE_CAP = 1_048_576  # q3 sf1's orders probe buffer
DENSE_PROBE_LIVE = 777_211
SEARCH_CAP = 5_242_880       # q3 sf1's lineitem probe buffer
SEARCH_LIVE = 3_049_501
SEARCH_BUILD_CAP = 262_144   # q3 sf1's orders build
SEARCH_BUILD = 157_563
SCATTER_CAP = 8_388_608      # a D4 sf10 q9 shard's lineitem page
SCATTER_LIVE = 7_503_144
SCATTER_N = 8
SCATTER_BUCKET = 1_048_576
SCATTER_DTYPES = (torch.int64, torch.int64, torch.int64, torch.float64,
                  torch.float64, torch.float64, torch.int64)
LOOKUP_CAP = 8_388_608       # G3's probe: lineitem sf1 on a scan page
LOOKUP_LIVE = 5_999_956
LOOKUP_SLOTS = 256
LOOKUP_BUILD = 1_500_000     # orders sf1 over the 256 slots
BOUNDS_CAP = 2_097_152       # G3's build: orders sf1 on its page
BOUNDS_LIVE = 1_500_000
RUNS_CAP = 8_388_608          # sf1's largest expanding build
RUNS_LIVE = 3_793_276
RUNS_ORDERS = 1_500_000
RUNS_DENSE = 2_097_152
RUNS_Q13 = (2_097_152, 1_500_000, 150_000)  # cap, orders, customers (sf1)
MAP_L3 = (8_388_608, 5_999_956, 7, 10_000, 1_024, 16_384)  # cap, live,
MAP_L4 = (1_048_576, 800_000, 200_000, 10_000, 128, 16_384)  # keys, G, L,
# list rows
PARTS = ("floor", "main", "spill", "hll", "ladder", "heavy", "post",
         "dense", "probe", "scatter", "lookup", "bounds", "spillprobe",
         "runs", "map")


def event_ms(fn, iters: int = 100) -> float:
    """Median CUDA-event milliseconds of one `fn()` on an idle stream."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, calls: int) -> float:
    """CUDA-event milliseconds per call over `calls` calls enqueued back
    to back: the device time of a call whose host enqueue is shorter (the
    profiler's device split can drop events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def enqueue_us(fn, calls: int) -> float:
    """Host microseconds per call of `fn` over `calls` calls (no sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


class _Traced:
    """native.library's result with each C function behind one Python
    frame (`ctypes_call`), so cProfile shows the ctypes call and its
    launches apart from the wrapper's own time."""

    def __init__(self, lib):
        self._lib = lib
        self._fns = {}

    def __getattr__(self, name):
        fn = self._fns.get(name)
        if fn is None:
            real = getattr(self._lib, name)

            def ctypes_call(*args):
                return real(*args)
            fn = self._fns[name] = ctypes_call
        return fn


def trace_ctypes() -> None:
    """Route every later native.library() and native.function() call
    through one Python frame per C function (`ctypes_call`)."""
    real = native.library
    cache = {}

    def library(name):
        if name not in cache:
            cache[name] = _Traced(real(name))
        return cache[name]
    native.library = library
    real_function = getattr(native, "function", None)
    if real_function is None:
        return
    fns = {}

    def function(name, entry, argtypes):
        fn = fns.get((name, entry))
        if fn is None:
            # the real binding, so that its argument types are set on the
            # ctypes function and not on a traced frame
            native.library = real
            try:
                real_fn = real_function(name, entry, argtypes)
            finally:
                native.library = library

            def ctypes_call(*args):
                return real_fn(*args)
            fn = fns[(name, entry)] = ctypes_call
        return fn
    native.function = function


def host_split(fn, wrapper, calls: int):
    """(µs per call under cProfile, [(callee label, µs per call)]) of
    `calls` calls of `fn`, which calls `wrapper`: the wrapper's own time
    first, then each function it calls directly, most time first."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    code = wrapper.__code__
    key = (code.co_filename, code.co_firstlineno, code.co_name)
    _, _, own, total, _ = stats[key]
    parts = [("(the wrapper's own lines: checks, lists, glue)",
              own / calls * 1e6)]
    for (path, line, name), (_, _, _, _, callers) in stats.items():
        if key in callers:
            label = f"{os.path.basename(path)}:{line}({name})" if line \
                else name
            parts.append((label, callers[key][3] / calls * 1e6))
    parts[1:] = sorted(parts[1:], key=lambda p: -p[1])
    return total / calls * 1e6, parts


def device_split(fn, iters: int = 10):
    """(device-busy ms per call, kernels launched per call, [(kernel,
    ms per call, launches per call)] most time first) of `fn` from
    torch.profiler: every kernel, memset and copy it ran. A window in
    which the profiler records no device event is tried once more, five
    times as long; (None, 0, []) when that records none either."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for n in (iters, 5 * iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total", 0.0), e.count,
                 _short(e.key)) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if rows:
            busy = sum(t for t, _, _ in rows) / n / 1e3
            launches = sum(c for _, c, _ in rows) / n
            return busy, launches, [(k, t / n / 1e3, c / n)
                                    for t, c, k in sorted(rows, reverse=True)]
    return None, 0, []


def _short(name: str) -> str:
    """A kernel's profiler name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0] if "(" in name and not name.startswith(
        "Memset") else name


def launch_floor(calls: int = 1000) -> dict:
    """Host µs per launch and CUDA-event ms per launch of the empty
    kernels: ctypes with 3, 256 and 2,048 parameter words, Triton with
    30 arguments."""
    lib = native.library("floor")
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(native.stream_ptr(dev))
    words = {n: (ctypes.c_int64 * n)(*range(n)) for n in (256, 2048)}

    def small():
        native.check(lib.launch_floor_small(stream), "launch_floor_small")

    def table(n):
        def run():
            native.check(lib.launch_floor_table(words[n], ctypes.c_int64(n),
                                                stream), "launch_floor_table")
        return run
    kinds = [("ctypes, 3 words", small),
             ("ctypes, 256 words", table(256)),
             ("ctypes, 2,048 words (16 KB Table)", table(2048))]
    if hasattr(lib, "launch_floor_coop"):

        def coop():
            native.check(lib.launch_floor_coop(stream), "launch_floor_coop")
        kinds.append(("ctypes, 3 words, cooperative", coop))
    kinds.append(("triton, 30 arguments", _triton_empty(dev)))
    out = {}
    for label, fn in kinds:
        out[label] = (enqueue_us(fn, calls), event_ms(fn))
    return out


def _triton_empty(dev):
    import triton
    import triton.language as tl
    # the kernel's annotations resolve `tl` through this module's globals
    globals()["tl"] = tl

    @triton.jit
    def empty(p0, p1, p2, p3, p4, p5, p6, p7, p8, p9, p10, p11, p12, p13,
              p14, p15, p16, p17, p18, p19, p20, p21, p22, p23, n0, n1, n2,
              n3, K: tl.constexpr, B: tl.constexpr):
        pass
    bufs = [torch.empty(1, dtype=torch.int64, device=dev) for _ in range(24)]

    def run():
        empty[(1,)](*bufs, 1, 2, 3, 4, K=2, B=1024, num_warps=4)
    return run


def receive_call(dev):
    """An exchange receive: RECEIVE_SLICES slices of RECEIVE_CAP rows of
    six value columns and their validity, RECEIVE_LIVE live rows."""
    g = torch.Generator(device=dev).manual_seed(13)
    arrays, counts = [], []
    for s in range(RECEIVE_SLICES):
        pa = []
        for dt in RECEIVE_DTYPES:
            if dt.is_floating_point:
                v = torch.rand(RECEIVE_CAP, generator=g, device=dev,
                               dtype=dt)
            else:
                v = torch.randint(-2**30, 2**30, (RECEIVE_CAP,), generator=g,
                                  device=dev, dtype=dt)
            pa += [v, torch.rand(RECEIVE_CAP, generator=g, device=dev) < 0.9]
        arrays.append(pa)
        n = RECEIVE_LIVE // RECEIVE_SLICES + (s < RECEIVE_LIVE
                                               % RECEIVE_SLICES)
        counts.append(torch.tensor(n, dtype=torch.int32, device=dev))
    return arrays, counts, RECEIVE_SLICES * RECEIVE_CAP


def spill_call(dev):
    """K16's arguments at sf1's spilled orders build: (o_orderkey, its
    value mod 1000) over SPILL_LIVE live rows of SPILL_CAP, no NULL."""
    i = torch.arange(SPILL_CAP, dtype=torch.int64, device=dev)
    key = (i // 8) * 32 + i % 8 + 1          # TPC-H's sparse order keys
    cols = [(key, None), (key % 1000, None)]
    return cols, torch.tensor(SPILL_LIVE, dtype=torch.int32, device=dev)


def hll_call(dev, groups: int, pairs: int, cap: int, nseg: int,
             seed: int = 5):
    """K30 HLL's arguments as K8 leaves them: `pairs` distinct (group <<
    11 | bucket) pairs of `groups` groups in a random order (K8's
    hash-slot order) on a page of `cap` rows, each with its largest rho
    (1 + the larger of two geometric draws), num_groups on the device and
    nseg."""
    import numpy as np
    rng = np.random.default_rng(seed)
    space = groups << 11
    drawn = np.unique(rng.integers(0, space, int(pairs * 1.05) + 64))
    pair = rng.permutation(drawn)[:min(pairs, len(drawn))]
    rho = 1 + np.maximum(rng.geometric(0.5, len(pair)),
                         rng.geometric(0.5, len(pair)))
    p = torch.full((cap,), -1, dtype=torch.int64)
    r = torch.zeros(cap, dtype=torch.int64)
    p[:len(pair)] = torch.from_numpy(pair)
    r[:len(pair)] = torch.from_numpy(np.minimum(rho, 54))
    n = torch.tensor(len(pair), dtype=torch.int32, device=dev)
    ng = torch.tensor(groups, dtype=torch.int32, device=dev)
    return p.to(dev), r.to(dev), n, ng, nseg


def heavy_words(cap: int, live: int, distinct: int, seed: int = 9,
                dev="cpu") -> torch.Tensor:
    """K36's input: `live` words drawn from `distinct` keys (spread over
    the 64-bit range by a multiplicative hash, none the sentinel) in
    unsigned ascending order, then the sentinel 2^64 - 1 (-1) up to
    `cap`, as K10 leaves a shard's masked key words."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(distinct, 1), live).astype(np.uint64)
    w = keys * np.uint64(0x9E3779B97F4A7C15)
    w[w == np.uint64(0xFFFFFFFFFFFFFFFF)] = 0
    out = torch.full((cap,), -1, dtype=torch.int64)
    out[:live] = torch.from_numpy(np.sort(w).view(np.int64))
    return out.to(dev)


def post_call(dev, helpers: int, cap: int = POST_CAP,
              live: int = POST_LIVE, seed: int = 3):
    """K27's arguments at G3's aggregated page: `helpers` summed #valid-w
    columns (int64, zeros among them) of `cap` rows, `live` live."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = [torch.randint(0, 3, (cap,), generator=g, device=dev,
                        dtype=torch.int64) for _ in range(helpers)]
    return hs, torch.tensor(live, dtype=torch.int32, device=dev)


def dense_build_cols(cap: int, live: int, dev, keys: int = DENSE_KEYS,
                     seed: int = 7):
    """K5's dense-mode input at q3 sf1's build: `live` distinct int64 keys
    of 1 .. `keys` (customer keys that passed the filter) in a random
    order on a page of `cap` rows, no NULL."""
    g = torch.Generator().manual_seed(seed)
    v = torch.zeros(cap, dtype=torch.int64)
    v[:live] = torch.randperm(keys, generator=g)[:live] + 1
    return [(v.to(dev), None)], torch.tensor(live, dtype=torch.int32,
                                            device=dev)


def probe_cols(build: int, span: int, cap: int, live: int, dev,
               seed: int = 11):
    """An mxu-route probe: `build` distinct keys of 0 .. span - 1 on a
    page of 2 x build rows (bcols, bnr), and `live` probe keys of 0 ..
    span + span // 8 on a page of `cap` rows (pcols, pnr), no NULL."""
    g = torch.Generator().manual_seed(seed)
    b = torch.zeros(2 * build, dtype=torch.int64)
    b[:build] = torch.randperm(span, generator=g)[:build]
    p = torch.randint(0, span + span // 8, (cap,), generator=g)
    return ([(b.to(dev), None)],
            torch.tensor(build, dtype=torch.int32, device=dev),
            [(p.to(dev), None)],
            torch.tensor(live, dtype=torch.int32, device=dev))


def dense_probe_cols(dev, seed: int = 13):
    """q3 sf1's dense-route probe: the dense build of dense_build_cols
    (bcols, bnr), and DENSE_PROBE_LIVE customer keys of 1 .. DENSE_KEYS
    on DENSE_PROBE_CAP rows (pcols, pnr), about a fifth matching."""
    bcols, bnr = dense_build_cols(DENSE_CAP, DENSE_LIVE, dev)
    g = torch.Generator().manual_seed(seed)
    p = torch.randint(1, DENSE_KEYS + 1, (DENSE_PROBE_CAP,), generator=g)
    return (bcols, bnr, [(p.to(dev), None)],
            torch.tensor(DENSE_PROBE_LIVE, dtype=torch.int32, device=dev))


def search_cols(dev, seed: int = 12):
    """q3 sf1's search-route probe: SEARCH_BUILD order keys (TPC-H's
    sparse keys, i // 8 * 32 + i % 8 + 1) of 1,500,000 orders on a
    SEARCH_BUILD_CAP page, and SEARCH_LIVE probe keys laid out as
    lineitem lays them out, each order's 1 to 7 lines together in order
    of key, the orders drawn from ten times as many (about 1% match), on
    SEARCH_CAP rows."""
    g = torch.Generator().manual_seed(seed)

    def okey(i):
        return i // 8 * 32 + i % 8 + 1
    b = torch.zeros(SEARCH_BUILD_CAP, dtype=torch.int64)
    b[:SEARCH_BUILD] = okey(torch.randperm(1_500_000, generator=g)[
        :SEARCH_BUILD])
    orders = torch.sort(torch.randint(0, 15_000_000, (SEARCH_CAP // 4,),
                                      generator=g)).values
    lines = torch.randint(1, 8, (orders.numel(),), generator=g)
    p = torch.zeros(SEARCH_CAP, dtype=torch.int64)
    keys = okey(torch.repeat_interleave(orders, lines))[:SEARCH_CAP]
    p[:keys.numel()] = keys
    return ([(b.to(dev), None)],
            torch.tensor(SEARCH_BUILD, dtype=torch.int32, device=dev),
            [(p.to(dev), None)],
            torch.tensor(SEARCH_LIVE, dtype=torch.int32, device=dev))


def scatter_arrays(dev, cap: int = SCATTER_CAP, live: int = SCATTER_LIVE,
                   seed: int = 17):
    """A D4 sf10 q9 shard's lineitem page as K35 moves it: (key columns,
    num_rows, [(array, template)]) with SCATTER_DTYPES values (the first
    the join key) and a validity for each, `live` live rows of `cap`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    arrays = []
    for dt in SCATTER_DTYPES:
        if dt.is_floating_point:
            v = torch.rand(cap, generator=g, device=dev, dtype=dt)
        else:
            v = torch.randint(0, 1 << 40, (cap,), generator=g, device=dev,
                              dtype=dt)
        valid = torch.rand(cap, generator=g, device=dev) < 0.95
        arrays += [(v, v), (valid, valid)]
    nr = torch.tensor(live, dtype=torch.int32, device=dev)
    return [(arrays[0][0], None)], nr, arrays


def scatter_call(dev):
    """K35's scatter arguments at the D4 shard's shape: the state from
    K35's count pass on the card (hash mode), the arrays, n, bucket."""
    from trino_tpu_torch.parallel import exchange as X
    cols, nr, arrays = scatter_arrays(dev)
    state, _ = X.exchange_count_cuda(cols, nr, SCATTER_N, X.MODE_HASH, None)
    return state, arrays, SCATTER_N, SCATTER_BUCKET


def scatter_check(args) -> int:
    """Compare K35's scatter at `args` with its twin over every occupied
    slot of every array; returns the rows moved."""
    from trino_tpu_torch.parallel import exchange as X
    state, arrays, n, bucket = args
    dest = state[0]
    got = X.exchange_scatter_cuda(*args)
    want = X.exchange_scatter_plain(dest, arrays, n, bucket)
    counts = [min(int(((dest == d) | (dest == -1)).sum()), bucket)
              for d in range(n)]
    for a, b in zip(got, want):
        for d, m in enumerate(counts):
            lo = d * bucket
            if not torch.equal(a[lo:lo + m], b[lo:lo + m]):
                raise SystemExit("K35's scatter differs from its twin")
    return sum(counts)


def scatter_library(args):
    """The library call beside K35's scatter: one stable argsort of the
    destinations and one index_select per array."""
    state, arrays, _, _ = args
    src = [a for a, _ in arrays if a is not None]

    def run():
        order = torch.argsort(state[0], stable=True)
        return [a.index_select(0, order) for a in src]
    return run


def lookup_call(dev, cap: int = LOOKUP_CAP, live: int = LOOKUP_LIVE,
                seed: int = 19):
    """K25's arguments at G3's probe: (key, num_rows, table, kmin, outs)
    with G3's outputs: the pairs, l_linenumber x pairs, the build column's
    sum and its valid count (the SUM's helper)."""
    from trino_tpu_torch.ops import join_mxu as JM
    g = torch.Generator(device=dev).manual_seed(seed)
    key = torch.randint(0, 6_000_000, (cap,), generator=g, device=dev,
                        dtype=torch.int64) % LOOKUP_SLOTS
    v = torch.randint(1, 8, (cap,), generator=g, device=dev,
                      dtype=torch.int32)
    per = LOOKUP_BUILD // LOOKUP_SLOTS
    cnt = torch.randint(per - 50, per + 50, (LOOKUP_SLOTS,), generator=g,
                        device=dev, dtype=torch.int64)
    table = torch.stack([cnt, cnt * 75_000, cnt], 1).contiguous()
    kmin = torch.zeros(1, dtype=torch.int64, device=dev)
    outs = [(JM.OP_PAIRS, 0, None, None), (JM.OP_SUMP_I, 0, v, None),
            (JM.OP_TABLE_I, 1, None, None), (JM.OP_TABLE_I, 2, None, None)]
    nr = torch.tensor(live, dtype=torch.int32, device=dev)
    return (key, None), nr, table, kmin, outs


def lookup_check(args) -> None:
    """Compare K25 at `args` with its twin over the live rows, the
    outputs and the mask."""
    from trino_tpu_torch.ops import join_mxu as JM
    n = int(args[1])
    got, live = JM.agg_lookup_cuda(*args)
    want, wlive = JM.agg_lookup_plain(*args)
    if not torch.equal(live[:n], wlive[:n]) or not all(
            torch.equal(a[:n], b[:n]) for a, b in zip(got, want)):
        raise SystemExit("K25 differs from its twin on the live rows")


def lookup_library(args):
    """The library call beside K25: index_select of each live row's table
    row (the indices made beforehand)."""
    key, nr, table, kmin, _ = args
    idx = (key[0][:int(nr)] - kmin).clamp(0, table.shape[0] - 1)
    return lambda: table.index_select(0, idx)


def bounds_call(dev):
    """K26's arguments at G3's build: (values, valid, num_rows) with
    BOUNDS_LIVE int64 keys o_orderkey % 256 (TPC-H's sparse order keys, in
    order) on BOUNDS_CAP rows, no NULL."""
    i = torch.arange(BOUNDS_LIVE, dtype=torch.int64)
    v = torch.zeros(BOUNDS_CAP, dtype=torch.int64)
    v[:BOUNDS_LIVE] = (i // 8 * 32 + i % 8 + 1) % 256
    return v.to(dev), None, torch.tensor(BOUNDS_LIVE, dtype=torch.int32,
                                        device=dev)


def bounds_wrapper():
    from trino_tpu_torch.ops import join_mxu as JM
    return getattr(JM, "key_bounds_cuda", None) \
        or getattr(JM, "key_bounds_triton")


def spill_probe_call(dev):
    """K17's dense-mode arguments at q3 sf1's spill-dense probe: the
    SEARCH_BUILD order keys of search_cols through K16 and K5's dense mode
    (the row table over their span), and SEARCH_LIVE lineitem order keys
    of SEARCH_CAP rows: (pcols, num_rows, mode, table, stats)."""
    from trino_tpu_torch.ops import join as J
    bcols, bnr, pcols, pnr = search_cols(dev)
    keys, perm, stats = J.spill_prep_cuda(bcols, bnr)
    kmin, kmax = (J.unsigned(int(stats[J.KMIN])),
                  J.unsigned(int(stats[J.KMAX])))
    size = 1 << (kmax - kmin).bit_length()
    table = J.build_dense_table_rows(size)(keys, perm, stats)
    return pcols, pnr, J.SPILL_DENSE, table, stats


def spill_probe_check(args) -> int:
    """Compare K17 at `args` with its twin over the live rows; returns
    the matches."""
    from trino_tpu_torch.ops import join as J
    n = int(args[1])
    got = J.spill_probe(*args)
    want = J.spill_probe_plain(*args)
    if int(got[2]) != int(want[2]) or not all(
            torch.equal(a[:n], b[:n]) for a, b in zip(got[:2], want[:2])):
        raise SystemExit("K17 differs from its twin on the live rows")
    return int(got[2])


def spill_probe_library(args):
    """The library call beside K17's dense mode: index_select of the row
    table at the live rows' offsets (made beforehand)."""
    from trino_tpu_torch.ops import join as J
    pcols, nr, _, table, stats = args
    key, _ = J._key_cols(pcols)
    off = (key[:int(nr)] - stats[J.KMIN]).clamp(0, table.numel() - 1)
    return lambda: table.index_select(0, off)


def runs_call(dev, seed: int = 19):
    """K5 runs-mode arguments at sf1's largest expanding build: (cols,
    num_rows, stats, lookup, size) from K5 on the card over RUNS_LIVE
    lines kept from RUNS_ORDERS orders of 1 to 7 lines (TPC-H's sparse
    order keys: 8 of every 32) on RUNS_CAP rows."""
    from trino_tpu_torch.ops import join as J
    g = torch.Generator().manual_seed(seed)
    lines = torch.randint(1, 8, (RUNS_ORDERS,), generator=g)
    o = torch.arange(RUNS_ORDERS)
    okey = torch.repeat_interleave(o // 8 * 32 + o % 8 + 1, lines)
    keep = torch.randperm(okey.numel(), generator=g)[:RUNS_LIVE]
    v = torch.zeros(RUNS_CAP, dtype=torch.int64)
    v[:RUNS_LIVE] = okey[torch.sort(keep).values]
    cols = [(v.to(dev), None)]
    nr = torch.tensor(RUNS_LIVE, dtype=torch.int32, device=dev)
    stats, lookup = J.join_build_cuda(cols, nr)
    return cols, nr, stats, lookup, RUNS_DENSE


def runs_q13_call(dev, seed: int = 13):
    """K5 runs-mode arguments at q13's build at sf1: (cols, num_rows,
    stats, lookup, 0) over RUNS_Q13's orders in order-key order, each
    o_custkey drawn uniformly from the customers whose key is not a
    multiple of 3 (TPC-H's rule), so a run's rows lie apart."""
    from trino_tpu_torch.ops import join as J
    cap, orders, customers = RUNS_Q13
    g = torch.Generator().manual_seed(seed)
    ck = torch.arange(1, customers + 1)
    ck = ck[ck % 3 != 0]
    v = torch.zeros(cap, dtype=torch.int64)
    v[:orders] = ck[torch.randint(0, ck.numel(), (orders,), generator=g)]
    cols = [(v.to(dev), None)]
    nr = torch.tensor(orders, dtype=torch.int32, device=dev)
    stats, lookup = J.join_build_cuda(cols, nr)
    return cols, nr, stats, lookup, 0


def runs_check(args) -> int:
    """Compare K5's runs mode at `args` with its twin, each run read
    through its (start, count); returns max_run."""
    from trino_tpu_torch.ops import join as J
    cols, nr, stats, lookup, size = args
    (runs, start, count), dense = J.join_runs_cuda(*args)
    wst, wlk = J.join_build_plain(cols, nr)
    (wruns, _, wcount), wdense = J.join_runs_plain(cols, nr, wst, wlk,
                                                        size)
    occ = lookup[2] >= 0
    keys, order = torch.sort(lookup[1][occ])
    c = count[occ][order].to(torch.int64)
    s0 = start[occ][order].to(torch.int64)
    total = int(c.sum())
    first = torch.cumsum(c, 0) - c
    place = torch.repeat_interleave(s0 - first, c) + torch.arange(
        total, device=c.device)
    if not (torch.equal(keys, wlk[1]) and torch.equal(c, wcount.to(
            torch.int64)) and torch.equal(runs[place], wruns[:total])):
        raise SystemExit("K5's runs mode differs from its twin")
    if (dense is None) != (wdense is None):
        raise SystemExit("K5's runs mode and its twin differ on the dense "
                         "table's presence")
    if dense is None:
        return int(stats[J.MAX_RUN])
    kin = dense != 2**31 - 1
    if not torch.equal(kin, wdense != 2**31 - 1) or not torch.equal(
            lookup[1][dense[kin].long()], wlk[1][wdense[kin].long()]):
        raise SystemExit("K5's runs-mode dense table differs from its twin")
    return int(stats[J.MAX_RUN])


def map_call(dev, shape, seed: int = 33):
    """K33 map-mode arguments (x, x2, masks, num_rows, gid, num_groups, L,
    rows) and the span bound at L3's (`shape` MAP_L3: histogram of int32
    codes) or L4's (MAP_L4: map_agg of int64 part keys, each on 4 of the
    groups, and float64 costs) call; group ids uniform over the groups."""
    cap, live, keys, groups, L, rows = shape
    g = torch.Generator().manual_seed(seed)
    gid = torch.zeros(cap, dtype=torch.int32)
    if shape is MAP_L3:
        gid[:live] = torch.randint(0, groups, (live,), generator=g,
                                   dtype=torch.int32)
        x = torch.zeros(cap, dtype=torch.int32)
        x[:live] = torch.randint(0, keys, (live,), generator=g,
                                 dtype=torch.int32)
        x2, span = None, keys
    else:
        p = torch.arange(keys).repeat_interleave(4)
        i = torch.arange(live) % 4
        gid[:live] = ((p + i * (groups // 4 + p // groups)) % groups).to(
            torch.int32)
        x = torch.zeros(cap, dtype=torch.int64)
        x[:live] = p + 1
        x2 = torch.zeros(cap, dtype=torch.float64)
        x2[:live] = torch.randint(100, 100_000, (live,), generator=g) / 100
        x2, span = x2.to(dev), None
    args = (x.to(dev), x2, [], torch.tensor(live, dtype=torch.int32,
                                            device=dev), gid.to(dev),
            torch.tensor(groups, dtype=torch.int32, device=dev), L, rows)
    return args, span


def map_wrapper_call(args, span):
    """The tree's map-mode wrapper at `args`, with the span bound where
    the wrapper takes one (a tree before it does not)."""
    import inspect
    from trino_tpu_torch.ops import lists as LS
    if "span" in inspect.signature(LS.collect_map_cuda).parameters:
        return lambda: LS.collect_map_cuda(*args, span)
    return lambda: LS.collect_map_cuda(*args)


def map_library(args):
    """The library call beside K33's map mode: torch.sort(stable=True) of
    (group, key) and one index_put_ of the keys at each group's row."""
    x, _, _, nr, gid, _, L, rows = args
    n = int(nr)
    key = (gid[:n].to(torch.int64) << 32) + x[:n].to(torch.int64)
    flat = torch.zeros(rows * L, dtype=x.dtype, device=x.device)
    slot = (gid[:n].to(torch.int64) * L).clamp(max=rows * L - 1)
    xs = x[:n]
    return lambda: flat.index_put_((slot[torch.sort(key, stable=True)
                                         .indices],), xs)


def probe_prepared(bcols, bnr, route: str):
    """K5 (with its dense mode on the dense route, K12 on the mxu route)
    on the card: the Prepared K6 reads."""
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import join_mxu as JM
    stats, lookup = J.join_build_cuda(bcols, bnr)
    prep = J.Prepared(None, (), stats, lookup)
    kmin, kmax = (J.unsigned(int(stats[J.KMIN])),
                  J.unsigned(int(stats[J.KMAX])))
    if route == "mxu":
        size = 1 << max((kmax - kmin).bit_length(), 7)
        prep.mxu = JM.mxu_table_cuda(bcols, bnr, stats, lookup, None, size)
    elif route == "dense":
        size = 1 << max((kmax - kmin).bit_length(), 10)
        prep.dense = J.join_dense_cuda(bcols, bnr, stats, size)
    return prep


def k27_wrapper():
    from trino_tpu_torch.ops import join_mxu as JM
    return getattr(JM, "agg_post_cuda", None) \
        or getattr(JM, "agg_post_triton")


@contextlib.contextmanager
def last_block_groups(value: int):
    """K30 HLL's last-block threshold set to `value` for the block."""
    from trino_tpu_torch.ops import aggregate as A
    old = A.HLL_LAST_BLOCK_GROUPS
    A.HLL_LAST_BLOCK_GROUPS = value
    try:
        yield
    finally:
        A.HLL_LAST_BLOCK_GROUPS = old


def k4_wrapper():
    from trino_tpu_torch.ops import aggregate as A
    return getattr(A, "global_reduce_cuda", None) \
        or getattr(A, "global_reduce_triton")


def main_path_calls():
    """(q1 sf1's K2 arguments, q6 sf1's first K4 call of the largest
    capacity) from runs of q1 and q6 on the card, captured as
    chip_smoke.py's phase 4 captures them."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.exec import LocalQueryRunner
    from trino_tpu_torch.ops import aggregate as A
    k2, k4 = P.concat_rows_cuda, k4_wrapper()
    seen = {}

    def k2_seen(arrays, counts, out_cap):
        if out_cap > seen.get("k2", (None, None, -1))[2]:
            seen["k2"] = (arrays, counts, out_cap)
        return k2(arrays, counts, out_cap)

    def k4_seen(states, num_rows, cap):
        if cap > seen.get("k4", (None, None, -1))[2]:
            seen["k4"] = (states, num_rows, cap)
        return k4(states, num_rows, cap)
    # the kernels count their launches on the name they are called by
    k2_seen.__dict__.update(k2.__dict__)
    k4_seen.__dict__.update(k4.__dict__)
    runner = LocalQueryRunner.tpch("sf1")
    P.concat_rows_cuda = k2_seen
    setattr(A, k4.__name__, k4_seen)
    try:
        runner.execute(Q1)
        seen.pop("k4", None)
        runner.execute(Q6)
    finally:
        P.concat_rows_cuda = k2
        setattr(A, k4.__name__, k4)
    torch.cuda.synchronize()
    return seen["k2"], seen["k4"]


def report(calls: int, parts=PARTS):
    """Yield the launch-floor lines, then one host-split line per call
    (and for K16 and the HLL fold a device-split line), then the HLL
    ladder."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import join as J
    dev = torch.device("cuda")
    native.build_all()
    card = torch.cuda.get_device_name(0)
    if "floor" in parts:
        for label, (us, ms) in launch_floor(calls).items():
            yield (f"[kernel] launch floor, {label}: host {us:.2f} us per "
                   f"launch ({calls} launches), {ms:.4f} ms per launch "
                   f"(CUDA events) — {card}")
    shapes = []
    if "main" in parts:
        q1_args, q6_args = main_path_calls()
        k4 = k4_wrapper()
        caps = [next(a.shape[0] for a in pa if a is not None)
                for pa in q1_args[0]]
        shapes += [
            ("K2 at q1 sf1's partial buffer", P.concat_rows_cuda, q1_args,
             f"{len(q1_args[0])} pages, {len(q1_args[0][0])} arrays, caps "
             f"{caps}, live {[int(c) for c in q1_args[1]]}", False),
            ("K2 at the receive", P.concat_rows_cuda, receive_call(dev),
             f"{RECEIVE_SLICES} slices of {RECEIVE_CAP} rows, "
             f"{2 * len(RECEIVE_DTYPES)} arrays, {RECEIVE_LIVE} live", False),
            ("K4 at q6 sf1's partial", k4, q6_args,
             f"{len(q6_args[0])} states, cap {q6_args[2]}, "
             f"{int(q6_args[1])} live", False)]
    if "spill" in parts:
        shapes.append((
            "K16 at sf1's spilled build", J.spill_prep_cuda, spill_call(dev),
            f"cap {SPILL_CAP}, {SPILL_LIVE} live rows, 2 int64 key columns, "
            f"no NULL", True))
    if "hll" in parts:
        shapes.append((
            "K30 HLL fold at S5's shape", A.hll_fold_cuda,
            hll_call(dev, HLL_GROUPS, HLL_PAIRS, HLL_CAP, HLL_CAP),
            f"{HLL_PAIRS} pairs of {HLL_GROUPS} groups on a page of "
            f"{HLL_CAP}, nseg {HLL_CAP}", True))
    if "heavy" in parts:
        from trino_tpu_torch.parallel import exchange as X
        words = heavy_words(HEAVY_CAP, HEAVY_LIVE, HEAVY_KEYS, dev=dev)
        for k in (8, 64):
            got = X.heavy_local_cuda(words, k)
            want = X.heavy_local_plain(words, k)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K36 local mode at k {k} differs from "
                                 "its twin")
            shapes.append((
                f"K36 local mode at a D4 q9 shard, k {k}",
                X.heavy_local_cuda, (words, k),
                f"{HEAVY_LIVE} live sorted words of {HEAVY_KEYS} keys on "
                f"{HEAVY_CAP}", True))
    if "post" in parts:
        for n in (1, 9):
            shapes.append((
                f"K27 at G3's aggregated page, {n} helper(s)", k27_wrapper(),
                post_call(dev, n), f"cap {POST_CAP}, {POST_LIVE} live rows",
                True))
    if "dense" in parts:
        cols, nr = dense_build_cols(DENSE_CAP, DENSE_LIVE, dev)
        stats, _ = J.join_build_cuda(cols, nr)
        for size in DENSE_SIZES:
            if not torch.equal(J.join_dense_cuda(cols, nr, stats, size),
                               J.join_dense_plain(cols, nr, stats, size)):
                raise SystemExit(f"K5's dense mode at {size} slots differs "
                                 "from its twin")
            shapes.append((
                f"K5 dense mode at q3's build, {size} slots",
                J.join_dense_cuda, (cols, nr, stats, size),
                f"{DENSE_LIVE} live keys of {DENSE_KEYS} on {DENSE_CAP} "
                f"rows", True))
    if "probe" in parts:
        calls_ = [("K13 in K6, 128 slots", "mxu",
                   probe_cols(MXU_BUILD, MXU_SPAN, MXU_CAP, MXU_LIVE, dev),
                   f"{MXU_LIVE} live of {MXU_CAP}, {MXU_BUILD} keyed build "
                   f"rows"),
                  ("K13 in K6, 4,096 slots", "mxu",
                   probe_cols(*MXU_BIG, MXU_CAP, MXU_LIVE, dev),
                   f"{MXU_LIVE} live of {MXU_CAP}, {MXU_BIG[0]} keyed "
                   f"build rows"),
                  ("K6 dense route at q3's first probe", "dense",
                   dense_probe_cols(dev),
                   f"{DENSE_PROBE_LIVE} live of {DENSE_PROBE_CAP}, "
                   f"{DENSE_LIVE} build rows"),
                  ("K6 search route at q3's probe", "search",
                   search_cols(dev),
                   f"{SEARCH_LIVE} live of {SEARCH_CAP}, {SEARCH_BUILD} "
                   f"build rows on {SEARCH_BUILD_CAP}")]
        for name, route, (bcols, bnr, pcols, pnr), shape in calls_:
            prep = probe_prepared(bcols, bnr, route)
            twin = J.Prepared(None, (), *J.join_build_plain(bcols, bnr))
            if prep.mxu is not None:
                from trino_tpu_torch.ops import join_mxu as JM
                twin.mxu = JM.mxu_table_plain(bcols, bnr, twin.stats,
                                              twin.lookup, None,
                                              prep.mxu.shape[0])
            if prep.dense is not None:
                twin.dense = J.join_dense_plain(bcols, bnr, twin.stats,
                                                prep.dense.numel())
            got = J.unique_probe_cuda(pcols, bcols, pnr, prep)
            want = J.unique_probe_plain(pcols, bcols, pnr, twin)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{name} differs from its twin")
            shapes.append((name, J.unique_probe_cuda,
                           (pcols, bcols, pnr, prep),
                           f"{shape}, {int(got[2])} matched", True))
    library = {}
    if "scatter" in parts:
        from trino_tpu_torch.parallel import exchange as X
        args = scatter_call(dev)
        moved = scatter_check(args)
        name = "K35 scatter at a D4 q9 shard"
        library[name] = ("argsort(dest, stable=True) + index_select per "
                         "array", scatter_library(args))
        shapes.append((
            name, X.exchange_scatter_cuda, args,
            f"{SCATTER_LIVE} live rows of {SCATTER_CAP}, {moved} moved, "
            f"{SCATTER_N} x {SCATTER_BUCKET} slots, {len(args[1])} arrays",
            True))
    if "lookup" in parts:
        from trino_tpu_torch.ops import join_mxu as JM
        args = lookup_call(dev)
        lookup_check(args)
        name = "K25 at G3's probe"
        library[name] = ("index_select of the live rows' table rows",
                         lookup_library(args))
        shapes.append((
            name, JM.agg_lookup_cuda, args,
            f"{LOOKUP_LIVE} live rows of {LOOKUP_CAP}, table "
            f"{tuple(args[2].shape)}, {len(args[4])} outputs", True))
    entry = {}
    if "bounds" in parts:
        from trino_tpu_torch.ops import join_mxu as JM
        args = bounds_call(dev)
        if not torch.equal(JM.key_bounds_words(*args),
                           JM.key_bounds_plain(*args)):
            raise SystemExit("K26 differs from its twin")
        name = "K26 at G3's build"
        library[name] = ("torch.aminmax of the live keys",
                         lambda v=args[0][:BOUNDS_LIVE]: torch.aminmax(v))
        entry[name] = JM.key_bounds_words
        shapes.append((name, bounds_wrapper(), args,
                       f"{BOUNDS_LIVE} live int64 keys of {BOUNDS_CAP}, no "
                       f"NULL", True))
    if "spillprobe" in parts:
        args = spill_probe_call(dev)
        matched = spill_probe_check(args)
        name = "K17 dense mode at q3's spill-dense probe"
        library[name] = ("index_select of the row table at the live rows' "
                         "offsets", spill_probe_library(args))
        entry[name] = J.spill_probe
        shapes.append((
            name, J.spill_probe_cuda, args,
            f"{SEARCH_LIVE} live of {SEARCH_CAP}, a row table of "
            f"{args[3].numel()} slots over {SEARCH_BUILD} build keys, "
            f"{matched} matched", True))
    if "runs" in parts:
        for name, args in (
                ("K5 runs mode at sf1's largest expanding build",
                 runs_call(dev)),
                ("K5 runs mode at q13's build (orders by o_custkey, sf1)",
                 runs_q13_call(dev))):
            max_run = runs_check(args)
            live = int(args[1])
            keys = args[0][0][0][:live]
            library[name] = ("torch.argsort(stable=True) of the build keys",
                             lambda k=keys: torch.argsort(k, stable=True))
            shapes.append((
                name, J.join_runs_cuda, args,
                f"{live} live keyed rows of {args[0][0][0].numel()}, "
                f"{args[3][2].numel()} slots, dense table {args[4]}, "
                f"max_run {max_run}", True))
    if "map" in parts:
        from trino_tpu_torch.ops import lists as LS
        for label, shape in (("L3", MAP_L3), ("L4", MAP_L4)):
            args, span = map_call(dev, shape)
            call = map_wrapper_call(args, span)
            got, want = call(), LS.collect_map_plain(*args)
            if not all(torch.equal(a.view(torch.uint8) if a.is_floating_point()
                                   else a, b.view(torch.uint8)
                                   if b.is_floating_point() else b)
                       for a, b in zip(got, want)):
                raise SystemExit(f"K33's map mode at {label} differs from "
                                 "its twin")
            name = f"K33 map mode at {label}'s call"
            library[name] = ("torch.sort(stable=True) of (group, key) + "
                             "index_put_", map_library(args))
            entry[name] = lambda *a, c=call: c()
            plan = getattr(LS, "map_plan", None)
            passes = len(plan(args[0], args[7], span).passes) if plan \
                else len(LS._words_passes(args[7], True))
            shapes.append((
                name, LS.collect_map_cuda, args,
                f"{int(args[3])} live rows of {args[0].numel()}, key "
                f"{args[0].dtype}, {'histogram' if args[1] is None else 'map_agg'}, "
                f"{int(args[5])} groups, L {args[6]}, {args[7]} list rows, "
                f"span bound {span}, {passes} K10 passes launched", True))
    trace_ctypes()
    for name, wrapper, args, shape, split in shapes:
        def call(w=entry.get(name, wrapper), a=args):
            return w(*a)
        total, parts_ = host_split(call, wrapper, calls)
        queued = calls
        if split:
            busy, n, top = device_split(call)
            queued = max(1, min(calls, int(QUEUE_LAUNCHES // max(n, 1))))
        yield (f"[host] {name} ({shape}): host enqueue "
               f"{enqueue_us(call, queued):.1f} us per call ({queued} "
               f"calls), "
               f"{event_ms(call):.4f} ms per call (CUDA events), "
               f"{queued_ms(call, min(queued, 200)):.4f} ms per call back "
               f"to back; under "
               f"cProfile {total:.1f} us per call: "
               + "; ".join(f"{label} {us:.1f}" for label, us in parts_[:12])
               + f" — {card}")
        if split and busy is None:
            yield (f"[device] {name}: not measured (the profiler recorded "
                   f"no device event) — {card}")
        elif split:
            yield (f"[device] {name}: device-busy {busy:.4f} ms per call, "
                   f"{n:g} kernels and copies per call: "
                   + "; ".join(f"{k} {ms:.4f} ms x{c:g}" for k, ms, c in top)
                   + f" — {card}")
        if name in library:
            label, lib = library[name]
            yield (f"[library] {name}: {label} {event_ms(lib):.4f} ms per "
                   f"call (CUDA events) — {card}")
    if "ladder" in parts and hasattr(A, "HLL_LAST_BLOCK_GROUPS"):
        for groups in HLL_LADDER:
            pairs = 78 * groups
            cap = max(1024, 1 << (pairs - 1).bit_length())
            args = hll_call(dev, groups, pairs, cap, groups)
            times = []
            for label, limit in (("last block", groups), ("second launch",
                                                          0)):
                with last_block_groups(limit):
                    got = A.hll_fold_cuda(*args)
                    if not torch.equal(got, A.hll_fold_plain(*args)):
                        raise SystemExit(f"HLL fold at {groups} groups "
                                         f"({label}) differs from its twin")
                    fold = (lambda: A.hll_fold_cuda(*args))
                    busy, n, _ = device_split(fold)
                    dev = "not measured" if busy is None \
                        else f"{busy:.4f} ms"
                    times.append(f"{label} {event_ms(fold):.4f} ms events, "
                                 f"{dev} busy in {n:g} kernels")
            yield (f"[ladder] K30 HLL fold, {groups} groups, {pairs} pairs "
                   f"(nseg {groups}, cap {cap}): " + "; ".join(times)
                   + f"; threshold now {A.HLL_LAST_BLOCK_GROUPS} — {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts: " + ", ".join(PARTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_trace needs a CUDA device")
    parts = tuple(args.only.split(","))
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"--only takes {', '.join(PARTS)}")
    for line in report(args.calls, parts):
        print(line, flush=True)


if __name__ == "__main__":
    main()
