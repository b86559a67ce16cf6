"""Where the host time of a K2 or K4 call goes, and the launch floor.

For three calls of the main path it traces 1,000 calls with cProfile and
splits each call's host time over what the wrapper calls directly (the
checks and glue in the wrapper itself, each allocation, the pointer-table
build, the stream lookup, the ctypes call with its launches, a Triton
launcher), beside the call's host enqueue time without the profiler and
its CUDA-event time on an idle stream:

* K2 (`page.concat_rows_cuda`) at q1 sf1's partial buffer, captured from
  a run of q1 on the card;
* K2 at an exchange receive of 8 slices of 2,097,152 rows and 12 arrays
  (six value columns and their validity), 161,549 live rows;
* K4 (`ops/aggregate.py`'s CUDA wrapper) at q6 sf1's partial, captured
  from a run of q6.

The launch floor is an empty kernel (`csrc/floor.cu`) launched through
the package's ctypes binding with a parameter block of three words, of
256 words and of 2,048 words (common.cuh's 16 KB `Table`), and an empty
`@triton.jit` kernel of 30 arguments: host microseconds per launch over
1,000 launches, and CUDA-event milliseconds per launch. Needs the card:

    python3 -m trino_tpu_torch.launch_trace [--calls 1000]
"""

from __future__ import annotations

import argparse
import cProfile
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


def event_ms(fn, iters: int = 20) -> float:
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
            real_fn = real_function(name, entry, argtypes)

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
    out = {}
    for label, fn in (("ctypes, 3 words", small),
                      ("ctypes, 256 words", table(256)),
                      ("ctypes, 2,048 words (16 KB Table)", table(2048)),
                      ("triton, 30 arguments", _triton_empty(dev))):
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


def report(calls: int):
    """Yield the launch-floor lines, then one host-split line per call."""
    from trino_tpu_torch import page as P
    dev = torch.device("cuda")
    native.build_all()
    card = torch.cuda.get_device_name(0)
    for label, (us, ms) in launch_floor(calls).items():
        yield (f"[kernel] launch floor, {label}: host {us:.2f} us per "
               f"launch ({calls} launches), {ms:.4f} ms per launch (CUDA "
               f"events) — {card}")
    q1_args, q6_args = main_path_calls()
    k4 = k4_wrapper()
    trace_ctypes()
    caps = [next(a.shape[0] for a in pa if a is not None)
            for pa in q1_args[0]]
    shapes = [
        ("K2 at q1 sf1's partial buffer", P.concat_rows_cuda, q1_args,
         f"{len(q1_args[0])} pages, {len(q1_args[0][0])} arrays, caps "
         f"{caps}, live {[int(c) for c in q1_args[1]]}"),
        ("K2 at the receive", P.concat_rows_cuda, receive_call(dev),
         f"{RECEIVE_SLICES} slices of {RECEIVE_CAP} rows, "
         f"{2 * len(RECEIVE_DTYPES)} arrays, {RECEIVE_LIVE} live"),
        ("K4 at q6 sf1's partial", k4, q6_args,
         f"{len(q6_args[0])} states, cap {q6_args[2]}, "
         f"{int(q6_args[1])} live"),
    ]
    for name, wrapper, args, shape in shapes:
        def call(w=wrapper, a=args):
            return w(*a)
        total, parts = host_split(call, wrapper, calls)
        yield (f"[host] {name} ({shape}): host enqueue "
               f"{enqueue_us(call, calls):.1f} us per call, "
               f"{event_ms(call):.4f} ms per call (CUDA events); under "
               f"cProfile {total:.1f} us per call: "
               + "; ".join(f"{label} {us:.1f}" for label, us in parts[:12])
               + f" — {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_trace needs a CUDA device")
    for line in report(args.calls):
        print(line, flush=True)


if __name__ == "__main__":
    main()
