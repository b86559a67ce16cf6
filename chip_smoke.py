"""Drive the PyTorch port (trino_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines before the next starts:
  1. card: name and power limit, torch/CUDA versions, kernel build time
     (every csrc/*.cu built by nvcc in parallel, plus the Triton kernel);
  2. kernels against their plain PyTorch twins on seeded inputs on the
     card (NULLs, NaN, -0.0, empty pages, all-false masks, ragged
     capacities, duplicate, negative (-1 included), composite and
     out-of-span join keys, an empty build, an all-dead probe, one
     4,194,304-row page; the expanding probe for every join kind on both
     routes, null_aware on and off): integers and masks exact, float64
     sums to 1e-9 relative, GROUP BY results equal as multisets of groups,
     DISTINCT marks one row per distinct key; K10's words bit for bit and
     its permutations exactly on both sides of the one-block threshold
     and at 4,194,304 rows; K11 (generated Triton kernels) against the
     plain compiler over a corpus of every scalar function and special
     form, the string paths, try_cast and the date units;
  3. the 22 TPC-H queries, a FULL join and a MARK query at sf1 and q6, q3,
     q9, q13 at sf10 (spill off: the spilled join is not ported) from SQL
     through LocalQueryRunner.tpch(schema).execute(sql) on cuda, rows held
     equal to the same queries through the port on the CPU; each join's
     kind, route, build live rows, max_run, probe and output rows; no
     filter or project step evaluated by the torch-op compiler and no
     sort by the plain twin on the card;
  4. every kernel, every expanding-probe kind and the dense, search and
     cross routes launched during phase 3; per kernel its launches, its
     time at the main path's shapes (CUDA events; K10 and K11 also their
     host time per call), its bound, its plain twin's time and a one-call
     PyTorch yardstick; each query's warm wall time, idle share and top
     device and host costs. `[time]` lines give each phase's seconds.
The last line is {"ok": true, "device": {...}}. Any failure exits
non-zero before it. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)

# The 22 TPC-H queries of tests/tpch_sql.py, which imports the JAX
# package, so this script carries its own copy (tests/
# test_torch_chip_smoke.py holds the two equal): name -> (SQL, whether
# the rows come in a defined order).
TPCH = {
    "q1": ("""
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""", True),
    "q2": ("""
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey AND p_size = 15
  AND p_type LIKE '%BRASS' AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey AND r_name = 'EUROPE'
  AND ps_supplycost = (SELECT min(ps_supplycost)
                       FROM partsupp, supplier, nation, region
                       WHERE p_partkey = ps_partkey
                         AND s_suppkey = ps_suppkey
                         AND s_nationkey = n_nationkey
                         AND n_regionkey = r_regionkey
                         AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT 100""", True),
    "q3": ("""
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey
LIMIT 10""", True),
    "q4": ("""
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= DATE '1993-07-01'
  AND o_orderdate < DATE '1993-07-01' + INTERVAL '3' MONTH
  AND EXISTS (SELECT * FROM lineitem
              WHERE l_orderkey = o_orderkey
                AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority ORDER BY o_orderpriority""", True),
    "q5": ("""
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA' AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY n_name ORDER BY revenue DESC, n_name""", True),
    "q6": ("""
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
  AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01
  AND l_quantity < 24""", False),
    "q7": ("""
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
             extract(year FROM l_shipdate) AS l_year,
             l_extendedprice * (1 - l_discount) AS volume
      FROM supplier, lineitem, orders, customer, nation n1, nation n2
      WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
        AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
        AND c_nationkey = n2.n_nationkey
        AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
          OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
        AND l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31')
     AS shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year""", True),
    "q8": ("""
SELECT o_year, sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
               / sum(volume) AS mkt_share
FROM (SELECT extract(year FROM o_orderdate) AS o_year,
             l_extendedprice * (1 - l_discount) AS volume,
             n2.n_name AS nation
      FROM part, supplier, lineitem, orders, customer,
           nation n1, nation n2, region
      WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
        AND l_orderkey = o_orderkey AND o_custkey = c_custkey
        AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
        AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey
        AND o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
        AND p_type = 'ECONOMY ANODIZED STEEL') AS all_nations
GROUP BY o_year ORDER BY o_year""", True),
    "q9": ("""
SELECT nation, o_year, sum(amount) AS sum_profit FROM (
  SELECT n_name AS nation, extract(year FROM o_orderdate) AS o_year,
         l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity
           AS amount
  FROM part, supplier, lineitem, partsupp, orders, nation
  WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
    AND ps_partkey = l_partkey AND p_partkey = l_partkey
    AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
    AND p_name LIKE '%green%'
) profit GROUP BY nation, o_year ORDER BY nation, o_year DESC""", True),
    "q10": ("""
SELECT c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND o_orderdate >= DATE '1993-10-01'
  AND o_orderdate < DATE '1993-10-01' + INTERVAL '3' MONTH
  AND l_returnflag = 'R' AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
ORDER BY revenue DESC, c_custkey LIMIT 20""", True),
    "q11": ("""
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
  AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) >
       (SELECT sum(ps_supplycost * ps_availqty) * 0.0001
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY')
ORDER BY value DESC, ps_partkey""", True),
    "q12": ("""
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT'
                 OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END)
         AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT'
                AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
         AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
  AND l_receiptdate >= DATE '1994-01-01'
  AND l_receiptdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY l_shipmode ORDER BY l_shipmode""", True),
    "q13": ("""
SELECT c_count, count(*) AS custdist
FROM (SELECT c_custkey, count(o_orderkey) AS c_count
      FROM customer LEFT OUTER JOIN orders
        ON c_custkey = o_custkey AND o_comment NOT LIKE '%special%'
      GROUP BY c_custkey) AS c_orders
GROUP BY c_count ORDER BY custdist DESC, c_count DESC""", True),
    "q14": ("""
SELECT sum(CASE WHEN p_type LIKE 'PROMO%'
                THEN l_extendedprice * (1 - l_discount) ELSE 0 END) AS promo,
       sum(l_extendedprice * (1 - l_discount)) AS total
FROM lineitem, part
WHERE l_partkey = p_partkey AND l_shipdate >= DATE '1995-09-01'
  AND l_shipdate < DATE '1995-10-01'""", False),
    "q15": ("""
WITH revenue AS (
  SELECT l_suppkey AS supplier_no,
         sum(l_extendedprice * (1 - l_discount)) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= DATE '1996-01-01'
    AND l_shipdate < DATE '1996-01-01' + INTERVAL '3' MONTH
  GROUP BY l_suppkey)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey""", True),
    "q16": ("""
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
  AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
                         WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size""", True),
    "q17": ("""
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey AND p_brand = 'Brand#23'
  AND p_container = 'MED BOX'
  AND l_quantity < (SELECT 0.2 * avg(l_quantity) FROM lineitem
                    WHERE l_partkey = p_partkey)""", False),
    "q18": ("""
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem
                     GROUP BY l_orderkey HAVING sum(l_quantity) > 200)
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate, o_orderkey LIMIT 100""", True),
    "q19": ("""
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem, part
WHERE (p_partkey = l_partkey AND p_brand = 'Brand#12'
       AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       AND l_quantity >= 1 AND l_quantity <= 11
       AND p_size BETWEEN 1 AND 5
       AND l_shipmode IN ('AIR', 'REG AIR')
       AND l_shipinstruct = 'DELIVER IN PERSON')
   OR (p_partkey = l_partkey AND p_brand = 'Brand#23'
       AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       AND l_quantity >= 10 AND l_quantity <= 20
       AND p_size BETWEEN 1 AND 10
       AND l_shipmode IN ('AIR', 'REG AIR')
       AND l_shipinstruct = 'DELIVER IN PERSON')
   OR (p_partkey = l_partkey AND p_brand = 'Brand#34'
       AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       AND l_quantity >= 20 AND l_quantity <= 30
       AND p_size BETWEEN 1 AND 15
       AND l_shipmode IN ('AIR', 'REG AIR')
       AND l_shipinstruct = 'DELIVER IN PERSON')""", False),
    "q20": ("""
SELECT s_name, s_address
FROM supplier, nation
WHERE s_suppkey IN (
    SELECT ps_suppkey FROM partsupp
    WHERE ps_partkey IN (SELECT p_partkey FROM part
                         WHERE p_name LIKE 'forest%')
      AND ps_availqty > (SELECT 0.5 * sum(l_quantity) FROM lineitem
                         WHERE l_partkey = ps_partkey
                           AND l_suppkey = ps_suppkey
                           AND l_shipdate >= DATE '1994-01-01'
                           AND l_shipdate < DATE '1994-01-01'
                                            + INTERVAL '1' YEAR))
  AND s_nationkey = n_nationkey AND n_name = 'CANADA'
ORDER BY s_name""", True),
    "q21": ("""
SELECT s_name, count(*) AS numwait
FROM supplier, lineitem l1, orders, nation
WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
  AND o_orderstatus = 'F' AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (SELECT * FROM lineitem l2
              WHERE l2.l_orderkey = l1.l_orderkey
                AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (SELECT * FROM lineitem l3
                  WHERE l3.l_orderkey = l1.l_orderkey
                    AND l3.l_suppkey <> l1.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
  AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT 100""", True),
    "q22": ("""
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal
      FROM customer
      WHERE substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30')
        AND c_acctbal > (SELECT avg(c_acctbal) FROM customer
                         WHERE c_acctbal > 0.00)
        AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey))
     AS custsale
GROUP BY cntrycode ORDER BY cntrycode""", True),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 20) -> float:
    """Median milliseconds of `fn()` over `iters` runs, CUDA events."""
    for _ in range(3):
        fn()
    sync()
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


def device_profile(fn, iters: int = 10):
    """(device-busy ms per call, top kernels) of `fn` from torch.profiler:
    the sum of the device time of every kernel and copy it ran. None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    # device-side events only (kernels, copies): an operator's entry
    # repeats the device time of the kernels it launched
    rows = [(getattr(e, "self_device_time_total", 0.0), e.key)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_us = sum(t for t, _ in rows)
    if total_us <= 0:
        return None, []
    top = sorted(rows, reverse=True)[:6]
    return total_us / iters / 1e3, [(k, t / iters / 1e3) for t, k in top]


def host_profile(fn, iters: int = 3, top: int = 12) -> str:
    """The functions with the most host self time per call of `fn`
    (cProfile), as 'file:line(function) ms' items."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    sync()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, fl) for fl, (_, _, tt, _, _) in stats.items()),
                  reverse=True)[:top]
    return ", ".join(f"{os.path.basename(f)}:{ln}({name}) "
                     f"{tt / iters * 1e3:.3f} ms"
                     for tt, (f, ln, name) in rows)


# ------------------------------------------------------------ comparisons


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype in (torch.float64, torch.int64):
        return torch.equal(x.view(torch.int64), y.view(torch.int64))
    return torch.equal(x, y)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    d = (x.to(torch.float64) - y.to(torch.float64)).abs()
    d = torch.where(torch.isnan(x.to(torch.float64))
                    & torch.isnan(y.to(torch.float64)),
                    torch.zeros_like(d), d)
    return float(d.max())


def close_f64(x: torch.Tensor, y: torch.Tensor, rel: float = 1e-9) -> bool:
    both_nan = torch.isnan(x) & torch.isnan(y)
    same = (x == y) | both_nan
    tol = rel * torch.maximum(x.abs(), y.abs())
    return bool((same | ((x - y).abs() <= tol)).all())


# ----------------------------------------------------------- phase 2 data


def rng_page_arrays(g: torch.Generator, cap: int, dev):
    """Seeded columns of every element size, with NaN and -0.0."""
    ints = torch.randint(-2**62, 2**62, (cap,), generator=g,
                         dtype=torch.int64)
    f = torch.randn(cap, generator=g, dtype=torch.float64) * 1e3
    if cap >= 4:
        f[::7] = float("nan")
        f[1::11] = -0.0
        f[2::13] = 0.0
    i32 = torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                        dtype=torch.int32)
    valid = torch.rand(cap, generator=g) < 0.8
    i16 = torch.randint(-2**15, 2**15 - 1, (cap,), generator=g,
                        dtype=torch.int16)
    return [t.to(dev) for t in (ints, f, i32, valid, i16)]


def check_compact(g, dev) -> float:
    from trino_tpu_torch import page as P
    cases = [(0, 0, 0.5), (1, 1, 1.0), (4095, 4000, 0.5), (4096, 4096, 0.0),
             (4097, 4097, 1.0), (5000, 3000, 0.3), (100_003, 99_999, 0.01),
             (4_194_304, 4_194_304, 0.02)]
    for cap, n, p in cases:
        arrays = rng_page_arrays(g, cap, dev)
        mask = (torch.rand(cap, generator=g) < p).to(dev)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        got, cnt = P.compact_rows_cuda(arrays, mask, num_rows)
        sync()
        want, wcnt = P.compact_rows_plain(arrays, mask, num_rows)
        k = int(wcnt)
        if int(cnt) != k:
            fail(f"K1 count cap={cap}: {int(cnt)} != {k}")
        for a, b in zip(got, want):
            if not same_bits(a[:k], b[:k]):
                fail(f"K1 rows differ at cap={cap} dtype={a.dtype}")
    return 0.0   # compared bit for bit


def check_concat(g, dev) -> float:
    from trino_tpu_torch import page as P
    layouts = [[(10, 3), (0, 0), (4097, 4097), (5, 0)],
               [(2048, 2000), (2049, 1), (1, 1)],
               [(12, 4), (12, 4)],
               [(4_194_304, 4_000_000), (1_805_652, 1_805_652)]]
    for layout in layouts:
        arrays, counts = [], []
        for i, (cap, n) in enumerate(layout):
            ints, f, i32, valid, _ = rng_page_arrays(g, cap, dev)
            arrays.append([ints, f, i32, valid if i % 2 == 0 else None])
            counts.append(torch.tensor(n, dtype=torch.int32, device=dev))
        out_cap = sum(c for c, _ in layout)
        got, tot = P.concat_rows_cuda(arrays, counts, out_cap)
        sync()
        want, wtot = P.concat_rows_plain(arrays, counts, out_cap)
        k = int(wtot)
        if int(tot) != k:
            fail(f"K2 total {int(tot)} != {k}")
        for a, b in zip(got, want):
            if not same_bits(a[:k], b[:k]):
                fail(f"K2 rows differ for layout {layout}")
    return 0.0   # compared bit for bit


def agg_states(g, cap, dev, with_masks=True):
    from trino_tpu_torch.ops import aggregate as A
    ints = torch.randint(-10**9, 10**9, (cap,), generator=g,
                         dtype=torch.int64).to(dev)
    pos = (torch.rand(cap, generator=g, dtype=torch.float64) * 1e3).to(dev)
    f = torch.randn(cap, generator=g, dtype=torch.float64).to(dev)
    if cap >= 4:
        f[::997] = float("nan")
        f[1::5] = -0.0
        f[2::7] = 0.0
    valid = (torch.rand(cap, generator=g) < 0.9).to(dev)
    mask = (torch.rand(cap, generator=g) < 0.7).to(dev) if with_masks \
        else None
    S = A.StateInput
    return [S(ints, valid, None, A.SUM, False),
            S(pos, valid, mask, A.SUM, True),
            S(None, valid, mask, A.COUNT, False),
            S(ints, None, mask, A.MIN, False),
            S(ints, valid, None, A.MAX, False),
            S(f, valid, None, A.MIN, True),
            S(f, None, mask, A.MAX, True)]


def compare_states(label, states, got, want) -> float:
    worst = 0.0
    for s, a, b in zip(states, got, want):
        if s.is_float and s.kind == 0:
            if not close_f64(a, b):
                fail(f"{label}: float sum beyond 1e-9 relative")
            worst = max(worst, max_abs_err(a, b))
        elif not same_bits(a, b):
            fail(f"{label}: state kind {s.kind} float={s.is_float} differs")
    return worst


def check_direct(g, dev) -> float:
    from trino_tpu_torch.ops import aggregate as A
    worst = 0.0
    # (4, 3): 32 per-lane tables in shared memory; (17, 16): one shared
    # table; (64, 64): atomics on the global table
    for cap, n, sizes in [(0, 0, (4, 3)), (5000, 4321, (4, 3)),
                          (50_000, 49_000, (17, 16)),
                          (100_000, 100_000, (64, 64)),
                          (4_194_304, 4_100_000, (4, 3))]:
        keys = []
        stride = 1
        for s in sizes:
            stride *= s
        for size in sizes:
            stride //= size
            codes = torch.randint(-1, size, (cap,), generator=g,
                                  dtype=torch.int32).to(dev)
            kv = (torch.rand(cap, generator=g) < 0.95).to(dev)
            keys.append(A.KeyInput(codes, kv, size, stride))
        nseg = 1
        for s in sizes:
            nseg *= s
        states = agg_states(g, cap, dev)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        slots, got, ng = A.direct_reduce_cuda(keys, states, num_rows, nseg)
        sync()
        wslots, want, wng = A.direct_reduce_plain(keys, states, num_rows,
                                                  nseg)
        k = int(wng)
        if int(ng) != k or not torch.equal(slots[:k], wslots[:k]):
            fail(f"K3 groups differ at cap={cap} sizes={sizes}")
        worst = max(worst, compare_states(
            f"K3 cap={cap}", states, [x[:k] for x in got],
            [x[:k] for x in want]))
    return worst


def check_global(g, dev) -> float:
    from trino_tpu_torch.ops import aggregate as A
    worst = 0.0
    for cap, n in [(0, 0), (1, 1), (4097, 10), (100_003, 100_003),
                   (4_194_304, 4_194_304)]:
        states = agg_states(g, cap, dev)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        got = A.global_reduce_triton(states, num_rows, cap)
        sync()
        want = A.global_reduce_plain(states, num_rows, cap)
        worst = max(worst, compare_states(f"K4 cap={cap}", states, got,
                                          want))
    return worst


def check_range(g, dev) -> float:
    """K1's range mode (range_prefilter) against its twin."""
    from trino_tpu_torch import page as P
    for cap, n, kind in [(0, 0, "i64"), (1, 1, "f64"), (5000, 4000, "i32"),
                         (100_003, 99_999, "f64"),
                         (4_194_304, 4_194_304, "i64")]:
        arrays = rng_page_arrays(g, cap, dev)
        key = {"i64": arrays[0], "f64": arrays[1], "i32": arrays[2]}[kind]
        key_valid = arrays[3]
        if cap:
            lo, hi = torch.sort(key[torch.randint(0, cap, (2,),
                                                  generator=g).to(dev)])[0]
        else:
            lo = hi = torch.zeros((), dtype=key.dtype, device=dev)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        got, cnt = P.compact_range_cuda(arrays, key, key_valid, lo, hi,
                                        num_rows)
        sync()
        want, wcnt = P.compact_range_plain(arrays, key, key_valid, lo, hi,
                                           num_rows)
        k = int(wcnt)
        if int(cnt) != k:
            fail(f"K1 range count cap={cap} {kind}: {int(cnt)} != {k}")
        for a, b in zip(got, want):
            if not same_bits(a[:k], b[:k]):
                fail(f"K1 range rows differ at cap={cap} {kind}")
    return 0.0   # compared bit for bit


def check_gather(g, dev) -> float:
    """K7 against its twin, indices past both ends included."""
    from trino_tpu_torch import page as P
    for cap, n in [(1, 5), (5000, 7000), (4097, 0),
                   (4_194_304, 4_194_304)]:
        arrays = rng_page_arrays(g, cap, dev)
        idx = torch.randint(-3, cap + 3, (n,), generator=g).to(dev)
        got = P.gather_rows_cuda(arrays, idx)
        sync()
        want = P.gather_rows_plain(arrays, idx)
        for a, b in zip(got, want):
            if not same_bits(a, b):
                fail(f"K7 rows differ at cap={cap} n={n} dtype={a.dtype}")
    return 0.0   # compared bit for bit


def join_case(g, dev, kind, cap, n, dup=False, null_frac=0.1):
    """Build-side key columns (values, valid) of one join test case."""
    if kind == "dense":      # a shuffled dense span, like an orderkey
        v = (torch.randperm(cap, generator=g) * 4 + 1000).to(torch.int64)
    elif kind == "negative":  # sparse keys over all of int64
        v = torch.randint(-2**62, 2**62, (cap,), generator=g,
                          dtype=torch.int64) * 2
    else:                     # composite: (int32, int64)
        v = torch.randint(0, 50, (cap,), generator=g, dtype=torch.int32)
    if dup and cap > 8:
        v[cap // 2:cap // 2 + 5] = v[0]
    valid = torch.rand(cap, generator=g) >= null_frac
    cols = [(v.to(dev), valid.to(dev))]
    if kind == "composite":
        w = torch.arange(cap, dtype=torch.int64) * 7 - cap
        if dup and cap > 8:
            w[cap // 2:cap // 2 + 5] = w[0]
        cols.append((w.to(dev), None))
    return cols


def probe_cols(g, build_cols, cap, dev, hit=0.6):
    """Probe key columns drawn from the build keys (hits) and from keys
    outside them (misses), with NULLs."""
    out = []
    bcap = build_cols[0][0].shape[0]
    pick = torch.randint(0, max(bcap, 1), (cap,), generator=g).to(dev)
    miss = (torch.rand(cap, generator=g) >= hit).to(dev)
    for values, _ in build_cols:
        if bcap:
            v = values[pick]
        else:
            v = torch.zeros(cap, dtype=values.dtype, device=dev)
        other = torch.randint(-10**6, 10**6, (cap,), generator=g).to(dev) \
            .to(values.dtype)
        out.append((torch.where(miss, other, v).contiguous(),
                    (torch.rand(cap, generator=g) >= 0.05).to(dev)))
    return out


def check_join(g, dev) -> float:
    """K5 (statistics, hash table, dense table) and K6 (both routes)
    against their twins."""
    from trino_tpu_torch.ops import join as J
    cases = [("dense", 5000, 4900, False, 6000, 5990),
             ("dense", 20_000, 20_000, True, 100, 100),
             ("negative", 30_000, 29_000, False, 70_000, 65_000),
             ("composite", 4096, 4096, False, 9000, 9000),
             ("composite", 3000, 3000, True, 10, 10),
             ("dense", 1000, 0, False, 500, 500),           # empty build
             ("negative", 1000, 1000, False, 500, 0),       # dead probe
             ("dense", 147_456, 147_000, False, 4_194_304, 4_194_304)]
    for kind, bcap, bn, dup, pcap, pn in cases:
        label = f"{kind} build {bn}/{bcap} probe {pn}/{pcap} dup={dup}"
        bcols = join_case(g, dev, kind, bcap, bn, dup)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        stats, lookup = J.join_build_cuda(bcols, bnr)
        sync()
        wstats, wlookup = J.join_build_plain(bcols, bnr)
        if not torch.equal(stats, wstats):
            fail(f"K5 statistics differ ({label}):\n{stats.tolist()}\n"
                 f"{wstats.tolist()}")
        if dup and int(stats[J.MAX_RUN]) < 2:
            fail(f"K5 missed the duplicate keys ({label})")
        if not hash_table_ok(bcols, bnr, lookup):
            fail(f"K5 hash table does not hold the build keys ({label})")
        kmin, kmax = (J.unsigned(int(stats[J.KMIN])),
                      J.unsigned(int(stats[J.KMAX])))
        routes = ["search"]
        if kmax >= kmin and kmax - kmin < (1 << 22):
            routes.append("dense")
        pcols = probe_cols(g, bcols, pcap, dev)
        pnr = torch.tensor(pn, dtype=torch.int32, device=dev)
        for route in routes:
            prep = J.Prepared(None, (), stats, lookup)
            wprep = J.Prepared(None, (), wstats, wlookup)
            if route == "dense":
                size = 1 << max(10, (kmax - kmin).bit_length())
                table = J.join_dense_cuda(bcols, bnr, stats, size)
                sync()
                wtable = J.join_dense_plain(bcols, bnr, wstats, size)
                if not torch.equal(table, wtable):
                    fail(f"K5 dense table differs ({label})")
                prep.dense, wprep.dense = table, wtable
            f, b, c = J.unique_probe_cuda(pcols, bcols, pnr, prep)
            sync()
            wf, wb, wc = J.unique_probe_plain(pcols, bcols, pnr, wprep)
            if int(c) != int(wc) or not torch.equal(f, wf):
                fail(f"K6 {route} found/count differ ({label}): "
                     f"{int(c)} vs {int(wc)}")
            if not dup and not torch.equal(b, wb):
                fail(f"K6 {route} build rows differ ({label})")
    return 0.0   # compared exactly


def lexsort_rows(cols):
    """Permutation ordering rows by int64 columns, first most major."""
    perm = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def compare_groups(label, states, got, want) -> float:
    """K8 output against its twin as multisets of groups: canonical keys
    equal, states as compare_states holds them."""
    from trino_tpu_torch.ops import aggregate as A
    (kv, km, res, ng), (wkv, wkm, wres, wng) = got, want
    k = int(wng)
    if int(ng) != k:
        fail(f"{label}: {int(ng)} groups != {k}")
    sides = []
    for vals, valids, results in ((kv, km, res), (wkv, wkm, wres)):
        canon = []
        for v, m in zip(vals, valids):
            canon += list(A._canonical(A.GroupKey(
                v[:k], None if m is None else m[:k])))
        canon = [c.to(torch.int64) for c in canon]
        perm = lexsort_rows(canon) if canon and k else \
            torch.arange(k, device=res[0].device if res else None)
        sides.append(([c[perm] for c in canon],
                      [r[:k][perm] for r in results]))
    if not all(torch.equal(a, b) for a, b in zip(sides[0][0], sides[1][0])):
        fail(f"{label}: group keys differ")
    return compare_states(label, states, sides[0][1], sides[1][1])


def group_keys(g, cap, dev, ngroups):
    from trino_tpu_torch.ops import aggregate as A
    big = torch.randint(0, max(ngroups, 1), (cap,), generator=g,
                        dtype=torch.int64) * 1_000_003 - 2**40
    f = torch.randint(0, 6, (cap,), generator=g).to(torch.float64) - 2.5
    if cap >= 8:
        f[::5] = float("nan")
        f[1::7] = -0.0
        f[2::9] = 0.0
    code = torch.randint(0, 4, (cap,), generator=g, dtype=torch.int32)
    return [A.GroupKey(big.to(dev), (torch.rand(cap, generator=g) >= 0.05)
                       .to(dev)),
            A.GroupKey(f.to(dev), (torch.rand(cap, generator=g) >= 0.1)
                       .to(dev)),
            A.GroupKey(code.to(dev), None)]


def check_group(g, dev) -> float:
    """K8 against its twin: NULL, NaN, -0.0 and +0.0 keys, integer and
    dictionary-code keys, few and many groups."""
    from trino_tpu_torch.ops import aggregate as A
    worst = 0.0
    for cap, n, ngroups in [(0, 0, 1), (1, 1, 1), (5000, 4321, 3),
                            (100_000, 99_000, 50_000),
                            (4_194_304, 4_000_000, 1_000_000)]:
        keys = group_keys(g, cap, dev, ngroups)
        states = agg_states(g, cap, dev)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        got = A.group_reduce_cuda(keys, states, num_rows, cap)
        sync()
        want = A.group_reduce_plain(keys, states, num_rows, cap)
        worst = max(worst, compare_groups(f"K8 cap={cap}", states, got,
                                          want))
    return worst


def runs_case(g, dev, kind, cap, n):
    """Build-side key columns with duplicate keys: a dense span with runs
    of up to 40 (`dense`), sparse keys over all of int64 with a live -1
    (`negative`), duplicate (int32, int64) pairs (`composite`)."""
    if kind == "dense":
        v = (torch.randint(0, max(cap // 4, 1), (cap,), generator=g) * 3
             + 100).to(torch.int64)
        if cap > 100:
            v[:40] = v[0]           # one run of at least 40
    elif kind == "negative":
        pool = torch.randint(-2**62, 2**62, (max(cap // 3, 1),),
                             generator=g, dtype=torch.int64)
        v = pool[torch.randint(0, pool.numel(), (cap,), generator=g)]
        v[::5] = -1
    else:
        v = torch.randint(0, 7, (cap,), generator=g, dtype=torch.int32)
    valid = torch.rand(cap, generator=g) >= 0.05
    cols = [(v.to(dev), valid.to(dev))]
    if kind == "composite":
        w = torch.randint(0, max(cap // 20, 1), (cap,), generator=g,
                          dtype=torch.int64)
        cols.append((w.to(dev), None))
    return cols


def built_pair(cols, bnr, size):
    """(kernel Prepared, twin Prepared) of one build with runs."""
    from trino_tpu_torch.ops import join as J
    stats, lookup = J.join_build_cuda(cols, bnr)
    runs, dense = J.join_runs_cuda(cols, bnr, stats, lookup, size)
    wstats, wlookup = J.join_build_plain(cols, bnr)
    wruns, wdense = J.join_runs_plain(cols, bnr, wstats, wlookup, size)
    return (J.Prepared(None, (), stats, lookup, dense, runs),
            J.Prepared(None, (), wstats, wlookup, wdense, wruns))


def dense_size(stats) -> int:
    from trino_tpu_torch.ops import join as J
    kmin = J.unsigned(int(stats[J.KMIN]))
    kmax = J.unsigned(int(stats[J.KMAX]))
    if kmax < kmin or kmax - kmin >= (1 << 22):
        return 0
    return 1 << max(10, (kmax - kmin).bit_length())


def runs_by_key(prep, twin: bool):
    """(key, build row) pairs of a Prepared's runs, in layout order."""
    runs, start, count = prep.runs
    if twin:
        keys = prep.lookup[1]
        occ = torch.ones_like(keys, dtype=torch.bool)
    else:
        occ = prep.lookup[2] >= 0
        keys = prep.lookup[1][occ]
    counts = count[occ].to(torch.int64) if not twin else count.to(
        torch.int64)
    total = int(counts.sum())
    return torch.repeat_interleave(keys, counts), runs[:total].to(
        torch.int64)


def runs_ok(label, kprep, wprep) -> None:
    """K5's runs mode holds the twin's rows per key, each run ascending;
    its dense table names the same keys as the twin's."""
    kk, kr = runs_by_key(kprep, False)
    wk, wr = runs_by_key(wprep, True)
    if kk.numel() != wk.numel():
        fail(f"K5 runs mode laid out {kk.numel()} rows, twin "
             f"{wk.numel()} ({label})")
    ascending = (kr[1:] > kr[:-1]) | (kk[1:] != kk[:-1])
    if kk.numel() > 1 and not bool(ascending.all()):
        fail(f"K5 runs mode: a run is not in ascending row order ({label})")
    p, q = lexsort_rows([kk, kr]), lexsort_rows([wk, wr])
    if not (torch.equal(kk[p], wk[q]) and torch.equal(kr[p], wr[q])):
        fail(f"K5 runs mode rows per key differ from the twin ({label})")
    if kprep.dense is not None:
        from trino_tpu_torch.ops import join as J
        kmin = kprep.stats[J.KMIN]
        d = torch.arange(kprep.dense.numel(), device=kr.device)
        kin = kprep.dense != 2**31 - 1
        win = wprep.dense != 2**31 - 1
        if not torch.equal(kin, win) or not torch.equal(
                kprep.lookup[1][kprep.dense[kin].long()],
                wprep.lookup[1][wprep.dense[win].long()]) or not torch.equal(
                kprep.lookup[1][kprep.dense[kin].long()], (d + kmin)[kin]):
            fail(f"K5 runs-mode dense table differs ({label})")


EXPAND_CASES = [  # kind, build cap, live, probe cap, live
    ("dense", 5000, 4900, 6000, 5990),
    ("negative", 30_000, 29_000, 70_000, 65_000),
    ("composite", 4096, 4096, 9000, 9000),
    ("dense", 1000, 0, 500, 500),               # empty build
    ("negative", 1000, 1000, 500, 0),           # dead probe
    ("dense", 147_456, 147_000, 4_194_304, 4_194_304)]


def check_runs(g, dev) -> float:
    """K5 runs mode (and its dense table) against its twin."""
    from trino_tpu_torch.ops import join as J
    for kind, bcap, bn, *_ in EXPAND_CASES:
        cols = runs_case(g, dev, kind, bcap, bn)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        stats, _ = J.join_build_cuda(cols, bnr)
        for size in sorted({0, dense_size(stats)}):
            kprep, wprep = built_pair(cols, bnr, size)
            sync()
            runs_ok(f"{kind} build {bn}/{bcap} dense {size}", kprep, wprep)
    return 0.0   # compared exactly


def check_expand(g, dev) -> float:
    """K9 for every kind on both routes against its twins: launch A's
    counts and total, launch B's (probe row, build row) pairs and FULL's
    build_matched, the SEMI/ANTI/MARK verdicts with null_aware on and
    off. Runs hold equal rows per key in the same order, so every result
    is compared exactly."""
    from trino_tpu_torch.ops import join as J
    K = J.JoinType
    for kind, bcap, bn, pcap, pn in EXPAND_CASES:
        bcols = runs_case(g, dev, kind, bcap, bn)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        stats, _ = J.join_build_cuda(bcols, bnr)
        pcols = probe_cols(g, bcols, pcap, dev)
        pnr = torch.tensor(pn, dtype=torch.int32, device=dev)
        for size in sorted({0, dense_size(stats)}):
            label = f"{kind} build {bn}/{bcap} probe {pn}/{pcap} " \
                    f"dense {size}"
            kprep, wprep = built_pair(bcols, bnr, size)
            for jk in (K.INNER, K.LEFT, K.FULL):
                c = J.expand_count_cuda(pcols, bcols, pnr, kprep, jk)
                w = J.expand_count_plain(pcols, bcols, pnr, wprep, jk)
                sync()
                if int(c.total) != int(w.total) or not torch.equal(
                        c.emit, w.emit) or not torch.equal(c.cand_len,
                                                           w.cand_len):
                    fail(f"K9 {jk} counts differ ({label}): "
                         f"{int(c.total)} vs {int(w.total)}")
                out_cap = max(int(w.total), 1)
                m = torch.zeros(bcap, dtype=torch.bool, device=dev)
                wm = torch.zeros(bcap, dtype=torch.bool, device=dev)
                p, b = J.expand_write_cuda(pcols, bcols, c, jk, out_cap, m)
                wp, wb = J.expand_write_plain(pcols, bcols, w, jk, out_cap,
                                              wm)
                sync()
                t = int(w.total)
                if not (torch.equal(p[:t], wp[:t])
                        and torch.equal(b[:t], wb[:t])):
                    fail(f"K9 {jk} output rows differ ({label})")
                if jk == K.FULL and not torch.equal(m, wm):
                    fail(f"K9 full build_matched differs ({label})")
            for jk in (K.SEMI, K.ANTI, K.MARK):
                for null_aware in (True, False):
                    f, f2 = J.probe_verdict_cuda(pcols, bcols, pnr, kprep,
                                                 jk, null_aware)
                    wf, wf2 = J.probe_verdict_plain(pcols, bcols, pnr,
                                                    wprep, jk, null_aware)
                    sync()
                    if not torch.equal(f, wf) or (
                            f2 is not None and not torch.equal(f2, wf2)):
                        fail(f"K9 {jk} null_aware={null_aware} verdict "
                             f"differs ({label})")
    return 0.0   # compared exactly


def check_distinct(g, dev) -> float:
    """K8's distinct mode against its twin: exactly one marked row per
    distinct canonical (keys, argument) among the eligible rows (which row
    of a pair is free: they are equal under the canonical rules)."""
    from trino_tpu_torch.ops import aggregate as A
    for cap, ngroups in [(0, 1), (1, 1), (5000, 3), (100_000, 50_000),
                         (4_194_304, 1_000_000)]:
        keys = group_keys(g, cap, dev, ngroups)[:2]
        arg = torch.randint(0, 50, (cap,), generator=g).to(torch.float64)
        if cap >= 8:
            arg[::6] = float("nan")
            arg[1::8] = -0.0
            arg[2::9] = 0.0
        keys.append(A.GroupKey(arg.to(dev), None))
        eligible = ((torch.rand(cap, generator=g) < 0.9)
                    & (torch.arange(cap) < cap - cap // 10)).to(dev)
        mark = A.distinct_mask_cuda(keys, eligible)
        sync()
        want = A.distinct_mask_plain(keys, eligible)
        canon = [p.to(torch.int64) for k in keys for p in A._canonical(k)]
        rows = torch.stack(canon, 1) if cap else torch.zeros(
            0, len(canon), dtype=torch.int64, device=dev)
        n_marked = int(mark.sum())
        distinct = torch.unique(rows[mark], dim=0).shape[0] if n_marked \
            else 0
        if bool((mark & ~eligible).any()) or n_marked != int(want.sum()) \
                or distinct != n_marked:
            fail(f"K8 distinct mode marks {n_marked} rows ({distinct} "
                 f"distinct), twin {int(want.sum())} (cap={cap})")
    return 0.0   # compared exactly


# ------------------------------------------------- phase 2: K10 and K11

CORPUS_ROWS = 4096       # the expression corpus page: cap, live rows
CORPUS_LIVE = 4093


def corpus_page(device):
    """Seeded columns of every type the expression corpus reads, with
    NULLs, NaN, +-0.0, +-inf, zero and -1 divisors, INT64_MIN, decimal
    half cases (x.x5), dates before 1970 and month ends, two dictionaries
    over different pools."""
    import numpy as np
    from trino_tpu_torch import types as T
    from trino_tpu_torch.page import Page, row_count
    rng = np.random.default_rng(20261017)
    n = CORPUS_ROWS

    def pick(values, size=n):
        return np.asarray(values)[rng.integers(0, len(values), size)]

    def some(values, frac):
        """Random values with `values` planted in a fraction of rows."""
        out = rng.integers(-10**6, 10**6, n)
        hit = rng.random(n) < frac
        out[hit] = pick(values)[hit]
        return out

    i64 = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, 2, -7]
    floats = [np.nan, -0.0, 0.0, np.inf, -np.inf, 2.5, -2.5, 0.5, -1.5,
              1e300, -3.75]
    x = np.where(rng.random(n) < 0.3, pick(floats),
                 rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n))
    pools = {"s": ["", "BRASS", "COPPER", "MAIL", "PROMO BRUSHED TIN",
                   "STEEL", "a_b%c", "Rail 5"],
             "s2": ["AIR", "COPPER", "FOB", "SHIP", "TRUCK"],
             "num": ["12", " 7 ", "abc", "1.5", "-3", "1998-12-01",
                     "true", "9223372036854775807", "1e3"]}
    cols = {
        "b": (some(i64, 0.3).astype(np.int64), T.BIGINT, 0.85),
        "b2": (pick([0, -1, 1, 2, 3, -5, 7, 1 << 40]).astype(np.int64),
               T.BIGINT, 0.9),
        "i": (some([-(1 << 31), -1, 0, 1, (1 << 31) - 1], 0.2)
              .astype(np.int32), T.INTEGER, 0.9),
        "m": (rng.integers(-30, 30, n).astype(np.int32), T.INTEGER, None),
        "x": (x.astype(np.float64), T.DOUBLE, 0.9),
        "y": ((rng.random(n) * 20 - 5).astype(np.float64), T.DOUBLE, None),
        "r": ((rng.normal(size=n) * 100).astype(np.float32), T.REAL, 0.9),
        "d2": (np.where(rng.random(n) < 0.4, pick([125, -125, 150, -150, 5,
                                                   -5, 0, 49, -51]),
                        rng.integers(-10**9, 10**9, n)).astype(np.int64),
               T.DecimalType(12, 2), 0.9),
        "d4": (np.where(rng.random(n) < 0.4,
                        pick([12_345, -12_345, 5_000, -5_000, 50, -50]),
                        rng.integers(-10**11, 10**11, n)).astype(np.int64),
               T.DecimalType(15, 4), None),
        "dt": (np.where(rng.random(n) < 0.3,
                        pick([-1, 0, 59, 789, 10_956, -25_567, 11_016,
                              11_047, -719_162 + 366]),
                        rng.integers(-40_000, 40_000, n)).astype(np.int32),
               T.DATE, 0.9),
        "dt2": (rng.integers(-20_000, 30_000, n).astype(np.int32), T.DATE,
                None),
        "ts": ((rng.integers(-20_000, 30_000, n) * 86_400_000_000
                + rng.integers(0, 86_400_000_000, n)).astype(np.int64),
               T.TIMESTAMP, 0.9),
        "p": (rng.random(n) < 0.5, T.BOOLEAN, 0.7),
        "q": (rng.random(n) < 0.5, T.BOOLEAN, None),
        "sh": (rng.integers(-3, 70, n).astype(np.int64), T.BIGINT, None),
        "s": (pick(pools["s"]).astype(object), T.VARCHAR, 0.9),
        "s2": (pick(pools["s2"]).astype(object), T.VARCHAR, None),
        "num": (pick(pools["num"]).astype(object), T.VARCHAR, 0.95),
    }
    names = list(cols)
    arrays = [cols[k][0] for k in names]
    typs = [cols[k][1] for k in names]
    valids = [None if cols[k][2] is None else rng.random(n) < cols[k][2]
              for k in names]
    page = Page.from_numpy(arrays, typs, valids=valids, device=device)
    return Page(page.columns, row_count(CORPUS_LIVE, device)), names


def expr_corpus(names):
    """(case name, step mode, expression) over corpus_page's columns: every
    scalar function of expr/functions.py, the special forms, the string
    and dictionary paths, try_cast, the date unit calls and a padded IN
    list (once hoisted)."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr.ir import (Call, InputRef, Literal,
                                         SpecialForm, SpecialKind)
    from trino_tpu_torch.page import Page  # noqa: F401 (types of the page)
    typ = {"b": T.BIGINT, "b2": T.BIGINT, "i": T.INTEGER, "m": T.INTEGER,
           "x": T.DOUBLE, "y": T.DOUBLE, "r": T.REAL,
           "d2": T.DecimalType(12, 2), "d4": T.DecimalType(15, 4),
           "dt": T.DATE, "dt2": T.DATE, "ts": T.TIMESTAMP, "p": T.BOOLEAN,
           "q": T.BOOLEAN, "sh": T.BIGINT, "s": T.VARCHAR, "s2": T.VARCHAR,
           "num": T.VARCHAR}
    B, D, BOOL, V = T.BIGINT, T.DOUBLE, T.BOOLEAN, T.VARCHAR
    DEC = T.DecimalType

    def c(name):
        return InputRef(names.index(name), typ[name])

    def lit(v, t):
        return Literal(v, t)

    def f(name, t, *args):
        return Call(name, tuple(args), t)

    def sf(kind, t, *args):
        return SpecialForm(getattr(SpecialKind, kind), tuple(args), t)

    x, y, b, b2, i = c("x"), c("y"), c("b"), c("b2"), c("i")
    d2, d4, dt, s = c("d2"), c("d4"), c("dt"), c("s")
    cases = {
        # arithmetic, Java integer semantics, decimals
        "add_bigint_int": f("add", B, b, i),
        "add_decimal_scales": f("add", DEC(16, 4), d2, d4),
        "subtract_decimal": f("subtract", DEC(13, 2), d2, d2),
        "subtract_double": f("subtract", D, x, y),
        "multiply_wrap": f("multiply", B, b, b2),
        "multiply_decimal_half_up": f("multiply", DEC(18, 4), d2, d4),
        "divide_zero_and_min": f("divide", B, b, b2),
        "divide_int_literal_zero": f("divide", T.INTEGER, i,
                                     lit(0, T.INTEGER)),
        "divide_decimal": f("divide", DEC(12, 2), d2, d4),
        "divide_decimal_up": f("divide", DEC(18, 6), d4, d2),
        "divide_double": f("divide", D, x, y),
        "modulus_zero": f("modulus", B, b, b2),
        "modulus_double": f("modulus", D, x, y),
        "negate_bigint": f("negate", B, b),
        "negate_double": f("negate", D, x),
        "bitwise_and": f("bitwise_and", B, b, b2),
        "bitwise_or": f("bitwise_or", B, b, i),
        "bitwise_xor": f("bitwise_xor", B, b, b2),
        "bitwise_not": f("bitwise_not", B, i),
        "left_shift": f("bitwise_left_shift", B, b, c("sh")),
        "logical_right_shift": f("bitwise_right_shift", B, b, c("sh")),
        "arithmetic_right_shift": f("bitwise_right_shift_arithmetic", B, b,
                                    c("sh")),
        "bit_count_64": f("bit_count", B, b, lit(64, B)),
        "bit_count_col": f("bit_count", B, b, c("sh")),
        "width_bucket": f("width_bucket", B, x, lit(-20.0, D),
                          lit(20.0, D), lit(8, B)),
        # comparisons
        "eq_mixed_ints": f("eq", BOOL, b, i),
        "ne_doubles": f("ne", BOOL, x, y),
        "lt_decimals": f("lt", BOOL, d2, lit(125, DEC(12, 2))),
        "le_dates": f("le", BOOL, dt, c("dt2")),
        "gt_nan": f("gt", BOOL, x, lit(0.0, D)),
        "ge_int": f("ge", BOOL, i, lit(-1, T.INTEGER)),
        # math
        "abs_bigint": f("abs", B, b),
        "abs_double": f("abs", D, x),
        "ceil_decimal": f("ceil", B, d4),
        "ceil_double": f("ceil", D, x),
        "floor_decimal": f("floor", B, d2),
        "floor_double": f("floor", D, x),
        "round_decimal": f("round", B, d2),
        "round_double": f("round", D, x),
        "round_int": f("round", T.INTEGER, i),
        "round_digits_double": f("round_digits", D, x, lit(2, T.INTEGER)),
        "round_digits_decimal": f("round_digits", DEC(15, 4), d4,
                                  lit(1, T.INTEGER)),
        "round_digits_int": f("round_digits", B, b, lit(-2, T.INTEGER)),
        "round_digits_col": f("round_digits", D, y, c("m")),
        "sqrt_double": f("sqrt", D, x),
        "sqrt_bigint": f("sqrt", D, b2),
        "power_double": f("power", D, x, y),
        "power_int": f("power", B, b2, lit(3, B)),
        "exp": f("exp", D, y),
        "ln": f("ln", D, x),
        "log10": f("log10", D, y),
        "log2": f("log2", D, b2),
        "log": f("log", D, y, x),
        "cbrt": f("cbrt", D, x),
        "radians": f("radians", D, x),
        "degrees": f("degrees", D, y),
        "atan2": f("atan2", D, x, y),
        **{fn: f(fn, D, x) for fn in ("sin", "cos", "tan", "atan", "sinh",
                                      "cosh", "tanh")},
        "asin": f("asin", D, f("divide", D, y, lit(15.0, D))),
        "acos": f("acos", D, f("divide", D, x, lit(8.0, D))),
        "pi_plus": f("add", D, x, f("pi", D)),
        "e_times": f("multiply", D, y, f("e", D)),
        "truncate": f("truncate", D, x),
        "truncate_digits": f("truncate", D, y, lit(1, T.INTEGER)),
        "sign_double": f("sign", D, x),
        "sign_int": f("sign", T.INTEGER, i),
        "greatest_ints": f("greatest", B, b, i, lit(3, B)),
        "greatest_nan": f("greatest", D, x, y),
        "least_ints": f("least", B, b, b2),
        "least_nan": f("least", D, y, x),
        "real_times_double": f("multiply", D, f("cast", D, c("r")), y),
        # dates and timestamps
        "year": f("year", B, dt),
        "month": f("month", B, dt),
        "day": f("day", B, dt),
        "quarter": f("quarter", B, dt),
        "day_of_week": f("day_of_week", B, dt),
        "day_of_year": f("day_of_year", B, dt),
        "week": f("week", B, dt),
        "last_day_of_month": f("last_day_of_month", T.DATE, dt),
        "year_of_timestamp": f("year", B, c("ts")),
        "day_of_week_timestamp": f("day_of_week", B, c("ts")),
        "date_add_months": f("date_add_ym", T.DATE, dt,
                             lit(13, T.INTERVAL_YEAR_MONTH)),
        "date_add_months_col": f("date_add_ym", T.DATE, dt, c("m")),
        "date_add_days": f("date_add_dt", T.DATE, dt,
                           lit(-90 * 86_400_000_000, T.INTERVAL_DAY_TIME)),
        "date_trunc_week": f("date_trunc", T.DATE, lit("week", V), dt),
        "date_trunc_month": f("date_trunc", T.DATE, lit("month", V), dt),
        "date_trunc_quarter": f("date_trunc", T.DATE, lit("quarter", V), dt),
        "date_trunc_year": f("date_trunc", T.DATE, lit("year", V), dt),
        "date_trunc_hour": f("date_trunc", T.TIMESTAMP, lit("hour", V),
                             c("ts")),
        "date_diff_day": f("date_diff", B, lit("day", V), dt, c("dt2")),
        "date_diff_week": f("date_diff", B, lit("week", V), dt, c("dt2")),
        "date_diff_month": f("date_diff", B, lit("month", V), dt, c("dt2")),
        "date_diff_quarter": f("date_diff", B, lit("quarter", V), dt,
                               c("dt2")),
        "date_diff_year": f("date_diff", B, lit("year", V), c("dt2"), dt),
        "date_add_unit_month": f("date_add", T.DATE, lit("month", V),
                                 c("m"), dt),
        "date_add_unit_day": f("date_add", T.DATE, lit("day", V), c("m"),
                               dt),
        "date_add_unit_year": f("date_add", T.DATE, lit("year", V), c("m"),
                                dt),
        "timestamp_add_minutes": f("date_add", T.TIMESTAMP,
                                   lit("minute", V), c("m"), c("ts")),
        # casts
        "cast_decimal_double": f("cast", D, d2),
        "cast_double_bigint": f("cast", B, x),
        "cast_double_integer": f("cast", T.INTEGER, x),
        "cast_decimal_bigint": f("cast", B, d4),
        "cast_bigint_double": f("cast", D, b),
        "cast_int_decimal": f("cast", DEC(12, 2), i),
        "cast_double_decimal": f("cast", DEC(12, 2), y),
        "cast_decimal_rescale": f("cast", DEC(12, 2), d4),
        "cast_date_timestamp": f("cast", T.TIMESTAMP, dt),
        "cast_timestamp_date": f("cast", T.DATE, c("ts")),
        "cast_bigint_boolean": f("cast", BOOL, b2),
        "cast_boolean_integer": f("cast", T.INTEGER, c("p")),
        "cast_decimal_real": f("cast", T.REAL, d2),
        "cast_double_real": f("cast", T.REAL, x),
        "try_cast_double_integer": f("try_cast", T.INTEGER, x),
        "try_cast_bigint_integer": f("try_cast", T.INTEGER, b),
        "try_cast_decimal_narrow": f("try_cast", DEC(5, 2), d4),
        "try_cast_varchar_bigint": f("try_cast", B, c("num")),
        "try_cast_varchar_double": f("try_cast", D, c("num")),
        "try_cast_varchar_date": f("try_cast", T.DATE, c("num")),
        "try_cast_varchar_varchar": f("try_cast", V, s),
        # special forms
        "and": sf("AND", BOOL, c("p"), c("q"), f("gt", BOOL, x, y)),
        "or": sf("OR", BOOL, c("p"), f("lt", BOOL, b, lit(0, B))),
        "not": sf("NOT", BOOL, c("p")),
        "is_null": sf("IS_NULL", BOOL, x),
        "is_null_never": sf("IS_NULL", BOOL, y),
        "coalesce": sf("COALESCE", B, b, b2, lit(-1, B)),
        "coalesce_strings": sf("COALESCE", V, s, s),
        "if": sf("IF", B, c("p"), b, i),
        "if_null_branch": sf("IF", B, f("eq", BOOL, b, b2), lit(None, B),
                             b),
        "if_two_dictionaries": sf("IF", V, c("q"), s, c("s2")),
        "switch": sf("SWITCH", D, f("lt", BOOL, x, lit(0.0, D)), y,
                     sf("IS_NULL", BOOL, b), lit(2.5, D), x),
        "in_list": sf("IN", BOOL, b2, lit(0, B), lit(-1, B), lit(7, B)),
        "in_strings": sf("IN", BOOL, s, lit("MAIL", V), lit("STEEL", V)),
        "in_padded": sf("OR", BOOL, f("eq", BOOL, i, lit(1, T.INTEGER)),
                        f("eq", BOOL, i, lit(-1, T.INTEGER)),
                        f("eq", BOOL, i, lit(0, T.INTEGER))),
        "between": sf("BETWEEN", BOOL, x, y, lit(3.0, D)),
        # strings through the dictionary
        "string_eq": f("eq", BOOL, s, lit("COPPER", V)),
        "string_ne_absent": f("ne", BOOL, s, lit("ABSENT", V)),
        "string_lt_flipped": f("gt", BOOL, lit("PROMO", V), s),
        "string_le": f("le", BOOL, s, lit("MAIL", V)),
        "string_ge": f("ge", BOOL, s, lit("D", V)),
        "string_column_compare": f("lt", BOOL, s, s),
        "like": f("like", BOOL, s, lit("%R%", V)),
        "like_escape": f("like", BOOL, s, lit("a!_b%", V), lit("!", V)),
        "lower_substr": f("lower", V, f("substr", V, s, lit(2, B),
                                        lit(3, B))),
        "upper_trim": f("upper", V, f("trim", V, s)),
        "concat": f("concat", V, s, lit("-x", V)),
        "replace": f("replace", V, s, lit("O", V), lit("0", V)),
        "reverse_lpad": f("lpad", V, f("reverse", V, s), lit(8, B),
                          lit("*", V)),
        "rpad": f("rpad", V, s, lit(4, B), lit(".", V)),
        "split_part": f("split_part", V, s, lit(" ", V), lit(2, B)),
        "regexp_extract": f("regexp_extract", V, s, lit("[A-Z]+", V)),
        "regexp_replace": f("regexp_replace", V, s, lit("[AEIOU]", V),
                            lit("_", V)),
        "concat_ws": f("concat_ws", V, lit("-", V), s, lit("z", V)),
        "concat_ws_null_separator": f("concat_ws", V, lit(None, V), s),
        "length": f("length", B, s),
        "strpos": f("strpos", B, s, lit("R", V)),
        "codepoint": f("codepoint", B, c("s2")),
        "regexp_like": f("regexp_like", BOOL, s, lit("^[PS]", V)),
        "starts_with": f("starts_with", BOOL, s, lit("B", V)),
        "format_datetime": f("format_datetime", V, dt, lit("yyyy-MM", V)),
        "date_format_timestamp": f("date_format", V, c("ts"),
                                   lit("%Y/%m/%d", V)),
    }
    out = [(k, "project", e) for k, e in cases.items()]
    out += [
        ("filter_q6_shape", "filter", sf("AND", BOOL,
         f("ge", BOOL, dt, lit(8766, T.DATE)),
         f("lt", BOOL, dt, f("date_add_ym", T.DATE, lit(8766, T.DATE),
                             lit(12, T.INTERVAL_YEAR_MONTH))),
         sf("BETWEEN", BOOL, d2, lit(5, DEC(12, 2)), lit(7, DEC(12, 2))),
         f("lt", BOOL, d4, lit(240_000, DEC(15, 4))))),
        ("filter_kleene", "filter", sf("OR", BOOL, sf("NOT", BOOL, c("p")),
                                       f("gt", BOOL, b, lit(0, B)))),
        ("filter_like_in", "filter", sf("AND", BOOL,
         f("like", BOOL, s, lit("%O%", V)),
         sf("IN", BOOL, c("s2"), lit("AIR", V), lit("FOB", V)))),
        ("filter_boolean_column", "filter", c("p")),
        ("filter_invariant", "filter", f("lt", BOOL, lit(1, B), lit(2, B))),
    ]
    return out


def sort_page(cap: int, n: int, seed: int, device):
    """A seeded page of every sort-key type: DOUBLE with NULLs, NaN,
    +-0.0 and +-inf, BIGINT with INT64_MIN and duplicates, INTEGER with
    INT_MIN, DATE, BOOLEAN with NULLs, DECIMAL, dictionary codes, REAL."""
    import numpy as np
    from trino_tpu_torch import types as T
    from trino_tpu_torch.page import Dictionary, Page, row_count
    rng = np.random.default_rng(seed)

    def pick(values):
        return np.asarray(values)[rng.integers(0, len(values), cap)]
    cols = [
        (pick([-1.5, -0.0, 0.0, 2.25, np.nan, np.inf, -np.inf, 7.0]),
         T.DOUBLE, rng.random(cap) < 0.85),
        (np.where(rng.random(cap) < 0.1, -(1 << 63),
                  rng.integers(-50, 50, cap)).astype(np.int64), T.BIGINT,
         rng.random(cap) < 0.9),
        (pick([-(1 << 31), -2, 0, 5, (1 << 31) - 1]).astype(np.int32),
         T.INTEGER, None),
        (rng.integers(-800, 800, cap).astype(np.int32), T.DATE,
         rng.random(cap) < 0.95),
        (rng.random(cap) < 0.5, T.BOOLEAN, rng.random(cap) < 0.7),
        (rng.integers(-3, 4, cap).astype(np.int64) * 125,
         T.DecimalType(12, 2), None),
        (rng.integers(0, 4, cap).astype(np.int32), T.VARCHAR,
         rng.random(cap) < 0.9),
        (pick([-1.0, -0.0, 0.0, 3.5, np.nan]).astype(np.float32), T.REAL,
         None),
    ]
    pool = Dictionary(np.asarray(["AIR", "MAIL", "RAIL", "SHIP"],
                                 dtype=object))
    page = Page.from_numpy([c[0] for c in cols], [c[1] for c in cols],
                           valids=[c[2] for c in cols],
                           dictionaries=[pool if c[1] == T.VARCHAR else None
                                         for c in cols], device=device)
    return Page(page.columns, row_count(n, device))


SORT_KEYSETS = [  # (channel, ascending, nulls_first) per key
    [(0, True, None)],
    [(1, False, None)],
    [(2, False, None), (0, True, True)],
    [(6, True, None), (4, False, False), (0, False, None), (3, True, True)],
    [(1, True, False), (0, False, True), (5, False, None), (2, True, None)],
    [(7, False, None), (4, True, None)],
]


def check_sort(dev) -> float:
    """K10 against its twin: the packed words bit for bit and the
    permutation of the live prefix exactly, on both sides of the one-block
    threshold and at a 4,194,304-row page."""
    from trino_tpu_torch.ops import sort as S
    sizes = [(1, 1), (100, 0), (300, 257), (4096, 4093),
             (S.ONE_BLOCK_ROWS, S.ONE_BLOCK_ROWS),
             (S.ONE_BLOCK_ROWS + 1, S.ONE_BLOCK_ROWS + 1),
             (131_072, 100_003), (4_194_304, 4_194_304)]
    for (cap, n), seed in zip(sizes, range(len(sizes))):
        page = sort_page(cap, n, 500 + seed, dev)
        for ks in SORT_KEYSETS:
            keys = [S.SortKey(c, a, nf) for c, a, nf in ks]
            got_w = S.encode_sort_keys_cuda(page, keys)
            want_w = S.encode_sort_keys(page, keys)
            for a, b in zip(got_w, want_w):
                if not torch.equal(a[:n], b[:n]):
                    fail(f"K10 words differ at cap={cap} n={n} keys={ks}")
            got = S.sort_rows_cuda(page, keys)
            sync()
            want = S.sort_rows_plain(page, keys)
            if not torch.equal(got[:n].to(torch.int64), want[:n]):
                fail(f"K10 permutation differs at cap={cap} n={n} "
                     f"keys={ks}")
            if not torch.equal(got[n:].to(torch.int64),
                               torch.arange(n, cap, device=dev)):
                fail(f"K10 moved a dead row at cap={cap} n={n}")
    return 0.0   # compared exactly


def column_err(label, got, want, n) -> float:
    """Fail unless two Columns agree on the first n rows: validity
    exactly, values where valid (integers and codes exactly, floats to
    1e-9 relative, NaN equal to NaN, the sign of zero kept), equal
    dictionaries; returns the largest float difference."""
    def full(t):
        return None if t is None else (t.expand(n) if t.dim() == 0
                                       else t[:n])
    gv, wv = full(got.valid), full(want.valid)
    ones = torch.ones(n, dtype=torch.bool, device=got.values.device)
    gm = ones if gv is None else gv
    wm = ones if wv is None else wv
    if not torch.equal(gm, wm):
        fail(f"{label}: validity differs")
    if (got.dictionary is None) != (want.dictionary is None) or (
            got.dictionary is not None and got.dictionary != want.dictionary):
        fail(f"{label}: dictionary differs")
    g, w = full(got.values)[wm], full(want.values)[wm]
    if g.dtype != w.dtype:
        fail(f"{label}: dtype {g.dtype} != {w.dtype}")
    if not g.dtype.is_floating_point:
        if not torch.equal(g, w):
            fail(f"{label}: values differ")
        return 0.0
    g64, w64 = g.double(), w.double()
    nan = torch.isnan(g64) & torch.isnan(w64)
    close = (g64 == w64) | ((g64 - w64).abs()
                           <= 1e-9 * torch.maximum(g64.abs(), w64.abs()))
    sign = (w64 != 0) | (torch.signbit(g64) == torch.signbit(w64))
    if not bool((nan | (close & sign)).all()):
        fail(f"{label}: values differ beyond 1e-9 relative")
    return max_abs_err(g64, w64)


def check_expr(dev) -> float:
    """K11 against the plain compiler on the card over the corpus: the
    project cases 16 to a step (one kernel each), every filter case in its
    own step, literals hoisted as the main path hoists them."""
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.expr.hoist import hoist_literal_seq
    page, names = corpus_page(dev)
    n = int(page.num_rows)
    cases = expr_corpus(names)
    project = [(k, e) for k, m, e in cases if m == "project"]
    err = 0.0
    for start in range(0, len(project), 16):
        chunk = project[start:start + 16]
        exprs, params = hoist_literal_seq(tuple(e for _, e in chunk))
        step = KG.project_step(exprs)
        got = KG.expr_step_cuda(step, page, params)
        sync()
        want = step.plain(page, params)
        for (name, _), g_, w_ in zip(chunk, got, want):
            err = max(err, column_err(f"K11 {name}", g_, w_, n))
    for name, mode, e in cases:
        if mode != "filter":
            continue
        (canon,), params = hoist_literal_seq((e,))
        step = KG.filter_step(canon)
        got = KG.expr_step_cuda(step, page, params)
        sync()
        want = step.plain(page, params)
        if not torch.equal(got[:n], want[:n]):
            fail(f"K11 filter {name}: masks differ")
        launched = step.compiled(page, params).prog.outputs[0].kind
        if launched == "kernel" and bool(got[n:].any()):
            fail(f"K11 filter {name}: a dead row passed")
    return err


def kernel_rows_sort_expr(cap: Capture, originals, launches, dev, card):
    """K10 and K11 at the main path's largest calls, against their twins."""
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.ops import sort as S
    out = []

    def host_ms(fn, iters=50):
        """Host milliseconds per call (enqueue only, no sync)."""
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        sync()
        return (t1 - t0) / iters * 1e3

    # K10 at the largest ORDER BY / TopN sort of the sf1 queries
    page, keys = cap.calls[("sort_rows_cuda", "sf1")][1]
    n = int(page.num_rows)
    got = originals["sort_rows"](page, keys)
    want = S.sort_rows_plain(page, keys)
    if not torch.equal(got[:n].to(torch.int64), want[:n]):
        fail("K10 differs from its twin at the main path's inputs")
    words = S.encode_sort_keys(page, keys)
    word = words[-1][:n].contiguous()
    key_b = sum(page.column(k.channel).values.element_size()
                + (page.column(k.channel).valid is not None) for k in keys)
    fn10 = lambda: originals["sort_rows"](page, keys)   # noqa: E731
    out.append(dict(
        name="sort_rows (K10, order_by/top_n_masked)", route="cuda",
        source="trino_tpu_torch/csrc/sort.cu",
        replaces="trino_tpu/ops/sort.py:71", launches=launches["sort_rows"],
        max_abs_err=0.0, ms=cuda_ms(fn10), device_ms=device_profile(fn10)[0],
        host_ms=host_ms(fn10),
        plain_ms=cuda_ms(lambda: S.sort_rows_plain(page, keys)),
        # the key columns of the live rows read once, the int32
        # permutation written once
        bound_ms=n * (key_b + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sort(word, stable=True)),
        shape=f"sf1 sort: cap {page.capacity}, {n} live rows, {len(keys)} "
              f"keys, {len(words)} words, "
              f"{len(S.sort_passes(S.sort_layout(page, keys)))} digit "
              f"passes, {'one block' if page.capacity <= S.ONE_BLOCK_ROWS else 'multi-block'}; "
              f"library = torch.sort(stable=True) of one packed word"))

    # K11 at q6 sf1's largest step (its scan page's predicate)
    step, page, params = cap.calls[("expr_step_cuda", ("sf1", "q6"))][1]
    n = int(page.num_rows)
    got = originals["expr_step"](step, page, params)
    want = step.plain(page, params)
    if step.mode == "filter":
        if not torch.equal(got[:n], want[:n]):
            fail("K11 differs from the plain compiler at the main path's "
                 "inputs")
        err, out_b = 0.0, n
    else:
        err = max(column_err("K11 main path", g_, w_, n)
                  for g_, w_ in zip(got, want))
        out_b = sum(n * (c.values.element_size() + (c.valid is not None))
                    for c in got)
    comp = step.compiled(page, params)
    in_b = sum(n * (page.columns[i].values.element_size()
                    + (page.columns[i].valid is not None))
               for i in comp.prog.inputs)
    fn11 = lambda: originals["expr_step"](step, page, params)  # noqa: E731
    out.append(dict(
        name="expr_step (K11, compile_filter/compile_expression)",
        route="triton", source="trino_tpu_torch/expr/kernel_gen.py",
        replaces="trino_tpu/expr/compiler.py:945",
        launches=launches["expr_step"], max_abs_err=err, ms=cuda_ms(fn11),
        device_ms=device_profile(fn11)[0], host_ms=host_ms(fn11),
        plain_ms=cuda_ms(lambda: step.plain(page, params)),
        # the referenced live columns read once, the outputs written once
        bound_ms=(in_b + out_b) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        shape=f"q6 sf1 {step.mode} step: cap {page.capacity}, {n} live, "
              f"{len(comp.prog.inputs)} input columns, "
              f"{len(comp.prog.instrs)} primitive ops; library = none (no "
              f"single PyTorch call computes a tree)"))
    for r in out:
        say(f"[kernel] {r['name']}: host {r['host_ms']:.4f} ms per call "
            f"(enqueue), {r['ms']:.4f} ms per call (CUDA events) — {card}")
    return out


# ------------------------------------------------------------- phase 3/4


class Capture:
    """Keep a kernel wrapper's largest call of each query the timing rows
    read (q6, q1 and q3 at sf1) and its largest call of all sf1 queries,
    so phase 4 times each kernel at the shapes the main path gave it."""

    TIMED = (("sf1", "q6"), ("sf1", "q1"), ("sf1", "q3"))

    def __init__(self):
        self.label = None
        self.calls = {}
        self.orig = {}

    def wrap(self, module, name, size_of):
        """Replace module.name with a recording pass-through. The kernel
        function increments `<module>.<name>.launches` (and K9's
        `.by_kind`) through its module global, so the counters now live on
        the pass-through."""
        orig = getattr(module, name)

        def record(key, size, args):
            if key not in self.calls or size > self.calls[key][0]:
                self.calls[key] = (size, args)

        def wrapped(*args):
            if self.label is not None:
                size = size_of(*args)
                if self.label in self.TIMED:
                    record((name, self.label), size, args)
                if self.label[0] == "sf1":
                    record((name, "sf1"), size, args)
            return orig(*args)
        wrapped.launches = 0
        if hasattr(orig, "by_kind"):
            wrapped.by_kind = {}
        self.orig[name] = orig
        setattr(module, name, wrapped)


def _cell(x):
    return ("f", float(f"{x:.9g}")) if isinstance(x, float) else \
        (type(x).__name__, x)


def rows_equal(a, b) -> bool:
    """Rows equal in order, or (ties in an ORDER BY, groups in hash order)
    as multisets; doubles within 1e-9 relative, the rest exactly."""
    def same(ra, rb):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not (x == y or (x != x and y != y)
                        or abs(x - y) <= 1e-9 * max(abs(x), abs(y))):
                    return False
            elif x != y:
                return False
        return len(ra) == len(rb)
    if len(a) != len(b):
        return False
    if all(same(ra, rb) for ra, rb in zip(a, b)):
        return True

    def key(r):
        return tuple((x is None, str(_cell(x))) for x in r)
    return all(same(ra, rb) for ra, rb in zip(sorted(a, key=key),
                                              sorted(b, key=key)))


def nbytes(ts) -> int:
    seen = {}
    for t in ts:
        if t is not None and t.numel():
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


# Two more sf1 queries so that every join kind runs on the main path: a
# FULL join (TPC-H has none) and an IN subquery inside an OR (a MARK join).
FULL_SQL = """SELECT count(*), count(o_orderkey), count(c_custkey),
       sum(o_totalprice)
FROM (SELECT * FROM orders WHERE o_orderdate < DATE '1993-01-01') o
FULL JOIN (SELECT * FROM customer WHERE c_nationkey < 5) c
  ON o_custkey = c_custkey"""
MARK_SQL = """SELECT o_orderpriority, count(*), sum(o_totalprice)
FROM orders
WHERE o_custkey IN (SELECT c_custkey FROM customer
                    WHERE c_mktsegment = 'BUILDING')
   OR o_totalprice > 400000
GROUP BY o_orderpriority
ORDER BY o_orderpriority"""


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "trino_tpu_torch")):
        print("trino_tpu_torch/ not beside chip_smoke.py", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- phase 1: card and build
    say(card)   # as nvidia-smi prints it: name, power limit
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    from trino_tpu_torch import native
    t0 = time.perf_counter()
    logs = native.build_all()
    build_s = time.perf_counter() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build] {src}: {line.strip()}")
    say(f"[card] nvcc build of {len(logs)} sources in parallel: "
        f"{build_s:.2f} s")

    # ---- phase 2: kernels against plain twins
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(20261017)
    from trino_tpu_torch.ops import aggregate as A
    t0 = time.perf_counter()
    A._global_kernels()
    check_global(g, dev)   # first call compiles the Triton programs
    say(f"[card] Triton K4 first call (compile + run): "
        f"{time.perf_counter() - t0:.2f} s")
    errs = {"compact_rows": check_compact(g, dev),
            "concat_rows": check_concat(g, dev),
            "direct_aggregate": check_direct(g, dev),
            "global_aggregate": check_global(g, dev)}
    say(f"[kernels] K1-K4 match their plain twins on the card "
        f"(integers exact, float64 sums <= 1e-9 rel): {errs}")
    errs = {"compact_rows range mode": check_range(g, dev),
            "gather_rows": check_gather(g, dev),
            "join_build + join_dense + unique_probe": check_join(g, dev),
            "group_aggregate": check_group(g, dev)}
    say(f"[kernels] K1 range mode and K5-K8 match their plain twins on "
        f"the card (integers and masks exact, float64 sums <= 1e-9 rel, "
        f"groups as multisets): {errs}")
    errs = {"join_runs": check_runs(g, dev),
            "expand_count + expand_write + probe_verdict":
                check_expand(g, dev),
            "distinct_mask": check_distinct(g, dev)}
    say(f"[kernels] K5 runs mode, K9 (every kind, both routes, "
        f"null_aware on and off) and K8 distinct mode match their plain "
        f"twins on the card (all exact; one marked row per distinct key): "
        f"{errs}")
    t0 = time.perf_counter()
    errs = {"sort_encode + sort_radix": check_sort(dev)}
    say(f"[kernels] K10 matches its plain twin on the card (words bit for "
        f"bit, permutations exactly, one-block and multi-block paths, "
        f"4,194,304 rows): {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"expr_step": check_expr(dev)}
    say(f"[kernels] K11 matches the plain compiler on the card over "
        f"{len(expr_corpus(corpus_page('cpu')[1]))} corpus expressions "
        f"(integers, codes and masks exact, doubles <= 1e-9 rel, NaN and "
        f"-0.0 kept; compiles included): {errs} in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[time] phase 2 (kernels vs twins): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- phase 3: queries from SQL on cuda vs the port on the CPU
    t_phase = time.perf_counter()
    from trino_tpu_torch import page as P
    from trino_tpu_torch.exec import LocalQueryRunner
    from trino_tpu_torch.expr import compiler as EC
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import sort as S
    cap = Capture()
    cap.wrap(P, "compact_rows_cuda", lambda arrays, mask, n: mask.numel())
    cap.wrap(P, "concat_rows_cuda", lambda arrays, counts, c: c)
    cap.wrap(A, "direct_reduce_cuda",
             lambda keys, states, n, nseg: keys[0].codes.numel())
    cap.wrap(A, "global_reduce_triton", lambda states, n, c: c)
    cap.wrap(P, "compact_range_cuda", lambda arrays, key, *_: key.numel())
    cap.wrap(P, "gather_rows_cuda",
             lambda arrays, idx: idx.numel() if arrays else -1)
    cap.wrap(J, "join_build_cuda", lambda cols, n: cols[0][0].numel())
    cap.wrap(J, "join_dense_cuda", lambda cols, n, st, size: size)
    cap.wrap(J, "unique_probe_cuda", lambda pc, bc, *_: pc[0][0].numel())
    cap.wrap(A, "group_reduce_cuda", lambda keys, states, n, c: c)
    cap.wrap(J, "join_runs_cuda", lambda cols, *_: cols[0][0].numel())
    cap.wrap(J, "expand_count_cuda", lambda pc, *_: pc[0][0].numel())
    cap.wrap(J, "expand_write_cuda", lambda pc, bc, c, kind, oc, *_: oc)
    cap.wrap(J, "probe_verdict_cuda", lambda pc, *_: pc[0][0].numel())
    cap.wrap(A, "distinct_mask_cuda", lambda keys, el: el.numel())
    cap.wrap(S, "sort_rows_cuda", lambda page, keys: page.capacity)
    cap.wrap(KG, "expr_step_cuda",
             lambda step, page, params=(): page.capacity)
    plain_sorts = []     # the sort's plain twin must not run on the card
    real_plain_sort = S.sort_rows_plain

    def counted_plain_sort(page, keys):
        if page.device.type == "cuda" and cap.label is not None:
            plain_sorts.append(cap.label)
        return real_plain_sort(page, keys)
    S.sort_rows_plain = counted_plain_sort
    kernels = {"compact_rows": (P, "compact_rows_cuda"),
               "compact_range": (P, "compact_range_cuda"),
               "concat_rows": (P, "concat_rows_cuda"),
               "direct_aggregate": (A, "direct_reduce_cuda"),
               "global_aggregate": (A, "global_reduce_triton"),
               "join_build": (J, "join_build_cuda"),
               "join_dense": (J, "join_dense_cuda"),
               "join_runs": (J, "join_runs_cuda"),
               "unique_probe": (J, "unique_probe_cuda"),
               "expand_count": (J, "expand_count_cuda"),
               "expand_write": (J, "expand_write_cuda"),
               "probe_verdict": (J, "probe_verdict_cuda"),
               "gather_rows": (P, "gather_rows_cuda"),
               "group_aggregate": (A, "group_reduce_cuda"),
               "distinct_mask": (A, "distinct_mask_cuda"),
               "sort_rows": (S, "sort_rows_cuda"),
               "expr_step": (KG, "expr_step_cuda")}
    runs = [("sf1", q, TPCH[q][0]) for q in TPCH]
    runs += [("sf1", "full", FULL_SQL), ("sf1", "mark", MARK_SQL)]
    runs += [("sf10", q, TPCH[q][0]) for q in ("q6", "q3", "q9", "q13")]
    gpu = {s: LocalQueryRunner.tpch(s) for s in ("sf1", "sf10")}
    cpu = {s: LocalQueryRunner.tpch(s, device="cpu")
           for s in ("sf1", "sf10")}
    for runner in (gpu["sf10"], cpu["sf10"]):
        # q9's sf10 builds pass join_spill_threshold_bytes (1 GiB), and
        # the spilled join is not ported (ROADMAP A7/B9): these runs join
        # in memory, as a session without spill does
        runner.execute("SET SESSION spill_enabled = false")
    for mod, attr in kernels.values():
        getattr(mod, attr).launches = 0
        if hasattr(getattr(mod, attr), "by_kind"):
            getattr(mod, attr).by_kind = {}
    EC.cuda_evaluations = 0     # steps of the torch-op compiler on the card
    results = {}
    routes = set()
    kinds = set()
    per_query = {}
    for schema, q, sql in runs:
        cap.label = (schema, q)
        before = {k: getattr(mod, attr).launches
                  for k, (mod, attr) in kernels.items()}
        t0 = time.perf_counter()
        res = gpu[schema].execute(sql)
        sync()
        results[(schema, q)] = (res, time.perf_counter() - t0)
        per_query[(schema, q)] = {
            k: getattr(mod, attr).launches - before[k]
            for k, (mod, attr) in kernels.items()}
        for i, j in enumerate(gpu[schema].last_joins):
            routes.add(j["route"])
            kinds.add(j["kind"])
            say(f"[join] {q} {schema} join {i + 1}: {j['kind']}, route "
                f"{j['route']}, build {j['build_rows']} live rows, max_run "
                f"{j['max_run']}, probe {j['probe_rows']} rows, output "
                f"{j['output_rows']} rows")
    cap.label = None
    S.sort_rows_plain = real_plain_sort
    if EC.cuda_evaluations:
        fail(f"{EC.cuda_evaluations} filter/project steps on the card ran "
             f"through the torch-op compiler, not K11")
    if plain_sorts:
        fail(f"sorts on the card ran the plain twin, not K10: "
             f"{plain_sorts[:5]}")
    say("[k11] every filter and project step on the card ran K11 (the "
        "torch-op compiler evaluated 0 steps); every ORDER BY and TopN "
        "sort ran K10")
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in kernels.items()}
    by_kind = {k: dict(getattr(mod, attr).by_kind)
               for k, (mod, attr) in kernels.items()
               if hasattr(getattr(mod, attr), "by_kind")}
    for (schema, q), (res, secs) in results.items():
        say(f"[query] {q} {schema} on cuda: {len(res.rows)} rows, first "
            f"run {secs:.2f} s (includes data generation and staging)")
    t0 = time.perf_counter()
    for schema, q, sql in runs:
        want = cpu[schema].execute(sql).rows
        got = results[(schema, q)][0].rows
        if not rows_equal(got, want):
            fail(f"{q} {schema}: cuda rows differ from the CPU run:\n"
                 f"{got[:5]}\n{want[:5]}")
        say(f"[query] {q} {schema}: cuda rows == cpu rows ({len(got)} "
            f"rows, first {got[0] if got else None})")
    say(f"[time] phase 3 (queries): {time.perf_counter() - t_phase:.1f} s, "
        f"of which the CPU runs {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: launch check and times
    t_phase = time.perf_counter()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    need = {"expand_count": {"inner", "left", "full"},
            "probe_verdict": {"semi", "anti", "mark"}}
    for k, want_kinds in need.items():
        if not want_kinds <= set(by_kind[k]):
            fail(f"{k} never launched for "
                 f"{sorted(want_kinds - set(by_kind[k]))}: {by_kind[k]}")
    if routes != {"dense", "search", "cross"}:
        fail(f"the joins took the routes {sorted(routes)}, not dense, "
             f"search and cross")
    for (schema, q), counts in per_query.items():
        say(f"[launches] {q} {schema}: "
            + ", ".join(f"{k} {n}" for k, n in counts.items() if n))
    say(f"[launches] main path ({len(runs)} queries): {launches}; K9 by "
        f"kind: {by_kind} — {card}")
    originals = {k: cap.orig[attr] for k, (_, attr) in kernels.items()}
    rows = kernel_rows(cap, originals, launches, dev)
    rows += kernel_rows_q3(cap, originals, launches, dev)
    rows += kernel_rows_expand(cap, originals, launches, dev)
    rows += kernel_rows_sort_expr(cap, originals, launches, dev, card)
    for r in rows:
        dev_ms = "not measured" if r["device_ms"] is None \
            else f"{r['device_ms']:.4f} ms"
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        say(f"[kernel] {r['name']}: {r['ms']:.4f} ms per call (CUDA "
            f"events), device-busy {dev_ms} (profiler), bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"{r['shape']} — {card}")
    say(f"[time] phase 4 kernel rows: {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    from trino_tpu_torch.connector import tpch_gen
    lineitem = {s: tpch_gen.row_count("lineitem", sf)
                for s, sf in (("sf1", 1.0), ("sf10", 10.0))}
    for schema, q, sql in runs:
        gpu[schema].execute(sql)
        sync()
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            gpu[schema].execute(sql)
            sync()
            walls.append(time.perf_counter() - t1)
        w = statistics.median(walls)
        say(f"[wall] {q} {schema}: warm median of 3 = {w * 1e3:.1f} ms, "
            f"{lineitem[schema] / w / 1e6:.1f} M lineitem rows/s — {card}")
        busy, top = device_profile(lambda: gpu[schema].execute(sql), 3)
        if busy is None:
            say(f"[profile] {q} {schema}: device time not measured — "
                f"{card}")
        else:
            say(f"[profile] {q} {schema}: device busy {busy:.2f} ms of "
                f"{w * 1e3:.1f} ms warm wall (idle share "
                f"{max(0.0, 1 - busy / (w * 1e3)):.2f}); top device time: "
                + ", ".join(f"{k[:60]} {t:.3f} ms" for k, t in top)
                + f" — {card}")
        say(f"[profile] {q} {schema}: top host self time per query: "
            + host_profile(lambda: gpu[schema].execute(sql), top=6)
            + f" — {card}")
    say(f"[time] phase 4 walls and profiles: "
        f"{time.perf_counter() - t0:.1f} s; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def kernel_rows(cap: Capture, originals, launches, dev):
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import aggregate as A
    out = []

    # K1 at q6 sf1's scan-page filter
    arrays, mask, num_rows = cap.calls[("compact_rows_cuda",
                                        ("sf1", "q6"))][1]
    n = int(num_rows)
    sel = int((mask[:n]).sum())
    row_b = sum(a.element_size() for a in arrays)
    stacked = torch.stack([a.to(torch.int64) for a in arrays])
    got, c = originals["compact_rows"](arrays, mask, num_rows)
    want, wc = P.compact_rows_plain(arrays, mask, num_rows)
    if int(c) != int(wc) or not all(same_bits(x[:sel], y[:sel])
                                    for x, y in zip(got, want)):
        fail("K1 differs from its plain twin at the main path's inputs")
    err = max(max_abs_err(x[:sel], y[:sel]) for x, y in zip(got, want))
    out.append(dict(
        name="compact_rows (K1, Page.filter)", route="cuda",
        source="trino_tpu_torch/csrc/compact.cu",
        replaces="trino_tpu/page.py:308",
        launches=launches["compact_rows"], max_abs_err=err,
        ms=cuda_ms(lambda: originals["compact_rows"](arrays, mask,
                                                     num_rows)),
        device_ms=device_profile(lambda: originals["compact_rows"](
            arrays, mask, num_rows))[0],
        plain_ms=cuda_ms(lambda: P.compact_rows_plain(arrays, mask,
                                                      num_rows)),
        # the live mask read once, the selected rows read and written once
        bound_ms=(n + 2 * sel * row_b) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.masked_select(stacked, mask)),
        shape=f"q6 sf1 scan page: cap {mask.numel()}, {n} live, {sel} "
              f"selected, {len(arrays)} arrays"))

    # K2 at q1 sf1's partial-aggregate buffer merge
    arrays2, counts, out_cap = cap.calls[("concat_rows_cuda",
                                          ("sf1", "q1"))][1]
    live = [int(c) for c in counts]
    moved = sum(live[p] * sum(a.element_size() for a in pa if a is not None)
                for p, pa in enumerate(arrays2))
    got, tot = originals["concat_rows"](arrays2, counts, out_cap)
    want, wtot = P.concat_rows_plain(arrays2, counts, out_cap)
    k = int(wtot)
    if int(tot) != k or not all(same_bits(x[:k], y[:k])
                                for x, y in zip(got, want)):
        fail("K2 differs from its plain twin at the main path's inputs")
    err = max(max_abs_err(x[:k], y[:k]) for x, y in zip(got, want))
    parts = [torch.stack([a[:live[p]].to(torch.int64) for a in pa
                          if a is not None]) for p, pa in enumerate(arrays2)]
    out.append(dict(
        name="concat_rows (K2, device_concat)", route="cuda",
        source="trino_tpu_torch/csrc/concat.cu",
        replaces="trino_tpu/page.py:522",
        launches=launches["concat_rows"], max_abs_err=err,
        ms=cuda_ms(lambda: originals["concat_rows"](arrays2, counts,
                                                    out_cap)),
        device_ms=device_profile(lambda: originals["concat_rows"](
            arrays2, counts, out_cap))[0],
        plain_ms=cuda_ms(lambda: P.concat_rows_plain(arrays2, counts,
                                                     out_cap)),
        bound_ms=(2 * moved) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.cat(parts, dim=1)),
        shape=f"q1 sf1 partial buffer: {len(arrays2)} pages, caps "
              f"{[pa[0].numel() for pa in arrays2]}, live {live}"))

    # K3 at q1 sf1's partial aggregation of the first scan page
    keys, states, num_rows3, nseg = cap.calls[("direct_reduce_cuda",
                                               ("sf1", "q1"))][1]
    n3 = int(num_rows3)
    ins = [k.codes[:n3] for k in keys] + [k.valid[:n3] for k in keys
                                          if k.valid is not None]
    for s in states:
        ins += [x[:n3] for x in (s.values, s.valid, s.mask) if x is not None]
    slots, got, ng = originals["direct_aggregate"](keys, states, num_rows3,
                                                   nseg)
    wslots, want, wng = A.direct_reduce_plain(keys, states, num_rows3, nseg)
    kk = int(wng)
    if int(ng) != kk or not torch.equal(slots[:kk], wslots[:kk]):
        fail("K3 groups differ from its plain twin at the main path's "
             "inputs")
    compare_states("K3 main path", states, [x[:kk] for x in got],
                   [x[:kk] for x in want])
    err = max(max_abs_err(x[:kk], y[:kk]) for x, y in zip(got, want))
    seg = torch.zeros(keys[0].codes.numel(), dtype=torch.int64, device=dev)
    for kin in keys:
        seg += kin.codes.to(torch.int64).clamp(0, kin.size - 2) * kin.stride
    contrib = torch.stack([s.values if s.values is not None
                           else torch.ones_like(seg) for s in states], 1)
    contrib = contrib.view(torch.int64) if contrib.dtype != torch.int64 \
        else contrib
    table = torch.zeros(nseg, len(states), dtype=torch.int64, device=dev)
    out.append(dict(
        name="direct_aggregate (K3, _direct_aggregate)", route="cuda",
        source="trino_tpu_torch/csrc/direct_agg.cu",
        replaces="trino_tpu/ops/aggregate.py:675",
        launches=launches["direct_aggregate"], max_abs_err=err,
        ms=cuda_ms(lambda: originals["direct_aggregate"](
            keys, states, num_rows3, nseg)),
        device_ms=device_profile(lambda: originals["direct_aggregate"](
            keys, states, num_rows3, nseg))[0],
        plain_ms=cuda_ms(lambda: A.direct_reduce_plain(
            keys, states, num_rows3, nseg)),
        bound_ms=(nbytes(ins) + nseg * len(states) * 8)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: table.index_add_(0, seg, contrib)),
        shape=f"q1 sf1 partial: cap {keys[0].codes.numel()}, {n3} live, "
              f"{nseg} slots, {len(states)} states"))

    # K4 at q6 sf1's partial aggregation of the first filtered page
    states4, num_rows4, cap4 = cap.calls[("global_reduce_triton",
                                          ("sf1", "q6"))][1]
    n4 = int(num_rows4)
    ins4 = []
    for s in states4:
        ins4 += [x[:n4] for x in (s.values, s.valid, s.mask)
                 if x is not None]
    got = originals["global_aggregate"](states4, num_rows4, cap4)
    want = A.global_reduce_plain(states4, num_rows4, cap4)
    compare_states("K4 main path", states4, got, want)
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    stacked4 = torch.stack([s.values[:n4] if s.values is not None
                            else torch.ones(n4, dtype=torch.int64,
                                            device=dev)
                            for s in states4])
    out.append(dict(
        name="global_aggregate (K4, _global_aggregate)", route="triton",
        source="trino_tpu_torch/ops/aggregate.py",
        replaces="trino_tpu/ops/aggregate.py:1229",
        launches=launches["global_aggregate"], max_abs_err=err,
        ms=cuda_ms(lambda: originals["global_aggregate"](states4, num_rows4,
                                                         cap4)),
        device_ms=device_profile(lambda: originals["global_aggregate"](
            states4, num_rows4, cap4))[0],
        plain_ms=cuda_ms(lambda: A.global_reduce_plain(states4, num_rows4,
                                                       cap4)),
        bound_ms=(nbytes(ins4) + 8 * len(states4)) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sum(stacked4, dim=1)),
        shape=f"q6 sf1 partial: cap {cap4}, {n4} live, {len(states4)} "
              f"states"))
    return out


def hash_table_ok(cols, num_rows, lookup) -> bool:
    """K5's hash table holds each live key once, with its count and a row
    that carries it."""
    from trino_tpu_torch.ops import join as J
    _, slot_keys, slot_rows, slot_counts = lookup
    occ = slot_rows >= 0
    key, null = J._key_cols(cols)
    live = (torch.arange(key.shape[0], device=key.device)
            < num_rows) & ~null
    uk, uc = torch.unique(key[live], return_counts=True)
    sk, order = torch.sort(slot_keys[occ])
    return (torch.equal(sk, uk)
            and torch.equal(slot_counts[occ][order].to(torch.int64), uc)
            and torch.equal(key[slot_rows[occ].long()], slot_keys[occ]))


def col_bytes(cols, n: int) -> int:
    """Bytes of n rows of (values, valid) columns."""
    return sum(n * (v.element_size() + (1 if m is not None else 0))
               for v, m in cols)


def kernel_rows_q3(cap: Capture, originals, launches, dev):
    """The kernels q3 brought in, each at the largest call q3 sf1 gave it
    (the first in that size when several tie), against its twin."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import join as J
    label = ("sf1", "q3")
    out = []

    def row(name, source, replaces, key, err, fn, plain, bound_bytes,
            library, library_name, shape):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[key], max_abs_err=err, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    # K1 range mode at the lineitem scan page the dynamic filter compacts
    arrays, key, key_valid, lo, hi, nr = cap.calls[("compact_range_cuda",
                                                    label)][1]
    n = int(nr)
    got, c = originals["compact_range"](arrays, key, key_valid, lo, hi, nr)
    want, wc = P.compact_range_plain(arrays, key, key_valid, lo, hi, nr)
    sel = int(wc)
    if int(c) != sel or not all(same_bits(x[:sel], y[:sel])
                                for x, y in zip(got, want)):
        fail("K1 range mode differs from its twin at q3's inputs")
    keep = (key >= lo) & (key <= hi)
    if key_valid is not None:
        keep &= key_valid
    keep &= torch.arange(key.numel(), device=dev) < n
    stacked = torch.stack([a.to(torch.int64) for a in arrays])
    row_b = sum(a.element_size() for a in arrays)
    out.append(row(
        "compact_rows range mode (K1, range_prefilter)",
        "trino_tpu_torch/csrc/compact.cu", "trino_tpu/ops/join.py:772",
        "compact_range", 0.0,
        lambda: originals["compact_range"](arrays, key, key_valid, lo, hi,
                                           nr),
        lambda: P.compact_range_plain(arrays, key, key_valid, lo, hi, nr),
        col_bytes([(key, key_valid)], n) + 2 * sel * row_b,
        lambda: torch.masked_select(stacked, keep), "torch.masked_select",
        f"q3 sf1 lineitem probe page: cap {key.numel()}, {n} live, {sel} "
        f"kept, {len(arrays)} arrays"))

    # K5 at q3's largest build (orders joined with customer)
    cols, nr = cap.calls[("join_build_cuda", label)][1]
    n = int(nr)
    stats, lookup = originals["join_build"](cols, nr)
    wstats, _ = J.join_build_plain(cols, nr)
    if not torch.equal(stats, wstats) or not hash_table_ok(cols, nr,
                                                           lookup):
        fail("K5 differs from its twin at q3's build")
    slots = lookup[1].numel()
    bkeys = cols[0][0][:n]
    out.append(row(
        "join_build (K5, prepare_build + build_key_bounds)",
        "trino_tpu_torch/csrc/join_build.cu", "trino_tpu/ops/join.py:102",
        "join_build", 0.0, lambda: originals["join_build"](cols, nr),
        lambda: J.join_build_plain(cols, nr),
        # the keys read once; the lookup written as the n live keys and
        # rows it must hold (8 + 4 bytes each), not this design's slots
        col_bytes(cols, n) + n * 12 + 8 * J.N_STATS,
        lambda: torch.sort(bkeys), "torch.sort of the build keys",
        f"q3 sf1 build: cap {cols[0][0].numel()}, {n} rows, {len(cols)} "
        f"key column(s), {slots} hash slots"))

    # K5 dense mode at q3's dense build (customer)
    dcols, dnr, dstats, size = cap.calls[("join_dense_cuda", label)][1]
    dn = int(dnr)
    table = originals["join_dense"](dcols, dnr, dstats, size)
    wtable = J.join_dense_plain(dcols, dnr, dstats, size)
    if not torch.equal(table, wtable):
        fail("K5 dense mode differs from its twin at q3's build")
    dkey, dnull = J._key_cols(dcols)
    ok = (torch.arange(dkey.numel(), device=dev) < dn) & ~dnull
    raw = (dkey - dstats[J.KMIN])[ok]
    drows = torch.nonzero(ok).flatten().to(torch.int32)
    lib_table = torch.full((size,), 2**31 - 1, dtype=torch.int32,
                           device=dev)
    out.append(row(
        "join_dense (K5 dense mode, build_dense_table)",
        "trino_tpu_torch/csrc/join_build.cu", "trino_tpu/ops/join.py:172",
        "join_dense", 0.0,
        lambda: originals["join_dense"](dcols, dnr, dstats, size),
        lambda: J.join_dense_plain(dcols, dnr, dstats, size),
        col_bytes(dcols, dn) + size * 4,
        lambda: lib_table.scatter_reduce_(0, raw, drows, "amin"),
        "Tensor.scatter_reduce_ (amin)",
        f"q3 sf1 dense build: {dn} rows, table of {size} slots"))

    # K6 at q3's largest probe (the lineitem buffer)
    pcols, bcols, pnr, prep = cap.calls[("unique_probe_cuda", label)][1]
    pn = int(pnr)
    f, b, c = originals["unique_probe"](pcols, bcols, pnr, prep)
    bnr = prep.build.num_rows
    wst, wlk = J.join_build_plain(bcols, bnr)
    wprep = J.Prepared(prep.build, prep.keys, wst, wlk)
    if prep.dense is not None:
        wprep.dense = J.join_dense_plain(bcols, bnr, wst,
                                         prep.dense.numel())
    wf, wb, wc = J.unique_probe_plain(pcols, bcols, pnr, wprep)
    if int(c) != int(wc) or not torch.equal(f, wf) or not torch.equal(b,
                                                                       wb):
        fail("K6 differs from its twin at q3's probe")
    route = "dense" if prep.dense is not None else "search"
    bn = int(bnr)
    sorted_b = torch.sort(bcols[0][0][:bn]).values
    pk = pcols[0][0][:pn]
    pcap = pcols[0][0].numel()
    out.append(row(
        "unique_probe (K6, unique_inner_probe)",
        "trino_tpu_torch/csrc/join_probe.cu", "trino_tpu/ops/join.py:669",
        "unique_probe", 0.0,
        lambda: originals["unique_probe"](pcols, bcols, pnr, prep),
        lambda: J.unique_probe_plain(pcols, bcols, pnr, wprep),
        # the live probe keys read and found + brow (9 bytes) written once,
        # and the build's live keys and rows (8 + 4 bytes) read once; the
        # padding past the live rows is undefined and counts nothing
        col_bytes(pcols, pn) + pn * 9 + bn * 12,
        lambda: torch.searchsorted(sorted_b, pk),
        "torch.searchsorted into the sorted build keys",
        f"q3 sf1 probe: cap {pcap}, {pn} live, {int(c)} matched, route "
        f"{route}, build {bn} rows"))

    # K7 at q3's largest gather
    garrays, idx = cap.calls[("gather_rows_cuda", label)][1]
    got = originals["gather_rows"](garrays, idx)
    want = P.gather_rows_plain(garrays, idx)
    if not all(same_bits(x, y) for x, y in zip(got, want)):
        fail("K7 differs from its twin at q3's gather")
    gn = idx.numel()
    gsrc = garrays[0].numel()
    gstack = torch.stack([a.to(torch.int64) for a in garrays])
    gidx = idx.to(torch.int64).clamp(0, max(gsrc - 1, 0))
    grow_b = sum(a.element_size() for a in garrays)
    out.append(row(
        "gather_rows (K7, Column.gather / attach_build)",
        "trino_tpu_torch/csrc/gather.cu", "trino_tpu/page.py:205",
        "gather_rows", 0.0, lambda: originals["gather_rows"](garrays, idx),
        lambda: P.gather_rows_plain(garrays, idx),
        gn * idx.element_size() + 2 * gn * grow_b,
        lambda: gstack.index_select(1, gidx),
        "index_select of the stacked columns",
        f"q3 sf1: {gn} rows gathered from {gsrc}, {len(garrays)} arrays"))

    # K8 at q3's largest GROUP BY call
    keys, states, gnr, gcap = cap.calls[("group_reduce_cuda", label)][1]
    got = originals["group_aggregate"](keys, states, gnr, gcap)
    want = A.group_reduce_plain(keys, states, gnr, gcap)
    err = compare_groups("K8 main path", states, got, want)
    n8, ng = int(gnr), int(want[3])
    key_b = sum(k.values.element_size() + (k.valid is not None)
                for k in keys)
    state_b = sum((8 if s.values is not None else 0) + (s.valid is not None)
                  + (s.mask is not None) for s in states)
    live = torch.arange(gcap, device=dev) < n8
    canon = torch.stack([p.to(torch.int64) for k in keys
                         for p in A._canonical(k)], 1)[live]
    contrib = torch.stack([s.values[:n8] if s.values is not None
                           else torch.ones(n8, dtype=torch.int64,
                                           device=dev)
                           for s in states], 1)
    contrib = contrib.view(torch.int64) if contrib.dtype != torch.int64 \
        else contrib

    def library():
        _, inverse = torch.unique(canon, dim=0, return_inverse=True)
        acc = torch.zeros(n8, len(states), dtype=torch.int64, device=dev)
        return acc.index_add_(0, inverse, contrib)
    out.append(row(
        "group_aggregate (K8, hash_aggregate general GROUP BY)",
        "trino_tpu_torch/csrc/group_agg.cu",
        "trino_tpu/ops/aggregate.py:520", "group_aggregate", err,
        lambda: originals["group_aggregate"](keys, states, gnr, gcap),
        lambda: A.group_reduce_plain(keys, states, gnr, gcap),
        n8 * (key_b + state_b) + ng * (key_b + 8 * len(states)),
        library, "torch.unique(dim=0, return_inverse=True) + index_add_ "
        "(two calls)",
        f"q3 sf1: cap {gcap}, {n8} live rows, {ng} groups, {len(keys)} "
        f"keys, {len(states)} states"))
    return out


def kernel_rows_expand(cap: Capture, originals, launches, dev):
    """The kernels this slice brought in, each at its largest call of the
    sf1 queries, against its twin at those inputs."""
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import join as J
    out = []

    def row(name, source, replaces, key, fn, plain, bound_bytes, library,
            library_name, shape):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[key], max_abs_err=0.0, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    def twin_prep(prep, bcols):
        """The twins' Prepared for a build the kernels prepared."""
        bnr = prep.build.num_rows
        size = 0 if prep.dense is None else prep.dense.numel()
        wst, wlk = J.join_build_plain(bcols, bnr)
        wruns, wdense = J.join_runs_plain(bcols, bnr, wst, wlk, size)
        return J.Prepared(prep.build, prep.keys, wst, wlk, wdense, wruns)

    # K5 runs mode at the largest build of the sf1 queries
    cols, nr, stats, lookup, size = cap.calls[("join_runs_cuda", "sf1")][1]
    n = int(nr)
    runs, dense = originals["join_runs"](cols, nr, stats, lookup, size)
    wst, wlk = J.join_build_plain(cols, nr)
    wruns, wdense = J.join_runs_plain(cols, nr, wst, wlk, size)
    runs_ok("main path", J.Prepared(None, (), stats, lookup, dense, runs),
            J.Prepared(None, (), wst, wlk, wdense, wruns))
    n_live = int(stats[J.N_LIVE])
    slots = lookup[2].numel()
    keys5 = cols[0][0][:n]
    out.append(row(
        "join_runs (K5 runs mode, prepare_build bperm/run_len)",
        "trino_tpu_torch/csrc/join_build.cu", "trino_tpu/ops/join.py:102",
        "join_runs", lambda: originals["join_runs"](cols, nr, stats, lookup,
                                                    size),
        lambda: J.join_runs_plain(cols, nr, wst, wlk, size),
        # the slot counts read once, 4 bytes of row per live build row
        # read and written once, and the dense table of slots
        slots * 4 + n_live * 8 + size * 4,
        lambda: torch.argsort(keys5, stable=True),
        "torch.argsort(stable=True) of the build keys",
        f"sf1 build: cap {cols[0][0].numel()}, {n_live} live keyed rows, "
        f"{slots} slots, dense table {size}, max_run "
        f"{int(stats[J.MAX_RUN])}"))

    # K9 expanding (launch A + B) at the largest expanding probe of sf1
    pcols, bcols, pnr, prep, kind = cap.calls[("expand_count_cuda",
                                               "sf1")][1]
    pn = int(pnr)
    wprep = twin_prep(prep, bcols)
    bcap = bcols[0][0].numel()
    c = originals["expand_count"](pcols, bcols, pnr, prep, kind)
    w = J.expand_count_plain(pcols, bcols, pnr, wprep, kind)
    total = int(w.total)
    if int(c.total) != total or not torch.equal(c.emit, w.emit):
        fail("K9 launch A differs from its twin at the main path's inputs")
    out_cap = max(total, 1)
    m = torch.zeros(bcap, dtype=torch.bool, device=dev)
    p, b = originals["expand_write"](pcols, bcols, c, kind, out_cap, m)
    wp, wb = J.expand_write_plain(pcols, bcols, w, kind, out_cap,
                                  torch.zeros_like(m))
    if not (torch.equal(p[:total], wp[:total])
            and torch.equal(b[:total], wb[:total])):
        fail("K9 launch B differs from its twin at the main path's inputs")

    def expand():
        cc = originals["expand_count"](pcols, bcols, pnr, prep, kind)
        return originals["expand_write"](pcols, bcols, cc, kind, out_cap, m)

    def expand_plain():
        ww = J.expand_count_plain(pcols, bcols, pnr, wprep, kind)
        return J.expand_write_plain(pcols, bcols, ww, kind, out_cap, m)
    cands = int(w.cand_len.sum())
    key_b = sum(v.element_size() + (m_ is not None) for v, m_ in bcols)
    pidx = torch.arange(pcols[0][0].numel(), device=dev)
    emit = w.emit.to(torch.int64)
    out.append(row(
        "expand_count + expand_write (K9, hash_join expanding)",
        "trino_tpu_torch/csrc/join_expand.cu", "trino_tpu/ops/join.py:200",
        "expand_count", expand, expand_plain,
        # live probe keys read once, one lookup entry (start + length) per
        # live probe row, a composite key's candidates' key columns, and
        # 16 bytes of (probe row, build row) per output row written once
        col_bytes(pcols, pn) + pn * 8
        + (cands * key_b if len(pcols) > 1 else 0) + total * 16,
        lambda: torch.repeat_interleave(pidx, emit),
        "torch.repeat_interleave over the counts",
        f"sf1 {kind} probe: cap {pcols[0][0].numel()}, {pn} live, {total} "
        f"output rows, {len(pcols)} key column(s), route "
        f"{'dense' if prep.dense is not None else 'search'}, build "
        f"{int(prep.stats[J.N_LIVE])} keyed rows"))

    # K9 SEMI/ANTI/MARK at the largest verdict probe of sf1
    pcols, bcols, pnr, prep, kind, null_aware = cap.calls[
        ("probe_verdict_cuda", "sf1")][1]
    pn = int(pnr)
    wprep = twin_prep(prep, bcols)
    f, f2 = originals["probe_verdict"](pcols, bcols, pnr, prep, kind,
                                       null_aware)
    wf, wf2 = J.probe_verdict_plain(pcols, bcols, pnr, wprep, kind,
                                    null_aware)
    if not torch.equal(f, wf) or (f2 is not None
                                  and not torch.equal(f2, wf2)):
        fail("K9 verdict differs from its twin at the main path's inputs")
    bn = int(prep.build.num_rows)
    pk, bk = pcols[0][0][:pn], bcols[0][0][:bn]
    out.append(row(
        "probe_verdict (K9 SEMI/ANTI/MARK, hash_join + _mark_page)",
        "trino_tpu_torch/csrc/join_expand.cu", "trino_tpu/ops/join.py:86",
        "probe_verdict",
        lambda: originals["probe_verdict"](pcols, bcols, pnr, prep, kind,
                                           null_aware),
        lambda: J.probe_verdict_plain(pcols, bcols, pnr, wprep, kind,
                                      null_aware),
        # live probe keys read once, one lookup entry per live row, and
        # the verdict byte (MARK: two) written once
        col_bytes(pcols, pn) + pn * 8 + pn * (2 if f2 is not None else 1),
        lambda: torch.isin(pk, bk), "torch.isin of the probe keys",
        f"sf1 {kind} (null_aware {null_aware}) probe: cap "
        f"{pcols[0][0].numel()}, {pn} live, build {bn} rows, "
        f"{len(pcols)} key column(s)"))

    # K8 distinct mode at the largest DISTINCT aggregate of sf1 (q16)
    keys, eligible = cap.calls[("distinct_mask_cuda", "sf1")][1]
    mark = originals["distinct_mask"](keys, eligible)
    want = A.distinct_mask_plain(keys, eligible)
    canon = torch.stack([p_.to(torch.int64) for k in keys
                         for p_ in A._canonical(k)], 1)
    n_el = int(eligible.sum())
    if int(mark.sum()) != int(want.sum()) or bool((mark & ~eligible).any()) \
            or torch.unique(canon[mark], dim=0).shape[0] != int(want.sum()):
        fail("K8 distinct mode differs from its twin at the main path's "
             "inputs")
    key_b = sum(k.values.element_size() + (k.valid is not None)
                for k in keys)
    el_rows = canon[eligible]
    out.append(row(
        "distinct_mask (K8 distinct mode, _distinct_first_mask)",
        "trino_tpu_torch/csrc/group_agg.cu",
        "trino_tpu/ops/aggregate.py:818", "distinct_mask",
        lambda: originals["distinct_mask"](keys, eligible),
        lambda: A.distinct_mask_plain(keys, eligible),
        # the eligible rows' keys and argument read once, and a mask byte
        # per row written once
        n_el * (key_b + 1),
        lambda: torch.unique(el_rows, dim=0), "torch.unique(dim=0)",
        f"sf1 DISTINCT: cap {eligible.numel()}, {n_el} eligible rows, "
        f"{int(want.sum())} distinct, {len(keys)} key columns"))
    return out


if __name__ == "__main__":
    main()
