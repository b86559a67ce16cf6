"""Drive the PyTorch port (trino_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines before the next starts:
  1. card: name and power limit, torch/CUDA versions, kernel build time
     (every csrc/*.cu built by nvcc in parallel; the Triton kernels
     compile at their first launch);
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
     form, the string paths, try_cast and the date units; K12 and K13
     (the mxu route's table and lookup, in K6 and in K9 for every kind)
     at table sizes 128 and 4096; K14/K15 (TPC-H generation) over every
     generated column of the six tables at sf1 and one sf10 lineitem
     chunk, bit for bit against the twins and the NumPy chunks; K16-K19
     (the spilled join's keys and probe, the spill partitioner in hash,
     rank and range modes, the bypass states) over NULL, dead, -1, NaN,
     -0.0, bool and code keys, duplicate and empty builds, wide spans,
     salts 0-3, 1/4/16 partitions and NULLs first and last, bit for bit;
     K20-K23 (the window operator: segment bounds, ranking and value
     functions, framed aggregates, bounded min/max) over WIN_PAGES (a
     4,194,304-row page; NULL, NaN and -0.0 keys; an empty page; one-row
     partitions; no partition keys; no order keys; dictionary keys) and
     every function under whole, running and bounded frames (0 PRECEDING
     AND 0 FOLLOWING, and frames wider than the partition), K20 bit for
     bit, the others exactly but for doubles (1e-9 of the partition's
     |x| sum); K24-K27 (the fused aggregating join's table in both
     modes, lookup, key bounds and NULL masks) over AGG_CASES (128 to
     65,536 slots, 8 and 256 keys under 1.5M build rows, NULL and dead
     rows, negative and double keys, sums past 2^53, an all-NULL column,
     an empty build, a dead probe): integers, masks and mag_ok exact,
     float64 sums to 1e-9 relative; K28-K31 (the special aggregates: K8's
     group-id mode, the hash in checksum and HLL modes, the centered,
     positional and HLL-fold reductions, the percentile pick) over
     SPECIAL_CASES (empty pages, one row, one group, 3 to 2^20 groups;
     NULLs, NaN, +-0.0, +-inf, ties at the extremum and at the picked
     rank, a FILTER, negative narrow integers): exact but for the
     centered doubles (1e-9 relative or of the column's largest value);
     K32-K34 (the list layouts: K1, K7 and K2 moving planes of L 1, 8
     and 128, K2 padding a narrower page; K33's size, array and map
     modes over LIST_CASES, and its map mode's direct-address and sort
     routes over MAP_CASES, on each side of G x span's and the span's
     limits; K34's count and expand) bit for bit; K35
     (the exchange pack's count and scatter in hash, spread and replicate
     modes) and K36 (heavy keys, local and merge modes) over
     EXCHANGE_CASES (n = 1, 2, 4, 8; NULL, dead, -1, NaN, -0.0, bool,
     code and composite keys; empty shards, one destination past its
     bucket, heavy sets of 0, 1 and 8 keys, ties, a 4,194,304-row page)
     and whole exchanges of 8 shards on the card against the CPU, bit for
     bit; K36's local mode over HEAVY_CASES (cap 0, cap < k, all
     sentinel, every live word distinct, fewer keys than k, a run of
     1,000,000, runs from tile boundaries, a D4 sf10 q9 shard's shape) at
     k 1, 8 and 64, two calls in a row, and K27 for 0, 1, 2, 9 and 40
     helpers, one launch a call each; K35's scatter over SCATTER_CASES
     (num_rows 0, inside a tile, on a tile boundary and at the capacity;
     n 1 to 64; a heavy key replicated and spread past the bucket; list
     planes; a D4 sf10 q9 shard) over every occupied slot, and K25 over
     LOOKUP_CASES (num_rows 0, part and all, a 32,768-slot table, 70
     outputs, G3's probe) on the live rows, one launch a call and one
     enqueue a call at the largest case each;
  3. the 22 TPC-H queries, a FULL join, a MARK query and the window,
     grouping-set and UNION queries W1-W6 and W8 at sf1, and q6, q3, q9,
     q13 and W7 at sf10 (the reference's default session, spill on) from SQL
     through LocalQueryRunner.tpch(schema).execute(sql) on cuda, tables
     generated on the card, rows held equal to the same queries through
     the port on the CPU with tables from NumPy; each join's kind, route,
     build live rows, max_run, probe and output rows, each query's mxu
     routes and mxu_joins equal to the CPU's; no filter or project step
     evaluated by the torch-op compiler, no sort by the plain twin, no
     window function by a plain twin and no generated column staged from
     NumPy on the card; each WindowNode's rows, partitions, peer groups,
     functions and frames (`[window]`); the first-run walls
     of q6/q9 at sf1 and each table's generation seconds at sf1/sf10,
     K14/K15 against the NumPy path; each sf10 join's route with its build,
     device and host bytes and each sf10 query's spill counters; then the
     forced-threshold path (FORCED: q3 and q9 past a lowered join
     threshold, a composite unique build, the lineitem self-join, a
     high-NDV GROUP BY and a spilled ORDER BY at sf1), each equal to the
     card's run of the same SQL under the default session, which must
     launch K16-K19 and take spill-dense, spill-search and partitioned;
     then TPCDS at sf1: the TPC-DS queries of tests/test_tpcds.py, the two
     router variants of tests/test_mxu_join.py and G1-G4, the shapes of
     the fused aggregating join (G3 on TPC-H sf1), tables staged from
     NumPy; rows, join routes, mxu_joins and mxu_flops equal to the CPU
     port's, no fused join through a plain twin (`[fused]`); q72, whose
     inventory x catalog_sales join on item_sk alone needs more than the
     card's memory at sf1, reports the join that stopped it
     (`[ds-stopped]`) and is not compared; then the special-aggregate
     path: SPECIAL_QUERIES (S1-S7, S1 also at sf10) with every count set
     to 0 before it, each query's groups, rows and K28-K31 launches
     (`[special]`), rows equal to the CPU port's, K28-K31 each launched
     and no special aggregate through a plain twin; then the list path:
     LIST_QUERIES (L1-L6 at sf1, L2 also at sf10) with every count set
     to 0 before it, each query's groups, L, list rows, plane bytes,
     UNNEST slots and K32-K34 launches (`[list]`), rows equal to the CPU
     port's (L2 at sf10 to its lineitem identity, LIST_IDENTITY), each
     list kernel launched, no list operation through a plain twin and no
     step through the torch-op compiler; then the distributed path:
     DIST_QUERIES (D1 the 22 queries at sf1, D2 PARTITIONED joins, D3 the
     skewed pair with skew on and off, D4 q3 and q9 at sf10, D5 the
     dispatch loop) through DistributedQueryRunner over 8 shards of the
     card with every count set to 0 before it, an `[exchange]` line per
     query (fused and staged exchanges, rows, bytes, buckets, heavy keys,
     per-shard peaks), rows equal to the card's local runner, K35, K36,
     K2 and K10 launched, no plain twin and no torch-op step on the card;
  4. every kernel, every expanding-probe kind and the mxu, dense, search
     and cross routes launched during phase 3 (K16-K19 on the forced
     path; the host attach's ms per batch beside a pinned copy of the
     bytes it moves; K20-K23 at the window queries' largest sf1 calls;
     K24-K27 at their largest call of the TPC-DS runs, K24 also through
     its global-atomics mode; K28-K31 at their largest call of the
     special-aggregate path; the S queries' warm walls too; K32-K34 and
     K11's list steps at their largest call of the list path, and the L
     queries' warm walls; K35, K36 and K2 as the exchange receive at
     their largest call of the distributed path, and each D query's warm
     wall and idle share);
     per kernel its launches,
     its time at the main path's shapes (CUDA events; K10 and K11 also
     their host time per call), its bound, its plain twin's time and a
     one-call PyTorch yardstick; each query's warm wall time, idle share
     and top device and host costs. `[time]` lines give each phase's
     seconds.
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


# The window, grouping-set and UNION queries of the window slice (W1-W8):
# name -> (schema, label, SQL). ROWS frames, row_number, lead/lag and
# first/last/nth_value order on a unique key, so that the card and the
# CPU cannot differ within ties; the rows compare as multisets.
# tests/test_torch_window_queries.py runs the same texts at tiny against
# the reference.
WINDOW_QUERIES = {
    "W1": ("sf1", "topn_per_group", """SELECT o_custkey, o_orderkey, o_totalprice, rn, rk, running
FROM (SELECT o_custkey, o_orderkey, o_totalprice,
             row_number() OVER (PARTITION BY o_custkey
                                ORDER BY o_totalprice DESC, o_orderkey) AS rn,
             rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rk,
             sum(o_totalprice) OVER (PARTITION BY o_custkey
                                     ORDER BY o_orderdate) AS running
      FROM orders) t
WHERE rn <= 2"""),
    "W2": ("sf1", "bounded", """SELECT l_partkey, count(*), sum(a), max(m), min(prev)
FROM (SELECT l_partkey,
             avg(l_quantity) OVER (PARTITION BY l_partkey
                 ORDER BY l_orderkey, l_linenumber
                 ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS a,
             max(l_extendedprice) OVER (PARTITION BY l_partkey
                 ORDER BY l_orderkey, l_linenumber
                 ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS m,
             lag(l_shipdate) OVER (PARTITION BY l_partkey
                 ORDER BY l_orderkey, l_linenumber) AS prev
      FROM lineitem) t
WHERE prev IS NOT NULL
GROUP BY l_partkey"""),
    "W3": ("sf1", "rollup_rank", """SELECT o_orderpriority, o_orderstatus, sum(o_totalprice) AS s,
       grouping(o_orderpriority, o_orderstatus) AS g,
       rank() OVER (PARTITION BY grouping(o_orderpriority, o_orderstatus)
                    ORDER BY sum(o_totalprice) DESC) AS r
FROM orders
GROUP BY ROLLUP (o_orderpriority, o_orderstatus)"""),
    "W4": ("sf1", "cube", """SELECT o_orderstatus, o_orderpriority, count(*), sum(o_totalprice)
FROM orders
GROUP BY CUBE (o_orderstatus, o_orderpriority)"""),
    "W5": ("sf1", "union_all", """SELECT k, count(*), sum(v)
FROM (SELECT o_orderkey AS k, o_totalprice AS v FROM orders
      WHERE o_orderdate < DATE '1993-01-01'
      UNION ALL
      SELECT l_orderkey AS k, l_extendedprice AS v FROM lineitem
      WHERE l_shipdate > DATE '1998-11-01') t
GROUP BY k"""),
    "W6": ("sf1", "union_str", """SELECT c_mktsegment FROM customer
UNION
SELECT n_name FROM nation"""),
    "W7": ("sf10", "share", """SELECT l_suppkey, l_orderkey, l_linenumber, share, r
FROM (SELECT l_suppkey, l_orderkey, l_linenumber,
             CAST(l_extendedprice AS double)
               / sum(CAST(l_extendedprice AS double))
                 OVER (PARTITION BY l_suppkey) AS share,
             rank() OVER (PARTITION BY l_suppkey
                          ORDER BY l_extendedprice DESC, l_orderkey,
                                   l_linenumber) AS r
      FROM lineitem) t
WHERE r <= 3"""),
    "W8": ("sf1", "rank_dist", """SELECT o_orderpriority, count(*), sum(dr), sum(pr), sum(cd), sum(nt),
       min(fv), max(lv), sum(nv), count(nv), sum(ld), sum(mn), count(mn),
       sum(cnt)
FROM (SELECT o_orderpriority,
             dense_rank() OVER (PARTITION BY o_custkey
                                ORDER BY o_orderdate) AS dr,
             percent_rank() OVER (PARTITION BY o_custkey
                                  ORDER BY o_orderdate) AS pr,
             cume_dist() OVER (PARTITION BY o_custkey
                               ORDER BY o_orderdate) AS cd,
             ntile(4) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) AS nt,
             first_value(o_clerk) OVER (PARTITION BY o_custkey
                                        ORDER BY o_orderkey) AS fv,
             last_value(o_clerk) OVER (PARTITION BY o_custkey
                 ORDER BY o_orderkey
                 ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING)
               AS lv,
             nth_value(o_orderkey, 2) OVER (PARTITION BY o_custkey
                 ORDER BY o_orderkey
                 ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING)
               AS nv,
             lead(o_shippriority, 2, -1) OVER (PARTITION BY o_custkey
                                               ORDER BY o_orderkey) AS ld,
             min(o_totalprice) OVER (PARTITION BY o_custkey
                 ORDER BY o_orderkey
                 ROWS BETWEEN 1 FOLLOWING AND UNBOUNDED FOLLOWING) AS mn,
             count(*) OVER (PARTITION BY o_custkey) AS cnt
      FROM orders) t
GROUP BY o_orderpriority"""),
}


# The TPC-DS queries of tests/test_tpcds.py and the two router variants of
# tests/test_mxu_join.py (q72 and q64's core under the forced session:
# density threshold 0, 65,536 slots), then G1-G4, the shapes that enter
# the fused aggregating join (B11b): name -> (catalog, session, SQL,
# whether the rows come in a defined order). tests/test_torch_tpcds.py and
# tests/test_torch_join_mxu_agg.py hold these texts equal to the tests'
# and run them at tiny against the reference; phase 3 runs them at sf1.
FORCED_MXU = (("mxu_join_density_threshold", 0.0),
              ("mxu_join_max_slots", 65536))
TPCDS = {
    "ds_scan": ("tpcds", (), (
        "SELECT count(*), count(DISTINCT d_year) FROM date_dim "
        "WHERE d_year BETWEEN 1998 AND 2002"), False),
    "ds_q3": ("tpcds", (), """
SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) AS sum_agg
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manufact_id = 436 AND d_moy = 12
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, i_brand_id LIMIT 100""", True),
    "ds_q42": ("tpcds", (), """
SELECT d_year, i_category_id, i_category, sum(ss_ext_sales_price)
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manufact_id > 500 AND d_year = 2000 AND d_moy = 11
GROUP BY d_year, i_category_id, i_category
ORDER BY 4 DESC, d_year, i_category_id, i_category LIMIT 100""", True),
    "ds_q64": ("tpcds", (), """
WITH cs_ui AS (
  SELECT cs_item_sk,
         sum(cs_ext_list_price) AS sale,
         sum(cr_refunded_cash + cr_return_amount) AS refund
  FROM catalog_sales, catalog_returns
  WHERE cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number
  GROUP BY cs_item_sk
  HAVING sum(cs_ext_list_price) > 2 * sum(cr_refunded_cash
                                          + cr_return_amount))
SELECT i_product_name, s_store_name, s_zip, d1.d_year,
       count(*) AS cnt,
       sum(ss_wholesale_cost) AS s1, sum(ss_list_price) AS s2,
       sum(ss_coupon_amt) AS s3
FROM store_sales, store_returns, cs_ui, date_dim d1,
     customer, customer_demographics cd1, household_demographics hd1,
     customer_address ad1, income_band ib1, item, store
WHERE ss_store_sk = s_store_sk
  AND ss_sold_date_sk = d1.d_date_sk
  AND ss_customer_sk = c_customer_sk
  AND ss_cdemo_sk = cd1.cd_demo_sk
  AND ss_hdemo_sk = hd1.hd_demo_sk
  AND ss_addr_sk = ad1.ca_address_sk
  AND ss_item_sk = i_item_sk
  AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND ss_item_sk = cs_ui.cs_item_sk
  AND hd1.hd_income_band_sk = ib1.ib_income_band_sk
  AND i_color IN ('maroon', 'burnished', 'dim', 'steel', 'navajo',
                  'chocolate')
  AND i_current_price BETWEEN 35 AND 45
GROUP BY i_product_name, s_store_name, s_zip, d1.d_year
ORDER BY i_product_name, s_store_name, cnt LIMIT 100""", True),
    "ds_q72": ("tpcds", (), """
SELECT i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(CASE WHEN p_promo_sk IS NULL THEN 1 ELSE 0 END) no_promo,
       sum(CASE WHEN p_promo_sk IS NOT NULL THEN 1 ELSE 0 END) promo,
       count(*) total_cnt
FROM catalog_sales
JOIN inventory ON (cs_item_sk = inv_item_sk)
JOIN warehouse ON (w_warehouse_sk = inv_warehouse_sk)
JOIN item ON (i_item_sk = cs_item_sk)
JOIN customer_demographics ON (cs_bill_cdemo_sk = cd_demo_sk)
JOIN household_demographics ON (cs_bill_hdemo_sk = hd_demo_sk)
JOIN date_dim d1 ON (cs_sold_date_sk = d1.d_date_sk)
JOIN date_dim d2 ON (inv_date_sk = d2.d_date_sk)
JOIN date_dim d3 ON (cs_ship_date_sk = d3.d_date_sk)
LEFT JOIN promotion ON (cs_promo_sk = p_promo_sk)
LEFT JOIN catalog_returns ON (cr_item_sk = cs_item_sk
                              AND cr_order_number = cs_order_number)
WHERE d1.d_week_seq = d2.d_week_seq
  AND inv_quantity_on_hand < cs_quantity
  AND d3.d_date > d1.d_date + INTERVAL '5' DAY
  AND hd_buy_potential = '>10000'
  AND d1.d_year = 1999
  AND cd_marital_status = 'D'
GROUP BY i_item_desc, w_warehouse_name, d1.d_week_seq
ORDER BY total_cnt DESC, i_item_desc, w_warehouse_name, d1.d_week_seq
LIMIT 100""", True),
    "ds_inventory_week": ("tpcds", (), (
        "SELECT w_state, count(*) FROM inventory, warehouse, date_dim "
        "WHERE inv_warehouse_sk = w_warehouse_sk "
        "AND inv_date_sk = d_date_sk AND d_year = 2000 "
        "AND inv_quantity_on_hand < 10 GROUP BY w_state"), False),
    "ds_q72_router": ("tpcds", FORCED_MXU, """
SELECT i_item_desc, w_warehouse_name, d1.d_week_seq, count(*) total_cnt
FROM catalog_sales
JOIN inventory ON (cs_item_sk = inv_item_sk)
JOIN warehouse ON (w_warehouse_sk = inv_warehouse_sk)
JOIN item ON (i_item_sk = cs_item_sk)
JOIN date_dim d1 ON (cs_sold_date_sk = d1.d_date_sk)
JOIN date_dim d2 ON (inv_date_sk = d2.d_date_sk)
WHERE d1.d_week_seq = d2.d_week_seq
  AND inv_quantity_on_hand < cs_quantity AND d1.d_year = 1999
GROUP BY i_item_desc, w_warehouse_name, d1.d_week_seq
ORDER BY total_cnt DESC, i_item_desc, w_warehouse_name, d1.d_week_seq
LIMIT 100""", True),
    "ds_q64_router": ("tpcds", FORCED_MXU, """
SELECT i_product_name, d1.d_year, count(*) AS cnt,
       sum(ss_wholesale_cost) AS s1
FROM store_sales, store_returns, date_dim d1, item
WHERE ss_sold_date_sk = d1.d_date_sk
  AND ss_item_sk = i_item_sk
  AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND i_current_price BETWEEN 35 AND 45
GROUP BY i_product_name, d1.d_year
ORDER BY i_product_name, d1.d_year, cnt LIMIT 100""", True),
    "G1": ("tpcds", (), """SELECT ss_sold_date_sk, count(*), sum(ss_quantity),
       sum(s_number_employees), count(s_store_name)
FROM store_sales, store WHERE ss_store_sk = s_store_sk
GROUP BY ss_sold_date_sk""", False),
    "G2": ("tpcds", FORCED_MXU, """SELECT ss_store_sk, count(*), sum(ss_quantity),
       sum(i_brand_id), count(i_brand)
FROM store_sales, item WHERE ss_item_sk = i_item_sk
GROUP BY ss_store_sk""", False),
    "G3": ("tpch", FORCED_MXU, """SELECT g, count(*), sum(v), sum(w)
FROM (SELECT l_orderkey % 256 AS k, l_suppkey % 16 AS g,
             l_linenumber AS v FROM lineitem) p,
     (SELECT o_orderkey % 256 AS k, o_custkey AS w FROM orders) b
WHERE p.k = b.k GROUP BY g""", False),
    "G4": ("tpcds", (), """SELECT DISTINCT ss_sold_date_sk
FROM store_sales, store WHERE ss_store_sk = s_store_sk""", False),
}


# The special aggregates (ROADMAP B8) on TPC-H: name -> (schema, SQL).
# S1 puts lineitem on 4 groups (K30's contention case, also at sf10), S2
# and S4 on about 100,000 customers, S5 and S6 on 10,000 suppliers; S3
# is global with DISTINCT, S7 checksum through K4 (PARTIAL/FINAL), K3
# (dictionary keys) and K8.
S1_SQL = """SELECT l_returnflag, l_linestatus,
       stddev(l_extendedprice), stddev_pop(l_quantity),
       var_samp(l_discount), variance(l_tax),
       corr(l_extendedprice, l_quantity),
       covar_pop(l_quantity, l_extendedprice),
       covar_samp(l_quantity, l_extendedprice),
       regr_slope(l_extendedprice, l_quantity),
       regr_intercept(l_extendedprice, l_quantity)
FROM lineitem GROUP BY 1, 2"""
SPECIAL_QUERIES = {
    "S1": ("sf1", S1_SQL),
    "S1_sf10": ("sf10", S1_SQL),
    "S2": ("sf1", """SELECT o_custkey, stddev_samp(o_totalprice),
       var_pop(o_totalprice)
FROM orders GROUP BY o_custkey"""),
    "S3": ("sf1", """SELECT var_pop(DISTINCT l_quantity),
       stddev(DISTINCT l_discount), var_samp(l_extendedprice),
       corr(l_quantity, l_extendedprice)
FROM lineitem"""),
    "S4": ("sf1", """SELECT o_custkey, min_by(o_orderkey, o_totalprice),
       max_by(o_orderdate, o_totalprice), arbitrary(o_orderpriority)
FROM orders GROUP BY o_custkey"""),
    "S4_global": ("sf1", """SELECT min_by(l_orderkey, l_extendedprice),
       max_by(l_comment, l_extendedprice), arbitrary(l_shipmode)
FROM lineitem"""),
    "S5": ("sf1", """SELECT l_suppkey, approx_distinct(l_partkey),
       approx_distinct(l_orderkey)
FROM lineitem GROUP BY l_suppkey"""),
    "S5_global": ("sf1", """SELECT approx_distinct(l_orderkey),
       approx_distinct(l_comment), approx_distinct(l_extendedprice)
FROM lineitem"""),
    "S6": ("sf1", """SELECT o_orderpriority,
       approx_percentile(o_totalprice, 0.5e0),
       approx_percentile(o_totalprice, 0.99e0)
FROM orders GROUP BY 1"""),
    "S6_supp": ("sf1", """SELECT l_suppkey,
       approx_percentile(l_extendedprice, 0.9e0)
FROM lineitem GROUP BY l_suppkey"""),
    "S7": ("sf1", """SELECT checksum(l_orderkey), checksum(l_extendedprice),
       checksum(l_shipdate), checksum(l_comment), checksum(l_discount)
FROM lineitem"""),
    "S7_dict": ("sf1", """SELECT l_returnflag, checksum(l_partkey)
FROM lineitem GROUP BY 1"""),
    "S7_general": ("sf1", """SELECT o_custkey, checksum(o_orderkey)
FROM orders GROUP BY o_custkey"""),
}


# The list path (ARRAY and MAP): array_agg, UNNEST, histogram, map_agg and
# the list calls, read by tests/test_torch_list_queries.py too: name ->
# (schema, SQL). L2_sf10 is held on the card to the identity of its
# lineitem (LIST_IDENTITY), not run on the CPU.
L2_SQL = """SELECT count(*), sum(e), sum(o) FROM (SELECT l_orderkey,
       array_agg(l_partkey) ks FROM lineitem GROUP BY l_orderkey)
CROSS JOIN UNNEST(ks) WITH ORDINALITY AS u(e, o)"""
LIST_QUERIES = {
    "L1": ("sf1", """SELECT l_orderkey, array_agg(l_partkey) FROM lineitem
GROUP BY l_orderkey ORDER BY l_orderkey LIMIT 1000"""),
    "L2": ("sf1", L2_SQL),
    "L2_sf10": ("sf10", L2_SQL),
    "L3": ("sf1", """SELECT l_suppkey, histogram(l_shipmode) FROM lineitem
GROUP BY l_suppkey ORDER BY l_suppkey LIMIT 100"""),
    "L4": ("sf1", """SELECT count(*), sum(cardinality(m)),
       sum(element_at(m, p)), count(element_at(m, k))
FROM (SELECT ps_suppkey k, min(ps_partkey) p,
             map_agg(ps_partkey, ps_supplycost) m
      FROM partsupp GROUP BY ps_suppkey)"""),
    "L5": ("sf1", """SELECT l_returnflag,
       sum(cardinality(ARRAY[l_partkey, l_suppkey])),
       sum(element_at(ARRAY[l_quantity, l_extendedprice], 2)),
       sum(CASE WHEN contains(ARRAY[l_partkey, l_suppkey], 7) THEN 1
           ELSE 0 END)
FROM lineitem GROUP BY l_returnflag"""),
    "L6": ("sf1", """SELECT e, count(*) FROM orders
CROSS JOIN UNNEST(ARRAY[o_custkey % 7, o_shippriority]) AS u(e)
GROUP BY e ORDER BY e"""),
}
# L2's rows from lineitem alone: each order's array holds its l_partkey
# values and its ordinals run 1..n, as its l_linenumber values do
LIST_IDENTITY = {"L2_sf10": """SELECT count(*), sum(l_partkey),
       sum(l_linenumber) FROM lineitem"""}


def tpcds_runners(schema: str, device=None, device_gen=None) -> dict:
    """One runner per (catalog, session) of TPCDS at `schema` (TPC-DS
    through `USE tpcds.<schema>`)."""
    from trino_tpu_torch.exec import LocalQueryRunner
    out = {}
    for catalog, session, _, _ in TPCDS.values():
        if (catalog, session) in out:
            continue
        r = LocalQueryRunner.tpch(schema, device=device,
                                  device_gen=device_gen)
        if catalog == "tpcds":
            r.execute(f"USE tpcds.{schema}")
        for k, v in session:
            r.session.set(k, v)
        out[(catalog, session)] = r
    return out


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


def host_ms(fn, iters: int = 50) -> float:
    """Host milliseconds per call of `fn` (enqueue only, no sync)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    sync()
    return (t1 - t0) / iters * 1e3


def device_profile(fn, iters: int = 10):
    """(device-busy ms per call, top kernels) of `fn` from torch.profiler:
    the sum of the device time of every kernel and copy it ran. A window
    in which the profiler records no device time (it has happened on the
    card for short windows) is tried once more, five times as long; None
    when that records none either."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for n in (iters, 5 * iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync()
        # device-side events only (kernels, copies): an operator's entry
        # repeats the device time of the kernels it launched
        rows = [(getattr(e, "self_device_time_total", 0.0), e.key)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        total_us = sum(t for t, _ in rows)
        if total_us > 0:
            top = sorted(rows, reverse=True)[:6]
            return total_us / n / 1e3, [(k, t / n / 1e3) for t, k in top]
    return None, []


def say_split(name: str, what: str, fn, card) -> None:
    """Print the profiler's top device time per call of `fn`."""
    _, top = device_profile(fn)
    say(f"[kernel] {name} at {what}: top device time per call: "
        + ", ".join(f"{k[:48]} {t:.4f} ms" for k, t in top) + f" — {card}")


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
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
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


# K2's phase-2 layouts: (cap, live rows, plane width or None) per page.
# Every second page lacks its validity (written as all-valid bytes).
CONCAT_CASES = {
    "mixed": [(10, 3, None), (0, 0, None), (4097, 4097, None),
              (5, 0, None)],
    "tile_edges": [(2048, 2000, None), (2049, 1, None), (1, 1, None)],
    "two_small": [(12, 4, None), (12, 4, None)],
    "large": [(4_194_304, 4_000_000, None), (1_805_652, 1_805_652, None)],
    "none_live": [(100, 0, None), (2_097_152, 0, None), (3, 0, None)],
    "single_row": [(1, 1, None)],
    "64_pages": [(1000 + 37 * i, (911 * i) % 1000, None)
                 for i in range(64)],
    "narrower_planes": [(5000, 4999, 8), (3000, 2100, 1), (2, 1, 4)],
    "receive": [(2_097_152, 20_193 + (i < 5), None) for i in range(8)],
}


def concat_layout(g, layout, dev, receive=False):
    """Seeded pages of one CONCAT_CASES layout: int64, float64 (NaN,
    -0.0), int32 and a validity (absent on odd pages), plus an int64
    plane where the layout gives its width. The receive's pages carry
    six value columns and six validities (12 arrays), all present."""
    arrays, counts = [], []
    for i, (cap, n, L) in enumerate(layout):
        ints, f, i32, valid, i16 = rng_page_arrays(g, cap, dev)
        if receive:
            pa = [ints, valid, f, valid, i32, valid, i16, valid,
                  ints.flip(0), valid, f.flip(0), valid]
        else:
            pa = [ints, f, i32, valid if i % 2 == 0 else None]
        if L is not None:
            pa.append(torch.randint(-2**40, 2**40, (cap, L), generator=g,
                                    dtype=torch.int64).to(dev))
        arrays.append(pa)
        counts.append(torch.tensor(n, dtype=torch.int32, device=dev))
    return arrays, counts, sum(c for c, _, _ in layout)


def check_concat(g, dev) -> float:
    """K2 against its twin on every CONCAT_CASES layout, bit for bit
    (rows, all-valid bytes, a narrower plane's zero padding, the total),
    one launch per call."""
    from trino_tpu_torch import page as P
    for name, layout in CONCAT_CASES.items():
        arrays, counts, out_cap = concat_layout(g, layout, dev,
                                                name == "receive")
        before = P.concat_rows_cuda.launches
        got, tot = P.concat_rows_cuda(arrays, counts, out_cap)
        sync()
        if P.concat_rows_cuda.launches != before + 1:
            fail(f"K2 {name}: not one launch")
        want, wtot = P.concat_rows_plain(arrays, counts, out_cap)
        k = int(wtot)
        if int(tot) != k:
            fail(f"K2 {name}: total {int(tot)} != {k}")
        for a, b in zip(got, want):
            if a.shape != b.shape or not same_bits(a[:k], b[:k]):
                fail(f"K2 rows differ for layout {name}")
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


# K4's phase-2 calls: (cap, live rows, states). Caps off the grid's
# stride (global_grid(cap) x 256 rows), no live row and every row live;
# 1, 8, 9 and 17 states in one launch.
GLOBAL_CASES = [(0, 0, 7), (1, 1, 7), (4097, 10, 7), (100_003, 100_003, 1),
                (100_003, 0, 8), (1_000_003, 999_999, 9),
                (4_194_304, 4_194_304, 17), (5_000_011, 4_999_000, 7)]


def global_states(g, cap, dev, k):
    """k states cycling through agg_states' seven kinds (sums, a count,
    integer and float min/max), their floats with NaN, +-0.0 and +-inf."""
    base = agg_states(g, cap, dev)
    if cap >= 300:
        for s in base:
            if s.is_float:
                s.values[3::211] = float("inf")
                s.values[4::223] = float("-inf")
                s.values[5::97] = float("nan")
    return [base[j % len(base)] for j in range(k)]


def check_global(g, dev) -> float:
    """K4 against its twin on GLOBAL_CASES (one launch per call), and two
    calls on one page whose float sums must be equal bit for bit."""
    from trino_tpu_torch.ops import aggregate as A
    worst = 0.0
    for cap, n, k in GLOBAL_CASES:
        states = global_states(g, cap, dev, k)
        num_rows = torch.tensor(n, dtype=torch.int32, device=dev)
        before = A.global_reduce_cuda.launches
        got = A.global_reduce_cuda(states, num_rows, cap)
        sync()
        if A.global_reduce_cuda.launches != before + 1:
            fail(f"K4 cap={cap}: not one launch for {k} states")
        want = A.global_reduce_plain(states, num_rows, cap)
        worst = max(worst, compare_states(f"K4 cap={cap} k={k}", states,
                                          got, want))
        again = A.global_reduce_cuda(states, num_rows, cap)
        for s, a, b in zip(states, got, again):
            if not same_bits(a, b):
                fail(f"K4 cap={cap}: two calls differ (kind {s.kind}, "
                     f"float={s.is_float})")
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


JOIN_CASES = [  # key kind, build cap, live rows, duplicates, probe cap, live
    ("dense", 5000, 4900, False, 6000, 5990),
    ("dense", 20_000, 20_000, True, 100, 100),
    ("negative", 30_000, 29_000, False, 70_000, 65_000),
    ("composite", 4096, 4096, False, 9000, 9000),
    ("composite", 3000, 3000, True, 10, 10),
    ("dense", 1000, 0, False, 500, 500),           # empty build
    ("negative", 1000, 1000, False, 500, 0),       # dead probe
    ("dense", 147_456, 147_000, False, 4_194_304, 4_194_304),
    # a 2^22-slot dense table, a probe capacity off the kernel's 4-row step
    ("dense", 1_048_576, 1_040_000, False, 1_048_577, 1_000_001)]


def launcher_enqueues(kind: str) -> int:
    """The stream operations (kernels and memsets) K5's dense mode
    (`kind` "dense": csrc/join_build.cu join_dense), K6 ("probe":
    csrc/join_probe.cu join_probe), K35's scatter ("scatter":
    csrc/exchange.cu exchange_scatter), K25 ("lookup": csrc/join_mxu.cu
    agg_lookup), K26 ("bounds": csrc/join_mxu.cu key_bounds), K17
    ("spillprobe": csrc/join_spill.cu spill_probe), K5's runs mode
    ("runs": csrc/join_build.cu join_runs) or K33's map mode ("map":
    csrc/list.cu collect_map and collect_map_pack) has enqueued in this
    process, counted by the C launcher as it enqueues them."""
    import ctypes
    from trino_tpu_torch import native
    lib, entry = {"dense": ("join_build", "join_dense_enqueues"),
                  "probe": ("join_probe", "join_probe_enqueues"),
                  "scatter": ("exchange", "exchange_scatter_enqueues"),
                  "lookup": ("join_mxu", "agg_lookup_enqueues"),
                  "bounds": ("join_mxu", "key_bounds_enqueues"),
                  "spillprobe": ("join_spill", "spill_probe_enqueues"),
                  "runs": ("join_build", "join_runs_enqueues"),
                  "map": ("list", "collect_map_enqueues")}[kind]
    fn = getattr(native.library(lib), entry)
    fn.restype = ctypes.c_int64
    return fn()


def enqueue_window(kernels: int, memsets: int, n: int) -> str:
    """What a profiler window of `n` calls that recorded `kernels` kernels
    and `memsets` memsets says: "clean" (exactly one kernel a call, no
    memset), "extra" (at least one more kernel or memset a call than
    that) or "lossy" (anything else: the profiler dropped or misplaced
    device events)."""
    if kernels == n and not memsets:
        return "clean"
    if kernels >= 2 * n or memsets >= n:
        return "extra"
    return "lossy"


def enqueues(fn, windows=(10, 50, 50)):
    """(kernels, memsets) one call of `fn` puts on the card's stream, from
    torch.profiler windows of `windows` calls each. The profiler drops
    device events now and then (whole windows late in a run), so a window
    counts only as enqueue_window classifies it: a clean one is returned
    at once, two with extra enqueues as the first of them; (None, None)
    when neither happened."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    extra = []
    for n in windows:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync()
        kernels = memsets = 0
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            if e.key.startswith("Memset"):
                memsets += e.count
            elif not e.key.startswith("Memcpy"):
                kernels += e.count
        verdict = enqueue_window(kernels, memsets, n)
        if verdict == "clean":
            return 1.0, 0.0
        if verdict == "extra":
            extra.append((kernels / n, memsets / n))
            if len(extra) == 2:
                return extra[0]
    return None, None


def one_enqueue(label: str, fn, kind: str) -> None:
    """Fail unless one call of `fn` makes one enqueue: the C launcher of
    `kind` (see launcher_enqueues) counts one stream operation a call, and
    torch.profiler sees one kernel and no memset a call wherever it
    records the calls' device events whole."""
    before = launcher_enqueues(kind)
    calls = 5
    for _ in range(calls):
        fn()
    sync()
    counted = launcher_enqueues(kind) - before
    if counted != calls:
        fail(f"{label}: the launcher enqueued {counted} operations in "
             f"{calls} calls, not one a call")
    kernels, memsets = enqueues(fn)
    if kernels is None:
        say(f"[enqueue] {label}: one enqueue a call (launcher count); the "
            f"profiler's kernel count not measured (no window recorded "
            f"the calls' device events whole)")
        return
    if kernels != 1 or memsets:
        fail(f"{label}: {kernels:g} kernels and {memsets:g} memsets a call "
             f"in two profiler windows, not one kernel")
    say(f"[enqueue] {label}: one enqueue a call (launcher count); one "
        f"kernel, no memset a call (profiler)")


def check_join(g, dev) -> float:
    """K5 (statistics, hash table, dense table) and K6 (both routes)
    against their twins; two probes in flight before one count fetch;
    one enqueue a call of K5's dense mode and of K6."""
    from trino_tpu_torch.ops import join as J
    flight = []
    for kind, bcap, bn, dup, pcap, pn in JOIN_CASES:
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
            flight.append((pcols, bcols, pnr, prep, int(wc)))
            if bcap == JOIN_CASES[-1][1]:
                if route == "dense":
                    one_enqueue(f"join_dense at {size} slots", lambda:
                                J.join_dense_cuda(bcols, bnr, stats, size),
                                "dense")
                one_enqueue(f"unique_probe {route} at {label}", lambda:
                            J.unique_probe_cuda(pcols, bcols, pnr, prep),
                            "probe")
    # every probe launched before one fetch of all their counts, as the
    # executor's probe batches do: each count lands in its own word
    counts = [J.unique_probe_cuda(pc, bc, nr, pr)[2]
              for pc, bc, nr, pr, _ in flight]
    got = torch.stack(counts).tolist()
    if got != [w for *_, w in flight]:
        fail(f"K6 counts of {len(flight)} probes in flight differ from "
             f"their twins': {got} vs {[w for *_, w in flight]}")
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
    (`negative`), duplicate (int32, int64) pairs (`composite`), unique
    keys of a dense span but one key on SKEWED_RUN live rows
    (`skewed`)."""
    heavy = None
    if kind == "skewed":
        v = torch.randperm(cap, generator=g).to(torch.int64) * 2 + 7
        heavy = torch.randperm(n, generator=g)[:SKEWED_RUN]
        v[heavy] = 4242
    elif kind == "dense":
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
    if heavy is not None:
        valid[heavy] = True         # the heavy key on SKEWED_RUN live rows
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
    """(key, build row) pairs of a Prepared's runs, each run read through
    its (start, count) as the probes read it, runs in slot order (the
    twin's slots are its sorted keys). Fails when the kernel's runs do not
    tile the places [0, total) once each."""
    runs, start, count = prep.runs
    if twin:
        keys = prep.lookup[1]
        occ = torch.ones_like(keys, dtype=torch.bool)
    else:
        occ = prep.lookup[2] >= 0
    keys = prep.lookup[1][occ]
    counts = count[occ].to(torch.int64)
    starts = start[occ].to(torch.int64)
    total = int(counts.sum())
    first = torch.cumsum(counts, 0) - counts
    place = torch.repeat_interleave(starts - first, counts) + torch.arange(
        total, device=counts.device)
    if not twin and total and not torch.equal(
            torch.sort(place).values,
            torch.arange(total, device=place.device)):
        fail("K5 runs mode: the runs do not tile the places [0, total)")
    return torch.repeat_interleave(keys, counts), runs[place].to(
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


SKEWED_RUN = 20_000     # rows of the skewed build's one heavy key
EXPAND_CASES = [  # kind, build cap, live, probe cap, live
    ("dense", 5000, 4900, 6000, 5990),
    ("negative", 30_000, 29_000, 70_000, 65_000),
    ("composite", 4096, 4096, 9000, 9000),
    ("dense", 1000, 0, 500, 500),               # empty build
    ("negative", 1000, 1000, 500, 0),           # dead probe
    ("dense", 147_456, 147_000, 4_194_304, 4_194_304),
    # one key on 20,000 rows among unique keys (a dense span, so with and
    # without the dense table); 300 probe rows keep the output near 2M
    ("skewed", 65_536, 60_000, 4096, 300)]


def check_runs(g, dev) -> float:
    """K5 runs mode (and its dense table) against its twin; one enqueue a
    call at the largest build and at the skewed one."""
    from trino_tpu_torch.ops import join as J
    for kind, bcap, bn, *_ in EXPAND_CASES:
        cols = runs_case(g, dev, kind, bcap, bn)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        stats, lookup = J.join_build_cuda(cols, bnr)
        for size in sorted({0, dense_size(stats)}):
            kprep, wprep = built_pair(cols, bnr, size)
            sync()
            runs_ok(f"{kind} build {bn}/{bcap} dense {size}", kprep, wprep)
            if kind == "skewed" and int(kprep.stats[J.MAX_RUN]) < SKEWED_RUN:
                fail("K5 runs mode: the skewed build lost its heavy key")
            if bcap in (EXPAND_CASES[-1][1], EXPAND_CASES[-2][1]):
                one_enqueue(f"join_runs at {kind} build {bn}/{bcap}, dense "
                            f"{size}", lambda: J.join_runs_cuda(
                                cols, bnr, stats, lookup, size), "runs")
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


def twin_prepared(prep, bcols, nr=None):
    """The twins' Prepared for a build the kernels prepared: K5's twin and,
    as the kernel side has them, its runs, dense table and mxu table."""
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import join_mxu as JM
    bnr = prep.build.num_rows if nr is None else nr
    wst, wlk = J.join_build_plain(bcols, bnr)
    w = J.Prepared(prep.build, prep.keys, wst, wlk)
    if prep.runs is not None:
        size = 0 if prep.dense is None else prep.dense.numel()
        w.runs, w.dense = J.join_runs_plain(bcols, bnr, wst, wlk, size)
    elif prep.dense is not None:
        w.dense = J.join_dense_plain(bcols, bnr, wst, prep.dense.numel())
    if prep.mxu is not None:
        w.mxu = JM.mxu_table_plain(bcols, bnr, wst, wlk, w.runs,
                                   prep.mxu.shape[0])
    return w


def mxu_tables_ok(label, kprep, wprep) -> None:
    """K12's table against its twin's: counts equal per slot and, per
    occupied slot, the same build rows at its first position (the build
    row itself, or the key's run, laid out by each side's runs)."""
    kt, wt = kprep.mxu.to(torch.int64), wprep.mxu.to(torch.int64)
    if not torch.equal(kt[:, 0], wt[:, 0]):
        fail(f"K12 counts differ from the twin ({label})")
    occ = kt[:, 0] > 0
    if kprep.runs is None:
        if not torch.equal(kt[occ, 1], wt[occ, 1]):
            fail(f"K12 first rows differ from the twin ({label})")
        return
    counts = kt[occ, 0]

    def run_rows(table, prep):
        start = torch.repeat_interleave(table[occ, 1], counts)
        within = torch.arange(start.numel(), device=start.device) - \
            torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        return prep.runs[0].to(torch.int64)[start + within]
    if not torch.equal(run_rows(kt, kprep), run_rows(wt, wprep)):
        fail(f"K12 run starts name other build rows than the twin's "
             f"({label})")


MXU_CASES = [  # build cap, live rows, key span, duplicates, probe cap, live
    (200, 180, 100, True, 5000, 4990),
    (100, 100, 128, False, 6000, 6000),
    (5000, 4900, 4000, True, 70_000, 65_000),
    (3000, 2990, 4096, False, 4_194_304, 4_194_304),
    (4000, 3990, 4096, False, 262_144, 150_000),  # the main path's probe
    (1000, 0, 100, False, 500, 500),             # empty build
    (3000, 3000, 4096, True, 1000, 0)]           # dead probe


def mxu_case(g, dev, cap, n, span, dup):
    """Build keys over [1000, 1000 + span) with NULLs (unique, or drawn
    with duplicates), and the table size the router would give them."""
    if dup or cap > span:
        v = torch.randint(0, span, (cap,), generator=g)
    else:
        v = torch.randperm(span, generator=g)[:cap]
    valid = torch.rand(cap, generator=g) >= 0.05
    return [((v + 1000).to(torch.int64).to(dev), valid.to(dev))]


def mxu_probe(g, bcols, cap, dev, size):
    """Probe keys: build keys (in span), keys past kmin + size, keys below
    kmin (their u64 difference wraps), NULLs."""
    pc = probe_cols(g, bcols, cap, dev)
    v, valid = pc[0]
    k = torch.randint(0, 4, (cap,), generator=g).to(dev)
    v = torch.where(k == 1, 1000 + size + (v.abs() % 100), v)
    v = torch.where(k == 2, 999 - (v.abs() % 100), v)
    return [(v.contiguous(), valid)]


def check_mxu(g, dev) -> float:
    """K12 (row and runs modes) and K13, the mxu mode of K6 and of K9's
    count and verdict launches, against their twins at table sizes 128 and
    4096: duplicate, NULL and dead build keys, an empty build, probe keys
    in span, past kmin + size and below kmin, an all-dead probe. Each mode
    is also timed at its largest case."""
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import join_mxu as JM
    K = J.JoinType
    timed = max(c[4] for c in MXU_CASES)
    for bcap, bn, span, dup, pcap, pn in MXU_CASES:
        bcols = mxu_case(g, dev, bcap, bn, span, dup)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        stats, lookup = J.join_build_cuda(bcols, bnr)
        wstats, wlookup = J.join_build_plain(bcols, bnr)
        sync()
        if not torch.equal(stats, wstats):
            fail(f"K5 statistics (with NDISTINCT) differ on an mxu build: "
                 f"{stats.tolist()} vs {wstats.tolist()}")
        kmin, kmax = (J.unsigned(int(stats[J.KMIN])),
                      J.unsigned(int(stats[J.KMAX])))
        kspan = kmax - kmin + 1 if kmax >= kmin else 0
        size = 1 << max((max(kspan, 1) - 1).bit_length(), 7)
        label = f"build {bn}/{bcap} span {kspan} dup={dup} size {size} " \
                f"probe {pn}/{pcap}"
        pcols = mxu_probe(g, bcols, pcap, dev, size)
        pnr = torch.tensor(pn, dtype=torch.int32, device=dev)
        # row mode and K6
        kp = J.Prepared(None, (), stats, lookup,
                        mxu=JM.mxu_table_cuda(bcols, bnr, stats, lookup,
                                              None, size))
        wp = J.Prepared(None, (), wstats, wlookup,
                        mxu=JM.mxu_table_plain(bcols, bnr, wstats, wlookup,
                                               None, size))
        sync()
        mxu_tables_ok(label, kp, wp)
        if int(stats[J.MAX_RUN]) <= 1:
            f, b, c = J.unique_probe_cuda(pcols, bcols, pnr, kp)
            wf, wb, wc = J.unique_probe_plain(pcols, bcols, pnr, wp)
            sync()
            if int(c) != int(wc) or not torch.equal(f, wf) \
                    or not torch.equal(b, wb):
                fail(f"K13 in K6 differs from its twin ({label})")
            if size == 4096 and pcap == 262_144:
                one_enqueue(f"K13 in K6 at {label}", lambda:
                            J.unique_probe_cuda(pcols, bcols, pnr, kp),
                            "probe")
        # runs mode and K9
        runs, _ = J.join_runs_cuda(bcols, bnr, stats, lookup, 0)
        wruns, _ = J.join_runs_plain(bcols, bnr, wstats, wlookup, 0)
        kr = J.Prepared(None, (), stats, lookup, runs=runs)
        kr.mxu = JM.mxu_table_cuda(bcols, bnr, stats, lookup, runs, size)
        wr = J.Prepared(None, (), wstats, wlookup, runs=wruns)
        wr.mxu = JM.mxu_table_plain(bcols, bnr, wstats, wlookup, wruns, size)
        sync()
        mxu_tables_ok(label + " runs", kr, wr)
        for jk in (K.INNER, K.LEFT):
            c = J.expand_count_cuda(pcols, bcols, pnr, kr, jk)
            w = J.expand_count_plain(pcols, bcols, pnr, wr, jk)
            sync()
            if int(c.total) != int(w.total) or not torch.equal(
                    c.emit, w.emit) or not torch.equal(c.cand_len,
                                                       w.cand_len):
                fail(f"K13 in K9 launch A ({jk}) differs from its twin "
                     f"({label})")
            t = int(w.total)
            p_, b_ = J.expand_write_cuda(pcols, bcols, c, jk, max(t, 1))
            wp_, wb_ = J.expand_write_plain(pcols, bcols, w, jk, max(t, 1))
            sync()
            if not (torch.equal(p_[:t], wp_[:t])
                    and torch.equal(b_[:t], wb_[:t])):
                fail(f"K9 output rows over the mxu route differ ({jk}, "
                     f"{label})")
        for jk in (K.SEMI, K.ANTI, K.MARK):
            for null_aware in (True, False):
                f, f2 = J.probe_verdict_cuda(pcols, bcols, pnr, kr, jk,
                                             null_aware)
                wf, wf2 = J.probe_verdict_plain(pcols, bcols, pnr, wr, jk,
                                                null_aware)
                sync()
                if not torch.equal(f, wf) or (
                        f2 is not None and not torch.equal(f2, wf2)):
                    fail(f"K13 in K9 verdict ({jk}, null_aware "
                         f"{null_aware}) differs from its twin ({label})")
        if pcap == timed:
            ms = {"K12 (runs mode)": cuda_ms(lambda: JM.mxu_table_cuda(
                      bcols, bnr, stats, lookup, runs, size)),
                  "K13 in K6": cuda_ms(lambda: J.unique_probe_cuda(
                      pcols, bcols, pnr, kp)),
                  "K13 in K9 launch A": cuda_ms(lambda: J.expand_count_cuda(
                      pcols, bcols, pnr, kr, K.INNER)),
                  "K13 in K9 verdict": cuda_ms(lambda: J.probe_verdict_cuda(
                      pcols, bcols, pnr, kr, K.SEMI, True))}
            say(f"[kernels] mxu modes at {label}: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                + " per call (CUDA events)")
    return 0.0   # compared exactly


# --------------------------------------------- the aggregating join


AGG_CASES = [  # label, build cap, live rows, key kind, distinct keys,
               # slots, probe cap, live probe rows
    ("span 100", 5000, 4990, "int", 100, 128, 70_000, 65_000),
    ("span 4096", 40_000, 39_000, "int", 4096, 4096, 100_000, 99_000),
    ("32768 slots (G2 at sf1)", 18_000, 18_000, "int", 18_000, 32768,
     4_194_304, 2_880_404),
    ("65536 slots", 200_000, 199_000, "int", 65536, 65536, 1_000_000,
     999_000),
    ("8 keys under 1.5M build rows", 1_500_000, 1_500_000, "int", 8, 128,
     4_194_304, 4_194_304),
    ("256 keys under 1.5M build rows (G3)", 1_500_000, 1_500_000, "int",
     256, 256, 4_194_304, 4_194_304),
    ("negative keys", 3000, 3000, "negative", 100, 128, 10_000, 10_000),
    ("double keys (-0.0 among them)", 3000, 2990, "double", 200, 256,
     10_000, 9_000),
    ("integer sums past 2^53", 1000, 1000, "big", 64, 128, 5000, 5000),
    ("empty build", 1000, 0, "int", 100, 128, 5000, 5000),
    ("dead probe", 3000, 3000, "int", 100, 128, 1000, 0)]


def agg_case(g, dev, cap, kind, distinct):
    """(key column, base key word, value columns) of one build: keys over
    `distinct` values from a base (negative keys from -50, whose u64 words
    wrap; double keys as consecutive doubles from 1.0, with -0.0 keys
    below the span), an int64 column with NULLs (each value about 2^50
    for "big"),
    a float64 column with NULLs, an int32 column, an all-NULL column."""
    pick = torch.randint(0, distinct, (cap,), generator=g)
    if kind == "negative":
        keys, base = pick - 50, -50
    elif kind == "double":
        base = int(torch.tensor(1.0, dtype=torch.float64).view(torch.int64))
        keys = (pick + base).view(torch.float64).clone()
        keys[torch.rand(cap, generator=g) < 0.05] = -0.0

    else:
        keys, base = pick + 1000, 1000
    kvalid = torch.rand(cap, generator=g) >= 0.05
    a = torch.randint(-10**6, 10**6, (cap,), generator=g)
    if kind == "big":
        a = a + (1 << 50)
    cols = {"a": (a, torch.rand(cap, generator=g) >= 0.1),
            "d": (torch.randn(cap, generator=g, dtype=torch.float64) * 1e3,
                  torch.rand(cap, generator=g) >= 0.1),
            "c": (torch.randint(-1000, 1000, (cap,), generator=g,
                                dtype=torch.int32), None),
            "z": (torch.randint(0, 9, (cap,), generator=g),
                  torch.zeros(cap, dtype=torch.bool))}
    mv = lambda t: None if t is None else t.to(dev)  # noqa: E731
    return ((keys.to(dev), kvalid.to(dev)), base,
            {k: (v.to(dev), mv(m)) for k, (v, m) in cols.items()})


def check_agg_join(g, dev) -> float:
    """K24 (both modes), K25, K26 and K27 against their twins over
    AGG_CASES: K26's five words, K24's integer columns, info words and
    K25's outputs and live mask on the live rows exactly, K24's float64 sums to 1e-9
    relative (the order of its atomics), K27's masks exactly. Each kernel
    is timed at the largest case of its kind. Returns the largest float64
    error."""
    from trino_tpu_torch.ops import join_mxu as JM
    worst = 0.0
    for label, bcap, bn, kind, distinct, slots, pcap, pn in AGG_CASES:
        key, base, cols = agg_case(g, dev, bcap, kind, distinct)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        got = JM.key_bounds_cuda(key[0], key[1], bnr)
        want = JM.key_bounds_plain(key[0], key[1], bnr)
        sync()
        if not torch.equal(got, want):
            fail(f"K26 differs from its twin ({label}): {got.tolist()} vs "
                 f"{want.tolist()}")
        kmin = torch.tensor([base], dtype=torch.int64, device=dev)
        vecs = [(JM.VEC_CNT, None, None), (JM.VEC_SUM_I, *cols["a"]),
                (JM.VEC_SUM_F, *cols["d"]), (JM.VEC_VALIDCNT, *cols["a"]),
                (JM.VEC_SUM_I, *cols["c"]), (JM.VEC_VALIDCNT, *cols["z"]),
                (JM.VEC_SUM_I, *cols["z"])]
        wt, winfo = JM.agg_table_plain(key, vecs, bnr, kmin, slots)
        for mode in (JM.AGG_TABLE_AUTO, JM.AGG_TABLE_GLOBAL):
            kt, kinfo = JM.agg_table_cuda(key, vecs, bnr, kmin, slots,
                                          mode)
            sync()
            if not torch.equal(kinfo[:3], winfo[:3]):
                fail(f"K24 info (mode {mode}) differs from its twin "
                     f"({label}): {kinfo.tolist()} vs {winfo.tolist()}")
            for i, (vk, _, _) in enumerate(vecs):
                x = JM.table_column(kt, vk, i)
                y = JM.table_column(wt, vk, i)
                if vk == JM.VEC_SUM_F:
                    if not close_f64(x, y):
                        fail(f"K24 float sums differ ({label}, mode {mode})")
                    worst = max(worst, max_abs_err(x, y))
                elif not torch.equal(x, y):
                    fail(f"K24 column {i} differs from its twin ({label}, "
                         f"mode {mode})")
        if kind == "big" and int(winfo[JM.INFO_MAG_OK]):
            fail("K24's twin left mag_ok set past 2^53")
        # the probe: build keys, keys past the span and below kmin, NULLs
        pick = torch.randint(0, max(bcap, 1), (pcap,), generator=g).to(dev)
        pk = key[0][pick] if bcap else torch.zeros(pcap, dtype=key[0].dtype,
                                                   device=dev)
        r = torch.randint(0, 4, (pcap,), generator=g).to(dev)
        if key[0].is_floating_point():
            bits = pk.view(torch.int64)
            bits = torch.where(r == 1, bits + slots + 7, bits)
            pk = bits.view(torch.float64)
        else:
            pk = torch.where(r == 1, pk + slots + 7, pk)
            pk = torch.where(r == 2, pk - slots - 9, pk)
        pkey = (pk.contiguous(),
                (torch.rand(pcap, generator=g) >= 0.05).to(dev))
        pnr = torch.tensor(pn, dtype=torch.int32, device=dev)
        pv = (torch.randint(-10**9, 10**9, (pcap,), generator=g).to(dev),
              (torch.rand(pcap, generator=g) >= 0.1).to(dev))
        pf = ((torch.randn(pcap, generator=g, dtype=torch.float64)
               * 1e3).to(dev), None)
        pc = (torch.randint(-100, 100, (pcap,), generator=g,
                            dtype=torch.int32).to(dev), None)
        outs = [(JM.OP_PAIRS, 0, None, None), (JM.OP_CNTP, 0, *pv),
                (JM.OP_SUMP_I, 0, *pv), (JM.OP_SUMP_F, 0, *pf),
                (JM.OP_SUMP_I, 0, *pc), (JM.OP_TABLE_I, 3, None, None),
                (JM.OP_TABLE_F, 2, None, None), (JM.OP_TABLE_I, 1, None, None),
                (JM.OP_TABLE_I, 5, None, None), (JM.OP_TABLE_I, 6, None, None)]
        kg, klive = JM.agg_lookup_cuda(pkey, pnr, wt, kmin, outs)
        wg, wlive = JM.agg_lookup_plain(pkey, pnr, wt, kmin, outs)
        sync()
        # K25 writes the live rows only: the padding is left unwritten
        if not torch.equal(klive[:pn], wlive[:pn]):
            fail(f"K25's live mask differs from its twin ({label})")
        for i, (x, y) in enumerate(zip(kg, wg)):
            if not same_bits(x[:pn], y[:pn]):
                fail(f"K25 output {i} differs from its twin ({label})")
        helpers = [kg[5], kg[8]]
        km = JM.agg_post_cuda(helpers, pnr)
        wm = JM.agg_post_plain(helpers, pnr)
        sync()
        if not all(torch.equal(x[:pn], y[:pn]) for x, y in zip(km, wm)):
            fail(f"K27 differs from its twin on the live rows ({label})")
        if label.startswith(("256 keys", "32768 slots")):
            ms = {"K24 shared copy": cuda_ms(lambda: JM.agg_table_cuda(
                      key, vecs, bnr, kmin, slots, JM.AGG_TABLE_AUTO)),
                  "K24 global atomics": cuda_ms(lambda: JM.agg_table_cuda(
                      key, vecs, bnr, kmin, slots, JM.AGG_TABLE_GLOBAL)),
                  "K26": cuda_ms(lambda: JM.key_bounds_cuda(
                      key[0], key[1], bnr)),
                  "K25": cuda_ms(lambda: JM.agg_lookup_cuda(
                      pkey, pnr, wt, kmin, outs)),
                  "K27 (2 helpers)": cuda_ms(
                      lambda: JM.agg_post_cuda(helpers, pnr))}
            say(f"[kernels] aggregating join at {label} (build {bn}/"
                f"{bcap}, {len(vecs)} vectors, probe {pn}/{pcap}, "
                f"{len(outs)} outputs): "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                + " per call (CUDA events)")
    return worst


BOUNDS_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                torch.bool, torch.float32, torch.float64)
BOUNDS_CASES = [  # capacity, live rows ("cap": every row)
    (5000, 0), (5000, 700), (5000, 4096), (5000, "cap"),
    (2_097_152, 1_500_000)]   # G3's build: orders sf1 on its page


def bounds_key(g, dtype, cap, dev):
    """(values, valid) of one K26 case: keys of `dtype` with NULLs; floats
    with NaN, -0.0, +0.0 and both infinities among them."""
    v = torch.randint(-10**6, 10**6, (cap,), generator=g)
    if dtype is torch.bool:
        values = v > 0
    elif dtype.is_floating_point:
        values = (v * 0.75).to(dtype)
        values[::17] = float("nan")
        values[3::13] = -0.0
        values[5::19] = 0.0
        values[7::23] = float("inf")
        values[9::29] = float("-inf")
    else:
        values = v.to(dtype) if dtype is torch.int64 else \
            (v % 100 - 50).to(dtype)
    return (values.to(dev),
            (torch.rand(cap, generator=g) >= 0.1).to(dev))


def check_key_bounds(g, dev) -> float:
    """K26 against its twin over every key width and kind (1, 2, 4 and 8
    byte integers, bool, float32 and float64 with NaN and -0.0), with
    NULLs, no validity and an all-NULL column, num_rows 0, inside the
    first tile, on a tile boundary and equal to the capacity, and at G3's
    build; the five words bit for bit; one enqueue a call."""
    from trino_tpu_torch.ops import join_mxu as JM
    for dtype in BOUNDS_TYPES:
        for cap, n in BOUNDS_CASES:
            n = cap if n == "cap" else n
            values, valid = bounds_key(g, dtype, cap, dev)
            nr = torch.tensor(n, dtype=torch.int32, device=dev)
            for va in (valid, None, torch.zeros_like(valid)):
                got = JM.key_bounds_cuda(values, va, nr)
                want = JM.key_bounds_plain(values, va, nr)
                sync()
                if not torch.equal(got, want):
                    fail(f"K26 differs from its twin ({dtype}, {n} of "
                         f"{cap} live, validity "
                         f"{'none' if va is None else int(va.sum())}): "
                         f"{got.tolist()} vs {want.tolist()}")
    values, valid = bounds_key(g, torch.int64, 2_097_152, dev)
    nr = torch.tensor(1_500_000, dtype=torch.int32, device=dev)
    one_enqueue("key_bounds at G3's build shape", lambda: JM.key_bounds_cuda(
        values, None, nr), "bounds")
    return 0.0   # compared exactly


def gen_windows(table, sf):
    """(start, end, cap) of the first and the last scan page of a table at
    the scan capacity (4,194,304 rows, or the table where it is smaller)."""
    from trino_tpu_torch.connector import tpch_gen as G
    rows = G.row_count(table, sf)
    cap = min(1 << max(rows - 1, 1).bit_length(), 1 << 22)
    last = (rows - 1) // cap * cap
    return sorted({(0, min(cap, rows), cap), (last, rows, cap)})


def host_chunk(table, sf, name, typ, start, end):
    """The NumPy path's chunk of one column, in its staged dtype."""
    import numpy as np
    from trino_tpu_torch.connector import tpch_gen as G
    from trino_tpu_torch import types as T
    if G.string_kind(table, name) == "pooled":
        return G.codes_chunk(table, sf, name, start, end)
    return np.asarray(G.numeric_chunk(table, sf, name, start, end),
                      T.to_numpy_dtype(typ))


def check_gen_window(table, sf, start, end, cap, dev) -> int:
    """K15 and K14 (every supported column) over one window against their
    twins (on the card) and the NumPy host chunk, bit for bit; returns the
    columns checked."""
    from trino_tpu_torch.connector import tpch, tpch_dev as TD
    from trino_tpu_torch.connector import tpch_gen as G
    from trino_tpu_torch import types as T
    n = end - start
    oidx = woidx = None
    if table == "lineitem":
        seed, o_first, s0, norders = G.order_index_params(sf, start)
        no = min(n, norders - o_first)
        oidx = TD.order_index_cuda(seed, o_first, s0, start, n, no, cap, dev)
        woidx = TD.order_index_plain(seed, o_first, s0, start, n, no, cap,
                                     dev)
        host = torch.from_numpy(G._lineitem_rowmap(sf, start, end)[0])
        sync()
        if not torch.equal(oidx, woidx) or not torch.equal(
                oidx[:n].cpu(), host):
            fail(f"K15 order index differs (lineitem sf{sf} [{start}, "
                 f"{end}))")
    checked = 0
    for name, typ in tpch.TABLES[table][0]:
        if not TD.supported(table, name):
            continue
        recipe = G.device_recipe(table, name, sf)
        lut = None if recipe.lut is None else torch.from_numpy(
            recipe.lut).to(dev)
        dtype = torch.int32 if T.is_string(typ) else typ.dtype
        got = TD.gen_column_cuda(recipe, start, n, cap, oidx, lut, dtype,
                                 dev)
        want = TD.gen_column_plain(recipe, start, n, cap, woidx, lut, dtype,
                                   dev)
        host = torch.from_numpy(host_chunk(table, sf, name, typ, start, end))
        sync()
        if not same_bits(got, want) or not torch.equal(got[:n].cpu(), host) \
                or bool(got[n:].any()):
            fail(f"K14 differs from its twin or the NumPy chunk: {table}."
                 f"{name} sf{sf} [{start}, {end}) cap {cap}")
        checked += 1
    return checked


def check_gen(dev) -> float:
    """K14/K15 for every supported column of the six tables at sf1 (first
    and last scan page) and one sf10 lineitem chunk that starts in the
    middle of an order."""
    from trino_tpu_torch.connector import tpch_gen as G
    checked = 0
    for table in ("supplier", "customer", "part", "partsupp", "orders",
                  "lineitem"):
        for start, end, cap in gen_windows(table, 1.0):
            checked += check_gen_window(table, 1.0, start, end, cap, dev)
    _, starts = G._line_index(10.0)
    start = 7 * (1 << 22) + 3
    while int(starts[int((starts <= start).sum()) - 1]) == start:
        start += 1     # inside an order, not at its first line
    checked += check_gen_window("lineitem", 10.0, start,
                                start + (1 << 22), 1 << 22, dev)
    say(f"[kernels] K14/K15: {checked} column windows bit for bit equal "
        f"to their twins and the NumPy chunks (sf1 first and last pages, "
        f"sf10 lineitem [{start}, {start + (1 << 22)}), mid-order)")
    return 0.0


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


def same_page(page):
    """The page with every row equal to its row 0: every digit pass of
    every key set is trivial (only the dead byte could differ, and rows
    past num_rows take no part)."""
    import dataclasses
    from trino_tpu_torch.page import Page

    def first(t):
        return None if t is None else t[:1].repeat(t.shape[0])
    return Page([dataclasses.replace(c, values=first(c.values),
                                     valid=first(c.valid))
                 for c in page.columns], page.num_rows)


def sort_u64_words(kind: str, n: int, seed: int, dev):
    """Seeded int64 words holding u64 values: "random" over the whole
    range, "duplicates" from 37 values (0, -1, INT64_MIN among them)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=g,
                             dtype=torch.int64).to(dev)
    pool = torch.cat([torch.tensor([0, -1, -(1 << 63), (1 << 63) - 1, 255,
                                    256, 1 << 32]),
                      torch.randint(-(1 << 40), 1 << 40, (30,), generator=g)])
    return pool[torch.randint(0, pool.numel(), (n,), generator=g)].to(dev)


def sort_sizes():
    """(cap, n, equal rows) of check_sort: the earlier sizes, both sides
    of the one-block threshold by capacity and by live rows, a capacity
    that is not a multiple of the tile, no live row on a large capacity,
    pages of equal rows on both paths, 16,777,216 rows."""
    from trino_tpu_torch.ops import sort as S
    small, tile = S.SMALL_ROWS, S.SORT_TILE
    return [(1, 1, False), (100, 0, False), (300, 257, False),
            (4096, 4093, False), (65_536, 65_536, False),
            (65_537, 65_537, False), (131_072, 100_003, False),
            (4_194_304, 4_194_304, False), (small, small, False),
            (small + 1, small + 1, False), (65_536, small, False),
            (65_536, small + 1, False), (3 * tile + 5, 3 * tile + 3, False),
            (1 << 20, 0, False), (5000, 5000, True), (5000, 4000, True),
            (200_000, 200_000, True), (200_000, 150_001, True),
            (16_777_216, 16_777_216, False)]


U64_SIZES = [1, 8192, 8193, 1_000_003, 8_388_608]
# phase 4 times K10 at these sf1 queries' largest sorts (captured on the
# main path: q16's ORDER BY, W2's window sort) and at the distributed
# path's largest u64 sort (a D4 sf10 shard of K36's words)
K10_TIMED = {"q16": "sort_rows (K10, order_by/top_n_masked)",
             "W2": "sort_rows (K10, the window sort)"}


def check_sort(dev) -> float:
    """K10 against its twin: the packed words bit for bit and the
    permutation of the live prefix exactly at every sort_sizes() page and
    key set; K10's u64 sort against torch.sort of the flipped words at
    U64_SIZES, random and duplicate-heavy."""
    import ctypes
    from trino_tpu_torch import native
    from trino_tpu_torch.ops import sort as S
    lib = native.library("sort")
    for fn, want in (("sort_small_rows", S.SMALL_ROWS),
                     ("sort_tile_rows", S.SORT_TILE)):
        getattr(lib, fn).restype = ctypes.c_int64
        if getattr(lib, fn)() != want:
            fail(f"csrc/sort.cu {fn}() is not ops/sort.py's {want}")
    for seed, (cap, n, same) in enumerate(sort_sizes()):
        page = sort_page(cap, n, 500 + seed, dev)
        if same:
            page = same_page(page)
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
                     f"keys={ks} same={same}")
            if not torch.equal(got[n:].to(torch.int64),
                               torch.arange(n, cap, device=dev)):
                fail(f"K10 moved a dead row at cap={cap} n={n}")
        del page
    lo = -(1 << 63)
    for seed, (kind, n) in enumerate((k, n) for n in U64_SIZES
                                     for k in ("random", "duplicates")):
        words = sort_u64_words(kind, n, 900 + seed, dev)
        got = S.sort_u64_cuda(words)
        sync()
        want = torch.sort(words ^ lo, stable=True).values ^ lo
        if not torch.equal(got, want):
            fail(f"K10's u64 sort differs from torch.sort ({kind}, n={n})")
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


# ------------------------------------------- K16-K19 (the spill slice)


def spill_key_cols(g, kind, cap, n, dup, dev):
    """Build key columns (values, valid) of one K16/K17 case: NULL keys,
    a live key of -1, dead rows past n; `dup` repeats a key."""
    if kind == "dense":          # a shuffled surrogate span
        v = torch.randperm(cap, generator=g).to(torch.int64) + 1000
    elif kind == "minus1":       # a live key of -1 (u64::MAX, the mask)
        v = torch.randperm(cap, generator=g).to(torch.int64) - 1
    elif kind == "wide":         # a key span past 2^28: the search mode
        v = torch.randint(-2**40, 2**40, (cap,), generator=g,
                          dtype=torch.int64) * 3
        v[0] = -1
    elif kind == "float":        # NaN, -0.0 and +0.0 among the keys
        v = torch.randperm(cap, generator=g).to(torch.float64) * 0.5
        if cap > 16:
            v[3] = float("nan")
            v[5] = -0.0
            v[7] = 1e300
    elif kind == "codes":        # dictionary codes (int32)
        v = torch.randperm(cap, generator=g).to(torch.int32)
    elif kind == "bool":
        v = torch.arange(cap) % 2 == 0
    elif kind == "orders":       # sf1's spilled build: (o_orderkey, mod 1000)
        i = torch.arange(cap, dtype=torch.int64)
        v = (i // 8) * 32 + i % 8 + 1
        return [(v.to(dev), None), ((v % 1000).to(dev), None)]
    else:                        # composite (int32, int64)
        v = torch.randperm(cap, generator=g).to(torch.int32) % max(cap, 1)
    if dup and cap > 8:
        v[cap // 2] = v[1]
    valid = torch.rand(cap, generator=g) >= 0.05
    if kind == "bool":
        valid = torch.ones(cap, dtype=torch.bool)
    cols = [(v.contiguous().to(dev), valid.to(dev))]
    if kind == "composite":
        w = torch.arange(cap, dtype=torch.int64) * 11 - 7
        if dup and cap > 8:
            w[cap // 2] = w[1]
        cols.append((w.to(dev), None))
    return cols


SPILL_JOIN_CASES = [  # kind, cap, live rows, duplicate, probe cap, live
    ("dense", 8192, 8000, False, 20_000, 19_000),
    ("dense", 8192, 8192, True, 4096, 4096),
    ("minus1", 4096, 4096, False, 8192, 8192),
    ("wide", 50_000, 49_000, False, 70_000, 69_000),
    ("float", 4096, 4000, False, 8192, 8000),
    ("codes", 2048, 2048, False, 4096, 4000),
    ("bool", 8, 2, False, 64, 60),
    ("composite", 3000, 2900, False, 6000, 6000),
    ("composite", 3000, 3000, True, 100, 100),
    ("dense", 1024, 0, False, 512, 512),                 # empty build
    ("wide", 1024, 1024, False, 512, 0),                 # dead probe
    ("dense", 131_072, 131_000, False, 4_194_304, 4_194_304),
    ("wide", 65_536, 0, False, 4096, 4096),              # multi-block, empty
    ("wide", 65_536, 65_536, True, 4096, 4096),          # live to cap
    ("orders", 2_097_152, 1_500_000, False, 1_000_000, 1_000_000),  # sf1
]
# K17's dense mode with the live probe rows inside its first tile, and none
SPILL_PROBE_CASES = [("dense", 8192, 8000, False, 20_000, 300),
                     ("dense", 8192, 8000, False, 20_000, 0)]


def check_spill_join(g, dev) -> float:
    """K16 (sorted keys, permutation, statistics), K5's dense mode with
    the permutation as payload, and K17 in both modes, against their
    twins: everything bit for bit (K17's found and brow on the live
    rows: it leaves the padding unwritten); one enqueue a call of K17 in
    each mode at its largest case."""
    from trino_tpu_torch.ops import join as J
    largest = {}
    for kind, bcap, bn, dup, pcap, pn in SPILL_JOIN_CASES + \
            SPILL_PROBE_CASES:
        label = f"{kind} build {bn}/{bcap} probe {pn}/{pcap} dup={dup}"
        bcols = spill_key_cols(g, kind, bcap, bn, dup, dev)
        bnr = torch.tensor(bn, dtype=torch.int32, device=dev)
        before = J.spill_prep_cuda.launches
        keys, perm, stats = J.spill_prep_cuda(bcols, bnr)
        sync()
        if J.spill_prep_cuda.launches != before + 1:
            fail(f"K16 counted {J.spill_prep_cuda.launches - before} "
                 f"launches for one call ({label})")
        if kind == "orders":
            from trino_tpu_torch.launch_trace import device_split
            _, n_k, top = device_split(lambda: J.spill_prep_cuda(bcols,
                                                                 bnr))
            say(f"[kernel] spill_prep (K16) at {label}: {n_k:g} kernels "
                f"and copies per call: "
                + ", ".join(f"{k} x{c:g}" for k, _, c in top))
        wkeys, wperm, wstats = J.spill_prep_plain(bcols, bnr)
        if not torch.equal(stats, wstats):
            fail(f"K16 statistics differ ({label}):\n{stats.tolist()}\n"
                 f"{wstats.tolist()}")
        if not torch.equal(keys, wkeys) or not torch.equal(perm, wperm):
            fail(f"K16 sorted keys or permutation differ ({label})")
        if dup and bn > bcap // 2 and int(stats[J.SPILL_UNIQUE]):
            fail(f"K16 missed the duplicate key ({label})")
        pcols = probe_cols(g, bcols, pcap, dev)
        pnr = torch.tensor(pn, dtype=torch.int32, device=dev)
        kmin, kmax = (J.unsigned(int(stats[J.KMIN])),
                      J.unsigned(int(stats[J.KMAX])))
        modes = [(J.SPILL_SEARCH, (keys, perm), (wkeys, wperm))]
        if len(bcols) == 1 and kmax >= kmin \
                and kmax - kmin < J.SPILL_DENSE_MAX_SPAN:
            size = 1 << max(10, (kmax - kmin).bit_length())
            table = J.build_dense_table_rows(size)(keys, perm, stats)
            sync()
            wtable = J.join_dense_plain(
                [(wkeys, None)], wstats[J.N_LIVE].to(torch.int32), wstats,
                size, wperm)
            if not torch.equal(table, wtable):
                fail(f"K5 dense mode over K16's keys differs ({label})")
            modes.append((J.SPILL_DENSE, table, wtable))
        for mode, lookup, wlookup in modes:
            f, b, c = J.spill_probe_cuda(pcols, pnr, mode, lookup, stats)
            sync()
            wf, wb, wc = J.spill_probe_plain(pcols, pnr, mode, wlookup,
                                             wstats)
            if int(c) != int(wc) or not torch.equal(f[:pn], wf[:pn]) \
                    or not torch.equal(b[:pn], wb[:pn]):
                fail(f"K17 mode {mode} differs ({label}): count {int(c)} "
                     f"vs {int(wc)}")
            if pn >= largest.get(mode, (0,))[0]:
                largest[mode] = (pn, label, pcols, pnr, lookup, stats)
    for mode, (_, label, pcols, pnr, lookup, stats) in sorted(
            largest.items()):
        one_enqueue(f"spill_probe mode {mode} at {label}", lambda: (
            J.spill_probe_cuda(pcols, pnr, mode, lookup, stats)),
            "spillprobe")
    return 0.0   # compared exactly


def spill_page_cols(g, cap, dev):
    """The columns a K18 page carries: an int64 key with NULLs, a float64
    with NaN/-0.0/+0.0 and ties, a bool, int32 dictionary codes with few
    values (ties), and an int16 payload."""
    k = torch.randint(0, cap // 3 + 2, (cap,), generator=g,
                      dtype=torch.int64) - 1
    kv = torch.rand(cap, generator=g) >= 0.1
    f = (torch.randint(-50, 50, (cap,), generator=g) * 0.25).to(
        torch.float64)
    if cap > 32:
        f[::9] = float("nan")
        f[1::13] = -0.0
        f[2::17] = 0.0
        f[3::19] = float("-inf")
    fv = torch.rand(cap, generator=g) >= 0.1
    b = torch.rand(cap, generator=g) < 0.5
    codes = torch.randint(0, 7, (cap,), generator=g, dtype=torch.int32)
    pay = torch.randint(-2**15, 2**15 - 1, (cap,), generator=g,
                        dtype=torch.int16)
    return [(k.to(dev), kv.to(dev)), (f.to(dev), fv.to(dev)),
            (b.to(dev), None), (codes.to(dev), None), (pay.to(dev), None)]


def check_spill_part(g, dev) -> float:
    """K18's hash mode (salts 0-3, npart 1, 4 and 16), rank mode (each
    key type, both directions, NULLs first and last) and range mode
    (rank_bounds' quantiles with ties, K10 under them) against the
    twins: pids, counts and every moved column bit for bit."""
    from trino_tpu_torch.exec import spill as SP
    from trino_tpu_torch.ops.sort import sort_u64_cuda
    for cap, n in ((8192, 8000), (4096, 0), (2048, 2048),
                   (4_194_304, 4_194_000)):
        cols = spill_page_cols(g, cap, dev)
        arrays = [a for v, m in cols for a in ((v,) if m is None
                                               else (v, m))]
        nr = torch.tensor(n, dtype=torch.int32, device=dev)
        key_sets = ([cols[0]], [cols[1]], [cols[2], cols[3]],
                    [cols[0], cols[1], cols[3]])
        for keys in key_sets:
            for npart in (1, 4, 16):
                for salt in (0, 1, 2, 3):
                    if cap > 8192 and (salt > 1 or npart != 16):
                        continue
                    spec = (SP.MODE_HASH, salt)
                    got, cnt = SP.partition_rows_cuda(arrays, keys, nr,
                                                      spec, npart)
                    sync()
                    want, wcnt = SP.partition_rows_plain(arrays, keys, nr,
                                                         spec, npart)
                    if not torch.equal(cnt, wcnt) or not all(
                            same_bits(a, b) for a, b in zip(got, want)):
                        fail(f"K18 hash mode differs (cap {cap}, rows {n},"
                             f" {len(keys)} keys, npart {npart}, salt "
                             f"{salt}): {cnt.tolist()} vs {wcnt.tolist()}")
        live = torch.arange(cap, device=dev) < n
        for values, valid in cols[:4]:
            for asc in (True, False):
                for nf in (True, False):
                    r = SP.rank_rows_cuda(values, valid, asc, nf)
                    sync()
                    wr = SP.rank_rows_plain(values, valid, asc, nf)
                    if not torch.equal(r, wr):
                        fail(f"K18 rank mode differs ({values.dtype}, asc "
                             f"{asc}, nulls first {nf}, cap {cap})")
                    masked = torch.where(live, r, torch.full_like(r, -1))
                    s = sort_u64_cuda(masked)
                    ws = masked[torch.sort(masked ^ (-(1 << 63)),
                                           stable=True).indices]
                    if not torch.equal(s, ws):
                        fail(f"K10 over K18's ranks differs (cap {cap})")
                    for npart in (4, 16):
                        bounds = SP.rank_bounds(npart)(r, live, nr)
                        spec = (SP.MODE_RANGE, asc, nf, bounds)
                        got, cnt = SP.partition_rows_cuda(
                            arrays, [(values, valid)], nr, spec, npart)
                        sync()
                        want, wcnt = SP.partition_rows_plain(
                            arrays, [(values, valid)], nr, spec, npart)
                        if not torch.equal(cnt, wcnt) or not all(
                                same_bits(a, b) for a, b in zip(got, want)):
                            fail(f"K18 range mode differs ({values.dtype}, "
                                 f"asc {asc}, nulls first {nf}, npart "
                                 f"{npart}, cap {cap})")
    return 0.0   # compared exactly


def check_bypass(g, dev) -> float:
    """K19 against its twin over every state kind: count, integer and
    float sums, min/max of int64, int32, float64 (NaN), float32 and bool,
    a precomputed contribution, with validity, FILTER masks and dead
    rows; more than 8 states (two launches)."""
    from trino_tpu_torch.ops import aggregate as A
    err = 0.0
    for cap, n in ((4096, 4000), (1024, 0), (4_194_304, 4_194_304)):
        def col(dtype):
            if dtype == torch.bool:
                return torch.rand(cap, generator=g).to(dev) < 0.5
            if dtype.is_floating_point:
                x = (torch.randn(cap, generator=g) * 100).to(dtype)
                if cap > 16:
                    x[::7] = float("nan")
                    x[1::11] = -0.0
                return x.to(dev)
            return torch.randint(-2**30, 2**30, (cap,), generator=g).to(
                dtype).to(dev)

        def mask():
            return (torch.rand(cap, generator=g) < 0.8).to(dev)
        i64, f64 = col(torch.int64), col(torch.float64)
        states = [
            (A.StateInput(None, mask(), None, A.COUNT, False), torch.int64),
            (A.StateInput(i64, mask(), mask(), A.SUM, False), torch.int64),
            (A.StateInput(f64, mask(), None, A.SUM, True), torch.float64),
            (A.StateInput(i64, None, mask(), A.MIN, False), torch.int64),
            (A.StateInput(col(torch.int32).to(torch.int64), mask(), None,
                          A.MAX, False), torch.int32),
            (A.StateInput(f64, mask(), mask(), A.MIN, True), torch.float64),
            (A.StateInput(col(torch.float32).to(torch.float64), mask(),
                          None, A.MAX, True), torch.float32),
            (A.StateInput(col(torch.bool).to(torch.int64), mask(), None,
                          A.MIN, False), torch.bool),
            (A.StateInput(i64, None, None, A.MIN, False), torch.int64),
            (A.StateInput(None, None, mask(), A.COUNT, False), torch.int64),
        ]
        copies = [False] * (len(states) - 2) + [True, False]
        nr = torch.tensor(n, dtype=torch.int32, device=dev)
        sts = [s for s, _ in states]
        dts = [d for _, d in states]
        got = A.passthrough_triton(sts, copies, nr, cap, dts)
        sync()
        want = A.passthrough_plain(sts, copies, nr, cap, dts)
        for j, (a, b) in enumerate(zip(got, want)):
            if not same_bits(a, b):
                fail(f"K19 state {j} ({dts[j]}) differs from its twin "
                     f"(cap {cap}, rows {n})")
            err = max(err, max_abs_err(a, b))
    return err


# ------------------------------------------- K20-K23 (the window slice)

# (function, argument columns, output type) of the phase 2 window checks;
# a type is a name of trino_tpu_torch.types or ("DecimalType", p, s)
WIN_AGG = [("sum", ("xi",), "BIGINT"), ("sum", ("xd",), "DOUBLE"),
           ("avg", ("xdec",), ("DecimalType", 12, 2)),
           ("avg", ("xi",), "DOUBLE"), ("avg", ("xd",), "DOUBLE"),
           ("count", ("xd",), "BIGINT"), ("count", (), "BIGINT"),
           ("min", ("xi",), "BIGINT"), ("max", ("xd",), "DOUBLE"),
           ("min", ("xc",), "VARCHAR"), ("max", ("x32",), "INTEGER"),
           ("min", ("xdec",), ("DecimalType", 12, 2))]
WIN_VALUE = [("first_value", ("xd",), "DOUBLE"),
             ("last_value", ("xc",), "VARCHAR"),
             ("nth_value", ("xi", "nth"), "BIGINT")]
WIN_RANK = [("row_number", (), "BIGINT"), ("rank", (), "BIGINT"),
            ("dense_rank", (), "BIGINT"), ("percent_rank", (), "DOUBLE"),
            ("cume_dist", (), "DOUBLE"), ("ntile", ("k",), "BIGINT"),
            ("lead", ("xi",), "BIGINT"), ("lag", ("xd", "off"), "DOUBLE"),
            ("lead", ("xc", "off", "xc2"), "VARCHAR"),
            ("lag", ("x32", "off", "xi"), "BIGINT")]
# frame -> (whole, rows, bounds): whole, running ROWS, running RANGE and
# bounded ROWS frames, 0 PRECEDING AND 0 FOLLOWING and frames wider than
# any partition (K23's doubling table past 64 rows) included
WIN_FRAMES = {
    "whole": (True, False, None), "rows": (False, True, None),
    "range": (False, False, None),
    **{f"b{s}_{e}": (False, True, (s, e)) for s, e in (
        (None, 0), (0, None), (-3, 3), (-2, 2), (0, 0), (1, 3),
        (-500, 500), (-5000, None), (None, 5000))}}
WIN_BIG_FRAMES = ("whole", "rows", "range", "bNone_0", "b0_None", "b-3_3",
                  "b-2_2", "b-500_500")
WIN_COLS = ("pk", "pd", "pb", "pc", "ok", "od", "row", "xi", "xd", "xdec",
            "x32", "xc", "xc2", "off", "nth", "k", "absd")
# page -> (capacity, live rows, partitions of pk, partition columns, order
# keys as (column, ascending, nulls_first), frames)
WIN_PAGES = {
    "4M rows": (4_194_304, 4_194_304 - 777, 150_000, ("pk",),
                (("ok", True, None), ("row", True, None)), WIN_BIG_FRAMES),
    "NULL, NaN and -0.0 keys": (8192, 8000, 50, ("pd", "pb"),
                                (("od", False, None), ("row", True, None)),
                                tuple(WIN_FRAMES)),
    "empty page": (4096, 0, 10, ("pk",), (("row", True, None),),
                   ("whole", "rows", "range", "b-2_2")),
    "one-row partitions": (4096, 4000, 0, ("row",), (("ok", True, None),),
                           tuple(WIN_FRAMES)),
    "no partition keys": (4096, 3000, 10, (),
                          (("ok", True, False), ("row", True, None)),
                          tuple(WIN_FRAMES)),
    "no order keys": (4096, 4096, 40, ("pk",), (), ("whole",)),
    "dictionary keys": (4096, 4000, 10, ("pc",),
                        (("xc", False, True), ("row", False, None)),
                        tuple(WIN_FRAMES)),
}


def win_type(spec):
    from trino_tpu_torch import types as T
    return getattr(T, spec[0])(*spec[1:]) if isinstance(spec, tuple) \
        else getattr(T, spec)


def window_page(g, cap: int, n: int, nparts: int, dev):
    """A seeded page of WIN_COLS: partition keys with NULLs (pk BIGINT; pd
    DOUBLE with NaN, -0.0 and +0.0; pb BOOLEAN; pc dictionary codes),
    order keys with ties (ok INTEGER with NULLs, od DOUBLE), a unique row
    id, arguments of every kind with NULLs (xd with NaN, +-inf and -0.0),
    lead/lag offsets 0..3, nth_value's n in -1..4, ntile's 3 and |xd|
    where finite (the float tolerance's scale)."""
    import numpy as np
    from trino_tpu_torch import page as P
    from trino_tpu_torch import types as T

    def ints(lo, hi):
        return torch.randint(lo, hi, (cap,), generator=g)

    def mask(p):
        return torch.rand(cap, generator=g) < p

    def pick(values):
        v = torch.tensor(values, dtype=torch.float64)
        return v[torch.randint(0, len(values), (cap,), generator=g)]
    xd = torch.where(mask(0.5), torch.randn(cap, generator=g,
                                            dtype=torch.float64) * 1e3,
                     pick([-1.5, -0.0, 0.0, 2.25, 1e6, float("nan"),
                           float("inf"), float("-inf")]))
    pool_a = P.Dictionary(np.asarray(["AIR", "MAIL", "RAIL", "SHIP"],
                                     dtype=object))
    pool_b = P.Dictionary(np.asarray(["FOB", "MAIL", "TRUCK"], dtype=object))
    cols = {
        "pk": (ints(0, max(nparts, 1)), mask(0.95), T.BIGINT, None),
        "pd": (pick([float("nan"), -0.0, 0.0, 1.5, 2.5]), mask(0.9),
               T.DOUBLE, None),
        "pb": (mask(0.5), mask(0.8), T.BOOLEAN, None),
        "pc": (ints(0, 4).to(torch.int32), mask(0.9), T.VARCHAR, pool_a),
        "ok": (ints(-3, 4).to(torch.int32), mask(0.85), T.INTEGER, None),
        "od": (pick([-0.0, 0.0, 1.0, float("nan")]), None, T.DOUBLE, None),
        "row": (torch.randperm(cap, generator=g), None, T.BIGINT, None),
        "xi": (ints(-10 ** 6, 10 ** 6), mask(0.8), T.BIGINT, None),
        "xd": (xd, mask(0.85), T.DOUBLE, None),
        "xdec": (ints(-99999, 99999), mask(0.8), T.DecimalType(12, 2),
                 None),
        "x32": (ints(-50, 50).to(torch.int32), None, T.INTEGER, None),
        "xc": (ints(0, 4).to(torch.int32), mask(0.85), T.VARCHAR, pool_a),
        "xc2": (ints(0, 3).to(torch.int32), mask(0.85), T.VARCHAR, pool_b),
        "off": (ints(0, 4), None, T.BIGINT, None),
        "nth": (ints(-1, 5), None, T.BIGINT, None),
        "k": (torch.full((cap,), 3, dtype=torch.int64), None, T.BIGINT,
              None),
        "absd": (torch.where(torch.isfinite(xd), xd.abs(),
                             torch.zeros_like(xd)), None, T.DOUBLE, None),
    }
    page = P.Page(tuple(P.Column(v.to(dev), None if m is None else m.to(dev),
                                 t, d) for v, m, t, d in
                        (cols[c] for c in WIN_COLS)), n)
    return page, {c: i for i, c in enumerate(WIN_COLS)}


def window_specs(ch, frame):
    from trino_tpu_torch.ops import window as W
    whole, rows, bounds = WIN_FRAMES[frame]
    cases = WIN_AGG + WIN_VALUE + (WIN_RANK if frame == "range" else [])
    return [W.WindowSpec(name, tuple(ch[a] for a in args), win_type(out),
                         whole, rows, bounds) for name, args, out in cases]


def window_err(label, got, want, n: int, scale=None) -> float:
    """A window output column against its twin's on the live rows:
    validity exactly, values where valid: integers and codes exactly,
    doubles to 1e-9 relative to the larger of the value and `scale` (the
    partition's sum of |x|, which bounds every prefix the two scans add
    in their own orders; NaN equals NaN, -0.0 equals +0.0)."""
    gv = got.valid_mask()[:n]
    wv = want.valid_mask()[:n]
    if not torch.equal(gv, wv):
        fail(f"{label}: validity differs from the twin "
             f"({int((gv != wv).sum())} rows)")
    if got.values.dtype != want.values.dtype or (
            got.dictionary != want.dictionary):
        fail(f"{label}: type or dictionary differs from the twin")
    a, b = got.values[:n][wv], want.values[:n][wv]
    if not a.is_floating_point():
        if not torch.equal(a, b):
            fail(f"{label}: values differ from the twin")
        return 0.0
    a, b = a.to(torch.float64), b.to(torch.float64)
    s = b.abs() if scale is None else torch.maximum(b.abs(),
                                                    scale[:n][wv])
    ok = (a == b) | (torch.isnan(a) & torch.isnan(b)) | (
        (a - b).abs() <= 1e-9 * s)
    if not bool(ok.all()):
        bad = (~ok).nonzero()[:3].flatten()
        fail(f"{label}: values differ from the twin beyond 1e-9 of the "
             f"partition's |x| sum: {a[bad].tolist()} vs {b[bad].tolist()}")
    return max_abs_err(a, b)


def check_window(g, dev) -> float:
    """K20-K23 against their twins on the card: K20's six arrays bit for
    bit on every row; each K21, K22 and K23 output (fed K20's arrays)
    on the live rows, over WIN_PAGES x their frames x every function."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import sort as S
    from trino_tpu_torch.ops import window as W
    err = 0.0
    for label, (cap, n, nparts, part, okeys, frames) in WIN_PAGES.items():
        page, ch = window_page(g, cap, n, nparts, dev)
        keys = tuple(S.SortKey(ch[c]) for c in part) + tuple(
            S.SortKey(ch[c], a, nf) for c, a, nf in okeys)
        if keys:
            page = page.gather(S.sort_rows(page, keys), page.num_rows)
        pch = tuple(ch[c] for c in part)
        och = tuple(ch[c] for c, _, _ in okeys)
        b = W.window_bounds_cuda(page, pch, och)
        want = W.window_bounds_plain(page, pch, och)
        for f in ("seg_start", "seg_len", "peer_start", "peer_len",
                  "seg_id", "peer_id"):
            if not torch.equal(getattr(b, f), getattr(want, f)):
                fail(f"K20 {f} differs from its twin on the {label} page")
        scale = W.frame_aggregate_plain(W.WindowSpec(
            "sum", (ch["absd"],), win_type("DOUBLE"), True, False), page,
            b).values
        for frame in frames:
            for spec in window_specs(ch, frame):
                what = f"{spec.name}({spec.arg_channels}) {frame} on the " \
                       f"{label} page"
                if spec.name in W.RANKING or spec.name in W.VALUE:
                    err = max(err, window_err(
                        f"K21 {what}", W.rank_value_triton(spec, page, b),
                        W.rank_value_plain(spec, page, b), n))
                    continue
                if W.two_sided_minmax(spec):
                    err = max(err, window_err(
                        f"K23 {what}",
                        P.Column(*W.bounded_minmax_cuda(spec, page, b),
                                 spec.out_type),
                        P.Column(*W._bounded_minmax(spec, page, b),
                                 spec.out_type), n))
                    continue
                err = max(err, window_err(
                    f"K22 {what}", W.frame_aggregate_cuda(spec, page, b),
                    W.frame_aggregate_plain(spec, page, b), n, scale))
    sync()
    return err


def k10_row(name, n_launches, page, keys, sort_fn, what, card) -> dict:
    """K10 (sort_rows) at one captured page: against its twin, timed
    beside its bound and torch.sort(stable=True) of one packed word; the
    shape says how many digit passes ran and how many were trivial, and
    the profiler's top kernels are printed."""
    from trino_tpu_torch.ops import sort as S
    n = int(page.num_rows)
    got = sort_fn(page, keys)
    want = S.sort_rows_plain(page, keys)
    if not torch.equal(got[:n].to(torch.int64), want[:n]):
        fail(f"K10 differs from its twin at {what}")
    words = S.encode_sort_keys(page, keys)
    passes = S.sort_passes(S.sort_layout(page, keys))
    ran = sum(S.informative_passes_plain(words, page.num_rows, passes))
    word = words[-1][:n].contiguous()
    key_b = sum(page.column(k.channel).values.element_size()
                + (page.column(k.channel).valid is not None) for k in keys)
    fn = lambda: sort_fn(page, keys)   # noqa: E731
    dev_ms, top = device_profile(fn)
    say(f"[kernel] {name} at {what}: top device time per call: "
        + ", ".join(f"{k[:48]} {t:.4f} ms" for k, t in top) + f" — {card}")
    return dict(
        name=name, route="cuda", source="trino_tpu_torch/csrc/sort.cu",
        replaces="trino_tpu/ops/sort.py:71", launches=n_launches,
        max_abs_err=0.0, ms=cuda_ms(fn), device_ms=dev_ms,
        host_ms=host_ms(fn),
        plain_ms=cuda_ms(lambda: S.sort_rows_plain(page, keys)),
        # the key columns of the live rows read once, the int32
        # permutation written once
        bound_ms=n * (key_b + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sort(word, stable=True)),
        shape=f"{what}: cap {page.capacity}, {n} live rows, {len(keys)} "
              f"keys, {len(words)} words, {len(passes)} digit passes of "
              f"which {ran} ran and {len(passes) - ran} were trivial, "
              f"{'one block' if n <= S.SMALL_ROWS else 'one launch per pass'}"
              f"; library = torch.sort(stable=True) of one packed word")


def kernel_rows_sort_expr(cap: Capture, originals, launches, dev, card):
    """K10 and K11 at the main path's largest calls, against their twins."""
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.ops import sort as S
    out = []

    # K10 at q16's ORDER BY (the main path's small sorts) and at W2's
    # window sort (8,388,608 rows of capacity, the largest sf1 sort)
    for tag, name in K10_TIMED.items():
        page, keys = cap.calls[(f"sort_rows_cuda:{tag}", "sf1")][1]
        out.append(k10_row(name, launches["sort_rows"], page, keys,
                           originals["sort_rows"], f"{tag}'s sort", card))
    # both sides of the one-block threshold, on the same key set
    small = []
    for n in (S.SMALL_ROWS, S.SMALL_ROWS + 1):
        page = sort_page(n, n, 77, dev)
        keys = [S.SortKey(c, a, nf) for c, a, nf in SORT_KEYSETS[4]]
        small.append(cuda_ms(lambda: originals["sort_rows"](page, keys)))
    say(f"[kernel] sort_rows (K10) at the one-block threshold: "
        f"{S.SMALL_ROWS} rows (one block) {small[0]:.4f} ms, "
        f"{S.SMALL_ROWS + 1} rows (one launch per pass) {small[1]:.4f} ms "
        f"per call (CUDA events, 4 keys) — {card}")

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


# ------------------------------------------- K28-K31 (the special aggregates)

SPECIAL_CASES = [  # label, cap, live rows, groups (0: a global aggregation)
    ("an empty page", 0, 0, 0), ("an empty grouped page", 0, 0, 3),
    ("one row", 1, 1, 1), ("one group", 5000, 4321, 1),
    ("3 groups", 5000, 4321, 3), ("global", 100_000, 99_000, 0),
    ("3,000 groups", 100_000, 99_000, 3000),
    ("2^20 groups", 1 << 22, (1 << 22) - 7, 1 << 20),
    ("1,000 groups on 2,048 rows", 2048, 2000, 1000)]
SPECIAL_HASHED = ("dbl", "tie", "dec", "i8", "i16", "i32", "f32", "day",
                  "bool", "code")
# (x, y) pairs of the positional checks: codes, decimals, floats, dates
# and doubles picked by ties, NaN/+inf, narrow negative integers, bools
SPECIAL_XY = (("code", "tie"), ("dec", "big"), ("f32", "i8"),
              ("day", "bool"), ("dbl", "dbl"), ("i16", "code"))


def special_page(g, cap, dev):
    """Seeded columns for K29-K31: doubles with NaN, -0.0, +0.0 and +-inf
    (`tie` draws from 8 values, so ties at every extremum and rank), a
    decimal, few distinct int64 values, negative int8/int16/int32, float32
    with NaN and -0.0, a date, booleans and dictionary codes; a validity
    mask per column, a FILTER and a p column (0.5, one live row 0.75, the
    dead rows 1.0)."""
    def r(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (cap,), generator=g,
                             dtype=torch.int64).to(dtype)
    tie = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                        0.0, 3.5, 3.5, -2.0], dtype=torch.float64)
    cols = {"dbl": torch.randn(cap, generator=g, dtype=torch.float64) * 1e3,
            "tie": tie[r(0, 8)], "dec": r(-10**9, 10**9),
            "big": r(-6, 6) * 2**36, "i8": r(-128, 128, torch.int8),
            "i16": r(-2**15, 2**15, torch.int16),
            "i32": r(-2**31, 2**31, torch.int32),
            "f32": (torch.randn(cap, generator=g) * 50).to(torch.float32),
            "day": r(8000, 8040, torch.int32), "bool": r(0, 2, torch.bool),
            "code": r(0, 40, torch.int32)}
    if cap >= 32:
        cols["dbl"][::13] = float("nan")
        cols["dbl"][1::11] = -0.0
        cols["dbl"][3::19] = float("inf")
        cols["dbl"][4::23] = float("-inf")
        cols["f32"][::7] = float("nan")
        cols["f32"][1::9] = -0.0
    valid = {k: (torch.rand(cap, generator=g) < 0.9).to(dev) for k in cols}
    filt = (torch.rand(cap, generator=g) < 0.8).to(dev)
    return {k: v.to(dev) for k, v in cols.items()}, valid, filt


def special_keys(g, cap, n, ngroups, dev):
    """One int64 group key with about `ngroups` values (NULLs but for one
    group), and the rows' groups from K28 and its twin."""
    from trino_tpu_torch.ops import aggregate as A
    key = torch.randint(0, max(ngroups, 1), (cap,), generator=g,
                        dtype=torch.int64) * 1_000_003 - 2**40
    valid = None if ngroups == 1 else \
        (torch.rand(cap, generator=g) >= 0.05).to(dev)
    keys = [A.GroupKey(key.to(dev), valid)]
    nr = torch.tensor(n, dtype=torch.int32, device=dev)
    got = A.group_ids_cuda(keys, [], nr, cap)
    sync()
    want = A.group_ids_plain(keys, [], nr, cap)
    kv, km, _, ng, gid = got
    G = int(ng)
    if G != int(want[3]):
        fail(f"K28: {G} groups, twin {int(want[3])} (cap={cap})")
    live = torch.arange(cap, device=dev) < n
    if bool((gid[~live] != G).any()) or bool(
            ((gid[live] < 0) | (gid[live] >= G)).any()):
        fail(f"K28: a row's group lies outside [0, {G}) (cap={cap})")
    # every live row's canonical key is its output row's
    rows = gid[live].to(torch.int64)
    for k, v, m in zip(keys, kv, km):
        rn, rv = A._canonical(A.GroupKey(k.values[live], None if k.valid is
                                         None else k.valid[live]))
        on, ov = A._canonical(A.GroupKey(v[:G], None if m is None
                                         else m[:G]))
        if not (torch.equal(rn, on[rows]) and torch.equal(rv, ov[rows])):
            fail(f"K28: a row's group keys differ from its output row's "
                 f"(cap={cap})")
    return gid, ng, nr


def _same_picks(label, got, want, G) -> None:
    (gv, gm), (wv, wm) = got, want
    gv, gm, wv, wm = gv[:G], gm[:G], wv[:G], wm[:G]
    zero = torch.zeros((), dtype=gv.dtype, device=gv.device)
    if not torch.equal(gm, wm) or not same_bits(
            torch.where(gm, gv, zero), torch.where(wm, wv, zero)):
        fail(f"{label} differs from its twin")


def hll_kernels() -> int:
    """The kernels K30's HLL mode has launched in this process, counted by
    csrc/special_agg.cu as it enqueues them."""
    import ctypes
    from trino_tpu_torch import native
    fn = native.library("special_agg").special_hll_kernels
    fn.restype = ctypes.c_int64
    return fn()


def check_special(g, dev) -> float:
    """K28-K31 against their twins on SPECIAL_CASES: K28's row -> group
    map (every live row's key is its output row's; dead rows get
    num_groups); K29's hash in both modes over every column dtype, bit for
    bit; K30's HLL fold over the twin's (pair, max rho) page, the
    estimates exactly; K30's centered mode in every kind (validity exactly,
    doubles to 1e-9 relative or 1e-9 of the column's largest magnitude, a
    value near zero having no meaningful relative bound); K30's positional
    mode and K31 exactly. Returns the largest float error."""
    from trino_tpu_torch.ops import aggregate as A
    worst = 0.0
    for label, cap, n, ngroups in SPECIAL_CASES:
        cols, valid, filt = special_page(g, cap, dev)
        if ngroups:
            gid, ng, nr = special_keys(g, cap, n, ngroups, dev)
            nseg, G = cap, int(ng)
        else:
            gid, ng = None, None
            nr = torch.tensor(n, dtype=torch.int32, device=dev)
            nseg, G = 1, 1
        if nseg == 0:
            continue
        live = torch.arange(cap, device=dev) < n
        for c in SPECIAL_HASHED:
            mask = (live & valid[c] & filt).contiguous()
            if not torch.equal(A.checksum_contrib_cuda(cols[c], mask),
                               A.checksum_contrib_plain(cols[c], mask)):
                fail(f"K29 checksum mode differs from its twin ({c}, "
                     f"{label})")
            masks = [valid[c], filt]
            got = A.hll_pairs_cuda(cols[c], masks, nr, gid)
            want = A.hll_pairs_plain(cols[c], masks, nr, gid)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                fail(f"K29 HLL mode differs from its twin ({c}, {label})")
            kv, _, regs, npairs = A.group_reduce_plain(
                [A.GroupKey(want[0], None)],
                [A.StateInput(want[1], None, None, A.MAX, False)], nr, cap)
            fold = (kv[0], regs[0], npairs, ng, nseg)
            before, kernels = A.hll_fold_cuda.launches, hll_kernels()
            est = A.hll_fold_cuda(*fold)[:G].clone()
            again = A.hll_fold_cuda(*fold)[:G]
            calls = A.hll_fold_cuda.launches - before
            per_call = (hll_kernels() - kernels) / 2
            want_k = 1 + (nseg > A.HLL_LAST_BLOCK_GROUPS)
            if calls != 2 or per_call != want_k:
                fail(f"K30 HLL mode counted {calls} calls and {per_call:g} "
                     f"kernels per call, not 2 and {want_k} ({c}, {label})")
            if not torch.equal(est, A.hll_fold_plain(*fold)[:G]):
                fail(f"K30 HLL mode differs from its twin ({c}, {label})")
            if not torch.equal(again, est):
                fail(f"K30 HLL mode's second call differs from its first: "
                     f"its scratch was not zero ({c}, {label})")
        say(f"[kernel] special_hll (K30 HLL mode) at {label} (nseg {nseg}, "
            f"{G} groups, threshold {A.HLL_LAST_BLOCK_GROUPS}): "
            f"{per_call:g} kernel launch(es) per call")
        for kind in range(9):
            for a, div, b in (("dbl", None, "i32"), ("dec", 100.0, "dbl"),
                              ("f32", None, None), ("i8", None, "day")):
                masks = [valid[a], filt] + ([] if b is None else [valid[b]])
                bb = None if b is None else cols[b]
                got = A.centered_cuda(kind, cols[a], div, bb, None, masks,
                                      nr, gid, ng, nseg)
                want = A.centered_plain(kind, cols[a], div, bb, None, masks,
                                        nr, gid, ng, nseg)
                gv, gm, wv, wm = got[0][:G], got[1][:G], want[0][:G], \
                    want[1][:G]
                if not torch.equal(gm, wm):
                    fail(f"K30 centered kind {kind} validity differs from "
                         f"its twin ({a}, {b}, {label})")
                gv, wv = gv[wm], wv[wm]
                scale = float(wv[torch.isfinite(wv)].abs().max()) \
                    if bool(torch.isfinite(wv).any()) else 0.0
                ok = (gv == wv) | (torch.isnan(gv) & torch.isnan(wv)) | (
                    (gv - wv).abs() <= 1e-9 * torch.maximum(
                        torch.maximum(gv.abs(), wv.abs()),
                        torch.full_like(gv, scale)))
                if not bool(ok.all()):
                    fail(f"K30 centered kind {kind} differs from its twin "
                         f"({a}, {b}, {label})")
                worst = max(worst, max_abs_err(gv[torch.isfinite(wv)],
                                               wv[torch.isfinite(wv)]))
        for kind in (A.ARBITRARY, A.MIN_BY, A.MAX_BY):
            for x, y in SPECIAL_XY:
                yy = None if kind == A.ARBITRARY else cols[y]
                masks = [filt, valid[x] if kind == A.ARBITRARY else valid[y]]
                _same_picks(
                    f"K30 positional kind {kind} ({x} by {y}, {label})",
                    A.positional_cuda(kind, cols[x], valid[x], yy, masks,
                                      nr, gid, ng, nseg),
                    A.positional_plain(kind, cols[x], valid[x], yy, masks,
                                       nr, gid, ng, nseg), G)
        for x in ("tie", "dec", "day", "f32", "code", "bool"):
            for pv in (0.5, 0.99, 0.0, 1.0):
                p = torch.full((cap,), pv, dtype=torch.float64, device=dev)
                if cap > 3:
                    p[1] = 0.75
                p[n:] = 1.0
                masks = [valid[x], filt]
                _same_picks(
                    f"K31 ({x}, p {pv}, {label})",
                    A.percentile_cuda(cols[x], p, masks, nr, gid, ng, nseg),
                    A.percentile_plain(cols[x], p, masks, nr, gid, ng, nseg),
                    G)
        sync()
    return worst


# regr_intercept = mean(a) - slope * mean(b) cancels two terms of about
# mean(a) (S1: about 38,000 against intercepts of -17 to 63), so a 1e-12
# relative difference in the group sums, which float64 atomics in another
# order than the CPU's give, moves it by more than 1e-9 of itself. Such a
# column is held to 1e-9 of its group's mean(a), read from the CPU port:
# query -> (SQL giving each group's keys and scale, key columns, {output
# column: scale column}).
_S1_SCALE = ("SELECT l_returnflag, l_linestatus, avg(l_extendedprice) "
             "FROM lineitem GROUP BY 1, 2", 2, {10: 2})
SPECIAL_SCALES = {"S1": _S1_SCALE, "S1_sf10": _S1_SCALE}


def rows_equal_scaled(got, want, scale_rows, nkeys, cols) -> bool:
    """rows_equal, but for the columns `cols` maps: rows matched on their
    first nkeys columns, and each such column held to 1e-9 of its group's
    scale (scale_rows: the keys, then the scales)."""
    scales = {tuple(r[:nkeys]): r for r in scale_rows}
    if len(got) != len(want) or len(scales) != len(want):
        return False
    rest_g, rest_w = [], []
    for rg, rw in zip(sorted(got, key=lambda r: str(r[:nkeys])),
                      sorted(want, key=lambda r: str(r[:nkeys]))):
        key = tuple(rw[:nkeys])
        if tuple(rg[:nkeys]) != key or key not in scales:
            return False
        for c, sc in cols.items():
            x, y = rg[c], rw[c]
            if (x is None) != (y is None):
                return False
            if x is not None and abs(x - y) > 1e-9 * max(
                    abs(x), abs(y), abs(float(scales[key][sc]))):
                return False
        rest_g.append(tuple(v for j, v in enumerate(rg) if j not in cols))
        rest_w.append(tuple(v for j, v in enumerate(rw) if j not in cols))
    return rows_equal(rest_g, rest_w)


def table_rows(sql: str, schema: str) -> int:
    from trino_tpu_torch.connector import tpch_gen
    table = "lineitem" if "FROM lineitem" in sql else "orders"
    return tpch_gen.row_count(table, {"sf1": 1.0, "sf10": 10.0}[schema])


def special_runs(gpu, cpu, cap, kernels, special_kernels, card):
    """The special-aggregate path: SPECIAL_QUERIES on the card (every
    kernel's count set to 0 just before, read just after), no special
    aggregate through a plain twin, rows equal to the CPU port's. Prints
    a [special] line per query; returns the path's launches."""
    from trino_tpu_torch.ops import aggregate as A
    twins = ("group_ids_plain", "checksum_contrib_plain", "hll_pairs_plain",
             "centered_plain", "positional_plain", "hll_fold_plain",
             "percentile_plain")
    real = {k: getattr(A, k) for k in twins}
    on_card = []

    def watched(k):
        def run(*args):
            if cap.label is not None and any(
                    isinstance(a, torch.Tensor) and a.is_cuda
                    for a in args):
                on_card.append((k, cap.label))
            return real[k](*args)
        return run
    for k in twins:
        setattr(A, k, watched(k))
    every = {**kernels, **special_kernels}
    reset_counts(every)
    results = {}
    for name, (schema, sql) in SPECIAL_QUERIES.items():
        cap.label = ("special", name)
        before = {k: getattr(mod, attr).launches
                  for k, (mod, attr) in every.items()}
        t0 = time.perf_counter()
        res = gpu[schema].execute(sql)
        sync()
        secs = time.perf_counter() - t0
        counts = {k: getattr(mod, attr).launches - before[k]
                  for k, (mod, attr) in every.items()}
        results[name] = res
        say(f"[special] {name} {schema}: {len(res.rows)} groups over "
            f"{table_rows(sql, schema):,} rows in {secs:.2f} s (first run); "
            + ", ".join(f"{k} {counts[k]}" for k in special_kernels)
            + "".join(f", {k} {n}" for k, n in counts.items()
                      if n and k not in special_kernels))
    cap.label = None
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in special_kernels.items()}
    for k, fn in real.items():
        setattr(A, k, fn)
    if on_card:
        fail(f"special aggregates on the card ran a plain twin: "
             f"{on_card[:5]}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the special-aggregate path never launched {missing}")
    for name, (schema, sql) in SPECIAL_QUERIES.items():
        want = cpu[schema].execute(sql).rows
        got = results[name].rows
        if name in SPECIAL_SCALES:
            scale_sql, nkeys, cols = SPECIAL_SCALES[name]
            same = rows_equal_scaled(got, want, cpu[schema].execute(
                scale_sql).rows, nkeys, cols)
        else:
            same = rows_equal(got, want)
        if not same:
            fail(f"{name} {schema}: cuda rows differ from the CPU run:\n"
                 f"{got[:3]}\n{want[:3]}")
        say(f"[special] {name} {schema}: cuda rows == cpu rows "
            f"({len(got)} rows, first {got[0] if got else None})")
    say(f"[launches] special-aggregate path ({len(SPECIAL_QUERIES)} "
        f"queries): {launches}; special aggregates through a plain twin "
        f"on the card: {len(on_card)} — {card}")
    return launches


def kernel_rows_special(cap: Capture, originals, launches, dev, card):
    """K28-K31 at their largest call of the special-aggregate path, each
    against its twin at those inputs. Bounds count the live rows; each
    input read once (however many passes read it), each output written
    once (grouped outputs: the groups that exist)."""
    from trino_tpu_torch.ops import aggregate as A
    out = []

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape, err):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n_launches, max_abs_err=err, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    def masks_bytes(masks, n):
        return col_bytes([(None, m) for m in masks if m is not None], n)

    def groups_of(gid, ng, n):
        g = torch.zeros(n, dtype=torch.int64, device=dev) if gid is None \
            else gid[:n].to(torch.int64)
        return g, 1 if ng is None else int(ng)

    # K28 at its largest call
    keys, states, nr, c = cap.calls[("group_ids_cuda", "special")][1]
    n = int(nr)
    got = originals["group_ids"](keys, states, nr, c)
    want = A.group_ids_plain(keys, states, nr, c)
    G = int(got[3])
    if G != int(want[3]) or bool((got[4][n:] != G).any()):
        fail("K28 differs from its twin at the main path's inputs")
    canon = [p.to(torch.int64)[:n] for k in keys for p in A._canonical(k)]
    stacked = torch.stack(canon, 1)
    out.append(row(
        "group_ids (K28, K8's group-id mode)",
        "trino_tpu_torch/csrc/group_agg.cu",
        "trino_tpu/ops/aggregate.py:578", launches["group_ids"],
        lambda: originals["group_ids"](keys, states, nr, c),
        lambda: A.group_ids_plain(keys, states, nr, c),
        # the live keys and states read once, each row's group written
        # once, the groups' keys and states once
        col_bytes([(k.values, k.valid) for k in keys]
                  + [(s.values, s.valid) for s in states], n) + 4 * c
        + col_bytes([(k.values, k.valid) for k in keys]
                    + [(s.values, None) for s in states], G),
        lambda: torch.unique(stacked, dim=0, return_inverse=True),
        "torch.unique(dim=0, return_inverse=True) of the canonical keys",
        f"cap {c}, {n} live rows, {len(keys)} keys, {len(states)} states, "
        f"{G} groups", 0.0))

    # K29 in both modes at their largest calls
    values, mask = cap.calls[("checksum_contrib_cuda", "special")][1]
    if not torch.equal(originals["checksum_contrib"](values, mask),
                       A.checksum_contrib_plain(values, mask)):
        fail("K29 checksum mode differs from its twin at the main path's "
             "inputs")
    c = values.numel()
    out.append(row(
        "special_hash checksum mode (K29)",
        "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:181", launches["checksum_contrib"],
        lambda: originals["checksum_contrib"](values, mask),
        lambda: A.checksum_contrib_plain(values, mask),
        # the column and its mask read, the contribution written, over
        # the page's capacity (the state column is [cap]; the mask holds
        # the live rows)
        c * (values.element_size() + 1 + 8), None,
        "none: no PyTorch call computes splitmix64",
        f"cap {c}, {values.dtype}", 0.0))
    values, masks, nr, gid = cap.calls[("hll_pairs_cuda", "special")][1]
    n = int(nr)
    got = originals["hll_pairs"](values, masks, nr, gid)
    want = A.hll_pairs_plain(values, masks, nr, gid)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        fail("K29 HLL mode differs from its twin at the main path's inputs")
    c = values.numel()
    out.append(row(
        "special_hash HLL mode (K29)", "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:204", launches["hll_pairs"],
        lambda: originals["hll_pairs"](values, masks, nr, gid),
        lambda: A.hll_pairs_plain(values, masks, nr, gid),
        col_bytes([(values, None), (gid, None)], n) + masks_bytes(masks, n)
        + 16 * c, None, "none: no PyTorch call computes splitmix64",
        f"cap {c}, {n} live rows, {values.dtype}, "
        f"{'grouped' if gid is not None else 'global'}", 0.0))

    # K30's three modes
    args = cap.calls[("centered_cuda", "special")][1]
    kind, a, a_div, b, b_div, masks, nr, gid, ng, nseg = args
    n = int(nr)
    got = originals["centered"](*args)
    want = A.centered_plain(*args)
    gg, G = groups_of(gid, ng, n)
    if not torch.equal(got[1][:G], want[1][:G]) or not close_f64(
            got[0][:G][want[1][:G]], want[0][:G][want[1][:G]]):
        fail("K30 centered mode differs from its twin at the main path's "
             "inputs")
    err = max_abs_err(got[0][:G][want[1][:G]], want[0][:G][want[1][:G]])
    acc = torch.zeros(max(G, 1), dtype=torch.float64, device=dev)
    av = a[:n].to(torch.float64)
    out.append(row(
        "special_centered (K30 centered mode)",
        "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:1143", launches["centered"],
        lambda: originals["centered"](*args),
        lambda: A.centered_plain(*args),
        col_bytes([(a, None), (b, None), (gid, None)], n)
        + masks_bytes(masks, n) + 9 * G,
        lambda: acc.index_add_(0, gg, av),
        "one index_add_ of the first argument by group",
        f"cap {a.numel()}, {n} live rows, kind {kind}, "
        f"{'two arguments' if b is not None else 'one argument'}, {G} "
        f"groups", err))
    args = cap.calls[("positional_cuda", "special")][1]
    kind, x, x_valid, y, masks, nr, gid, ng, nseg = args
    n = int(nr)
    _same_picks("K30 positional mode at the main path's inputs",
                originals["positional"](*args), A.positional_plain(*args),
                groups_of(gid, ng, n)[1])
    gg, G = groups_of(gid, ng, n)
    ykey = A._y_key((x if y is None else y)[:n])
    ident = torch.full((max(G, 1),), 2**63 - 1, dtype=torch.int64,
                       device=dev)
    out.append(row(
        "special_positional (K30 positional mode)",
        "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:1054", launches["positional"],
        lambda: originals["positional"](*args),
        lambda: A.positional_plain(*args),
        col_bytes([(y, None), (gid, None)], n) + masks_bytes(masks, n)
        + G * (2 * x.element_size() + 2),
        lambda: ident.scatter_reduce(0, gg, ykey, "amin"),
        "scatter_reduce(amin) of y's order keys by group",
        f"cap {x.numel()}, {n} live rows, kind {kind}, x {x.dtype}, "
        f"{G} groups", 0.0))
    args = cap.calls[("hll_fold_cuda", "special")][1]
    pairs, regs, npairs, ng, nseg = args
    n = int(npairs)
    G = 1 if ng is None else int(ng)
    first = originals["hll_fold"](*args)[:G].clone()
    if not torch.equal(first, A.hll_fold_plain(*args)[:G]) \
            or not torch.equal(originals["hll_fold"](*args)[:G], first):
        fail("K30 HLL mode differs from its twin at the main path's inputs "
             "(or its second call from its first)")
    say_split("special_hll (K30 HLL mode)", f"its largest fold ({n} "
              f"pairs, {G} groups, nseg {nseg})",
              lambda: originals["hll_fold"](*args), card)
    pg = (pairs[:n] >> A.HLL_P).clamp(0, max(G - 1, 0))
    inv = torch.exp2(-regs[:n].to(torch.float64))
    acc = torch.zeros(max(G, 1), dtype=torch.float64, device=dev)
    out.append(row(
        "special_hll (K30 HLL mode)", "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:231", launches["hll_fold"],
        lambda: originals["hll_fold"](*args),
        lambda: A.hll_fold_plain(*args),
        16 * n + 8 * G, lambda: acc.index_add_(0, pg, inv),
        "one index_add_ of 2^-reg by group",
        f"pair page cap {pairs.numel()}, {n} (group, bucket) pairs, "
        f"{G} groups", 0.0))

    # K31 at its largest call
    args = cap.calls[("percentile_cuda", "special")][1]
    x, p, masks, nr, gid, ng, nseg = args
    n = int(nr)
    G = 1 if ng is None else int(ng)
    _same_picks("K31 at the main path's inputs", originals["percentile"](
        *args), A.percentile_plain(*args), G)
    picks = torch.randint(0, max(n, 1), (G,), device=dev)
    # the yardstick sorts what K31 sorts: its (group, value) words of the
    # live rows, value word then group word (a stable LSD sort), and then
    # picks one position per group
    words = A.percentile_words_plain(x, masks, nr, gid)[:, :n]

    def sort_and_pick():
        order = torch.sort(words[1], stable=True).indices
        order = order[torch.sort(words[0][order], stable=True).indices]
        return x.index_select(0, order[picks])
    out.append(row(
        "special_percentile (K31, with K10's radix passes)",
        "trino_tpu_torch/csrc/special_agg.cu",
        "trino_tpu/ops/aggregate.py:288", launches["percentile"],
        lambda: originals["percentile"](*args),
        lambda: A.percentile_plain(*args),
        col_bytes([(x, None), (p, None), (gid, None)], n)
        + masks_bytes(masks, n) + G * (x.element_size() + 1),
        sort_and_pick,
        "torch.sort(stable=True) of the packed (group, value) words, value "
        "word then group word, plus index_select of one pick per group",
        f"cap {x.numel()}, {n} live rows, {x.dtype}, {G} groups", 0.0))
    return out


# ------------------------------------------- K32-K34 (ARRAY and MAP)

LIST_PLANE_LS = (1, 8, 128)     # K32's plane widths checked in phase 2
LIST_CASES = [  # cap, live rows, groups, L (K33); 0 groups: an empty page
    (10, 10, 3, 8), (5000, 4286, 37, 256), (64, 0, 0, 1),
    (1 << 20, 1 << 20, 100_000, 64), (4_194_304, 4_000_000, 1_500_000, 8)]


# K33 map mode's routes: label, cap, live rows, groups, L, key dtype, key
# range [lo, hi), the span the caller passes (a dictionary's size) or
# None. G x span against MAP_DIRECT_LIMIT (4,194,304) and the span against
# MAP_DIRECT_SPAN (4,096) on each side; the key draws are spread over the
# range's ends so the span is the range's
MAP_CASES = [
    ("codes, the span from the dictionary", 600_000, 590_000, 10_000, 64,
     torch.int32, 0, 7, 7),
    ("G x span at the limit", 300_000, 300_000, 2048, 256, torch.int32,
     -1024, 1024, None),
    ("G x span past the limit", 300_000, 300_000, 2048, 256, torch.int32,
     -1024, 1025, None),
    ("span at its widest", 50_000, 49_000, 3, 8192, torch.int16, 100, 4196,
     None),
    ("span past its widest", 50_000, 49_000, 3, 8192, torch.int16, 100,
     4197, None),
    ("negative keys", 100_000, 99_000, 500, 64, torch.int64, -5_000_000,
     -4_999_000, None),
    ("an int64 span past 64 bits with the group", 100_000, 99_000, 500,
     64, torch.int64, -2**63, 2**63 - 1, None),
    ("1-byte keys", 100_000, 99_000, 40, 256, torch.int8, -128, 128, None),
    ("floats, one word", 100_000, 99_000, 700, 64, torch.float32, -3, 4,
     None),
    ("an empty page", 64, 0, 0, 1, torch.int32, 0, 7, 7)]


def map_case(g, dev, cap, n, ng, dt, lo, hi):
    """(x, gid, num_rows, num_groups, masks, map_agg values) of one
    MAP_CASES row: keys uniform over [lo, hi) with both ends present,
    floats with NaN, -0.0, +0.0 and both infinities; the first live row of
    each group a key that also comes later, so map_agg's value of a key's
    first row is not always its group's first."""
    from trino_tpu_torch.ops import aggregate as A
    gk = torch.randint(0, max(ng, 1), (cap,), generator=g)
    nr = torch.tensor(n, dtype=torch.int32, device=dev)
    *_, G, gid = A.group_ids([A.GroupKey(gk.to(dev), None)], [], nr, cap)
    if dt.is_floating_point:
        x = (torch.randint(lo, hi, (cap,), generator=g) * 0.5).to(dt)
        if cap:
            x[::5] = float("nan")
            x[1::7] = -0.0
            x[2::9] = 0.0
            x[3::11] = float("inf")
            x[4::13] = float("-inf")
    else:
        x = torch.randint(lo, hi, (cap,), generator=g, dtype=torch.int64)
        if cap > 2:
            x[0], x[1] = lo, hi - 1
        x = x.to(dt)
    masks = [(torch.rand(cap, generator=g) < 0.9).to(dev)]
    if cap > 2:
        masks[0][:2] = True
    x2 = torch.randint(-1000, 1000, (cap,), generator=g).to(dev)
    return x.to(dev), gid, nr, G, masks, x2


def map_sorts(x, masks, nr, gid, G, plan) -> bool:
    """Whether a K33 map-mode call must take the sort route: the plan's
    route, or on ROUTE_AUTO the eligible keys' span past MAP_DIRECT_SPAN
    or G x span past the table, read on the host from the inputs."""
    from trino_tpu_torch.ops import lists as LS
    if plan.route != LS.ROUTE_AUTO:
        return plan.route == LS.ROUTE_SORT
    n, G = int(nr), int(G)
    g = gid[:n].to(torch.int64)
    elig = LS._eligible(masks, nr, x.shape[0])[:n] & (g >= 0) & (g < G)
    k = LS.map_key(x[:n])[elig]
    span = int(k.max()) - int(k.min()) + 1 if k.numel() else 1
    return span > LS.MAP_DIRECT_SPAN or G * span > plan.table


def check_map_routes(g, dev) -> None:
    """K33 map mode over MAP_CASES: each route the plan and the device
    take, the card's route read back and held to what the inputs call
    for, equal to its twin bit for bit for histogram and map_agg; one
    enqueue a call on the direct route."""
    from trino_tpu_torch.ops import lists as LS
    for label, cap, n, ng, L, dt, lo, hi, span in MAP_CASES:
        x, gid, nr, G, masks, x2 = map_case(g, dev, cap, n, ng, dt, lo, hi)
        rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
        plan = LS.map_plan(x, rows, span)
        want_sort = map_sorts(x, masks, nr, gid, G, plan)
        for v2 in (None, x2):
            kind = "histogram" if v2 is None else "map_agg"
            *got, sorted_ = LS.collect_map_cuda(x, v2, masks, nr, gid, G, L,
                                                rows, span, with_route=True)
            want = LS.collect_map_plain(x, v2, masks, nr, gid, G, L, rows)
            for a, b in zip(got, want):
                if not same_bits(a, b):
                    fail(f"K33 map mode ({label}, {kind}) differs from its "
                         f"twin")
            if bool(int(sorted_)) != want_sort:
                fail(f"K33 map mode ({label}, {kind}): the card took the "
                     f"{'sort' if int(sorted_) else 'direct'} route, its "
                     f"inputs call for the other")
        say(f"[map] {label}: {dt}, {int(G)} groups, L {L}, plan route "
            f"{plan.route}, the card's route "
            f"{'sort' if want_sort else 'direct'}, {plan.words} word(s), "
            f"{len(plan.passes)} K10 passes launched")
        if plan.route == LS.ROUTE_DIRECT and cap > 1000:
            one_enqueue(f"collect_map direct route ({label})", lambda:
                        LS.collect_map_cuda(x, None, masks, nr, gid, G, L,
                                            rows, span), "map")


def list_arrays(g, cap, L, dev):
    """A page's arrays with list planes: an int64 column, a bool validity,
    an int32 plane [cap, L] (dictionary codes), its lengths, a float64
    MAP value plane."""
    return [torch.randint(-99, 99, (cap,), generator=g).to(dev),
            (torch.rand(cap, generator=g) < 0.8).to(dev),
            torch.randint(0, 1000, (cap, L), generator=g,
                          dtype=torch.int32).to(dev),
            torch.randint(0, L + 1, (cap,), generator=g,
                          dtype=torch.int32).to(dev),
            torch.randn((cap, L), generator=g,
                        dtype=torch.float64).to(dev)]


def check_list(g, dev) -> float:
    """K32 (K1, K7 and K2 moving planes of L 1, 8 and 128; K2 padding a
    narrower page), K33's three modes (NULL inputs, NaN, +-0.0, +-inf,
    duplicate keys, a FILTER, an empty page, 1.5M groups over 4M rows)
    and K34 (count and expand) against their twins, bit for bit."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import lists as LS

    def same_all(label, got, want, n=None):
        for x, y in zip(got, want):
            if (x is None) != (y is None) or (x is not None and not same_bits(
                    x if n is None else x[:n], y if n is None else y[:n])):
                fail(f"{label} differs from its twin")
    for L in LIST_PLANE_LS:
        for cap, n in ((4097, 3001), (300_000, 299_999)):
            arrays = list_arrays(g, cap, L, dev)
            nr = torch.tensor(n, dtype=torch.int32, device=dev)
            mask = (torch.rand(cap, generator=g) < 0.5).to(dev)
            got, c = P.compact_rows_cuda(arrays, mask, nr)
            want, wc = P.compact_rows_plain(arrays, mask, nr)
            if int(c) != int(wc):
                fail(f"K32 in K1: count {int(c)}, twin {int(wc)} (L={L})")
            same_all(f"K32 in K1 (L={L}, cap={cap})", got, want, int(wc))
            idx = torch.randint(-3, cap + 3, (n,), generator=g).to(dev)
            same_all(f"K32 in K7 (L={L}, cap={cap})",
                     P.gather_rows_cuda(arrays, idx),
                     P.gather_rows_plain(arrays, idx))
            L2 = max(1, L // 2)
            narrow = list_arrays(g, 1000, L2, dev)
            narrow[1] = None          # a page without validity
            counts = [nr, torch.tensor(777, dtype=torch.int32, device=dev)]
            got, t = P.concat_rows_cuda([arrays, narrow], counts, cap + 1000)
            want, wt = P.concat_rows_plain([arrays, narrow], counts,
                                           cap + 1000)
            if int(t) != int(wt):
                fail(f"K32 in K2: total {int(t)}, twin {int(wt)} (L={L})")
            same_all(f"K32 in K2 (L={L}/{L2})", got, want, int(wt))
    for cap, n, ng, L in LIST_CASES:
        keys = torch.randint(0, max(ng, 1), (cap,), generator=g).to(dev)
        nr = torch.tensor(n, dtype=torch.int32, device=dev)
        *_, G, gid = A.group_ids([A.GroupKey(keys, None)], [], nr, cap)
        same_all(f"K33 size mode (cap={cap})",
                 [LS.collect_sizes_cuda(gid, nr, G)],
                 [LS.collect_sizes_plain(gid, nr, G)])
        rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
        for dt in (torch.int64, torch.float64, torch.int32, torch.float32):
            x = torch.randint(-3, 4, (cap,), generator=g).to(dt)
            if dt.is_floating_point and cap:
                x[::5] = float("nan")
                x[1::7] = -0.0
                x[3::11] = float("inf")
                x[4::13] = float("-inf")
            x = x.to(dev)
            masks = [(torch.rand(cap, generator=g) < 0.8).to(dev),
                     (torch.rand(cap, generator=g) < 0.9).to(dev)]
            same_all(f"K33 array mode (cap={cap}, {dt})",
                     LS.collect_array_cuda(x, masks, nr, gid, G, L, rows),
                     LS.collect_array_plain(x, masks, nr, gid, G, L, rows))
            x2 = torch.randint(0, 1000, (cap,), generator=g).to(dev)
            for v2 in (None, x2):
                same_all(f"K33 map mode (cap={cap}, {dt}, "
                         f"{'histogram' if v2 is None else 'map_agg'})",
                         LS.collect_map_cuda(x, v2, masks, nr, gid, G, L,
                                             rows),
                         LS.collect_map_plain(x, v2, masks, nr, gid, G, L,
                                              rows))
    check_map_routes(g, dev)
    for cap, L in ((4096, 8), (1_500_000, 8), (100_000, 3), (10, 1)):
        arrays = list_arrays(g, cap, L, dev)
        _, v, plane, lens, aux = arrays
        nr = torch.tensor(cap - 3, dtype=torch.int32, device=dev)
        t = LS.unnest_count_cuda(lens, v, nr)
        wt = LS.unnest_count_plain(lens, v, nr)
        if int(t) != int(wt):
            fail(f"K34 count {int(t)}, twin {int(wt)} (cap={cap})")
        total = int(wt)
        out_cap = max(1024, 1 << max(total - 1, 0).bit_length())
        got = LS.unnest_expand_cuda(lens, v, nr, plane, aux, out_cap, True)
        want = LS.unnest_expand_plain(lens, v, nr, plane, aux, out_cap,
                                      True)
        same_all(f"K34 expand (cap={cap}, L={L})", got[:4], want[:4], total)
        if int(got[4]) != total:
            fail(f"K34 expand total {int(got[4])}, twin {total}")
    return 0.0   # compared bit for bit


EXCHANGE_NS = (1, 2, 4, 8)    # destinations of phase 2's K35 cases
EXCHANGE_CASES = [  # label, cap, live rows per shard, key kind, heavy keys
    ("bigint", 3000, None, "i64", 0), ("double", 3000, None, "f64", 1),
    ("bool", 1000, None, "bool", 0), ("code", 5000, None, "code", 8),
    ("composite", 4096, None, "comp", 1), ("empty", 4096, 0, "i64", 0),
    ("one-destination", 8192, 8192, "one", 0),
    ("big", 4_194_304, 4_194_304, "i64", 8)]


def exchange_page(g, cap, n_live, kind, dev):
    """A seeded page for K35: key columns of `kind` (NULL, -1, NaN, -0.0
    among them), a double and an int32 payload with NULLs."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch import types as T
    n_live = int(torch.randint(0, cap + 1, (), generator=g)) \
        if n_live is None else n_live
    keys = torch.randint(-3, 40, (cap,), generator=g, dtype=torch.int64)
    keys[torch.rand(cap, generator=g) < 0.05] = -1
    valid = torch.rand(cap, generator=g) >= 0.05
    cols = []
    if kind == "f64":
        k = keys.to(torch.float64) / 2
        k[torch.rand(cap, generator=g) < 0.1] = -0.0
        k[torch.rand(cap, generator=g) < 0.05] = float("nan")
        cols.append(P.Column(k, valid, T.DOUBLE))
    elif kind == "bool":
        cols.append(P.Column(keys > 10, valid, T.BOOLEAN))
    elif kind == "code":
        cols.append(P.Column(keys.clamp(0, 30).to(torch.int32), valid,
                             T.INTEGER))
    elif kind == "comp":
        cols.append(P.Column(keys, valid, T.BIGINT))
        cols.append(P.Column((keys % 5).to(torch.int32), None, T.INTEGER))
    elif kind == "one":
        cols.append(P.Column(torch.full((cap,), 42, dtype=torch.int64),
                             None, T.BIGINT))
    else:
        cols.append(P.Column(keys, valid, T.BIGINT))
    pay = torch.randn(cap, generator=g, dtype=torch.float64)
    cols.append(P.Column(pay, torch.rand(cap, generator=g) < 0.9, T.DOUBLE))
    cols.append(P.Column(torch.randint(0, 1 << 30, (cap,), generator=g,
                                       dtype=torch.int32), None, T.INTEGER))
    page = P.Page(tuple(cols), P.row_count(n_live, "cpu"))
    nkeys = 2 if kind == "comp" else 1
    return page, list(range(nkeys))


# K36's local mode in phase 2 (label, capacity, layout): every case at k
# 1, 8 and 64, two calls in a row (the second finds the ticket the first
# reset), one launch a call, bit for bit against heavy_local_plain
HEAVY_KS = (1, 8, 64)
HEAVY_D4 = (8_388_608, 3_805_999, 1_000_000)  # cap, live words, keys
HEAVY_CASES = [
    ("cap 0", 0, "empty"),
    ("cap < k", 5, "short"),
    ("all sentinel", 100_000, "sentinel"),
    ("every live word distinct", 12_000, "distinct"),
    ("fewer distinct keys than k", 50_000, "few"),
    ("one key over 245 tiles (a run of 1,000,000)", 2_097_152, "long"),
    ("runs starting at tile boundaries", 40_000, "boundary"),
    ("a D4 sf10 q9 shard's shape", HEAVY_D4[0], "d4")]


def heavy_runs(g, lengths, cap: int) -> torch.Tensor:
    """Distinct ascending words below 2^62, run i repeating its word
    lengths[i] times, then the sentinel (-1) up to cap."""
    n = len(lengths)
    keys = torch.unique(torch.randint(0, 1 << 62, (2 * n + 8,),
                                      generator=g))[:n]
    words = torch.repeat_interleave(keys, torch.tensor(lengths,
                                                       dtype=torch.int64))
    out = torch.full((cap,), -1, dtype=torch.int64)
    out[:words.numel()] = words
    return out


def heavy_case_words(g, cap: int, layout: str) -> torch.Tensor:
    """One HEAVY_CASES input on the CPU: sorted u64 words as int64, the
    sentinel last, as K10 leaves a shard's masked key words."""
    from trino_tpu_torch import launch_trace as LT

    def short_runs(n):
        return torch.randint(1, 8, (n,), generator=g).tolist()
    if layout == "empty":
        return torch.zeros(0, dtype=torch.int64)
    if layout == "short":
        return heavy_runs(g, [2, 1], cap)
    if layout == "sentinel":
        return torch.full((cap,), -1, dtype=torch.int64)
    if layout == "distinct":          # no zero-count position below L
        return heavy_runs(g, [1] * 10_000, cap)
    if layout == "few":
        return heavy_runs(g, [20_000, 5, 17_000], cap)
    if layout == "long":
        return heavy_runs(g, short_runs(50_000) + [1_000_000]
                          + short_runs(100_000), cap)
    if layout == "boundary":          # runs from 4,096 and 8,192
        return heavy_runs(g, [64, 64, 4096 - 128, 4096, 4097, 5]
                          + [3] * 5000, cap)
    cap, live, keys = HEAVY_D4
    return LT.heavy_words(cap, live, keys, seed=int(torch.randint(
        0, 1 << 30, (), generator=g)))


def check_heavy(g, dev) -> int:
    """K36's local mode over HEAVY_CASES at k 1, 8 and 64 against
    heavy_local_plain bit for bit, two calls in a row, one launch a call.
    Returns the calls checked."""
    from trino_tpu_torch.parallel import exchange as X
    checked = 0
    for label, cap, layout in HEAVY_CASES:
        words = heavy_case_words(g, cap, layout).to(dev)
        for k in HEAVY_KS:
            want = X.heavy_local_plain(words, k)
            before = X.heavy_local_cuda.launches
            got = [X.heavy_local_cuda(words, k) for _ in range(2)]
            sync()
            ran = X.heavy_local_cuda.launches - before
            if ran != 2:
                fail(f"K36 local mode launched {ran} times in two calls "
                     f"({label}, k {k})")
            for c, kk in got:
                if not (same_bits(c, want[0]) and same_bits(kk, want[1])):
                    fail(f"K36 local mode differs from its twin ({label}, "
                         f"k {k}): {c.tolist()} {kk.tolist()} / "
                         f"{want[0].tolist()} {want[1].tolist()}")
            checked += 2
    return checked


# K27 in phase 2: helpers per call, each at num_rows 0, part and all
POST_HELPERS = (0, 1, 2, 9, 40)
POST_CAP = 100_003


def check_post(g, dev) -> int:
    """K27 against agg_post_plain on the live rows for 0, 1, 2, 9 and 40
    helpers at num_rows 0, a third and all of POST_CAP: one launch a call
    with a helper, none without. Returns the calls checked."""
    from trino_tpu_torch.ops import join_mxu as JM
    checked = 0
    for m in POST_HELPERS:
        helpers = [torch.randint(-1, 3, (POST_CAP,), generator=g).to(dev)
                   for _ in range(m)]
        for n in (0, POST_CAP // 3, POST_CAP):
            nr = torch.tensor(n, dtype=torch.int32, device=dev)
            before = JM.agg_post_cuda.launches
            got = JM.agg_post_cuda(helpers, nr)
            want = JM.agg_post_plain(helpers, nr)
            sync()
            if JM.agg_post_cuda.launches != before + (1 if m else 0):
                fail(f"K27 launched {JM.agg_post_cuda.launches - before} "
                     f"times for {m} helpers")
            if len(got) != m or not all(torch.equal(x[:n], y[:n])
                                        for x, y in zip(got, want)):
                fail(f"K27 differs from its twin ({m} helpers, {n} live "
                     f"rows)")
            checked += 1
    return checked


# K35's scatter in phase 2 (label, capacity, live rows, destinations,
# mode, share of rows on one heavy key, bucket as a share of the largest
# count): num_rows at 0, inside a tile, on a tile boundary and at the
# capacity; n 1 to 64; a heavy key replicated (or spread) past the
# bucket; a D4 sf10 q9 shard's shape. Every case moves SCATTER_ARRAYS.
SCATTER_CASES = [
    ("num_rows 0", 20_000, 0, 8, 0, 0.0, 1.0),
    ("a tile straddling num_rows", 20_000, 10_000, 8, 0, 0.0, 1.0),
    ("num_rows on a tile boundary, spread", 20_000, 8192, 4, 1, 0.2, 1.0),
    ("num_rows = capacity", 12_288, 12_288, 2, 0, 0.0, 1.0),
    ("one destination", 10_000, 9_000, 1, 0, 0.0, 1.0),
    ("n = 64", 300_000, 299_000, 64, 0, 0.0, 1.0),
    ("n = 64, replicate", 50_000, 49_000, 64, 2, 0.01, 1.0),
    ("replicate, a heavy key past the bucket", 100_000, 99_000, 8, 2, 0.3,
     0.5),
    ("spread past the bucket", 100_000, 99_000, 8, 1, 0.3, 0.5),
    ("a D4 sf10 q9 shard", 8_388_608, 7_503_144, 8, 0, 0.0, 1.0)]
SCATTER_HEAVY_KEY = 123_456_789


def scatter_arrays(g, cap, dev):
    """K35's moved arrays of 1, 2, 4, 8, 12 and 16 row bytes: int64 and
    its validity, float64 with no validity (written as true), int32,
    int16, bool, an int32 list plane of L 3 and an int64 plane of L 2
    (K32's planes go from source to slot), as [(array, template)]."""
    def ints(dt, shape=(cap,)):
        return torch.randint(-1 << 14, 1 << 14, shape, generator=g,
                             dtype=dt).to(dev)
    f = torch.randn(cap, generator=g, dtype=torch.float64).to(dev)
    valid = (torch.rand(cap, generator=g) < 0.9).to(dev)
    flag = (torch.rand(cap, generator=g) < 0.5).to(dev)
    arrays = [(ints(torch.int64), None), (valid, None), (f, None),
              (None, torch.empty(0, dtype=torch.bool, device=dev)),
              (ints(torch.int32), None), (ints(torch.int16), None),
              (flag, None), (ints(torch.int32, (cap, 3)), None),
              (ints(torch.int64, (cap, 2)), None)]
    return [(a, a if like is None else like) for a, like in arrays]


def check_scatter(g, dev) -> int:
    """K35's scatter over SCATTER_CASES against exchange_scatter_plain bit
    for bit over every occupied slot of every array, one launch a call,
    the state from K35's count pass on the card; one enqueue a call at
    the D4 shard's shape. Returns the calls checked."""
    from trino_tpu_torch.parallel import exchange as X
    checked = 0
    for label, cap, live, n, mode, share, bucket_share in SCATTER_CASES:
        keys = torch.randint(0, 1 << 40, (cap,), generator=g)
        if share:
            keys[torch.rand(cap, generator=g) < share] = SCATTER_HEAVY_KEY
        kvalid = torch.rand(cap, generator=g) >= 0.02
        cols = [(keys.to(dev), kvalid.to(dev))]
        nr = torch.tensor(live, dtype=torch.int32, device=dev)
        heavy = None
        if mode != X.MODE_HASH:
            heavy = torch.full((8,), -1, dtype=torch.int64, device=dev)
            heavy[0] = SCATTER_HEAVY_KEY
        state, counts = X.exchange_count_cuda(cols, nr, n, mode, heavy)
        dest, want_counts = X.exchange_count_plain(cols, nr, n, mode, heavy)
        if not (same_bits(state[0], dest) and same_bits(counts,
                                                       want_counts)):
            fail(f"K35 count pass differs from its twin ({label})")
        cl = want_counts.tolist()
        bucket = max(1, int(max(cl + [1]) * bucket_share))
        arrays = scatter_arrays(g, cap, dev)
        before = X.exchange_scatter_cuda.launches
        got = X.exchange_scatter_cuda(state, arrays, n, bucket)
        want = X.exchange_scatter_plain(dest, arrays, n, bucket)
        sync()
        if X.exchange_scatter_cuda.launches != before + 1:
            fail(f"K35 scatter launched "
                 f"{X.exchange_scatter_cuda.launches - before} times in "
                 f"one call ({label})")
        for i, (a, b) in enumerate(zip(got, want)):
            for d in range(n):
                m = min(cl[d], bucket)
                lo = d * bucket
                if not same_bits(a[lo:lo + m], b[lo:lo + m]):
                    fail(f"K35 scatter differs from its twin ({label}, "
                         f"array {i}, destination {d})")
        if bucket_share < 1 and max(cl) <= bucket:
            fail(f"K35 scatter case {label} does not pass its bucket")
        checked += 1
        if cap == SCATTER_CASES[-1][1]:
            one_enqueue(f"exchange_scatter at {label}", lambda:
                        X.exchange_scatter_cuda(state, arrays, n, bucket),
                        "scatter")
    return checked


# K25 in phase 2 (label, capacity, live rows, slots, table columns,
# outputs, key kind): num_rows 0, part and all, an odd capacity (a
# thread's single last row), a 32,768-slot table read through L2, G3's
# probe, double keys, 70 outputs (the largest parameter block)
LOOKUP_CASES = [
    ("num_rows 0", 100_000, 0, 256, 3, 10, "int"),
    ("part, odd capacity", 100_001, 61_237, 256, 3, 10, "int"),
    ("all", 100_000, 100_000, 256, 3, 10, "int"),
    ("all, odd", 100_001, 100_001, 256, 3, 6, "int"),
    ("a 32,768-slot table (G2 at sf1)", 1_000_003, 999_999, 32_768, 4, 10,
     "int"),
    ("double keys", 50_000, 49_999, 128, 3, 10, "double"),
    ("70 outputs", 20_000, 17_777, 64, 3, 70, "int"),
    ("G3's probe", 8_388_608, 5_999_956, 256, 3, 4, "int")]


def lookup_case(g, cap, slots, ncols, nout, kind, dev):
    """K25's inputs: probe keys over the span, past it and below it with
    NULLs, a (slots, ncols) table (float64 bits in column 2), and `nout`
    outputs cycling through every op (G3's four for nout 4)."""
    from trino_tpu_torch.ops import join_mxu as JM
    raw = torch.randint(-9, slots + 9, (cap,), generator=g)
    if kind == "double":
        base = int(torch.tensor(1.0, dtype=torch.float64).view(torch.int64))
        keys = (raw + base).view(torch.float64).clone()
        keys[raw == 3] = -0.0
        kmin = base
    else:
        keys, kmin = raw + 1000, 1000
    key = (keys.to(dev), (torch.rand(cap, generator=g) >= 0.05).to(dev))
    table = torch.randint(0, 50, (slots, ncols), generator=g)
    table[:, 2] = (torch.rand(slots, generator=g, dtype=torch.float64)
                   * 1e3).view(torch.int64)
    table[torch.rand(slots, generator=g) < 0.1, 0] = 0
    pv = (torch.randint(-10**9, 10**9, (cap,), generator=g).to(dev),
          (torch.rand(cap, generator=g) >= 0.1).to(dev))
    pi = (torch.randint(-100, 100, (cap,), generator=g,
                        dtype=torch.int32).to(dev), None)
    pf = ((torch.randn(cap, generator=g) * 1e3).to(dev), None)
    pd = ((torch.randn(cap, generator=g, dtype=torch.float64)).to(dev),
          (torch.rand(cap, generator=g) >= 0.1).to(dev))
    if nout == 4:      # G3: the pairs, value x pairs, two table columns
        outs = [(JM.OP_PAIRS, 0, None, None), (JM.OP_SUMP_I, 0, *pi),
                (JM.OP_TABLE_I, 1, None, None), (JM.OP_TABLE_I, 2, None,
                                                 None)]
    else:
        every = [(JM.OP_PAIRS, 0, None, None), (JM.OP_CNTP, 0, *pv),
                 (JM.OP_SUMP_I, 0, *pv), (JM.OP_SUMP_I, 0, *pi),
                 (JM.OP_SUMP_F, 0, *pf), (JM.OP_SUMP_F, 0, *pd),
                 (JM.OP_TABLE_I, 1, None, None),
                 (JM.OP_TABLE_F, 2, None, None),
                 (JM.OP_CNTP, 0, pi[0], None),
                 (JM.OP_TABLE_I, ncols - 1, None, None)]
        outs = [every[q % len(every)] for q in range(nout)]
    kmin_t = torch.tensor([kmin], dtype=torch.int64, device=dev)
    return key, table.to(dev), kmin_t, outs


def check_lookup(g, dev) -> int:
    """K25 over LOOKUP_CASES against agg_lookup_plain bit for bit on the
    live rows (outputs and mask; the padding is left unwritten), one
    launch a call; one enqueue a call at G3's probe. Returns the calls
    checked."""
    from trino_tpu_torch.ops import join_mxu as JM
    checked = 0
    for label, cap, live, slots, ncols, nout, kind in LOOKUP_CASES:
        key, table, kmin, outs = lookup_case(g, cap, slots, ncols, nout,
                                             kind, dev)
        nr = torch.tensor(live, dtype=torch.int32, device=dev)
        before = JM.agg_lookup_cuda.launches
        got, glive = JM.agg_lookup_cuda(key, nr, table, kmin, outs)
        want, wlive = JM.agg_lookup_plain(key, nr, table, kmin, outs)
        sync()
        if JM.agg_lookup_cuda.launches != before + 1:
            fail(f"K25 launched {JM.agg_lookup_cuda.launches - before} "
                 f"times in one call ({label})")
        if not torch.equal(glive[:live], wlive[:live]):
            fail(f"K25's live mask differs from its twin ({label})")
        for i, (x, y) in enumerate(zip(got, want)):
            if not same_bits(x[:live], y[:live]):
                fail(f"K25 output {i} differs from its twin ({label})")
        checked += 1
        if cap == LOOKUP_CASES[-1][1]:
            one_enqueue(f"agg_lookup at {label}", lambda: JM.agg_lookup_cuda(
                key, nr, table, kmin, outs), "lookup")
    return checked


def _on(page, dev):
    from trino_tpu_torch.parallel.mesh import to_device
    return to_device(page, torch.device(dev))


def check_exchange(g, dev) -> float:
    """K35 (count and scatter in hash, spread and replicate modes) and K36
    (local and merge modes) against their twins, bit for bit: dest and
    counts on every row, the scatter's occupied slots of every array, the
    heavy candidates and set; then whole exchanges (K35 + the K2
    receive) on the card against the CPU, shard by shard."""
    from trino_tpu_torch.parallel import exchange as X
    checked = 0
    for label, cap, n_live, kind, nheavy in EXCHANGE_CASES:
        for n in (EXCHANGE_NS if cap <= 8192 else (8,)):
            page, keys = exchange_page(g, cap, n_live, kind, "cpu")
            cols = X.key_columns(page, keys)
            kw, null = _key_words(cols)
            heavy = torch.full((8,), -1, dtype=torch.int64)
            if nheavy:
                live = kw[:int(page.num_rows)][~null[:int(page.num_rows)]]
                vals, cnt = torch.unique(live, return_counts=True) \
                    if live.numel() else (live, live)
                top = vals[torch.argsort(-cnt, stable=True)[:nheavy]]
                heavy[:top.numel()] = top
            gpage = _on(page, dev)
            gcols = X.key_columns(gpage, keys)
            for mode in (X.MODE_HASH, X.MODE_SPREAD, X.MODE_REPLICATE):
                hv = None if mode == X.MODE_HASH else heavy
                state, counts = X.exchange_count_cuda(
                    gcols, gpage.num_rows, n, mode,
                    None if hv is None else hv.to(dev))
                dest, want = X.exchange_count_plain(cols, page.num_rows, n,
                                                    mode, hv)
                if not (same_bits(state[0].cpu(), dest)
                        and same_bits(counts.cpu(), want)):
                    fail(f"K35 count {label} n={n} mode {mode} differs")
                cl = want.tolist()
                bucket = max(1, max(cl) // 2) if label == "one-destination" \
                    else max([1] + cl)
                arrays = X._moved_arrays(page)
                garrays = X._moved_arrays(gpage)
                got = X.exchange_scatter_cuda(state, garrays, n, bucket)
                ref = X.exchange_scatter_plain(dest, arrays, n, bucket)
                for a, b in zip(got, ref):
                    a = a.cpu()
                    for d in range(n):
                        m = min(cl[d], bucket)
                        lo = d * bucket
                        if not same_bits(a[lo:lo + m], b[lo:lo + m]):
                            fail(f"K35 scatter {label} n={n} mode {mode} "
                                 f"destination {d} differs")
                checked += 1
        # K36 over this page's masked key words
        live = page.row_mask() & ~null
        masked = torch.where(live, kw, torch.full_like(kw, -1))
        s = X._sorted_words(masked)
        for k in (1, 3, 8):
            c1, k1 = X.heavy_local_cuda(s.to(dev), k)
            c2, k2 = X.heavy_local_plain(s, k)
            if not (same_bits(c1.cpu(), c2) and same_bits(k1.cpu(), k2)):
                fail(f"K36 local {label} k={k} differs: {c1} {k1} / {c2} "
                     f"{k2}")
            keys_m = torch.cat([k2, k2.flip(0), k2[:1]])
            counts_m = torch.cat([c2, c2, c2[:1]])
            for thr in (1, int(c2.max()) if c2.numel() else 1, 1 << 40):
                h1 = X.heavy_merge_cuda(keys_m.to(dev), counts_m.to(dev), k,
                                        thr)
                h2 = X.heavy_merge_plain(keys_m, counts_m, k, thr)
                if not same_bits(h1.cpu(), h2):
                    fail(f"K36 merge {label} k={k} threshold {thr} differs")
    # whole exchanges: 8 shards on the card against the same on the CPU
    from trino_tpu_torch.parallel import QueryMesh
    for kind in ("i64", "f64", "code", "comp"):
        pages = [exchange_page(g, 2048, None, kind, "cpu") for _ in range(8)]
        keys = pages[0][1]
        cpu_pages = QueryMesh(["cpu"] * 8).shard_pages([p for p, _ in pages])
        gpu_pages = QueryMesh([dev] * 8).shard_pages([p for p, _ in pages])
        hc = X.detect_heavy_keys(cpu_pages, keys, 8, 64)
        hg = X.detect_heavy_keys(gpu_pages, keys, 8, 64)
        if not same_bits(hg[0].cpu(), hc[0]):
            fail(f"detect_heavy_keys {kind}: {hg[0]} on the card, {hc[0]}")
        for name, run in (
                ("hash", lambda ps, h: X.all_to_all_by_key(ps, keys, 1024)),
                ("spread", lambda ps, h: X.all_to_all_by_key(
                    ps, keys, 1024, heavy=h)),
                ("replicate", lambda ps, h: X.all_to_all_replicate(
                    ps, keys, 1024, h)),
                ("broadcast", lambda ps, h: (X.broadcast_page(ps), 0))):
            want, ovf_c = run(cpu_pages, hc)
            got, ovf_g = run(gpu_pages, hg)
            if ovf_c != ovf_g:
                fail(f"{name} {kind}: overflow {ovf_g} on the card, {ovf_c}")
            for s, (a, b) in enumerate(zip(got, want)):
                n_rows = int(b.num_rows)
                if int(a.num_rows) != n_rows or a.capacity != b.capacity:
                    fail(f"{name} {kind} shard {s}: rows or capacity differ")
                for ca, cb in zip(a.columns, b.columns):
                    for x, y in ((ca.values, cb.values),
                                 (ca.valid, cb.valid)):
                        if (x is None) != (y is None) or (
                                x is not None and not same_bits(
                                    x[:n_rows].cpu(), y[:n_rows])):
                            fail(f"{name} {kind} shard {s}: rows differ")
            checked += 1
    check_exchange.cases = checked
    return 0.0


def _key_words(cols):
    from trino_tpu_torch.ops.join import _key_cols
    return _key_cols(cols)


def list_runs(gpu, cpu, cap, kernels, list_kernels, card):
    """The list path: LIST_QUERIES on the card (every kernel's count set
    to 0 just before, read just after), no list operation through a
    plain twin and no list call through the torch-op compiler, rows equal
    to the CPU port's (L2_sf10 to its lineitem identity). Prints a [list]
    line per query; returns the path's launches (K32 as the plane-mode
    launches of K1, K2 and K7)."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.expr import compiler as EC
    from trino_tpu_torch.ops import lists as LS
    twins = {LS: ("collect_sizes_plain", "collect_array_plain",
                  "collect_map_plain", "unnest_count_plain",
                  "unnest_expand_plain"),
             P: ("compact_rows_plain", "gather_rows_plain",
                 "concat_rows_plain")}
    real = {(mod, k): getattr(mod, k) for mod, ks in twins.items()
            for k in ks}
    on_card = []

    def cuda_in(args):
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, (list, tuple)):
                    if cuda_in(t):
                        return True
                elif isinstance(t, torch.Tensor) and t.is_cuda:
                    return True
        return False

    def watched(mod, k):
        def run(*args):
            if cap.label is not None and cuda_in(args):
                on_card.append((k, cap.label))
            return real[(mod, k)](*args)
        return run
    for (mod, k) in real:
        setattr(mod, k, watched(mod, k))
    planes = [(P, "compact_rows_cuda"), (P, "compact_range_cuda"),
              (P, "gather_rows_cuda"), (P, "concat_rows_cuda")]
    every = {**kernels, **list_kernels}
    reset_counts(every)
    for mod, attr in planes:
        getattr(mod, attr).plane_launches = 0
    EC.cuda_evaluations = 0
    results = {}
    for name, (schema, sql) in LIST_QUERIES.items():
        cap.label = ("list", name)
        before = {k: getattr(mod, attr).launches
                  for k, (mod, attr) in every.items()}
        k32_before = sum(getattr(m, a).plane_launches for m, a in planes)
        t0 = time.perf_counter()
        runner = gpu[schema]
        res = runner.execute(sql)
        sync()
        secs = time.perf_counter() - t0
        counts = {k: getattr(mod, attr).launches - before[k]
                  for k, (mod, attr) in every.items()}
        k32 = sum(getattr(m, a).plane_launches for m, a in planes) \
            - k32_before
        results[name] = res
        steps = runner.last_lists
        coll = [e for e in steps if e["step"] == "collect"]
        unn = [e for e in steps if e["step"] == "unnest"]
        say(f"[list] {name} {schema}: {len(res.rows)} rows in {secs:.2f} s "
            f"(first run); "
            + "; ".join(f"collect {int(e['groups']):,} groups, L {e['L']}, "
                        f"{e['rows']:,} list rows" for e in coll)
            + (f"; UNNEST {len(unn)} pages, "
               f"{sum(e['slots'] for e in unn):,} slots from "
               f"{sum(e['rows'] for e in unn):,} page rows" if unn else "")
            + f"; plane bytes {sum(e.get('plane_bytes', 0) for e in coll):,}"
            f"; K32 {k32}, "
            + ", ".join(f"{k} {counts[k]}" for k in list_kernels)
            + "".join(f", {k} {n}" for k, n in counts.items()
                      if n and k not in list_kernels))
    cap.label = None
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in list_kernels.items()}
    launches["list_planes"] = sum(getattr(m, a).plane_launches
                                  for m, a in planes)
    for (mod, k), fn in real.items():
        setattr(mod, k, fn)
    if on_card:
        fail(f"list operations on the card ran a plain twin: {on_card[:5]}")
    if EC.cuda_evaluations:
        fail(f"{EC.cuda_evaluations} steps of the list path on the card ran "
             f"through the torch-op compiler, not K11")
    say(f"[k11] every filter and project step of the list path on the "
        f"card ran K11 ({launches['expr_step']} launches; the torch-op "
        f"compiler evaluated 0 steps, list calls included)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the list path never launched {missing}")
    for name, (schema, sql) in LIST_QUERIES.items():
        got = results[name].rows
        if name in LIST_IDENTITY:
            want = cpu[schema].execute(LIST_IDENTITY[name]).rows
            what = "the CPU port's lineitem identity"
        else:
            want = cpu[schema].execute(sql).rows
            what = "cpu rows"
        if not rows_equal(got, want):
            fail(f"{name} {schema}: cuda rows differ from {what}:\n"
                 f"{got[:3]}\n{want[:3]}")
        say(f"[list] {name} {schema}: cuda rows == {what} ({len(got)} "
            f"rows, first {got[0] if got else None})")
    say(f"[launches] list path ({len(LIST_QUERIES)} queries): {launches}; "
        f"list operations through a plain twin on the card: "
        f"{len(on_card)}; steps through the torch-op compiler: "
        f"{EC.cuda_evaluations} — {card}")
    return launches


# The distributed path: DistributedQueryRunner over 8 shards of the one
# card (["cuda:0"] * 8). name -> (schema, session, SQL, the card's local
# run it must equal: a phase-3 result key, or None to run the SQL on the
# card's LocalQueryRunner).
DIST_SHARDS = 8
DIST_PARTITIONED = (("join_distribution_type", "PARTITIONED"),)
# l_linenumber (INTEGER, 7 values) against nation's BIGINT key: written
# as `l_linenumber = n_nationkey` the comparison casts the probe key and
# plans a cross join; the cast on nation's side, below its exchange, keeps
# the partitioned pair on exactly the clause keys
DIST_SKEW_SQL = ("SELECT n_name, count(*), sum(l_extendedprice) FROM "
                 "lineitem, (SELECT n_name, CAST(n_nationkey AS INTEGER) "
                 "AS nk FROM nation) n WHERE l_linenumber = nk "
                 "GROUP BY n_name")
DIST_CUSTOMER_SQL = ("SELECT c_mktsegment, count(*), sum(o_totalprice) "
                     "FROM customer, orders WHERE c_custkey = o_custkey "
                     "GROUP BY c_mktsegment")
DIST_QUERIES = {f"D1_{q}": ("sf1", (), TPCH[q][0], ("sf1", q))
                for q in TPCH}
DIST_QUERIES.update({
    "D2_customer_orders": ("sf1", DIST_PARTITIONED, DIST_CUSTOMER_SQL, None),
    "D2_q3": ("sf1", DIST_PARTITIONED, TPCH["q3"][0], ("sf1", "q3")),
    "D3_skew_on": ("sf1", DIST_PARTITIONED, DIST_SKEW_SQL, None),
    "D3_skew_off": ("sf1", DIST_PARTITIONED
                    + (("skewed_exchange_enabled", False),), DIST_SKEW_SQL,
                    None),
    "D4_q3": ("sf10", DIST_PARTITIONED, TPCH["q3"][0], ("sf10", "q3")),
    "D4_q9": ("sf10", DIST_PARTITIONED, TPCH["q9"][0], ("sf10", "q9")),
    "D5_q3_staged": ("sf1", (("mesh_execution", False),), TPCH["q3"][0],
                     ("sf1", "q3")),
})


def dist_runners(schemas, dev="cuda:0"):
    from trino_tpu_torch.exec.distributed import DistributedQueryRunner
    return {s: DistributedQueryRunner.tpch(s, devices=[dev] * DIST_SHARDS)
            for s in schemas}


def _with_session(runner, session, fn):
    for k, v in session:
        runner.session.set(k, v)
    try:
        return fn()
    finally:
        for k, _ in session:
            runner.session.properties.pop(k, None)


def dist_runs(dist, gpu, results, cap, kernels, dist_kernels, card):
    """The distributed path: DIST_QUERIES over 8 shards of the card, every
    kernel's count set to 0 just before, read just after; no plain twin
    and no torch-op compiler step on the card; rows equal to the card's
    LocalQueryRunner (phase 3's runs, or the same SQL now). Prints an
    [exchange] line per query; returns (launches, first-run seconds)."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.exec.memory import NODE_POOL
    from trino_tpu_torch.expr import compiler as EC
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import sort as S
    from trino_tpu_torch.parallel import exchange as X
    # every plain twin of the modules the path runs must stay off the card
    real = {}
    for mod in (P, X, S, J, A):
        for k in dir(mod):
            if k.endswith("_plain") and callable(getattr(mod, k)):
                real[(mod, k)] = getattr(mod, k)
    on_card = []

    def cuda_in(args):
        for a in args:
            if isinstance(a, (list, tuple)):
                if cuda_in(a):
                    return True
            elif isinstance(a, torch.Tensor) and a.is_cuda:
                return True
            elif isinstance(a, P.Page) and a.device.type == "cuda":
                return True
        return False

    def watched(mod, k):
        def run(*args, **kw):
            if cap.label is not None and cuda_in(args):
                on_card.append((k, cap.label))
            return real[(mod, k)](*args, **kw)
        return run
    for (mod, k) in real:
        setattr(mod, k, watched(mod, k))
    every = {**kernels, **dist_kernels}
    reset_counts(every)
    EC.cuda_evaluations = 0
    got, secs = {}, {}
    try:
        for name, (schema, session, sql, _) in DIST_QUERIES.items():
            cap.label = ("dist", name)
            runner = dist[schema]
            before = {k: getattr(mod, attr).launches
                      for k, (mod, attr) in every.items()}
            NODE_POOL.device_peak.clear()
            t0 = time.perf_counter()
            res = _with_session(runner, session,
                                lambda: runner.execute(sql))
            sync()
            secs[name] = time.perf_counter() - t0
            got[name] = res
            counts = {k: getattr(mod, attr).launches - before[k]
                      for k, (mod, attr) in every.items()}
            st = runner.last_query_stats
            ex = runner.last_exchanges
            heavy = [e["heavy"] for e in ex if "heavy" in e][:1]
            say(f"[exchange] {name} {schema}: {len(res.rows)} rows in "
                f"{secs[name]:.2f} s (first run); fused "
                f"{st['exchanges_fused']}, staged {st['exchanges_staged']}, "
                f"rows {st['exchange_rows']:,}, bytes "
                f"{st['exchange_bytes']:,}; buckets "
                f"{[e.get('bucket') for e in ex if e.get('bucket')]}; heavy "
                f"keys {heavy[0] if heavy else 'none'}; per-shard peak bytes "
                f"{[NODE_POOL.device_peak.get(i, 0) for i in range(DIST_SHARDS)]}"
                f"; mxu_joins {st['mxu_joins']}; "
                + ", ".join(f"{k} {counts[k]}" for k in dist_kernels)
                + f"; plain twins on the card so far {len(on_card)} — {card}")
    finally:
        cap.label = None
        for (mod, k), fn in real.items():
            setattr(mod, k, fn)
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in dist_kernels.items()}
    if on_card:
        fail(f"the distributed path ran a plain twin on the card: "
             f"{on_card[:5]}")
    if EC.cuda_evaluations:
        fail(f"{EC.cuda_evaluations} steps of the distributed path ran "
             f"through the torch-op compiler, not K11")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the distributed path never launched {missing}")
    on = [e for e in DIST_QUERIES if e == "D3_skew_on"]
    for name, (schema, session, sql, key) in DIST_QUERIES.items():
        if key is not None:
            want = results[key][0].rows
            what = f"the card's local run of {key[1]}"
        else:
            want = _with_session(gpu[schema], session,
                                 lambda: gpu[schema].execute(sql)).rows
            what = "the card's local run"
        if not rows_equal(got[name].rows, want):
            fail(f"{name} {schema}: distributed rows differ from {what}:\n"
                 f"{got[name].rows[:3]}\n{want[:3]}")
        say(f"[exchange] {name} {schema}: rows == {what} "
            f"({len(want)} rows, first {want[0] if want else None})")
    if on and got["D3_skew_on"].rows and not rows_equal(
            got["D3_skew_on"].rows, got["D3_skew_off"].rows):
        fail("D3: skew on and off give different rows")
    say(f"[launches] distributed path ({len(DIST_QUERIES)} queries over "
        f"{DIST_SHARDS} shards): {launches}; plain twins on the card "
        f"{len(on_card)}; steps through the torch-op compiler "
        f"{EC.cuda_evaluations} — {card}")
    return launches, secs


def kernel_rows_dist(cap: Capture, originals, launches, dev, card):
    """K35 (count and scatter), K36 (local and merge) and K2 as the
    exchange receive at their largest call of the distributed path, each
    against its twin at those inputs. Bounds: bytes (K35 reads the key
    columns and every moved array once and writes every moved row once;
    K36 reads the sorted words once; K2 reads and writes the live rows)."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.parallel import exchange as X
    out = []

    def row(name, source, replaces, n_launches, fn, plain, err,
            bound_bytes, library, library_name, shape):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n_launches, max_abs_err=err, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    # K35's count pass at its largest call
    cols, nr, n, mode, hv = cap.calls[("exchange_count_cuda", "dist")][1]
    (dest, *_), counts = originals["exchange_count"](cols, nr, n, mode, hv)
    pdest, pcounts = X.exchange_count_plain(cols, nr, n, mode, hv)
    if not (same_bits(dest, pdest) and same_bits(counts, pcounts)):
        fail("K35 count pass differs from its twin at the path's inputs")
    cap_rows = dest.numel()
    live = int(nr)
    key_bytes = sum(c.element_size() + (0 if v is None else 1)
                    for c, v in cols)

    def yard_count():
        d = pdest
        order = torch.argsort(d, stable=True)
        return order, torch.bincount(d.clamp(min=0).to(torch.int64),
                                     minlength=n + 1)
    out.append(row(
        "exchange_count (K35 count pass, _partition_of + counts)",
        "trino_tpu_torch/csrc/exchange.cu",
        "trino_tpu/parallel/exchange.py:52", launches["exchange_count"],
        lambda: originals["exchange_count"](cols, nr, n, mode, hv),
        lambda: X.exchange_count_plain(cols, nr, n, mode, hv), 0.0,
        live * key_bytes + 4 * cap_rows, yard_count,
        "torch.argsort(dest, stable=True) + bincount",
        f"cap {cap_rows}, {live} live rows, {n} destinations, mode {mode}, "
        f"{len(cols)} key column(s)"))
    # K35's scatter at its largest call
    state, arrays, n2, bucket = cap.calls[("exchange_scatter_cuda",
                                           "dist")][1]
    got = originals["exchange_scatter"](state, arrays, n2, bucket)
    want = X.exchange_scatter_plain(state[0], arrays, n2, bucket)
    cnts = [int(((state[0] == d) | (state[0] == -1)).sum())
            for d in range(n2)]
    for a, b in zip(got, want):
        for d in range(n2):
            m = min(cnts[d], bucket)
            if not same_bits(a[d * bucket:d * bucket + m],
                             b[d * bucket:d * bucket + m]):
                fail("K35 scatter differs from its twin at the path's "
                     "inputs")
    moved = sum(min(c, bucket) for c in cnts)
    live_rows = int(state[2])
    row_b = sum(P.row_bytes(lk) for _, lk in arrays)
    src_b = sum(P.row_bytes(a) for a, _ in arrays if a is not None)
    src_arrays = [a for a, _ in arrays if a is not None]
    # the live destination words and source rows read once, every moved
    # row written once; beside it the bound that reads every dest word
    scatter_bound = 4 * live_rows + live_rows * src_b + moved * row_b
    cap_bound = 4 * state[0].numel() + live_rows * src_b + moved * row_b

    def yard_scatter():
        order = torch.argsort(state[0], stable=True)
        return [a.index_select(0, order) for a in src_arrays]
    out.append(row(
        "exchange_scatter (K35 bucket pack, all_to_all_by_key's scatter)",
        "trino_tpu_torch/csrc/exchange.cu",
        "trino_tpu/parallel/exchange.py:141", launches["exchange_scatter"],
        lambda: originals["exchange_scatter"](state, arrays, n2, bucket),
        lambda: X.exchange_scatter_plain(state[0], arrays, n2, bucket), 0.0,
        scatter_bound, yard_scatter,
        "torch.argsort(dest, stable=True) + index_select per array",
        f"cap {state[0].numel()}, {live_rows} live, {moved} rows moved, "
        f"{n2} x {bucket} slots, {len(arrays)} arrays, mode {state[3]}; "
        f"bound reading every dest word "
        f"{cap_bound / HBM_BYTES_PER_S * 1e3:.6f} ms"))
    one_enqueue("exchange_scatter at the path's largest call", lambda:
                originals["exchange_scatter"](state, arrays, n2, bucket),
                "scatter")
    # K36's local mode: the bound reads the live words once (the sentinel
    # tail is not read), beside the bound over every word
    words, k = cap.calls[("heavy_local_cuda", "dist")][1]
    c1, k1 = originals["heavy_local"](words, k)
    c2, k2 = X.heavy_local_plain(words, k)
    if not (same_bits(c1, c2) and same_bits(k1, k2)):
        fail("K36 local mode differs from its twin at the path's inputs")
    n_live = int((words != -1).sum())

    def yard_local():
        _, cnt = torch.unique_consecutive(words, return_counts=True)
        return torch.topk(cnt, min(k, cnt.numel()))
    fn = lambda: originals["heavy_local"](words, k)   # noqa: E731
    shape = (f"{words.numel()} sorted words, {n_live} live, k {k}; bound "
             f"over every word "
             f"{8 * words.numel() / HBM_BYTES_PER_S * 1e3:.6f} ms")
    out.append(row(
        "heavy_local (K36 local mode, detect_heavy_keys's run lengths and "
        "top_k)", "trino_tpu_torch/csrc/exchange.cu",
        "trino_tpu/parallel/exchange.py:70", launches["heavy_local"], fn,
        lambda: X.heavy_local_plain(words, k), 0.0,
        8 * n_live + 16 * k, yard_local,
        "torch.unique_consecutive(return_counts) + topk", shape))
    # after the row's own profile: a first short window can come back empty
    say_split("heavy_local (K36 local mode)", shape, fn, card)
    # K10's u64 sort at its largest call (detect_heavy_keys's masked key
    # words of a D4 sf10 shard): the words read once, the sorted words
    # written once
    from trino_tpu_torch.ops import sort as S
    (words,) = cap.calls[("sort_u64_cuda", "dist")][1]
    lo = -(1 << 63)
    if not same_bits(originals["sort_u64"](words),
                     torch.sort(words ^ lo, stable=True).values ^ lo):
        fail("K10's u64 sort differs from torch.sort at the path's inputs")
    flipped = words ^ lo
    passes = [(0, 8 * b) for b in range(8)]
    ran = sum(S.informative_passes_plain([flipped], words.numel(), passes))
    fn = lambda: originals["sort_u64"](words)   # noqa: E731
    say(f"[kernel] sort_u64 (K10) at the distributed path's largest call: "
        f"top device time per call: " + ", ".join(
            f"{k_[:48]} {t:.4f} ms" for k_, t in device_profile(fn)[1])
        + f" — {card}")
    out.append(row(
        "sort_u64 (K10's u64 sort: detect_heavy_keys, rank_bounds)",
        "trino_tpu_torch/csrc/sort.cu", "trino_tpu/parallel/exchange.py:87",
        launches["sort_u64"], fn,
        lambda: torch.sort(words ^ lo, stable=True).values ^ lo, 0.0,
        16 * words.numel(), lambda: torch.sort(flipped, stable=True),
        "torch.sort(stable=True) of the flipped words",
        f"{words.numel()} u64 words, 8 digit passes of which {ran} ran and "
        f"{8 - ran} were trivial"))
    keys, cnts_m, k3, thr = cap.calls[("heavy_merge_cuda", "dist")][1]
    h1 = originals["heavy_merge"](keys, cnts_m, k3, thr)
    h2 = X.heavy_merge_plain(keys, cnts_m, k3, thr)
    if not same_bits(h1, h2):
        fail("K36 merge mode differs from its twin at the path's inputs")

    def yard_merge():
        u, inv = torch.unique(keys, return_inverse=True)
        glob = torch.zeros(u.numel(), dtype=torch.int64, device=dev)
        glob.index_add_(0, inv, cnts_m.to(torch.int64))
        return torch.topk(glob, min(k3, glob.numel()))
    out.append(row(
        "heavy_merge (K36 merge mode, detect_heavy_keys's global sums and "
        "top_k)", "trino_tpu_torch/csrc/exchange.cu",
        "trino_tpu/parallel/exchange.py:95", launches["heavy_merge"],
        lambda: originals["heavy_merge"](keys, cnts_m, k3, thr),
        lambda: X.heavy_merge_plain(keys, cnts_m, k3, thr), 0.0,
        16 * keys.numel() + 8 * k3, yard_merge,
        "torch.unique(return_inverse) + index_add_ + topk",
        f"{keys.numel()} candidates, k {k3}, threshold {thr}"))
    # K2 as the receive: its largest call of the distributed path
    arrays2, counts2, out_cap = cap.calls[("concat_rows_cuda:receive",
                                           "dist")][1]
    a = originals["concat_rows"](arrays2, counts2, out_cap)
    b = P.concat_rows_plain(arrays2, counts2, out_cap)
    total = int(sum(int(c) for c in counts2))
    for x, y in zip(a[0], b[0]):
        if not same_bits(x[:total], y[:total]):
            fail("K2 (the receive) differs from its twin at the path's "
                 "inputs")
    rb = sum(P.row_bytes(o) for o in a[0])
    firsts = [[t[:int(c)] for t in pa if t is not None]
              for pa, c in zip(arrays2, counts2)]
    out.append(row(
        "concat_rows (K2 as the exchange receive, _exchange_compact / "
        "broadcast_page)", "trino_tpu_torch/csrc/concat.cu",
        "trino_tpu/parallel/exchange.py:113", launches["exchange_receive"],
        lambda: originals["concat_rows"](arrays2, counts2, out_cap),
        lambda: P.concat_rows_plain(arrays2, counts2, out_cap), 0.0,
        2 * total * rb,
        lambda: [torch.cat([f[i] for f in firsts]) for i in
                 range(len(firsts[0]))] if firsts and firsts[0] else None,
        "torch.cat of the sources' live slices per array",
        f"{len(arrays2)} source slices, {total} rows into cap {out_cap}, "
        f"{len(a[0])} arrays"))
    for r in out:
        say(f"[kernel] {r['name']}: {r['ms']:.4f} ms per call, bound "
            f"{r['bound_ms']:.6f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, {r['shape']} — {card}")
    return out


def dist_walls(dist, card) -> None:
    """Each D query's warm wall (one warm run after the first) and device
    busy time and idle share (profiler, one run)."""
    for name, (schema, session, sql, _) in DIST_QUERIES.items():
        runner = dist[schema]

        def run():
            return _with_session(runner, session,
                                 lambda: runner.execute(sql))
        t0 = time.perf_counter()
        run()
        sync()
        w = time.perf_counter() - t0
        busy, top = device_profile(run, 1)
        idle = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / (w * 1e3)):.2f}"
        say(f"[wall] {name} {schema}: warm {w * 1e3:.1f} ms over "
            f"{DIST_SHARDS} shards; device busy "
            f"{'not measured' if busy is None else f'{busy:.2f} ms'}, idle "
            f"share {idle}; top device time: "
            + ", ".join(f"{k[:50]} {t:.3f} ms" for k, t in top[:6])
            + f" — {card}")


def kernel_rows_list(cap: Capture, originals, launches, dev, card):
    """K32-K34 and K11's list steps at their largest call of the list
    path, each against its twin at those inputs. Bounds count live rows,
    each distinct array read once and each output written once."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.ops import lists as LS
    out = []

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n_launches, max_abs_err=0.0, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    def equal(label, got, want, n=None):
        for x, y in zip(got, want):
            if (x is None) != (y is None) or (x is not None and not same_bits(
                    x if n is None else x[:n], y if n is None else y[:n])):
                fail(f"{label} differs from its twin at the list path's "
                     f"inputs")

    # K32: K7's plane mode at its largest list-path call (UNNEST's
    # replication, whose indices are its live slots alone)
    arrays, idx = cap.calls[("gather_rows_cuda:plane", "list")][1]
    equal("K32 (K7 plane mode)", originals["gather_rows"](arrays, idx),
          P.gather_rows_plain(arrays, idx))
    n = idx.numel()
    plane = max(arrays, key=lambda a: a.dim())
    out.append(row(
        "gather_rows plane mode (K32, in K7)",
        "trino_tpu_torch/csrc/gather.cu", "trino_tpu/page.py:324",
        launches["list_planes"],
        lambda: originals["gather_rows"](arrays, idx),
        lambda: P.gather_rows_plain(arrays, idx),
        # the index read, each array's gathered rows read and written
        8 * n + 2 * n * sum(P.row_bytes(a) for a in arrays),
        lambda: plane.index_select(0, idx.clamp(0, plane.shape[0] - 1)),
        "index_select of the plane's rows",
        f"{n} rows gathered from cap {plane.shape[0]}, {len(arrays)} "
        f"arrays, plane {tuple(plane.shape)} {plane.dtype}"))

    # K33's three modes
    gid, nr, ng = cap.calls[("collect_sizes_cuda", "list")][1]
    equal("K33 size mode", [originals["collect_sizes"](gid, nr, ng)],
          [LS.collect_sizes_plain(gid, nr, ng)])
    n, G = int(nr), int(ng)
    live = gid[:n].to(torch.int64)
    out.append(row(
        "collect_sizes (K33 size mode)", "trino_tpu_torch/csrc/list.cu",
        "trino_tpu/ops/aggregate.py:957", launches["collect_sizes"],
        lambda: originals["collect_sizes"](gid, nr, ng),
        lambda: LS.collect_sizes_plain(gid, nr, ng),
        4 * n + 4 * G + 16, lambda: torch.bincount(live, minlength=G),
        "torch.bincount of the group ids",
        f"cap {gid.numel()}, {n} live rows, {G} groups"))
    args = cap.calls[("collect_array_cuda", "list")][1]
    x, masks, nr, gid, ng, L, rows_ = args
    equal("K33 array mode", originals["collect_array"](*args),
          LS.collect_array_plain(*args))
    n, G = int(nr), int(ng)
    xs = x[:n]
    gsrt = gid[:n].to(torch.int64)
    flat = torch.zeros(rows_ * L, dtype=x.dtype, device=dev)
    slot = (gsrt * L).clamp(max=rows_ * L - 1)
    out.append(row(
        "collect_array (K33 array mode, with K10's radix passes)",
        "trino_tpu_torch/csrc/list.cu", "trino_tpu/ops/aggregate.py:976",
        launches["collect_array"],
        lambda: originals["collect_array"](*args),
        lambda: LS.collect_array_plain(*args),
        # the argument, masks and group ids read, the lists written
        n * (x.element_size() + len(masks) + 4) + G * (L * x.element_size()
                                                       + 4),
        lambda: flat.index_put_((slot[torch.sort(gsrt, stable=True)
                                      .indices],), xs),
        "torch.sort(stable=True) of the group ids plus one index_put_",
        f"cap {x.numel()}, {n} live rows, {x.dtype}, {G} groups, L {L}, "
        f"{rows_} list rows, {len(LS._array_passes(rows_))} K10 "
        f"passes"))
    # K33's map mode at its largest call (L3's direct route) and at its
    # largest call the host sends to the sort route (L4)
    for key, what in ((("collect_map_cuda", "list"), "largest call"),
                      (("collect_map_cuda:sort", "list"),
                       "largest sort-route call")):
        if key not in cap.calls:
            say(f"[kernel] collect_map: no {what} on the list path")
            continue
        args = cap.calls[key][1]
        x, x2, masks, nr, gid, ng, L, rows_, span = (*args, None)[:9]
        equal("K33 map mode", originals["collect_map"](*args),
              LS.collect_map_plain(*args[:8]))
        n, G = int(nr), int(ng)
        plan = LS.map_plan(x, rows_, span)
        if plan.route == LS.ROUTE_DIRECT:
            one_enqueue(f"collect_map at the list path's {what}",
                        lambda a=args: originals["collect_map"](*a), "map")
        sorted_key = (gid[:n].to(torch.int64) << 32) + x[:n].to(torch.int64)
        vsz = 8 if x2 is None else x2.element_size()
        kflat = torch.zeros(rows_ * L, dtype=x.dtype, device=dev)
        kslot = (gid[:n].to(torch.int64) * L).clamp(max=rows_ * L - 1)
        route = {LS.ROUTE_DIRECT: "the direct-address route",
                 LS.ROUTE_AUTO: "the route chosen on the card",
                 LS.ROUTE_SORT: "the sort route"}[plan.route]
        out.append(row(
            f"collect_map (K33 map mode, {what}: {route})",
            "trino_tpu_torch/csrc/list.cu",
            "trino_tpu/ops/aggregate.py:1020",
            launches["collect_map"],
            lambda a=args: originals["collect_map"](*a),
            lambda a=args: LS.collect_map_plain(*a[:8]),
            n * (x.element_size() + (0 if x2 is None else vsz)
                 + len(masks) + 4) + G * (L * (x.element_size() + vsz) + 4),
            lambda k=sorted_key, f=kflat, sl=kslot, xs=x[:n]: f.index_put_(
                (sl[torch.sort(k, stable=True).indices],), xs),
            "torch.sort(stable=True) of (group, key) plus one index_put_",
            f"cap {x.numel()}, {n} live rows, key {x.dtype}, "
            f"{'histogram' if x2 is None else 'map_agg'}, {G} groups, L "
            f"{L}, {rows_} list rows, span bound {span}, "
            f"{len(plan.passes)} K10 passes launched"))

    # K34: the count and the expansion at their largest calls
    lens, valid, nr = cap.calls[("unnest_count_cuda", "list")][1]
    equal("K34 count", [originals["unnest_count"](lens, valid, nr)],
          [LS.unnest_count_plain(lens, valid, nr)])
    n = int(nr)
    out.append(row(
        "unnest_count (K34 count)", "trino_tpu_torch/csrc/list.cu",
        "trino_tpu/exec/local_planner.py:3164", launches["unnest_count"],
        lambda: originals["unnest_count"](lens, valid, nr),
        lambda: LS.unnest_count_plain(lens, valid, nr),
        n * (4 + (0 if valid is None else 1)) + 4,
        lambda: lens[:n].sum(), "one sum of the lengths",
        f"cap {lens.numel()}, {n} live rows"))
    args = cap.calls[("unnest_expand_cuda", "list")][1]
    lens, valid, nr, plane, aux, out_cap, with_ord = args
    got = originals["unnest_expand"](*args)
    want = LS.unnest_expand_plain(*args)
    total = int(want[4])
    equal("K34 expand", got[:4], want[:4], total)
    n = int(nr)
    esz = plane.element_size() + (0 if aux is None else aux.element_size())
    ids = torch.arange(lens.numel(), device=dev)
    lens64 = lens.to(torch.int64)
    out.append(row(
        "unnest_expand (K34 expand)", "trino_tpu_torch/csrc/list.cu",
        "trino_tpu/exec/local_planner.py:3174", launches["unnest_expand"],
        lambda: originals["unnest_expand"](*args),
        lambda: LS.unnest_expand_plain(*args),
        # lengths read, the live elements read, each slot's row, ordinal
        # and element written
        n * (4 + (0 if valid is None else 1)) + total * esz
        + total * (4 + (8 if with_ord else 0) + esz),
        lambda: plane.index_select(0, torch.repeat_interleave(ids, lens64)),
        "repeat_interleave of the row ids plus one index_select",
        f"cap {lens.numel()}, {n} live rows, plane "
        f"{tuple(plane.shape)} {plane.dtype}, {total:,} slots"))

    # K11's list steps: the largest step of the list path whose tree
    # holds a list call
    step, page, params = cap.calls[("expr_step_cuda:list", "list")][1]
    got = originals["expr_step"](step, page, params)
    n = int(page.num_rows)
    prog = step.compiled(page, params).prog
    ins = P.Page(tuple(page.columns[i] for i in prog.inputs), page.num_rows)
    in_bytes = sum(P.row_bytes(a) for c in ins.columns
                   for a in P._movable(c)) * n
    outs = got if isinstance(got, tuple) else (got,)
    out_bytes = 0
    for c in outs:
        if isinstance(c, P.Column):
            out_bytes += sum(P.row_bytes(a) for a in P._movable(c)) * n
        else:
            out_bytes += n
    out.append(row(
        "expr_step list operations (K11, Triton)",
        "trino_tpu_torch/expr/kernel_gen.py",
        "trino_tpu/expr/compiler.py:617", launches["expr_step"],
        lambda: originals["expr_step"](step, page, params),
        lambda: step.plain(page, params), in_bytes + out_bytes, None,
        "none: no single PyTorch call",
        f"{step.mode} step of {len(step.exprs)} expressions, cap "
        f"{page.capacity}, {n} live rows"))
    return out


# ------------------------------------------------------------- phase 3/4


class Capture:
    """Keep a kernel wrapper's largest call of each query the timing rows
    read (q6, q1 and q3 at sf1), its largest call of all sf1 queries and
    of the forced-threshold runs (label ("forced", run)), so phase 4
    times each kernel at the shapes its path gave it."""

    TIMED = (("sf1", "q6"), ("sf1", "q1"), ("sf1", "q3"))

    def __init__(self):
        self.label = None
        self.calls = {}
        self.orig = {}

    def wrap(self, module, name, size_of, tag_of=None,
             scopes=("sf1", "forced")):
        """Replace module.name with a recording pass-through. The kernel
        function increments `<module>.<name>.launches` (and K9's
        `.by_kind`, K6's and K9's `.by_route`) through its module global,
        so the counters now live on the pass-through. `tag_of` names a
        mode whose largest sf1 call is kept apart (K13: the mxu route);
        `scopes` the run scopes whose largest call (and tagged call) is
        kept ("ds": the TPC-DS and G1-G4 runs, for K24-K27 and K13)."""
        orig = getattr(module, name)

        def record(key, size, args):
            if key not in self.calls or size > self.calls[key][0]:
                self.calls[key] = (size, args)

        def wrapped(*args):
            if self.label is not None:
                size = size_of(*args)
                if self.label in self.TIMED:
                    record((name, self.label), size, args)
                scope = self.label[0]    # sf1, sf10, forced or ds
                if scope in scopes:
                    record((name, scope), size, args)
                    tag = tag_of(*args) if tag_of else None
                    if tag:
                        record((f"{name}:{tag}", scope), size, args)
            return orig(*args)
        wrapped.launches = 0
        for counter in ("by_kind", "by_route", "by_mode"):
            if hasattr(orig, counter):
                setattr(wrapped, counter, {})
        if hasattr(orig, "plane_launches"):
            wrapped.plane_launches = 0
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


def reset_counts(kernels) -> None:
    """Every listed kernel's launch counters to 0 (a path's start)."""
    for mod, attr in kernels.values():
        fn = getattr(mod, attr)
        fn.launches = 0
        for counter in ("by_kind", "by_route", "by_mode"):
            if hasattr(fn, counter):
                setattr(fn, counter, {})


def join_line(q, schema, i, j) -> str:
    line = (f"[join] {q} {schema} join {i + 1}: {j['kind']}, route "
            f"{j['route']}, build {j['build_rows']} live rows, max_run "
            f"{j['max_run']}, probe {j['probe_rows']} rows, output "
            f"{j['output_rows']} rows")
    if "build_bytes" in j:
        line += (f"; build {j['build_bytes']} bytes, device holds "
                 f"{j['device_bytes']} bytes, host holds {j['host_bytes']}"
                 f" bytes")
    if "depth" in j:
        line += f", recursion depth {j['depth']}"
    return line


SPILL_COUNTERS = ("spilled_bytes", "agg_recursions", "join_recursions",
                  "heavy_key_splits", "spill_fallbacks",
                  "agg_mode_downgrades", "agg_mode_upgrades")


def spill_counters(runner) -> dict:
    return {k: runner.last_query_stats[k] for k in SPILL_COUNTERS}


def rows_same_multiset(a, b, nkeys: int) -> bool:
    """Rows equal as multisets, sorted by their first `nkeys` columns
    (integer keys, no NULLs), the rest compared as rows_equal does: for
    the million-row results of the forced runs."""
    if len(a) != len(b):
        return False
    return rows_equal(sorted(a, key=lambda r: r[:nkeys]),
                      sorted(b, key=lambda r: r[:nkeys]))


# The forced-threshold runs at sf1 (the spill path): each SQL under
# lowered thresholds against the card's own run of it under the default
# session. label -> (SQL, session properties, what it puts on the card,
# how its rows compare: "order", "multiset" or the key count to sort by)
SELF_JOIN_SQL = ("SELECT count(*), sum(l2.l_extendedprice) FROM lineitem l1 "
                 "JOIN lineitem l2 ON l1.l_orderkey = l2.l_orderkey")
GROUPS_SQL = ("SELECT l_orderkey, l_linenumber, sum(l_extendedprice) AS s, "
              "checksum(l_partkey) AS c "
              "FROM lineitem GROUP BY l_orderkey, l_linenumber")
SORT_SPILL_SQL = ("SELECT l_orderkey, l_partkey, l_shipdate, l_comment "
                  "FROM lineitem ORDER BY l_shipdate DESC, l_orderkey, "
                  "l_linenumber")
COMPOSITE_SQL = ("SELECT count(*), sum(l.l_linenumber), sum(o.o_totalprice) "
                 "FROM (SELECT l_orderkey, l_linenumber, l_orderkey % 1000 "
                 "AS k2 FROM lineitem) l JOIN (SELECT o_orderkey, "
                 "o_totalprice, o_orderkey % 1000 AS k2 FROM orders) o ON "
                 "l.l_orderkey = o.o_orderkey AND l.k2 = o.k2")
FORCED = {
    "a": (TPCH["q3"][0], {"join_spill_threshold_bytes": 1 << 20},
          "q3, its builds past 1 MiB: spill-dense (K16, K5 dense mode over "
          "K16's keys, K17 dense mode)", "multiset"),
    "b": (TPCH["q9"][0], {"join_spill_threshold_bytes": 1 << 20},
          "q9, its builds past 1 MiB (the composite partsupp build)",
          "multiset"),
    "b2": (COMPOSITE_SQL, {"join_spill_threshold_bytes": 1 << 20},
           "a composite unique build past 1 MiB: spill-search (K17 search "
           "mode) and the host attach", "multiset"),
    "c": (SELF_JOIN_SQL, {"join_spill_threshold_bytes": 4 << 20},
          "the lineitem self-join past 4 MiB: partitioned (K18 hash mode) "
          "with recursion", "multiset"),
    "d": (GROUPS_SQL, {"agg_spill_threshold_bytes": 32 << 20,
                       "scan_page_capacity": 1 << 20},
          "GROUP BY l_orderkey, l_linenumber past 32 MiB: the downgrade to "
          "bypass (K19) and the aggregation spill", 2),
    "e": (SORT_SPILL_SQL, {"sort_spill_threshold_bytes": 64 << 20},
          "ORDER BY past 64 MiB: range partitions (K18 rank and range "
          "modes, K10 under rank_bounds)", "order"),
}


def forced_runs(runner, cap, spill_kernels, card):
    """The spill path: every FORCED SQL on the card under the default
    session, then (counts set to 0 before, read after) under its lowered
    thresholds; rows equal, routes and spill counters printed. Returns
    (launches, by_mode, routes) of the forced runs."""
    default = {}
    for label, (sql, _, _, _) in FORCED.items():
        t0 = time.perf_counter()
        default[label] = runner.execute(sql).rows
        sync()
        say(f"[forced] {label} default session: {len(default[label])} "
            f"rows in {time.perf_counter() - t0:.2f} s")
    reset_counts(spill_kernels)
    routes = set()
    for label, (sql, props, what, compare) in FORCED.items():
        cap.label = ("forced", label)
        for k, v in props.items():
            runner.session.set(k, v)
        t0 = time.perf_counter()
        got = runner.execute(sql).rows
        sync()
        secs = time.perf_counter() - t0
        for k in props:
            runner.session.properties.pop(k, None)
        want = default[label]
        if compare == "order":
            same = got == want
        elif compare == "multiset":
            same = rows_equal(got, want)
        else:
            same = rows_same_multiset(got, want, compare)
        if not same:
            fail(f"forced run {label} ({what}): rows differ from the "
                 f"default session's:\n{got[:3]}\n{want[:3]}")
        for i, j in enumerate(runner.last_joins):
            routes.add(j["route"])
            say(join_line(f"forced-{label}", "sf1", i, j))
        say(f"[forced] {label}: {what}: {len(got)} rows equal to the "
            f"default session's ({'in order' if compare == 'order' else 'as a multiset'}) "
            f"in {secs:.2f} s; {props}; spill counters "
            f"{spill_counters(runner)} — {card}")
    cap.label = None
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in spill_kernels.items()}
    by_mode = {k: dict(getattr(mod, attr).by_mode)
               for k, (mod, attr) in spill_kernels.items()
               if hasattr(getattr(mod, attr), "by_mode")}
    return launches, by_mode, routes


def mxu_of(runner):
    """(joins on the mxu route, mxu_joins) of a runner's last query."""
    return (sum(j["route"] == "mxu" for j in runner.last_joins),
            runner.last_query_stats["mxu_joins"])


def ds_counters(runner) -> dict:
    """A runner's last query: its join routes in order, mxu_joins and
    mxu_flops."""
    return {"routes": [j["route"] for j in runner.last_joins],
            "mxu_joins": runner.last_query_stats["mxu_joins"],
            "mxu_flops": runner.last_query_stats["mxu_flops"]}


def cold_walls(runner1, card) -> None:
    """First-run (cold) walls of q6 and q9 at sf1 on the card: tables
    generated by K14/K15 against the NumPy path (host generation and
    pinned staging), each run with nothing staged or generated before
    (sf1 keeps the NumPy path's runs to seconds; gen_times gives each sf10
    table's generation seconds on both paths)."""
    from trino_tpu_torch.connector import tpch, tpch_dev as TD
    from trino_tpu_torch.exec import LocalQueryRunner
    numpy_runner = LocalQueryRunner.tpch("sf1", device_gen=False)
    for q in ("q6", "q9"):
        for label, runner in (("device generation", runner1),
                              ("NumPy path", numpy_runner)):
            tpch.drop_cached_columns(host_chunks=True)
            TD.drop_order_index()
            sync()
            t0 = time.perf_counter()
            runner.execute(TPCH[q][0])
            sync()
            say(f"[cold] {q} sf1 first run with {label}: "
                f"{time.perf_counter() - t0:.2f} s — {card}")
    tpch.drop_cached_columns(host_chunks=True)


def gen_times(dev, card) -> None:
    """Per table at sf1 and sf10: seconds to generate and stage every
    supported column of every scan page on the card (K14/K15) and through
    the NumPy path (host generation, padding, pinned copy), nothing of the
    table cached before either (cold_walls emptied the host cache). The
    NumPy chunks stay in the host cache for the CPU runs that follow."""
    from trino_tpu_torch.connector import tpch, tpch_dev as TD
    from trino_tpu_torch import types as T
    for schema in ("sf1", "sf10"):
        sf = tpch.SCHEMAS[schema]
        for table in ("supplier", "customer", "part", "partsupp", "orders",
                      "lineitem"):
            rows = tpch.table_row_count(table, sf)
            cap = min(1 << max(rows - 1, 1).bit_length(), 1 << 22)
            cols = [(n, t) for n, t in tpch.TABLES[table][0]
                    if TD.supported(table, n)]
            secs = {}
            for path in ("device", "numpy"):
                tpch.drop_cached_columns()
                TD.drop_order_index()
                sync()
                t0 = time.perf_counter()
                for off in range(0, rows, cap):
                    hi = min(off + cap, rows)
                    for name, typ in cols:
                        if path == "device":
                            TD.generate(table, sf, name, off, hi, cap,
                                        torch.int32 if T.is_string(typ)
                                        else typ.dtype, dev)
                        else:
                            tpch._staged_column(table, sf, name, typ, off,
                                                hi, cap, dev, False)
                sync()
                secs[path] = time.perf_counter() - t0
            say(f"[gen] {table} {schema} ({rows} rows, {len(cols)} "
                f"columns): K14/K15 {secs['device']:.3f} s, NumPy path "
                f"{secs['numpy']:.3f} s — {card}")
        tpch.drop_cached_columns()


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
    card_name = torch.cuda.get_device_name(0)
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
    errs = {"compact_rows": check_compact(g, dev),
            "concat_rows": check_concat(g, dev),
            "direct_aggregate": check_direct(g, dev),
            "global_aggregate": check_global(g, dev)}
    say(f"[kernels] K1-K4 match their plain twins on the card "
        f"(integers exact, float64 sums <= 1e-9 rel; K2 in one launch over "
        f"{len(CONCAT_CASES)} layouts: {', '.join(CONCAT_CASES)}; K4 in one "
        f"launch for 1 to 17 states, NaN, +-0.0, +-inf, no row and every "
        f"row live, caps off the grid's stride, float sums equal bit for "
        f"bit over two calls): {errs} in {time.perf_counter() - t0:.1f} s")
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
    errs = {"mxu_table + the mxu modes of unique_probe, expand_count and "
            "probe_verdict": check_mxu(g, dev)}
    say(f"[kernels] K12 and K13 (K6's and K9's mxu modes, every kind) match "
        f"their plain twins on the card (all exact; table sizes 128 and "
        f"4096; keys in span, past it and below kmin): {errs} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"agg_table + agg_lookup + key_bounds + agg_post":
            check_agg_join(g, dev),
            "key_bounds over every key type": check_key_bounds(g, dev)}
    say(f"[kernels] K24 (both modes), K25, K26 and K27 match their plain "
        f"twins on the card (K26's words over {len(BOUNDS_TYPES)} key "
        f"types x {len(BOUNDS_CASES)} live-row counts x 3 validities and "
        f"the fused cases, K24's "
        f"counts, integer sums, distinct slots, live rows and mag_ok, K25's "
        f"outputs and live mask, K27's masks exactly; float64 sums <= 1e-9 "
        f"rel; {len(AGG_CASES)} cases: 128 to 65,536 slots, 8 and 256 keys "
        f"under 1.5M build rows, NULL and dead rows, negative and double "
        f"keys, sums past 2^53, an all-NULL column, an empty build, a dead "
        f"probe): {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"gen_column + order_index": check_gen(dev)}
    say(f"[kernels] K14 and K15 match their plain twins and the NumPy "
        f"chunks bit for bit: {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"sort_encode + sort_radix": check_sort(dev)}
    say(f"[kernels] K10 matches its plain twin on the card (words bit for "
        f"bit, permutations exactly; {len(sort_sizes())} pages x "
        f"{len(SORT_KEYSETS)} key sets: both sides of the one-block "
        f"threshold by capacity and by live rows, a capacity off the "
        f"tile, no live row, equal rows, 4,194,304 and 16,777,216 rows; "
        f"the u64 sort at {U64_SIZES} words, random and duplicate-heavy, "
        f"equal to torch.sort): {errs} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"spill_prep + join_dense (payload) + spill_probe":
                check_spill_join(g, dev),
            "partition_rows + rank_rows + rank_bounds":
                check_spill_part(g, dev),
            "passthrough": check_bypass(g, dev)}
    say(f"[kernels] K16, K5's dense mode over K16's keys, K17 (dense and "
        f"search modes), K18 (hash mode at salts 0-3 and 1/4/16 "
        f"partitions, rank and range modes, NULLs first and last both "
        f"ways) and K19 (Triton, first call compiles) match their plain "
        f"twins on the card (ids, counts, permutations, positions and "
        f"moved columns bit for bit): {errs} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"window_bounds + rank_value + frame_aggregate + bounded_minmax":
            check_window(g, dev)}
    say(f"[kernels] K20-K23 match their plain twins on the card (K20's "
        f"arrays bit for bit on every row; K21-K23 on the live rows: "
        f"validity, integers, decimals and codes exact, doubles <= 1e-9 of "
        f"the partition's |x| sum; pages: {', '.join(WIN_PAGES)}; every "
        f"function under whole, running ROWS and RANGE and bounded frames "
        f"to +-5000 rows; K21's Triton programs compiled on first call): "
        f"{errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"expr_step": check_expr(dev)}
    say(f"[kernels] K11 matches the plain compiler on the card over "
        f"{len(expr_corpus(corpus_page('cpu')[1]))} corpus expressions "
        f"(integers, codes and masks exact, doubles <= 1e-9 rel, NaN and "
        f"-0.0 kept; compiles included): {errs} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"group_ids + special_hash + special_centered + "
            "special_positional + special_hll + special_percentile":
            check_special(g, dev)}
    say(f"[kernels] K28 (K8's group-id mode), K29 (both modes), K30 "
        f"(centered, positional and HLL modes) and K31 match their plain "
        f"twins on the card (K28's row -> group map, K29's hashes, K30's "
        f"estimates and picks and K31's picks exactly; K30's centered "
        f"doubles <= 1e-9 rel or 1e-9 of the column's largest magnitude; "
        f"{len(SPECIAL_CASES)} cases: an empty page, one row, one group, "
        f"3 and 3,000 groups, a global page, 2^20 groups over 4,194,304 "
        f"rows; NULLs, NaN, +-0.0, +-inf, ties, a FILTER, negative narrow "
        f"integers): {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"gather/compact/concat plane modes + collect_sizes + "
            "collect_array + collect_map + unnest_count + unnest_expand":
            check_list(g, dev)}
    say(f"[kernels] K32 (K1, K7 and K2 moving planes of L "
        f"{', '.join(map(str, LIST_PLANE_LS))}; K2 padding a narrower "
        f"page), K33 (size, array and map modes) and K34 (count, expand) "
        f"match their plain twins on the card bit for bit ({len(LIST_CASES)}"
        f" K33 cases: an empty page, 3 to 1,500,000 groups, 4,194,304 rows; "
        f"NULL inputs, NaN, +-0.0, +-inf, duplicate keys, int32/int64/"
        f"float32/float64 keys): {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = {"exchange_count + exchange_scatter + heavy_local + heavy_merge":
            check_exchange(g, dev)}
    say(f"[kernels] K35 (count and scatter in hash, spread and replicate "
        f"modes) and K36 (local and merge modes) match their plain twins on "
        f"the card bit for bit ({check_exchange.cases} cases: n = "
        f"{', '.join(map(str, EXCHANGE_NS))}; NULL, dead, -1, NaN, -0.0, "
        f"bool, code and composite keys; an empty shard, one destination "
        f"past its bucket, heavy sets of 0, 1 and 8 keys, ties, one "
        f"4,194,304-row page; whole exchanges of 8 shards on the card "
        f"against 8 on the CPU): {errs} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_heavy = check_heavy(g, dev)
    say(f"[kernels] K36's local mode matches heavy_local_plain bit for bit "
        f"in one launch a call ({n_heavy} calls: "
        f"{'; '.join(label for label, _, _ in HEAVY_CASES)}; k "
        f"{', '.join(map(str, HEAVY_KS))}; two calls in a row equal) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_post = check_post(g, dev)
    say(f"[kernels] K27 matches agg_post_plain on the live rows in one "
        f"launch a call ({n_post} calls: {', '.join(map(str, POST_HELPERS))}"
        f" helpers at num_rows 0, {POST_CAP // 3} and {POST_CAP} of "
        f"{POST_CAP}; no launch without a helper) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_scatter = check_scatter(g, dev)
    say(f"[kernels] K35's scatter matches exchange_scatter_plain bit for bit "
        f"over every occupied slot of every array in one launch a call "
        f"({n_scatter} calls: "
        f"{'; '.join(label for label, *_ in SCATTER_CASES)}; rows of 1, 2, "
        f"4, 8, 12 and 16 bytes, an absent validity) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_lookup = check_lookup(g, dev)
    say(f"[kernels] K25 matches agg_lookup_plain bit for bit on the live "
        f"rows (outputs and mask; the padding is unwritten) in one launch a "
        f"call ({n_lookup} calls: "
        f"{'; '.join(label for label, *_ in LOOKUP_CASES)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[time] phase 2 (kernels vs twins): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- phase 3: queries from SQL on cuda vs the port on the CPU
    t_phase = time.perf_counter()
    from trino_tpu_torch import page as P
    from trino_tpu_torch.exec import LocalQueryRunner
    from trino_tpu_torch.expr import compiler as EC
    from trino_tpu_torch.expr import kernel_gen as KG
    from trino_tpu_torch.connector import tpch, tpch_dev as TD
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import join_mxu as JM
    from trino_tpu_torch.ops import sort as S
    from trino_tpu_torch.ops import lists as LS
    from trino_tpu_torch.expr import ir as EI
    cap = Capture()

    def mxu_tag(pc, bc, nr, prep, *_):
        return "mxu" if prep.mxu is not None else None
    cap.wrap(P, "compact_rows_cuda", lambda arrays, mask, n: mask.numel())
    def receive_tag(*_):
        # K2 called by the exchange receive or a broadcast
        f = sys._getframe(2)
        for _ in range(4):
            if f is None:
                break
            if f.f_code.co_name in ("exchange_apply", "broadcast_page"):
                receive_launches[0] += cap.label is not None \
                    and cap.label[0] == "dist"
                return "receive"
            f = f.f_back
        return None
    receive_launches = [0]
    cap.wrap(P, "concat_rows_cuda", lambda arrays, counts, c: c,
             receive_tag, ("sf1", "forced", "dist"))
    cap.wrap(A, "direct_reduce_cuda",
             lambda keys, states, n, nseg: keys[0].codes.numel())
    cap.wrap(A, "global_reduce_cuda", lambda states, n, c: c)
    cap.wrap(P, "compact_range_cuda", lambda arrays, key, *_: key.numel())
    def plane_tag(arrays, *_):
        return "plane" if any(a is not None and a.dim() == 2
                              for a in arrays) else None
    cap.wrap(P, "gather_rows_cuda",
             lambda arrays, idx: idx.numel() if arrays else -1, plane_tag,
             ("sf1", "forced", "list"))
    cap.wrap(J, "join_build_cuda", lambda cols, n: cols[0][0].numel())
    cap.wrap(J, "join_dense_cuda", lambda cols, n, st, size, *_: size)
    # K13's modes keep their largest TPC-DS call too: K9's mxu mode may
    # run there alone (q72's router variant)
    k13_scopes = ("sf1", "forced", "ds")
    # K6's largest call of each route is kept apart (phase 4 times them)
    cap.wrap(J, "unique_probe_cuda", lambda pc, bc, *_: pc[0][0].numel(),
             lambda pc, bc, nr, prep: J.route_of(prep), k13_scopes)
    cap.wrap(A, "group_reduce_cuda", lambda keys, states, n, c: c)
    # K28-K31: their largest call of the special-aggregate path
    sp = ("special",)
    cap.wrap(A, "group_ids_cuda", lambda keys, states, n, c: c, scopes=sp)
    cap.wrap(A, "checksum_contrib_cuda", lambda v, m: v.numel(), scopes=sp)
    cap.wrap(A, "hll_pairs_cuda", lambda v, *_: v.numel(), scopes=sp)
    cap.wrap(A, "centered_cuda", lambda kind, a, ad, b, *_: a.numel()
             * (1 if b is None else 2), scopes=sp)
    cap.wrap(A, "positional_cuda", lambda kind, x, *_: x.numel(), scopes=sp)
    cap.wrap(A, "hll_fold_cuda", lambda pairs, *_: pairs.numel(), scopes=sp)
    cap.wrap(A, "percentile_cuda", lambda x, *_: x.numel(), scopes=sp)
    cap.wrap(J, "join_runs_cuda", lambda cols, *_: cols[0][0].numel())
    cap.wrap(J, "expand_count_cuda", lambda pc, *_: pc[0][0].numel(),
             mxu_tag, k13_scopes)
    cap.wrap(J, "expand_write_cuda", lambda pc, bc, c, kind, oc, *_: oc)
    cap.wrap(J, "probe_verdict_cuda", lambda pc, *_: pc[0][0].numel(),
             mxu_tag, k13_scopes)
    cap.wrap(JM, "mxu_table_cuda", lambda cols, *_: cols[0][0].numel())
    cap.wrap(TD, "gen_column_cuda", lambda recipe, start, n, c, *_: n)
    cap.wrap(TD, "order_index_cuda", lambda *a: a[4])
    cap.wrap(A, "distinct_mask_cuda", lambda keys, el: el.numel())
    cap.wrap(S, "sort_rows_cuda", lambda page, keys: page.capacity,
             lambda page, keys: cap.label[1]
             if cap.label[0] == "sf1" and cap.label[1] in K10_TIMED
             else None)
    def list_step(step, page, params=()):
        def has(e):
            return (isinstance(e, EI.Call) and e.name in EC.LIST_CALLS) \
                or any(has(c) for c in e.children())
        return "list" if any(has(e) for e in step.exprs) else None
    cap.wrap(KG, "expr_step_cuda",
             lambda step, page, params=(): page.capacity, list_step,
             ("sf1", "forced", "list"))
    # K33/K34: their largest call of the list path
    lp = ("list",)
    cap.wrap(LS, "collect_sizes_cuda", lambda gid, *_: gid.numel(),
             scopes=lp)
    cap.wrap(LS, "collect_array_cuda",
             lambda x, masks, nr, gid, ng, L, rows: x.numel() * L, scopes=lp)
    cap.wrap(LS, "collect_map_cuda",
             lambda x, x2, masks, nr, gid, ng, L, rows, span=None:
             x.numel() * L, lambda x, x2, masks, nr, gid, ng, L, rows,
             span=None: "sort" if LS.map_plan(x, rows, span).route
             != LS.ROUTE_DIRECT else None, scopes=lp)
    cap.wrap(LS, "unnest_count_cuda", lambda lens, *_: lens.numel(),
             scopes=lp)
    cap.wrap(LS, "unnest_expand_cuda", lambda lens, v, nr, plane, *_:
             plane.numel(), scopes=lp)
    from trino_tpu_torch.exec import local_planner as LP
    from trino_tpu_torch.exec import spill as SP
    cap.wrap(J, "spill_prep_cuda", lambda cols, n: cols[0][0].numel())
    cap.wrap(J, "spill_probe_cuda", lambda pc, *_: pc[0][0].numel(),
             lambda pc, n, mode, *_: "dense" if mode == J.SPILL_DENSE
             else "search")
    cap.wrap(SP, "partition_rows_cuda",
             lambda arrays, kc, *_: kc[0][0].numel() * len(arrays),
             lambda arrays, kc, n, spec, npart: "hash"
             if spec[0] == SP.MODE_HASH else "range")
    cap.wrap(SP, "rank_rows_cuda", lambda values, *_: values.numel())
    cap.wrap(A, "passthrough_triton",
             lambda states, copies, n, c, dtypes: c * len(states))
    from trino_tpu_torch.ops import window as PW
    cap.wrap(PW, "window_bounds_cuda", lambda page, p, o: page.capacity)
    cap.wrap(PW, "rank_value_triton", lambda spec, page, b: page.capacity)
    cap.wrap(PW, "frame_aggregate_cuda", lambda spec, page, b: page.capacity,
             lambda spec, page, b: "whole" if PW.frame_kind(spec) == "whole"
             and spec.name in ("sum", "count") else None)
    cap.wrap(PW, "bounded_minmax_cuda", lambda spec, page, b: page.capacity)
    ds = ("ds",)
    cap.wrap(JM, "agg_table_cuda", lambda key, vecs, *_: key[0].numel()
             * len(vecs), scopes=ds)
    cap.wrap(JM, "agg_lookup_cuda", lambda key, nr, tab, km, outs:
             key[0].numel() * len(outs), scopes=ds)
    cap.wrap(JM, "key_bounds_cuda", lambda values, *_: values.numel(),
             scopes=ds)
    cap.wrap(JM, "agg_post_cuda",
             lambda hs, nr: hs[0].numel() * len(hs) if hs else 0, scopes=ds)
    real_attach = LP.attach_build_host

    def watched_attach(pre, *args, **kw):
        # the host attach's largest sf1 batch, timed in phase 4
        key = ("attach_build_host", "forced")
        if cap.label is not None and cap.label[0] == "forced" and (
                key not in cap.calls or pre.capacity > cap.calls[key][0]):
            cap.calls[key] = (pre.capacity, ((pre,) + args, kw))
        return real_attach(pre, *args, **kw)
    LP.attach_build_host = watched_attach
    plain_sorts = []     # the sort's plain twin must not run on the card
    real_plain_sort = S.sort_rows_plain

    def counted_plain_sort(page, keys):
        if page.device.type == "cuda" and cap.label is not None:
            plain_sorts.append(cap.label)
        return real_plain_sort(page, keys)
    S.sort_rows_plain = counted_plain_sort
    # no window function may run through a plain twin on the card
    win_plain = []
    real_win_plain = {k: getattr(PW, k) for k in (
        "window_bounds_plain", "rank_value_plain", "frame_aggregate_plain",
        "_bounded_minmax")}

    def counted_win_plain(k):
        def run(*args):
            if cap.label is not None and any(
                    isinstance(a, P.Page) and a.device.type == "cuda"
                    for a in args):
                win_plain.append((k, cap.label))
            return real_win_plain[k](*args)
        return run
    for k in real_win_plain:
        setattr(PW, k, counted_win_plain(k))
    # no fused aggregating join may run through a plain twin on the card
    agg_plain = []
    real_agg_plain = {k: getattr(JM, k) for k in (
        "agg_table_plain", "agg_lookup_plain", "key_bounds_plain",
        "agg_post_plain")}

    def counted_agg_plain(k):
        def run(*args):
            if cap.label is not None and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for a in args for t in (a if isinstance(a, (list, tuple))
                                            else (a,))):
                agg_plain.append((k, cap.label))
            return real_agg_plain[k](*args)
        return run
    for k in real_agg_plain:
        setattr(JM, k, counted_agg_plain(k))
    kernels = {"compact_rows": (P, "compact_rows_cuda"),
               "compact_range": (P, "compact_range_cuda"),
               "concat_rows": (P, "concat_rows_cuda"),
               "direct_aggregate": (A, "direct_reduce_cuda"),
               "global_aggregate": (A, "global_reduce_cuda"),
               "join_build": (J, "join_build_cuda"),
               "join_dense": (J, "join_dense_cuda"),
               "join_runs": (J, "join_runs_cuda"),
               "unique_probe": (J, "unique_probe_cuda"),
               "expand_count": (J, "expand_count_cuda"),
               "expand_write": (J, "expand_write_cuda"),
               "probe_verdict": (J, "probe_verdict_cuda"),
               "mxu_table": (JM, "mxu_table_cuda"),
               "gen_column": (TD, "gen_column_cuda"),
               "order_index": (TD, "order_index_cuda"),
               "gather_rows": (P, "gather_rows_cuda"),
               "group_aggregate": (A, "group_reduce_cuda"),
               "distinct_mask": (A, "distinct_mask_cuda"),
               "sort_rows": (S, "sort_rows_cuda"),
               "expr_step": (KG, "expr_step_cuda"),
               "window_bounds": (PW, "window_bounds_cuda"),
               "rank_value": (PW, "rank_value_triton"),
               "frame_aggregate": (PW, "frame_aggregate_cuda"),
               "bounded_minmax": (PW, "bounded_minmax_cuda"),
               "agg_table": (JM, "agg_table_cuda"),
               "agg_lookup": (JM, "agg_lookup_cuda"),
               "key_bounds": (JM, "key_bounds_cuda"),
               "agg_post": (JM, "agg_post_cuda")}
    # K16-K19: the memory-bounded paths' kernels (the sf10 runs may
    # launch them; the forced-threshold path below must)
    spill_kernels = {"spill_prep": (J, "spill_prep_cuda"),
                     "spill_probe": (J, "spill_probe_cuda"),
                     "spill_partition": (SP, "partition_rows_cuda"),
                     "spill_rank": (SP, "rank_rows_cuda"),
                     "bypass_partial": (A, "passthrough_triton")}
    all_kernels = {**kernels, **spill_kernels}
    # K28-K31: the special-aggregate path's kernels (SPECIAL_QUERIES)
    special_kernels = {"group_ids": (A, "group_ids_cuda"),
                       "checksum_contrib": (A, "checksum_contrib_cuda"),
                       "hll_pairs": (A, "hll_pairs_cuda"),
                       "centered": (A, "centered_cuda"),
                       "positional": (A, "positional_cuda"),
                       "hll_fold": (A, "hll_fold_cuda"),
                       "percentile": (A, "percentile_cuda")}
    # K33/K34 and K11's list steps: the list path's kernels (LIST_QUERIES;
    # K32 is counted as the plane-mode launches of K1, K2 and K7)
    list_kernels = {"group_ids": (A, "group_ids_cuda"),
                    "collect_sizes": (LS, "collect_sizes_cuda"),
                    "collect_array": (LS, "collect_array_cuda"),
                    "collect_map": (LS, "collect_map_cuda"),
                    "unnest_count": (LS, "unnest_count_cuda"),
                    "unnest_expand": (LS, "unnest_expand_cuda"),
                    "expr_step": (KG, "expr_step_cuda"),
                    "gather_rows": (P, "gather_rows_cuda")}
    runs = [("sf1", q, TPCH[q][0]) for q in TPCH]
    runs += [("sf1", "full", FULL_SQL), ("sf1", "mark", MARK_SQL)]
    win_runs = [(schema, w, sql)
                for w, (schema, _, sql) in WINDOW_QUERIES.items()]
    runs += [r for r in win_runs if r[0] == "sf1"]
    runs += [("sf10", q, TPCH[q][0]) for q in ("q6", "q3", "q9", "q13")]
    runs += [r for r in win_runs if r[0] == "sf10"]
    # the card generates its tables (K14/K15); the CPU port stages NumPy's,
    # an independent path
    gpu = {s: LocalQueryRunner.tpch(s) for s in ("sf1", "sf10")}
    cpu = {s: LocalQueryRunner.tpch(s, device="cpu", device_gen=False)
           for s in ("sf1", "sf10")}
    gpu_ds = tpcds_runners("sf1")
    cpu_ds = tpcds_runners("sf1", "cpu", False)
    host_staged = []     # supported columns staged from NumPy on the card
    real_host_cached = tpch._host_cached

    def watched_host_cached(key, build):
        if cap.label is not None and TD.supported(key[0], key[2]):
            host_staged.append(key)
        return real_host_cached(key, build)
    tpch._host_cached = watched_host_cached
    reset_counts(all_kernels)
    EC.cuda_evaluations = 0     # steps of the torch-op compiler on the card
    results = {}
    routes = set()
    kinds = set()
    per_query = {}
    mxu_counts = {}      # (schema, q) -> (mxu routes, mxu_joins) on cuda
    for schema, q, sql in runs:
        cap.label = (schema, q)
        before = {k: getattr(mod, attr).launches
                  for k, (mod, attr) in all_kernels.items()}
        t0 = time.perf_counter()
        res = gpu[schema].execute(sql)
        sync()
        results[(schema, q)] = (res, time.perf_counter() - t0)
        per_query[(schema, q)] = {
            k: getattr(mod, attr).launches - before[k]
            for k, (mod, attr) in all_kernels.items()}
        for i, j in enumerate(gpu[schema].last_joins):
            routes.add(j["route"])
            kinds.add(j["kind"])
            say(join_line(q, schema, i, j))
        for i, w in enumerate(gpu[schema].last_windows):
            say(f"[window] {q} {schema} window {i + 1}: {w['rows']} rows, "
                f"{w['partitions']} partitions, {w['peer_groups']} peer "
                f"groups, functions {w['functions']}, frames "
                f"{w['frames']}")
        if schema == "sf10":
            say(f"[spill] {q} sf10 (default session): "
                f"{spill_counters(gpu[schema])}")
        mxu_counts[(schema, q)] = mxu_of(gpu[schema])
    # TPC-DS at sf1 and G1-G4 (G3 on TPC-H sf1): tables staged from NumPy
    # on first use, so each first run includes the staging of the tables
    # no earlier query touched
    t_ds = time.perf_counter()
    ds_results, ds_failed = {}, {}
    for dsq, (catalog, session, sql, _) in TPCDS.items():
        runner = gpu_ds[(catalog, session)]
        cap.label = ("ds", dsq)
        before = {k: getattr(mod, attr).launches
                  for k, (mod, attr) in all_kernels.items()}
        t0 = time.perf_counter()
        try:
            res = runner.execute(sql)
            sync()
        except torch.cuda.OutOfMemoryError as e:
            ds_failed[dsq] = (str(e).split(".")[0],
                              [dict(j) for j in runner.last_joins])
            torch.cuda.empty_cache()
            res = None
        secs = time.perf_counter() - t0
        per_query[("ds", dsq)] = {
            k: getattr(mod, attr).launches - before[k]
            for k, (mod, attr) in all_kernels.items()}
        for i, j in enumerate(runner.last_joins):
            routes.add(j["route"])
            kinds.add(j["kind"])
            say(join_line(dsq, "sf1", i, j))
        if res is not None:
            ds_results[dsq] = (res, secs, ds_counters(runner))
    t_ds = time.perf_counter() - t_ds
    cap.label = None
    S.sort_rows_plain = real_plain_sort
    for k, fn in real_win_plain.items():
        setattr(PW, k, fn)
    for k, fn in real_agg_plain.items():
        setattr(JM, k, fn)
    if agg_plain:
        fail(f"fused joins on the card ran a plain twin: {agg_plain[:5]}")
    fused = sum(j[2]["routes"].count("mxu-agg")
                for j in ds_results.values())
    say(f"[fused] fused aggregating joins on the card: {fused} "
        f"(route mxu-agg), through a plain twin: {len(agg_plain)}")
    for dsq, (msg, joins) in ds_failed.items():
        if not dsq.startswith("ds_q72"):
            fail(f"{dsq} sf1 failed on the card: {msg}")
        big = max(joins, key=lambda j: j["output_rows"] or 0)
        say(f"[ds-stopped] {dsq} sf1 could not run on the card: {msg}; "
            f"at join {joins.index(big) + 1} of {len(joins)} ({big['kind']}"
            f", route {big['route']}): build {big['build_rows']} live rows,"
            f" max_run {big['max_run']}, probe page {big['probe_rows']} "
            f"rows, output {big['output_rows']} rows — {card}")
    tpch._host_cached = real_host_cached
    if host_staged:
        fail(f"{len(host_staged)} column slices on the card that K14 "
             f"generates were staged from NumPy: {host_staged[:5]}")
    say("[gen] every supported TPC-H column on the card was generated by "
        "K14/K15 (no NumPy staging of them)")
    if EC.cuda_evaluations:
        fail(f"{EC.cuda_evaluations} filter/project steps on the card ran "
             f"through the torch-op compiler, not K11")
    if plain_sorts:
        fail(f"sorts on the card ran the plain twin, not K10: "
             f"{plain_sorts[:5]}")
    say("[k11] every filter and project step on the card ran K11 (the "
        "torch-op compiler evaluated 0 steps); every ORDER BY and TopN "
        "sort ran K10")
    if win_plain:
        fail(f"window functions on the card ran a plain twin: "
             f"{win_plain[:5]}")
    say(f"[window] window functions through a plain twin on the card: "
        f"{len(win_plain)} (every one ran K20-K23)")
    launches = {k: getattr(mod, attr).launches
                for k, (mod, attr) in all_kernels.items()}
    spill_main = {k: dict(getattr(mod, attr).by_mode)
                  for k, (mod, attr) in spill_kernels.items()
                  if hasattr(getattr(mod, attr), "by_mode")}
    by_kind = {k: dict(getattr(mod, attr).by_kind)
               for k, (mod, attr) in kernels.items()
               if hasattr(getattr(mod, attr), "by_kind")}
    k13 = {k: dict(getattr(J, f"{k}_cuda").by_route)
           for k in ("unique_probe", "expand_count", "probe_verdict")}
    # the special-aggregate path, its counts set to 0 (the main path's
    # are read above)
    t_special = time.perf_counter()
    special_launches = special_runs(gpu, cpu, cap, all_kernels,
                                    special_kernels, card)
    t_special = time.perf_counter() - t_special
    # the list path, its counts set to 0 in turn
    t_list = time.perf_counter()
    list_launches = list_runs(gpu, cpu, cap, all_kernels, list_kernels,
                              card)
    t_list = time.perf_counter() - t_list
    # the distributed path over 8 shards of the card, its counts set to 0
    t_dist = time.perf_counter()
    from trino_tpu_torch.parallel import exchange as X
    dscope = ("dist",)
    cap.wrap(X, "exchange_count_cuda",
             lambda cols, nr, n, mode, hv: cols[0][0].numel(), scopes=dscope)
    cap.wrap(X, "exchange_scatter_cuda",
             lambda state, arrays, n, b: state[0].numel() * len(arrays),
             scopes=dscope)
    cap.wrap(X, "heavy_local_cuda", lambda w, k: w.numel(), scopes=dscope)
    cap.wrap(S, "sort_u64_cuda", lambda w: w.numel(), scopes=dscope)
    cap.wrap(X, "heavy_merge_cuda", lambda keys, *_: keys.numel(),
             scopes=dscope)
    dist_kernels = {"exchange_count": (X, "exchange_count_cuda"),
                    "exchange_scatter": (X, "exchange_scatter_cuda"),
                    "heavy_local": (X, "heavy_local_cuda"),
                    "heavy_merge": (X, "heavy_merge_cuda"),
                    "concat_rows": (P, "concat_rows_cuda"),
                    "sort_u64": (S, "sort_u64_cuda"),
                    "sort_rows": (S, "sort_rows_cuda"),
                    "expr_step": (KG, "expr_step_cuda")}
    dist = dist_runners(("sf1", "sf10"))
    receive_launches[0] = 0
    dist_launches, dist_secs = dist_runs(dist, gpu, results, cap,
                                         all_kernels, dist_kernels, card)
    dist_launches["exchange_receive"] = receive_launches[0]
    t_dist = time.perf_counter() - t_dist
    for (schema, q), (res, secs) in results.items():
        say(f"[query] {q} {schema} on cuda: {len(res.rows)} rows, first "
            f"run {secs:.2f} s (includes data generation and staging)")
    for dsq, (res, secs, _) in ds_results.items():
        say(f"[query] {dsq} sf1 on cuda: {len(res.rows)} rows, first run "
            f"{secs:.2f} s (includes NumPy generation and staging of the "
            f"tables no earlier TPC-DS query touched)")
    cold_walls(gpu["sf1"], card)
    gen_times(dev, card)
    t0 = time.perf_counter()
    for schema, q, sql in runs:
        want = cpu[schema].execute(sql).rows
        got = results[(schema, q)][0].rows
        if not rows_equal(got, want):
            fail(f"{q} {schema}: cuda rows differ from the CPU run:\n"
                 f"{got[:5]}\n{want[:5]}")
        if mxu_of(cpu[schema]) != mxu_counts[(schema, q)]:
            fail(f"{q} {schema}: (mxu routes, mxu_joins) "
                 f"{mxu_counts[(schema, q)]} on cuda, "
                 f"{mxu_of(cpu[schema])} on the CPU")
        say(f"[query] {q} {schema}: cuda rows == cpu rows ({len(got)} "
            f"rows, first {got[0] if got else None}); mxu routes and "
            f"mxu_joins {mxu_counts[(schema, q)]} on both")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dsq, (res, _, counters) in ds_results.items():
        catalog, session, sql, _ = TPCDS[dsq]
        runner = cpu_ds[(catalog, session)]
        want = runner.execute(sql).rows
        if not rows_equal(res.rows, want):
            fail(f"{dsq} sf1: cuda rows differ from the CPU run:\n"
                 f"{res.rows[:5]}\n{want[:5]}")
        if ds_counters(runner) != counters:
            fail(f"{dsq} sf1: routes and mxu counters {counters} on cuda, "
                 f"{ds_counters(runner)} on the CPU")
        say(f"[query] {dsq} sf1: cuda rows == cpu rows ({len(want)} rows, "
            f"first {want[0] if want else None}); routes, mxu_joins and "
            f"mxu_flops {counters} on both")
    t_ds_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    spill_launches, spill_modes, spill_routes = forced_runs(
        gpu["sf1"], cap, spill_kernels, card)
    missing = [k for k, n in spill_launches.items() if n == 0]
    if missing:
        fail(f"the forced-threshold runs never launched {missing}")
    for k, modes in (("spill_probe", {"dense", "search"}),
                     ("spill_partition", {"hash", "range"})):
        if not modes <= set(spill_modes[k]):
            fail(f"{k} never ran {sorted(modes - set(spill_modes[k]))} "
                 f"in the forced runs: {spill_modes[k]}")
    want_routes = {"spill-dense", "spill-search", "partitioned"}
    if not want_routes <= spill_routes | routes:
        fail(f"the spilled routes {sorted(want_routes - spill_routes)} "
             f"were never taken on the card")
    say(f"[launches] forced-threshold path ({len(FORCED)} runs): "
        f"{spill_launches}; by mode {spill_modes}; routes "
        f"{sorted(spill_routes)} — {card}")
    say(f"[time] phase 3 (queries): {time.perf_counter() - t_phase:.1f} s, "
        f"of which the CPU runs {t_cpu:.1f} s, the forced-threshold "
        f"runs {time.perf_counter() - t0:.1f} s, TPC-DS and G1-G4 "
        f"{t_ds:.1f} s on the card and {t_ds_cpu:.1f} s on the CPU, the "
        f"special aggregates {t_special:.1f} s (card and CPU), the list "
        f"path {t_list:.1f} s (card and CPU), the distributed path "
        f"{t_dist:.1f} s (card)")

    # ---- phase 4: launch check and times
    t_phase = time.perf_counter()
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    need = {"expand_count": {"inner", "left", "full"},
            "probe_verdict": {"semi", "anti", "mark"}}
    for k, want_kinds in need.items():
        if not want_kinds <= set(by_kind[k]):
            fail(f"{k} never launched for "
                 f"{sorted(want_kinds - set(by_kind[k]))}: {by_kind[k]}")
    if not {"dense", "search", "mxu", "cross"} <= routes:
        fail(f"the joins took the routes {sorted(routes)}, not dense, "
             f"search, mxu and cross")
    if not sum(r.get("mxu", 0) for r in k13.values()):
        fail(f"K13 (the mxu mode of K6/K9) never launched: {k13}")
    for (schema, q), counts in per_query.items():
        say(f"[launches] {q} {schema}: "
            + ", ".join(f"{k} {n}" for k, n in counts.items() if n))
    say(f"[launches] main path ({len(runs)} queries): {launches}; K9 by "
        f"kind: {by_kind}; K6/K9 by route: {k13} — {card}")
    originals = {k: cap.orig[attr] for k, (_, attr) in kernels.items()}
    rows = kernel_rows(cap, originals, launches, dev)
    rows += kernel_rows_q3(cap, originals, launches, dev)
    rows += kernel_rows_expand(cap, originals, launches, dev)
    rows += kernel_rows_sort_expr(cap, originals, launches, dev, card)
    rows += kernel_rows_mxu_gen(cap, originals, launches, k13, dev, card)
    originals.update({k: cap.orig[attr]
                      for k, (_, attr) in spill_kernels.items()})
    rows += kernel_rows_spill(cap, originals, launches, spill_launches,
                              spill_main, spill_modes, dev, card)
    rows += kernel_rows_window(cap, originals, launches, dev, card)
    rows += kernel_rows_agg_join(cap, originals, launches, dev, card)
    originals.update({k: cap.orig[attr]
                      for k, (_, attr) in special_kernels.items()})
    rows += kernel_rows_special(cap, originals, special_launches, dev, card)
    originals.update({k: cap.orig[attr]
                      for k, (_, attr) in list_kernels.items()})
    rows += kernel_rows_list(cap, originals, list_launches, dev, card)
    originals.update({k: cap.orig[attr]
                      for k, (_, attr) in dist_kernels.items()
                      if attr in cap.orig})
    rows += kernel_rows_dist(cap, originals, dist_launches, dev, card)
    from trino_tpu_torch import launch_trace
    for label, (us, ms) in launch_trace.launch_floor().items():
        say(f"[kernel] launch floor, {label}: host {us:.2f} us per launch "
            f"(1000 launches of an empty kernel), {ms:.4f} ms per launch "
            f"(CUDA events) — {card}")
    for r in rows:
        dev_ms = "not measured" if r["device_ms"] is None \
            else f"{r['device_ms']:.4f} ms"
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        host = "" if r.get("host_ms") is None \
            else f", host enqueue {r['host_ms']:.4f} ms"
        say(f"[kernel] {r['name']}: {r['ms']:.4f} ms per call (CUDA "
            f"events{host}), device-busy {dev_ms} (profiler), bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"{r['shape']} — {card}")
    say(f"[time] phase 4 kernel rows: {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    from trino_tpu_torch.connector import tpch_gen
    lineitem = {s: tpch_gen.row_count("lineitem", sf)
                for s, sf in (("sf1", 1.0), ("sf10", 10.0))}
    for schema, q, sql in runs:
        w = warm_profile(q, schema, lambda: gpu[schema].execute(sql), card)
        say(f"[wall] {q} {schema}: {lineitem[schema] / w / 1e6:.1f} M "
            f"lineitem rows/s — {card}")
    t_ds_walls = time.perf_counter()
    for dsq in ds_results:
        catalog, session, sql, _ = TPCDS[dsq]
        runner = gpu_ds[(catalog, session)]
        warm_profile(dsq, "sf1", lambda: runner.execute(sql), card)
    say(f"[time] TPC-DS and G1-G4 walls and profiles: "
        f"{time.perf_counter() - t_ds_walls:.1f} s")
    t_sp_walls = time.perf_counter()
    for name, (schema, sql) in SPECIAL_QUERIES.items():
        warm_profile(name, schema, lambda: gpu[schema].execute(sql), card)
    say(f"[time] special-aggregate walls and profiles: "
        f"{time.perf_counter() - t_sp_walls:.1f} s")
    t_list_walls = time.perf_counter()
    for name, (schema, sql) in LIST_QUERIES.items():
        warm_profile(name, schema, lambda: gpu[schema].execute(sql), card)
    say(f"[time] list-path walls and profiles: "
        f"{time.perf_counter() - t_list_walls:.1f} s")
    t_dist_walls = time.perf_counter()
    dist_walls(dist, card)
    say(f"[time] distributed-path walls and profiles: "
        f"{time.perf_counter() - t_dist_walls:.1f} s")
    say(f"[time] phase 4 walls and profiles: "
        f"{time.perf_counter() - t0:.1f} s; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "device_ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)


def warm_profile(q, schema, run, card) -> float:
    """Warm wall (median of 3 after one run), device busy and idle share
    (profiler, 3 runs) and the top host self time of one query; returns
    the wall in seconds."""
    run()
    sync()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        run()
        sync()
        walls.append(time.perf_counter() - t1)
    w = statistics.median(walls)
    say(f"[wall] {q} {schema}: warm median of 3 = {w * 1e3:.1f} ms — {card}")
    busy, top = device_profile(run, 3)
    if busy is None:
        say(f"[profile] {q} {schema}: device time not measured — {card}")
    else:
        say(f"[profile] {q} {schema}: device busy {busy:.2f} ms of "
            f"{w * 1e3:.1f} ms warm wall (idle share "
            f"{max(0.0, 1 - busy / (w * 1e3)):.2f}); top device time: "
            + ", ".join(f"{k[:60]} {t:.3f} ms" for k, t in top)
            + f" — {card}")
    say(f"[profile] {q} {schema}: top host self time per query: "
        + host_profile(run, top=6) + f" — {card}")
    return w


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
        host_ms=host_ms(lambda: originals["concat_rows"](arrays2, counts,
                                                         out_cap)),
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
    states4, num_rows4, cap4 = cap.calls[("global_reduce_cuda",
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
        name="global_aggregate (K4, _global_aggregate)", route="cuda",
        source="trino_tpu_torch/csrc/global_agg.cu",
        replaces="trino_tpu/ops/aggregate.py:1229",
        launches=launches["global_aggregate"], max_abs_err=err,
        ms=cuda_ms(lambda: originals["global_aggregate"](states4, num_rows4,
                                                         cap4)),
        device_ms=device_profile(lambda: originals["global_aggregate"](
            states4, num_rows4, cap4))[0],
        host_ms=host_ms(lambda: originals["global_aggregate"](
            states4, num_rows4, cap4)),
        plain_ms=cuda_ms(lambda: A.global_reduce_plain(states4, num_rows4,
                                                       cap4)),
        bound_ms=(nbytes(ins4) + 8 * len(states4)) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sum(stacked4, dim=1)),
        shape=f"q6 sf1 partial: cap {cap4}, {n4} live, {len(states4)} "
              f"states"))
    return out


def kernel_rows_agg_join(cap: Capture, originals, launches, dev, card):
    """K24-K27 at their largest call of the TPC-DS and G1-G4 runs, each
    against its twin at those inputs, K24 also through its other mode.
    Bounds count the live rows; each input read once (a column two
    vectors or outputs share, once), each output written once (K24: the
    table; K25: every derived column and the mask; K27: the masks)."""
    from trino_tpu_torch.ops import join_mxu as JM
    out = []

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape, err):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n_launches, max_abs_err=err, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    # K24 at its largest call (rows x vectors)
    key, vecs, nr, kmin, slots = cap.calls[("agg_table_cuda", "ds")][1]
    n = int(nr)
    got_t, got_i = originals["agg_table"](key, vecs, nr, kmin, slots)
    want_t, want_i = JM.agg_table_plain(key, vecs, nr, kmin, slots)
    err = 0.0
    for i, (kind, _, _) in enumerate(vecs):
        x, y = (JM.table_column(t, kind, i) for t in (got_t, want_t))
        if kind == JM.VEC_SUM_F:
            if not close_f64(x, y):
                fail("K24's float sums differ from its twin at the main "
                     "path's inputs")
            err = max(err, max_abs_err(x, y))
        elif not torch.equal(x, y):
            fail("K24 differs from its twin at the main path's inputs")
    if not torch.equal(got_i[:3], want_i[:3]):
        fail("K24's info differs from its twin at the main path's inputs")
    # the yardstick: one scatter_add_ of every (row, vector) contribution
    # into the flattened table, its indices and values made beforehand
    k64 = key[0][:n].to(torch.int64) if not key[0].is_floating_point() \
        else key[0][:n].to(torch.float64).view(torch.int64)
    slot = (k64 - kmin).clamp(0, slots - 1)
    nv = len(vecs)
    idx = (slot[:, None] * nv + torch.arange(nv, device=dev)).reshape(-1)
    src = torch.ones(idx.numel(), dtype=torch.int64, device=dev)
    flat = torch.zeros(slots * nv, dtype=torch.int64, device=dev)
    other = JM.AGG_TABLE_GLOBAL if slots * nv <= JM.AGG_SHARED_WORDS \
        else None
    other_ms = None if other is None else cuda_ms(
        lambda: originals["agg_table"](key, vecs, nr, kmin, slots, other))
    out.append(row(
        "agg_table (K24, scatter_agg_table)",
        "trino_tpu_torch/csrc/join_mxu.cu",
        "trino_tpu/ops/join_mxu.py:149", launches["agg_table"],
        lambda: originals["agg_table"](key, vecs, nr, kmin, slots),
        lambda: JM.agg_table_plain(key, vecs, nr, kmin, slots),
        # the key and vector columns read once (a valid count reads only
        # the validity), the table written once
        col_bytes([key] + [(None if kind == JM.VEC_VALIDCNT else v, m)
                           for kind, v, m in vecs], n) + 8 * slots * nv,
        lambda: flat.scatter_add_(0, idx, src),
        "one scatter_add_ of every (row, vector) contribution",
        f"build: cap {key[0].numel()}, {n} live rows, {nv} vectors, "
        f"{slots} slots" + ("" if other_ms is None else
                            f"; the global-atomics mode at this call "
                            f"{other_ms:.4f} ms"), err))

    # K25 at its largest call (rows x outputs)
    pkey, pnr, table, kmin, outs = cap.calls[("agg_lookup_cuda", "ds")][1]
    n = int(pnr)
    got, glive = originals["agg_lookup"](pkey, pnr, table, kmin, outs)
    want, wlive = JM.agg_lookup_plain(pkey, pnr, table, kmin, outs)
    # the live rows: K25 leaves the padding unwritten
    if not torch.equal(glive[:n], wlive[:n]) or not all(
            same_bits(x[:n], y[:n]) for x, y in zip(got, want)):
        fail("K25 differs from its twin at the main path's inputs")
    k64 = pkey[0][:n].to(torch.int64) if not pkey[0].is_floating_point() \
        else pkey[0][:n].to(torch.float64).view(torch.int64)
    rows_idx = (k64 - kmin).clamp(0, table.shape[0] - 1)
    out.append(row(
        "agg_lookup (K25, agg_join_lookup)",
        "trino_tpu_torch/csrc/join_mxu.cu", "trino_tpu/ops/join_mxu.py:218",
        launches["agg_lookup"],
        lambda: originals["agg_lookup"](pkey, pnr, table, kmin, outs),
        lambda: JM.agg_lookup_plain(pkey, pnr, table, kmin, outs),
        # the key and probe value columns read once (a count of valid
        # probe values reads only the validity), the table once, every
        # output and the live mask written once
        col_bytes([pkey] + [(None if op == JM.OP_CNTP else v, m)
                            for op, _, v, m in outs], n)
        + table.numel() * 8 + (8 * len(outs) + 1) * n,
        lambda: table.index_select(0, rows_idx),
        "index_select of each live row's table row",
        f"probe: cap {pkey[0].numel()}, {n} live rows, {len(outs)} outputs, "
        f"table {tuple(table.shape)}", 0.0))
    one_enqueue("agg_lookup at the main path's call", lambda: originals[
        "agg_lookup"](pkey, pnr, table, kmin, outs), "lookup")

    # K26 at its largest call
    values, valid, nr = cap.calls[("key_bounds_cuda", "ds")][1]
    n = int(nr)
    if not torch.equal(originals["key_bounds"](values, valid, nr),
                       JM.key_bounds_plain(values, valid, nr)):
        fail("K26 differs from its twin at the main path's inputs")
    out.append(row(
        "key_bounds (K26, key_bounds)", "trino_tpu_torch/csrc/join_mxu.cu",
        "trino_tpu/ops/join_mxu.py:201", launches["key_bounds"],
        lambda: originals["key_bounds"](values, valid, nr),
        lambda: JM.key_bounds_plain(values, valid, nr),
        col_bytes([(values, valid)], n) + 40,
        lambda: torch.aminmax(values[:n]), "torch.aminmax of the live keys",
        f"build key: cap {values.numel()}, {n} live rows, {values.dtype}",
        0.0))
    one_enqueue("key_bounds at the main path's call", lambda: originals[
        "key_bounds"](values, valid, nr), "bounds")

    # K27 at its largest call
    helpers, nr = cap.calls[("agg_post_cuda", "ds")][1]
    n = int(nr)
    if not all(torch.equal(x[:n], y[:n]) for x, y in zip(
            originals["agg_post"](helpers, nr),
            JM.agg_post_plain(helpers, nr))):
        fail("K27 differs from its twin at the main path's inputs")
    live = [h[:n] for h in helpers]
    fn = lambda: originals["agg_post"](helpers, nr)   # noqa: E731
    shape = (f"aggregated page: cap {helpers[0].numel()}, {n} live rows, "
             f"{len(helpers)} helpers")
    out.append(row(
        "agg_post (K27, agg_join_post)", "trino_tpu_torch/csrc/join_mxu.cu",
        "trino_tpu/ops/join_mxu.py:287", launches["agg_post"], fn,
        lambda: JM.agg_post_plain(helpers, nr),
        # the live helper rows read once, their masks written once
        col_bytes([(h, None) for h in helpers], n) + n * len(helpers) + 4,
        (lambda: live[0] > 0) if len(live) == 1 else
        (lambda: torch.stack(live) > 0),
        "Tensor.gt of the live helper rows" + (
            "" if len(live) == 1 else " (stacked)"), shape, 0.0))
    say_split("agg_post (K27)", shape, fn, card)
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
    """Bytes of n rows of (values, valid) columns, each array counted once
    however many columns name it (two aggregates of one column read it
    once); values may be None where only the validity is read."""
    arrays = {a.data_ptr(): a.element_size()
              for v, m in cols for a in (v, m) if a is not None}
    return n * sum(arrays.values())


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
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
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
    dcols, dnr, dstats, size = cap.calls[("join_dense_cuda", label)][1][:4]
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
    one_enqueue("join_dense at q3's build", lambda: originals["join_dense"](
        dcols, dnr, dstats, size), "dense")
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
    wprep = twin_prepared(prep, bcols)
    wf, wb, wc = J.unique_probe_plain(pcols, bcols, pnr, wprep)
    if int(c) != int(wc) or not torch.equal(f, wf) or not torch.equal(b,
                                                                       wb):
        fail("K6 differs from its twin at q3's probe")
    route = J.route_of(prep)
    bn = int(bnr)
    sorted_b = torch.sort(bcols[0][0][:bn]).values
    pk = pcols[0][0][:pn]
    pcap = pcols[0][0].numel()
    one_enqueue(f"unique_probe ({route}) at q3's probe", lambda: originals[
        "unique_probe"](pcols, bcols, pnr, prep), "probe")
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

    # K5 runs mode at the largest build of the sf1 queries
    cols, nr, stats, lookup, size = cap.calls[("join_runs_cuda", "sf1")][1]
    n = int(nr)
    runs, dense = originals["join_runs"](cols, nr, stats, lookup, size)
    wst, wlk = J.join_build_plain(cols, nr)
    wruns, wdense = J.join_runs_plain(cols, nr, wst, wlk, size)
    runs_ok("main path", J.Prepared(None, (), stats, lookup, dense, runs),
            J.Prepared(None, (), wst, wlk, wdense, wruns))
    one_enqueue("join_runs at the main path's call", lambda: originals[
        "join_runs"](cols, nr, stats, lookup, size), "runs")
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
    wprep = twin_prepared(prep, bcols)
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
        f"{J.route_of(prep)}, build {int(prep.stats[J.N_LIVE])} keyed "
        f"rows"))

    # K9 SEMI/ANTI/MARK at the largest verdict probe of sf1
    pcols, bcols, pnr, prep, kind, null_aware = cap.calls[
        ("probe_verdict_cuda", "sf1")][1]
    pn = int(pnr)
    wprep = twin_prepared(prep, bcols)
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
        f"{len(pcols)} key column(s), route {J.route_of(prep)}"))

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



def kernel_rows_mxu_gen(cap: Capture, originals, launches, k13, dev, card):
    """K12, K13 (each mode the main path launched) and K14/K15, each at its
    largest call of the sf1 queries, against its twin at those inputs; each
    also with its host time per call."""
    from trino_tpu_torch.connector import tpch_dev as TD
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.ops import join_mxu as JM
    out = []

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n_launches, max_abs_err=0.0, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    # K12 at the largest mxu build of sf1
    cols, nr, stats, lookup, runs, size = cap.calls[("mxu_table_cuda",
                                                     "sf1")][1]
    n = int(nr)
    table = originals["mxu_table"](cols, nr, stats, lookup, runs, size)
    kp = J.Prepared(None, (), stats, lookup, runs=runs, mxu=table)
    wst, wlk = J.join_build_plain(cols, nr)
    wruns = None if runs is None else J.join_runs_plain(cols, nr, wst, wlk,
                                                        0)[0]
    wp = J.Prepared(None, (), wst, wlk, runs=wruns,
                    mxu=JM.mxu_table_plain(cols, nr, wst, wlk, wruns, size))
    mxu_tables_ok("main path", kp, wp)
    key, null = J._key_cols(cols)
    ok = (torch.arange(key.numel(), device=dev) < n) & ~null
    raw = (key - stats[J.KMIN])[ok]
    rows_ = torch.nonzero(ok).flatten().to(torch.int32)
    lib_table = torch.full((size,), 2**31 - 1, dtype=torch.int32,
                           device=dev)
    out.append(row(
        "mxu_table (K12, build_count_pos_table)",
        "trino_tpu_torch/csrc/join_mxu.cu", "trino_tpu/ops/join_mxu.py:91",
        launches["mxu_table"],
        lambda: originals["mxu_table"](cols, nr, stats, lookup, runs, size),
        lambda: JM.mxu_table_plain(cols, nr, wst, wlk, wruns, size),
        # the live keys read once, the table written once
        col_bytes(cols, n) + size * 8,
        lambda: lib_table.scatter_reduce_(0, raw, rows_, "amin"),
        "Tensor.scatter_reduce_ (amin) of the rows into the table",
        f"sf1 mxu build: cap {cols[0][0].numel()}, {n} rows, "
        f"{int(stats[J.NDISTINCT])} distinct keys, table of {size} slots, "
        f"{'runs' if runs is not None else 'rows'}"))

    # K13 in each mode the main path launched, at its largest sf1 call
    def lookup_lib(prep, pcols, pn):
        kmin = prep.stats[J.KMIN]
        size = prep.mxu.shape[0]
        off = (pcols[0][0][:pn].to(torch.int64) - kmin).clamp(0, size - 1)
        return lambda: prep.mxu.index_select(0, off)
    modes = [("unique_probe", "K13 in K6, unique_inner_probe mxu",
              "trino_tpu_torch/csrc/join_probe.cu",
              "trino_tpu/ops/join.py:713"),
             ("expand_count", "K13 in K9 launch A, hash_join mxu",
              "trino_tpu_torch/csrc/join_expand.cu",
              "trino_tpu/ops/join.py:302"),
             ("probe_verdict", "K13 in K9 verdict, hash_join mxu",
              "trino_tpu_torch/csrc/join_expand.cu",
              "trino_tpu/ops/join.py:302")]
    for k, name, source, replaces in modes:
        n_launches = k13[k].get("mxu", 0)
        if not n_launches:
            say(f"[kernel] {name}: no launch on the main path")
            continue
        # the largest TPC-H sf1 call, else the largest TPC-DS one (q72's
        # router variant sends its duplicate builds to mxu)
        scope = next((sc for sc in ("sf1", "ds")
                      if (f"{k}_cuda:mxu", sc) in cap.calls), None)
        if scope is None:
            fail(f"{name}: {n_launches} launches on the main path, none in "
                 f"a TPC-H or TPC-DS sf1 run to hold against its twin")
        args = cap.calls[(f"{k}_cuda:mxu", scope)][1]
        pcols, bcols, pnr, prep = args[:4]
        rest = args[4:]
        pn = int(pnr)
        wprep = twin_prepared(prep, bcols)
        plain = {"unique_probe": J.unique_probe_plain,
                 "expand_count": J.expand_count_plain,
                 "probe_verdict": J.probe_verdict_plain}[k]
        got = originals[k](pcols, bcols, pnr, prep, *rest)
        want = plain(pcols, bcols, pnr, wprep, *rest)
        same = {"unique_probe": lambda a, b: all(
                    torch.equal(x, y) for x, y in zip(a, b)),
                "expand_count": lambda a, b: int(a.total) == int(b.total)
                and torch.equal(a.emit, b.emit)
                and torch.equal(a.cand_len, b.cand_len),
                "probe_verdict": lambda a, b: torch.equal(a[0], b[0]) and (
                    a[1] is None or torch.equal(a[1], b[1]))}[k]
        if not same(got, want):
            fail(f"{name} differs from its twin at the main path's inputs")
        out_b = {"unique_probe": 9, "expand_count": 12,
                 "probe_verdict": 2 if rest and rest[0] == "mark" else 1}[k]
        if k == "unique_probe":
            one_enqueue(f"{name} at the main path's call", lambda: originals[
                k](pcols, bcols, pnr, prep), "probe")
        out.append(row(
            f"{k} mxu mode ({name})", source, replaces, n_launches,
            lambda: originals[k](pcols, bcols, pnr, prep, *rest),
            lambda: plain(pcols, bcols, pnr, wprep, *rest),
            # the live probe keys and the table read once, the outputs of
            # a live row written once
            col_bytes(pcols, pn) + prep.mxu.numel() * 4 + pn * out_b,
            lookup_lib(prep, pcols, pn),
            "index_select of the table at the clamped offsets",
            f"{'TPC-H' if scope == 'sf1' else 'TPC-DS'} sf1 probe: cap "
            f"{pcols[0][0].numel()}, {pn} live, table of "
            f"{prep.mxu.shape[0]} slots, build "
            f"{int(prep.stats[J.N_LIVE])} keyed rows"
            + (f", {rest[0]}" if rest else "")))

    # K6's dense route at its largest sf1 call
    if not k13["unique_probe"].get("dense"):
        fail("K6's dense route never launched on the main path")
    pcols, bcols, pnr, prep = cap.calls[("unique_probe_cuda:dense",
                                         "sf1")][1]
    pn = int(pnr)
    wprep = twin_prepared(prep, bcols)
    got = originals["unique_probe"](pcols, bcols, pnr, prep)
    want = J.unique_probe_plain(pcols, bcols, pnr, wprep)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        fail("K6's dense route differs from its twin at the main path's "
             "inputs")
    one_enqueue("unique_probe (dense) at the main path's call",
                lambda: originals["unique_probe"](pcols, bcols, pnr, prep),
                "probe")
    dsize = prep.dense.numel()
    doff = (J._key_cols(pcols)[0][:pn] - prep.stats[J.KMIN]).clamp(
        0, dsize - 1)
    out.append(row(
        "unique_probe dense route (K6, unique_inner_probe dense)",
        "trino_tpu_torch/csrc/join_probe.cu", "trino_tpu/ops/join.py:190",
        k13["unique_probe"]["dense"],
        lambda: originals["unique_probe"](pcols, bcols, pnr, prep),
        lambda: J.unique_probe_plain(pcols, bcols, pnr, wprep),
        # the live probe keys and the table read once, found + brow (9
        # bytes) written once a live row
        col_bytes(pcols, pn) + dsize * 4 + pn * 9,
        lambda: prep.dense.index_select(0, doff),
        "index_select of the dense table at the clamped offsets",
        f"TPC-H sf1 probe: cap {pcols[0][0].numel()}, {pn} live, table of "
        f"{dsize} slots, build {int(prep.stats[J.N_LIVE])} keyed rows"))

    # K15 and K14 at sf1 lineitem's first scan page (the largest call of
    # both); K14 for l_receiptdate, the deepest recipe: the order date,
    # the ship days and the receipt days, three hash draws a row
    from trino_tpu_torch.connector import tpch, tpch_gen as G
    sf1 = tpch.SCHEMAS["sf1"]
    seed, o_first, s0, start, n15, norders, cap15, _ = cap.calls[
        ("order_index_cuda", "sf1")][1]
    oidx = originals["order_index"](seed, o_first, s0, start, n15, norders,
                                    cap15, dev)
    woidx = TD.order_index_plain(seed, o_first, s0, start, n15, norders,
                                 cap15, dev)
    if not torch.equal(oidx, woidx):
        fail("K15 differs from its twin at the main path's inputs")
    orders = torch.arange(norders, device=dev) + o_first
    per_order = torch.bincount(oidx[:n15] - o_first, minlength=norders)
    out.append(row(
        "order_index (K15, tpch_dev._oidx_fn)",
        "trino_tpu_torch/csrc/tpch_gen.cu",
        "trino_tpu/connector/tpch_dev.py:90", launches["order_index"],
        lambda: originals["order_index"](seed, o_first, s0, start, n15,
                                         norders, cap15, dev),
        lambda: TD.order_index_plain(seed, o_first, s0, start, n15, norders,
                                     cap15, dev),
        n15 * 8,   # the order index written once
        lambda: torch.repeat_interleave(orders, per_order),
        "repeat_interleave of the orders by their lines",
        f"sf1 lineitem page: rows [{start}, {start + n15}), cap {cap15}, "
        f"{norders} orders"))
    recipe = G.device_recipe("lineitem", "l_receiptdate", sf1)
    _, _, gn, gcap = cap.calls[("gen_column_cuda", "sf1")][1][:4]
    seed, o_first, s0, total = G.order_index_params(sf1, 0)
    goidx = originals["order_index"](seed, o_first, s0, 0, gn,
                                     min(gn, total - o_first), gcap, dev)
    got = originals["gen_column"](recipe, 0, gn, gcap, goidx, None,
                                  torch.int32, dev)
    want = TD.gen_column_plain(recipe, 0, gn, gcap, goidx, None,
                               torch.int32, dev)
    if not same_bits(got, want):
        fail("K14 differs from its twin at the main path's inputs")
    out.append(row(
        "gen_column (K14, tpch_dev._chunk_fn)",
        "trino_tpu_torch/csrc/tpch_gen.cu",
        "trino_tpu/connector/tpch_dev.py:55", launches["gen_column"],
        lambda: originals["gen_column"](recipe, 0, gn, gcap, goidx, None,
                                        torch.int32, dev),
        lambda: TD.gen_column_plain(recipe, 0, gn, gcap, goidx, None,
                                    torch.int32, dev),
        # the order index read once and the column written once
        gn * 8 + gcap * 4, None,
        "none (no PyTorch call computes a hash stream)",
        f"sf1 lineitem first page, l_receiptdate: {gn} rows, cap {gcap}"))
    for r in out:
        say(f"[kernel] {r['name']}: host {r['host_ms']:.4f} ms per call "
            f"(enqueue), {r['ms']:.4f} ms per call (CUDA events) — {card}")
    return out


def kernel_rows_spill(cap: Capture, originals, launches, spill_launches,
                      spill_main, spill_modes, dev, card):
    """K16, K17 (both modes), K18 (hash, range and rank modes) and K19,
    each at its largest call of the forced-threshold runs at sf1
    against its twin at those inputs, with its host time per call; and
    the host attach's milliseconds per batch. Launches are those of every
    configuration: the main path and the forced runs."""
    from trino_tpu_torch.exec import spill as SP
    from trino_tpu_torch.ops import aggregate as A
    from trino_tpu_torch.ops import join as J
    out = []
    i64_min = -(1 << 63)

    def total(k, mode=None):
        if mode is None:
            return launches[k] + spill_launches[k]
        return spill_main.get(k, {}).get(mode, 0) + \
            spill_modes.get(k, {}).get(mode, 0)

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape, route="cuda"):
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=n_launches, max_abs_err=0.0, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    # K16 at its largest sf1 build
    cols, nr = cap.calls[("spill_prep_cuda", "forced")][1]
    bcap, n = cols[0][0].numel(), int(nr)
    got = originals["spill_prep"](cols, nr)
    want = J.spill_prep_plain(cols, nr)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("K16 differs from its twin at the main path's inputs")
    key, null = J._key_cols(cols)
    dead = (torch.arange(bcap, device=dev) >= n) | null
    masked = torch.where(dead, torch.full_like(key, -1), key) ^ i64_min
    say_split("spill_prep (K16)", f"its largest sf1 build ({n} of {bcap} "
              f"rows)", lambda: originals["spill_prep"](cols, nr), card)
    out.append(row(
        "spill_prep (K16, prepare_build_spilled)",
        "trino_tpu_torch/csrc/join_spill.cu", "trino_tpu/ops/join.py:485",
        total("spill_prep"), lambda: originals["spill_prep"](cols, nr),
        lambda: J.spill_prep_plain(cols, nr),
        # the key columns of the live rows read once, the sorted keys
        # and permutation written once
        col_bytes(cols, n) + bcap * 12,
        lambda: torch.sort(masked, stable=True),
        "torch.sort(stable=True) of the masked keys",
        f"sf1 spilled build: cap {bcap}, {n} live rows, "
        f"{int(got[2][J.N_LIVE])} keyed, {len(cols)} key column(s)"))

    # K17 in each mode at its largest sf1 probe
    for tag, mode, replaces in (
            ("dense", J.SPILL_DENSE, "trino_tpu/ops/join.py:533"),
            ("search", J.SPILL_SEARCH, "trino_tpu/ops/join.py:584")):
        pcols, pnr, m, lookup, stats = cap.calls[
            (f"spill_probe_cuda:{tag}", "forced")][1]
        pn, pcap = int(pnr), pcols[0][0].numel()
        got = originals["spill_probe"](pcols, pnr, m, lookup, stats)
        want = J.spill_probe_plain(pcols, pnr, m, lookup, stats)
        # the live rows: K17 leaves the padding unwritten
        if int(got[2]) != int(want[2]) or not all(
                torch.equal(a[:pn], b[:pn])
                for a, b in zip(got[:2], want[:2])):
            fail(f"K17 {tag} mode differs from its twin at the main path's "
                 f"inputs")
        pkey, _ = J._key_cols(pcols)
        if m == J.SPILL_DENSE:
            table = lookup
            held = table.numel() * 4
            off = (pkey[:pn] - stats[J.KMIN]).clamp(0, table.numel() - 1)
            lib = (lambda t=table, o=off: t.index_select(0, o))
            lib_name = "index_select of the row table at the live offsets"
            desc = f"row table of {table.numel()} slots"
        else:
            bkeys, bperm = lookup
            held = bkeys.numel() * 12
            flipped = bkeys ^ i64_min
            pflip = pkey[:pn] ^ i64_min
            lib = (lambda f=flipped, p=pflip: torch.searchsorted(f, p))
            lib_name = "torch.searchsorted of the live keys"
            desc = f"{bkeys.numel()} sorted keys"
        # the live probe rows' keys and the lookup read once, found (1
        # byte) and brow (8 bytes) of each live row written once; the
        # whole capacity for the shape text
        live_bytes, cap_bytes = (col_bytes(pcols, r) + held + r * 9
                                 for r in (pn, pcap))
        out.append(row(
            f"spill_probe {tag} mode (K17, spilled_"
            f"{'dense' if tag == 'dense' else 'unique'}_probe)",
            "trino_tpu_torch/csrc/join_spill.cu", replaces,
            total("spill_probe", tag),
            lambda: originals["spill_probe"](pcols, pnr, m, lookup, stats),
            lambda: J.spill_probe_plain(pcols, pnr, m, lookup, stats),
            live_bytes, lib, lib_name,
            f"sf1 spilled probe: cap {pcap}, {pn} live, {desc}; bound "
            f"over the capacity "
            f"{cap_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms"))
        one_enqueue(f"spill_probe {tag} mode at the main path's call",
                    lambda: originals["spill_probe"](pcols, pnr, m, lookup,
                                                     stats), "spillprobe")

    # K18 in hash and range mode at its largest sf1 page
    for tag, replaces in (("hash", "trino_tpu/exec/spill.py:88"),
                          ("range", "trino_tpu/exec/spill.py:164")):
        arrays, key_cols, nr, spec, npart = cap.calls[
            (f"partition_rows_cuda:{tag}", "forced")][1]
        pcap = key_cols[0][0].numel()
        got = originals["spill_partition"](arrays, key_cols, nr, spec, npart)
        want = SP.partition_rows_plain(arrays, key_cols, nr, spec, npart)
        if not torch.equal(got[1], want[1]) or not all(
                same_bits(a, b) for a, b in zip(got[0], want[0])):
            fail(f"K18 {tag} mode differs from its twin at the main path's "
                 f"inputs")
        pid = SP._pids_plain(key_cols, nr, spec, npart)

        def lib(pid=pid, arrays=arrays):
            perm = torch.argsort(pid, stable=True)
            return [a.index_select(0, perm) for a in arrays]
        moved = sum(a.numel() * a.element_size() for a in arrays)
        out.append(row(
            f"spill_partition {tag} mode (K18, partition_by_{tag})",
            "trino_tpu_torch/csrc/spill_part.cu", replaces,
            total("spill_partition", tag),
            lambda: originals["spill_partition"](arrays, key_cols, nr, spec,
                                                 npart),
            lambda: SP.partition_rows_plain(arrays, key_cols, nr, spec,
                                            npart),
            # every moved array read and written once, the key columns
            # read once, the counts written
            2 * moved + col_bytes(key_cols, pcap) + npart * 8, lib,
            "argsort(pid, stable=True) and one index_select per array",
            f"sf1 page: cap {pcap}, {int(nr)} live rows, {len(arrays)} "
            f"arrays, {npart} partitions"))

    # K18's rank mode
    values, valid, asc, nf = cap.calls[("rank_rows_cuda", "forced")][1]
    rcap = values.numel()
    if not torch.equal(originals["spill_rank"](values, valid, asc, nf),
                       SP.rank_rows_plain(values, valid, asc, nf)):
        fail("K18 rank mode differs from its twin at the main path's inputs")
    out.append(row(
        "spill_rank (K18 rank mode, leading_rank)",
        "trino_tpu_torch/csrc/spill_part.cu", "trino_tpu/exec/spill.py:112",
        total("spill_rank"),
        lambda: originals["spill_rank"](values, valid, asc, nf),
        lambda: SP.rank_rows_plain(values, valid, asc, nf),
        col_bytes([(values, valid)], rcap) + rcap * 8, None,
        "none (no PyTorch call computes the rank)",
        f"sf1 sort spill: cap {rcap}, {values.dtype}"))

    # K19 at its largest sf1 page
    states, copies, nr, c, dtypes = cap.calls[("passthrough_triton",
                                               "forced")][1]
    got = originals["bypass_partial"](states, copies, nr, c, dtypes)
    want = A.passthrough_plain(states, copies, nr, c, dtypes)
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        fail("K19 differs from its twin at the main path's inputs")
    read = sum(t.numel() * t.element_size() for st in states
               for t in (st.values, st.valid, st.mask) if t is not None)
    written = sum(t.numel() * t.element_size() for t in got)
    out.append(row(
        "bypass_partial (K19, passthrough_partial)",
        "trino_tpu_torch/ops/aggregate.py",
        "trino_tpu/ops/aggregate.py:916", total("bypass_partial"),
        lambda: originals["bypass_partial"](states, copies, nr, c, dtypes),
        lambda: A.passthrough_plain(states, copies, nr, c, dtypes),
        read + written, None, "none (no single PyTorch call)",
        f"sf1 bypass page: cap {c}, {int(nr)} live rows, {len(states)} "
        f"states", route="triton"))
    for r in out:
        say(f"[kernel] {r['name']}: host {r['host_ms']:.4f} ms per call "
            f"(enqueue), {r['ms']:.4f} ms per call (CUDA events) — {card}")

    # the host attach of the spilled join, per batch (it waits for the
    # card once: its time is the batch's wall on the host)
    from trino_tpu_torch.ops.join import attach_build_host
    args, kw = cap.calls[("attach_build_host", "forced")][1]

    def attach():
        return attach_build_host(*args, **kw)
    attach()
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        attach()
    sync()
    per_batch = (time.perf_counter() - t0) / 5e-3
    # its bound: the bytes it moves across PCIe (each matched row's build
    # row and verified probe keys to the host, 8 bytes each; every emitted
    # column staged at the page's capacity to the card), timed as one
    # pinned host-to-device copy of as many bytes
    pre = args[0]
    n_rows, pcap = int(pre.num_rows), pre.capacity
    host_cols = args[2]
    emit = kw.get("emit")
    emitted = host_cols if emit is None else [host_cols[i] for i in emit]
    moved = n_rows * 8 * (1 + len(kw.get("verify") or ())) + sum(
        pcap * (v.element_size() + (0 if m is None else 1))
        for v, m, _, _ in emitted)
    pinned = torch.empty(moved, dtype=torch.uint8, pin_memory=True)
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 10)
    say(f"[host] attach_build_host: {per_batch:.3f} ms per batch of "
        f"{n_rows} matched rows (cap {pcap}, {len(host_cols)} host "
        f"columns, {len(emitted)} emitted); it moves {moved} bytes across "
        f"PCIe, and a pinned host-to-device copy of {moved} bytes takes "
        f"{copy_ms:.3f} ms (its bound) — {card}")
    return out



def kernel_rows_window(cap: Capture, originals, launches, dev, card):
    """K20-K23 at their largest call of the sf1 window queries (W1-W6,
    W8), K22 also at its largest whole-partition sum or count beside
    torch.segment_reduce, K23 also through its doubling table; each
    against its twin at those inputs. Bounds count the live rows: nothing
    reads a dead row's output."""
    from trino_tpu_torch import page as P
    from trino_tpu_torch.ops import window as W
    out = []

    def row(name, source, replaces, n_launches, fn, plain, bound_bytes,
            library, library_name, shape, err, route="cuda"):
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=n_launches, max_abs_err=err, ms=cuda_ms(fn),
            device_ms=device_profile(fn)[0], host_ms=host_ms(fn),
            plain_ms=cuda_ms(plain),
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if library is None else cuda_ms(library),
            shape=f"{shape}; library = {library_name}")

    def arg_bytes(page, spec, rows):
        """The spec's argument columns (values and validity) over rows."""
        return sum(col_bytes([(page.column(c).values, page.column(c).valid)],
                             rows) for c in spec.arg_channels)

    def out_bytes(col, rows):
        return col_bytes([(col.values, col.valid)], rows)

    # K20 at its largest sf1 call
    page, pch, och = cap.calls[("window_bounds_cuda", "sf1")][1]
    pcap, n = page.capacity, int(page.num_rows)
    got = originals["window_bounds"](page, pch, och)
    want = W.window_bounds_plain(page, pch, och)
    for f in ("seg_start", "seg_len", "peer_start", "peer_len", "seg_id",
              "peer_id"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            fail(f"K20 {f} differs from its twin at the main path's inputs")
    keys = [(page.column(c).values, page.column(c).valid) for c in pch + och]
    out.append(row(
        "window_bounds (K20, window)", "trino_tpu_torch/csrc/window.cu",
        "trino_tpu/ops/window.py:58", launches["window_bounds"],
        lambda: originals["window_bounds"](page, pch, och),
        lambda: W.window_bounds_plain(page, pch, och),
        # the key columns read once, four int64 and two int32 arrays written
        col_bytes(keys, n) + 40 * n, None,
        "none (no PyTorch call computes the segment and peer arrays)",
        f"sf1 window page: cap {pcap}, {n} live rows, "
        f"{len(pch)} partition and {len(och)} order keys", 0.0))

    # K21 at its largest sf1 call
    spec, page, b = cap.calls[("rank_value_triton", "sf1")][1]
    pcap, n = page.capacity, int(page.num_rows)
    got = originals["rank_value"](spec, page, b)
    want = W.rank_value_plain(spec, page, b)
    err = window_err("K21 at the main path's inputs", got, want, n)
    # seg_start and seg_len, the peer arrays the function reads, its
    # arguments at one row each, the output written once
    reads = {"rank": 8, "dense_rank": 4, "percent_rank": 8,
             "cume_dist": 16}.get(spec.name, 0)
    if W.frame_kind(spec) == "range" and spec.name in (
            "first_value", "last_value", "nth_value"):
        reads = 16
    out.append(row(
        f"rank_value (K21, _eval: {spec.name})",
        "trino_tpu_torch/ops/window.py",
        "trino_tpu/ops/window.py:126", launches["rank_value"],
        lambda: originals["rank_value"](spec, page, b),
        lambda: W.rank_value_plain(spec, page, b),
        (16 + reads) * n + arg_bytes(page, spec, n) + out_bytes(got, n),
        None, "none (no single PyTorch call computes a window function)",
        f"sf1 window page: cap {pcap}, {n} live rows, "
        f"{spec.name} over a {W.frame_kind(spec)} frame", err,
        route="triton"))

    # K22 at its largest sf1 call, and at its largest whole-partition
    # sum or count beside torch.segment_reduce
    for key, what in ((("frame_aggregate_cuda", "sf1"), "largest call"),
                      (("frame_aggregate_cuda:whole", "sf1"),
                       "whole-partition")):
        if key not in cap.calls:
            continue
        spec, page, b = cap.calls[key][1]
        pcap, n = page.capacity, int(page.num_rows)
        got = originals["frame_aggregate"](spec, page, b)
        want = W.frame_aggregate_plain(spec, page, b)
        err = window_err("K22 at the main path's inputs", got, want, n)
        library, library_name = None, \
            "none (no PyTorch call computes a segmented scan read per row)"
        if W.frame_kind(spec) == "whole":
            starts = b.seg_start[:n] == torch.arange(n, device=dev)
            lengths = b.seg_len[:n][starts]
            col = page.column(spec.arg_channels[0]) if spec.arg_channels \
                else None
            x = torch.ones(n, dtype=torch.float64, device=dev) if col is None \
                else torch.where(col.valid_mask()[:n], col.values[:n],
                                 torch.zeros_like(col.values[:n])).to(
                                     torch.float64)
            library = (lambda x=x, lengths=lengths: torch.segment_reduce(
                x, "sum", lengths=lengths))
            library_name = ("torch.segment_reduce(sum) over the partitions "
                            "(one value per partition, not per row)")
        reads = 32 if W.frame_kind(spec) == "range" else 16
        out.append(row(
            f"frame_aggregate (K22, _eval_aggregate: {spec.name} over a "
            f"{W.frame_kind(spec)} frame, {what})",
            "trino_tpu_torch/csrc/window.cu", "trino_tpu/ops/window.py:276",
            launches["frame_aggregate"],
            lambda: originals["frame_aggregate"](spec, page, b),
            lambda: W.frame_aggregate_plain(spec, page, b),
            # the argument and K20's arrays read once, the output written
            arg_bytes(page, spec, n) + reads * n + out_bytes(got, n),
            library, library_name,
            f"sf1 window page: cap {pcap}, {n} live rows", err))

    # K23 at its largest sf1 call
    spec, page, b = cap.calls[("bounded_minmax_cuda", "sf1")][1]
    pcap, n = page.capacity, int(page.num_rows)
    got = P.Column(*originals["bounded_minmax"](spec, page, b),
                   spec.out_type)
    err = window_err("K23 at the main path's inputs", got, P.Column(
        *W._bounded_minmax(spec, page, b), spec.out_type), n)
    bs, be = spec.bounds
    library, library_name = None, "none (an asymmetric frame)"
    if bs == -be:
        x = page.column(spec.arg_channels[0]).values.to(torch.float64)
        x = (x if spec.name == "max" else -x).reshape(1, 1, -1)
        library = (lambda x=x: torch.nn.functional.max_pool1d(
            x, 2 * be + 1, stride=1, padding=be))
        library_name = (f"max_pool1d over {2 * be + 1} rows (no partition "
                        f"clipping, no NULLs)")
    out.append(row(
        f"bounded_minmax (K23, _bounded_minmax: {spec.name} ROWS {bs}..{be})",
        "trino_tpu_torch/csrc/window.cu", "trino_tpu/ops/window.py:372",
        launches["bounded_minmax"],
        lambda: originals["bounded_minmax"](spec, page, b),
        lambda: W._bounded_minmax(spec, page, b),
        # the argument, seg_start and seg_len read once, the values and
        # validity written
        arg_bytes(page, spec, n) + 16 * n + out_bytes(got, n),
        library, library_name,
        f"sf1 window page: cap {pcap}, {n} live rows", err))
    # the same call through K23's doubling table (the path of frames past
    # its halo's width), held to the halo's output bit for bit
    table = (be - bs + 1).bit_length()
    got_t = P.Column(*originals["bounded_minmax"](spec, page, b, table),
                     spec.out_type)
    if not (torch.equal(got_t.values[:n], got.values[:n])
            and torch.equal(got_t.valid[:n], got.valid[:n])):
        fail("K23's doubling table differs from its halo path at the main "
             "path's inputs")
    halo_ms = cuda_ms(lambda: originals["bounded_minmax"](spec, page, b))
    table_ms = cuda_ms(lambda: originals["bounded_minmax"](spec, page, b,
                                                           table))
    say(f"[kernel] bounded_minmax (K23) at W2's call, {spec.name} ROWS "
        f"{bs}..{be} over cap {pcap} ({n} live rows): halo path "
        f"{halo_ms:.4f} ms, doubling table ({table} levels) {table_ms:.4f} "
        f"ms per call (CUDA events, same call) — {card}")
    for r in out:
        say(f"[kernel] {r['name']}: host {r['host_ms']:.4f} ms per call "
            f"(enqueue), {r['ms']:.4f} ms per call (CUDA events) — {card}")
    return out

if __name__ == "__main__":
    main()
