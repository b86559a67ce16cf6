"""The fused aggregating join of trino_tpu_torch against trino_tpu (CPU).

* The four functions of ops/join_mxu.py against the reference's
  scatter_agg_table, key_bounds, agg_join_lookup and agg_join_post (run on
  the CPU, where the reference accumulates in float64) on seeded numpy
  builds and probes: 128 to 65,536 slots, 8 and 256 keys under many build
  rows, NULL keys and values, dead rows, negative and double keys, probe
  keys below kmin and past the span, integer sums past 2^53, an all-NULL
  build column, the empty build and an all-dead probe. Integers, masks and
  mag_ok compare exactly, doubles to 1e-12 relative.
* K26 and K27 are CUDA kernels: their wrappers run through kernel models
  in test_torch_spill_bounds_models.py and test_torch_heavy_post_models.py.
* Queries at tiny under the default, forced and off sessions: G1-G4
  (chip_smoke.TPCDS), G5 and G6 (the all-NULL build sum and the 2^53
  guard, as inline subqueries: the port has no memory tables), the
  aggregating shapes of tests/test_mxu_join.py and its sparse decline.
  Rows, the number of fused joins, mxu_joins and mxu_flops equal the
  reference's.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import assert_same
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu.exec import local_planner as RLP
from trino_tpu.ops import join_mxu as RM
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner
from trino_tpu_torch.ops import join as PJ
from trino_tpu_torch.ops import join_mxu as PM

torch.set_num_threads(1)
CPU = torch.device("cpu")
_REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_agg", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


TPCDS = _chip_smoke().TPCDS

# ------------------------------------------------------------ the twins

CASES = {  # build cap, live rows, key kind, distinct keys, slots,
           # probe cap, live probe rows
    "span 100": (600, 590, "int", 100, 128, 900, 850),
    "4096 slots": (5000, 4900, "int", 4096, 4096, 3000, 2900),
    "32768 slots": (3000, 3000, "int", 3000, 32768, 2000, 2000),
    "65536 slots": (4000, 3990, "int", 4000, 65536, 1500, 1400),
    "8 keys, many rows": (20_000, 20_000, "int", 8, 128, 3000, 3000),
    "256 keys, many rows": (20_000, 19_990, "int", 256, 256, 3000, 2990),
    "negative keys": (700, 700, "negative", 100, 128, 900, 900),
    "double keys": (700, 690, "double", 200, 256, 900, 880),
    "sums past 2^53": (500, 500, "big", 64, 128, 600, 600),
    "empty build": (300, 0, "int", 100, 128, 600, 600),
    "dead probe": (700, 700, "int", 100, 128, 500, 0),
}

# the build's table columns: cnt, sum(a) (int), sum(d) (double), #valid
# a, sum(c) (int32), #valid z, sum(z) (z all NULL)
VEC_SPECS = (("cnt",), ("sum", 1, "i"), ("sum", 2, "f"), ("validcnt", 1),
             ("sum", 3, "i"), ("validcnt", 4), ("sum", 4, "i"))
BUILD_TYPES = ("key", "BIGINT", "DOUBLE", "INTEGER", "BIGINT")


def _pages(arrays, types, valids, n):
    ref = RP.Page.from_numpy(arrays, [getattr(RT, t) for t in types],
                             valids=valids)
    port = PP.Page.from_numpy(arrays, [getattr(PT, t) for t in types],
                              valids=valids, device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, CPU)))


def case(name):
    """(reference build page, port build page, kmin word, reference
    probe page, port probe page, slots) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cap, n, kind, distinct, slots, pcap, pn = CASES[name]
    pick = rng.integers(0, distinct, cap)
    if kind == "negative":
        keys, base, ktype = pick - 50, -50, "BIGINT"
    elif kind == "double":
        # consecutive doubles from 1.0 (the reference's CPU flushes
        # subnormals); -0.0 keys sit below the span
        base = int(np.float64(1.0).view(np.int64))
        keys = (pick + base).view(np.float64).copy()
        keys[rng.random(cap) < 0.05] = -0.0
        ktype = "DOUBLE"
    else:
        keys, base, ktype = pick + 1000, 1000, "BIGINT"
    a = rng.integers(-10**6, 10**6, cap)
    if kind == "big":
        a = a + (1 << 50)
    arrays = [keys, a, rng.standard_normal(cap) * 1e3,
              rng.integers(-1000, 1000, cap).astype(np.int32),
              rng.integers(0, 9, cap)]
    valids = [rng.random(cap) >= 0.05, rng.random(cap) >= 0.1,
              rng.random(cap) >= 0.1, None, np.zeros(cap, bool)]
    types = (ktype,) + BUILD_TYPES[1:]
    rb, pb = _pages(arrays, types, valids, n)
    # probe keys: build keys, keys past the span, keys below kmin
    pk = keys[rng.integers(0, cap, pcap)].copy()
    r = rng.integers(0, 4, pcap)
    if kind == "double":
        bits = pk.view(np.int64)
        bits[r == 1] += slots + 7
    else:
        pk[r == 1] += slots + 7
        pk[r == 2] -= slots + 9
    parrays = [pk, rng.integers(-10**9, 10**9, pcap),
               rng.standard_normal(pcap) * 1e3,
               rng.integers(-100, 100, pcap).astype(np.int32),
               rng.integers(0, 5, pcap)]
    pvalids = [rng.random(pcap) >= 0.05, rng.random(pcap) >= 0.1, None,
               None, rng.random(pcap) >= 0.2]
    rp, pp = _pages(parrays, (ktype, "BIGINT", "DOUBLE", "INTEGER",
                              "BIGINT"), pvalids, pn)
    return rb, pb, base, rp, pp, slots


def tables(name):
    rb, pb, base, rp, pp, slots = case(name)
    rtable, rdistinct, rmag = RM.scatter_agg_table(slots, VEC_SPECS, 0)(
        rb, jnp.uint64(PJ.unsigned(base)))
    kmin = torch.tensor(base, dtype=torch.int64)
    ptable, info = PM.scatter_agg_table(slots, VEC_SPECS, 0)(pb, kmin)
    return (np.asarray(rtable), int(rdistinct), bool(rmag), rb, rp,
            ptable, info, kmin, pb, pp, base, slots)


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scatter_agg_table_matches_reference(name):
    rtable, rdistinct, rmag, *_, ptable, info, _, _, _, _, _ = tables(name)
    assert ptable.shape == rtable.shape
    for i, spec in enumerate(VEC_SPECS):
        kind = PM.vec_kind(spec)
        col = PM.table_column(ptable, kind, i).numpy()
        if kind == PM.VEC_SUM_F:
            _close(col, rtable[:, i])
        elif name != "sums past 2^53" or kind != PM.VEC_SUM_I:
            # float64 holds these sums exactly
            np.testing.assert_array_equal(col, rtable[:, i].astype(np.int64))
    assert int(info[PM.INFO_DISTINCT]) == rdistinct
    assert bool(info[PM.INFO_MAG_OK]) == rmag
    assert int(info[PM.INFO_LIVE]) == int(rtable[:, 0].sum())
    assert rmag == (name != "sums past 2^53")


@pytest.mark.parametrize("name", sorted(CASES))
def test_key_bounds_matches_reference(name):
    rb, pb, *_ = case(name)
    rmin, rmax = (int(x) for x in RM.key_bounds(0)(rb))
    words = PM.key_bounds(0)(pb)
    assert PJ.unsigned(int(words[PM.B_KMIN])) == rmin
    assert PJ.unsigned(int(words[PM.B_KMAX])) == rmax
    # the dynamic filter's range: the reference's build_key_bounds
    from trino_tpu.ops import join as RJ
    rlo, rhi = RJ.build_key_bounds([0])(rb)
    lo, hi = PJ.typed_bounds(pb.column(0).values.dtype,
                             words[PM.B_LO:PM.B_HI + 1])
    if int(pb.num_rows):
        assert float(lo) == float(rlo) and float(hi) == float(rhi)


DERIVE = (("pairs",), ("cntp", 1), ("sump", 1, "i"), ("sump", 2, "f"),
          ("sump", 3, "i"), ("cntb", 3), ("sumb", 1, "i", 0),
          ("sumb", 2, "f", 0), ("sumb", 6, "i", 1), ("cntb", 5))
HELPERS = (3, 5)


def _cols_equal(ref_page, port_page, exact=True):
    """Columns equal on the live rows: validity exactly, doubles to 1e-12
    relative, integers exactly where `exact` (past 2^53 the reference's
    float64 table rounds what the port's int64 table holds: 1e-12
    relative there)."""
    n = int(ref_page.num_rows)
    assert int(port_page.num_rows) == n
    for rc, pc in zip(ref_page.columns, port_page.columns):
        rv = np.asarray(rc.values)[:n]
        pv = pc.values[:n].numpy()
        rvalid = np.ones(n, bool) if rc.valid is None else \
            np.asarray(rc.valid)[:n]
        pvalid = pc.valid_mask()[:n].numpy()
        np.testing.assert_array_equal(pvalid, rvalid)
        if pv.dtype.kind == "f" or not exact:
            _close(pv[rvalid], rv[rvalid])
        else:
            np.testing.assert_array_equal(pv[rvalid],
                                          rv[rvalid].astype(pv.dtype))


@pytest.mark.parametrize("name", sorted(CASES))
def test_agg_join_lookup_matches_reference(name):
    rtable, _, _, _, rp, ptable, _, kmin, _, pp, base, _ = tables(name)
    want = RM.agg_join_lookup(0, (4,), DERIVE, HELPERS)(
        rp, jnp.asarray(rtable), jnp.uint64(PJ.unsigned(base)))
    got = PM.agg_join_lookup(0, (4,), DERIVE, HELPERS)(pp, ptable, kmin)
    assert len(got.columns) == len(want.columns)
    for rc, pc in zip(want.columns, got.columns):
        assert pc.type == getattr(PT, type(rc.type).__name__.replace(
            "Type", "").upper(), pc.type)
    _cols_equal(want, got, exact=name != "sums past 2^53")


@pytest.mark.parametrize("name", sorted(CASES))
def test_agg_join_post_matches_reference(name):
    """The post step over each side's SINGLE aggregation of its derived
    rows: declared types, build-side SUM NULL where no non-NULL build
    value joined (the all-NULL column's sum), helpers dropped."""
    from trino_tpu.ops import AggSpec as RAggSpec
    from trino_tpu.ops import Step as RStep
    from trino_tpu.ops import hash_aggregate as ragg
    from trino_tpu_torch.ops import AggSpec, Step, hash_aggregate
    rtable, _, _, _, rp, ptable, _, kmin, _, pp, base, _ = tables(name)
    rder = RM.agg_join_lookup(0, (4,), DERIVE, HELPERS)(
        rp, jnp.asarray(rtable), jnp.uint64(PJ.unsigned(base)))
    pder = PM.agg_join_lookup(0, (4,), DERIVE, HELPERS)(pp, ptable, kmin)
    if int(pder.num_rows) == 0:
        # no derived rows: the executor yields no groups, post never runs
        assert int(rder.num_rows) == 0
        return
    types = [c.type for c in pder.columns[1:]]
    rtypes = [c.type for c in rder.columns[1:]]
    ragged = ragg([0], [RAggSpec("sum", 1 + i, t)
                        for i, t in enumerate(rtypes)], RStep.SINGLE)(rder)
    pagged = hash_aggregate([0], [AggSpec("sum", 1 + i, t)
                                  for i, t in enumerate(types)],
                            Step.SINGLE)(pder)
    out = (PT.BIGINT, PT.BIGINT, PT.BIGINT, PT.DOUBLE, PT.BIGINT, PT.BIGINT,
           PT.BIGINT, PT.DOUBLE, PT.BIGINT, PT.BIGINT)
    rout = tuple(getattr(RT, t.display().upper()) for t in out)
    want = RM.agg_join_post(1, DERIVE, len(HELPERS), rout)(ragged)
    got = PM.agg_join_post(1, DERIVE, len(HELPERS), out)(pagged)
    assert [c.type for c in got.columns[1:]] == list(out)
    assert len(got.columns) == 1 + len(DERIVE)
    # groups come in each side's hash order: compare as sorted rows
    n = int(want.num_rows)
    assert int(got.num_rows) == n
    order = np.argsort(want.columns[0].values[:n])
    porder = torch.argsort(got.columns[0].values[:n])
    for rc, pc in zip(want.columns, got.columns):
        r = RP.Column(rc.values[:n][order], None if rc.valid is None
                      else rc.valid[:n][order], rc.type, None)
        p = PP.Column(pc.values[:n][porder], None if pc.valid is None
                      else pc.valid[:n][porder], pc.type, None)
        _cols_equal(RP.Page((r,), np.int32(n)), PP.Page((p,), PP.row_count(
            n, CPU)), exact=name != "sums past 2^53")
    sumz = 1 + DERIVE.index(("sumb", 6, "i", 1))
    assert not got.columns[sumz].valid_mask()[:n].any()   # all NULL w


# ------------------------------------------------------------- queries

FORCED = ("SET SESSION mxu_join_density_threshold = 0",
          "SET SESSION mxu_join_max_slots = 65536")
OFF = ("SET SESSION mxu_join_enabled = false",)
SESSIONS = {"default": (), "forced": FORCED, "off": OFF}

# tests/test_mxu_join.py's aggregating shapes (test_aggregating_join,
# test_distinct_project, test_sparse_build_declines), G1-G4 from
# chip_smoke.TPCDS, and G5/G6, the memory-table tests' shapes as inline
# subqueries (the larger table is the probe): name -> (catalog, SQL)
QUERIES = {
    "aggregating_join": ("tpch",
                         "SELECT s_nationkey, count(*), sum(s_acctbal), "
                         "sum(n_regionkey), count(n_comment) "
                         "FROM supplier, nation WHERE s_nationkey = "
                         "n_nationkey GROUP BY s_nationkey ORDER BY "
                         "s_nationkey"),
    "distinct_project": ("tpch",
                         "SELECT DISTINCT s_nationkey FROM supplier, nation "
                         "WHERE s_nationkey = n_nationkey"),
    "sparse_build": ("tpch",
                     "SELECT count(*) FROM lineitem, part "
                     "WHERE l_partkey = p_partkey AND p_partkey % 64 = 0"),
    "G5": ("tpch",
           "SELECT g, count(*), sum(w), count(w) FROM (SELECT o_orderkey % 8 "
           "AS k, o_orderkey % 8 AS g FROM orders) p, (SELECT s_suppkey % 8 "
           "AS k, CASE WHEN s_suppkey % 8 = 3 THEN NULL ELSE s_nationkey END "
           "AS w FROM supplier) b WHERE p.k = b.k GROUP BY g"),
    "G6": ("tpch",
           "SELECT g, sum(w) FROM (SELECT o_orderkey % 4 AS k, o_orderkey % 2 "
           "AS g FROM orders) p, (SELECT s_suppkey % 4 AS k, "
           "9007199254740993 + s_suppkey AS w FROM supplier) b "
           "WHERE p.k = b.k GROUP BY g"),
    "G2_decimal": ("tpcds",
                   "SELECT ss_store_sk, count(*), sum(ss_net_paid), "
                   "sum(i_current_price) FROM store_sales, item "
                   "WHERE ss_item_sk = i_item_sk GROUP BY ss_store_sk"),
}
QUERIES.update({g: (TPCDS[g][0], TPCDS[g][2])
                for g in ("G1", "G2", "G3", "G4")})


@pytest.fixture(scope="module")
def runners():
    """(reference, port) runner per (session, catalog), built on first
    use."""
    made = {}

    def get(session, catalog):
        key = (session, catalog)
        if key not in made:
            ref = RefRunner.tpch("tiny")
            port = PortRunner.tpch("tiny", device="cpu")
            stmts = SESSIONS[session] + (
                ("USE tpcds.tiny",) if catalog == "tpcds" else ())
            for stmt in stmts:
                ref.execute(stmt)
                port.execute(stmt)
            made[key] = (ref, port)
        return made[key]
    return get


@pytest.fixture
def ref_fused(monkeypatch):
    """Counts the reference's fused joins: its _mxu_agg_join_run reports
    each one through _adaptive_span('join-mxu-agg', ...)."""
    count = [0]
    orig = RLP.LocalExecutionPlanner._adaptive_span

    def span(self, name, **attrs):
        if name == "join-mxu-agg":
            count[0] += 1
        return orig(self, name, **attrs)
    monkeypatch.setattr(RLP.LocalExecutionPlanner, "_adaptive_span", span)
    return count


def run_both(runners, ref_fused, session, name):
    catalog, sql = QUERIES[name]
    ref, port = runners(session, catalog)
    ref_fused[0] = 0
    want = ref.execute(sql).rows
    rstats = dict(ref.last_query_stats)
    got = port.execute(sql).rows
    assert_same(got, want, "ORDER BY" in sql)
    fused = sum(j["route"] == "mxu-agg" for j in port.last_joins)
    assert fused == ref_fused[0], name
    pstats = port.last_query_stats
    assert pstats["mxu_joins"] == rstats.get("mxu_joins", 0), name
    assert pstats["mxu_flops"] == rstats.get("mxu_flops", 0), name
    return fused, got, port


@pytest.mark.parametrize("session", sorted(SESSIONS))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fused_join_routes_like_the_reference(runners, ref_fused, session,
                                              name):
    fused, _, port = run_both(runners, ref_fused, session, name)
    if session == "off":
        assert fused == 0
    elif name in ("G6", "sparse_build") and session == "default":
        assert fused == 0
    elif name != "G6":
        assert fused == 1
        log = [j for j in port.last_joins if j["route"] == "mxu-agg"][0]
        assert log["slots"] >= 128 and log["build_rows"] > 0
        assert log["output_rows"] <= log["probe_rows"]


def test_all_null_build_sum_is_null(runners, ref_fused):
    """G5: group 3 joined only NULL build values: sum(w) NULL, count(w)
    0, on the fused path."""
    fused, rows, _ = run_both(runners, ref_fused, "forced", "G5")
    assert fused == 1
    g3 = [r for r in rows if r[0] == 3][0]
    assert g3[2] is None and g3[3] == 0 and g3[1] > 0


def test_magnitude_guard_declines(runners, ref_fused):
    """G6: per-key sums past 2^53 clear mag_ok, the fused join declines to
    the gather join (one mxu lookup route), whose int64 sums the rows
    hold."""
    fused, rows, port = run_both(runners, ref_fused, "forced", "G6")
    assert fused == 0
    assert [j["route"] for j in port.last_joins] == ["mxu"]
    assert len(rows) == 2


@pytest.mark.parametrize("name, flops", [("aggregating_join", 1_048_576),
                                         ("distinct_project", 262_144)])
def test_default_session_fuses_like_the_reference(runners, ref_fused, name,
                                                  flops):
    """The port's fault before the fused join was ported: under the
    default session it took the lookup join plus an aggregation, and
    counted 524,288 flops for both queries where the reference fuses
    (4 table columns, then 1)."""
    fused, _, port = run_both(runners, ref_fused, "default", name)
    assert fused == 1
    assert port.last_query_stats["mxu_flops"] == flops
