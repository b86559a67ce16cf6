"""The `mxu` join route of trino_tpu_torch against trino_tpu (CPU, tiny).

* Per TPC-H query, default session: the port's router sends the same joins
  to `mxu` as the reference's (last_query_stats["mxu_joins"], read live
  from the reference, not hard-coded), counts the same cost-model
  mxu_flops over its probe pages, and gives the reference's rows
  (tests/oracle.assert_same).
* Forced session (tests/test_mxu_join.py's: density threshold 0, 65,536
  slots) and mxu_join_enabled = false: the semi/anti shapes of
  test_semijoin_and_anti, test_sparse_build_declines' sparse build, and
  two join-route variants of the aggregating shapes; rows and mxu_joins
  equal the reference's in every session.
* K12/K13's twins (ops/join_mxu.py) against the reference's
  build_count_pos_table and matmul_lookup on seeded numpy builds and
  probes: counts exactly, first positions through the reference's bperm
  (each package keeps its own build order). Duplicates, NULLs, dead rows,
  keys outside the span and the empty build.
Everything compares exactly.
"""

import numpy as np
import pytest
import torch

from oracle import assert_same
from tpch_sql import QUERIES
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu.ops import join as RJ
from trino_tpu.ops import join_mxu as RM
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner
from trino_tpu_torch.ops import join as PJ
from trino_tpu_torch.ops import join_mxu as PM

torch.set_num_threads(1)
CPU = torch.device("cpu")

FORCED = ("SET SESSION mxu_join_density_threshold = 0",
          "SET SESSION mxu_join_max_slots = 65536")
OFF = ("SET SESSION mxu_join_enabled = false",)
SESSIONS = {"default": (), "forced": FORCED, "off": OFF}


@pytest.fixture(scope="module")
def runners():
    """(reference, port) runner per session name, built on first use."""
    made = {}

    def get(name):
        if name not in made:
            ref = RefRunner.tpch("tiny")
            port = PortRunner.tpch("tiny", device="cpu")
            for stmt in SESSIONS[name]:
                ref.execute(stmt)
                port.execute(stmt)
            made[name] = (ref, port)
        return made[name]
    return get


def run_both(ref, port, sql, ordered=False):
    want = ref.execute(sql).rows
    rstats = dict(ref.last_query_stats)
    got = port.execute(sql).rows
    assert_same(got, want, ordered)
    return rstats, dict(port.last_query_stats)


@pytest.mark.parametrize("name", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_tpch_routes_like_the_reference(runners, name):
    sql, _, ordered = QUERIES[name]
    ref, port = runners("default")
    rstats, pstats = run_both(ref, port, sql, ordered)
    assert pstats["mxu_joins"] == rstats.get("mxu_joins", 0), name
    assert sum(j["route"] == "mxu" for j in port.last_joins) == \
        pstats["mxu_joins"]
    # the probe pages' capacities are the reference's, so the cost-model
    # flops agree exactly
    assert pstats["mxu_flops"] == rstats.get("mxu_flops", 0), name


SHAPES = {
    "semi_in": "SELECT count(*) FROM orders WHERE o_custkey IN "
               "(SELECT c_custkey FROM customer WHERE c_acctbal > 0)",
    "anti_not_in": "SELECT count(*) FROM orders WHERE o_custkey NOT IN "
                   "(SELECT c_custkey FROM customer WHERE c_acctbal > 0)",
    "exists": "SELECT count(*) FROM customer c WHERE EXISTS "
              "(SELECT 1 FROM orders o WHERE o.o_custkey = c.c_custkey)",
    "sparse_build": "SELECT count(*) FROM lineitem, part "
                    "WHERE l_partkey = p_partkey AND p_partkey % 64 = 0",
    "unique_build_sum": "SELECT sum(l_extendedprice * p_size) "
                        "FROM lineitem, part WHERE l_partkey = p_partkey "
                        "AND p_size > 25",
    "duplicate_build_sum": "SELECT sum(c_acctbal + o_totalprice) "
                           "FROM customer, orders "
                           "WHERE c_custkey = o_custkey "
                           "AND o_orderstatus = 'F'",
}


@pytest.mark.parametrize("session", ["forced", "off"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forced_and_disabled_sessions(runners, shape, session):
    ref, port = runners(session)
    rstats, pstats = run_both(ref, port, SHAPES[shape])
    assert pstats["mxu_joins"] == rstats.get("mxu_joins", 0)
    if session == "off":
        assert pstats["mxu_joins"] == 0
    elif shape != "sparse_build":
        assert pstats["mxu_joins"] >= 1


def test_sparse_build_declines_by_default(runners):
    ref, port = runners("default")
    rstats, pstats = run_both(ref, port, SHAPES["sparse_build"])
    assert pstats["mxu_joins"] == rstats.get("mxu_joins", 0) == 0


# ------------------------------------------------------------ the twins


def pages(keys, valid, n):
    """One BIGINT key column as a reference page and a port page."""
    ref = RP.Page.from_numpy([keys], [RT.BIGINT],
                             valids=[valid])
    port = PP.Page.from_numpy([keys], [PT.BIGINT], valids=[valid],
                              device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, CPU)))


TWIN_CASES = {  # build cap, live rows, span, duplicates, NULL fraction
    "unique": (100, 90, 128, False, 0.0),
    "duplicates": (300, 280, 100, True, 0.0),
    "nulls": (500, 450, 4096, True, 0.1),
    "empty": (64, 0, 50, False, 0.0),
}


def twin_case(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    cap, n, span, dup, null_frac = TWIN_CASES[kind]
    v = rng.integers(0, span, cap) if dup else rng.permutation(span)[:cap]
    keys = (v + 1000).astype(np.int64)
    valid = rng.random(cap) >= null_frac if null_frac else None
    rb, pb = pages(keys, valid, n)
    ref = RJ.prepare_build([0])(rb)
    port = PJ.prepare_build([0])(pb)
    kmin = PJ.unsigned(int(port.stats[PJ.KMIN]))
    kmax = PJ.unsigned(int(port.stats[PJ.KMAX]))
    span_live = kmax - kmin + 1 if kmax >= kmin else 0
    size = 1 << max((max(span_live, 1) - 1).bit_length(), 7)
    # probe keys: build keys, keys past kmin + size, keys below kmin
    pk = rng.choice(keys, 700)
    pk[::4] = 1000 + size + rng.integers(0, 50, pk[::4].size)
    pk[1::4] = 999 - rng.integers(0, 50, pk[1::4].size)
    rp, pp = pages(pk, rng.random(700) >= 0.05, 650)
    return ref, port, rp, pp, size


@pytest.mark.parametrize("kind", sorted(TWIN_CASES))
def test_distinct_live_keys_matches_reference(kind):
    ref, port, _, _, _ = twin_case(kind)
    want = int(RM.distinct_live_keys(ref[1], ref[3]))
    assert int(PM.distinct_live_keys(port)) == want


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("kind", sorted(TWIN_CASES))
def test_count_pos_table_matches_reference(kind, runs):
    ref, port, _, _, size = twin_case(kind)
    if runs:
        port = PJ.prepare_runs(0)(port)
    table = PM.build_count_pos_table(size)(port).mxu.to(torch.int64)
    want = np.asarray(RM.build_count_pos_table(size)(ref[1], ref[3],
                                                     ref[8]))
    bperm = np.asarray(ref[2])
    np.testing.assert_array_equal(table[:, 0].numpy(),
                                  want[:, 0].astype(np.int64))
    occ = want[:, 0] > 0
    first = table[occ, 1]
    if runs:
        first = port.runs[0].to(torch.int64)[first]
    # the reference's first sorted position names the same build row
    np.testing.assert_array_equal(first.numpy(),
                                  bperm[want[occ, 1].astype(np.int64)])


@pytest.mark.parametrize("kind", sorted(TWIN_CASES))
def test_matmul_lookup_matches_reference(kind):
    ref, port, rp, pp, size = twin_case(kind)
    rtable = RM.build_count_pos_table(size)(ref[1], ref[3], ref[8])
    rkey, _ = RJ._key_u64(rp, [0])
    rcnt, rlo = (np.asarray(x) for x in RM.matmul_lookup(rtable, ref[8],
                                                        rkey))
    port = PM.build_count_pos_table(size)(port)
    pkey, _ = PJ._key_u64(pp, [0])
    cnt, first = PM.matmul_lookup(port.mxu, port.stats[PJ.KMIN], pkey)
    np.testing.assert_array_equal(cnt.numpy(), rcnt.astype(np.int32))
    hit = rcnt > 0
    bperm = np.asarray(ref[2])
    np.testing.assert_array_equal(first.numpy()[hit], bperm[rlo[hit]])
    assert not first.numpy()[~hit].any()


@pytest.mark.parametrize("kind", ["unique", "empty"])
def test_unique_probe_on_the_mxu_route(kind):
    """K6's twin over the mxu table finds the rows of the dense route."""
    _, port, _, pp, size = twin_case(kind)
    assert int(port.stats[PJ.MAX_RUN]) <= 1
    mxu = PM.build_count_pos_table(size)(port)
    dense = PJ.build_dense_table(size)(port)
    got = PJ.unique_inner_probe([0], [0], lookup="mxu")(pp, mxu)
    want = PJ.unique_inner_probe([0], [0], lookup="dense")(pp, dense)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert torch.equal(got[0].columns[-1].values, want[0].columns[-1].values)
