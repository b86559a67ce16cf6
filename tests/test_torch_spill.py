"""The spill partitioner (K18's plain twin), the host partition store and
spill ledger, and the adaptive bypass's per-row states (K19's plain twin)
against trino_tpu on the same seeded numpy pages (CPU).

partition_by_hash at salts 0-3 and 1, 4 and 16 partitions, leading_rank
for every key type in both directions with NULLs first and last,
rank_bounds and partition_by_range: moved pages, counts and ranks bit for
bit (the reference sorts by partition id stably, so every row of the
capacity compares). HostPartitionStore and SpillLedger: restage, bounded
chunks, draining, heavy-key detection and splitting, byte accounting and
the ledger back at 0; a budget past spill_max_bytes raises
EXCEEDED_SPILL_LIMIT, not retryable. passthrough_partial: every state
column of every row, integers exactly and doubles bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_join import pages
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.exec import spill as RS
from trino_tpu.ops import aggregate as RA
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.exec import spill as PS
from trino_tpu_torch.ops import aggregate as PA

torch.set_num_threads(1)

WORDS = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"],
                 dtype=object)


def spill_page(seed=0, cap=512, n=480):
    """(ref page, port page): BIGINT keys with NULLs and -1, DOUBLE with
    NaN, -0.0, +0.0, -inf and ties, BOOLEAN, VARCHAR codes, an INTEGER
    payload."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, cap // 3, cap).astype(np.int64)
    f = rng.integers(-40, 40, cap).astype(np.float64) * 0.25
    f[::9] = np.nan
    f[1::13] = -0.0
    f[2::17] = 0.0
    f[3::19] = -np.inf
    b = rng.random(cap) < 0.5
    d = RP.Dictionary(WORDS)
    codes = rng.integers(0, len(WORDS), cap).astype(np.int32)
    pay = rng.integers(-10**6, 10**6, cap).astype(np.int32)
    return pages([k, f, b, codes, pay],
                 ["BIGINT", "DOUBLE", "BOOLEAN", "VARCHAR", "INTEGER"],
                 [rng.random(cap) < 0.9, rng.random(cap) < 0.9, None, None,
                  rng.random(cap) < 0.95], n, [None, None, None, d, None])


def assert_same_page(ref, port):
    assert int(ref.num_rows) == int(port.num_rows)
    for rc, pc in zip(ref.columns, port.columns):
        rv = np.asarray(rc.values)
        pv = pc.values.numpy()
        if rv.dtype.kind == "f":
            rv, pv = rv.view(np.int64), pv.view(np.int64)
        np.testing.assert_array_equal(rv, pv)
        assert (rc.valid is None) == (pc.valid is None)
        if rc.valid is not None:
            np.testing.assert_array_equal(np.asarray(rc.valid),
                                          pc.valid.numpy())


KEYSETS = {"bigint": (0,), "double": (1,), "bool_varchar": (2, 3),
           "composite": (0, 1, 3)}
HASH_CASES = [(ks, 4, salt) for ks in sorted(KEYSETS) for salt in range(4)] \
    + [(ks, npart, salt) for ks in sorted(KEYSETS) for npart in (1, 16)
       for salt in (0, 2)]


@pytest.mark.parametrize("keyset,npart,salt", HASH_CASES)
def test_partition_by_hash_matches_reference(keyset, npart, salt):
    rp, pp = spill_page(seed=npart + salt)
    keys = KEYSETS[keyset]
    rsorted, rcounts = RS.partition_by_hash(keys, npart, salt=salt)(rp)
    psorted, pcounts = PS.partition_by_hash(keys, npart, salt=salt)(pp)
    np.testing.assert_array_equal(np.asarray(rcounts), pcounts.numpy())
    assert_same_page(rsorted, psorted)


def test_canonical_hash_matches_reference():
    rp, pp = spill_page(seed=7)
    for keys in KEYSETS.values():
        want = np.asarray(RS._canonical_key_hash(rp, keys)).view(np.int64)
        cols = [(pp.column(c).values, pp.column(c).valid) for c in keys]
        np.testing.assert_array_equal(want, PS.key_hash_plain(cols).numpy())


RANK_CASES = [(ch, asc, nf) for ch in (0, 1, 2, 3) for asc in (True, False)
              for nf in (True, False)]


@pytest.mark.parametrize("channel,ascending,nulls_first", RANK_CASES)
def test_leading_rank_matches_reference(channel, ascending, nulls_first):
    rp, pp = spill_page(seed=3)
    want = RS.leading_rank(channel, ascending, nulls_first)(rp)
    got = PS.leading_rank(channel, ascending, nulls_first)(pp)
    np.testing.assert_array_equal(np.asarray(want).view(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("channel,ascending,nulls_first", RANK_CASES)
def test_partition_by_range_matches_reference(channel, ascending,
                                              nulls_first):
    """rank_bounds' quantiles (ties among them) and the range partitions:
    equal keys never straddle a partition."""
    rp, pp = spill_page(seed=5)
    npart = 4
    rr = RS.leading_rank(channel, ascending, nulls_first)(rp)
    pr = PS.leading_rank(channel, ascending, nulls_first)(pp)
    rb = RS.rank_bounds(npart)(rr, rp.row_mask(), rp.num_rows)
    pb = PS.rank_bounds(npart)(pr, pp.row_mask(), pp.num_rows)
    np.testing.assert_array_equal(np.asarray(rb).view(np.int64), pb.numpy())
    rsorted, rcounts = RS.partition_by_range(channel, ascending, nulls_first,
                                             npart)(rp, rb)
    psorted, pcounts = PS.partition_by_range(channel, ascending, nulls_first,
                                             npart)(pp, pb)
    np.testing.assert_array_equal(np.asarray(rcounts), pcounts.numpy())
    assert_same_page(rsorted, psorted)


@pytest.mark.parametrize("npart", [2, 16])
def test_rank_bounds_all_dead_and_ties(npart):
    """Bounds over an all-dead page are u64::MAX; a single repeated key
    puts every live row in one partition."""
    rp, pp = spill_page(seed=11, n=0)
    rr = RS.leading_rank(0, True, False)(rp)
    pr = PS.leading_rank(0, True, False)(pp)
    rb = RS.rank_bounds(npart)(rr, rp.row_mask(), rp.num_rows)
    pb = PS.rank_bounds(npart)(pr, pp.row_mask(), pp.num_rows)
    np.testing.assert_array_equal(np.asarray(rb).view(np.int64), pb.numpy())
    assert (pb.numpy() == -1).all()
    ones = np.full(64, 5, dtype=np.int64)
    rq, pq = pages([ones], ["BIGINT"], [None], 60)
    pr = PS.leading_rank(0, True, False)(pq)
    pb = PS.rank_bounds(npart)(pr, pq.row_mask(), pq.num_rows)
    _, counts = PS.partition_by_range(0, True, False, npart)(pq, pb)
    assert sorted(counts.tolist())[-1] == 60


# ------------------------------------------------------------ the store


def both_stores(npart=4, limit=None, ledgers=None):
    rl, pl = ledgers or (RS.SpillLedger(), PS.SpillLedger())
    return (RS.HostPartitionStore(npart, ledger=rl, query_id="q",
                                  limit=limit),
            PS.HostPartitionStore(npart, ledger=pl, query_id="q",
                                  limit=limit), rl, pl)


def fill(rstore, pstore, seeds=(0, 1, 2)):
    for seed in seeds:
        rp, pp = spill_page(seed=seed)
        rs, rc = RS.partition_by_hash((0,), rstore.npart)(rp)
        ps, pc = PS.partition_by_hash((0,), pstore.npart)(pp)
        rstore.spill_partitioned(rs, np.asarray(rc))
        pstore.spill_partitioned(ps, pc.tolist())


def test_store_accounting_restage_and_ledger():
    rstore, pstore, rl, pl = both_stores()
    fill(rstore, pstore)
    assert pstore.bytes == rstore.bytes > 0 and pl.reserved == rl.reserved
    for p in range(4):
        assert pstore.partition_rows(p) == rstore.partition_rows(p)
        assert pstore.partition_bytes(p) == rstore.partition_bytes(p)
        assert pstore.chunk_rows_for(p, 1000) == rstore.chunk_rows_for(p,
                                                                       1000)
        n = rstore.partition_rows(p)
        assert_same_page(rstore.restage(p, 2048), pstore.restage(p, 2048))
        assert n > 0
    pstore.close()
    rstore.close()
    assert pl.reserved == 0 and rl.reserved == 0 and not pl.by_query


@pytest.mark.parametrize("chunk_rows", [100, 333, 5000])
def test_store_chunks_and_drain(chunk_rows):
    rstore, pstore, rl, pl = both_stores()
    fill(rstore, pstore)
    for p in range(4):
        rchunks = list(rstore.iter_partition_chunks(p, chunk_rows))
        pchunks = list(pstore.iter_partition_chunks(p, chunk_rows))
        assert len(rchunks) == len(pchunks)
        for a, b in zip(rchunks, pchunks):
            assert_same_page(a, b)
    before = pl.reserved
    drained = list(pstore.drain_partition_chunks(0, chunk_rows))
    list(rstore.drain_partition_chunks(0, chunk_rows))
    assert sum(int(c.num_rows) for c in drained) > 0
    assert pstore.partition_rows(0) == 0 and pl.reserved < before
    assert pl.reserved == rl.reserved
    pstore.close()
    assert pl.reserved == 0


def test_heavy_key_detection_and_split():
    """A dominant key is found and split into its own store with its bytes;
    the rest stays; both ledgers agree and return to 0."""
    rstore, pstore, rl, pl = both_stores(npart=2)
    for seed in (4, 5):
        cap, n = 512, 500
        rng = np.random.default_rng(seed)
        k = rng.integers(0, 100, cap).astype(np.int64)
        k[: cap // 2] = 42
        rp, pp = pages([k, rng.integers(0, 9, cap).astype(np.int64)],
                       ["BIGINT", "BIGINT"], [None, None], n)
        rs, rc = RS.partition_by_hash((0,), 2)(rp)
        ps, pc = PS.partition_by_hash((0,), 2)(pp)
        rstore.spill_partitioned(rs, np.asarray(rc))
        pstore.spill_partitioned(ps, pc.tolist())
    for p in range(2):
        rh = RS.detect_partition_heavy_keys(rstore, p, [0], 8, 100)
        ph = PS.detect_partition_heavy_keys(pstore, p, [0], 8, 100)
        np.testing.assert_array_equal(np.sort(rh), np.sort(ph))
        if not len(ph):
            continue
        rsub = RS.split_partition(rstore, p, [0], rh)
        psub = PS.split_partition(pstore, p, [0], ph)
        assert psub.partition_rows(0) == rsub.partition_rows(0) >= 500
        assert pstore.partition_rows(p) == rstore.partition_rows(p)
        assert psub.bytes == rsub.bytes
        assert_same_page(rsub.restage(0, 1024), psub.restage(0, 1024))
        psub.close()
        rsub.close()
    pstore.close()
    rstore.close()
    assert pl.reserved == rl.reserved == 0


def test_spill_limit_is_classified():
    rstore, pstore, rl, pl = both_stores(limit=8192)
    for store, ledger, mod in ((rstore, rl, RS), (pstore, pl, PS)):
        with pytest.raises(mod.ExceededSpillLimitError) as ei:
            if mod is RS:
                fill(rstore, pstore.__class__(4), seeds=(0, 1))
            else:
                fill(rstore.__class__(4), pstore, seeds=(0, 1))
        assert ei.value.error_name == "EXCEEDED_SPILL_LIMIT"
        assert not ei.value.retryable
        assert ledger.denials == 1
        store.close()
        assert ledger.reserved == 0


def test_resolve_spill_limit_default():
    from trino_tpu_torch.metadata import Session
    s = Session()
    assert PS.resolve_spill_limit(s) == RS.default_spill_limit_bytes()
    s.set("spill_max_bytes", 4096)
    assert PS.resolve_spill_limit(s) == 4096


# ------------------------------------------------- passthrough_partial


def agg_page(seed=0, cap=256, n=240):
    rng = np.random.default_rng(seed)
    i = rng.integers(-10**6, 10**6, cap).astype(np.int64)
    f = rng.normal(0, 100, cap)
    f[::11] = np.nan
    f[1::7] = -0.0
    pos = np.abs(f) + 1.0
    r = rng.normal(0, 10, cap).astype(np.float32)
    b = rng.random(cap) < 0.6
    dt = rng.integers(0, 9000, cap).astype(np.int32)
    d = RP.Dictionary(WORDS)
    codes = rng.integers(0, len(WORDS), cap).astype(np.int32)
    dec = rng.integers(-10**8, 10**8, cap).astype(np.int64)
    flt = rng.random(cap) < 0.7
    key = rng.integers(0, 20, cap).astype(np.int64)
    arrays = [key, i, f, r, b, dt, codes, dec, pos, flt]
    names = ["BIGINT", "BIGINT", "DOUBLE", "REAL", "BOOLEAN", "DATE",
             "VARCHAR", "DECIMAL_12_2", "DOUBLE", "BOOLEAN"]
    valids = [None] + [rng.random(cap) < 0.85 for _ in range(8)] + [None]
    dicts = [None] * 6 + [d, None, None, None]
    ref = RP.Page.from_numpy(arrays, [_type(RT, t) for t in names],
                             valids=valids, dictionaries=dicts)
    port = PP.Page.from_numpy(
        arrays, [_type(PT, t) for t in names], valids=valids,
        dictionaries=[None if x is None else PP.Dictionary(x.values)
                      for x in dicts], device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, torch.device("cpu"))))


AGGS = [  # name, input channel, type name, mask channel
    ("count", None, None, None), ("count", 1, "BIGINT", 9),
    ("sum", 1, "BIGINT", None), ("sum", 2, "DOUBLE", 9),
    ("sum", 3, "REAL", None), ("sum", 7, "DECIMAL_12_2", None),
    ("avg", 2, "DOUBLE", None), ("avg", 7, "DECIMAL_12_2", 9),
    ("min", 1, "BIGINT", None), ("max", 2, "DOUBLE", None),
    ("min", 3, "REAL", 9), ("max", 5, "DATE", None),
    ("min", 6, "VARCHAR", None), ("max", 4, "BOOLEAN", None),
    ("count_if", 4, "BOOLEAN", None), ("bool_and", 4, "BOOLEAN", None),
    ("bool_or", 4, "BOOLEAN", 9), ("geometric_mean", 8, "DOUBLE", None),
]


def _type(mod, name):
    if name is None:
        return None
    if name.startswith("DECIMAL"):
        _, p, s = name.split("_")
        return mod.DecimalType(int(p), int(s))
    return getattr(mod, name)


def test_agg_page_decimal_types_exist():
    assert _type(PT, "DECIMAL_12_2") == PT.DecimalType(12, 2)


@pytest.mark.parametrize("which", range(len(AGGS)))
def test_passthrough_partial_matches_reference(which):
    rp, pp = agg_page(seed=which)
    name, ch, tname, mask = AGGS[which]
    rspec = RA.AggSpec(name, ch, _type(RT, tname), mask)
    pspec = PA.AggSpec(name, ch, _type(PT, tname), mask)
    want = RA.passthrough_partial([0], [rspec])(rp)
    got = PA.passthrough_partial([0], [pspec])(pp)
    assert got.num_columns == want.num_columns
    assert_same_page(want, got)
    for rc, pc in zip(want.columns[1:], got.columns[1:]):
        assert (rc.dictionary is None) == (pc.dictionary is None)


def test_passthrough_partial_all_aggregates_in_one_page():
    """Every state of every aggregate at once: more than 8 state columns,
    so the kernel's launches come in groups."""
    rp, pp = agg_page(seed=99)
    rspecs = [RA.AggSpec(n, c, _type(RT, t), m) for n, c, t, m in AGGS]
    pspecs = [PA.AggSpec(n, c, _type(PT, t), m) for n, c, t, m in AGGS]
    want = RA.passthrough_partial([0, 6], rspecs)(rp)
    got = PA.passthrough_partial([0, 6], pspecs)(pp)
    assert got.num_columns == want.num_columns > 10
    assert_same_page(want, got)


def test_passthrough_partial_refuses_single_step_aggregates():
    for spec in (PA.AggSpec("sum", 1, PT.BIGINT, None, True),
                 PA.AggSpec("min_by", 1, PT.BIGINT, None, False, 2,
                            PT.DOUBLE)):
        with pytest.raises(NotImplementedError):
            PA.passthrough_partial([0], [spec])


# ---------------------------------------------- the query memory ledger


def test_memory_context_reserve_and_limit():
    """tests/test_memory.py's context case, on the port's ledger."""
    from trino_tpu_torch.exec.memory import (ExceededMemoryLimitError,
                                             QueryMemoryContext)
    ctx = QueryMemoryContext(1000)
    ctx.reserve(600, "join-build")
    ctx.reserve(300, "collect")
    assert ctx.reserved == 900 and ctx.peak == 900
    with pytest.raises(ExceededMemoryLimitError) as e:
        ctx.reserve(200, "sort")
    assert "Query exceeded per-node memory limit" in str(e.value)
    assert "sort" in str(e.value)
    ctx.free(600, "join-build")
    ctx.reserve(200, "sort")
    assert ctx.peak == 900 and ctx.close() == 500


def test_node_pool_accounting_and_overflow():
    """Two queries share a pool; a reservation past its limit fails the
    requester with the retryable CLUSTER_OUT_OF_MEMORY (the low-memory
    killer is ROADMAP A.6); close releases what a query leaked."""
    from trino_tpu_torch.exec.memory import (ClusterOutOfMemoryError,
                                             NodeMemoryPool,
                                             QueryMemoryContext)
    pool = NodeMemoryPool(limit_bytes=1000)
    a = QueryMemoryContext(None, query_id="qa", pool=pool)
    b = QueryMemoryContext(None, query_id="qb", pool=pool)
    a.reserve(400, "collect")
    b.reserve(500, "collect")
    assert pool.reserved == 900 and pool.peak == 900
    with pytest.raises(ClusterOutOfMemoryError) as e:
        b.reserve(200, "collect")
    assert e.value.retryable
    assert e.value.error_name == "CLUSTER_OUT_OF_MEMORY"
    assert b.reserved == 500
    a.free(400, "collect")
    assert pool.reserved == 500
    assert a.close() == 0
    assert b.close() == 500
    assert pool.reserved == 0


def test_runner_closes_each_query_ledger():
    """Every query's reservations end with it: the node pool reads 0
    after a join, a spilled join and a sort."""
    from trino_tpu_torch.exec import LocalQueryRunner
    from trino_tpu_torch.exec.memory import NODE_POOL
    runner = LocalQueryRunner.tpch("tiny", device="cpu")
    leaks = NODE_POOL.leaks
    runner.execute("SELECT o_orderkey, c_name FROM orders, customer WHERE "
                   "o_custkey = c_custkey ORDER BY o_orderkey LIMIT 5")
    runner.session.set("join_spill_threshold_bytes", 1024)
    runner.execute("SELECT count(*) FROM orders, customer WHERE "
                   "o_custkey = c_custkey")
    assert NODE_POOL.reserved == 0 and NODE_POOL.leaks == leaks
