"""trino_tpu_torch.ops.join against trino_tpu.ops.join on seeded pages (CPU).

The expanding probe (hash_join, K9's plain twins over K5's runs mode) runs
every kind (INNER over duplicate keys, LEFT, FULL with build_matched,
SEMI, ANTI and MARK with null_aware on and off) on both routes, single and
composite keys, with NULL keys on either side, a live key -1 on both
sides, an empty build, an all-dead probe, probe rows matching the first
key column only and NaN candidates that the composite check filters out;
its rows must equal the reference's in the reference's order, and K5's
runs the reference's (bkey_s, bperm) per key.

The build statistics (K5's plain twin: live rows, NULL keys, max_run, the
key min/max as unsigned 64-bit words), build_key_bounds, range_prefilter
(K1's range mode), unique_inner_probe on the dense and search routes (K6's
plain twin: found, build row, match count) and attach_build (K7's plain
twin) take the same numpy pages through both packages. Cases: NULL keys on
both sides, negative and full-range int64 keys, DOUBLE keys with -0.0 and
NaN, composite keys, an empty build, dead probe rows, probe keys outside the
build's span, and string keys across dictionaries. Everything compares
exactly: keys bit for bit as uint64, masks and rows as integers.
"""

import numpy as np
import pytest
import torch

from oracle import assert_same
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.ops import join as RJ
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.ops import join as PJ

torch.set_num_threads(1)
CPU = torch.device("cpu")


def pages(arrays, typs, valids, n, dicts=None):
    """The same columns as a reference page and a port page (CPU)."""
    dicts = dicts or [None] * len(arrays)
    ref = RP.Page.from_numpy(arrays, [getattr(RT, t) for t in typs],
                             valids=valids, dictionaries=dicts)
    port = PP.Page.from_numpy(
        arrays, [getattr(PT, t) for t in typs], valids=valids,
        dictionaries=[None if d is None else PP.Dictionary(d.values)
                      for d in dicts], device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, CPU)))


def build_keys_of(rng, kind, cap):
    """(key arrays, type names) of a build side of `cap` rows."""
    if kind in ("unique", "nulls", "empty"):
        return [rng.permutation(cap).astype(np.int64) * 3 + 7], ["BIGINT"]
    if kind == "negative":
        return [rng.choice(np.arange(-2**62, 2**62, 2**50), cap,
                           replace=False).astype(np.int64)], ["BIGINT"]
    if kind == "integer":
        return [rng.permutation(cap).astype(np.int32) - cap // 2], \
            ["INTEGER"]
    if kind == "double":
        v = rng.permutation(cap).astype(np.float64) - cap // 3
        v[0] = np.nan
        return [v], ["DOUBLE"]
    if kind == "duplicates":
        v = rng.integers(0, cap // 3, cap).astype(np.int64)
        return [v], ["BIGINT"]
    # composite: (INTEGER, BIGINT), unique as a pair only
    a = rng.integers(0, 5, cap).astype(np.int32)
    b = rng.permutation(cap).astype(np.int64) - 10
    return [a, b], ["INTEGER", "BIGINT"]


CASES = {  # kind -> (build cap, live build rows, probe cap, live probe rows)
    "unique": (64, 50, 100, 90),
    "nulls": (300, 280, 500, 480),
    "negative": (200, 200, 300, 300),
    "integer": (128, 100, 256, 256),
    "double": (100, 100, 150, 140),
    "composite": (256, 256, 400, 380),
    "empty": (16, 0, 40, 40),
    "duplicates": (90, 90, 60, 0),
}


def make_case(kind, seed=0):
    """(ref build, port build, ref probe, port probe, nkeys) of one case:
    a trailing BIGINT payload column on each side, probe keys drawn from
    the build keys (hits), shifted keys (misses, some past the span),
    NULLs where the case has them, and the probe's -0.0 for the build's
    +0.0 in the DOUBLE case."""
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    bcap, bn, pcap, pn = CASES[kind]
    keys, typs = build_keys_of(rng, kind, bcap)
    nulls = kind in ("nulls", "double", "composite")
    bvalid = [(rng.random(bcap) < 0.85) if nulls else None for _ in keys]
    payload = rng.integers(-10**6, 10**6, bcap).astype(np.int64)
    rb, pb = pages(keys + [payload], typs + ["BIGINT"], bvalid + [None], bn)
    pick = rng.integers(0, bcap, pcap)
    miss = rng.random(pcap) < 0.3
    pkeys = []
    for k in keys:
        v = k[pick].copy()
        if np.issubdtype(v.dtype, np.floating):
            v[miss] = v[miss] + 0.5
            v[v == 0] = -0.0
        else:
            v[miss] = v[miss] + (5 * bcap + 1 if kind != "composite"
                                 else 1)
        pkeys.append(v)
    pvalid = [(rng.random(pcap) < 0.9) if nulls else None for _ in keys]
    ppay = rng.integers(-10**6, 10**6, pcap).astype(np.int64)
    rp, pp = pages([ppay] + pkeys, ["BIGINT"] + typs, [None] + pvalid, pn)
    return rb, pb, rp, pp, len(keys)


def u64(x) -> int:
    return int(np.asarray(x).astype(np.uint64))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_key_u64_is_bit_identical(kind):
    rb, pb, rp, pp, nk = make_case(kind)
    for ref, port, chans in ((rb, pb, range(nk)),
                             (rp, pp, range(1, nk + 1))):
        rk, rn = RJ._key_u64(ref, list(chans))
        pk, pn = PJ._key_u64(port, list(chans))
        np.testing.assert_array_equal(np.asarray(rk).view(np.int64),
                                      pk.numpy())
        np.testing.assert_array_equal(np.asarray(rn), pn.numpy())


@pytest.mark.parametrize("kind", sorted(CASES))
def test_prepare_build_matches_reference(kind):
    rb, pb, _, _, nk = make_case(kind)
    ref = RJ.prepare_build(list(range(nk)))(rb)
    port = PJ.prepare_build(list(range(nk)))(pb)
    st = port.stats.tolist()
    assert st[PJ.N_LIVE] == int(ref[3])
    assert st[PJ.N_ROWS] == int(ref[4])
    assert st[PJ.HAS_NULL] == int(bool(ref[5]))
    # max_run counted independently over the live non-NULL keys
    key, null = PJ._key_u64(pb, list(range(nk)))
    live = (np.arange(pb.capacity) < int(pb.num_rows)) & ~null.numpy()
    _, counts = np.unique(key.numpy()[live], return_counts=True)
    assert st[PJ.MAX_RUN] == (counts.max() if len(counts) else 0)
    # the reference parks dead and NULL rows under the key u64::MAX, so a
    # live key -1 (u64::MAX as well) joins their run when any exist; its
    # max_run is then too large (ROADMAP C, reference defects) and routes
    # the join to the expanding probe, with the same rows
    sentinel = bool((key.numpy()[live] == -1).any()) and not live.all()
    if sentinel:
        assert int(ref[7]) > st[PJ.MAX_RUN]
    else:
        assert st[PJ.MAX_RUN] == int(ref[7])
    assert PJ.unsigned(st[PJ.KMIN]) == u64(ref[8])
    assert PJ.unsigned(st[PJ.KMAX]) == u64(ref[9])
    if kind == "duplicates":
        assert st[PJ.MAX_RUN] > 1


@pytest.mark.parametrize("kind", sorted(CASES))
def test_build_key_bounds_matches_reference(kind):
    rb, pb, _, _, nk = make_case(kind)
    rlo, rhi = RJ.build_key_bounds(list(range(nk)))(rb)
    prepared = PJ.prepare_build(list(range(nk)))(pb)
    plo, phi = PJ.build_key_bounds(list(range(nk)))(prepared)
    assert plo.dtype == pb.column(0).values.dtype == phi.dtype
    for r, p in ((rlo, plo), (rhi, phi)):
        r, p = np.asarray(r).item(), p.item()
        assert (r == p) or (r != r and p != p), (r, p)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_range_prefilter_matches_reference(kind):
    rb, pb, rp, pp, nk = make_case(kind)
    lo_hi = RJ.build_key_bounds(list(range(nk)))(rb)
    want = RJ.range_prefilter(1)(rp, *lo_hi)
    plo, phi = PJ.build_key_bounds(list(range(nk)))(
        PJ.prepare_build(list(range(nk)))(pb))
    got = PJ.range_prefilter(1)(pp, plo, phi)
    n = int(want.num_rows)
    assert int(got.num_rows) == n
    for rc, pc in zip(want.columns, got.columns):
        np.testing.assert_array_equal(np.asarray(rc.values)[:n],
                                      pc.values[:n].numpy())


def routes(kind):
    # the dense table needs a span the planner would accept: negative keys
    # are large unsigned words, so a span across zero is too wide
    return ["search"] if kind in ("negative", "integer", "composite",
                                  "double") else ["search", "dense"]


def ref_prepared(rb, nk, route):
    prepared = RJ.prepare_build(list(range(nk)))(rb)
    if route == "dense":
        kmin, kmax = u64(prepared[8]), u64(prepared[9])
        span = kmax - kmin + 1 if kmax >= kmin else 1
        size = 1 << max(10, (span - 1).bit_length())
        prepared = prepared + (RJ.build_dense_table(size)(
            prepared[1], prepared[3], prepared[8]),)
    return prepared


def port_prepared(pb, nk, route):
    prepared = PJ.prepare_build(list(range(nk)))(pb)
    if route == "dense":
        kmin = PJ.unsigned(int(prepared.stats[PJ.KMIN]))
        kmax = PJ.unsigned(int(prepared.stats[PJ.KMAX]))
        span = kmax - kmin + 1 if kmax >= kmin else 1
        size = 1 << max(10, (span - 1).bit_length())
        prepared = PJ.build_dense_table(size)(prepared)
    return prepared


PROBE_CASES = [(k, r) for k in sorted(CASES) if k != "duplicates"
               for r in routes(k)]


@pytest.mark.parametrize("kind,route", PROBE_CASES)
def test_unique_inner_probe_matches_reference(kind, route):
    rb, pb, rp, pp, nk = make_case(kind)
    pkeys, bkeys = list(range(1, nk + 1)), list(range(nk))
    rpre, rfound, rcount = RJ.unique_inner_probe(pkeys, bkeys, lookup=route)(
        rp, ref_prepared(rb, nk, route))
    ppre, pfound, pcount = PJ.unique_inner_probe(pkeys, bkeys, lookup=route)(
        pp, port_prepared(pb, nk, route))
    np.testing.assert_array_equal(np.asarray(rfound), pfound.numpy())
    assert int(rcount) == int(pcount)
    assert ppre.num_columns == rpre.num_columns == pp.num_columns + 1
    np.testing.assert_array_equal(np.asarray(rpre.columns[-1].values),
                                  ppre.columns[-1].values.numpy())
    if kind in ("unique", "nulls"):
        assert 0 < int(pcount) < int(pp.num_rows)


@pytest.mark.parametrize("kind", ["unique", "nulls", "composite",
                                  "double"])
def test_attach_build_matches_reference(kind):
    rb, pb, rp, pp, nk = make_case(kind)
    pkeys, bkeys = list(range(1, nk + 1)), list(range(nk))
    rprep, pprep = ref_prepared(rb, nk, "search"), \
        port_prepared(pb, nk, "search")
    rpre, rfound, _ = RJ.unique_inner_probe(pkeys, bkeys, probe_out=[0])(
        rp, rprep)
    ppre, pfound, _ = PJ.unique_inner_probe(pkeys, bkeys, probe_out=[0])(
        pp, pprep)
    rcomp = rpre.filter(rfound)
    pcomp = ppre.filter(pfound)
    want = RJ.attach_build(1, build_out=[nk, 0])(rcomp, rprep)
    got = PJ.attach_build(1, build_out=[nk, 0])(pcomp, pprep)
    n = int(want.num_rows)
    assert int(got.num_rows) == n and got.num_columns == 3
    for rc, pc in zip(want.columns, got.columns):
        np.testing.assert_array_equal(np.asarray(rc.values)[:n],
                                      pc.values[:n].numpy())
        if rc.valid is not None:
            np.testing.assert_array_equal(np.asarray(rc.valid)[:n],
                                          pc.valid[:n].numpy())


def test_string_keys_need_one_dictionary():
    """Across distinct dictionaries both packages refuse to compare codes
    (the executor re-encodes the probe first); one shared pool joins."""
    words = np.array(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)
    other = np.array(["AIR", "RAIL", "TRUCK"], dtype=object)
    rd, rd2 = RP.Dictionary(words), RP.Dictionary(other)
    rb, pb = pages([rd.encode(words)], ["VARCHAR"], [None], 4, [rd])
    rp, pp = pages([rd2.encode(other)], ["VARCHAR"], [None], 3, [rd2])
    for J, b, p in ((RJ, rb, rp), (PJ, pb, pp)):
        with pytest.raises(NotImplementedError):
            J.unique_inner_probe([0], [0])(p, J.prepare_build([0])(b))
    rp, pp = pages([rd.encode(np.array(["SHIP", "AIR", "SHIP"],
                                       dtype=object))], ["VARCHAR"], [None],
                   3, [rd])
    _, rfound, rc = RJ.unique_inner_probe([0], [0])(
        rp, RJ.prepare_build([0])(rb))
    _, pfound, pc = PJ.unique_inner_probe([0], [0])(
        pp, PJ.prepare_build([0])(pb))
    np.testing.assert_array_equal(np.asarray(rfound), pfound.numpy())
    assert int(rc) == int(pc) == 3


def test_expanding_probe_names_its_roadmap_item():
    """Every join kind runs on the reference's three lookups (the
    matrix-unit one since its lookup half was ported); another name is
    refused."""
    for lookup in ("search", "dense", "mxu"):
        assert PJ.hash_join([0], [0], PJ.JoinType.LEFT,
                            lookup=lookup).lookup == lookup
    with pytest.raises(ValueError, match="matmul"):
        PJ.hash_join([0], [0], PJ.JoinType.LEFT, lookup="matmul")


# ------------------------------------------------ the expanding probe (K9)

# case -> (build cap, live build rows, probe cap, live probe rows)
JCASES = {
    "dups": (90, 80, 120, 110),          # duplicate keys, NULLs both sides
    "clean": (64, 60, 100, 96),          # duplicates, no NULL build key
    "minus_one": (70, 66, 80, 75),       # a live key -1 on both sides
    "composite": (128, 120, 160, 150),   # (INTEGER, BIGINT), dup pairs
    "nan_composite": (60, 60, 80, 80),   # NaN candidates all filtered out
    "empty": (16, 0, 40, 36),            # no live build row
    "dead_probe": (40, 40, 64, 0),       # no live probe row
}


def jcase(name, seed=0):
    """(ref build, port build, ref probe, port probe, nkeys): key columns
    first on the build side and after a BIGINT payload on the probe side;
    build payloads are BIGINT (NULL on a tenth of the rows)."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    bcap, bn, pcap, pn = JCASES[name]
    pick = rng.integers(0, bcap, pcap)
    miss = rng.random(pcap) < 0.25
    if name in ("composite", "nan_composite"):
        if name == "composite":
            a = rng.integers(0, 5, bcap).astype(np.int32)
            typs = ["INTEGER", "BIGINT"]
        else:
            a = rng.integers(0, 4, bcap).astype(np.float64)
            a[::3] = np.nan
            a[1::5] = 0.0
            typs = ["DOUBLE", "BIGINT"]
        b = rng.integers(0, 12, bcap).astype(np.int64)
        bkeys = [a, b]
        pa, pb_ = a[pick].copy(), b[pick].copy()
        pb_[miss] += 100                  # matches on the first column only
        if name == "nan_composite":
            pa[pa == 0] = -0.0
        pkeys = [pa, pb_]
        bvalid = [None, rng.random(bcap) < 0.9]
        pvalid = [rng.random(pcap) < 0.9, None]
    else:
        k = rng.integers(0, bcap // 3, bcap).astype(np.int64)
        if name == "minus_one":
            k[::4] = -1
        bkeys, typs = [k], ["BIGINT"]
        pk = k[pick].copy()
        pk[miss] += 1000
        pkeys = [pk]
        bvalid = [None if name == "clean" else rng.random(bcap) < 0.85]
        pvalid = [rng.random(pcap) < 0.9]
    bpay = rng.integers(-10**6, 10**6, bcap).astype(np.int64)
    ppay = rng.integers(-10**6, 10**6, pcap).astype(np.int64)
    rb, pb = pages(bkeys + [bpay], typs + ["BIGINT"],
                   bvalid + [rng.random(bcap) < 0.9], bn)
    rp, pp = pages([ppay] + pkeys, ["BIGINT"] + typs, [None] + pvalid, pn)
    return rb, pb, rp, pp, len(bkeys)


def jroutes(name):
    # a key -1 is u64::MAX, and a NaN or composite key a mixed word: their
    # spans are far too wide for a direct-address table
    return ["search"] if name in ("minus_one", "composite", "nan_composite") \
        else ["search", "dense"]


def port_runs(pb, nk, route):
    prepared = PJ.prepare_build(list(range(nk)))(pb)
    size = 0
    if route == "dense":
        kmin = PJ.unsigned(int(prepared.stats[PJ.KMIN]))
        kmax = PJ.unsigned(int(prepared.stats[PJ.KMAX]))
        span = kmax - kmin + 1 if kmax >= kmin else 1
        size = 1 << max(10, (span - 1).bit_length())
    return PJ.prepare_runs(size)(prepared)


K = PJ.JoinType
KINDS = [(K.INNER, True), (K.LEFT, True), (K.FULL, True),
         (K.SEMI, True), (K.SEMI, False), (K.ANTI, True), (K.ANTI, False),
         (K.MARK, True), (K.MARK, False)]
HJ_CASES = [(c, r, k, na) for c in sorted(JCASES) for r in jroutes(c)
            for k, na in KINDS]


def live_rows(page):
    return page.to_pylist()


@pytest.mark.parametrize("case,route,kind,null_aware", HJ_CASES)
def test_hash_join_matches_reference(case, route, kind, null_aware):
    """Rows in the reference's order (probe rows in order, each key's
    build rows ascending); FULL's build_matched mask exactly."""
    rb, pb, rp, pp, nk = jcase(case)
    pkeys, bkeys = list(range(1, nk + 1)), list(range(nk))
    port = PJ.hash_join(pkeys, bkeys, kind, null_aware=null_aware,
                        lookup=route)(pp, port_runs(pb, nk, route))
    total = int(port[1])
    # a capacity past every candidate expansion: the reference's total is
    # then exact (below it, the candidate count, its re-run signal)
    bound = pp.capacity * max(pb.capacity, 1)
    ref = RJ.hash_join(pkeys, bkeys, kind, null_aware=null_aware,
                       lookup=route, prepared=True,
                       output_capacity=1 << (bound - 1).bit_length())(
        rp, ref_prepared(rb, nk, route))
    assert int(ref[1]) == total
    assert_same(live_rows(port[0]), live_rows(ref[0]), True)
    if kind == K.FULL:
        np.testing.assert_array_equal(np.asarray(ref[2]), port[2].numpy())
    if case in ("dups", "clean", "composite") and kind == K.INNER:
        assert 0 < total and int(port[0].num_rows) == total
    if case == "nan_composite" and kind == K.LEFT:
        # a NaN key finds candidates under its mixed word, every one fails
        # the column check, and the row null-extends
        nan_rows = [r for r in live_rows(port[0])
                    if isinstance(r[1], float) and r[1] != r[1]]
        assert nan_rows and all(r[3] is None for r in nan_rows)


@pytest.mark.parametrize("case", sorted(JCASES))
def test_runs_mode_matches_reference(case):
    """K5's runs mode holds each live key's build rows, ascending, as the
    reference's (bkey_s, bperm, run_len) do."""
    rb, pb, _, _, nk = jcase(case)
    ref = RJ.prepare_build(list(range(nk)))(rb)
    n_live = int(ref[3])
    want = {}
    for key, row in zip(np.asarray(ref[1])[:n_live].tolist(),
                        np.asarray(ref[2])[:n_live].tolist()):
        want.setdefault(key, []).append(row)
    prepared = port_runs(pb, nk, "search")
    runs, starts, counts = (t.tolist() for t in prepared.runs)
    skeys = [PJ.unsigned(k) for k in prepared.lookup[1].tolist()]
    got = {k: runs[s:s + c] for k, s, c in zip(skeys, starts, counts)}
    assert got == {k: sorted(v) for k, v in want.items()}
    assert all(v == sorted(v) for v in got.values())
    assert sum(counts) == n_live
    if case in ("dups", "minus_one"):
        assert max(counts) > 1


def test_unmatched_build_page_matches_reference():
    rb, pb, rp, pp, nk = jcase("dups")
    matched = np.random.default_rng(5).random(rb.capacity) < 0.5
    meta = [(RT.BIGINT, None), (RT.VARCHAR, RP.Dictionary(
        np.array(["x"], dtype=object)))]
    want = RJ.unmatched_build_page(meta)(rb, matched)
    got = PJ.unmatched_build_page(
        [(PT.BIGINT, None), (PT.VARCHAR, PP.Dictionary(
            np.array(["x"], dtype=object)))])(pb, torch.from_numpy(matched))
    assert_same(live_rows(got), live_rows(want), True)
    assert got.columns[1].dictionary.values.tolist() == ["x"]
