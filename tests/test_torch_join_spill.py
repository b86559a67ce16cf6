"""The spilled join's device functions (K16, K17 and K5's dense mode with
a payload, through their plain twins) and the host attach, against
trino_tpu.ops.join on the same seeded numpy pages (CPU).

prepare_build_spilled: the sorted masked keys bit for bit as uint64, the
live count, live rows, has-NULL, is-unique and the unsigned key min/max
exactly, and the permutation over the live prefix of a unique build (the
reference's two-key sort is not stable, so that is where it is defined).
build_dense_table_rows, spilled_dense_probe and spilled_unique_probe:
tables, found masks, build rows and counts exactly (the search probe fed
the reference's own sorted keys and permutation, so every row compares).
attach_build_host: the joined rows, composite keys re-checked on the
host. Cases: NULL keys, a live key of -1, dead rows, full-range int64
keys (a span past 2^28), DOUBLE keys with NaN and -0.0, INTEGER keys,
composite keys, duplicates, an empty build and probe keys outside the
build's span.
"""

import numpy as np
import pytest
import torch

from test_torch_join import build_keys_of, pages, u64
from trino_tpu.ops import join as RJ
from trino_tpu_torch.ops import join as PJ

torch.set_num_threads(1)

CASES = {  # kind -> (build cap, live build rows, probe cap, live rows)
    "unique": (64, 50, 100, 90),
    "nulls": (300, 280, 500, 480),
    "negative": (200, 200, 300, 300),
    "integer": (128, 100, 256, 256),
    "double": (100, 100, 150, 140),
    "composite": (256, 256, 400, 380),
    "empty": (16, 0, 40, 40),
    "duplicates": (90, 90, 60, 50),
    "minus1": (128, 120, 200, 200),
}


def make_case(kind, seed=0):
    """(ref build, port build, ref probe, port probe, nkeys): a payload
    column after the build keys and before the probe keys; probe keys
    drawn from the build (hits) and shifted past it (misses)."""
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    bcap, bn, pcap, pn = CASES[kind]
    if kind == "minus1":
        keys, typs = [rng.permutation(bcap).astype(np.int64) - 1], \
            ["BIGINT"]
    else:
        keys, typs = build_keys_of(rng, kind, bcap)
    nulls = kind in ("nulls", "double", "composite", "minus1")
    bvalid = [(rng.random(bcap) < 0.85) if nulls else None for _ in keys]
    if kind == "minus1":
        bvalid[0][np.flatnonzero(keys[0] == -1)] = True
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


def both_prepared(kind):
    rb, pb, rp, pp, nk = make_case(kind)
    bkeys = list(range(nk))
    ref = RJ.prepare_build_spilled(bkeys)(rb)
    port = PJ.prepare_build_spilled(bkeys)(pb)
    return rb, pb, rp, pp, nk, ref, port


@pytest.mark.parametrize("kind", sorted(CASES))
def test_prepare_build_spilled_matches_reference(kind):
    *_, ref, port = both_prepared(kind)
    bkey_s, bperm, n_live, n_rows, has_null, is_unique, kmin, kmax = ref
    keys, perm, stats = port
    np.testing.assert_array_equal(np.asarray(bkey_s).view(np.int64),
                                  keys.numpy())
    st = stats.tolist()
    assert st[PJ.N_LIVE] == int(n_live)
    assert st[PJ.N_ROWS] == int(n_rows)
    assert st[PJ.HAS_NULL] == int(bool(has_null))
    assert st[PJ.SPILL_UNIQUE] == int(bool(is_unique))
    assert PJ.unsigned(st[PJ.KMIN]) == u64(kmin)
    assert PJ.unsigned(st[PJ.KMAX]) == u64(kmax)
    if bool(is_unique):
        nl = int(n_live)
        np.testing.assert_array_equal(np.asarray(bperm)[:nl],
                                      perm[:nl].numpy())
    if kind == "duplicates":
        assert not bool(is_unique)
    if kind == "minus1":
        # the live -1 sorts before the rows masked to the same word
        assert st[PJ.KMAX] == -1 and keys[st[PJ.N_LIVE] - 1] == -1


def dense_size(stats):
    span = PJ.unsigned(stats[PJ.KMAX]) - PJ.unsigned(stats[PJ.KMIN]) + 1
    return 1 << max(10, (span - 1).bit_length())


# kinds whose unsigned key span fits a dense table (negative keys wrap)
DENSE_KINDS = ["unique", "nulls", "duplicates"]


@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_build_dense_table_rows_matches_reference(kind):
    *_, ref, port = both_prepared(kind)
    keys, perm, stats = port
    size = dense_size(stats.tolist())
    # the reference's permutation wherever it differs: one table input
    rtable = RJ.build_dense_table_rows(size)(ref[0], ref[1], ref[2], ref[6])
    ptable = PJ.build_dense_table_rows(size)(
        keys, torch.from_numpy(np.asarray(ref[1]).astype(np.int32)), stats)
    np.testing.assert_array_equal(np.asarray(rtable), ptable.numpy())


@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_spilled_dense_probe_matches_reference(kind):
    rb, pb, rp, pp, nk, ref, port = both_prepared(kind)
    keys, perm, stats = port
    size = dense_size(stats.tolist())
    rtable = RJ.build_dense_table_rows(size)(ref[0], ref[1], ref[2], ref[6])
    ptable = PJ.build_dense_table_rows(size)(
        keys, torch.from_numpy(np.asarray(ref[1]).astype(np.int32)), stats)
    pkeys = list(range(1, nk + 1))
    rpre, rfound, rcount = RJ.spilled_dense_probe(pkeys, probe_out=[0])(
        rp, rtable, ref[6])
    ppre, pfound, pcount = PJ.spilled_dense_probe(pkeys, probe_out=[0])(
        pp, ptable, stats)
    np.testing.assert_array_equal(np.asarray(rfound), pfound.numpy())
    assert int(rcount) == int(pcount)
    for rc, pc in zip(rpre.columns, ppre.columns):
        np.testing.assert_array_equal(np.asarray(rc.values),
                                      pc.values.numpy())


@pytest.mark.parametrize("kind", sorted(CASES))
def test_spilled_unique_probe_matches_reference(kind):
    rb, pb, rp, pp, nk, ref, port = both_prepared(kind)
    _, _, stats = port
    pkeys = list(range(1, nk + 1))
    rpre, rfound, rcount = RJ.spilled_unique_probe(pkeys, probe_out=[0])(
        rp, ref[0], ref[1], ref[2])
    keys = torch.from_numpy(np.asarray(ref[0]).view(np.int64).copy())
    perm = torch.from_numpy(np.asarray(ref[1]).astype(np.int32))
    ppre, pfound, pcount = PJ.spilled_unique_probe(pkeys, probe_out=[0])(
        pp, keys, perm, stats)
    np.testing.assert_array_equal(np.asarray(rfound), pfound.numpy())
    assert int(rcount) == int(pcount)
    for rc, pc in zip(rpre.columns, ppre.columns):
        np.testing.assert_array_equal(np.asarray(rc.values),
                                      pc.values.numpy())


def test_spilled_dense_probe_key_outside_span():
    """Probe keys below kmin (a huge unsigned difference) and past the
    table miss; NULL and dead probe rows never match."""
    rb, pb, rp, pp, nk, ref, port = both_prepared("unique")
    keys, perm, stats = port
    size = dense_size(stats.tolist())
    table = PJ.build_dense_table_rows(size)(keys, perm, stats)
    kmin = PJ.unsigned(stats[PJ.KMIN].item())
    probe = torch.tensor([kmin - 1, kmin + size, kmin, -5], dtype=torch.int64)
    found, brow, count = PJ.spill_probe_plain(
        [(probe, torch.tensor([True, True, True, False]))],
        torch.tensor(4, dtype=torch.int32), PJ.SPILL_DENSE, table, stats)
    assert found.tolist() == [False, False, True, False]
    assert int(count) == 1 and brow[0] == 0 and brow[1] == 0


@pytest.mark.parametrize("kind", ["unique", "nulls", "composite", "double",
                                  "negative"])
def test_attach_build_host_matches_reference(kind):
    rb, pb, rp, pp, nk, ref, port = both_prepared(kind)
    pkeys = list(range(1, nk + 1))
    keys = torch.from_numpy(np.asarray(ref[0]).view(np.int64).copy())
    perm = torch.from_numpy(np.asarray(ref[1]).astype(np.int32))
    probe_out = [0] + pkeys
    rpre, rfound, _ = RJ.spilled_unique_probe(pkeys, probe_out=probe_out)(
        rp, ref[0], ref[1], ref[2])
    ppre, pfound, _ = PJ.spilled_unique_probe(pkeys, probe_out=probe_out)(
        pp, keys, perm, port[2])
    rpre, ppre = rpre.filter(rfound), ppre.filter(pfound)
    n_rows = int(ref[3])
    host_idx = [nk] + list(range(nk))      # payload, then the key columns
    rhost, phost = [], []
    for ci in host_idx:
        rc, pc = rb.columns[ci], pb.columns[ci]
        rv = np.asarray(rc.values)[:n_rows]
        rm = None if rc.valid is None else np.asarray(rc.valid)[:n_rows]
        rhost.append((rv, rm, rc.type, rc.dictionary))
        phost.append((pc.values[:n_rows].clone(),
                      None if pc.valid is None else pc.valid[:n_rows].clone(),
                      pc.type, pc.dictionary))
    verify = [(1 + j, 1 + j) for j in range(nk)] if nk > 1 else None
    want = RJ.attach_build_host(rpre, len(probe_out), rhost, verify=verify,
                                emit=[0])
    got = PJ.attach_build_host(ppre, len(probe_out), phost, verify=verify,
                               emit=[0])
    n = int(want.num_rows)
    assert int(got.num_rows) == n and got.num_columns == want.num_columns
    for rc, pc in zip(want.columns, got.columns):
        np.testing.assert_array_equal(np.asarray(rc.values)[:n],
                                      pc.values[:n].numpy())
        if rc.valid is not None:
            np.testing.assert_array_equal(np.asarray(rc.valid)[:n],
                                          pc.valid[:n].numpy())
