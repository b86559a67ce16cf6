"""The port's collective exchanges (B12: K35, K36 and the K2 receive)
against the reference's under shard_map on the 8 virtual CPU devices.

The same seeded pages go through trino_tpu.parallel under jax.jit of
QueryMesh.shard_map and through trino_tpu_torch.parallel over
QueryMesh(["cpu"] * 8): every shard's received rows (in order, with
their validity), its capacity, the overflow at a small bucket, the heavy
set (ties included), the replicate and broadcast/gather forms. Keys cover
NULL, dead rows, -1, NaN, -0.0, bool, dictionary and composite keys.
"""

import jax
import numpy as np
import pytest
import torch

from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.parallel import QueryMesh as RefMesh
from trino_tpu.parallel import exchange as RX
from trino_tpu_torch import page as P
from trino_tpu_torch import types as T
from trino_tpu_torch.parallel import QueryMesh
from trino_tpu_torch.parallel import exchange as X

torch.set_num_threads(1)

N = 8
pytestmark = pytest.mark.skipif(len(jax.devices()) < N,
                                reason="needs the 8-device CPU mesh")

_TYPES = {"i64": (RT.BIGINT, T.BIGINT), "f64": (RT.DOUBLE, T.DOUBLE),
          "i32": (RT.INTEGER, T.INTEGER), "bool": (RT.BOOLEAN, T.BOOLEAN),
          "str": (RT.VARCHAR, T.VARCHAR)}


def shard_arrays(seed, cap, kinds, key_mod=40, hot=None, hot_frac=0.0,
                 null_frac=0.1, live=None):
    """Per shard: (arrays per column, valids, live rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(N):
        n = int(rng.integers(0, cap + 1)) if live is None else live[s]
        cols, valids = [], []
        for kind in kinds:
            if kind == "i64":
                a = rng.integers(-3, key_mod, cap).astype(np.int64)
                if hot is not None:
                    a[: int(cap * hot_frac)] = hot
                a[rng.random(cap) < 0.05] = -1
            elif kind == "i32":
                a = rng.integers(0, key_mod, cap).astype(np.int32)
            elif kind == "f64":
                a = rng.integers(-4, 6, cap).astype(np.float64) / 2
                a[rng.random(cap) < 0.1] = -0.0
                a[rng.random(cap) < 0.05] = np.nan
            elif kind == "bool":
                a = rng.random(cap) < 0.5
            else:
                a = np.array([f"k{v}" for v in rng.integers(0, 12, cap)],
                             dtype=object)
            cols.append(a)
            valids.append(rng.random(cap) >= null_frac if null_frac
                          else None)
        out.append((cols, valids, n))
    return out


def ref_pages(data, kinds):
    """The reference's pages of `data`. A -0.0 goes in as +0.0: under jit
    XLA folds the reference's `x + 0.0` away, so its exchange hashes -0.0
    apart from +0.0, while K35 (as K5) hashes them as one key, the SQL
    equality (ROADMAP C)."""
    from trino_tpu.page import Dictionary as RD
    pages = []
    for cols, valids, n in data:
        rc = []
        for a, v, kind in zip(cols, valids, kinds):
            typ = _TYPES[kind][0]
            if kind == "f64":
                a = np.where(a == 0, 0.0, a)
            if kind == "str":
                d = RD(np.unique(np.array(["k%d" % i for i in range(12)],
                                          dtype=object)))
                rc.append(RP.Column.from_numpy(d.encode(a), typ, v, d))
            else:
                rc.append(RP.Column.from_numpy(a, typ, v))
        pages.append(RP.Page(tuple(rc), n))
    return pages


def port_pages(data, kinds):
    from trino_tpu_torch.page import Dictionary
    d = Dictionary(np.unique(np.array(["k%d" % i for i in range(12)],
                                      dtype=object)))
    pages = []
    for cols, valids, n in data:
        pc = []
        for a, v, kind in zip(cols, valids, kinds):
            typ = _TYPES[kind][1]
            if kind == "str":
                pc.append(P.Column.from_numpy(d.encode(a), typ, v, d,
                                              device="cpu"))
            else:
                pc.append(P.Column.from_numpy(a, typ, v, device="cpu"))
        pages.append(P.Page(tuple(pc), P.row_count(n, "cpu")))
    return pages


def run_ref(pages, fn):
    mesh = RefMesh()
    out = jax.jit(mesh.shard_map(fn))(mesh.shard_pages(pages))
    return jax.device_get(out)


def same_values(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.int64), b.view(np.int64)) or \
            np.array_equal(a, b, equal_nan=True), label
    else:
        assert np.array_equal(a, b), (label, a[:10], b[:10])


def assert_shards_equal(ref_page, port_pages_out, label):
    for s in range(N):
        n = int(ref_page.num_rows[s])
        got = port_pages_out[s]
        assert int(got.num_rows) == n, (label, s)
        assert got.capacity == ref_page.columns[0].values[s].shape[0], \
            (label, s, got.capacity)
        for ci, (rc, pc) in enumerate(zip(ref_page.columns, got.columns)):
            want = np.asarray(rc.values[s])[:n]
            have = pc.values[:n].numpy()
            if rc.valid is None:
                assert pc.valid is None, (label, s, ci)
                same_values(have, want, (label, s, ci))
            else:
                rv = np.asarray(rc.valid[s])[:n]
                pv = pc.valid_mask()[:n].numpy()
                assert np.array_equal(pv, rv), (label, s, ci)
                # values under NULL are don't-cares in both engines
                same_values(np.where(rv, have, 0), np.where(rv, want, 0),
                            (label, s, ci))


CASES = {  # label -> (kinds, key channels, cap, seed)
    "bigint": (("i64", "i32"), (0,), 256, 1),
    "double": (("f64", "i64"), (0,), 256, 2),
    "bool": (("bool", "i64"), (0,), 128, 3),
    "dictionary": (("str", "f64"), (0,), 256, 4),
    "composite": (("i32", "str", "i64"), (0, 1), 256, 5),
}


@pytest.mark.parametrize("label", list(CASES))
def test_repartition_per_shard_rows(label):
    kinds, keys, cap, seed = CASES[label]
    data = shard_arrays(seed, cap, kinds)
    bucket = 2 * cap

    ref = run_ref(ref_pages(data, kinds),
                  lambda p: RX.all_to_all_by_key(p, list(keys), bucket))
    got, overflow = X.all_to_all_by_key(
        QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds)),
        list(keys), bucket)
    assert overflow == int(np.max(ref[1])) == 0
    assert_shards_equal(ref[0], got, label)


def test_repartition_overflow_at_small_bucket():
    kinds = ("i64", "i32")
    data = shard_arrays(6, 256, kinds, key_mod=3, null_frac=0.0,
                        live=[256] * N)
    ref = run_ref(ref_pages(data, kinds),
                  lambda p: RX.all_to_all_by_key(p, [0], 16))
    got, overflow = X.all_to_all_by_key(
        QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds)), [0], 16)
    assert overflow == int(np.max(ref[1])) > 0
    assert_shards_equal(ref[0], got, "overflow")


def test_empty_shards_and_one_destination():
    """Empty shards and a shard whose every row has one key."""
    kinds = ("i64", "i32")
    live = [0, 64, 0, 64, 64, 0, 64, 64]
    data = shard_arrays(7, 64, kinds, null_frac=0.0, live=live)
    data[1][0][0][:] = 42
    ref = run_ref(ref_pages(data, kinds),
                  lambda p: RX.all_to_all_by_key(p, [0], 1024))
    got, _ = X.all_to_all_by_key(
        QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds)), [0],
        1024)
    assert_shards_equal(ref[0], got, "empty")


HEAVY_CASES = {  # label -> (hot key, hot share, k, threshold)
    "one_hot": (7, 0.6, 8, 64),
    "none": (None, 0.0, 8, 100000),
    "ties": (None, 0.0, 3, 1),
    "k_keys": (None, 0.0, 8, 20),
}


@pytest.mark.parametrize("label", list(HEAVY_CASES))
def test_heavy_keys_and_spread(label):
    hot, frac, k, threshold = HEAVY_CASES[label]
    kinds = ("i64", "i32")
    data = shard_arrays(8, 256, kinds, key_mod=12, hot=hot, hot_frac=frac,
                        null_frac=0.05)

    def stage(p):
        heavy = RX.detect_heavy_keys(p, [0], k, threshold)
        out, ovf = RX.all_to_all_by_key(p, [0], 512, heavy=heavy)
        return out, ovf, heavy

    ref_out, ref_ovf, ref_heavy = run_ref(ref_pages(data, kinds), stage)
    pages = QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds))
    heavy = X.detect_heavy_keys(pages, [0], k, threshold)
    want = np.asarray(ref_heavy)[0].astype(np.uint64).view(np.int64)
    for h in heavy:
        assert np.array_equal(h.numpy(), want), (h, want)
    if label == "one_hot":
        assert 7 in want
    if label == "none":
        assert (want == -1).all()
    got, ovf = X.all_to_all_by_key(pages, [0], 512, heavy=heavy)
    assert ovf == int(np.max(ref_ovf))
    assert_shards_equal(ref_out, got, label)


def test_replicate_heavy_build_rows():
    kinds = ("i64", "i32")
    data = shard_arrays(9, 64, kinds, key_mod=30, hot=7, hot_frac=0.2,
                        null_frac=0.1)
    hv = np.full(8, -1, dtype=np.int64)
    hv[:2] = [7, 11]
    import jax.numpy as jnp
    rheavy = jnp.asarray(hv.view(np.uint64))
    ref = run_ref(ref_pages(data, kinds),
                  lambda p: RX.all_to_all_replicate(p, [0], 256, rheavy))
    pages = QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds))
    got, ovf = X.all_to_all_replicate(pages, [0], 256,
                                      [torch.from_numpy(hv)] * N)
    assert ovf == int(np.max(ref[1])) == 0
    assert_shards_equal(ref[0], got, "replicate")
    # a small bucket overflows as the reference's does
    ref = run_ref(ref_pages(data, kinds),
                  lambda p: RX.all_to_all_replicate(p, [0], 8, rheavy))
    got, ovf = X.all_to_all_replicate(pages, [0], 8,
                                      [torch.from_numpy(hv)] * N)
    assert ovf == int(np.max(ref[1])) > 0
    assert_shards_equal(ref[0], got, "replicate-overflow")


@pytest.mark.parametrize("fn", ["broadcast_page", "gather_page"])
def test_broadcast_and_gather(fn):
    kinds = ("i64", "f64", "str")
    data = shard_arrays(10, 64, kinds)
    ref = run_ref(ref_pages(data, kinds), lambda p: getattr(RX, fn)(p))
    got = getattr(X, fn)(
        QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds)))
    assert_shards_equal(ref, got, fn)
    assert all(g is got[0] for g in got)   # one replica per device


def test_bucket_from_counts():
    """A callable bucket gets the largest source -> destination count
    before any row moves (the capacity ladder in one fetch)."""
    kinds = ("i64", "i32")
    data = shard_arrays(11, 256, kinds, key_mod=3, null_frac=0.0,
                        live=[256] * N)
    pages = QueryMesh(["cpu"] * N).shard_pages(port_pages(data, kinds))
    seen = []

    def ladder(largest):
        seen.append(largest)
        return max(largest, 1)
    got, overflow = X.all_to_all_by_key(pages, [0], ladder)
    assert overflow == 0 and seen and seen[0] > 0
    assert sum(int(p.num_rows) for p in got) == 256 * N
    assert got[0].capacity == N * seen[0]


@pytest.mark.parametrize("mode", [X.MODE_HASH, X.MODE_SPREAD,
                                  X.MODE_REPLICATE])
def test_k35_wrapper_cpu_path_is_its_twin(mode):
    kinds = ("i64", "f64")
    data = shard_arrays(12, 128, kinds)
    page = port_pages(data, kinds)[3]
    heavy = torch.tensor([5, -1, 7], dtype=torch.int64)
    cols = X.key_columns(page, [0, 1])
    state, counts = X.exchange_count(cols, page.num_rows, N, mode, heavy)
    dest, want = X.exchange_count_plain(cols, page.num_rows, N, mode, heavy)
    assert torch.equal(state, dest) and torch.equal(counts, want)
    arrays = X._moved_arrays(page)
    for a, b in zip(X.exchange_scatter(state, arrays, N, 32),
                    X.exchange_scatter_plain(dest, arrays, N, 32)):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float64
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.float64 else b)


def test_k36_wrapper_cpu_path_is_its_twin():
    g = torch.Generator().manual_seed(13)
    words = torch.randint(-2, 9, (512,), generator=g, dtype=torch.int64)
    s = X._sorted_words(words)
    for k in (1, 3, 8):
        c1, k1 = X.heavy_local(s, k)
        c2, k2 = X.heavy_local_plain(s, k)
        assert torch.equal(c1, c2) and torch.equal(k1, k2)
        keys = torch.cat([k1, k2.flip(0)])
        counts = torch.cat([c1, c2.flip(0)])
        assert torch.equal(X.heavy_merge(keys, counts, k, 5),
                           X.heavy_merge_plain(keys, counts, k, 5))
