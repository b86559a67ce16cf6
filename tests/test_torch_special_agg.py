"""The special aggregates' twins (K28-K31) against trino_tpu (CPU).

Each special aggregate runs through hash_aggregate(..., Step.SINGLE) in
both packages over seeded pages: NULL keys and values, NaN, -0.0, +-inf,
ties at the y-extremum and at the picked rank, duplicate keys, a FILTER
with NULLs, dead padding rows, an empty page, one group and a page of
2^16 rows in 2^15 groups. On the CPU the port's hash_aggregate runs K28's
twin for the group ids (K8's plain grouping), then the twins of K29-K31.
Groups compare as multisets: integers, codes, dates, decimals, the
positional picks, approx_distinct, approx_percentile and checksum exactly;
the centered moments to 1e-9 relative with an absolute floor of 1e-9 (a
corr or covar near zero has no meaningful relative bound; the two sum in
the same row order here, so they agree to a few ulps). K29's hash is held
bit for bit against the reference's _hash64 over every column dtype
(negative narrow integers are sign-extended, as the reference's cast
does), and the refusals raise the reference's text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.ops import aggregate as RA
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.ops import aggregate as PA

torch.set_num_threads(1)

COLS = ["k1", "grp", "fgrp", "big", "dec", "dbl", "day", "flag", "tiny",
        "small", "int", "real", "name", "p", "f", "tie"]
TYPES = {"k1": "VARCHAR", "grp": "BIGINT", "fgrp": "DOUBLE",
         "big": "BIGINT", "dec": ("DecimalType", 12, 2), "dbl": "DOUBLE",
         "day": "DATE", "flag": "BOOLEAN", "tiny": "TINYINT",
         "small": "SMALLINT", "int": "INTEGER", "real": "REAL",
         "name": "VARCHAR", "p": "DOUBLE", "f": "BOOLEAN", "tie": "DOUBLE"}
POOLS = {"k1": ["A", "N", "R"],
         "name": [f"name{i:03d}" for i in range(40)]}


def ty(T, spec):
    if isinstance(spec, tuple):
        return getattr(T, spec[0])(spec[1], spec[2])
    return getattr(T, spec)


def seeded(seed, cap, n, ngroups=5):
    rng = np.random.default_rng(seed)
    dbl = rng.normal(size=cap) * 1000
    tie = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 3.5, 3.5, -2.0])[
        rng.integers(0, 8, cap)]
    real = (rng.normal(size=cap) * 50).astype(np.float32)
    if cap:
        dbl[::13] = np.nan
        dbl[1::11] = -0.0
        dbl[2::17] = 0.0
        dbl[3::19] = np.inf
        dbl[4::23] = -np.inf
        real[::7] = np.nan
        real[1::9] = -0.0
    grp = np.array([-7, 0, 3, 2**40, -2**62], dtype=np.int64)[
        rng.integers(0, 5, cap)] if ngroups <= 5 else \
        rng.integers(0, ngroups, cap).astype(np.int64)
    p = np.full(cap, 0.5)
    p[n:] = 1.0          # dead rows: p_g is the max over live rows only
    if cap > 3:
        p[1] = 0.75
    arrays = {"k1": np.array(POOLS["k1"], dtype=object)[
                  rng.integers(0, 3, cap)],
              "grp": grp,
              "fgrp": np.array([np.nan, -0.0, 0.0, 1.5, -2.25])[
                  rng.integers(0, 5, cap)],
              # few distinct values: ties at the extremum
              "big": rng.integers(-6, 6, cap) * 2**36,
              "dec": rng.integers(-10**9, 10**9, cap),
              "dbl": dbl,
              "day": rng.integers(8000, 8040, cap).astype(np.int32),
              "flag": rng.random(cap) < 0.6,
              "tiny": rng.integers(-128, 128, cap).astype(np.int8),
              "small": rng.integers(-2**15, 2**15, cap).astype(np.int16),
              "int": rng.integers(-2**31, 2**31, cap).astype(np.int32),
              "real": real,
              "name": np.array(POOLS["name"], dtype=object)[
                  rng.integers(0, 40, cap)],
              "p": p,
              "f": rng.random(cap) < 0.7,
              "tie": tie}
    valids = {c: rng.random(cap) < 0.88 for c in COLS}
    valids["grp"] = rng.random(cap) < 0.95
    valids["p"] = None
    return arrays, valids, n


def build_page(pkg_page, T, data):
    arrays, valids, n = data
    cols, dicts = [], []
    for c in COLS:
        if c in POOLS:
            d = pkg_page.Dictionary(np.asarray(POOLS[c], dtype=object))
            cols.append(d.encode(arrays[c]))
            dicts.append(d)
        else:
            cols.append(arrays[c])
            dicts.append(None)
    where = {} if pkg_page is RP else {"device": "cpu"}
    page = pkg_page.Page.from_numpy(cols, [ty(T, TYPES[c]) for c in COLS],
                                    valids=[valids[c] for c in COLS],
                                    dictionaries=dicts, **where)
    return pkg_page.Page(page.columns, n if pkg_page is RP
                         else PP.row_count(n, torch.device("cpu")))


def specs(A, T, aggs):
    out = []
    for name, c, c2, *rest in aggs:
        distinct = "distinct" in rest
        filt = COLS.index("f") if "filter" in rest else None
        ch2 = None if c2 is None else COLS.index(c2)
        out.append(A.AggSpec(name, COLS.index(c), ty(T, TYPES[c]), filt,
                             distinct, ch2,
                             None if c2 is None else ty(T, TYPES[c2])))
    return out


def rows(page, nkeys):
    n = int(page.num_rows)
    cols = []
    for ci, c in enumerate(page.columns):
        vals = c.values[:n].numpy() if isinstance(c.values, torch.Tensor) \
            else np.asarray(c.values)[:n]
        valid = np.ones(n, dtype=bool) if c.valid is None else (
            c.valid[:n].numpy() if isinstance(c.valid, torch.Tensor)
            else np.asarray(c.valid)[:n])
        out = []
        for v, ok in zip(vals.tolist(), valid.tolist()):
            if not ok:
                out.append(None)
            elif c.dictionary is not None:
                out.append(c.dictionary.values[v])
            elif ci < nkeys and isinstance(v, float) and v == 0:
                out.append(0.0)
            else:
                out.append(v)
        cols.append(out)
    return sorted((tuple(c[i] for c in cols) for i in range(n)),
                  key=lambda r: tuple((x is None, str(x)) for x in r[:nkeys]))


def same(x, y, centered):
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, float) or isinstance(y, float):
        x, y = float(x), float(y)
        if x != x or y != y:
            return x != x and y != y
        if not centered:
            return x == y and np.signbit(x) == np.signbit(y)
        return abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1.0)
    return x == y


CENTERED = [("variance", "dbl", None), ("var_samp", "dec", None),
            ("var_pop", "big", None, "filter"), ("stddev", "real", None),
            ("stddev_samp", "int", None), ("stddev_pop", "small", None),
            ("corr", "dbl", "dec"), ("covar_pop", "big", "tiny"),
            ("covar_samp", "dec", "dbl", "filter"),
            ("regr_slope", "dbl", "big"), ("regr_intercept", "dec", "int"),
            ("var_pop", "dec", None, "distinct"),
            ("stddev", "day", None, "distinct", "filter")]
POSITIONAL = [("min_by", "name", "tie"), ("max_by", "name", "tie"),
              ("min_by", "dec", "big"), ("max_by", "day", "big", "filter"),
              ("min_by", "dbl", "real"), ("max_by", "flag", "dbl"),
              ("min_by", "big", "name"), ("max_by", "tiny", "day"),
              ("arbitrary", "name", None), ("arbitrary", "dbl", None,
                                            "filter"),
              ("arbitrary", "tiny", None)]
SKETCH = [("approx_distinct", "big", None), ("approx_distinct", "name", None),
          ("approx_distinct", "dbl", None, "filter"),
          ("approx_distinct", "real", None), ("approx_distinct", "tiny", None),
          ("approx_distinct", "dec", None), ("approx_distinct", "flag", None),
          ("approx_percentile", "dbl", "p"),
          ("approx_percentile", "tie", "p", "filter"),
          ("approx_percentile", "dec", "p"),
          ("approx_percentile", "day", "p"),
          ("approx_percentile", "name", "p")]
CHECKSUM = [("checksum", c, None) for c in
            ("big", "dec", "dbl", "day", "flag", "tiny", "small", "int",
             "real", "name", "tie")] + [("checksum", "big", None, "filter"),
                                        ("checksum", "dbl", None, "distinct")]
FAMILIES = {"centered": CENTERED, "positional": POSITIONAL,
            "sketch": SKETCH, "checksum": CHECKSUM}
KEYSETS = {"global": [], "dict_key": ["k1"], "bigint_key": ["grp"],
           "double_key": ["fgrp"], "dict_and_int": ["k1", "grp"]}
LAYOUTS = {"ragged": (300, 211, 5), "empty": (64, 0, 5),
           "one_row": (8, 1, 5), "full": (257, 257, 5)}


def run(pkg, page, keys, aggs):
    A, T = pkg
    return A.hash_aggregate([COLS.index(k) for k in keys],
                            specs(A, T, aggs), A.Step.SINGLE)(page)


def check(keys, aggs, cap, n, ngroups, seed):
    data = seeded(seed, cap, n, ngroups)
    want = rows(run((RA, RT), build_page(RP, RT, data), keys, aggs),
                len(keys))
    got = rows(run((PA, PT), build_page(PP, PT, data), keys, aggs),
               len(keys))
    assert len(got) == len(want)
    cent = [False] * len(keys) + [a[0] in PA.CENTERED_AGGREGATES
                                  for a in aggs]
    for g, w in zip(got, want):
        assert all(same(a, b, c) for a, b, c in zip(g, w, cent)), (g, w)


CASES = [(f, k, lay) for f in sorted(FAMILIES) for k in sorted(KEYSETS)
         for lay in sorted(LAYOUTS)]


@pytest.mark.parametrize("family,keys,layout", CASES)
def test_special_aggregates_match_reference(family, keys, layout):
    cap, n, ng = LAYOUTS[layout]
    check(KEYSETS[keys], FAMILIES[family], cap, n, ng,
          sum(map(ord, family + keys + layout)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_many_groups_match_reference(family):
    """2^16 rows in up to 2^15 groups (the global-atomics side of K30's
    shared-copy threshold on the card)."""
    check(["grp"], FAMILIES[family][:4], 1 << 16, (1 << 16) - 5, 1 << 15,
          len(family))


HASH_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.bool_,
               np.float32, np.float64]


@pytest.mark.parametrize("dtype", HASH_DTYPES,
                         ids=[np.dtype(d).name for d in HASH_DTYPES])
def test_hash_matches_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    if dtype == np.bool_:
        v = rng.random(64) < 0.5
    elif np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = np.concatenate([
            np.array([info.min, info.max, -1, 0, 1, -2], dtype=dtype),
            rng.integers(info.min, info.max, 58, dtype=dtype)])
    else:
        v = np.concatenate([
            np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0,
                      -1.5], dtype=dtype),
            (rng.normal(size=56) * 1e6).astype(dtype)])
    want = np.asarray(RA._hash64(jnp.asarray(v))).view(np.int64)
    got = PA.hash64_plain(torch.from_numpy(v)).numpy()
    assert (got == want).all()
    # checksum's contribution and the HLL register inputs
    m = rng.random(len(v)) < 0.7
    want_c = np.asarray(RA._checksum_state(None)[0].contrib(
        jnp.asarray(v), jnp.asarray(m)))
    got_c = PA.checksum_contrib(torch.from_numpy(v), torch.from_numpy(m))
    assert (got_c.numpy() == want_c).all()
    bucket, rho = RA._hll_register_inputs(jnp.asarray(v), jnp.asarray(m))
    pair, prho = PA.hll_pairs(torch.from_numpy(v), [torch.from_numpy(m)],
                              None, None)
    assert (pair.numpy() == np.where(m, np.asarray(bucket), -1)).all()
    assert (prho.numpy() == np.asarray(rho)).all()


def test_hll_rho_edges():
    """rho of the extreme remainders: w = 0 gives 54, w = 1 gives 53, the
    top bit 1 (clz(w) - 10 for w > 0)."""
    h = torch.tensor([0, 1, 2, (1 << 52), (1 << 53) - 1, 5 << 53],
                     dtype=torch.int64)
    w = h & ((1 << 53) - 1)
    _, e = torch.frexp(w.to(torch.float64))
    rho = torch.where(w > 0, 54 - e.to(torch.int64), 54)
    assert rho.tolist() == [54, 53, 52, 1, 1, 54]


def test_hll_estimate_matches_reference():
    """The fold of exact register sums: every register value 1-54 present
    in one group, the empty group, and the all-buckets group."""
    regs = np.concatenate([np.arange(1, 55), np.ones(2048 - 54)])
    pairs = np.concatenate([np.arange(54), np.arange(54, 2048)]).astype(
        np.int64)
    pairs = np.concatenate([pairs, 2 * 2048 + np.arange(7)])
    regs = np.concatenate([regs, [3, 9, 20, 1, 2, 45, 54]]).astype(np.int64)
    got = PA.hll_fold(torch.from_numpy(pairs), torch.from_numpy(regs),
                      torch.tensor(len(pairs), dtype=torch.int32), None, 3)
    want = []
    for g in range(3):
        sel = (pairs >> 11) == g
        r = regs[sel]
        want.append(int(np.asarray(RA._hll_estimate(
            jnp.sum(jnp.exp2(-jnp.asarray(r, jnp.float64))),
            jnp.asarray(float(sel.sum()))))))
    assert got.tolist() == want


def test_group_ids_twin_maps_rows_to_groups():
    """K28's twin: each live row's id is its group's output row, dead rows
    get num_groups."""
    data = seeded(3, 100, 90)
    page = build_page(PP, PT, data)
    keys = [PA.GroupKey(page.column(COLS.index(c)).values,
                        page.column(COLS.index(c)).valid)
            for c in ("k1", "grp")]
    kv, kval, _, ng, gid = PA.group_ids(keys, [], page.num_rows, 100)
    g = int(ng)
    assert (gid[90:] == g).all()
    for i in range(90):
        j = int(gid[i])
        assert 0 <= j < g
        for k, v, ok in zip(keys, kv, kval):
            if not bool(k.valid[i]):
                assert not bool(ok[j])
            else:
                assert bool(ok[j]) and v[j] == k.values[i]


@pytest.mark.parametrize("aggs,step,message", [
    ([("min_by", "name", "big", "distinct")], "single",
     r"min_by\(DISTINCT \.\.\.\)"),
    ([("corr", "dbl", "big", "distinct")], "single",
     r"corr\(DISTINCT \.\.\.\)"),
    ([("stddev", "dbl", None)], "partial", r"stddev\(\) in partial step"),
    ([("approx_distinct", "big", None)], "final",
     r"approx_distinct\(\) in final step"),
    ([("var_pop", "dbl", None, "distinct")], "intermediate",
     r"var_pop\(DISTINCT \.\.\.\) in intermediate step")])
def test_refusals_carry_the_reference_text(aggs, step, message):
    for A, T in ((RA, RT), (PA, PT)):
        with pytest.raises(NotImplementedError, match=message):
            A.hash_aggregate([], specs(A, T, aggs), step, [[2]])


def test_collecting_aggregates_wait_for_b13():
    """B13 is ported: a global collecting aggregate raises the reference's
    refusal when it runs, and the bypass partial still refuses it."""
    sp = [PA.AggSpec("array_agg", 3, PT.BIGINT)]
    page = build_page(PP, PT, seeded(3, 16, 12))
    with pytest.raises(NotImplementedError,
                       match=r"global array_agg/histogram/map_agg"):
        PA.hash_aggregate([], sp)(page)
    with pytest.raises(NotImplementedError, match="bypass partial"):
        PA.passthrough_partial([], sp)
