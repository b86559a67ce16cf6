"""hash_aggregate parity: trino_tpu_torch vs trino_tpu.ops.aggregate (CPU).

The direct (dictionary-key) path runs K3's plain twin, the general GROUP BY
K8's and the global path K4's; all are driven through PARTIAL -> FINAL,
PARTIAL -> INTERMEDIATE -> FINAL and SINGLE over seeded pages with NULL
keys, NULL values, NaN, -0.0, dead padding rows and an empty page, for
sum/count/avg/min/max on BIGINT, DECIMAL and DOUBLE (plus count_if and
bool_and/bool_or). The general path groups on BIGINT, DOUBLE (NaN, -0.0,
+0.0 and NULL keys), DATE and mixed dictionary + integer keys. Groups
compare as multisets (the general path emits them in hash-slot order, the
reference in sorted order); integers and decimals match exactly, doubles
to 1e-9 relative; a -0.0 key equals a +0.0 key (the reference emits a
group's first sorted row, the port any of its rows). DISTINCT aggregates
(K8's distinct mode) run in a SINGLE step on the same pages.
"""

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

D = ("DecimalType", 12, 2)
# (name, input column) — column names index COLS below
AGGS = [("sum", "big"), ("sum", "dec"), ("sum", "dbl"), ("count", "dbl"),
        ("count", None), ("avg", "dec"), ("avg", "big"), ("avg", "dbl"),
        ("min", "big"), ("max", "big"), ("min", "dec"), ("max", "dec"),
        ("min", "dbl"), ("max", "dbl"), ("min", "day"), ("max", "day"),
        ("count_if", "flag"), ("bool_and", "flag"), ("bool_or", "flag")]
# (min/max over a varchar run end to end in test_torch_queries.py: an
# all-NULL group's dictionary code does not decode in either package)
COLS = ["k1", "k2", "big", "dec", "dbl", "day", "flag", "grp", "fgrp"]


def ty(T, spec):
    if isinstance(spec, tuple):
        return getattr(T, spec[0])(spec[1], spec[2])
    return getattr(T, spec)


TYPES = {"k1": "VARCHAR", "k2": "VARCHAR", "big": "BIGINT", "dec": D,
         "dbl": "DOUBLE", "day": "DATE", "flag": "BOOLEAN", "grp": "BIGINT",
         "fgrp": "DOUBLE"}


def seeded(seed, cap, n, null_keys=True):
    rng = np.random.default_rng(seed)
    k1 = np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, cap)]
    k2 = np.array(["F", "O"], dtype=object)[rng.integers(0, 2, cap)]
    dbl = rng.normal(size=cap) * 100
    if cap:
        dbl[::11] = np.nan
        dbl[1::7] = -0.0
        dbl[2::9] = 0.0
    # few distinct group keys: negative and huge integers; doubles with
    # NaN, -0.0 and +0.0
    grp = np.array([-7, 0, 3, 2**40, -2**62], dtype=np.int64)[
        rng.integers(0, 5, cap)]
    fgrp = np.array([np.nan, -0.0, 0.0, 1.5, -2.25])[rng.integers(0, 5, cap)]
    arrays = {"k1": k1, "k2": k2, "grp": grp, "fgrp": fgrp,
              "big": rng.integers(-2**40, 2**40, cap),
              "dec": rng.integers(-10**9, 10**9, cap),
              "dbl": dbl,
              "day": rng.integers(8000, 11000, cap).astype(np.int32),
              "flag": rng.random(cap) < 0.6}
    valids = {"k1": rng.random(cap) < 0.85 if null_keys else None,
              "k2": None, "big": rng.random(cap) < 0.9,
              "dec": rng.random(cap) < 0.9, "dbl": rng.random(cap) < 0.9,
              "day": None, "flag": rng.random(cap) < 0.8,
              "grp": rng.random(cap) < 0.9, "fgrp": rng.random(cap) < 0.9}
    return arrays, valids, n


POOLS = {"k1": ["A", "N", "R"], "k2": ["F", "O"]}


def build_page(pkg_page, T, data):
    """A page whose key columns share one pool across pages, as the
    pages of one table scan do."""
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


def specs(A, T, keys, aggs):
    out = []
    for name, c in aggs:
        ch = None if c is None else COLS.index(c)
        out.append(A.AggSpec(name, ch, None if c is None
                             else ty(T, TYPES[c])))
    return out


def state_channels(A, sp, nkeys):
    chans, ch = [], nkeys
    for s in sp:
        k = len(A.get_aggregate(s.name, s.input_type).state(s.input_type))
        chans.append(list(range(ch, ch + k)))
        ch += k
    return chans


def run_steps(pkg, pages, keys, aggs, chain):
    """Run `chain` ("single" | "pf" | "pif") over pages with one package."""
    A, T, Pg = pkg
    key_chs = [COLS.index(k) for k in keys]
    sp = specs(A, T, keys, aggs)
    if chain == "single":
        return A.hash_aggregate(key_chs, sp, A.Step.SINGLE)(pages[0])
    partial = A.hash_aggregate(key_chs, sp, A.Step.PARTIAL)
    parts = [partial(p) for p in pages]
    merged = Pg.device_concat(parts)
    final_keys = list(range(len(keys)))
    chans = state_channels(A, sp, len(keys))
    if chain == "pif":
        # per-page compaction, a merge, and one more compaction of the
        # merged states before FINAL
        inter = A.hash_aggregate(final_keys, sp, A.Step.INTERMEDIATE, chans)
        merged = inter(Pg.device_concat([inter(p) for p in parts]))
    return A.hash_aggregate(final_keys, sp, A.Step.FINAL, chans)(merged)


def rows(page, nkeys=0):
    """Live rows as tuples, NULL as None, dictionary codes decoded only
    where valid (the NULL-key slot's code lies past the pool); a -0.0 in
    the first nkeys (group key) columns reads as +0.0."""
    n = int(page.num_rows)
    cols = []
    for ci, c in enumerate(page.columns):
        vals = np.asarray(c.values)[:n] if not isinstance(
            c.values, torch.Tensor) else c.values[:n].numpy()
        valid = np.ones(n, dtype=bool) if c.valid is None else (
            np.asarray(c.valid)[:n] if not isinstance(c.valid, torch.Tensor)
            else c.valid[:n].numpy())
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
                  key=lambda r: tuple((x is None, str(x)) for x in r))


def same_value(x, y):
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, (float, np.floating)) or isinstance(y, (float,
                                                             np.floating)):
        x, y = float(x), float(y)
        if x != x or y != y:
            return x != x and y != y
        if x == 0 and y == 0:
            return np.signbit(x) == np.signbit(y)
        return abs(x - y) <= 1e-9 * max(abs(x), abs(y))
    return x == y


REF = (RA, RT, RP)
PORT = (PA, PT, PP)
KEYSETS = {"global": [], "one_key": ["k1"], "two_keys": ["k1", "k2"],
           # the general path (K8)
           "bigint_key": ["grp"], "double_key": ["fgrp"],
           "date_key": ["day"], "dict_and_int": ["k1", "grp"],
           "three_mixed": ["fgrp", "k2", "grp"]}
LAYOUTS = {"ragged": [(300, 211), (64, 64), (100, 0)],
           "empty": [(50, 0)],
           "single_page": [(257, 257)]}


# INTERMEDIATE runs only on grouped aggregations (the spill compaction)
CHAINS = [(k, lay, ch) for k in sorted(KEYSETS) for lay in sorted(LAYOUTS)
          for ch in ("single", "pf", "pif") if KEYSETS[k] or ch != "pif"]


@pytest.mark.parametrize("keys,layout,chain", CHAINS)
def test_hash_aggregate_matches_reference(keys, layout, chain):
    datas = [seeded(sum(map(ord, keys + layout)) + i, cap, n)
             for i, (cap, n) in enumerate(LAYOUTS[layout])]
    ref_pages = [build_page(RP, RT, data) for data in datas]
    port_pages = [build_page(PP, PT, data) for data in datas]
    nk = len(KEYSETS[keys])
    want = rows(run_steps(REF, ref_pages, KEYSETS[keys], AGGS, chain), nk)
    got = rows(run_steps(PORT, port_pages, KEYSETS[keys], AGGS, chain), nk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(same_value(a, b) for a, b in zip(g, w)), (g, w)


def test_unsupported_paths_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="B13"):
        PA.hash_aggregate([], [PA.AggSpec("array_agg", 2, PT.BIGINT)])
    # DISTINCT runs in a SINGLE step only, and refuses PARTIAL/FINAL
    # exactly where the reference does
    sp = [PA.AggSpec("sum", 2, PT.BIGINT, distinct=True)]
    for A in (RA, PA):
        with pytest.raises(NotImplementedError, match="DISTINCT"):
            A.hash_aggregate([COLS.index("big")], sp, A.Step.PARTIAL)
    # a non-dictionary key runs (the general GROUP BY)
    page = build_page(PP, PT, seeded(1, 10, 10))
    op = PA.hash_aggregate([COLS.index("big")],
                           [PA.AggSpec("count", None, None)])
    assert int(op(page).num_rows) == 10


# DISTINCT aggregates: (name, argument, FILTER channel or None)
DISTINCT_AGGS = [("count", "dbl", None), ("sum", "dbl", None),
                 ("avg", "dec", None), ("count", "big", "flag"),
                 ("sum", "grp", None), ("avg", "fgrp", None),
                 ("count", "fgrp", "flag"), ("sum", "day", "flag")]
DISTINCT_KEYS = ["global", "one_key", "bigint_key", "double_key",
                 "dict_and_int"]


@pytest.mark.parametrize("keys,layout", [(k, lay) for k in DISTINCT_KEYS
                                         for lay in ("ragged", "empty")])
def test_distinct_aggregate_matches_reference(keys, layout):
    """count/sum/avg(DISTINCT ...) in a SINGLE step, K8's distinct mode
    (its twin) against the reference's _distinct_first_mask: NULL
    arguments, NaN, -0.0 beside +0.0, a FILTER mask, one mask shared by
    aggregates over one argument. Integers exact, doubles 1e-9 relative."""
    cap, n = LAYOUTS[layout][0]
    data = seeded(sum(map(ord, keys + layout)) + 7, cap, n)
    key_chs = [COLS.index(k) for k in KEYSETS[keys]]
    out = []
    for A, T, Pg in (REF, PORT):
        sp = [A.AggSpec(name, COLS.index(c), ty(T, TYPES[c]),
                        None if f is None else COLS.index(f), True)
              for name, c, f in DISTINCT_AGGS]
        page = build_page(Pg, T, data)
        out.append(rows(A.hash_aggregate(key_chs, sp, A.Step.SINGLE)(page),
                        len(key_chs)))
    got, want = out[1], out[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(same_value(a, b) for a, b in zip(g, w)), (g, w)


def test_output_types_resolve_for_every_aggregate():
    for name in RA.AGGREGATES + ("approx_distinct", "checksum"):
        r = RA.get_aggregate(name, RT.BIGINT).output_type(RT.BIGINT)
        p = PA.get_aggregate(name, PT.BIGINT).output_type(PT.BIGINT)
        assert type(r).__name__ == type(p).__name__, name
