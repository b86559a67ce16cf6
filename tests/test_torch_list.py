"""The list layouts (ARRAY, MAP) against trino_tpu (CPU).

- K33's twins through hash_aggregate(..., Step.SINGLE, list_len=L) in
  both packages over seeded pages (NULL keys and values, NaN, +-0.0,
  +-inf, duplicate keys, dictionary keys and values, a FILTER, dead
  padding rows, an empty page), with L the reference's sizing
  (group_max_size rounded up to a power of two) and a short L that cuts
  the lists; the size mode against group_max_size. Lists compare exactly,
  in order, a zero's sign included.
- K32's twin, the plain move of a page with list planes (Page.filter,
  Column.gather, device_concat over planes of mixed L), against the
  reference's, planes and lengths compared row by row.
- K34's twin against the reference's count and expand ops.
- K11's list operations (array_ctor, cardinality, element_at, contains,
  map_element_at) as the generated kernel text, run under the torch
  stand-in for `triton.language` of test_torch_expr_kernel.py, and as the
  Program's torch evaluator, against the plain compiler over every
  filter and project step of list queries at `tiny`.
"""

import numpy as np
import pytest
import torch

import test_torch_expr_kernel as TK
import test_torch_special_agg as SA
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.ops import aggregate as RA
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.exec import LocalQueryRunner
from trino_tpu_torch.expr import compiler as C
from trino_tpu_torch.expr import kernel_gen as K
from trino_tpu_torch.expr.ir import Call
from trino_tpu_torch.ops import aggregate as PA
from trino_tpu_torch.ops import lists as LS

torch.set_num_threads(1)


def _canon(v):
    """A decoded cell with floats as repr (NaN equal to NaN, the sign of
    a zero kept), lists in order, maps as sorted items."""
    if isinstance(v, dict):
        return ("map", tuple(sorted((_canon(k), _canon(x))
                                    for k, x in v.items())))
    if isinstance(v, list):
        return ("list", tuple(_canon(x) for x in v))
    if isinstance(v, float):
        return ("f", repr(v))
    return v


def list_rows(page, nkeys):
    """The live rows, cells decoded by the page's own to_host, sorted by
    their keys (a zero key as +0.0: groups come out in each engine's
    order)."""
    n = int(page.num_rows)
    cols = page.to_host(n)
    out = []
    for i in range(n):
        row = []
        for ci, col in enumerate(cols):
            v = col[i]
            if hasattr(v, "item"):
                v = v.item()
            if ci < nkeys and isinstance(v, float) and v == 0:
                v = 0.0
            row.append(_canon(v))
        out.append(tuple(row))
    return sorted(out, key=lambda r: tuple((x is None, str(x))
                                           for x in r[:nkeys]))


COLLECT = {
    "array": [("array_agg", "big", None), ("array_agg", "dbl", None),
              ("array_agg", "name", None), ("array_agg", "real", None,
                                             "filter"),
              ("array_agg", "dec", None, "distinct"),
              ("array_agg", "flag", None), ("array_agg", "tie", None)],
    "histogram": [("histogram", "name", None), ("histogram", "tie", None),
                  ("histogram", "real", None, "filter"),
                  ("histogram", "big", None), ("histogram", "day", None)],
    "map_agg": [("map_agg", "tie", "big"), ("map_agg", "name", "dbl"),
                ("map_agg", "big", "name", "filter"),
                ("map_agg", "fgrp", "tiny"), ("map_agg", "real", "dec")],
}
KEYSETS = {k: SA.KEYSETS[k] for k in ("dict_key", "bigint_key",
                                      "double_key", "dict_and_int")}
LAYOUTS = SA.LAYOUTS


def _sizing(ref_page, keys):
    """The executor's L: the reference's group_max_size rounded up."""
    largest = max(int(RA.group_max_size(keys)(ref_page)), 1)
    return 1 << (largest - 1).bit_length()


@pytest.mark.parametrize("family,keys,layout,short", [
    (f, k, lay, short) for f in sorted(COLLECT) for k in sorted(KEYSETS)
    for lay in sorted(LAYOUTS) for short in (False, True)])
def test_collect_aggregates_match_reference(family, keys, layout, short):
    cap, n, ng = LAYOUTS[layout]
    data = SA.seeded(sum(map(ord, family + keys + layout)), cap, n, ng)
    key_ch = [SA.COLS.index(k) for k in KEYSETS[keys]]
    ref_page = SA.build_page(RP, RT, data)
    port_page = SA.build_page(PP, PT, data)
    L = 2 if short else _sizing(ref_page, key_ch)
    aggs = COLLECT[family]
    want = RA.hash_aggregate(key_ch, SA.specs(RA, RT, aggs), RA.Step.SINGLE,
                             list_len=L)(ref_page)
    got = PA.hash_aggregate(key_ch, SA.specs(PA, PT, aggs), PA.Step.SINGLE,
                            list_len=L)(port_page)
    assert list_rows(got, len(key_ch)) == list_rows(want, len(key_ch))
    # the output has a power of two at least the groups in rows (at least
    # 1024, at most the page's capacity), not the reference's capacity
    groups = int(got.num_rows)
    rows = max(1024, 1 << max(groups - 1, 0).bit_length())
    assert got.capacity == min(rows, port_page.capacity)
    if not short:
        # without list_len the operator sizes L itself, as the
        # reference's executor does (K33's size mode)
        auto = PA.hash_aggregate(key_ch, SA.specs(PA, PT, aggs),
                                 PA.Step.SINGLE)(port_page)
        assert {c.values.shape[1] for c in auto.columns if c.is_list} \
            == {L}
        assert list_rows(auto, len(key_ch)) == list_rows(want, len(key_ch))


@pytest.mark.parametrize("keys,layout", [(k, lay) for k in sorted(KEYSETS)
                                         for lay in sorted(LAYOUTS)])
def test_size_mode_matches_group_max_size(keys, layout):
    cap, n, ng = LAYOUTS[layout]
    data = SA.seeded(sum(map(ord, keys + layout)), cap, n, ng)
    key_ch = [SA.COLS.index(k) for k in KEYSETS[keys]]
    ref_page = SA.build_page(RP, RT, data)
    page = SA.build_page(PP, PT, data)
    gk = [PA.GroupKey(page.column(c).values, page.column(c).valid)
          for c in key_ch]
    *_, num_groups, gid = PA.group_ids(gk, [], page.num_rows, page.capacity)
    largest, groups = LS.collect_sizes(gid, page.num_rows,
                                       num_groups).tolist()
    assert largest == int(RA.group_max_size(key_ch)(ref_page))
    assert groups == int(num_groups)


def test_collect_quirks():
    """NULL inputs are skipped, DISTINCT does not narrow a collecting
    aggregate, a NaN map key comes back as +inf and +-0.0 keys merge
    under the first row's sign, as in the reference; a global call is
    refused with the reference's text when the operator runs."""
    x = np.array([0.0, -0.0, np.nan, 1.0, np.inf, -0.0, 2.0, 2.0])
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], dtype=bool)
    g = np.array([1, 1, 1, 1, 1, 2, 2, 2], dtype=np.int64)

    def run(pkg_page, A, T, aggs, L):
        where = {} if pkg_page is RP else {"device": "cpu"}
        page = pkg_page.Page.from_numpy([g, x], [T.BIGINT, T.DOUBLE],
                                        valids=[None, valid], **where)
        specs = [A.AggSpec(name, 1, T.DOUBLE, None, distinct)
                 for name, distinct in aggs]
        return list_rows(A.hash_aggregate([0], specs, A.Step.SINGLE,
                                          list_len=L)(page), 1)
    aggs = [("array_agg", False), ("array_agg", True), ("histogram", False)]
    got = run(PP, PA, PT, aggs, 8)
    assert got == run(RP, RA, RT, aggs, 8)
    g1 = dict((r[0], r[1:]) for r in got)[1]
    assert g1[0] == ("list", (("f", "0.0"), ("f", "-0.0"), ("f", "nan"),
                              ("f", "1.0"), ("f", "inf")))
    assert g1[1] == g1[0]                       # DISTINCT is not applied
    assert g1[2] == ("map", ((("f", "0.0"), 2), (("f", "1.0"), 1),
                             (("f", "inf"), 2)))
    g2 = dict((r[0], r[1:]) for r in got)[2]
    assert g2[0] == ("list", (("f", "-0.0"), ("f", "2.0")))   # NULL skipped
    for A, T in ((RA, RT), (PA, PT)):
        op = A.hash_aggregate([], [A.AggSpec("array_agg", 1, T.DOUBLE)])
        page = (RP if A is RA else PP).Page.from_numpy(
            [g, x], [T.BIGINT, T.DOUBLE],
            **({} if A is RA else {"device": "cpu"}))
        with pytest.raises(NotImplementedError,
                           match=r"global array_agg/histogram/map_agg "
                                 r"\(no GROUP BY\)"):
            op(page)


# ------------------------------------------------------------------ K32


def _list_page(pkg_page, T, seed, cap, n, L, with_map):
    """A page of an int column, an ARRAY(varchar) column (dictionary
    codes) and, optionally, a MAP(double, bigint) column, planes [cap, L]
    of seeded elements past each length too (what a move must carry)."""
    rng = np.random.default_rng(seed)
    pool = np.array(["a", "bb", "ccc", "dd"], dtype=object)
    d = pkg_page.Dictionary(pool)
    ints = rng.integers(-50, 50, cap).astype(np.int64)
    codes = rng.integers(0, 4, (cap, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    keys = rng.normal(size=(cap, L))
    vals = rng.integers(0, 9, (cap, L)).astype(np.int64)
    arr_t = T.ArrayType(element=T.VARCHAR)
    map_t = T.MapType(key=T.DOUBLE, value=T.BIGINT)
    if pkg_page is RP:
        import jax.numpy as jnp
        put = jnp.asarray
        cols = [RP.Column(put(ints), None, T.BIGINT),
                RP.Column(put(codes), put(valid), arr_t, d, put(lens))]
        if with_map:
            cols.append(RP.Column(put(keys), None, map_t, None, put(lens),
                                  put(vals)))
        return RP.Page(tuple(cols), jnp.asarray(n, dtype=jnp.int32))
    arrays = [ints, codes] + ([keys] if with_map else [])
    return PP.page_from_host(
        arrays, [None, valid] + ([None] if with_map else []),
        [None, list(pool)] + ([None] if with_map else []),
        [T.BIGINT, arr_t] + ([map_t] if with_map else []), n, device="cpu",
        lists=[None, (lens, None, None)]
        + ([(lens, vals, None)] if with_map else []))


def _planes(page, n):
    """Every array of the page's first n rows as numpy."""
    out = []
    for c in page.columns:
        for a in (c.values, c.valid, c.lengths, c.aux):
            if a is not None:
                out.append(np.asarray(a)[:n] if not isinstance(
                    a, torch.Tensor) else a[:n].numpy())
    return out


def _same_planes(got, want, n):
    a, b = _planes(got, n), _planes(want, n)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("L,with_map", [(1, False), (3, True), (8, True),
                                        (128, False)])
def test_plane_moves_match_reference(L, with_map):
    cap, n = 300, 257
    ref = _list_page(RP, RT, L, cap, n, L, with_map)
    port = _list_page(PP, PT, L, cap, n, L, with_map)
    rng = np.random.default_rng(L)
    mask = rng.random(cap) < 0.5
    import jax.numpy as jnp
    want = ref.filter(jnp.asarray(mask))
    got = port.filter(torch.from_numpy(mask))
    assert int(got.num_rows) == int(want.num_rows)
    _same_planes(got, want, int(want.num_rows))
    assert list_rows(got, 0) == list_rows(want, 0)
    idx = rng.integers(-3, cap + 3, 500)
    for gc, wc in zip(port.columns, ref.columns):
        g = gc.gather(torch.from_numpy(idx))
        w = wc.gather(jnp.asarray(idx))
        _same_planes(PP.Page((g,), 500), RP.Page((w,), 500), 500)
    # device_concat: a page with a narrower plane pads to the widest L
    L2 = max(1, L // 2)
    ref2 = _list_page(RP, RT, L + 1, 40, 33, L2, with_map)
    port2 = _list_page(PP, PT, L + 1, 40, 33, L2, with_map)
    want = RP.device_concat([ref2, ref, ref2])
    got = PP.device_concat([port2, port, port2])
    total = int(want.num_rows)
    assert int(got.num_rows) == total == 33 + n + 33
    assert got.column(1).values.shape[1] == L
    _same_planes(got, want, total)


# ------------------------------------------------------------------ K34


@pytest.mark.parametrize("L,with_map,ordinality", [
    (1, False, False), (3, True, True), (8, False, True)])
def test_unnest_twin_matches_reference_ops(L, with_map, ordinality):
    """The reference's count and expand ops (_exec_UnnestNode's bodies,
    restated over its arrays) against K34's twin."""
    import jax.numpy as jnp
    cap, n = 200, 150
    port = _list_page(PP, PT, 5, cap, n, L, with_map)
    ref = _list_page(RP, RT, 5, cap, n, L, with_map)
    ci = 2 if with_map else 1
    c = ref.column(ci)
    live = ref.row_mask() & c.valid_mask()
    lens = jnp.where(live, c.lengths, 0).astype(jnp.int64)
    total = int(jnp.sum(lens))
    pc = port.column(ci)
    assert int(LS.unnest_count(pc.lengths, pc.valid, port.num_rows)) == total
    out_cap = 1 << max(total - 1, 0).bit_length()
    srow, ordinal, elem, aux, count = LS.unnest_expand(
        pc.lengths, pc.valid, port.num_rows, pc.values, pc.aux, out_cap,
        ordinality)
    offsets = jnp.cumsum(lens)
    prow = np.asarray(jnp.searchsorted(offsets, jnp.arange(total),
                                       side="right"))
    within = np.arange(total) - np.asarray(offsets - lens)[prow]
    assert int(count) == total
    assert srow[:total].tolist() == prow.tolist()
    plane = np.asarray(c.values)
    assert elem[:total].numpy().tobytes() == \
        plane[prow, within].tobytes()
    if with_map:
        assert aux[:total].tolist() == \
            np.asarray(c.aux)[prow, within].tolist()
    if ordinality:
        assert ordinal[:total].tolist() == (within + 1).tolist()


# ------------------------------------------------------------------ K11

K11_QUERIES = {
    "ctor_calls":
        "SELECT l_returnflag, sum(cardinality(ARRAY[l_partkey, l_suppkey])),"
        " sum(element_at(ARRAY[l_quantity, l_extendedprice], 2)), "
        "sum(CASE WHEN contains(ARRAY[l_partkey, l_suppkey], 7) THEN 1 "
        "ELSE 0 END) FROM lineitem GROUP BY l_returnflag",
    "ctor_output":
        "SELECT e, count(*) FROM orders CROSS JOIN UNNEST(ARRAY["
        "o_custkey % 7, o_shippriority]) AS u(e) GROUP BY e",
    "string_ctor":
        "SELECT ARRAY[n_name, r_name], contains(ARRAY[n_name, 'PERU'], "
        "'PERU'), element_at(ARRAY[n_name, r_name], -1) FROM nation "
        "JOIN region ON n_regionkey = r_regionkey",
    "constants":
        "SELECT ARRAY[1, 2, 3], element_at(ARRAY[10, 20], -1), "
        "contains(ARRAY[1, 2], 3), element_at(ARRAY[1, 2], 0)",
    "array_column":
        "SELECT n_nationkey, contains(ks, n_nationkey), element_at(ks, 2),"
        " element_at(ks, -9), cardinality(ks) FROM nation JOIN (SELECT "
        "n_regionkey rk, array_agg(n_nationkey) ks FROM nation GROUP BY "
        "n_regionkey) ON n_regionkey = rk WHERE contains(ks, 3) OR "
        "element_at(ks, 1) > 2",
    "map_column":
        "SELECT count(*), sum(cardinality(m)), sum(element_at(m, p)), "
        "count(element_at(m, k)) FROM (SELECT ps_suppkey k, "
        "min(ps_partkey) p, map_agg(ps_partkey, ps_supplycost) m FROM "
        "partsupp GROUP BY ps_suppkey)",
    "map_strings":
        "SELECT element_at(m, 'ALGERIA'), element_at(m, n_name), "
        "contains(ARRAY['x', n_name], 'x') FROM nation CROSS JOIN (SELECT "
        "histogram(n_name) m FROM nation GROUP BY n_regionkey % 1)",
}


def _full(x, n):
    if x is None:
        return None
    return x.expand((n,) + tuple(x.shape)) if x.dim() == 0 else x[:n]


def _same_values(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            a[~torch.isnan(a)], b[~torch.isnan(b)])
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def port_runner():
    return LocalQueryRunner.tpch("tiny", device="cpu")


@pytest.mark.parametrize("name", sorted(K11_QUERIES))
def test_k11_list_operations_match_plain(port_runner, name, monkeypatch):
    """Every step of the query runs three ways: the plain compiler (whose
    result the query goes on with), the Program's torch evaluator and the
    generated text under the stand-in; live rows must agree exactly."""
    steps = []

    def checked(step, page, params=()):
        want = step.plain(page, params)
        prog, _, evaluated, text = TK.kernel_outputs(step, page, params)
        n = int(page.num_rows)
        wants = [want] if step.mode == "filter" else list(want)
        for o, w, ev, tx in zip(prog.outputs, wants, evaluated, text):
            if o.kind != "kernel":
                continue
            if step.mode == "filter":
                got_ev = ev.value & (True if ev.valid is None
                                     else ev.valid) & page.row_mask()
                assert torch.equal(_full(got_ev, n), w[:n])
                assert torch.equal(tx[0][:n], w[:n])
                continue
            wv, wm = _full(w.values, n), _full(w.valid, n)
            keep = torch.ones(n, dtype=torch.bool) if wm is None else wm
            for gv, gm in ((ev.value, ev.valid), tx):
                gv, gm = _full(gv, n), _full(gm, n)
                assert (gm is None) == (wm is None)
                assert gm is None or torch.equal(gm, wm)
                assert _same_values(gv[keep], wv[keep])
        steps.append(step.exprs)
        return want
    monkeypatch.setattr(K.ExprStep, "__call__", checked)
    port_runner.execute(K11_QUERIES[name])

    def lists_in(e):
        return (isinstance(e, Call) and e.name in C.LIST_CALLS) or any(
            lists_in(c) for c in e.children())
    assert any(lists_in(e) for exprs in steps for e in exprs)
