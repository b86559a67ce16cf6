"""trino_tpu_torch.ops.window against trino_tpu.ops.window on seeded pages
(CPU: the plain twins of K20-K23).

Every function of RANKING, VALUE and AGGREGATE runs under every frame
kind: whole, running ROWS, running RANGE and bounded ROWS frames with each
side None, 0 or k (k wider than a partition included), over integer,
decimal, double (NaN, +-inf, -0.0), REAL and dictionary arguments with
NULLs, on pages with dead rows, NULL, NaN and -0.0 keys, no partition
keys, no order keys, one-row partitions and no live row. Integers,
decimals, dictionary codes and masks compare exactly; doubles to 1e-9
relative to the larger of the value and the sum of |x| over the row's
partition, which bounds every prefix the two scans add in their own
orders (the reference's associative_scan tree, the port's doubling
steps). Values compare where valid; every row up to num_rows compares.
"""

import numpy as np
import pytest
import torch

from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.ops import window as RW
from trino_tpu.ops.sort import SortKey as RSortKey
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.ops import window as PW
from trino_tpu_torch.ops.sort import SortKey as PSortKey

torch.set_num_threads(1)
CPU = torch.device("cpu")
POOL_A = np.asarray(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)
POOL_B = np.asarray(["FOB", "MAIL", "TRUCK"], dtype=object)

# column name -> (type name or ("DecimalType", p, s), pool)
SCHEMA = {
    "pk": ("BIGINT", None),            # partition key with NULLs
    "pd": ("DOUBLE", None),            # partition key: NaN, -0.0, NULL
    "pc": ("VARCHAR", POOL_A),         # dictionary partition key
    "pb": ("BOOLEAN", None),
    "ok": ("INTEGER", None),           # order key with ties and NULLs
    "od": ("DOUBLE", None),            # order key: -0.0 / +0.0 peers, NaN
    "row": ("BIGINT", None),           # unique order key
    "xi": ("BIGINT", None),            # arguments
    "xd": ("DOUBLE", None),
    "xdec": (("DecimalType", 12, 2), None),
    "xr": ("REAL", None),
    "x32": ("INTEGER", None),
    "xc": ("VARCHAR", POOL_A),
    "xc2": ("VARCHAR", POOL_B),        # a default from another dictionary
    "xb": ("BOOLEAN", None),
    "absd": ("DOUBLE", None),          # |xd| where finite (tolerance scale)
    "off": ("BIGINT", None),           # lead/lag offsets 0..3
    "nth": ("BIGINT", None),           # nth_value n: -1..4
    "k": ("BIGINT", None),             # ntile buckets
}
CH = {name: i for i, name in enumerate(SCHEMA)}


def ty(T, spec):
    return getattr(T, spec[0])(*spec[1:]) if isinstance(spec, tuple) \
        else getattr(T, spec)


def page_arrays(seed: int, cap: int, nparts: int):
    rng = np.random.default_rng(seed)
    xd = rng.choice([-1.5, -0.0, 0.0, 2.25, 1e6, np.nan, np.inf, -np.inf],
                    cap, p=[.2, .1, .1, .2, .25, .05, .05, .05])
    xd = np.where(rng.random(cap) < 0.5, rng.normal(0, 1e3, cap), xd)
    arrays = {
        "pk": (rng.integers(0, nparts, cap), rng.random(cap) < 0.9),
        "pd": (rng.choice([np.nan, -0.0, 0.0, 1.5, 2.5], cap),
               rng.random(cap) < 0.9),
        "pc": (rng.integers(0, 4, cap), rng.random(cap) < 0.9),
        "pb": (rng.random(cap) < 0.5, rng.random(cap) < 0.8),
        "ok": (rng.integers(-3, 4, cap), rng.random(cap) < 0.85),
        "od": (rng.choice([-0.0, 0.0, 1.0, np.nan], cap), None),
        "row": (rng.permutation(cap), None),
        "xi": (rng.integers(-10 ** 6, 10 ** 6, cap), rng.random(cap) < 0.8),
        "xd": (xd, rng.random(cap) < 0.85),
        "xdec": (rng.integers(-99999, 99999, cap), rng.random(cap) < 0.8),
        "xr": (rng.normal(0, 100, cap), rng.random(cap) < 0.9),
        "x32": (rng.integers(-50, 50, cap), None),
        "xc": (rng.integers(0, 4, cap), rng.random(cap) < 0.85),
        "xc2": (rng.integers(0, 3, cap), rng.random(cap) < 0.85),
        "xb": (rng.random(cap) < 0.5, rng.random(cap) < 0.9),
        "off": (rng.integers(0, 4, cap), None),
        "nth": (rng.integers(-1, 5, cap), None),
        "k": (np.full(cap, 3), None),
    }
    arrays["absd"] = (np.where(np.isfinite(xd), np.abs(xd), 0.0), None)
    out = {}
    for name, (t, _) in SCHEMA.items():
        vals, valid = arrays[name]
        out[name] = (np.asarray(vals).astype(
            ty(RT, t).dtype if name not in ("xc", "xc2", "pc") else np.int32),
            valid)
    return out


def pages(cols, n):
    names = list(SCHEMA)
    arrays = [cols[k][0] for k in names]
    valids = [cols[k][1] for k in names]
    ref = RP.Page.from_numpy(
        arrays, [ty(RT, SCHEMA[k][0]) for k in names], valids=valids,
        dictionaries=[None if SCHEMA[k][1] is None
                      else RP.Dictionary(SCHEMA[k][1]) for k in names])
    port = PP.Page.from_numpy(
        arrays, [ty(PT, SCHEMA[k][0]) for k in names], valids=valids,
        dictionaries=[None if SCHEMA[k][1] is None
                      else PP.Dictionary(SCHEMA[k][1]) for k in names],
        device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, CPU)))


# (function, argument columns, output type) per kind of argument
AGG_CASES = [("sum", ("xi",), "BIGINT"), ("sum", ("xd",), "DOUBLE"),
             ("sum", ("xdec",), ("DecimalType", 18, 2)),
             ("avg", ("xi",), "DOUBLE"), ("avg", ("xd",), "DOUBLE"),
             ("avg", ("xdec",), ("DecimalType", 12, 2)),
             ("avg", ("xr",), "REAL"),
             ("count", ("xd",), "BIGINT"), ("count", (), "BIGINT"),
             ("min", ("xi",), "BIGINT"), ("max", ("xd",), "DOUBLE"),
             ("min", ("xdec",), ("DecimalType", 12, 2)),
             ("max", ("x32",), "INTEGER"), ("min", ("xr",), "REAL"),
             ("max", ("xc",), "VARCHAR"), ("min", ("xd",), "DOUBLE")]
VALUE_CASES = [("first_value", ("xd",), "DOUBLE"),
               ("last_value", ("xc",), "VARCHAR"),
               ("nth_value", ("xi", "nth"), "BIGINT"),
               ("first_value", ("xb",), "BOOLEAN"),
               ("last_value", ("xdec",), ("DecimalType", 12, 2))]
LEAD_LAG = [("lead", ("xi",), "BIGINT"), ("lag", ("xd", "off"), "DOUBLE"),
            ("lead", ("xc", "off", "xc2"), "VARCHAR"),
            ("lag", ("x32", "off", "xi"), "BIGINT"),
            ("lag", ("xc", "off", "xc"), "VARCHAR")]
RANK_CASES = [("row_number", (), "BIGINT"), ("rank", (), "BIGINT"),
              ("dense_rank", (), "BIGINT"), ("percent_rank", (), "DOUBLE"),
              ("cume_dist", (), "DOUBLE"), ("ntile", ("k",), "BIGINT")]

K = 50      # wider than any partition of the pages below
FRAMES = {
    "whole": (True, False, None), "rows": (False, True, None),
    "range": (False, False, None),
    **{f"b{s}_{e}": (False, True, (s, e)) for s, e in (
        (None, 0), (None, 3), (None, K), (0, None), (-3, None),
        (-K, None), (-2, 2), (0, 0), (-3, 0), (0, 2), (1, 3), (-K, K),
        (-1, -1), (2, 1))},
}


def specs_for(T, frame):
    whole, rows, bounds = FRAMES[frame]
    cases = AGG_CASES + VALUE_CASES
    if frame == "range":
        cases = cases + RANK_CASES + LEAD_LAG
    spec = RW.WindowSpec if T is RT else PW.WindowSpec
    return [spec(name, tuple(CH[a] for a in args), ty(T, out), whole, rows,
                 bounds) for name, args, out in cases]


# (partition columns, order keys as (column, ascending, nulls_first))
LAYOUTS = {
    "int_keys": (("pk",), (("ok", True, None), ("row", True, None))),
    "nan_keys": (("pd", "pb"), (("od", False, None), ("row", True, None))),
    "dict_keys": (("pc",), (("ok", False, True), ("row", False, None))),
    "no_partition": ((), (("ok", True, False), ("row", True, None))),
    "no_order": (("pk",), ()),
}


def _ops(T, W, SK, layout, specs):
    part, okeys = LAYOUTS[layout]
    return W.window(tuple(CH[c] for c in part),
                    [SK(CH[c], a, nf) for c, a, nf in okeys], specs)


def run_both(layout, frame, n=231, cap=256, seed=7, nparts=12):
    """(reference output, port output, each row's partition sum of |xd|
    where finite, n) for every spec of `frame` under `layout`."""
    ref_page, port_page = pages(page_arrays(seed, cap, nparts), n)
    ref = _ops(RT, RW, RSortKey, layout, specs_for(RT, frame))(ref_page)
    port = _ops(PT, PW, PSortKey, layout, specs_for(PT, frame))(port_page)
    scale_spec = RW.WindowSpec("sum", (CH["absd"],), RT.DOUBLE, True, False)
    scale = _ops(RT, RW, RSortKey, layout, [scale_spec])(ref_page)
    return ref, port, np.asarray(scale.columns[-1].values)[:n], n


def assert_columns_match(ref_out, port_out, scale, n):
    """Every column (the input's, sorted, and each spec's) on the live
    rows: validity exactly, then values where valid."""
    assert len(ref_out.columns) == len(port_out.columns)
    assert int(port_out.num_rows) == int(ref_out.num_rows)
    for i, (rc, pc) in enumerate(zip(ref_out.columns, port_out.columns)):
        rv = np.asarray(rc.values)[:n]
        pv = pc.values[:n].numpy()
        rvalid = np.ones(n, bool) if rc.valid is None \
            else np.asarray(rc.valid)[:n]
        pvalid = np.ones(n, bool) if pc.valid is None \
            else pc.valid[:n].numpy()
        assert np.array_equal(rvalid, pvalid), f"column {i}: validity"
        assert (rc.dictionary is None) == (pc.dictionary is None)
        if rc.dictionary is not None:
            assert list(rc.dictionary.values) == list(pc.dictionary.values)
        assert rv.dtype == pv.dtype, f"column {i}: {rv.dtype} {pv.dtype}"
        rv, pv, sc = rv[rvalid], pv[rvalid], scale[rvalid]
        if np.issubdtype(rv.dtype, np.floating):
            with np.errstate(invalid="ignore"):
                same = (rv == pv) | (np.isnan(rv) & np.isnan(pv)) | (
                    np.abs(rv - pv) <= 1e-9 * np.maximum(np.abs(rv), sc))
            assert same.all(), (f"column {i}: {rv[~same][:5]} "
                                f"{pv[~same][:5]}")
        else:
            assert np.array_equal(rv, pv), f"column {i}: {rv[:8]} {pv[:8]}"


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_function_matches_the_reference(layout, frame):
    assert_columns_match(*run_both(layout, frame))


# (live rows, capacity, partitions): no live row, a full page, one-row
# partitions (a key per row), one partition
EDGE_PAGES = {"empty": (0, 64, 4), "full": (128, 128, 5),
              "one_row_partitions": (180, 256, 100000),
              "one_partition": (100, 128, 1)}


@pytest.mark.parametrize("frame", ["whole", "range", "rows", "b-2_2",
                                   "bNone_0", "b-3_None", "b-50_50"])
@pytest.mark.parametrize("edge", sorted(EDGE_PAGES))
def test_edge_pages_match_the_reference(edge, frame):
    n, cap, nparts = EDGE_PAGES[edge]
    assert_columns_match(*run_both("int_keys", frame, n=n, cap=cap,
                                   nparts=nparts))


def _tiny_page(pd, od):
    """A page of a DOUBLE partition key, a DOUBLE order key and a BIGINT
    argument, on both engines."""
    n = len(pd)
    arrays = [np.asarray(pd, np.float64), np.asarray(od, np.float64),
              np.arange(n, dtype=np.int64)]
    ref = RP.Page.from_numpy(arrays, [RT.DOUBLE, RT.DOUBLE, RT.BIGINT])
    port = PP.Page.from_numpy(arrays, [PT.DOUBLE, PT.DOUBLE, PT.BIGINT],
                              device="cpu")
    return ref, port


def _one(W, SK, T, page, name, args=(), bounds=None, whole=False):
    op = W.window((0,), [SK(1), SK(2)],
                  [W.WindowSpec(name, args, T.BIGINT, whole, True, bounds)])
    out = op(page)
    col = out.columns[-1]
    vals = np.asarray(col.values if W is RW else col.values.numpy())
    valid = None if col.valid is None else np.asarray(
        col.valid if W is RW else col.valid.numpy())
    return vals, valid


def test_nan_keys_each_start_a_partition_and_signed_zeros_are_peers():
    """The reference's change flags compare values with `!=`: every NaN
    key row starts its own partition (a quirk the port keeps), while
    -0.0 and +0.0 are one key."""
    pd = [np.nan, np.nan, -0.0, 0.0, 1.0, np.nan]
    od = [1.0, 1.0, 2.0, 1.0, -0.0, 0.0]
    ref, port = _tiny_page(pd, od)
    want, _ = _one(RW, RSortKey, RT, ref, "row_number")
    got, _ = _one(PW, PSortKey, PT, port, "row_number")
    assert list(got) == list(want)
    # sorted: -0.0/+0.0 (one partition of two rows), 1.0, then the three
    # NaN rows, each a partition of its own
    assert list(got) == [1, 2, 1, 1, 1, 1]
    ref, port = _tiny_page([1.0] * 4, [0.0, -0.0, 1.0, -0.0])
    op = PW.window((0,), [PSortKey(1)], [PW.WindowSpec(
        "rank", (), PT.BIGINT, False, False)])
    assert op(port).columns[-1].values.tolist() == [1, 1, 1, 4]


def test_empty_bounded_frames_give_null_and_a_count_of_zero():
    ref, port = _tiny_page([1.0, 1.0, 2.0], [1.0, 2.0, 3.0])
    for name in ("sum", "min", "count", "first_value", "nth_value"):
        args = (2, 2) if name == "nth_value" else (() if name == "count"
                                                    else (2,))
        got, valid = _one(PW, PSortKey, PT, port, name, args, (1, 3))
        want, wvalid = _one(RW, RSortKey, RT, ref, name, args, (1, 3))
        if name == "count":
            assert list(got) == list(want) == [1, 0, 0]
        else:
            assert list(valid) == list(wvalid)
            assert not valid[1] and not valid[2]


def test_dynamic_nth_below_one_gives_null():
    ref, port = _tiny_page([1.0] * 4, [1.0, 2.0, 3.0, 4.0])
    port = PP.Page(port.columns[:2] + (PP.Column(
        torch.tensor([0, -1, 1, 2]), None, PT.BIGINT),), port.num_rows)
    for bounds in (None, (-3, 3)):
        op = PW.window((0,), [PSortKey(1)], [PW.WindowSpec(
            "nth_value", (1, 2), PT.DOUBLE, True, True, bounds)])
        col = op(port).columns[-1]
        assert col.valid.tolist() == [False, False, True, True]


# ------------------------- K21's Triton text under a torch stand-in (CPU)

class _Ptr:
    def __init__(self, t, off=None):
        self.t, self.off = t, off
        self.dtype = type("PtrType", (), {"element_ty": t.dtype})

    def __add__(self, off):
        return _Ptr(self.t, off)


def _tensor(v, like):
    return v if isinstance(v, torch.Tensor) else torch.tensor(
        v, dtype=like.dtype if isinstance(like, torch.Tensor)
        else torch.int64)


class _TL:
    """The parts of triton.language K21 uses, as torch ops on one
    program's block of rows."""

    int64, float64, uint8 = torch.int64, torch.float64, torch.uint8
    constexpr = int
    pid = 0

    def program_id(self, axis):
        return torch.tensor(self.pid, dtype=torch.int32)

    @staticmethod
    def arange(a, b):
        return torch.arange(a, b, dtype=torch.int32)

    @staticmethod
    def load(ptr, mask=None, other=0):
        if ptr.off is None:
            return ptr.t.reshape(())
        vals = ptr.t[ptr.off.clamp(0, ptr.t.numel() - 1)]
        return torch.where(mask, vals, torch.tensor(other, dtype=vals.dtype))

    @staticmethod
    def store(ptr, val, mask=None):
        ptr.t[ptr.off[mask]] = torch.broadcast_to(
            val, ptr.off.shape)[mask].to(ptr.t.dtype)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, _tensor(a, b), _tensor(b, a))

    @staticmethod
    def minimum(a, b):
        return torch.minimum(_tensor(a, b), _tensor(b, a))

    @staticmethod
    def maximum(a, b):
        return torch.maximum(_tensor(a, b), _tensor(b, a))


class _ShimK21:
    """kernel[grid](*args, **constexprs), each program in turn."""

    def __init__(self, tl):
        self.tl = tl

    def __getitem__(self, grid):
        def launch(*args, num_warps=None, **kw):
            args = [_Ptr(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in range(grid[0]):
                self.tl.pid = pid
                PW._rank_value_kernel(*args, **kw)
        return launch


@pytest.fixture
def k21_shim(monkeypatch):
    tl = _TL()
    monkeypatch.setattr(PW, "tl", tl, raising=False)
    monkeypatch.setattr(PW, "_k21", lambda: _ShimK21(tl))
    monkeypatch.setattr(PW, "RANK_VALUE_BLOCK", 64)


@pytest.mark.parametrize("frame", ["whole", "rows", "range", "b-2_2",
                                   "bNone_0", "b0_None", "b1_3", "b2_1",
                                   "b-50_50"])
def test_k21_text_matches_its_twin(k21_shim, frame):
    """K21's kernel text (run per program under the stand-in) gives the
    plain twin's columns for every ranking and value function."""
    _, port_page = pages(page_arrays(11, 200, 9), 187)
    whole, rows, bounds = FRAMES[frame]
    cases = VALUE_CASES + RANK_CASES + LEAD_LAG
    specs = [PW.WindowSpec(name, tuple(CH[a] for a in args), ty(PT, out),
                           whole, rows, bounds) for name, args, out in cases]
    sort = PW.window((CH["pk"],), [PSortKey(CH["ok"]), PSortKey(CH["row"])],
                     [])(port_page)
    b = PW.window_bounds_plain(sort, (CH["pk"],), (CH["ok"], CH["row"]))
    before = PW.rank_value_triton.launches
    for spec in specs:
        want = PW.rank_value_plain(spec, sort, b)
        got = PW.rank_value_triton(spec, sort, b)
        n = 187
        assert got.values.dtype == want.values.dtype
        assert got.dictionary == want.dictionary
        wv = want.valid_mask()[:n]
        assert torch.equal(got.valid_mask()[:n], wv), spec.name
        g, w = got.values[:n][wv], want.values[:n][wv]
        if g.is_floating_point():
            assert torch.allclose(g, w, rtol=0, atol=0, equal_nan=True), \
                spec.name
        else:
            assert torch.equal(g, w), spec.name
    assert PW.rank_value_triton.launches - before == len(specs)
