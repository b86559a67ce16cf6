"""trino_tpu_torch.page against trino_tpu.page on seeded pages (CPU).

Page.filter (K1's plain twin), device_concat (K2's plain twin) and
Page.gather (K7's plain twin) take the same seeded numpy pages through both
packages: NULL validity, NaN, -0.0, all-false and all-true masks, indices
past both ends, capacity 0 and ragged live counts. Live rows must match bit
for bit (floats compared by their bits, so -0.0 and NaN count).
"""

import numpy as np
import pytest
import torch

from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT

torch.set_num_threads(1)


def port_type(t):
    """The port's Type equal to a reference Type (same class name and
    fields)."""
    import dataclasses
    cls = getattr(PT, type(t).__name__)
    return cls(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})


def to_port_page(page, device="cpu"):
    """A reference page carried across as host arrays."""
    arrays, valids, pools, typs = [], [], [], []
    for c in page.columns:
        arrays.append(np.asarray(c.values))
        valids.append(None if c.valid is None else np.asarray(c.valid))
        pools.append(None if c.dictionary is None
                     else list(c.dictionary.values))
        typs.append(port_type(c.type))
    return PP.page_from_host(arrays, valids, pools, typs,
                             int(page.num_rows), device=device)


def seeded_columns(rng, cap):
    """(arrays, types, valids, pools) of every layout the slice moves."""
    f = rng.normal(size=cap) * 1e3
    if cap:
        f[::7] = np.nan
        f[1::5] = -0.0
    words = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"], dtype=object)
    arrays = [rng.integers(-2**62, 2**62, size=cap, dtype=np.int64),
              f,
              rng.integers(-10**6, 10**6, size=cap).astype(np.int32),
              rng.random(cap) < 0.5,
              words[rng.integers(0, 5, size=cap)]]
    typs = [RT.BIGINT, RT.DOUBLE, RT.DATE, RT.BOOLEAN, RT.VARCHAR]
    valids = [rng.random(cap) < 0.8, None, rng.random(cap) < 0.5, None,
              rng.random(cap) < 0.9]
    return arrays, typs, valids


def ref_page(arrays, typs, valids, n):
    page = RP.Page.from_numpy(arrays, typs, valids=valids)
    return RP.Page(page.columns, np.int32(n))


def live_bits(page, n):
    """Live-row host arrays of a page (values as raw bits + validity)."""
    out = []
    for c in page.columns:
        v = np.asarray(c.values if not isinstance(c.values, torch.Tensor)
                       else c.values.numpy())[:n]
        if v.dtype == np.float64:
            v = v.view(np.int64)
        out.append(v)
        if c.valid is not None:
            valid = c.valid.numpy() if isinstance(c.valid, torch.Tensor) \
                else np.asarray(c.valid)
            out.append(valid[:n])
    return out


def assert_same_page(ref, port):
    n = int(ref.num_rows)
    assert int(port.num_rows) == n
    assert port.num_rows.dtype == torch.int32 and port.num_rows.dim() == 0
    for a, b in zip(live_bits(ref, n), live_bits(port, n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap,n", [(0, 0), (1, 1), (17, 17), (64, 40),
                                   (1000, 999)])
def test_round_trip_and_reference_conversion(cap, n):
    rng = np.random.default_rng(cap)
    arrays, typs, valids = seeded_columns(rng, cap)
    ref = ref_page(arrays, typs, valids, n)
    port = to_port_page(ref)
    assert port.capacity == cap
    assert [c.type for c in port.columns] == [port_type(t) for t in typs]
    assert_same_page(ref, port)
    # the host row form is the reference's, row for row
    got, want = port.to_host(), ref.to_host()
    for a, b in zip(got, want):
        assert len(a) == len(b) == n
        for x, y in zip(a, b):
            assert (x is None and y is None) or x == y or (x != x and y != y)
    direct = PP.Page.from_numpy(arrays, [port_type(t) for t in typs],
                                valids=valids, device="cpu")
    assert int(direct.num_rows) == cap
    assert direct.to_host(n)[4].tolist() == ref.to_host(n)[4].tolist()


MASKS = ["random", "all_false", "all_true", "alternate"]


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("cap,n", [(0, 0), (5, 5), (300, 211), (4097, 4097)])
def test_filter_matches_reference(mask_kind, cap, n):
    rng = np.random.default_rng(1000 + cap)
    arrays, typs, valids = seeded_columns(rng, cap)
    mask = {"random": rng.random(cap) < 0.4,
            "all_false": np.zeros(cap, dtype=bool),
            "all_true": np.ones(cap, dtype=bool),
            "alternate": np.arange(cap) % 2 == 0}[mask_kind]
    ref = ref_page(arrays, typs, valids, n)
    port = to_port_page(ref)
    got = port.filter(torch.from_numpy(mask))
    want = ref.filter(np.asarray(mask))
    assert_same_page(want, got)
    assert got.capacity == cap


def test_filter_scalar_mask_and_empty_page():
    rng = np.random.default_rng(7)
    arrays, typs, valids = seeded_columns(rng, 50)
    port = to_port_page(ref_page(arrays, typs, valids, 30))
    assert int(port.filter(torch.tensor(True)).num_rows) == 30
    assert int(port.filter(torch.tensor(False)).num_rows) == 0
    empty = PP.Page((), PP.row_count(0, torch.device("cpu")))
    assert int(empty.filter(torch.zeros(0, dtype=torch.bool)).num_rows) == 0


LAYOUTS = [
    [(10, 3), (0, 0), (40, 40), (5, 0)],
    [(16, 16), (16, 1)],
    [(3, 3), (2, 2), (7, 6), (1, 1), (9, 0)],
    [(0, 0), (0, 0)],
]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_concat_matches_reference(layout):
    rng = np.random.default_rng(len(layout) * 31 + layout[0][0])
    words = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"]
    pool_ref = RP.Dictionary(np.asarray(words, dtype=object))
    refs = []
    for i, (cap, n) in enumerate(layout):
        arrays, typs, valids = seeded_columns(rng, cap)
        arrays[4] = pool_ref.encode(arrays[4])
        # ragged validity: some pages carry NULL masks, others none
        if i % 2:
            valids = [None] * len(valids)
        page = RP.Page.from_numpy(arrays, typs, valids=valids,
                                  dictionaries=[None] * 4 + [pool_ref])
        refs.append(RP.Page(page.columns, np.int32(n)))
    ports = [to_port_page(p) for p in refs]
    got = PP.device_concat(ports)
    want = RP.device_concat(refs)
    assert got.capacity == want.capacity == sum(c for c, _ in layout)
    assert_same_page(want, got)


def test_device_concat_refuses_mixed_dictionaries():
    a = PP.Page.from_numpy([np.array(["x"], dtype=object)], [PT.VARCHAR],
                           device="cpu")
    b = PP.Page.from_numpy([np.array(["y"], dtype=object)], [PT.VARCHAR],
                           device="cpu")
    with pytest.raises(ValueError):
        PP.device_concat([a, b])


def test_shrink_pad_gather_and_dictionary():
    rng = np.random.default_rng(3)
    arrays, typs, valids = seeded_columns(rng, 20)
    ref = ref_page(arrays, typs, valids, 12)
    port = to_port_page(ref)
    assert_same_page(ref.shrink_to(16), port.shrink_to(16))
    assert port.pad_to(32).capacity == 32
    assert_same_page(ref.pad_to(32), port.pad_to(32))
    idx = np.array([5, 0, 19, 25, -1], dtype=np.int32)
    assert_same_page(ref.gather(idx, 5), port.gather(torch.from_numpy(idx),
                                                     5))
    d = PP.Dictionary.build(["b", "a", "c", "a"])[0]
    assert d.code_of("b") == 1 and d.code_of("z") == -1
    assert d == PP.Dictionary(np.array(["a", "b", "c"], dtype=object))


def test_entry_points_need_an_explicit_cpu_device():
    assert PP.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PP.resolve_device(None)


GATHERS = {"permutation": lambda rng, cap: rng.permutation(cap),
           "past_both_ends": lambda rng, cap: rng.integers(-5, cap + 5,
                                                            2 * cap),
           "repeat_first": lambda rng, cap: np.zeros(cap // 2, dtype=int),
           "empty": lambda rng, cap: np.zeros(0, dtype=int)}


@pytest.mark.parametrize("kind", sorted(GATHERS))
@pytest.mark.parametrize("cap,n", [(1, 1), (300, 211), (4097, 4000)])
def test_gather_matches_reference(kind, cap, n):
    rng = np.random.default_rng(500 + cap)
    arrays, typs, valids = seeded_columns(rng, cap)
    ref = ref_page(arrays, typs, valids, n)
    port = to_port_page(ref)
    idx = GATHERS[kind](rng, cap).astype(np.int32)
    count = min(n, len(idx))
    want = ref.gather(idx, count)
    got = port.gather(torch.from_numpy(idx).to(torch.int64), count)
    assert got.capacity == len(idx)
    assert_same_page(want, got)
    col = port.column(0).gather(torch.from_numpy(idx))
    np.testing.assert_array_equal(col.values.numpy(),
                                  np.asarray(ref.column(0).gather(idx)
                                             .values))


def test_constructors_default_to_cuda():
    """Column.from_numpy, Page.from_numpy, page_from_host and
    union_dictionaries place their tensors on cuda unless told otherwise,
    and raise without a card."""
    arr = np.arange(4, dtype=np.int64)
    d = PP.Dictionary(np.array(["a", "b"], dtype=object))
    calls = [lambda **kw: PP.Column.from_numpy(arr, PT.BIGINT, **kw),
             lambda **kw: PP.Page.from_numpy([arr], [PT.BIGINT], **kw),
             lambda **kw: PP.page_from_host([arr], [None], [None],
                                            [PT.BIGINT], 4, **kw),
             lambda **kw: PP.union_dictionaries([d, d], **kw)]
    for call in calls:
        assert call(device="cpu") is not None
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    page = PP.Page.from_numpy([arr], [PT.BIGINT], device="cpu")
    assert page.device.type == "cpu" and page.column(0).device.type == "cpu"
