"""K17 and K26 on the CPU: the plain models of what the one-launch designs
of csrc/join_spill.cu (spill_probe) and csrc/join_mxu.cu (key_bounds) do,
and both wrappers' arguments and buffers read back the way the kernels
read them.

K17 is one launch in either mode with no memset: the blocks walk the live
prefix only (found and brow past num_rows are left unwritten), each
block's match count goes to K6's per-device word and the block that takes
the last ticket writes the call's own count word. K26 is one launch: the
blocks stride the live prefix, reading the key in its own width, fold
their five values into per-device words with one atomic each, and the
block that takes the last ticket writes the call's five words from them
and sets them back. The models
(ops/join.py spill_probe_launch_model, ops/join_mxu.py
key_bounds_launch_model) are held against spill_probe_plain and
key_bounds_plain bit for bit; the twins themselves are held against the
JAX package by test_torch_join_spill.py and test_torch_join_mxu_agg.py.
"""

import ast
import ctypes
import pathlib

import numpy as np
import pytest
import torch

from trino_tpu_torch import launch_trace as LT
from trino_tpu_torch import native
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import join_mxu as JM

torch.set_num_threads(1)
TESTS = pathlib.Path(__file__).resolve().parent
CSRC = pathlib.Path(J.__file__).resolve().parents[1] / "csrc"
DTYPES = {(1, 0): torch.int8, (2, 0): torch.int16, (4, 0): torch.int32,
          (8, 0): torch.int64, (4, 1): torch.float32, (8, 1): torch.float64}
ORDERS = ("forward", "reversed", "shuffled")


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


def column_at(ptr: int, vptr: int, esz: int, is_float: int, cap: int):
    """A key column (values, valid) read as the kernels read it: values
    at the pointer in the element size and kind, the validity a byte a row
    (None at pointer 0)."""
    values = mem(ptr, ctypes.c_uint8, cap * esz, torch.uint8).view(
        DTYPES[(esz, is_float)])
    valid = None if vptr == 0 else mem(vptr, ctypes.c_bool, cap, torch.bool)
    return values, valid


def block_order(order: str, grid: int):
    return {"forward": list(range(grid)),
            "reversed": list(range(grid))[::-1],
            "shuffled": [int(b) for b in np.random.default_rng(grid)
                         .permutation(grid)]}[order]


# ------------------------------------------------------------- K26 model

# test_torch_join_mxu_agg.py's CASES, read from its text (that file
# imports the JAX package, this one does not)
_AGG = (TESTS / "test_torch_join_mxu_agg.py").read_text()
_AGG_TREE = ast.parse(_AGG)
AGG_CASES = next(ast.literal_eval(node.value) for node in _AGG_TREE.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "CASES")


def agg_key(name: str):
    """The build key column of one of those cases as its `case` makes it
    (the same seed and draws): (values, valid, num_rows)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cap, n, kind, distinct, _, _, _ = AGG_CASES[name]
    pick = rng.integers(0, distinct, cap)
    if kind == "negative":
        keys = pick - 50
    elif kind == "double":
        base = int(np.float64(1.0).view(np.int64))
        keys = (pick + base).view(np.float64).copy()
        keys[rng.random(cap) < 0.05] = -0.0
    else:
        keys = pick + 1000
    rng.integers(-10**6, 10**6, cap)
    rng.standard_normal(cap)
    rng.integers(-1000, 1000, cap)
    rng.integers(0, 9, cap)
    valid = rng.random(cap) >= 0.05
    return (torch.from_numpy(keys), torch.from_numpy(valid),
            torch.tensor(n, dtype=torch.int32))


def run_bounds_model(values, valid, n: int, grid: int, order: str):
    acc = torch.tensor(JM.key_bounds_acc_init())
    out = torch.full((JM.KEY_BOUNDS_WORDS,), -3, dtype=torch.int64)
    reads = JM.key_bounds_launch_model(values, valid, n, grid, acc, out,
                                       block_order(order, grid))
    # the ticket and the reductions are set back for the next call
    assert acc.tolist() == JM.key_bounds_acc_init()
    return out, reads


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", [1, 3, 40])
@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_k26_model_gives_the_twin(name, grid, order):
    """Over the fused join's build keys (integers, negative keys, doubles
    with -0.0, the empty build): the five words equal key_bounds_plain's
    bit for bit in any block order, and each live row is read once and no
    row past num_rows at all."""
    values, valid, nr = agg_key(name)
    out, reads = run_bounds_model(values, valid, int(nr), grid, order)
    assert torch.equal(out, JM.key_bounds_plain(values, valid, nr))
    assert torch.equal(reads, (torch.arange(values.shape[0]) < int(nr))
                       .to(torch.int64))


def typed_keys(dtype: str, cap: int, seed: int):
    """A key column of `dtype` with NULLs; floats with NaN, -0.0, +0.0
    and both infinities among them."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-100, 100, cap)
    if dtype == "bool":
        values = torch.from_numpy(v > 0)
    elif dtype.startswith("float"):
        f = (v * 0.75).astype(dtype)
        f[::17] = np.nan
        f[3::13] = -0.0
        f[5::19] = 0.0
        f[7::23] = np.inf
        f[9::29] = -np.inf
        values = torch.from_numpy(f)
    else:
        values = torch.from_numpy(v.astype(dtype))
    return values, torch.from_numpy(rng.random(cap) >= 0.1)


KEY_TYPES = ("int8", "int16", "int32", "int64", "bool", "float32",
             "float64")
TILE = JM.KEY_BOUNDS_THREADS * JM.KEY_BOUNDS_ROWS


@pytest.mark.parametrize("rows", ["none", "inside a tile", "tile boundary",
                                  "capacity"])
@pytest.mark.parametrize("dtype", KEY_TYPES)
def test_k26_model_over_key_types(dtype, rows):
    """Every key width and kind, with NULLs, an all-NULL column and no
    validity, num_rows 0, inside a tile, on a tile boundary and equal to
    the capacity, over grids of 1, 3 and many blocks."""
    cap = 3 * TILE + 77
    n = {"none": 0, "inside a tile": TILE + 300, "tile boundary": 2 * TILE,
         "capacity": cap}[rows]
    values, valid = typed_keys(dtype, cap, seed=len(dtype) + n)
    nr = torch.tensor(n, dtype=torch.int32)
    for va in (valid, None, torch.zeros(cap, dtype=torch.bool)):
        want = JM.key_bounds_plain(values, va, nr)
        for grid, order in ((1, "forward"), (3, "shuffled"),
                            (17, "reversed")):
            out, _ = run_bounds_model(values, va, n, grid, order)
            assert torch.equal(out, want), (out.tolist(), want.tolist())


def test_k26_words_of_the_edges():
    """What the words hold at the edges: no live key gives kmin > kmax
    (u64::MAX, 0) and the identities (int64 max/min, +inf/-inf bits); a
    NaN gives NaN bits for lo and hi and lo_nan 1; -0.0 is the key +0.0
    but the lowest value in the column's own order."""
    nr = torch.tensor(4, dtype=torch.int32)
    dead = torch.zeros(4, dtype=torch.bool)
    ints, _ = run_bounds_model(torch.arange(4), dead, 4, 2, "forward")
    assert ints.tolist() == [-1, 0, JM._I64_MAX, JM._I64_MIN, 0]
    floats, _ = run_bounds_model(torch.zeros(4, dtype=torch.float64), dead,
                                 4, 2, "forward")
    assert floats.tolist() == [-1, 0, 0x7FF0000000000000,
                               -0x10000000000000, 0]
    nan = torch.tensor([1.0, float("nan"), -2.0, 0.0], dtype=torch.float32)
    out, _ = run_bounds_model(nan, None, 4, 1, "forward")
    assert out[JM.B_LO:].tolist() == [JM._F64_NAN_BITS] * 2 + [1]
    assert torch.equal(out, JM.key_bounds_plain(nan, None, nr))
    zero = torch.tensor([0.0, -0.0, 0.0, -0.0], dtype=torch.float64)
    out, _ = run_bounds_model(zero, None, 4, 3, "shuffled")
    assert out[:2].tolist() == [0, 0]
    assert out[JM.B_LO] == torch.tensor(-0.0, dtype=torch.float64).view(
        torch.int64)
    assert out[JM.B_HI] == 0 and out[JM.B_LO_NAN] == 0


@pytest.mark.parametrize("cap,sms,want", [
    (0, 132, 1), (1, 132, 1), (2048, 132, 1), (2049, 132, 2),
    (2_097_152, 132, 264), (2_097_152, 114, 228), (300_000, 132, 147),
    (1 << 26, 300, 600)])
def test_k26_grid_is_sized_to_the_card(cap, sms, want):
    """One block per tile of 256 x 8 rows of capacity, at most 2 per SM."""
    assert JM.key_bounds_grid(cap, sms) == want


# --------------------------------------------------- K26 through its wrapper


def bounds_kernel_model(monkeypatch, sms: int = 132):
    """Run key_bounds_cuda on CPU tensors: the launch reads the key column,
    its validity and num_rows at their pointers and runs the model on the
    scratch and the output behind theirs (device memory starts as
    garbage). Returns the launches and the per-device scratches."""
    calls, scratches = [], {}

    def scratch_of(index):
        if index not in scratches:
            scratches[index] = torch.tensor(JM.key_bounds_acc_init())
        return scratches[index]

    def key_bounds(values, valid, esz, is_float, num_rows, cap, scratch,
                   out, grid, stream):
        v, a = column_at(values, valid, esz, is_float, cap)
        n = ctypes.c_int32.from_address(num_rows).value
        acc = mem(scratch, ctypes.c_int64, 6, torch.int64)
        assert acc.tolist() == JM.key_bounds_acc_init()
        o = mem(out, ctypes.c_int64, JM.KEY_BOUNDS_WORDS, torch.int64)
        o.fill_(-7)
        JM.key_bounds_launch_model(v, a, max(0, min(n, cap)), grid, acc, o)
        calls.append(dict(values=values, valid=valid, esz=esz,
                          is_float=is_float, cap=cap, scratch=scratch,
                          out=out, grid=grid, stream=stream))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: key_bounds)
    monkeypatch.setattr(native, "raw_stream", lambda index: 11)
    monkeypatch.setattr(native, "sm_count", lambda index: sms)
    monkeypatch.setattr(JM, "_key_bounds_scratch", scratch_of)
    return calls, scratches


@pytest.mark.parametrize("dtype", KEY_TYPES)
def test_k26_wrapper_is_one_launch(monkeypatch, dtype):
    """One launch with the key's own pointer, width and kind (no widened
    copy), its validity's pointer (0 without one), the grid of
    key_bounds_grid and the per-device scratch; one allocation, the five
    output words, which equal the twin's."""
    cap, n = 5000, 4321
    values, valid = typed_keys(dtype, cap, seed=3)
    nr = torch.tensor(n, dtype=torch.int32)
    calls, scratches = bounds_kernel_model(monkeypatch)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a)
                        or empty(*a, **{k_: v for k_, v in k.items()
                                        if k_ != "device"}))
    for va in (valid, None):
        before = JM.key_bounds_cuda.launches
        del made[:]
        out = JM.key_bounds_cuda(values, va, nr)
        assert JM.key_bounds_cuda.launches == before + 1
        assert made == [(JM.KEY_BOUNDS_WORDS,)]
        c = calls[-1]
        assert (c["values"], c["esz"], c["is_float"]) == (
            values.data_ptr(), values.element_size(),
            int(values.is_floating_point()))
        assert c["valid"] == (0 if va is None else va.data_ptr())
        assert (c["cap"], c["grid"], c["stream"]) == (
            cap, JM.key_bounds_grid(cap, 132), 11)
        assert c["scratch"] == scratches[0].data_ptr()
        assert c["out"] == out.data_ptr()
        assert torch.equal(out, JM.key_bounds_plain(values, va, nr))
    assert len(calls) == 2 and len(scratches) == 1


def test_k26_entry_points_take_the_kernel(monkeypatch):
    """key_bounds_words and the fused join's key_bounds(channel) take the
    kernel for a CUDA tensor (here the wrapper's model) and the twin for a
    CPU one."""
    values, valid = typed_keys("int64", 700, seed=5)
    nr = torch.tensor(650, dtype=torch.int32)
    want = JM.key_bounds_plain(values, valid, nr)
    assert torch.equal(JM.key_bounds_words(values, valid, nr), want)
    calls, _ = bounds_kernel_model(monkeypatch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert torch.equal(JM.key_bounds_words(values, valid, nr), want)
    assert len(calls) == 1


def test_k26_scratch_is_made_once_per_device(monkeypatch):
    """The ticket and the five reductions are set to their identities
    once per device; later calls reuse them."""
    made = []
    monkeypatch.setattr(JM, "_KEY_BOUNDS_SCRATCH", {})
    monkeypatch.setattr(torch, "tensor", lambda v, dtype, device: made.append(
        (v, dtype, str(device))) or torch.empty(0))
    assert JM._key_bounds_scratch(0) is JM._key_bounds_scratch(0)
    assert JM._key_bounds_scratch(1) is not JM._key_bounds_scratch(0)
    init = [0, -1, 0, (1 << 63) - 1, -(1 << 63), 0]
    assert made == [(init, torch.int64, "cuda:0"),
                    (init, torch.int64, "cuda:1")]


def test_k26_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    values, valid = typed_keys("int32", 64, seed=1)
    nr = torch.tensor(60, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        JM.key_bounds_cuda(values, valid, nr)
    bounds_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        JM.key_bounds_cuda(values, valid, nr.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        JM.key_bounds_cuda(values, valid, nr.reshape(1))
    with pytest.raises(ValueError, match="does not match"):
        JM.key_bounds_cuda(values[::2], None, nr)
    with pytest.raises(ValueError, match="does not match"):
        JM.key_bounds_cuda(values.to(torch.float16), None, nr)
    with pytest.raises(ValueError, match="validity"):
        JM.key_bounds_cuda(values, valid.to(torch.uint8), nr)
    with pytest.raises(ValueError, match="validity"):
        JM.key_bounds_cuda(values, valid[:32], nr)


def test_k26_is_cuda_and_not_triton():
    """K26's kernel lives in csrc/join_mxu.cu with its enqueue count; no
    Triton program and no widened copy of a float key remain."""
    text = (CSRC / "join_mxu.cu").read_text()
    assert "TT_EXPORT int key_bounds(" in text
    assert "TT_EXPORT int64_t key_bounds_enqueues()" in text
    src = pathlib.Path(JM.__file__).read_text()
    for gone in ("triton", "_float_bits", "key_bounds_triton", "tl."):
        assert gone not in src


# ------------------------------------------------------------- K17 model


def spill_keys(kind: str, cap: int, seed: int):
    """Build key columns: a shuffled dense span with NULLs; negative
    int32 keys; a composite (int32, int64) of distinct tuples."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        v = torch.from_numpy(rng.permutation(cap) * 3 + 1000)
        return [(v, torch.from_numpy(rng.random(cap) >= 0.1))]
    if kind == "negative":
        v = torch.from_numpy(-2 * rng.permutation(cap).astype(np.int32) - 7)
        return [(v, torch.from_numpy(rng.random(cap) >= 0.05))]
    a = torch.from_numpy(rng.integers(0, 40, cap).astype(np.int32))
    b = torch.from_numpy(rng.permutation(cap) * 5 - cap)
    return [(a, torch.from_numpy(rng.random(cap) >= 0.1)), (b, None)]


def spill_probe_keys(bcols, cap: int, seed: int):
    """Probe columns: build keys (hits), keys past the span, keys below
    the smallest key, NULLs."""
    rng = np.random.default_rng(seed)
    bcap = bcols[0][0].shape[0]
    pick = torch.from_numpy(rng.integers(0, max(bcap, 1), cap))
    kind = torch.from_numpy(rng.integers(0, 4, cap))
    out = []
    for values, _ in bcols:
        v = values[pick] if bcap else torch.zeros(cap, dtype=values.dtype)
        v = torch.where(kind == 1, v + 10**6, v)
        v = torch.where(kind == 2, v - 10**6, v)
        out.append((v.contiguous(),
                    torch.from_numpy(rng.random(cap) >= 0.05)))
    return out


SPILL_CASES = {  # key kind, build cap, live build rows, probe cap, live
    "dense, dead and NULL rows": ("dense", 300, 280, 1001, 950),
    "negative keys": ("negative", 200, 200, 640, 640),
    "composite keys": ("composite", 250, 240, 777, 700),
    "empty build": ("dense", 64, 0, 100, 100),
    "no live probe row": ("dense", 64, 64, 100, 0),
    "live to capacity": ("dense", 128, 128, 1536, 1536),
    "probe capacity 0": ("dense", 64, 64, 0, 0),
}


def spill_setup(case: str, mode: int):
    """(probe cols, probe live rows, the lookup the kernel reads, K16's
    stats) of one case: K16's sorted keys and permutation, or the dense
    row table over their span (K5's dense mode with the permutation as
    payload; a composite key's span is its mixed words', so its table
    holds the slots from kmin)."""
    kind, bcap, bn, pcap, pn = SPILL_CASES[case]
    bcols = spill_keys(kind, bcap, seed=len(case))
    pcols = spill_probe_keys(bcols, pcap, seed=len(case) + 1)
    keys, perm, stats = J.spill_prep_plain(
        bcols, torch.tensor(bn, dtype=torch.int32))
    if mode == J.SPILL_SEARCH:
        return pcols, pn, (keys, perm), stats
    table = J.join_dense_plain([(keys, None)],
                               stats[J.N_LIVE].to(torch.int32), stats, 2048,
                               perm)
    return pcols, pn, table, stats


def run_spill_model(pcols, pn, mode, lookup, stats, grid, scratch,
                    order=None):
    cap = pcols[0][0].shape[0]
    found = torch.ones(cap, dtype=torch.bool)       # garbage: found set
    brow = torch.full((cap,), -9, dtype=torch.int64)
    count = torch.full((), -5, dtype=torch.int64)
    stores = J.spill_probe_launch_model(pcols, pn, mode, lookup, stats,
                                        grid, scratch, found, brow, count,
                                        order)
    return found, brow, count, stores


MODES = {"dense": J.SPILL_DENSE, "search": J.SPILL_SEARCH}


@pytest.mark.parametrize("grid", [1, 2, 9])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(SPILL_CASES))
def test_k17_model_gives_the_twin_on_the_live_rows(case, mode, grid):
    """Each live row is stored exactly once and no row past num_rows at
    all (its garbage stays); found and brow equal spill_probe_plain's on
    the live rows bit for bit (a composite key, keys outside the span,
    the table's INT32_MAX slots, NULL keys, the empty build); the block
    that takes the last ticket writes the twin's count and leaves the
    per-device word 0, in any block order."""
    m = MODES[mode]
    pcols, pn, lookup, stats = spill_setup(case, m)
    cap = pcols[0][0].shape[0]
    wf, wb, wc = J.spill_probe_plain(pcols, torch.tensor(
        pn, dtype=torch.int32), m, lookup, stats)
    for order in ORDERS:
        scratch = torch.zeros(1, dtype=torch.int64)
        found, brow, count, stores = run_spill_model(
            pcols, pn, m, lookup, stats, grid, scratch,
            block_order(order, grid))
        assert torch.equal(found[:pn], wf[:pn])
        assert torch.equal(brow[:pn], wb[:pn])
        assert found[pn:].all() and (brow[pn:] == -9).all()
        assert int(count) == int(wc) and int(scratch[0]) == 0
        assert torch.equal(stores, (torch.arange(cap) < pn).to(torch.int64))


def test_k17_dense_table_holds_empty_slots():
    """The dense case's table has INT32_MAX slots inside the span (keys
    every third value), so probes that land on them find nothing."""
    pcols, pn, table, stats = spill_setup("dense, dead and NULL rows",
                                          J.SPILL_DENSE)
    assert int((table == J._I32_MAX).sum()) > 0
    raw = J._key_cols(pcols)[0][:pn] - stats[J.KMIN]
    inside = (raw >= 0) & (raw < table.numel())
    on_empty = inside & (table[raw.clamp(0, table.numel() - 1)]
                         == J._I32_MAX)
    assert int(on_empty.sum()) > 0


def test_k17_counts_of_two_calls_in_flight():
    """Two probes launched before one fetch share the per-device word;
    each count lands in its own word, both right, and the word is 0
    after each."""
    scratch = torch.zeros(1, dtype=torch.int64)
    got, want = [], []
    for case, mode, grid in (("composite keys", J.SPILL_SEARCH, 5),
                             ("dense, dead and NULL rows", J.SPILL_DENSE,
                              2)):
        pcols, pn, lookup, stats = spill_setup(case, mode)
        _, _, count, _ = run_spill_model(pcols, pn, mode, lookup, stats,
                                         grid, scratch)
        got.append(count)
        want.append(int(J.spill_probe_plain(pcols, torch.tensor(
            pn, dtype=torch.int32), mode, lookup, stats)[2]))
        assert int(scratch[0]) == 0
    assert torch.stack(got).tolist() == want and want[0] != want[1]


@pytest.mark.parametrize("cap,mode,sms,want", [
    (0, J.SPILL_DENSE, 132, 1), (512, J.SPILL_DENSE, 132, 1),
    (513, J.SPILL_DENSE, 132, 2), (513, J.SPILL_SEARCH, 132, 3),
    (5_242_880, J.SPILL_DENSE, 132, 1056),
    (5_242_880, J.SPILL_SEARCH, 114, 912),
    (1 << 26, J.SPILL_DENSE, 300, J.PROBE_GRID_MAX)])
def test_k17_grid_is_sized_to_the_card(cap, mode, sms, want):
    """K6's sizing: one block per tile of 256 x 2 rows of capacity in
    dense mode, 256 searching, at most 8 per SM and PROBE_GRID_MAX."""
    assert J.spill_probe_grid(cap, mode, sms) == want


# -------------------------------------------------- K17 through its wrapper


def spill_kernel_model(monkeypatch):
    """Run spill_probe_cuda on CPU tensors: the launch reads its parameter
    words (the probe key columns), num_rows, K16's stats and the mode's
    lookup at their pointers, scribbles over the outputs (device memory
    starts as garbage) and runs the model into found, brow and count with
    K6's per-device word behind its pointer. Returns the launches and the
    per-device words."""
    calls, scratches = [], {}

    def scratch_of(index):
        if index not in scratches:
            scratches[index] = torch.zeros(1, dtype=torch.int64)
        return scratches[index]

    def spill_probe(table, nkeys, cap, num_rows, mode, dense, size, bkeys,
                    bperm, nbuild, stats, found, brow, count, ticket, grid,
                    stream):
        words = list((ctypes.c_int64 * (4 * nkeys)).from_address(table))
        pcols = [column_at(*words[q:q + 4], cap)
                 for q in range(0, len(words), 4)]
        n = max(0, min(ctypes.c_int32.from_address(num_rows).value, cap))
        st = mem(stats, ctypes.c_int64, J.N_STATS, torch.int64)
        if mode == J.SPILL_DENSE:
            assert bkeys == bperm == nbuild == 0
            lookup = mem(dense, ctypes.c_int32, size, torch.int32)
        else:
            assert dense == size == 0
            lookup = (mem(bkeys, ctypes.c_int64, nbuild, torch.int64),
                      mem(bperm, ctypes.c_int32, nbuild, torch.int32))
        f = mem(found, ctypes.c_bool, cap, torch.bool)
        b = mem(brow, ctypes.c_int64, cap, torch.int64)
        c = mem(count, ctypes.c_int64, 1, torch.int64)
        f.fill_(True)
        b.fill_(-9)
        c.fill_(-5)
        scratch = mem(ticket, ctypes.c_int64, 1, torch.int64)
        assert int(scratch[0]) == 0
        J.spill_probe_launch_model(pcols, n, mode, lookup, st, grid, scratch,
                                   f, b, c[0])
        calls.append(dict(words=words, cap=cap, mode=mode, grid=grid,
                          found=found, brow=brow, count=count, ticket=ticket,
                          stream=stream))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: spill_probe)
    monkeypatch.setattr(native, "raw_stream", lambda index: 13)
    monkeypatch.setattr(native, "sm_count", lambda index: 132)
    monkeypatch.setattr(J, "_probe_scratch", scratch_of)
    return calls, scratches


def block_words(words: int) -> int:
    for limit in (8, 64, native.TABLE_MAX):
        if words <= limit:
            return limit
    return 0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("nkeys,block", [(1, 8), (2, 8), (3, 64),
                                         (17, native.TABLE_MAX)])
def test_k17_wrapper_reads_its_block(monkeypatch, nkeys, block, mode):
    """One launch; the parameter words are 4 per probe key column
    (values, validity or 0, element size, float flag) in a block of 8
    words for 1 or 2 columns, 64 for 3 and the full table past 16; found,
    brow and count are views of one allocation (probe_outputs) at the
    pointers the kernel writes; the tickets go to K6's per-device word;
    the grid is spill_probe_grid's; on the live rows the outputs equal the
    twin's."""
    m = MODES[mode]
    rng = np.random.default_rng(nkeys)
    bcap, bn, pcap, pn = 300, 290, 1001, 950
    bcols = [(torch.from_numpy(rng.permutation(bcap) * 2 + 5),
              torch.from_numpy(rng.random(bcap) >= 0.1))] + [
        (torch.from_numpy(rng.integers(0, 2, bcap).astype(np.int16)), None)
        for _ in range(nkeys - 1)]
    pcols = spill_probe_keys(bcols, pcap, seed=nkeys + 1)
    keys, perm, stats = J.spill_prep_plain(
        bcols, torch.tensor(bn, dtype=torch.int32))
    lookup = (keys, perm) if m == J.SPILL_SEARCH else J.join_dense_plain(
        [(keys, None)], stats[J.N_LIVE].to(torch.int32), stats, 1024, perm)
    pnr = torch.tensor(pn, dtype=torch.int32)
    calls, scratches = spill_kernel_model(monkeypatch)
    before = J.spill_probe_cuda.launches
    found, brow, count = J.spill_probe_cuda(pcols, pnr, m, lookup, stats)
    assert J.spill_probe_cuda.launches == before + 1 and len(calls) == 1
    c = calls[0]
    assert block_words(4 * nkeys) == block
    assert c["words"] == J._key_table(pcols)
    assert (c["mode"], c["cap"], c["stream"]) == (m, pcap, 13)
    assert c["grid"] == J.spill_probe_grid(pcap, m, 132)
    assert (c["found"], c["brow"], c["count"]) == (
        found.data_ptr(), brow.data_ptr(), count.data_ptr())
    assert c["ticket"] == scratches[0].data_ptr()
    base = brow.untyped_storage().data_ptr()
    assert found.untyped_storage().data_ptr() == base
    assert count.untyped_storage().data_ptr() == base
    wf, wb, wc = J.spill_probe_plain(pcols, pnr, m, lookup, stats)
    assert torch.equal(found[:pn], wf[:pn]) and torch.equal(brow[:pn],
                                                            wb[:pn])
    assert found[pn:].all() and (brow[pn:] == -9).all()   # left unwritten
    assert int(count) == int(wc) and count.dim() == 0


def test_k17_wrapper_two_calls_before_one_fetch(monkeypatch):
    """As the spilled join's batch does: two probes launched, then ONE
    torch.stack(...).tolist() of their counts; each is right, the
    per-device word is the same for both and the outputs are not."""
    calls, scratches = spill_kernel_model(monkeypatch)
    results, wants = [], []
    for case, mode in (("composite keys", J.SPILL_SEARCH),
                       ("negative keys", J.SPILL_DENSE)):
        pcols, pn, lookup, stats = spill_setup(case, mode)
        pnr = torch.tensor(pn, dtype=torch.int32)
        results.append(J.spill_probe_cuda(pcols, pnr, mode, lookup, stats))
        wants.append(int(J.spill_probe_plain(pcols, pnr, mode, lookup,
                                             stats)[2]))
    assert torch.stack([c for _, _, c in results]).tolist() == wants
    assert calls[0]["ticket"] == calls[1]["ticket"] == \
        scratches[0].data_ptr()
    assert calls[0]["count"] != calls[1]["count"]


def test_k17_entry_points_take_the_kernel(monkeypatch):
    """spilled_dense_probe's op goes through spill_probe to the kernel for
    a CUDA page (here the wrapper's model) and carries brow as the pre
    page's last column."""
    from trino_tpu_torch.page import Column, Page
    from trino_tpu_torch import types as T
    pcols, pn, table, stats = spill_setup("dense, dead and NULL rows",
                                          J.SPILL_DENSE)
    page = Page((Column(pcols[0][0], pcols[0][1], T.BIGINT, None),),
                torch.tensor(pn, dtype=torch.int32))
    calls, _ = spill_kernel_model(monkeypatch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    pre, found, count = J.spilled_dense_probe([0])(page, table, stats)
    assert len(calls) == 1 and calls[0]["mode"] == J.SPILL_DENSE
    wf, wb, wc = J.spill_probe_plain(pcols, page.num_rows, J.SPILL_DENSE,
                                     table, stats)
    assert torch.equal(pre.columns[-1].values[:pn], wb[:pn])
    assert torch.equal(found[:pn], wf[:pn]) and int(count) == int(wc)


def test_k17_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    pcols, pn, table, stats = spill_setup("negative keys", J.SPILL_DENSE)
    _, _, (keys, perm), _ = spill_setup("negative keys", J.SPILL_SEARCH)
    pnr = torch.tensor(pn, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        J.spill_probe_cuda(pcols, pnr, J.SPILL_DENSE, table, stats)
    spill_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        J.spill_probe_cuda(pcols, pnr.reshape(1), J.SPILL_DENSE, table,
                           stats)
    with pytest.raises(ValueError, match="probe key column"):
        J.spill_probe_cuda([(pcols[0][0][::2], None)], pnr, J.SPILL_DENSE,
                           table, stats)
    with pytest.raises(ValueError, match="validity"):
        J.spill_probe_cuda([(pcols[0][0], pcols[0][1].to(torch.int8))],
                           pnr, J.SPILL_DENSE, table, stats)
    with pytest.raises(ValueError, match="table holds"):
        J.spill_probe_cuda(pcols * 513, pnr, J.SPILL_DENSE, table, stats)
    with pytest.raises(ValueError, match="stats"):
        J.spill_probe_cuda(pcols, pnr, J.SPILL_DENSE, table, stats[:5])
    with pytest.raises(ValueError, match="dense row table"):
        J.spill_probe_cuda(pcols, pnr, J.SPILL_DENSE, table.to(torch.int64),
                           stats)
    with pytest.raises(ValueError, match="search mode"):
        J.spill_probe_cuda(pcols, pnr, J.SPILL_SEARCH,
                           (keys, perm.to(torch.int64)), stats)
    with pytest.raises(ValueError, match="search mode"):
        J.spill_probe_cuda(pcols, pnr, J.SPILL_SEARCH, (keys, perm[:-1]),
                           stats)
    with pytest.raises(ValueError, match="no mode"):
        J.spill_probe_cuda(pcols, pnr, 7, table, stats)


def test_k17_launcher_is_one_enqueue_with_a_sized_block():
    """csrc/join_spill.cu's spill_probe switches over the 8, 64 and
    TABLE_MAX blocks, counts its enqueues, and enqueues no memset; the
    kernel walks the live prefix only."""
    text = (CSRC / "join_spill.cu").read_text()
    probe = text[text.index("TT_EXPORT int spill_probe("):]
    assert "switch (param_block_words(KEY_FIELDS * nkeys))" in probe
    assert "cudaMemsetAsync" not in probe
    assert "TT_EXPORT int64_t spill_probe_enqueues()" in text
    kernel = text[text.index("probe_kernel(const __grid_constant__"):]
    kernel = kernel[:kernel.index("template <int W, int MODE>\nint ")]
    assert "base < n; base += step" in kernel and "< cap" not in kernel


# ------------------------------------------------- launch_trace's shapes


def test_launch_trace_bounds_shape_is_g3s_build():
    """The bounds part's input: G3's build, 1,500,000 live int64 keys
    o_orderkey % 256 of 2,097,152 rows, no NULL."""
    values, valid, nr = LT.bounds_call("cpu")
    assert values.dtype is torch.int64 and valid is None
    assert (values.numel(), int(nr)) == (2_097_152, 1_500_000)
    live = values[:1_500_000]
    assert int(live.min()) >= 0 and int(live.max()) < 256
    assert live.unique().numel() == 64        # o_orderkey's residues
