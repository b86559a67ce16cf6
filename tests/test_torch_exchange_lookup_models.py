"""K35's scatter and K25 on the CPU: the plain models of what the
one-launch designs of csrc/exchange.cu (exchange_scatter) and
csrc/join_mxu.cu (agg_lookup) do, and both wrappers' parameter words and
buffers read back the way the kernels read them.

K35's scatter reads each live destination word once, ranks the rows of a
tile with one warp ballot per destination and a block scan over
(destination, warp), and writes every array through a window of
destination-major positions (rows of 1 to 8 bytes staged in shared memory,
wider rows straight from their source). K25 computes the live rows only,
two a thread, its grid striding them. The models
(parallel/exchange.py scatter_launch_model, ops/join_mxu.py
agg_lookup_launch_model) are held against exchange_scatter_plain and
agg_lookup_plain bit for bit; the twins themselves are held against the
JAX package by test_torch_exchange.py, test_torch_distributed.py and
test_torch_join_mxu_agg.py.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from trino_tpu_torch import launch_trace as LT
from trino_tpu_torch import native
from trino_tpu_torch.ops import join_mxu as JM
from trino_tpu_torch.page import row_bytes
from trino_tpu_torch.parallel import exchange as X

torch.set_num_threads(1)
CSRC = pathlib.Path(X.__file__).resolve().parents[1] / "csrc"
MODES = {"hash": X.MODE_HASH, "spread": X.MODE_SPREAD,
         "replicate": X.MODE_REPLICATE}
NS = (1, 2, 4, 8, 64)
HEAVY_KEY = 77


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


# ------------------------------------------------------------ K35 cases


def scatter_arrays(cap: int, seed: int):
    """Moved arrays of 1, 2, 4, 8, 12 and 16 row bytes and an absent
    validity, as [(array or None, template)]."""
    rng = np.random.default_rng(seed)

    def ints(dtype, shape=(cap,)):
        return torch.from_numpy(rng.integers(-9000, 9000, shape)).to(dtype)
    arrays = [ints(torch.int64), torch.from_numpy(rng.random(cap) < 0.9),
              torch.from_numpy(rng.standard_normal(cap)), None,
              ints(torch.int32), ints(torch.int16), ints(torch.int8),
              ints(torch.int32, (cap, 3)), ints(torch.int64, (cap, 2))]
    return [(a, torch.empty(0, dtype=torch.bool) if a is None else a)
            for a in arrays]


def scatter_state(cap: int, live: int, n: int, mode: int, share: float,
                  seed: int):
    """(key columns, num_rows, heavy set, dest, counts) of one case: int64
    keys with NULLs, `share` of the rows on one heavy key."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 1 << 40, cap))
    keys[torch.from_numpy(rng.random(cap) < share)] = HEAVY_KEY
    cols = [(keys, torch.from_numpy(rng.random(cap) >= 0.03))]
    nr = torch.tensor(live, dtype=torch.int32)
    heavy = None
    if mode != X.MODE_HASH:
        heavy = torch.full((8,), -1, dtype=torch.int64)
        heavy[0] = HEAVY_KEY
    dest, counts = X.exchange_count_plain(cols, nr, n, mode, heavy)
    return cols, nr, heavy, dest, counts


def byte_cols(arrays, outs, cap: int):
    """The model's view of the arrays: (source bytes (cap, rb) or None,
    destination bytes (n * bucket, rb)), sharing memory."""
    out = []
    for (a, _), o in zip(arrays, outs):
        rb = row_bytes(o)
        src = None if a is None else \
            a.contiguous().view(torch.uint8).reshape(cap, rb).numpy()
        out.append((src, o.view(torch.uint8).reshape(-1, rb).numpy()))
    return out


def occupied_equal(got, want, counts, n: int, bucket: int) -> bool:
    """Every occupied slot of every array equal bit for bit."""
    for a, b in zip(got, want):
        for d in range(n):
            m = min(int(counts[d]), bucket)
            lo = d * bucket
            x = a[lo:lo + m].contiguous().view(torch.uint8)
            y = b[lo:lo + m].contiguous().view(torch.uint8)
            if not torch.equal(x, y):
                return False
    return True


def untouched(outs, counts, n: int, bucket: int) -> bool:
    """Every slot past a destination's count still holds the 0xAB
    fill."""
    for o in outs:
        for d in range(n):
            m = min(int(counts[d]), bucket)
            rest = o[d * bucket + m:(d + 1) * bucket].contiguous()
            if not bool((rest.view(torch.uint8) == 0xAB).all()):
                return False
    return True


LIVES = {"0": lambda cap, tile: 0,
         "inside a tile": lambda cap, tile: 2 * tile + tile // 3,
         "on a tile boundary": lambda cap, tile: 2 * tile,
         "the capacity": lambda cap, tile: cap}


def run_model(cap, live, n, mode, share, bucket_share, tile, warps, stage,
              seed):
    cols, nr, heavy, dest, counts = scatter_state(cap, live, n, mode,
                                                  share, seed)
    bucket = max(1, int(int(counts.max()) * bucket_share))
    arrays = scatter_arrays(cap, seed + 1)
    want = X.exchange_scatter_plain(dest, arrays, n, bucket)
    outs = [torch.empty_like(w) for w in want]
    for o in outs:
        o.view(torch.uint8).fill_(0xAB)
    hist = X.scatter_offsets_plain(dest, nr, n, tile).numpy()
    stats = X.scatter_launch_model(dest.numpy(), hist, live, mode,
                                   byte_cols(arrays, outs, cap), n, bucket,
                                   tile, warps, stage)
    return outs, want, counts, bucket, stats


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("live", sorted(LIVES))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", NS)
def test_scatter_model_gives_the_twin(n, mode, live, overflow):
    """Tiles of 256 rows (two warps of four rounds), windows of 200
    positions: every occupied slot of every array equals
    exchange_scatter_plain's bit for bit, the slots past a destination's
    count are not written, and no destination word or source row at or
    past num_rows is read; replicated rows past the window go through
    their destinations' ballots again."""
    tile, cap = 256, 1500
    nlive = LIVES[live](cap, tile)
    outs, want, counts, bucket, st = run_model(
        cap, nlive, n, MODES[mode], 0.15, 0.6 if overflow else 1.0, tile,
        2, 200, seed=n + 7 * len(live))
    assert occupied_equal(outs, want, counts, n, bucket)
    assert untouched(outs, counts, n, bucket)
    assert st["read"] == nlive - 1
    assert st["tiles"] == -(-nlive // tile)
    assert st["widest"] <= 200
    if overflow and nlive:
        assert int(counts.max()) > bucket
    if mode == "replicate" and nlive and n > 1:
        assert st["rep_passes"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", NS)
def test_scatter_model_at_the_kernels_tile(n, mode):
    """The kernel's own shape (4,096-row tiles, eight warps of 16 rounds,
    4,096-position windows): a tile straddling num_rows, a bucket that
    overflows, rows of 1 to 16 bytes (two list planes from source to
    slot) and an absent validity."""
    cap, live = 10_000, 9_001
    outs, want, counts, bucket, st = run_model(
        cap, live, n, MODES[mode], 0.05, 0.8, X.TILE, X.SCATTER_WARPS,
        X.SCATTER_STAGE, seed=3 * n)
    assert occupied_equal(outs, want, counts, n, bucket)
    assert untouched(outs, counts, n, bucket)
    assert st["read"] == live - 1 and st["tiles"] == 3
    # six staged arrays and two planes a window; the absent validity is
    # written without a read
    assert st["staged"] == 6 * st["windows"]
    assert st["direct"] == 2 * st["windows"]
    if mode != "replicate":
        assert st["windows"] == 3 and st["rep_passes"] == 0


def test_scatter_model_replicates_a_heavy_tile_through_windows():
    """A tile whose rows all carry the heavy key in replicate mode places
    each row in every destination: n x 4,096 positions, n windows, every
    destination's ballots redone once per window it meets."""
    cap = 4096
    cols, nr, heavy, dest, counts = scatter_state(cap, cap, 8,
                                                  X.MODE_REPLICATE, 1.0, 1)
    nulls = int((~cols[0][1]).sum())
    assert int(counts.max()) == cap and int(counts.min()) == cap - nulls
    arrays = scatter_arrays(cap, 2)
    want = X.exchange_scatter_plain(dest, arrays, 8, cap)
    outs = [torch.empty_like(w) for w in want]
    hist = X.scatter_offsets_plain(dest, nr, 8).numpy()
    st = X.scatter_launch_model(dest.numpy(), hist, cap, X.MODE_REPLICATE,
                                byte_cols(arrays, outs, cap), 8, cap)
    assert occupied_equal(outs, want, counts, 8, cap)
    total = int(counts.sum())
    assert st["windows"] == -(-total // X.SCATTER_STAGE)
    assert st["rep_passes"] >= 8


def test_scatter_offsets_are_the_count_passes():
    """scatter_offsets_plain lays out the count pass's `hist`: per
    (destination, tile), destination-major, the members before the tile,
    then the total; each destination's first offset is its start."""
    dest = torch.tensor([0, 1, -1, 1, 2, 0, 3, 3, 1, -1], dtype=torch.int32)
    hist = X.scatter_offsets_plain(dest, 8, 3, tile=4)
    # tiles [0, 4) [4, 8) [8, 10); live rows 0-7 (num_rows 8)
    assert hist.tolist() == [0, 2, 3,      # d 0: 2 in tile 0, 1 in tile 1
                             3, 6, 6,      # d 1: 3, 0, 0
                             6, 7, 8,      # d 2: 1, 1, 0
                             8]


# ------------------------------------------- K35 through its wrapper


def scatter_kernel_model(monkeypatch, tile=X.TILE):
    """Run exchange_scatter_cuda on CPU tensors: the launch reads its
    parameter words, dest, hist and num_rows at their pointers, scribbles
    over the outputs (device memory starts as garbage) and runs the model
    into them. Returns the launches."""
    calls = []

    def exchange_scatter(dest, cap, n, hist, num_rows, mode, bucket, cols,
                         ncols, stream):
        words = list((ctypes.c_int64 * (3 * ncols)).from_address(cols)) \
            if ncols else []
        ntiles = max(1, -(-cap // tile))
        d = mem(dest, ctypes.c_int32, cap, torch.int32).numpy()
        h = mem(hist, ctypes.c_int64, n * ntiles + 1, torch.int64).numpy()
        live = ctypes.c_int32.from_address(num_rows).value
        arrays = []
        for c in range(ncols):
            src, dst, rb = words[3 * c:3 * c + 3]
            out = mem(dst, ctypes.c_uint8, n * bucket * rb, torch.uint8)
            out.fill_(0xAB)
            arrays.append((None if src == 0 else mem(
                src, ctypes.c_uint8, cap * rb, torch.uint8).reshape(
                    cap, rb).numpy(), out.reshape(-1, rb).numpy()))
        st = X.scatter_launch_model(d, h, live, mode, arrays, n, bucket)
        calls.append(dict(n=n, mode=mode, bucket=bucket, words=words,
                          cap=cap, stats=st))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: exchange_scatter)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    return calls


def cpu_state(dest, nr, n, mode):
    """The count pass's state as the card's wrapper returns it."""
    return (dest, X.scatter_offsets_plain(dest, nr, n), nr, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [1, 8, 64])
def test_scatter_wrapper_gives_the_twin(monkeypatch, n, mode):
    """One launch; the parameter words are 3 per array (the source, 0 for
    an absent validity; the output; its row bytes); the outputs equal the
    twin's on every occupied slot."""
    cap, live = 9000, 8500
    cols, nr, heavy, dest, counts = scatter_state(cap, live, n,
                                                  MODES[mode], 0.1, n)
    arrays = scatter_arrays(cap, n)
    bucket = max(1, int(counts.max()) * 3 // 4)
    calls = scatter_kernel_model(monkeypatch)
    before = X.exchange_scatter_cuda.launches
    got = X.exchange_scatter_cuda(cpu_state(dest, nr, n, MODES[mode]),
                                  arrays, n, bucket)
    assert X.exchange_scatter_cuda.launches == before + 1
    assert len(calls) == 1
    call = calls[0]
    assert (call["n"], call["mode"], call["bucket"]) == (n, MODES[mode],
                                                         bucket)
    assert call["words"][0::3] == [0 if a is None else a.data_ptr()
                                   for a, _ in arrays]
    assert call["words"][1::3] == [o.data_ptr() for o in got]
    assert call["words"][2::3] == [row_bytes(o) for o in got] == [
        8, 1, 8, 1, 4, 2, 1, 12, 16]
    st = call["stats"]
    assert st["staged"] == 6 * st["windows"]
    assert st["direct"] == 2 * st["windows"]
    want = X.exchange_scatter_plain(dest, arrays, n, bucket)
    assert [(o.dtype, o.shape) for o in got] == [(w.dtype, w.shape)
                                                 for w in want]
    assert occupied_equal(got, want, counts, n, bucket)


def test_scatter_outputs_are_views_of_one_allocation(monkeypatch):
    """Every output lies in one allocation: the arrays of one dtype and
    row shape side by side as the rows of one block, each block's start
    256-byte aligned, no two outputs overlapping."""
    cap, n, bucket = 3000, 4, 1000
    _, nr, _, dest, _ = scatter_state(cap, cap, n, X.MODE_HASH, 0.0, 5)
    arrays = scatter_arrays(cap, 5)
    scatter_kernel_model(monkeypatch)
    got = X.exchange_scatter_cuda(cpu_state(dest, nr, n, X.MODE_HASH),
                                  arrays, n, bucket)
    base = got[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in got)
    layout, nbytes = X.scatter_layout(arrays, n, bucket)
    assert got[0].untyped_storage().nbytes() == nbytes
    # int64, bool (the validity, the absent one and the int8 flags are
    # not alike: int8 is its own block), float64, int32, int16, int8 and
    # the two planes
    assert [idx for *_, idx in layout] == [[0], [1, 3], [2], [4], [5], [6],
                                           [7], [8]]
    for at, dtype, rshape, rb, idx in layout:
        assert at % X.SCATTER_ALIGN == 0
        for j, i in enumerate(idx):
            o = got[i]
            assert (o.dtype, tuple(o.shape)) == (dtype, (n * bucket,)
                                                 + rshape)
            assert o.is_contiguous()
            assert o.data_ptr() - base == at + j * n * bucket * rb
    spans = sorted((o.data_ptr(), o.data_ptr() + o.numel()
                    * o.element_size()) for o in got)
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))


def test_scatter_wrapper_launches_for_a_dead_page(monkeypatch):
    """num_rows 0 and capacity 0: still one launch (the blocks return at
    once), no slot written."""
    calls = scatter_kernel_model(monkeypatch)
    for cap, live in ((500, 0), (0, 0)):
        dest = torch.full((cap,), 4, dtype=torch.int32)
        nr = torch.tensor(live, dtype=torch.int32)
        arrays = scatter_arrays(cap, 1)
        X.exchange_scatter_cuda(cpu_state(dest, nr, 4, X.MODE_HASH),
                                arrays, 4, 16)
    assert len(calls) == 2


def test_scatter_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cap = 100
    _, nr, _, dest, _ = scatter_state(cap, cap, 4, X.MODE_HASH, 0.0, 2)
    arrays = scatter_arrays(cap, 2)
    state = cpu_state(dest, nr, 4, X.MODE_HASH)
    with pytest.raises(ValueError, match="CUDA"):
        X.exchange_scatter_cuda(state, arrays, 4, 50)
    scatter_kernel_model(monkeypatch)
    for n, bucket in ((0, 50), (65, 50), (4, 0)):
        with pytest.raises(ValueError, match="destinations"):
            X.exchange_scatter_cuda(state, arrays, n, bucket)
    with pytest.raises(ValueError, match="table holds"):
        X.exchange_scatter_cuda(state, arrays[:1] * 683, 4, 50)
    for bad in (arrays[0][0][::2], arrays[0][0][:50],
                arrays[0][0].to(torch.int32)):
        with pytest.raises(ValueError, match="does not match"):
            X.exchange_scatter_cuda(state, [(bad, arrays[0][1])], 4, 50)


def test_scatter_launcher_switches_on_the_sized_block():
    """K35's scatter takes 3 words an array in a block of 8, 64 or
    TABLE_MAX words, with the replicate variant beside the other; each
    launch counts one enqueue."""
    text = (CSRC / "exchange.cu").read_text()
    assert "switch (param_block_words(3 * ncols))" in text
    assert re.findall(r"case (\w+):\n\s+return scatter_mode<(\w+)>",
                      text) == [("8", "8"), ("64", "64"),
                                ("TABLE_MAX", "TABLE_MAX")]
    body = text[text.index("int scatter_launch("):]
    body = body[:body.index("\n}")]
    assert body.count("<<<") == 1 and "++scatter_enqueues;" in body
    assert "TT_EXPORT int64_t exchange_scatter_enqueues()" in text
    assert X.SCATTER_MAX_ARRAYS * 3 <= native.TABLE_MAX


# ------------------------------------------------------------ K25 cases


def lookup_inputs(cap: int, slots: int, ncols: int, seed: int,
                  kind: str = "int"):
    """(key, table, kmin, outs): probe keys over the span, past it and
    below it with NULLs, a (slots, ncols) table with empty slots and
    float64 bits in column 2, and one output of every op (two probe
    value kinds for the products)."""
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(rng.integers(-7, slots + 7, cap))
    if kind == "double":
        base = int(torch.tensor(1.0, dtype=torch.float64).view(torch.int64))
        keys = (raw + base).view(torch.float64).clone()
        keys[raw == 2] = -0.0
    else:
        base, keys = 50, raw + 50
    key = (keys, torch.from_numpy(rng.random(cap) >= 0.05))
    table = torch.from_numpy(rng.integers(0, 40, (slots, ncols)))
    table[:, 2] = torch.from_numpy(rng.random(slots) * 1e3).view(torch.int64)
    table[torch.from_numpy(rng.random(slots) < 0.2), 0] = 0
    v = torch.from_numpy(rng.integers(-10**9, 10**9, cap))
    vvalid = torch.from_numpy(rng.random(cap) >= 0.1)
    i32 = torch.from_numpy(rng.integers(-99, 99, cap).astype(np.int32))
    f32 = torch.from_numpy(rng.standard_normal(cap).astype(np.float32))
    f64 = torch.from_numpy(rng.standard_normal(cap) * 1e3)
    flags = torch.from_numpy(rng.random(cap) < 0.5).view(torch.uint8)
    outs = [(JM.OP_PAIRS, 0, None, None), (JM.OP_CNTP, 0, v, vvalid),
            (JM.OP_CNTP, 0, i32, None), (JM.OP_SUMP_I, 0, v, vvalid),
            (JM.OP_SUMP_I, 0, i32, None), (JM.OP_SUMP_I, 0, flags, None),
            (JM.OP_SUMP_F, 0, f32, None), (JM.OP_SUMP_F, 0, f64, vvalid),
            (JM.OP_TABLE_I, 1, None, None), (JM.OP_TABLE_F, 2, None, None),
            (JM.OP_TABLE_I, ncols - 1, None, None)]
    return key, table, torch.tensor([base]), outs


def lookup_twin_equal(got, live, want, wlive, n: int) -> bool:
    return torch.equal(live[:n], wlive[:n]) and all(
        torch.equal(a[:n].view(torch.int64), b[:n].view(torch.int64))
        for a, b in zip(got, want))


LOOKUP_LIVES = {"none": 0, "part": 1337, "all": 2001}


@pytest.mark.parametrize("grid", [1, 3, 16])
@pytest.mark.parametrize("kind", ["int", "double"])
@pytest.mark.parametrize("slots", [100, 2100])
@pytest.mark.parametrize("live", sorted(LOOKUP_LIVES))
def test_lookup_model_gives_the_twin(live, slots, kind, grid):
    """Every op on the live rows equals agg_lookup_plain's bit for bit,
    each live row written once and no row at or past num_rows written; a
    block with no live row returns before staging the table, and a table
    above SMEM_WORDS (2,100 slots x 3) is not staged."""
    cap = 2001
    n = LOOKUP_LIVES[live]
    key, table, kmin, outs = lookup_inputs(cap, slots, 3, seed=slots + n,
                                           kind=kind)
    nr = torch.tensor(n, dtype=torch.int32)
    want, wlive = JM.agg_lookup_plain(key, nr, table, kmin, outs)
    got = [torch.full_like(w, 7) for w in want]
    live_out = torch.zeros(cap, dtype=torch.bool)
    st = JM.agg_lookup_launch_model(key, n, table, int(kmin), outs, got,
                                    live_out, grid)
    assert lookup_twin_equal(got, live_out, want, wlive, n)
    assert (st["writes"][:n] == 1).all() and (st["writes"][n:] == 0).all()
    assert all(bool((g[n:].view(torch.int64) == torch.full_like(
        g[n:], 7).view(torch.int64)).all()) for g in got)
    step = JM.AGG_LOOKUP_THREADS * JM.AGG_LOOKUP_ROWS
    assert st["blocks"] == min(grid, -(-n // step))
    assert st["staged"] == (st["blocks"] if slots * 3
                            <= JM.AGG_LOOKUP_SMEM_WORDS else 0)
    assert st["pairs"] == n // 2 and st["singles"] == n % 2


def test_lookup_grid_depends_on_the_capacity_and_the_card():
    """The grid is what the card holds at once: eight blocks an SM, four
    when each stages a table of more than 12 KB (a larger table than
    48 KB is not staged)."""
    assert [JM.agg_lookup_grid(c, 132, 768) for c in (0, 1, 512, 513,
                                                        1 << 23)] \
        == [1, 1, 1, 2, JM.AGG_LOOKUP_PER_SM * 132] == [1, 1, 1, 2, 1056]
    assert JM.agg_lookup_grid(1 << 23, 2, 768) == 2 * JM.AGG_LOOKUP_PER_SM
    assert [JM.agg_lookup_grid(1 << 23, 132, w) for w in (
        768, 1536, 1537, 6144, 6145, 131_072)] == [1056, 1056, 528, 528,
                                                   1056, 1056]


def test_lookup_stride_aligns_every_output():
    for cap in (0, 1, 1001, 8_388_608, 17):
        stride = JM.agg_lookup_stride(cap)
        assert stride % 32 == 0 and cap <= stride < cap + 32


# ------------------------------------------------- K25 through its wrapper


def lookup_kernel_model(monkeypatch, sms: int = 3):
    """Run agg_lookup_cuda on CPU tensors: the launch reads its parameter
    words (the key's four, six per output), num_rows, the table and kmin
    at their pointers, scribbles over the output block and runs the model
    into it. Returns the launches."""
    calls = []
    dtypes = {(1, 0): torch.uint8, (2, 0): torch.int16, (4, 0): torch.int32,
              (8, 0): torch.int64, (4, 1): torch.float32,
              (8, 1): torch.float64}

    def column(ptr, vptr, esz, is_float, cap):
        values = None if ptr == 0 else mem(
            ptr, ctypes.c_uint8, cap * esz, torch.uint8).view(
                dtypes[(esz, is_float)])
        valid = None if vptr == 0 else mem(vptr, ctypes.c_bool, cap,
                                           torch.bool)
        return values, valid

    def agg_lookup(desc, nout, cap, num_rows, tab, slots, ncols, kmin, outs,
                   stride, live, grid, stream):
        words = list((ctypes.c_int64 * (4 + 6 * nout)).from_address(desc))
        key = column(*words[:4], cap)
        specs = []
        for q in range(nout):
            op, col, ptr, vptr, esz, is_float = words[4 + 6 * q:10 + 6 * q]
            values, valid = column(ptr, vptr, esz, is_float, cap)
            specs.append((op, col, values, valid))
        n = ctypes.c_int32.from_address(num_rows).value
        table = mem(tab, ctypes.c_int64, slots * ncols,
                    torch.int64).reshape(slots, ncols)
        km = ctypes.c_int64.from_address(kmin).value
        block = mem(outs, ctypes.c_int64, nout * stride, torch.int64)
        block.fill_(-5)
        got = [block[q * stride:q * stride + cap] for q in range(nout)]
        live_out = mem(live, ctypes.c_bool, cap, torch.bool)
        JM.agg_lookup_launch_model(key, n, table, km, specs, got, live_out,
                                   grid)
        calls.append(dict(words=words, grid=grid, stride=stride, outs=outs,
                          live=live, cap=cap))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: agg_lookup)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    monkeypatch.setattr(native, "sm_count", lambda index: sms)
    return calls


@pytest.mark.parametrize("nout", [1, 4, 11, 70])
@pytest.mark.parametrize("live", sorted(LOOKUP_LIVES))
def test_lookup_wrapper_gives_the_twin_in_one_launch(monkeypatch, live,
                                                     nout):
    """One launch; the parameter words are the key's four and six per
    output; the outputs are the rows of one allocation at a 32-word
    multiple stride, the mask a second allocation; the live rows equal
    the twin's."""
    cap = 2001
    n = LOOKUP_LIVES[live]
    key, table, kmin, every = lookup_inputs(cap, 100, 3, seed=nout)
    outs = [every[q % len(every)] for q in range(nout)]
    nr = torch.tensor(n, dtype=torch.int32)
    calls = lookup_kernel_model(monkeypatch)
    before = JM.agg_lookup_cuda.launches
    got, live_out = JM.agg_lookup_cuda(key, nr, table, kmin, outs)
    assert JM.agg_lookup_cuda.launches == before + 1 and len(calls) == 1
    call = calls[0]
    assert call["words"] == JM.agg_lookup_words(key, outs)
    assert len(call["words"]) == 4 + JM.AGG_LOOKUP_FIELDS * nout
    assert call["grid"] == JM.agg_lookup_grid(cap, 3, 300)
    stride = JM.agg_lookup_stride(cap)
    assert call["stride"] == stride
    base = got[0].untyped_storage().data_ptr()
    assert call["outs"] == base and call["live"] == live_out.data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)
    assert live_out.untyped_storage().data_ptr() != base
    assert [g.data_ptr() - base for g in got] == [
        8 * q * stride for q in range(nout)]
    assert all(g.shape == (cap,) and g.is_contiguous() for g in got)
    assert got[0].untyped_storage().nbytes() == 8 * nout * stride
    assert live_out.shape == (cap,) and live_out.dtype == torch.bool
    assert [g.dtype for g in got] == [
        torch.float64 if op in (JM.OP_SUMP_F, JM.OP_TABLE_F) else torch.int64
        for op, *_ in outs]
    want, wlive = JM.agg_lookup_plain(key, nr, table, kmin, outs)
    assert lookup_twin_equal(got, live_out, want, wlive, n)


def test_lookup_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    key, table, kmin, outs = lookup_inputs(300, 50, 3, seed=1)
    nr = torch.tensor(200, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        JM.agg_lookup_cuda(key, nr, table, kmin, outs)
    lookup_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        JM.agg_lookup_cuda(key, nr.to(torch.int64), table, kmin, outs)
    with pytest.raises(ValueError, match="contiguous int64"):
        JM.agg_lookup_cuda(key, nr, table.t(), kmin, outs)
    with pytest.raises(ValueError, match="contiguous int64"):
        JM.agg_lookup_cuda(key, nr, table.to(torch.int32), kmin, outs)
    with pytest.raises(ValueError, match="kmin"):
        JM.agg_lookup_cuda(key, nr, table, kmin.to(torch.int32), outs)
    with pytest.raises(ValueError, match="table holds"):
        JM.agg_lookup_cuda(key, nr, table, kmin,
                           outs[:1] * (JM.AGG_LOOKUP_MAX + 1))
    with pytest.raises(ValueError, match="its column"):
        JM.agg_lookup_cuda(key, nr, table, kmin,
                           [(JM.OP_SUMP_I, 0, None, None)])
    with pytest.raises(ValueError, match="out of range"):
        JM.agg_lookup_cuda(key, nr, table, kmin,
                           [(JM.OP_TABLE_I, 3, None, None)])
    with pytest.raises(ValueError, match="does not match"):
        JM.agg_lookup_cuda(key, nr, table, kmin,
                           [(JM.OP_SUMP_I, 0, key[0][:100], None)])


def test_lookup_launcher_switches_on_the_sized_block():
    """K25's descriptors travel in a block of 8, 64 or LK_MAX outputs (the
    key's four words first); each launch counts one enqueue."""
    text = (CSRC / "join_mxu.cu").read_text()
    assert re.findall(r"if \(nout <= (\w+)\)\n\s+return lookup_launch<(\w+)>",
                      text) == [("8", "8"), ("64", "64")]
    assert "return lookup_launch<LK_MAX>" in text
    assert "(TABLE_MAX - KEY_FIELDS) / LK_FIELDS" in text
    assert JM.AGG_LOOKUP_MAX == (native.TABLE_MAX - 4) // 6 == 340
    body = text[text.index("int lookup_launch("):]
    body = body[:body.index("\n}")]
    assert body.count("<<<") == 1 and "++lookup_enqueues;" in body
    assert "TT_EXPORT int64_t agg_lookup_enqueues()" in text


# ------------------------------------------------- the chip's shapes


def chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_k35_k25", CSRC.parents[1] / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    return C


def test_chip_smoke_cases_cover_the_redesign():
    """Phase 2 holds K35's scatter at a tile straddling num_rows, n = 64,
    a heavy key replicated past the bucket, list planes, and the D4
    shard's shape; K25 at num_rows 0, part and all, a 32,768-slot table,
    an odd capacity, 70 outputs and G3's probe."""
    C = chip_smoke()
    cases = {label: (cap, live, n, mode, share, bucket)
             for label, cap, live, n, mode, share, bucket in
             C.SCATTER_CASES}
    assert any(live % X.TILE and 0 < live < cap
               for cap, live, *_ in cases.values())
    assert any(n == 64 for _, _, n, *_ in cases.values())
    assert any(mode == X.MODE_REPLICATE and share > 0 and bucket < 1
               for *_, mode, share, bucket in cases.values())
    assert (8_388_608, 7_503_144, 8) in {v[:3] for v in cases.values()}
    rbs = [row_bytes(like) if a is None else a[0].numel() * a.element_size()
           for a, like in C.scatter_arrays(torch.Generator().manual_seed(0),
                                           10, "cpu") if a is not None]
    assert {1, 2, 4, 8, 12, 16} <= set(rbs)
    lives = {(live == 0, live == cap) for _, cap, live, *_ in
             C.LOOKUP_CASES}
    assert lives == {(True, False), (False, False), (False, True)}
    assert any(slots * ncols > JM.AGG_LOOKUP_SMEM_WORDS
               for _, _, _, slots, ncols, *_ in C.LOOKUP_CASES)
    assert any(nout > 64 for *_, nout, _ in C.LOOKUP_CASES)
    assert (8_388_608, 5_999_956) in {(cap, live) for _, cap, live, *_ in
                                      C.LOOKUP_CASES}


def test_launch_trace_shapes_are_the_main_paths():
    """launch_trace's K35 input: a D4 sf10 q9 shard's 14 arrays of 63
    bytes a row (seven columns and their validity), hash mode over 8
    destinations; K25's: G3's probe, keys of 256 values, G3's four
    outputs over a (256, 3) table."""
    cols, nr, arrays = LT.scatter_arrays("cpu", cap=4096, live=3000)
    assert len(arrays) == 14 and int(nr) == 3000
    assert sum(row_bytes(like) for _, like in arrays) == 63
    assert cols[0][0] is arrays[0][0]
    key, nr, table, kmin, outs = LT.lookup_call("cpu", cap=4096, live=3000)
    assert table.shape == (LT.LOOKUP_SLOTS, 3) and int(nr) == 3000
    assert int(key[0].min()) >= 0 and int(key[0].max()) < 256
    assert [op for op, *_ in outs] == [JM.OP_PAIRS, JM.OP_SUMP_I,
                                       JM.OP_TABLE_I, JM.OP_TABLE_I]
    assert (LT.SCATTER_CAP, LT.SCATTER_LIVE, LT.LOOKUP_CAP,
            LT.LOOKUP_LIVE) == (8_388_608, 7_503_144, 8_388_608, 5_999_956)
