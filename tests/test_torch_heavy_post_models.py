"""K36's local mode and K27 on the CPU: the plain model of what
csrc/exchange.cu's one-launch local mode does, and both wrappers'
parameters and buffers read back the way the kernels read them.

K36's local mode walks the live prefix of the sorted words in tiles,
finds run starts from neighbours and run ends from the next start (one
search past each tile's end), keeps each block's k best in registers and
merges the grid's lists with the sentinel tail in the last block. The
model (parallel/exchange.py heavy_local_model) is held against
heavy_local_plain bit for bit; the twin itself is held against the JAX
package by test_torch_distributed.py. K27 is one CUDA launch for any
number of helpers; its twin is held against the reference's
agg_join_post by test_torch_join_mxu_agg.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from trino_tpu_torch import launch_trace as LT
from trino_tpu_torch import native
from trino_tpu_torch.ops import join_mxu as JM
from trino_tpu_torch.parallel import exchange as X

torch.set_num_threads(1)
KS = (1, 8, 64)


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


# ------------------------------------------------------------ K36 cases


def runs_of(lengths, cap: int, seed: int = 0) -> torch.Tensor:
    """Ascending distinct words (random, below the sentinel), run i
    repeating its word lengths[i] times, then the sentinel up to cap."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**63, 2 * len(lengths) + 8))
    keys = np.sort(keys[rng.permutation(len(keys))[:len(lengths)]]) * 2
    words = np.repeat(keys.astype(np.uint64), lengths)
    out = torch.full((cap,), -1, dtype=torch.int64)
    out[:len(words)] = torch.from_numpy(words.view(np.int64))
    return out


def heavy_case(name: str) -> torch.Tensor:
    """The phase-2 cases of chip_smoke.py at small sizes."""
    if name == "cap 0":
        return torch.zeros(0, dtype=torch.int64)
    if name == "cap < k":
        return runs_of([2, 1], 5)
    if name == "all sentinel":
        return torch.full((3000,), -1, dtype=torch.int64)
    if name == "every live word distinct":    # fewer zeros than k below L
        return runs_of([1] * 40, 300)
    if name == "fewer keys than k":
        return runs_of([700, 2, 250], 5000)
    if name == "one run across many tiles":   # tiles of 64 in the model
        return runs_of([3] * 50 + [1000] + [2] * 300, 3000)
    if name == "runs at tile boundaries":     # starts at 64, 128, 4096
        return runs_of([64, 64, 4096 - 128, 4096, 4097, 5] + [3] * 900,
                       20_000)
    if name == "live prefix ends a tile":
        return runs_of([7] * 585 + [1], 4200)   # L = 4,096
    if name == "a D4 shard, scaled":          # runs of 3.8 on average
        return LT.heavy_words(36_000, 16_310, 4_292, seed=4)
    # "every word live": no sentinel, the tail list is empty
    return runs_of([5, 1, 9] * 300, 4500)


HEAVY_CASES = ["cap 0", "cap < k", "all sentinel", "every live word distinct",
               "fewer keys than k", "one run across many tiles",
               "runs at tile boundaries", "live prefix ends a tile",
               "a D4 shard, scaled", "every word live"]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", HEAVY_CASES)
def test_heavy_model_gives_the_twin(name, k):
    """At the kernel's tile of 4,096 words and at tiles of 64 (many
    tiles, four blocks striding them): counts and keys equal
    heavy_local_plain's bit for bit; the tiles walked cover the live
    prefix and nothing past it, at most one search past a tile's end
    each."""
    words = heavy_case(name)
    want = X.heavy_local_plain(words, k)
    for tile, grid_max in ((X.HEAVY_TILE, X.HEAVY_GRID_MAX), (64, 4)):
        counts, keys, st = X.heavy_local_model(words, k, tile=tile,
                                               grid_max=grid_max)
        assert torch.equal(counts, want[0]) and torch.equal(keys, want[1])
        live = st["live"]
        assert live == int((words != -1).sum())
        assert st["tiles"] == -(-live // tile)
        assert st["searches"] == max(0, st["tiles"] - 1)
        assert st["furthest"] < live


def test_heavy_model_counts_a_long_run_once():
    """A run of 1,000 words spans 16 tiles of 64: the tile it starts in
    scores it 1,000 and the others score only zero-count positions."""
    words = heavy_case("one run across many tiles")
    counts, keys, _ = X.heavy_local_model(words, 3, tile=64, grid_max=4)
    assert counts.tolist() == [1000, 3, 3]
    assert keys[0] == words[150]


def test_heavy_model_fills_with_the_lowest_zero_positions():
    """Fewer runs than k: the zero-count entries are the duplicates in
    the prefix, then the sentinel positions from L on, by position."""
    words = runs_of([2, 3], 9)
    counts, keys, _ = X.heavy_local_model(words, 8)
    assert counts.tolist() == [3, 2, 0, 0, 0, 0, 0, 0]
    assert keys.tolist() == ([int(words[2]), int(words[0]), int(words[1]),
                              int(words[3]), int(words[4])] + [-1] * 3)


def test_heavy_model_skips_tiles_below_the_kth():
    """One long run first: every later tile of short runs beats none of
    the block's k best and is skipped without a selection."""
    words = runs_of([5000] + [2] * 4000, 20_000)
    _, _, st = X.heavy_local_model(words, 1, tile=256, grid_max=1)
    assert st["tiles"] == -(-13_000 // 256) and st["skipped"] == \
        st["tiles"] - 1


def test_heavy_grid_depends_on_the_capacity_alone():
    assert [X.heavy_grid(c) for c in (0, 1, 4096, 4097, 1 << 20, 1 << 23)] \
        == [1, 1, 1, 2, X.HEAVY_GRID_MAX, X.HEAVY_GRID_MAX]
    assert X.HEAVY_GRID_MAX < 512      # one list head a thread at the merge


# ------------------------------------------- K36 through its wrapper


def heavy_kernel_model(monkeypatch):
    """Run heavy_local_cuda on CPU tensors: the launch runs the model on
    the memory behind its pointers, requires a zero ticket, writes the
    grid's partials and leaves the ticket zero. Returns the launches and
    the scratch tensors handed to the kernel."""
    calls, scratches = [], {}

    def scratch_of(index):
        if index not in scratches:
            scratches[index] = torch.zeros(
                X.HEAVY_GRID_MAX * X.MAX_HEAVY + 1, dtype=torch.int64)
        return scratches[index]

    def heavy_local(sorted_ptr, cap, k, scratch, out, grid, stream):
        assert grid == X.heavy_grid(cap)
        words = mem(sorted_ptr, ctypes.c_int64, cap, torch.int64)
        part = mem(scratch, ctypes.c_int64, X.HEAVY_GRID_MAX * X.MAX_HEAVY
                   + 1, torch.int64)
        assert int(part[-1]) == 0               # the ticket
        counts, keys, st = X.heavy_local_model(words.clone(), k)
        assert st["grid"] == grid
        part[:grid * k] = 1                     # the blocks' partials
        res = mem(out, ctypes.c_int64, 2 * k, torch.int64)
        res[:k], res[k:] = counts, keys
        calls.append((cap, k, scratch, out))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: heavy_local)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    monkeypatch.setattr(X, "_heavy_scratch", scratch_of)
    return calls, scratches


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", HEAVY_CASES)
def test_heavy_wrapper_gives_the_twin_twice(monkeypatch, name, k):
    """Two calls in a row give the twin's counts and keys, one launch
    each, counts and keys the two halves of one int64[2k] allocation,
    the same scratch both times."""
    words = heavy_case(name)
    want = X.heavy_local_plain(words, k)
    calls, scratches = heavy_kernel_model(monkeypatch)
    before = X.heavy_local_cuda.launches
    first = X.heavy_local_cuda(words, k)
    second = X.heavy_local_cuda(words, k)
    assert X.heavy_local_cuda.launches == before + 2 and len(calls) == 2
    for counts, keys in (first, second):
        assert torch.equal(counts, want[0]) and torch.equal(keys, want[1])
        assert counts.data_ptr() + 8 * k == keys.data_ptr()
        assert counts.untyped_storage().nbytes() == 16 * k
    assert calls[0][2] == calls[1][2] == scratches[0].data_ptr()
    assert calls[0][3] != calls[1][3]


def test_heavy_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    words = heavy_case("fewer keys than k")
    with pytest.raises(ValueError, match="CUDA"):
        X.heavy_local_cuda(words, 8)
    heavy_kernel_model(monkeypatch)
    for k in (0, 65):
        with pytest.raises(ValueError, match="1 to 64"):
            X.heavy_local_cuda(words, k)
    with pytest.raises(ValueError, match="contiguous int64"):
        X.heavy_local_cuda(words.to(torch.int32), 8)
    with pytest.raises(ValueError, match="contiguous int64"):
        X.heavy_local_cuda(words[::2], 8)
    with pytest.raises(ValueError, match="contiguous int64"):
        X.heavy_local_cuda(words.reshape(50, 100), 8)


def test_heavy_scratch_is_made_once_per_device(monkeypatch):
    """The per-device scratch holds the largest grid's partials and the
    ticket, zeroed once; later calls reuse it."""
    made = []
    monkeypatch.setattr(X, "_HEAVY_SCRATCH", {})
    monkeypatch.setattr(torch, "zeros", lambda n, dtype, device: made.append(
        (n, dtype, str(device))) or torch.empty(0))
    a, b = X._heavy_scratch(0), X._heavy_scratch(0)
    assert a is b
    assert made == [(X.HEAVY_GRID_MAX * X.MAX_HEAVY + 1, torch.int64,
                     "cuda:0")]


# ------------------------------------------------- K27 through its wrapper


def post_kernel_model(monkeypatch):
    """Run agg_post_cuda on CPU tensors: the launch reads its pointer
    pairs and num_rows and writes helper > 0 on the live rows (the
    padding left as the allocation had it). Returns the launches."""
    calls = []

    def agg_post(table, nhelpers, num_rows, cap, grid, stream):
        assert grid == JM.agg_post_grid(cap)
        words = list((ctypes.c_int64 * (2 * nhelpers)).from_address(table))
        n = max(0, min(ctypes.c_int32.from_address(num_rows).value, cap))
        for j in range(nhelpers):
            h = mem(words[2 * j], ctypes.c_int64, cap, torch.int64)
            o = mem(words[2 * j + 1], ctypes.c_bool, cap, torch.bool)
            o[:n] = h[:n] > 0
        calls.append((nhelpers, cap, words))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: agg_post)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    return calls


@pytest.mark.parametrize("nhelpers", [1, 2, 9, 40])
@pytest.mark.parametrize("live", ["none", "part", "all"])
def test_post_wrapper_gives_the_twin_in_one_launch(monkeypatch, nhelpers,
                                                  live):
    """One launch for any number of helpers; the masks are the rows of
    one bool [helpers, cap] allocation, in helper order, equal to the
    twin's on the live rows."""
    cap = 700
    rng = np.random.default_rng(nhelpers)
    helpers = [torch.from_numpy(rng.integers(-1, 3, cap))
               for _ in range(nhelpers)]
    n = {"none": 0, "part": 437, "all": cap}[live]
    nr = torch.tensor(n, dtype=torch.int32)
    calls = post_kernel_model(monkeypatch)
    before = JM.agg_post_cuda.launches
    got = JM.agg_post_cuda(helpers, nr)
    assert JM.agg_post_cuda.launches == before + 1 and len(calls) == 1
    want = JM.agg_post_plain(helpers, nr)
    assert len(got) == nhelpers
    assert all(torch.equal(x[:n], y[:n]) for x, y in zip(got, want))
    base = got[0].data_ptr()
    assert [m.data_ptr() for m in got] == [base + j * cap
                                           for j in range(nhelpers)]
    assert got[0].untyped_storage().nbytes() == nhelpers * cap
    assert calls[0][2][0::2] == [h.data_ptr() for h in helpers]
    assert calls[0][2][1::2] == [m.data_ptr() for m in got]


def test_post_wrapper_launches_nothing_without_a_helper(monkeypatch):
    calls = post_kernel_model(monkeypatch)
    before = JM.agg_post_cuda.launches
    assert JM.agg_post_cuda([], torch.tensor(3, dtype=torch.int32)) == []
    assert JM.agg_post_cuda.launches == before and not calls


def test_post_grid_depends_on_the_capacity_alone():
    assert [JM.agg_post_grid(c) for c in (0, 1, 256, 257, 1 << 23)] == \
        [1, 1, 1, 2, JM.AGG_POST_GRID_MAX]


def test_post_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    h = torch.arange(10, dtype=torch.int64)
    nr = torch.tensor(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        JM.agg_post_cuda([h], nr)
    post_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int64"):
        JM.agg_post_cuda([h.to(torch.int32)], nr)
    with pytest.raises(ValueError, match="int64"):
        JM.agg_post_cuda([h, h[:9]], nr)
    with pytest.raises(ValueError, match="contiguous"):
        JM.agg_post_cuda([torch.arange(20, dtype=torch.int64)[::2]], nr)
    with pytest.raises(ValueError, match="int32"):
        JM.agg_post_cuda([h], nr.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        JM.agg_post_cuda([h], nr.reshape(1))
    with pytest.raises(ValueError, match="table holds"):
        JM.agg_post_cuda([h] * (JM.AGG_POST_MAX + 1), nr)
