"""K5's dense mode and K6 on the CPU: the plain models of what the one-launch
designs of csrc/join_build.cu (join_dense) and csrc/join_probe.cu
(join_probe) do, and both wrappers' parameter blocks and buffers read back
the way the kernels read them.

K5's dense mode is one cooperative launch: the blocks fill the table, wait
at a grid barrier and scatter the live non-NULL rows with atomicMin, in any
block order. K6 is one launch with no memset: each block's match count goes
to a per-device scratch word and the block that takes the last ticket sums
them into the call's own count word. The models
(ops/join.py dense_launch_model, probe_launch_model) are held against
join_dense_plain and unique_probe_plain bit for bit; the twins themselves
are held against the JAX package by test_torch_join.py,
test_torch_join_mxu.py, test_torch_join_spill.py and test_torch_queries.py.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from trino_tpu_torch import launch_trace as LT
from trino_tpu_torch import native
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import join_mxu as JM
from trino_tpu_torch.ops.aggregate import hash_slots

torch.set_num_threads(1)
CSRC = pathlib.Path(J.__file__).resolve().parents[1] / "csrc"
ROUTES = ("dense", "mxu", "search")
DTYPES = {(1, 0): torch.int8, (2, 0): torch.int16, (4, 0): torch.int32,
          (8, 0): torch.int64, (4, 1): torch.float32, (8, 1): torch.float64}


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


def read_cols(words, cap: int):
    """Key columns (values, valid) from 4-word entries, read as the
    kernels read them: values at the pointer in the element size and
    kind, the validity a byte a row (None at pointer 0)."""
    out = []
    for q in range(0, len(words), 4):
        ptr, vptr, esz, is_float = words[q:q + 4]
        dtype = DTYPES[(esz, is_float)]
        values = mem(ptr, ctypes.c_uint8, cap * esz, torch.uint8).view(dtype)
        valid = None if vptr == 0 else mem(vptr, ctypes.c_bool, cap,
                                           torch.bool)
        out.append((values, valid))
    return out


def key_cases(kind: str, cap: int, seed: int):
    """Build key columns of one case: unique keys (a key tuple for the
    composite) with NULLs, in a shuffled order."""
    rng = np.random.default_rng(seed)
    if kind == "dense":              # a shuffled span, like an orderkey
        v = torch.from_numpy(rng.permutation(cap) * 3 + 1000)
        return [(v, torch.from_numpy(rng.random(cap) >= 0.1))]
    if kind == "negative":           # int32 keys below zero
        v = torch.from_numpy(-2 * rng.permutation(cap).astype(np.int32) - 7)
        return [(v, torch.from_numpy(rng.random(cap) >= 0.05))]
    if kind == "float":              # float64 keys, -0.0 among them
        v = torch.from_numpy(rng.permutation(cap) * 0.5 - 3.0)
        v[v == 0.0] = -0.0
        return [(v, None)]
    # composite (int32, int64): each tuple distinct
    a = torch.from_numpy(rng.integers(0, 40, cap).astype(np.int32))
    b = torch.from_numpy(rng.permutation(cap) * 5 - cap)
    return [(a, torch.from_numpy(rng.random(cap) >= 0.1)), (b, None)]


def probe_of(bcols, cap: int, seed: int):
    """Probe columns: build keys (hits), keys past the span, keys below
    the smallest key, NULLs."""
    rng = np.random.default_rng(seed)
    bcap = bcols[0][0].shape[0]
    pick = torch.from_numpy(rng.integers(0, max(bcap, 1), cap))
    kind = torch.from_numpy(rng.integers(0, 4, cap))
    out = []
    for values, _ in bcols:
        v = values[pick] if bcap else torch.zeros(cap, dtype=values.dtype)
        big = torch.full_like(v, 1e6 if v.is_floating_point() else min(
            10**6, torch.iinfo(v.dtype).max // 4))
        v = torch.where(kind == 1, big + v.abs() % 100, v)
        v = torch.where(kind == 2, -big - v.abs() % 100, v)
        out.append((v.contiguous(),
                    torch.from_numpy(rng.random(cap) >= 0.05)))
    return out


def hash_build(cols, n: int):
    """K5's open-addressing table of a unique build as the kernel leaves
    it: power-of-two slots from hash_slots, linear probing from
    mix64(key), row -1 for an empty slot."""
    cap = cols[0][0].shape[0]
    slots = hash_slots(cap)
    keys = torch.zeros(slots, dtype=torch.int64)
    rows = torch.full((slots,), -1, dtype=torch.int32)
    key, null = J._key_cols(cols)
    mixed = J._mix64(key)
    for i in range(min(n, cap)):
        if null[i]:
            continue
        s = int(mixed[i]) & (slots - 1)
        while rows[s] != -1 and keys[s] != key[i]:
            s = (s + 1) & (slots - 1)
        if rows[s] == -1:
            keys[s], rows[s] = key[i], i
    return keys, rows


def prepared_for(route: str, bcols, bn: int, size: int):
    """(twin Prepared, the kernel's table or hash table) of one route."""
    bnr = torch.tensor(bn, dtype=torch.int32)
    stats, lookup = J.join_build_plain(bcols, bnr)
    prep = J.Prepared(None, (), stats, lookup)
    if route == "dense":
        prep.dense = J.join_dense_plain(bcols, bnr, stats, size)
        return prep, prep.dense
    if route == "mxu":
        prep.mxu = JM.mxu_table_plain(bcols, bnr, stats, lookup, None, size)
        return prep, prep.mxu.flatten()
    return prep, hash_build(bcols, bn)


PROBE_CASES = {   # key kind, build cap, live build rows, probe cap, live
    "dense, dead and NULL rows": ("dense", 300, 280, 1001, 950),
    "negative keys": ("negative", 200, 200, 640, 640),
    "float keys": ("float", 150, 140, 333, 300),
    "composite keys": ("composite", 250, 240, 777, 700),
    "empty build": ("dense", 64, 0, 100, 100),
    "no live probe row": ("dense", 64, 64, 100, 0),
    "probe capacity 0": ("dense", 64, 64, 0, 0),
}


# ------------------------------------------------------------- K5 model


@pytest.mark.parametrize("order", ["forward", "reversed", "shuffled"])
@pytest.mark.parametrize("grid", [1, 3, 17])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_dense_model_gives_the_twin(case, grid, order):
    """The fill stores every slot exactly once before the barrier (16
    bytes a store, the tail one slot at a time), and the atomicMin scatter
    over the blocks in any order gives join_dense_plain's table bit for
    bit: duplicate keys keep the smallest row, or the smallest payload;
    NULL, dead, below-kmin and past-the-span rows write nothing."""
    kind, cap, n, _, _ = PROBE_CASES[case]
    cols = key_cases(kind, cap, seed=len(case))
    if cap > 8:     # duplicates: K5's dense mode keeps the smallest
        for values, _ in cols:
            values[cap // 2:cap // 2 + 5] = values[1]
    nr = torch.tensor(n, dtype=torch.int32)
    stats, _ = J.join_build_plain(cols, nr)
    blocks = {"forward": list(range(grid)),
              "reversed": list(range(grid))[::-1],
              "shuffled": list(np.random.default_rng(grid).permutation(
                  grid))}[order]
    payload = torch.from_numpy(np.random.default_rng(5).permutation(cap)
                               .astype(np.int32))
    for size in (1024, 61, 4):       # the span, its front, a tail only
        for pay in (None, payload):
            table, stores = J.dense_launch_model(cols, nr, stats, size, pay,
                                                 grid, blocks)
            want = J.join_dense_plain(cols, nr, stats, size, pay)
            assert torch.equal(table, want)
            assert torch.equal(stores, torch.ones(size, dtype=torch.int64))


# -------------------------------------------------- K5 through its wrapper


def dense_kernel_model(monkeypatch, grid: int = 7):
    """Run join_dense_cuda on CPU tensors: the launch reads its parameter
    words, num_rows, stats and payload at their pointers, scribbles over
    the table (device memory starts as garbage) and runs the model into
    it. Returns the launches."""
    calls = []

    def join_dense(table, nkeys, cap, num_rows, stats, payload, dense, size,
                   stream):
        words = list((ctypes.c_int64 * (4 * nkeys)).from_address(table))
        cols = read_cols(words, cap)
        n = ctypes.c_int32.from_address(num_rows).value
        st = mem(stats, ctypes.c_int64, J.N_STATS, torch.int64)
        pay = None if payload == 0 else mem(payload, ctypes.c_int32, cap,
                                            torch.int32)
        out = mem(dense, ctypes.c_int32, size, torch.int32)
        out.fill_(-3)
        got, _ = J.dense_launch_model(cols, torch.tensor(n), st, size, pay,
                                      grid)
        out.copy_(got)
        calls.append((nkeys, words, stats, payload, size))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: join_dense)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    return calls


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("nkeys,block", [(1, 8), (2, 8), (4, 64),
                                         (17, native.TABLE_MAX)])
def test_dense_wrapper_reads_its_block(monkeypatch, nkeys, block,
                                       with_payload):
    """One launch; the parameter words are 4 per key column (values,
    validity or 0, element size, float flag) in a block of 8 words for 1
    or 2 columns, 64 for 4 and the full table past 16; the payload's
    pointer (0 without one) and stats travel beside them; the table equals
    the twin's."""
    rng = np.random.default_rng(nkeys)
    cap, n = 500, 470
    cols = [(torch.from_numpy(rng.integers(-3, 4, cap)),
             torch.from_numpy(rng.random(cap) >= 0.1) if q % 2 else None)
            for q in range(nkeys - 1)]
    cols.insert(0, (torch.from_numpy(rng.permutation(cap).astype(np.int32)),
                    torch.from_numpy(rng.random(cap) >= 0.1)))
    nr = torch.tensor(n, dtype=torch.int32)
    stats, _ = J.join_build_plain(cols, nr)
    payload = torch.from_numpy(rng.permutation(cap).astype(np.int32)) \
        if with_payload else None
    size = 1024
    calls = dense_kernel_model(monkeypatch)
    before = J.join_dense_cuda.launches
    got = J.join_dense_cuda(cols, nr, stats, size, payload)
    assert J.join_dense_cuda.launches == before + 1 and len(calls) == 1
    assert block_words(4 * nkeys) == block
    nk, words, stats_ptr, pay_ptr, got_size = calls[0]
    assert nk == nkeys and got_size == size
    assert words == J._key_table(cols)
    assert stats_ptr == stats.data_ptr()
    assert pay_ptr == (0 if payload is None else payload.data_ptr())
    assert torch.equal(got, J.join_dense_plain(cols, nr, stats, size,
                                               payload))


def test_dense_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cols = key_cases("dense", 40, 1)
    nr = torch.tensor(30, dtype=torch.int32)
    stats, _ = J.join_build_plain(cols, nr)
    with pytest.raises(ValueError, match="CUDA"):
        J.join_dense_cuda(cols, nr, stats, 128)
    dense_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        J.join_dense_cuda(cols, nr.to(torch.int64), stats, 128)
    with pytest.raises(ValueError, match="does not match"):
        J.join_dense_cuda([(cols[0][0][::2], None)], nr, stats, 128)
    with pytest.raises(ValueError, match="validity"):
        J.join_dense_cuda([(cols[0][0], cols[0][1].to(torch.int8))], nr,
                          stats, 128)
    with pytest.raises(ValueError, match="stats"):
        J.join_dense_cuda(cols, nr, stats[:5], 128)
    with pytest.raises(ValueError, match="payload"):
        J.join_dense_cuda(cols, nr, stats, 128,
                          torch.zeros(40, dtype=torch.int64))
    with pytest.raises(ValueError, match="table holds"):
        J.join_dense_cuda(cols * 513, nr, stats, 128)


def block_words(words: int) -> int:
    """The parameter block csrc/common.cuh param_block_words picks for a
    table of `words` words (0 past TABLE_MAX)."""
    common = (CSRC / "common.cuh").read_text()
    body = common[common.index("inline int param_block_words"):]
    body = body[:body.index("\n}")]
    limits = re.findall(r"len <= (\w+)", body)
    assert limits == ["8", "64", "TABLE_MAX"]
    for limit in (8, 64, native.TABLE_MAX):
        if words <= limit:
            return limit
    return 0


def test_launchers_switch_on_the_sized_block():
    """The 1, 2 and 4 key columns of K5 and K6 take blocks of 8 or 64
    words; past TABLE_MAX there is none, and both launchers switch over
    the 8, 64 and TABLE_MAX blocks."""
    assert [block_words(w) for w in (1, 8, 9, 64, 65, 2048, 2049)] == [
        8, 8, 64, 64, native.TABLE_MAX, native.TABLE_MAX, 0]
    # join_build.cu switches twice: K5's dense mode and its runs mode
    for src, words, launchers in (
            ("join_build.cu", "KEY_FIELDS * nkeys", 2),
            ("join_probe.cu", "2 * KEY_FIELDS * nkeys", 1)):
        text = (CSRC / src).read_text()
        assert text.count(f"switch (param_block_words({words}))") \
            == launchers
        assert re.findall(r"case (\w+):\n\s+return \w+<(\w+)>", text) == [
            ("8", "8"), ("64", "64"), ("TABLE_MAX", "TABLE_MAX")] * launchers


# ------------------------------------------------------------- K6 model


def probe_setup(case: str, route: str):
    """(probe cols, build cols, probe live rows, twin Prepared, the
    kernel's table, table size) of one case on one route."""
    kind, bcap, bn, pcap, pn = PROBE_CASES[case]
    bcols = key_cases(kind, bcap, seed=len(case))
    pcols = probe_of(bcols, pcap, seed=len(case) + 1)
    size = 512 if route == "mxu" else 1024
    prep, table = prepared_for(route, bcols, bn, size)
    return pcols, bcols, pn, prep, table, size


def run_model(pcols, bcols, pn, prep, table, size, route, grid, scratch,
              order=None):
    count = torch.full((1,), -5, dtype=torch.int64)
    dense = table if route != "search" else None
    found, brow, writes = J.probe_launch_model(
        pcols, bcols, pn, J.ROUTE_CODE[route], dense, size,
        int(prep.stats[J.KMIN]), table if route == "search" else None,
        grid, scratch, count, order)
    return found, brow, count, writes


@pytest.mark.parametrize("grid", [1, 2, 9])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_model_gives_the_twin(case, route, grid):
    """Each row is written exactly once (tiles of 256 x R rows, the grid
    striding over them), found and brow equal unique_probe_plain's bit for
    bit (0 where nothing matched), and the block that takes the last
    ticket writes the twin's count and leaves the per-device word 0, over
    several block orders."""
    pcols, bcols, pn, prep, table, size = probe_setup(case, route)
    wf, wb, wc = J.unique_probe_plain(pcols, bcols,
                                      torch.tensor(pn, dtype=torch.int32),
                                      prep)
    cap = pcols[0][0].shape[0]
    for order in (None, list(range(grid))[::-1],
                  list(np.random.default_rng(grid).permutation(grid))):
        scratch = torch.zeros(1, dtype=torch.int64)
        found, brow, count, writes = run_model(
            pcols, bcols, pn, prep, table, size, route, grid, scratch, order)
        assert torch.equal(found, wf) and torch.equal(brow, wb)
        assert int(count) == int(wc)
        assert torch.equal(writes, torch.ones(cap, dtype=torch.int64))
        assert int(scratch[0]) == 0


def test_probe_counts_of_two_calls_in_flight():
    """Two probes launched before one fetch share the per-device word;
    each count lands in its own word, both right, and the word is 0
    after each."""
    scratch = torch.zeros(1, dtype=torch.int64)
    outs = []
    for case, route, grid in (("composite keys", "search", 5),
                              ("dense, dead and NULL rows", "mxu", 2)):
        pcols, bcols, pn, prep, table, size = probe_setup(case, route)
        _, _, count, _ = run_model(pcols, bcols, pn, prep, table, size,
                                   route, grid, scratch)
        want = J.unique_probe_plain(pcols, bcols,
                                    torch.tensor(pn, dtype=torch.int32),
                                    prep)[2]
        outs.append((count, int(want)))
    assert [int(c) for c, _ in outs] == [w for _, w in outs]
    assert outs[0][1] != outs[1][1] and int(scratch[-1]) == 0


@pytest.mark.parametrize("cap,route,size,sms,want", [
    (0, 1, 1024, 132, 1), (512, 1, 1024, 132, 1), (513, 1, 1024, 132, 2),
    (262_144, 2, 128, 132, 512), (262_144, 2, 4096, 132, 264),
    (4_194_304, 2, 4096, 132, 264), (4_194_304, 2, 8192, 132, 1056),
    (1025, 0, 0, 132, 5), (5_242_880, 0, 0, 132, 1056),
    (5_242_880, 0, 0, 114, 912),
    (1 << 26, 0, 0, 300, J.PROBE_GRID_MAX)])
def test_probe_grid_is_sized_to_the_card(cap, route, size, sms, want):
    """One block per tile of 256 x 2 rows of capacity (256 x 1 on the
    search route), at most 8 per SM, or 2 where each block stages an mxu
    table of more than 4 KB, and at most PROBE_GRID_MAX."""
    assert J.probe_grid(cap, route, size, sms) == want


@pytest.mark.parametrize("cap", [0, 1, 5, 8, 1000, 4099])
def test_probe_outputs_are_views_of_one_allocation(cap):
    """found bool[cap], brow int64[cap] and a 0-d int64 count in one
    allocation: brow at its start, the count after it, found after the
    count (brow 16-byte and found 8-byte aligned from an aligned start)."""
    found, brow, count = J.probe_outputs(cap, "cpu")
    assert found.dtype is torch.bool and found.shape == (cap,)
    assert brow.dtype is torch.int64 and brow.shape == (cap,)
    assert count.dtype is torch.int64 and count.dim() == 0
    base = brow.untyped_storage().data_ptr()
    assert count.untyped_storage().data_ptr() == base
    assert found.untyped_storage().data_ptr() == base
    assert brow.storage_offset() == 0 and count.storage_offset() == cap
    assert found.storage_offset() == 8 * cap + 8      # in bytes
    assert brow.untyped_storage().nbytes() == 8 * (cap + 1 + (cap + 7) // 8)
    assert torch.stack([count, torch.tensor(3)]).shape == (2,)


# -------------------------------------------------- K6 through its wrapper


def probe_kernel_model(monkeypatch):
    """Run unique_probe_cuda on CPU tensors: the launch reads its parameter
    words (probe columns, then build columns), num_rows, K5's kmin and the
    route's table at their pointers, and runs the model on them into the
    memory of found, brow and count with the scratch behind its pointers.
    Returns the launches and the per-device scratches."""
    calls, scratches = [], {}

    def scratch_of(index):
        if index not in scratches:
            scratches[index] = torch.zeros(1, dtype=torch.int64)
        return scratches[index]

    def join_probe(table, nkeys, cap, num_rows, route, dense, size, stats,
                   slot_keys, slot_rows, slots, found, brow, count, ticket,
                   grid, stream):
        words = list((ctypes.c_int64 * (8 * nkeys)).from_address(table))
        pcols = read_cols(words[:4 * nkeys], cap)
        # the build's capacity is no parameter: the test names it
        bcols = read_cols(words[4 * nkeys:], calls_bcap[0])
        n = ctypes.c_int32.from_address(num_rows).value
        kmin = ctypes.c_int64.from_address(stats + 8 * J.KMIN).value
        scratch = mem(ticket, ctypes.c_int64, 1, torch.int64)
        assert int(scratch[0]) == 0
        if route == J.ROUTE_CODE["search"]:
            tab = None
            hashed = (mem(slot_keys, ctypes.c_int64, slots, torch.int64),
                      mem(slot_rows, ctypes.c_int32, slots, torch.int32))
        else:
            words_ = 2 * size if route == J.ROUTE_CODE["mxu"] else size
            tab = mem(dense, ctypes.c_int32, words_, torch.int32)
            hashed = None
        out_count = mem(count, ctypes.c_int64, 1, torch.int64)
        f, b, _ = J.probe_launch_model(pcols, bcols, max(0, min(n, cap)),
                                       route, tab, size, kmin, hashed,
                                       grid, scratch, out_count)
        mem(found, ctypes.c_bool, cap, torch.bool).copy_(f)
        mem(brow, ctypes.c_int64, cap, torch.int64).copy_(b)
        calls.append(dict(words=words, cap=cap, route=route, size=size,
                          grid=grid, found=found, brow=brow, count=count,
                          ticket=ticket, nkeys=nkeys))
        return 0
    calls_bcap = [0]
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: join_probe)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    monkeypatch.setattr(native, "sm_count", lambda index: 132)
    monkeypatch.setattr(J, "_probe_scratch", scratch_of)
    return calls, scratches, calls_bcap


def kernel_prepared(route: str, bcols, bn: int, size: int):
    """The Prepared K5/K12 leave on the card for one route: the hash
    table's lookup tuple on the search route."""
    prep, table = prepared_for(route, bcols, bn, size)
    if route == "search":
        keys, rows = table
        prep = J.Prepared(None, (), prep.stats,
                          ("hash", keys, rows, torch.ones_like(rows)))
    return prep


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nkeys,block", [(1, 8), (2, 64), (4, 64),
                                         (9, native.TABLE_MAX)])
def test_probe_wrapper_reads_its_block(monkeypatch, nkeys, block, route):
    """One launch; the parameter words are 4 per probe key column, then 4
    per build key column, in a block of 8 words for one column, 64 for 2
    or 4 and the full table past 8; found, brow and count are the views
    of one allocation at the pointers the kernel writes; the grid is
    probe_grid's; the outputs equal the twin's."""
    rng = np.random.default_rng(nkeys)
    bcap, bn, pcap, pn = 300, 290, 1001, 950
    first = torch.from_numpy(rng.permutation(bcap) * 2 + 5)
    bcols = [(first, torch.from_numpy(rng.random(bcap) >= 0.1))] + [
        (torch.from_numpy(rng.integers(0, 2, bcap).astype(np.int16)), None)
        for _ in range(nkeys - 1)]
    pcols = probe_of(bcols, pcap, seed=nkeys + 1)
    size = 1024
    prep = kernel_prepared(route, bcols, bn, size)
    twin, _ = prepared_for(route, bcols, bn, size)
    pnr = torch.tensor(pn, dtype=torch.int32)
    calls, scratches, bcap_box = probe_kernel_model(monkeypatch)
    bcap_box[0] = bcap
    before = J.unique_probe_cuda.launches
    found, brow, count = J.unique_probe_cuda(pcols, bcols, pnr, prep)
    assert J.unique_probe_cuda.launches == before + 1 and len(calls) == 1
    c = calls[0]
    assert block_words(8 * nkeys) == block
    assert c["words"] == J._key_table(pcols) + J._key_table(bcols)
    assert c["route"] == J.ROUTE_CODE[route]
    assert c["grid"] == J.probe_grid(pcap, c["route"], c["size"], 132)
    assert (c["found"], c["brow"], c["count"]) == (
        found.data_ptr(), brow.data_ptr(), count.data_ptr())
    assert c["ticket"] == scratches[0].data_ptr()
    wf, wb, wc = J.unique_probe_plain(pcols, bcols, pnr, twin)
    assert torch.equal(found, wf) and torch.equal(brow, wb)
    assert int(count) == int(wc) and count.dim() == 0


def test_probe_wrapper_two_calls_before_one_fetch(monkeypatch):
    """As _run_unique_inner does: two probes launched, then ONE
    torch.stack(...).tolist() of their counts; each is right, the scratch
    is the same for both and the outputs are not."""
    calls, scratches, bcap_box = probe_kernel_model(monkeypatch)
    results, wants = [], []
    for case, route in (("composite keys", "search"),
                        ("negative keys", "dense")):
        kind, bcap, bn, pcap, pn = PROBE_CASES[case]
        bcols = key_cases(kind, bcap, seed=len(case))
        pcols = probe_of(bcols, pcap, seed=len(case) + 1)
        bcap_box[0] = bcap
        pnr = torch.tensor(pn, dtype=torch.int32)
        results.append(J.unique_probe_cuda(
            pcols, bcols, pnr, kernel_prepared(route, bcols, bn, 1024)))
        twin, _ = prepared_for(route, bcols, bn, 1024)
        wants.append(int(J.unique_probe_plain(pcols, bcols, pnr, twin)[2]))
    assert torch.stack([c for _, _, c in results]).tolist() == wants
    assert calls[0]["ticket"] == calls[1]["ticket"] == \
        scratches[0].data_ptr()
    assert calls[0]["count"] != calls[1]["count"]


def test_probe_scratch_is_made_once_per_device(monkeypatch):
    """The per-device word of tickets and matches is zeroed once; later
    calls reuse it."""
    made = []
    monkeypatch.setattr(J, "_PROBE_SCRATCH", {})
    monkeypatch.setattr(torch, "zeros", lambda n, dtype, device: made.append(
        (n, dtype, str(device))) or torch.empty(0))
    assert J._probe_scratch(0) is J._probe_scratch(0)
    assert made == [(1, torch.int64, "cuda:0")]


def test_probe_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    bcols = key_cases("dense", 40, 1)
    pcols = probe_of(bcols, 64, 2)
    pnr = torch.tensor(60, dtype=torch.int32)
    prep, _ = prepared_for("dense", bcols, 40, 256)
    with pytest.raises(ValueError, match="CUDA"):
        J.unique_probe_cuda(pcols, bcols, pnr, prep)
    probe_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        J.unique_probe_cuda(pcols, bcols, pnr.reshape(1), prep)
    with pytest.raises(ValueError, match="as many key columns"):
        J.unique_probe_cuda(pcols * 2, bcols, pnr, prep)
    with pytest.raises(ValueError, match="probe key column"):
        J.unique_probe_cuda([(pcols[0][0][::2], None)], bcols, pnr, prep)
    with pytest.raises(ValueError, match="table holds"):
        J.unique_probe_cuda(pcols * 257, bcols * 257, pnr, prep)
    search, _ = prepared_for("search", bcols, 40, 256)
    with pytest.raises(ValueError, match="hash table"):
        J.unique_probe_cuda(pcols, bcols, pnr, search)
    runs = J.Prepared(None, (), prep.stats, prep.lookup, runs=(None,),
                      mxu=torch.zeros(128, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="expanding probe"):
        J.unique_probe_cuda(pcols, bcols, pnr, runs)


# ------------------------------------------------- the chip's shapes


def test_chip_smoke_join_cases_cover_the_redesign():
    """Phase 2 holds K5's dense mode at a 2^22-slot table and K13 in K6
    at a 4,096-slot table under the main path's probe (capacity 262,144,
    150,000 live), with a probe capacity off the 4-row step."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_join", CSRC.parents[1] / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    spans = [4 * bn for kind, bcap, bn, *_ in C.JOIN_CASES if kind == "dense"]
    assert any(1 << 21 < s <= 1 << 22 for s in spans)
    assert any(pcap % 4 for *_, pcap, _ in C.JOIN_CASES)
    assert (4096, 262_144, 150_000) in {(span, pcap, pn) for _, _, span, _,
                                        pcap, pn in C.MXU_CASES}


def test_launch_trace_shapes_are_the_main_paths():
    """launch_trace's K5 and K6 inputs: q3 sf1's dense build (30,136 live
    keys over a span that takes 262,144 slots), the K13 probe (150,000
    live of 262,144 over 25 keyed build rows) and q3's search probe."""
    cols, nr = LT.dense_build_cols(LT.DENSE_CAP, LT.DENSE_LIVE, "cpu")
    key = cols[0][0][:int(nr)]
    assert int(nr) == 30_136 and key.unique().numel() == 30_136
    assert 131_072 < int(key.max() - key.min()) + 1 <= 262_144
    bcols, bnr, pcols, pnr = LT.probe_cols(LT.MXU_BUILD, LT.MXU_SPAN,
                                           LT.MXU_CAP, LT.MXU_LIVE, "cpu")
    assert (int(bnr), int(pnr), pcols[0][0].numel()) == (25, 150_000,
                                                         262_144)
    hit = torch.isin(pcols[0][0][:150_000], bcols[0][0][:25])
    assert 0 < int(hit.sum()) < 150_000
