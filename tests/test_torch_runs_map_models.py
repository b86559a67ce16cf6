"""K5's runs mode and K33's map mode on the CPU: the plain models of what
the one-launch designs of csrc/join_build.cu (join_runs) and csrc/list.cu
(collect_map, collect_map_pack) do, and both wrappers' arguments and
buffers read back the way the kernels read them.

K5's runs mode is one cooperative launch: each live row finds its slot
once, the row that claimed the slot takes its run's start from a block
scan and one atomic a block and round on a per-device counter, the other
rows take places counted down from that row's cursor, and each run is put
in row order (a rank per row up to 32 rows, a
block's chunk sorts and merge passes past that). K33's map mode takes a
direct-address (group, key - kmin) table in one launch where the span is
narrow, else packs (group, key - kmin) into the bits they use, sorts them
with K10 and packs the runs. The models (ops/join.py runs_launch_model,
ops/lists.py map_launch_model) are held against join_runs_plain and
collect_map_plain bit for bit; the twins themselves are held against the
JAX package by test_torch_join.py and test_torch_list.py.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as C
from trino_tpu_torch import launch_trace as LT
from trino_tpu_torch import native
from trino_tpu_torch.ops import aggregate as A
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import lists as LS
from trino_tpu_torch.ops import sort as S
from trino_tpu_torch.ops.aggregate import hash_slots

torch.set_num_threads(1)
CSRC = pathlib.Path(J.__file__).resolve().parents[1] / "csrc"
ORDERS = ("forward", "reversed", "shuffled")
I32_MAX = (1 << 31) - 1


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


def block_order(order: str, grid: int):
    return {"forward": list(range(grid)),
            "reversed": list(range(grid))[::-1],
            "shuffled": [int(b) for b in np.random.default_rng(grid)
                         .permutation(grid)]}[order]


# ------------------------------------------------------------- K5 model


def hash_build(cols, n: int, seed: int = 0):
    """K5's open-addressing table as join_build leaves it: power-of-two
    slots from hash_slots, linear probing from mix64(key), each slot
    claimed by whichever of its rows came first (rows arrive in a shuffled
    order, as the card's threads do), with its key's row count."""
    cap = cols[0][0].shape[0]
    slots = hash_slots(cap)
    keys = torch.zeros(slots, dtype=torch.int64)
    rows = torch.full((slots,), -1, dtype=torch.int32)
    counts = torch.zeros(slots, dtype=torch.int32)
    key, null = J._key_cols(cols)
    mixed = J._mix64(key)
    for i in np.random.default_rng(seed).permutation(min(n, cap)).tolist():
        if null[i]:
            continue
        s = int(mixed[i]) & (slots - 1)
        while rows[s] != -1 and keys[s] != key[i]:
            s = (s + 1) & (slots - 1)
        if rows[s] == -1:
            keys[s], rows[s] = key[i], i
        counts[s] += 1
    return ("hash", keys, rows, counts)


def runs_by_key(runs, start, count, keys, occupied):
    """{key: its rows as its run holds them}, each run read through its
    (start, count); and the places the runs cover."""
    out, places = {}, []
    for s in torch.nonzero(occupied).flatten().tolist():
        lo, c = int(start[s]), int(count[s])
        out[int(keys[s])] = runs[lo:lo + c].tolist()
        places += range(lo, lo + c)
    return out, sorted(places)


def runs_keys(kind: str, cap: int, seed: int):
    """Build keys: unique keys (runs of 1); runs of 31 and of 33 rows
    (either side of the per-row rank's limit) among unique keys; one key
    on 20,000 rows among unique keys; composite (int32, int64) pairs with
    runs of a few rows. NULLs in each."""
    rng = np.random.default_rng(seed)
    v = rng.permutation(cap).astype(np.int64) * 3 + 11
    if kind == "runs of 31 and 33":
        v[rng.permutation(cap)[:31]] = 5
        v[rng.permutation(cap)[:33]] = 8
    elif kind == "one key on 20,000 rows":
        v[rng.permutation(cap)[:20_000]] = 5
    valid = rng.random(cap) >= 0.03
    if kind == "one key on 20,000 rows":
        valid[:] = True
    cols = [(torch.from_numpy(v), torch.from_numpy(valid))]
    if kind == "composite":
        cols = [(torch.from_numpy(rng.integers(0, cap // 4, cap)
                                  .astype(np.int32)),
                 torch.from_numpy(rng.random(cap) >= 0.03)),
                (torch.from_numpy(rng.integers(0, 3, cap)), None)]
    return cols


RUNS_CASES = {  # kind, cap, live rows
    "unique keys": ("unique", 3000, 2990),
    "runs of 31 and 33": ("runs of 31 and 33", 2000, 2000),
    "one key on 20,000 rows": ("one key on 20,000 rows", 24_000, 24_000),
    "composite keys": ("composite", 1500, 1400),
    "an empty build": ("unique", 500, 0),
    "dead and NULL rows only": ("unique", 300, 1),
}


def runs_setup(case: str):
    kind, cap, n = RUNS_CASES[case]
    cols = runs_keys(kind, cap, seed=len(case))
    nr = torch.tensor(n, dtype=torch.int32)
    stats, lookup = J.join_build_plain(cols, nr)
    return cols, nr, stats, lookup, hash_build(cols, n)


def check_runs(cols, nr, stats, lookup, table, size, grid, order):
    (wruns, wstart, wcount), wdense = J.join_runs_plain(cols, nr, stats,
                                                        lookup, size)
    want, _ = runs_by_key(wruns, wstart, wcount, lookup[1],
                          torch.ones_like(wcount, dtype=torch.bool))
    counter = torch.zeros(1, dtype=torch.int32)
    runs, start, dense, lookups = J.runs_launch_model(
        cols, nr, stats, table, size, grid, order, counter)
    assert int(counter[0]) == 0              # ready for the next call
    got, places = runs_by_key(runs, start, table[3], table[1],
                              table[2] >= 0)
    assert got == want                       # rows per key, in row order
    assert places == list(range(len(places)))   # the runs tile [0, total)
    key, null = J._key_cols(cols)
    n = int(nr)
    assert torch.equal(lookups, (~null[:n]).to(torch.int64))  # one each
    if size:
        assert torch.equal(dense != I32_MAX, wdense != I32_MAX)
        hit = dense != I32_MAX
        assert torch.equal(table[1][dense[hit].long()],
                           lookup[1][wdense[hit].long()])


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", [1, 3, 40])
@pytest.mark.parametrize("case", sorted(set(RUNS_CASES)
                                        - {"one key on 20,000 rows"}))
def test_k5_runs_model_gives_the_twin(case, grid, order):
    """Each key's rows in ascending row order, the runs tiling the places
    [0, total) once each, one slot lookup per live non-NULL row, with and
    without a dense table of slots, over grids of 1, 3 and 40 blocks in
    any order."""
    cols, nr, stats, lookup, table = runs_setup(case)
    kmin, kmax = J.unsigned(int(stats[J.KMIN])), J.unsigned(
        int(stats[J.KMAX]))
    sizes = [0]
    if kmax >= kmin and kmax - kmin < (1 << 22):   # a span the router takes
        sizes.append(1 << max(10, (kmax - kmin).bit_length()))
    for size in sizes:
        check_runs(cols, nr, stats, lookup, table, size, grid,
                   block_order(order, grid))


@pytest.mark.parametrize("grid,order", [(1, "forward"), (3, "reversed"),
                                        (40, "shuffled")])
def test_k5_runs_model_orders_a_20000_row_run(grid, order):
    """One key on 20,000 rows among unique keys: its run is sorted by the
    owner's block (10 chunks, four merge passes) into row order, with and
    without the dense table."""
    cols, nr, stats, lookup, table = runs_setup("one key on 20,000 rows")
    assert int(stats[J.MAX_RUN]) == 20_000
    for size in (0, 1 << 17):
        check_runs(cols, nr, stats, lookup, table, size, grid,
                   block_order(order, grid))


@pytest.mark.parametrize("c", [33, 100, 2048, 2049, 4096, 4097, 9000,
                               20_000])
def test_k5_block_sort_lands_in_runs(c):
    """A long run is sorted in place: its chunks go into the run or into
    the scratch so that the last of ceil(log2(chunks)) merge passes writes
    the run; the merge-path search takes every row once."""
    rows = torch.from_numpy(np.random.default_rng(c).permutation(
        5 * c)[:c].astype(np.int32))
    runs = rows.clone()
    scratch = torch.full((c,), -1, dtype=torch.int32)
    passes = J.block_sort_model(runs, scratch)
    chunks = -(-c // J.RUNS_CHUNK)
    assert passes == (chunks - 1).bit_length()
    assert torch.equal(runs, torch.sort(rows).values)


def test_k5_runs_constants_match_the_kernel():
    text = (CSRC / "join_build.cu").read_text()
    for name, value in (("SHORT_RUN", J.RUNS_SHORT), ("CHUNK", J.RUNS_CHUNK),
                        ("RUNS_MAX_GRID", J.RUNS_MAX_GRID),
                        ("RUN_ITEMS", J.RUNS_ITEMS)):
        assert f"constexpr int {name} = {value};" in text
    assert "constexpr int THREADS = 256;" in text and J.RUNS_THREADS == 256


def test_k5_runs_is_one_cooperative_launch_without_a_memset():
    """join_runs enqueues one cooperative launch and counts it; the old
    count, scan, scatter, place and order kernels and the cursor's memset
    are gone."""
    text = (CSRC / "join_build.cu").read_text()
    body = text[text.index("TT_EXPORT int join_runs("):]
    assert "cudaMemsetAsync" not in body and "<<<" not in body
    launch = text[text.index("int runs_launch("):
                  text.index("TT_EXPORT int join_runs(")]
    assert launch.count("cudaLaunchCooperativeKernel") == 1
    assert "++runs_enqueues_;" in launch
    assert "TT_EXPORT int64_t join_runs_enqueues()" in text
    for gone in ("runs_place_kernel", "runs_order_kernel",
                 "runs_start_kernel", "runs_dense_kernel",
                 "dense_init_kernel", "tile_offsets", "placed"):
        assert gone not in text


# -------------------------------------------------- K5 through its wrapper


def runs_kernel_model(monkeypatch, grid: int = 5):
    """Run join_runs_cuda on CPU tensors: the launch reads its parameter
    words, num_rows, stats and the hash table at their pointers and runs
    the model into the outputs behind theirs. Returns the launches."""
    calls = []

    def join_runs(table, nkeys, cap, num_rows, stats, slot_keys, slot_rows,
                  slot_counts, slots, slot_start, scratch, counter, runs,
                  dense, size, stream):
        words = list((ctypes.c_int64 * (4 * nkeys)).from_address(table))
        cols = []
        for q in range(nkeys):
            ptr, vptr, esz, is_float = words[4 * q:4 * q + 4]
            dt = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}[esz] if not is_float else \
                {4: torch.float32, 8: torch.float64}[esz]
            v = mem(ptr, ctypes.c_uint8, cap * esz, torch.uint8).view(dt)
            a = None if vptr == 0 else mem(vptr, ctypes.c_bool, cap,
                                           torch.bool)
            cols.append((v, a))
        n = ctypes.c_int32.from_address(num_rows).value
        lookup = ("hash", mem(slot_keys, ctypes.c_int64, slots, torch.int64),
                  mem(slot_rows, ctypes.c_int32, slots, torch.int32),
                  mem(slot_counts, ctypes.c_int32, slots, torch.int32))
        st = mem(stats, ctypes.c_int64, J.N_STATS, torch.int64)
        word = mem(counter, ctypes.c_int32, 1, torch.int32)
        assert int(word[0]) == 0            # zero between calls
        r, s, d, _ = J.runs_launch_model(cols, torch.tensor(n), st, lookup,
                                         size, grid, None, word)
        mem(runs, ctypes.c_int32, cap, torch.int32).copy_(r)
        mem(slot_start, ctypes.c_int32, slots, torch.int32).copy_(s)
        if size:
            mem(dense, ctypes.c_int32, size, torch.int32).copy_(d)
        calls.append(dict(nkeys=nkeys, words=words, cap=cap, slots=slots,
                          size=size, scratch=scratch, stats=stats,
                          counter=counter, stream=stream))
        return 0
    counters = {}
    monkeypatch.setattr(J, "_runs_counter", lambda index: counters.setdefault(
        index, torch.zeros(1, dtype=torch.int32)))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: join_runs)
    monkeypatch.setattr(native, "raw_stream", lambda index: 3)
    return calls


@pytest.mark.parametrize("size", [0, 1 << 14])
@pytest.mark.parametrize("case", ["runs of 31 and 33", "composite keys"])
def test_k5_runs_wrapper_is_one_launch(monkeypatch, case, size):
    """One launch with the key columns' parameter words, the hash table,
    runs_scratch_words of scratch (one allocation), the per-device
    counter (zero before and after) and the outputs as views of one
    allocation (the dense table 16-byte aligned); the runs read through
    (start, count) equal the twin's."""
    cols, nr, stats, lookup, table = runs_setup(case)
    cap = cols[0][0].shape[0]
    calls = runs_kernel_model(monkeypatch)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        (a, k.get("dtype"))) or empty(*a, **{k_: v for k_, v in k.items()
                                              if k_ != "device"}))
    before = J.join_runs_cuda.launches
    (runs, start, count), dense = J.join_runs_cuda(cols, nr, stats, table,
                                                   size)
    assert J.join_runs_cuda.launches == before + 1 and len(calls) == 1
    slots = table[2].numel()
    head = -(-cap // 4) * 4
    assert made == [((head + slots + max(size, 1),), torch.int32),
                    ((J.runs_scratch_words(cap),), torch.int64)]
    c = calls[0]
    assert c["words"] == J._key_table(cols) and c["nkeys"] == len(cols)
    assert (c["cap"], c["slots"], c["size"], c["stream"]) == (cap, slots,
                                                              size, 3)
    assert c["stats"] == stats.data_ptr()
    assert c["counter"] == J._runs_counter(0).data_ptr()
    assert int(J._runs_counter(0)[0]) == 0
    assert start.data_ptr() == runs.data_ptr() + 4 * head
    assert count is table[3]
    assert (dense is None) == (size == 0)
    if size:
        assert dense.data_ptr() == start.data_ptr() + 4 * slots
    (wruns, wstart, wcount), _ = J.join_runs_plain(cols, nr, stats, lookup,
                                                   size)
    got, _ = runs_by_key(runs, start, count, table[1], table[2] >= 0)
    want, _ = runs_by_key(wruns, wstart, wcount, lookup[1],
                          torch.ones_like(wcount, dtype=torch.bool))
    assert got == want


def test_k5_runs_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cols, nr, stats, lookup, table = runs_setup("unique keys")
    with pytest.raises(ValueError, match="CUDA"):
        J.join_runs_cuda(cols, nr, stats, table, 0)
    runs_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="int32"):
        J.join_runs_cuda(cols, nr.to(torch.int64), stats, table, 0)
    with pytest.raises(ValueError, match="stats"):
        J.join_runs_cuda(cols, nr, stats[:4], table, 0)
    with pytest.raises(ValueError, match="hash table"):
        J.join_runs_cuda(cols, nr, stats, lookup, 0)
    with pytest.raises(ValueError, match="does not match"):
        J.join_runs_cuda([(cols[0][0][::2], None)], nr, stats, table, 0)
    with pytest.raises(ValueError, match="table holds"):
        J.join_runs_cuda(cols * 513, nr, stats, table, 0)


def test_k5_runs_counter_is_made_once_per_device(monkeypatch):
    """The counter the runs take their starts from is one zeroed int32 a
    device, made at first use and reused."""
    made = []
    monkeypatch.setattr(J, "_RUNS_COUNTER", {})
    monkeypatch.setattr(torch, "zeros", lambda n, dtype, device: made.append(
        (n, dtype, str(device))) or torch.empty(0))
    assert J._runs_counter(0) is J._runs_counter(0)
    assert J._runs_counter(1) is not J._runs_counter(0)
    assert made == [(1, torch.int32, "cuda:0"), (1, torch.int32, "cuda:1")]


def test_chip_smoke_expands_a_skewed_build():
    """Phase 2's EXPAND_CASES hold a build whose one key has 20,000 rows
    among unique keys of a dense span (so the runs are checked with and
    without the dense table); runs_case makes it."""
    skewed = [c for c in C.EXPAND_CASES if c[0] == "skewed"]
    assert len(skewed) == 1 and C.SKEWED_RUN == 20_000
    _, cap, n, _, _ = skewed[0]
    cols = C.runs_case(torch.Generator().manual_seed(1), "cpu", "skewed",
                       cap, n)
    nr = torch.tensor(n, dtype=torch.int32)
    stats, _ = J.join_build_plain(cols, nr)
    assert int(stats[J.MAX_RUN]) == 20_000
    assert C.dense_size(stats) > 0


# ------------------------------------------------------------ K33 model


def map_inputs(cap, n, ng, dt, lo, hi, seed, L=64):
    """One map-mode call's inputs: K28's group ids of `ng` groups, keys of
    `dt` uniform over [lo, hi) with both ends present (floats: NaN, -0.0,
    +0.0 and both infinities among them), a FILTER-like mask, map_agg
    values."""
    g = torch.Generator().manual_seed(seed)
    return C.map_case(g, "cpu", cap, n, ng, dt, lo, hi) + (L,)


def same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a, b)


def check_map(x, gid, nr, G, masks, x2, L, plan, grid, order, route):
    rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
    for v2 in (None, x2):
        want = LS.collect_map_plain(x, v2, masks, nr, gid, G, L, rows)
        got, taken, _ = LS.map_launch_model(x, v2, masks, nr, gid, G, L,
                                            rows, plan, grid, order)
        assert taken == route
        assert all(same(a, b) for a, b in zip(got, want))


MAP_TYPES = {
    "int8": (torch.int8, -128, 128), "int16": (torch.int16, -300, 300),
    "int32": (torch.int32, -40, 40), "int64": (torch.int64, 10**12,
                                               10**12 + 50),
    "float32": (torch.float32, -6, 6), "float64": (torch.float64, -6, 6)}


@pytest.mark.parametrize("grid,order", [(1, "forward"), (3, "reversed"),
                                        (40, "shuffled")])
@pytest.mark.parametrize("dtype", sorted(MAP_TYPES))
def test_k33_map_model_gives_the_twin(dtype, grid, order):
    """Every key width and kind, histogram and map_agg, bit for bit (a
    zero's sign, NaN as +inf): integers take the direct route (the plan's,
    or the card's choice), floats the sort route."""
    dt, lo, hi = MAP_TYPES[dtype]
    x, gid, nr, G, masks, x2, L = map_inputs(3000, 2900, 37, dt, lo, hi,
                                             seed=len(dtype))
    rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
    plan = LS.map_plan(x, rows)
    route = "sort" if dt.is_floating_point else "direct"
    check_map(x, gid, nr, G, masks, x2, L, plan, grid,
              block_order(order, grid), route)


@pytest.mark.parametrize("grid", [1, 3, 40])
@pytest.mark.parametrize("dtype", ["int16", "int32", "int64"])
def test_k33_sort_route_of_wide_integer_spans(dtype, grid):
    """Integer keys too wide for the direct route sort: one packed word,
    or (int64 over its whole range) the key and the group in two."""
    dt = {"int16": torch.int16, "int32": torch.int32,
          "int64": torch.int64}[dtype]
    lo, hi = {"int16": (-30_000, 30_000), "int32": (-2**31, 2**31 - 1),
              "int64": (-2**63, 2**63 - 1)}[dtype]
    x, gid, nr, G, masks, x2, L = map_inputs(2500, 2400, 11, dt, lo, hi,
                                             seed=grid)
    rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
    plan = LS.map_plan(x, rows)
    assert plan.route == LS.ROUTE_AUTO
    check_map(x, gid, nr, G, masks, x2, L, plan, grid,
              block_order("shuffled", grid), "sort")


@pytest.mark.parametrize("extra,route", [(0, "direct"), (1, "sort")])
def test_k33_route_at_the_tables_edge(extra, route):
    """On the card's choice the direct route holds while G x span fits the
    table (here a table of 64 x 40 entries) and the sort route takes the
    next key past it."""
    x, gid, nr, G, masks, x2, L = map_inputs(4000, 4000, 64, torch.int32,
                                             0, 40 + extra, seed=3)
    assert int(G) == 64
    plan = LS.MapPlan(LS.ROUTE_AUTO, 64 * 40, 1, ((0, 0), (0, 8), (0, 16),
                                                  (0, 24), (0, 32)))
    check_map(x, gid, nr, G, masks, x2, L, plan, 7,
              block_order("reversed", 7), route)


@pytest.mark.parametrize("extra,route", [(0, "direct"), (1, "sort")])
def test_k33_route_at_the_widest_span(extra, route):
    """The direct route takes a span of MAP_DIRECT_SPAN keys, the sort
    route one more."""
    x, gid, nr, G, masks, x2, L = map_inputs(
        12_000, 12_000, 3, torch.int32, 0, LS.MAP_DIRECT_SPAN + extra,
        seed=4, L=8192)
    rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
    plan = LS.map_plan(x, rows)
    check_map(x, gid, nr, G, masks, x2, L, plan, 3, None, route)


def test_k33_first_row_of_a_key_is_not_its_groups_first():
    """map_agg's value is the key's first row's, in row order: group 0's
    rows carry keys 5, 3, 3, 5 with values 10, 20, 30, 40, so key 3 takes
    20 and key 5 takes 10, on both routes."""
    x = torch.tensor([5, 3, 3, 5, 1], dtype=torch.int64)
    gid = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32)
    x2 = torch.tensor([10, 20, 30, 40, 50], dtype=torch.int64)
    nr, G = torch.tensor(5, dtype=torch.int32), torch.tensor(
        2, dtype=torch.int32)
    want = LS.collect_map_plain(x, x2, [], nr, gid, G, 4, 1024)
    assert want[0][0, :2].tolist() == [3, 5]
    assert want[1][0, :2].tolist() == [20, 10]
    for plan, route in ((LS.map_plan(x, 1024), "direct"),
                        (LS.MapPlan(LS.ROUTE_SORT, 0, 2, tuple(
                            (0, 8 * b) for b in range(8)) + ((1, 0),
                                                              (1, 8))),
                         "sort")):
        for grid in (1, 2):
            got, taken, _ = LS.map_launch_model(x, x2, [], nr, gid, G, 4,
                                                1024, plan, grid)
            assert taken == route
            assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("route", [LS.ROUTE_DIRECT, LS.ROUTE_AUTO,
                                   LS.ROUTE_SORT])
def test_k33_empty_page(route):
    """No live row: every list row is zeros with length 0, and K10 sorts
    nothing."""
    x = torch.zeros(64, dtype=torch.int32)
    gid = torch.zeros(64, dtype=torch.int32)
    nr, G = torch.tensor(0, dtype=torch.int32), torch.tensor(
        0, dtype=torch.int32)
    plan = LS.MapPlan(route, 1024 * 7, 1, ((0, 0), (0, 8)))
    got, _, sorted_rows = LS.map_launch_model(x, None, [], nr, gid, G, 1,
                                              1024, plan, 2)
    want = LS.collect_map_plain(x, None, [], nr, gid, G, 1, 1024)
    assert all(same(a, b) for a, b in zip(got, want)) and sorted_rows == 0


@pytest.mark.parametrize("dtype,rows,span,want", [
    (torch.int32, 16_384, 7, (LS.ROUTE_DIRECT, 16_384 * 7, 0, 0)),
    (torch.int32, 1024, 0, (LS.ROUTE_DIRECT, 1024, 0, 0)),
    (torch.int32, 16_384, None, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 6)),
    (torch.int64, 16_384, None, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 2,
                                 10)),
    (torch.int8, 16_384, None, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 3)),
    (torch.int8, 32_768, None, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 3)),
    (torch.int16, 1024, None, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 4)),
    (torch.int32, 1024, 4097, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 6)),
    (torch.int32, 2048, 2048, (LS.ROUTE_DIRECT, 2048 * 2048, 0, 0)),
    (torch.int32, 4096, 2048, (LS.ROUTE_AUTO, LS.MAP_DIRECT_LIMIT, 1, 6)),
    (torch.float32, 16_384, None, (LS.ROUTE_SORT, 0, 1, 6)),
    (torch.float64, 16_384, None, (LS.ROUTE_SORT, 0, 2, 10))])
def test_k33_map_plan(dtype, rows, span, want):
    """The host's plan: the direct route where a dictionary's size bounds
    the span (G x span within MAP_DIRECT_LIMIT), the card's choice for
    other integers (1-byte keys too), the sort route for floats; one word
    when the key's bits and the group's fit 64, else the key's 8 bytes and
    the group's; L3's call (16,384 list rows, 7 codes) takes one launch
    and L4's (int64 part keys) 10 K10 passes where the parent launched
    11."""
    plan = LS.map_plan(torch.zeros(4, dtype=dtype), rows, span)
    assert (plan.route, plan.table, plan.words, len(plan.passes)) == want
    if plan.route == LS.ROUTE_DIRECT:     # the keys' range the host knows
        assert (plan.kmin, plan.span) == (0, max(span, 1))


def test_k33_constants_match_the_kernel():
    text = (CSRC / "list.cu").read_text()
    for name, value in (("MAP_THREADS", LS.MAP_THREADS),
                        ("MAP_MAX_GRID", LS.MAP_MAX_GRID),
                        ("MAP_RUN", LS.MAP_RUN)):
        assert f"constexpr int {name} = {value};" in text
    assert "constexpr int MAP_TILE = MAP_THREADS * MAP_RUN;" in text
    assert LS.MAP_TILE == LS.MAP_THREADS * LS.MAP_RUN
    assert f"constexpr int64_t MAP_DIRECT_SPAN = {LS.MAP_DIRECT_SPAN};" \
        in text
    assert "enum MapRoute { ROUTE_DIRECT = 0, ROUTE_AUTO = 1, " \
        "ROUTE_SORT = 2 };" in text
    body = text[text.index("TT_EXPORT int collect_map("):
                text.index("TT_EXPORT int64_t collect_map_enqueues()")]
    assert body.count("cudaLaunchCooperativeKernel") == 2
    assert body.count("++map_enqueues_;") == 2
    assert "cudaMemsetAsync" not in body and "<<<" not in body


# ------------------------------------------------- K33 through its wrapper


def map_kernel_model(monkeypatch, grid: int = 4):
    """Run collect_map_cuda on CPU tensors: collect_map reads its inputs at
    their pointers and runs the model into the outputs behind theirs
    (writing K10's row count and the route where the card would);
    sort_radix and collect_map_pack record their arguments. Returns the
    calls of each."""
    calls = {"collect_map": [], "sort_radix": [], "collect_map_pack": []}

    def collect_map(x, esz, is_float, x2, esz2, cap, num_rows, masks,
                    nmasks, gid, num_groups, L, rows, route, kmin, span,
                    table, table_cap, words, nw, sort_n, info, partials,
                    keys, aux, lengths, stream):
        dt = {(1, 0): torch.int8, (2, 0): torch.int16, (4, 0): torch.int32,
              (8, 0): torch.int64, (4, 1): torch.float32,
              (8, 1): torch.float64}
        xs = mem(x, ctypes.c_uint8, cap * esz, torch.uint8).view(
            dt[(esz, is_float)])
        vs = None if not x2 else mem(x2, ctypes.c_uint8, cap * esz2,
                                     torch.uint8).view(dt[(esz2, 0)])
        ptrs = list(masks)[:nmasks]     # the host table itself
        mk = [mem(p, ctypes.c_bool, cap, torch.bool) for p in ptrs]
        n = ctypes.c_int32.from_address(num_rows).value
        G = ctypes.c_int32.from_address(num_groups).value
        gd = mem(gid, ctypes.c_int32, cap, torch.int32)
        passes = tuple((0, 8 * b) for b in range(8)) + ((1, 0), (1, 8),
                                                         (1, 16))
        plan = LS.MapPlan(route, table_cap, 2, passes, kmin, span)
        got, taken, sorted_rows = LS.map_launch_model(
            xs, vs, mk, torch.tensor(n), gd, torch.tensor(G), L, rows, plan,
            grid)
        mem(keys, ctypes.c_uint8, rows * L * esz, torch.uint8).copy_(
            got[0].contiguous().view(-1).view(torch.uint8))
        mem(aux, ctypes.c_uint8, rows * L * (esz2 if vs is not None else 8),
            torch.uint8).copy_(got[1].contiguous().view(-1).view(torch.uint8))
        mem(lengths, ctypes.c_int32, rows, torch.int32).copy_(got[2])
        if sort_n:
            ctypes.c_int32.from_address(sort_n).value = sorted_rows
        mem(info, ctypes.c_int64, LS.MAP_INFO_WORDS, torch.int64)[0] = \
            int(taken == "sort")
        calls["collect_map"].append(dict(
            route=route, kmin=kmin, span=span, table_cap=table_cap, nw=nw,
            cap=cap, rows=rows,
            L=L, sort_n=sort_n, words=words, info=info, keys=keys,
            esz2=esz2, stream=stream, taken=taken))
        return 0

    def sort_radix(num_rows, cap, words, npasses, passes, perm, keys_out,
                   *scratch_and_stream):
        table = list(passes)[:2 * npasses]   # words, then shifts
        calls["sort_radix"].append(dict(
            num_rows=num_rows, cap=cap, words=words,
            passes=tuple(zip(table[:npasses], table[npasses:])), perm=perm,
            keys_out=keys_out))
        return 0

    def collect_map_pack(perm, words, cap, sort_n, info, *rest):
        calls["collect_map_pack"].append(dict(perm=perm, words=words,
                                              sort_n=sort_n, info=info))
        return 0
    fns = {"collect_map": collect_map, "sort_radix": sort_radix,
           "collect_map_pack": collect_map_pack}
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: fns[entry])
    monkeypatch.setattr(native, "raw_stream", lambda index: 5)
    return calls


@pytest.mark.parametrize("kind", ["histogram", "map_agg"])
def test_k33_wrapper_on_the_direct_route_is_one_launch(monkeypatch, kind):
    """A dictionary's size as the span: one launch, no K10 and no pack,
    the table rows x span entries, no row count for K10; five
    allocations (the three outputs, one int64 and one int32 scratch); the
    lists equal the twin's."""
    x, gid, nr, G, masks, x2, L = map_inputs(5000, 4800, 300, torch.int32,
                                             0, 7, seed=8)
    v2 = None if kind == "histogram" else x2
    rows = 1024
    calls = map_kernel_model(monkeypatch)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a)
                        or empty(*a, **{k_: v for k_, v in k.items()
                                        if k_ != "device"}))
    before = LS.collect_map_cuda.launches
    got = LS.collect_map_cuda(x, v2, masks, nr, gid, G, L, rows, 7)
    assert LS.collect_map_cuda.launches == before + 1
    assert len(calls["collect_map"]) == 1
    assert not calls["sort_radix"] and not calls["collect_map_pack"]
    c = calls["collect_map"][0]
    assert (c["route"], c["kmin"], c["span"], c["table_cap"], c["sort_n"],
            c["taken"]) == (LS.ROUTE_DIRECT, 0, 7, rows * 7, None, "direct")
    assert made == [((rows, L),), ((rows, L),), (rows,),
                    (LS.MAP_INFO_WORDS + 2 * LS.MAP_MAX_GRID,),
                    (rows * 7 + 1,)]
    want = LS.collect_map_plain(x, v2, masks, nr, gid, G, L, rows)
    assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("span,taken", [(7, 0), (None, 1)])
def test_k33_wrapper_returns_the_cards_route(monkeypatch, span, taken):
    """with_route adds the route the card took, read from the info word
    the prep launch writes (0 direct, 1 sort) without a sync; the lists
    are the same three."""
    x, gid, nr, G, masks, x2, L = map_inputs(3000, 2900, 20, torch.int64,
                                             0 if span else -2**40,
                                             7 if span else 2**40, seed=5)
    map_kernel_model(monkeypatch)
    *got, route = LS.collect_map_cuda(x, x2, masks, nr, gid, G, L, 1024,
                                      span, with_route=True)
    assert route.shape == () and route.dtype == torch.int64
    assert int(route) == taken
    want = LS.collect_map_plain(x, x2, masks, nr, gid, G, L, 1024)
    assert len(got) == 3 and all(same(a, b) for a, b in zip(got, want))


def test_k33_wrapper_on_the_sort_route(monkeypatch):
    """int64 keys with no span bound: collect_map (the card's choice),
    K10 over the words at the row count collect_map writes with the
    plan's passes, and the pack over K10's permutation: three launches,
    the words and row count shared by pointer."""
    x, gid, nr, G, masks, x2, L = map_inputs(3000, 2900, 20, torch.int64,
                                             -2**40, 2**40, seed=9)
    rows = 1024
    calls = map_kernel_model(monkeypatch)
    got = LS.collect_map_cuda(x, x2, masks, nr, gid, G, L, rows)
    plan = LS.map_plan(x, rows)
    (m,), (k,), (p,) = (calls["collect_map"], calls["sort_radix"],
                        calls["collect_map_pack"])
    assert m["route"] == LS.ROUTE_AUTO and m["taken"] == "sort"
    assert m["nw"] == plan.words == 2 and k["passes"] == plan.passes
    assert k["num_rows"] == m["sort_n"] == p["sort_n"]
    assert k["words"] == m["words"] == p["words"] and k["cap"] == 3000
    assert k["perm"] == p["perm"] and k["keys_out"] is None
    assert p["info"] == m["info"]
    want = LS.collect_map_plain(x, x2, masks, nr, gid, G, L, rows)
    assert all(same(a, b) for a, b in zip(got, want))


def test_k33_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    x, gid, nr, G, masks, x2, L = map_inputs(100, 90, 5, torch.int32, 0, 7,
                                             seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        LS.collect_map_cuda(x, None, masks, nr, gid, G, L, 1024)
    map_kernel_model(monkeypatch)
    with pytest.raises(ValueError, match="floats"):
        LS.collect_map_cuda(x.to(torch.float16), None, masks, nr, gid, G,
                            L, 1024)
    with pytest.raises(ValueError, match="L >= 1"):
        LS.collect_map_cuda(x, None, masks, nr, gid, G, 0, 1024)
    with pytest.raises(ValueError, match="masks"):
        LS.collect_map_cuda(x, None, masks * 7, nr, gid, G, L, 1024)
    with pytest.raises(ValueError, match="int32"):
        LS.collect_map_cuda(x, None, masks, nr.to(torch.int64), gid, G, L,
                            1024)
    with pytest.raises(ValueError, match="contiguous"):
        LS.collect_map_cuda(x[::2], None, [], nr, gid[::2], G, L, 1024)


def test_hash_aggregate_passes_the_dictionarys_size(monkeypatch):
    """The aggregation hands K33 its key's dictionary size as the span
    (L3's histogram over l_shipmode: 7 codes) and no bound for an integer
    key."""
    from trino_tpu_torch.exec import LocalQueryRunner
    seen = []
    real = LS.collect_map

    def spy(x, x2, masks, num_rows, gid, num_groups, L, rows, span=None):
        seen.append((x.dtype, span))
        return real(x, x2, masks, num_rows, gid, num_groups, L, rows, span)
    monkeypatch.setattr(LS, "collect_map", spy)
    runner = LocalQueryRunner.tpch("tiny", device="cpu")
    runner.execute("SELECT l_suppkey, histogram(l_shipmode) FROM lineitem "
                   "GROUP BY l_suppkey")
    runner.execute("SELECT l_suppkey, histogram(l_linenumber) FROM lineitem "
                   "GROUP BY l_suppkey")
    assert (torch.int32, 7) in seen
    assert any(span is None for _, span in seen)


# -------------------------------------------------- chip_smoke, launch_trace


def test_chip_smoke_map_cases_take_each_route():
    """MAP_CASES hold the dictionary's direct route, G x span at and past
    the table, the span at and past MAP_DIRECT_SPAN, negative keys, an
    int64 span past 64 bits with the group, 1-byte keys, floats and an
    empty page; the keys' span is the range's."""
    labels = [c[0] for c in C.MAP_CASES]
    assert len(labels) == len(set(labels)) == 10
    g = torch.Generator().manual_seed(0)
    want = {"codes, the span from the dictionary": (LS.ROUTE_DIRECT, 7),
            "G x span at the limit": (LS.ROUTE_AUTO, 2048),
            "G x span past the limit": (LS.ROUTE_AUTO, 2049),
            "span at its widest": (LS.ROUTE_AUTO, 4096),
            "span past its widest": (LS.ROUTE_AUTO, 4097)}
    for label, cap, n, ng, L, dt, lo, hi, span in C.MAP_CASES:
        if label not in want or cap > 300_000:
            continue
        x, gid, nr, G, masks, x2 = C.map_case(g, "cpu", cap, n, ng, dt, lo,
                                              hi)
        rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
        k = LS.map_key(x[:n])[LS._eligible(masks, nr, cap)[:n]]
        assert (LS.map_plan(x, rows, span).route,
                int(k.max()) - int(k.min()) + 1) == want[label]
        if "limit" in label:
            assert int(G) * (int(k.max()) - int(k.min()) + 1) == \
                LS.MAP_DIRECT_LIMIT + (0 if "at" in label else 2048)


MAP_CASE_SORTS = {
    "codes, the span from the dictionary": False,
    "G x span at the limit": False, "G x span past the limit": True,
    "span at its widest": False, "span past its widest": True,
    "negative keys": False, "an int64 span past 64 bits with the group":
    True, "1-byte keys": False, "floats, one word": True,
    "an empty page": False}


@pytest.mark.parametrize("label", sorted(MAP_CASE_SORTS))
def test_chip_smoke_map_sorts(label):
    """map_sorts, which the card's route is held to, calls for the sort
    route exactly where the inputs pass a limit, agreeing with the
    launch model's choice on the page's first 3,000 rows (the same span:
    map_case puts both ends of the range in rows 0 and 1, and the same
    group count)."""
    case = next(c for c in C.MAP_CASES if c[0] == label)
    _, cap, n, ng, L, dt, lo, hi, span = case
    g = torch.Generator().manual_seed(1)
    x, gid, nr, G, masks, x2 = C.map_case(g, "cpu", cap, n, ng, dt, lo, hi)
    rows = max(1024, 1 << max(int(G) - 1, 0).bit_length())
    plan = LS.map_plan(x, rows, span)
    assert C.map_sorts(x, masks, nr, gid, G, plan) is MAP_CASE_SORTS[label]
    if cap > 3000:
        x, gid, masks = x[:3000], gid[:3000], [m[:3000] for m in masks]
        nr = torch.tensor(min(n, 3000), dtype=torch.int32)
    _, taken, _ = LS.map_launch_model(x, None, masks, nr, gid, G, 1, rows,
                                      plan, 3)
    assert (taken == "sort") is C.map_sorts(x, masks, nr, gid, G, plan)


def test_launch_trace_parts_runs_and_map():
    """launch_trace's `runs` part is sf1's largest expanding build's shape
    and q13's build (orders by o_custkey at sf1), and `map` L3's and L4's
    calls."""
    assert {"runs", "map"} <= set(LT.PARTS)
    assert (LT.RUNS_CAP, LT.RUNS_LIVE, LT.RUNS_DENSE) == (
        8_388_608, 3_793_276, 2_097_152)
    assert LT.RUNS_Q13 == (2_097_152, 1_500_000, 150_000)
    assert LT.MAP_L3 == (8_388_608, 5_999_956, 7, 10_000, 1_024, 16_384)
    assert LT.MAP_L4[2:] == (200_000, 10_000, 128, 16_384)


def test_launch_trace_q13_runs_shape(monkeypatch):
    """q13's build draws each o_custkey from the customers whose key is
    not a multiple of 3, as TPC-H does, so the runs average 1.5 x the
    customers' share (15 rows at sf1; here 150 customers, 1,500 orders),
    their rows apart; runs_check holds a call without a dense table to
    the twin (the kernel and the build stood in for by their twins)."""
    monkeypatch.setattr(LT, "RUNS_Q13", (2048, 1500, 150))
    monkeypatch.setattr(J, "join_build_cuda", J.join_build_plain)
    monkeypatch.setattr(J, "join_runs_cuda", J.join_runs_plain)
    args = LT.runs_q13_call("cpu")
    keys = args[0][0][0]
    assert int(args[1]) == 1500 and args[4] == 0
    assert bool((keys[:1500] % 3 != 0).all()) and not keys[1500:].any()
    c = torch.bincount(keys[:1500])
    c = c[c > 0]
    assert c.numel() == 100 and 14 <= float(c.float().mean()) <= 16
    assert LT.runs_check(args) == int(c.max())
