"""Hash aggregation: the direct (dictionary-key), general and global paths.

Port of `trino_tpu/ops/aggregate.py`. Aggregate state is a tuple of
columns (avg = (sum, count)) that PARTIAL, INTERMEDIATE and FINAL steps
produce and merge exactly as the reference does. Three device kernels live
here, each beside its plain PyTorch twin:

* K3 `direct_reduce` (`_direct_aggregate`): GROUP BY over a small static
  key space of dictionary codes, `csrc/direct_agg.cu`;
* K8 `group_reduce` (the sorted path of `hash_aggregate`): GROUP BY on
  any other keys through a global hash table, `csrc/group_agg.cu`; its
  distinct mode `distinct_mask` (`_distinct_first_mask`) marks one
  eligible row per distinct (group keys, argument) pair for a DISTINCT
  aggregate;
* K4 `global_reduce` (`_global_aggregate`): no GROUP BY, a masked
  multi-column reduction to one row, `csrc/global_agg.cu`;
* K19 `passthrough` (passthrough_partial): the adaptive bypass's
  PARTIAL-layout state row per input row, a Triton kernel in this module;
* K28 `group_ids`, K8's group-id mode: one K8 launch that also maps every
  row to its group's output row, for the special aggregates;
* K29 `checksum_contrib` / `hll_pairs`, K30 `centered` / `positional` /
  `hll_fold` and K31 `percentile` (`csrc/special_agg.cu`): checksum's
  hashed contribution, the centered moments, min_by/max_by/arbitrary,
  approx_distinct and approx_percentile;
* K33 (`ops/lists.py`, `csrc/list.cu`): the collecting aggregates'
  packs, array_agg's list and histogram's or map_agg's map per group.

Every state reaches a kernel as a `StateInput`: a value tensor (int64 or
float64), an optional validity and an optional FILTER mask, and a kind
(sum, count, min, max). Rows past `num_rows`, and rows whose validity or
mask is false, contribute the reducer's identity — the reference's
`jnp.where(m, v, ident)` contributions. One definition of that encoding
feeds both the kernels and their twins.

DISTINCT runs in a SINGLE step only (its mask narrows the aggregate's
input), as in the reference, and so do the special aggregates of
SINGLE_STEP_AGGREGATES. checksum is an ordinary two-state aggregate whose
contribution K29 hashes. The collecting aggregates (array_agg, histogram,
map_agg) need a GROUP BY, as in the reference. The operator sizes their
lists itself from K33's size mode (one fetch of the largest group and the
group count): list_len, the largest group's row count rounded up to a
power of two, as the reference's executor sets it (an explicit list_len
overrides it, as the reference's API takes it), and an output of the
next power of two above the group count in rows, where the reference's
has the page's capacity.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.ops import lists
from trino_tpu_torch.ops.sort import radix_sort_words, sort_permutation
from trino_tpu_torch.page import Column, Page, host_table


class Step:
    """Aggregation step (reference: AggregationNode.Step). INTERMEDIATE
    merges partial states and re-emits the PARTIAL layout."""

    SINGLE = "single"
    PARTIAL = "partial"
    INTERMEDIATE = "intermediate"
    FINAL = "final"


SUM, COUNT, MIN, MAX = 0, 1, 2, 3
_KIND_OF = {"sum": SUM, "min": MIN, "max": MAX}


@dataclasses.dataclass(frozen=True)
class StateColumn:
    """One column of aggregate state.

    source: "value" — the input value where eligible (reduced by
            `reducer`); "count" — 1 where eligible; "contrib" — the
            per-row contribution `contrib(values, mask)` over live rows.
    """

    type: T.Type
    reducer: str
    source: str = "value"
    contrib: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class AggregateFunction:
    """Declarative aggregate: state columns + final projection."""

    name: str
    state: Callable[[T.Type], Tuple[StateColumn, ...]]
    final: Optional[Callable]
    output_type: Callable[[Optional[T.Type]], T.Type]


def _sum_state(in_type):
    acc_t = T.DOUBLE if isinstance(in_type, (T.DoubleType, T.RealType)) \
        else T.BIGINT
    if isinstance(in_type, T.DecimalType):
        acc_t = in_type
    return (StateColumn(acc_t, "sum"), StateColumn(T.BIGINT, "sum", "count"))


def _sum_final(state, _):
    total, nnz = state
    return total, nnz > 0


def _count_state(in_type):
    return (StateColumn(T.BIGINT, "sum", "count"),)


def _count_final(state, _):
    return state[0], None


def _minmax_state(in_type, is_min):
    return (StateColumn(in_type, "min" if is_min else "max"),
            StateColumn(T.BIGINT, "sum", "count"))


def _minmax_final(state, _):
    value, nnz = state
    return value, nnz > 0


def _avg_state(in_type):
    sum_t = in_type if isinstance(in_type, T.DecimalType) else T.DOUBLE
    return (StateColumn(sum_t, "sum"), StateColumn(T.BIGINT, "sum", "count"))


def _avg_final_factory(in_type):
    def final(state, _):
        total, nnz = state
        denom = torch.clamp(nnz, min=1)
        if isinstance(in_type, T.DecimalType):
            # decimal avg keeps scale, HALF_UP
            half = torch.div(denom, 2, rounding_mode="trunc")
            adj = torch.where(total >= 0, total + half, total - half)
            value = torch.div(adj, denom, rounding_mode="trunc")
        else:
            value = total.to(torch.float64) / denom
        return value, nnz > 0
    return final


def _count_if_state(in_type):
    # counts rows where the (non-null) argument is true
    return (StateColumn(T.BIGINT, "sum", "count_if"),)


def _bool_state(is_and):
    # AND folds with min over {0,1} (identity 1), OR with max (identity 0)
    ident = 1 if is_and else 0
    return (
        StateColumn(T.BIGINT, "min" if is_and else "max", "contrib",
                    lambda v, m: torch.where(m, v.to(torch.int64), ident)),
        StateColumn(T.BIGINT, "sum", "count"),
    )


def _bool_final(state, _):
    value, nnz = state
    return value > 0, nnz > 0


def _to_double(v, t: Optional[T.Type]):
    out = v.to(torch.float64)
    if isinstance(t, T.DecimalType) and t.scale:
        out = out / (10.0 ** t.scale)
    return out


def _geomean_state_factory(in_type):
    def state(t):
        return (
            StateColumn(T.DOUBLE, "sum", "contrib",
                        lambda v, m: torch.where(
                            m, torch.log(_to_double(v, in_type)), 0.0)),
            StateColumn(T.BIGINT, "sum", "count"),
        )
    return state


def _geomean_final(state, _):
    s, n = state
    return torch.exp(s / torch.clamp(n.to(torch.float64), min=1.0)), n > 0


POSITIONAL_AGGREGATES = frozenset({"min_by", "max_by", "arbitrary"})
CENTERED_AGGREGATES = frozenset({
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
    "corr", "covar_pop", "covar_samp", "regr_slope", "regr_intercept"})
SKETCH_AGGREGATES = frozenset({"approx_distinct", "approx_percentile"})
COLLECT_AGGREGATES = frozenset({"array_agg", "histogram", "map_agg"})
SINGLE_STEP_AGGREGATES = (POSITIONAL_AGGREGATES | CENTERED_AGGREGATES
                          | SKETCH_AGGREGATES | COLLECT_AGGREGATES)
# aggregates this package executes; the rest resolve (the planner needs
# their output types) but raise at execution
SUPPORTED = frozenset({"count", "count_if", "sum", "avg", "min", "max",
                       "bool_and", "bool_or", "geometric_mean", "checksum"}) \
    | CENTERED_AGGREGATES | POSITIONAL_AGGREGATES | SKETCH_AGGREGATES \
    | COLLECT_AGGREGATES
# the single-step aggregates this package executes by their own kernels
SPECIAL_AGGREGATES = SINGLE_STEP_AGGREGATES - COLLECT_AGGREGATES


def get_aggregate(name: str, in_type: Optional[T.Type]) -> AggregateFunction:
    """Resolve an aggregate by name + input type (FunctionRegistry analog).
    For two-argument aggregates `in_type` is a (first, second) tuple."""
    n = name.lower()
    tx, ty = (in_type if isinstance(in_type, tuple) else (in_type, None))
    if n == "count":
        return AggregateFunction("count", _count_state, _count_final,
                                 lambda t: T.BIGINT)
    if n == "count_if":
        return AggregateFunction("count_if", _count_if_state, _count_final,
                                 lambda t: T.BIGINT)
    if n in ("bool_and", "bool_or"):
        return AggregateFunction(
            n, lambda t: _bool_state(n == "bool_and"), _bool_final,
            lambda t: T.BOOLEAN)
    if n == "geometric_mean":
        return AggregateFunction(n, _geomean_state_factory(tx),
                                 _geomean_final, lambda t: T.DOUBLE)
    if n in CENTERED_AGGREGATES:
        return AggregateFunction(n, lambda t: (), None, lambda t: T.DOUBLE)
    if n in POSITIONAL_AGGREGATES:
        return AggregateFunction(n, lambda t: (), None, lambda t: tx)
    if n == "approx_distinct":
        return AggregateFunction(n, lambda t: (), None, lambda t: T.BIGINT)
    if n == "array_agg":
        return AggregateFunction(n, lambda t: (), None,
                                 lambda t: T.ArrayType(element=tx))
    if n == "histogram":
        return AggregateFunction(
            n, lambda t: (), None,
            lambda t: T.MapType(key=tx, value=T.BIGINT))
    if n == "map_agg":
        return AggregateFunction(
            n, lambda t: (), None, lambda t: T.MapType(key=tx, value=ty))
    if n == "approx_percentile":
        return AggregateFunction(n, lambda t: (), None, lambda t: tx)
    if n == "checksum":
        # a wrapping int64 sum of per-value hashes (K29), NULL over zero
        # non-null rows (ChecksumAggregationFunction)
        return AggregateFunction(
            "checksum",
            lambda t: (StateColumn(T.BIGINT, "sum", "contrib",
                                   checksum_contrib),
                       StateColumn(T.BIGINT, "sum", "count")),
            _sum_final, lambda t: T.BIGINT)
    if n == "sum":
        out = in_type if isinstance(in_type, (T.DecimalType, T.DoubleType,
                                              T.RealType)) else T.BIGINT
        if isinstance(in_type, T.RealType):
            out = T.REAL
        return AggregateFunction("sum", _sum_state, _sum_final, lambda t: out)
    if n == "avg":
        if isinstance(in_type, T.DecimalType):
            out = in_type
        elif isinstance(in_type, T.RealType):
            out = T.REAL
        else:
            out = T.DOUBLE
        return AggregateFunction("avg", _avg_state,
                                 _avg_final_factory(in_type), lambda t: out)
    if n == "min":
        return AggregateFunction(
            "min", lambda t: _minmax_state(t, True), _minmax_final,
            lambda t: in_type)
    if n == "max":
        return AggregateFunction(
            "max", lambda t: _minmax_state(t, False), _minmax_final,
            lambda t: in_type)
    raise KeyError(f"unknown aggregate function: {name}")


AGGREGATES = ("count", "sum", "avg", "min", "max", "count_if", "bool_and",
              "bool_or", "variance", "var_samp", "var_pop", "stddev",
              "stddev_samp", "stddev_pop", "geometric_mean", "corr",
              "covar_pop", "covar_samp", "regr_slope", "regr_intercept",
              "min_by", "max_by", "arbitrary")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate call in a plan: fn(input_channel). input None =
    count(*). Two-argument aggregates carry (input2, input2_type)."""

    name: str
    input: Optional[int]
    input_type: Optional[T.Type]
    mask_channel: Optional[int] = None
    distinct: bool = False
    input2: Optional[int] = None
    input2_type: Optional[T.Type] = None


# ------------------------------------------------------- state encoding


@dataclasses.dataclass
class StateInput:
    """One state column as a kernel sees it: contribution of live row i is
    values[i] (kind sum/min/max) or 1 (kind count) where valid[i] and
    mask[i] hold (None = all true), else the reducer's identity."""

    values: Optional[torch.Tensor]   # int64 or float64 [cap]; None for count
    valid: Optional[torch.Tensor]    # bool [cap]
    mask: Optional[torch.Tensor]     # bool [cap]
    kind: int
    is_float: bool


def _wide(v: torch.Tensor) -> torch.Tensor:
    """Values widened to the kernels' 8-byte lanes (exact for every
    integer, bool and float32 input)."""
    if v.dtype in (torch.int64, torch.float64):
        return v.contiguous()
    if v.is_floating_point():
        return v.to(torch.float64)
    return v.to(torch.int64)


def _filter_mask(page: Page, spec: AggSpec) -> Optional[torch.Tensor]:
    """FILTER (WHERE ...) channel folded to one bool mask, or None."""
    if spec.mask_channel is None:
        return None
    fcol = page.column(spec.mask_channel)
    return fcol.values & fcol.valid_mask()


def _partial_inputs(page: Page, spec: AggSpec, states,
                    dmask: Optional[torch.Tensor] = None
                    ) -> List[StateInput]:
    """PARTIAL/SINGLE step: states computed from the aggregate's input.
    A DISTINCT aggregate's `dmask` (its first-row mask, which already holds
    the FILTER) takes the FILTER's place."""
    fmask = _filter_mask(page, spec) if dmask is None else dmask
    if spec.input is not None:
        col = page.column(spec.input)
        vals, valid = col.values, col.valid
    else:   # count(*)
        vals, valid = None, None
    out = []
    for sc in states:
        if sc.source == "count":
            out.append(StateInput(None, valid, fmask, COUNT, False))
        elif sc.source == "count_if":
            m = vals if fmask is None else (vals & fmask)
            out.append(StateInput(None, valid, m, COUNT, False))
        elif sc.source == "contrib":
            m = page.row_mask()
            if valid is not None:
                m = m & valid
            if fmask is not None:
                m = m & fmask
            v = _wide(sc.contrib(vals, m).to(sc.type.dtype))
            out.append(StateInput(v, None, None, _KIND_OF[sc.reducer],
                                  v.is_floating_point()))
        else:
            v = _wide(vals.to(sc.type.dtype))
            out.append(StateInput(v, valid, fmask, _KIND_OF[sc.reducer],
                                  v.is_floating_point()))
    return out


def _merge_inputs(page: Page, states, chans) -> List[StateInput]:
    """FINAL/INTERMEDIATE step: partial state columns merged with each
    state's reducer (dead rows contribute its identity)."""
    out = []
    for sc, ch in zip(states, chans):
        v = _wide(page.column(ch).values)
        out.append(StateInput(v, None, None, _KIND_OF[sc.reducer],
                              v.is_floating_point()))
    return out


_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def ordered_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 with the same order (-0.0 < +0.0; NaN excluded).
    The kernels' `ordered_key` in csrc/common.cuh is the same map."""
    b = x.view(torch.int64)
    return torch.where(b >= 0, b, b ^ _I64_MAX)


def from_ordered_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ _I64_MAX).view(torch.float64)


KEY_POS_INF = 0x7FF0000000000000            # order key of +inf
KEY_NEG_INF = -0x7FF0000000000001           # order key of -inf


def _ident_key(s: "StateInput") -> int:
    """Identity of a min/max state in order-key space."""
    if s.is_float:
        return KEY_POS_INF if s.kind == MIN else KEY_NEG_INF
    return _I64_MAX if s.kind == MIN else _I64_MIN


def _row_contrib(s: StateInput, live: torch.Tensor):
    """(eligible mask, contribution) of one state over every row: sums
    and counts as values, min/max as order keys (NaN flagged apart)."""
    elig = live
    if s.valid is not None:
        elig = elig & s.valid
    if s.mask is not None:
        elig = elig & s.mask
    if s.kind == COUNT:
        return elig, elig.to(torch.int64)
    if s.kind == SUM:
        zero = torch.zeros((), dtype=s.values.dtype, device=live.device)
        return elig, torch.where(elig, s.values, zero)
    key = s.values
    if s.is_float:
        nan = torch.isnan(key)
        key = ordered_key(torch.where(nan, torch.zeros_like(key), key))
        elig = elig & ~nan
    return elig, torch.where(elig, key, _ident_key(s))


def _nan_any(s: StateInput, live: torch.Tensor) -> torch.Tensor:
    """Eligible rows whose float value is NaN."""
    rows = live & torch.isnan(s.values)
    if s.valid is not None:
        rows = rows & s.valid
    if s.mask is not None:
        rows = rows & s.mask
    return rows


def _decode_minmax(s: StateInput, key: torch.Tensor,
                   has_nan: torch.Tensor) -> torch.Tensor:
    if not s.is_float:
        return key
    return torch.where(has_nan, float("nan"), from_ordered_key(key))


# ------------------------------------------------------------------ K3


@dataclasses.dataclass
class KeyInput:
    codes: torch.Tensor            # int32 dictionary codes [cap]
    valid: Optional[torch.Tensor]  # bool [cap]
    size: int                      # dictionary size + 1 (the NULL slot)
    stride: int


def direct_reduce_plain(keys: Sequence[KeyInput], states: Sequence[StateInput],
                        num_rows: torch.Tensor, nseg: int
                        ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                   torch.Tensor]:
    """Plain twin of K3: (compacted slot ids [nseg], compacted state
    arrays [nseg] each, num_groups). Present slots (live count > 0) keep
    slot order; padding is zero."""
    cap = keys[0].codes.shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    slot = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k in keys:
        code = k.codes.to(torch.int64).clamp(0, k.size - 2)
        if k.valid is not None:
            code = torch.where(k.valid, code, k.size - 1)
        slot = slot + code * k.stride
    seg = torch.where(live, slot, nseg)
    cnt = torch.bincount(seg, minlength=nseg + 1)[:nseg]
    present = cnt > 0
    num_groups = present.sum(dtype=torch.int64).to(torch.int32)
    pos = torch.cumsum(present.to(torch.int64), 0) - 1
    where = torch.where(present, pos, nseg)

    def compact(per_slot: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(nseg + 1, dtype=per_slot.dtype, device=dev)
        out[where] = per_slot
        return out[:nseg]

    results = []
    for s in states:
        elig, c = _row_contrib(s, live)
        if s.kind in (SUM, COUNT):
            acc = torch.zeros(nseg + 1, dtype=c.dtype, device=dev)
            acc.index_add_(0, seg, c)
            results.append(compact(acc[:nseg]))
            continue
        ident = c.new_full((nseg + 1,), _ident_key(s))
        red = ident.scatter_reduce(0, seg, c,
                                   "amin" if s.kind == MIN else "amax")
        has_nan = torch.zeros(nseg + 1, dtype=torch.bool, device=dev)
        if s.is_float:
            has_nan[seg[_nan_any(s, live)]] = True
        results.append(compact(_decode_minmax(s, red, has_nan)[:nseg]))
    slots = compact(torch.arange(nseg, dtype=torch.int32, device=dev))
    return slots, results, num_groups


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_states(bools, states: Sequence[StateInput], cap: int,
                  dev) -> None:
    """A grouped kernel's inputs: every mask (key validity included) and
    state column a contiguous [cap] tensor on the device."""
    for b in bools + [b for s in states for b in (s.valid, s.mask)]:
        if b is not None and (b.device != dev or b.dtype != torch.bool
                              or b.shape != (cap,)
                              or not b.is_contiguous()):
            raise ValueError("masks must be contiguous bool [cap] on the "
                             "device")
    for s in states:
        if s.values is not None and (
                s.values.device != dev or s.values.shape != (cap,)
                or s.values.dtype != (torch.float64 if s.is_float
                                      else torch.int64)
                or not s.values.is_contiguous()):
            raise ValueError("state values must be contiguous int64/"
                             "float64 [cap] on the device")


def _state_table(states: Sequence[StateInput]) -> List[int]:
    """The 5-word state entries of a K3/K8 pointer table."""
    return [x for s in states for x in (_ptr(s.values), _ptr(s.valid),
                                        _ptr(s.mask), s.kind,
                                        int(s.is_float))]


def direct_reduce_cuda(keys: Sequence[KeyInput], states: Sequence[StateInput],
                       num_rows: torch.Tensor, nseg: int
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  torch.Tensor]:
    """K3 launch: see csrc/direct_agg.cu."""
    cap = keys[0].codes.shape[0]
    dev = num_rows.device
    if num_rows.dtype != torch.int32 or nseg > _DIRECT_MAX_GROUPS:
        raise ValueError("direct_reduce: int32 num_rows and <= 4096 slots")
    for k in keys:
        if k.codes.device != dev or k.codes.dtype != torch.int32 \
                or k.codes.shape != (cap,) or not k.codes.is_contiguous():
            raise ValueError("key codes must be contiguous int32 [cap] "
                             "on the device")
    _check_states([k.valid for k in keys], states, cap, dev)
    k = len(states)
    table = host_table(
        [x for kk in keys for x in (_ptr(kk.codes), _ptr(kk.valid),
                                    kk.size, kk.stride)],
        _state_table(states))
    acc = torch.empty(nseg * (k + 1), dtype=torch.int64, device=dev)
    nan = torch.empty(max(nseg * k, 1), dtype=torch.int32, device=dev)
    slots = torch.zeros(nseg, dtype=torch.int32, device=dev)
    out = torch.zeros(max(k, 1) * nseg, dtype=torch.int64, device=dev)
    num_groups = torch.empty((), dtype=torch.int32, device=dev)
    lib = native.library("direct_agg")
    rc = lib.direct_aggregate(
        table, ctypes.c_int64(len(keys)),
        ctypes.c_int64(k), ctypes.c_int64(nseg), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()), ctypes.c_void_p(acc.data_ptr()),
        ctypes.c_void_p(nan.data_ptr()), ctypes.c_void_p(slots.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(num_groups.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "direct_aggregate")
    direct_reduce_cuda.launches += 1
    results = []
    for j, s in enumerate(states):
        words = out[j * nseg:(j + 1) * nseg]
        results.append(words.view(torch.float64) if s.is_float else words)
    return slots, results, num_groups


direct_reduce_cuda.launches = 0


def direct_reduce(keys, states, num_rows, nseg):
    """K3 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = direct_reduce_cuda if num_rows.is_cuda else direct_reduce_plain
    return run(keys, states, num_rows, nseg)


# ------------------------------------------------------------------ K8


@dataclasses.dataclass
class GroupKey:
    values: torch.Tensor           # any 1-, 2-, 4- or 8-byte column [cap]
    valid: Optional[torch.Tensor]  # bool [cap]


def _canonical(k: GroupKey) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NULL flag, canonical int64 value) of a group key: NULL -> 0,
    -0.0 -> +0.0, every NaN -> one bit pattern, integers widened; equal
    canonical pairs are one group, as the reference's sort + boundary scan
    groups rows."""
    null = torch.zeros_like(k.values, dtype=torch.bool) if k.valid is None \
        else ~k.valid
    v = k.values
    if v.is_floating_point():
        x = v.to(torch.float64)
        x = torch.where(x == 0, torch.zeros_like(x), x)
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        w = x.view(torch.int64)
    else:
        w = v.to(torch.int64)
    return null, torch.where(null, torch.zeros_like(w), w)


def _lex_groups(cols: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """(each row's group, groups) of the rows of int64 `cols`: groups
    numbered in ascending lexicographic order of the rows, as
    torch.unique(dim=0, return_inverse=True) numbers them (a stable sort
    per column, least significant first, and a boundary scan: faster than
    torch.unique's row sort at millions of rows)."""
    n = cols[0].shape[0]
    dev = cols[0].device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), 0
    perm = torch.arange(n, device=dev)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    start = torch.zeros(n, dtype=torch.bool, device=dev)
    start[0] = True
    for c in cols:
        s = c[perm]
        start[1:] |= s[1:] != s[:-1]
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[perm] = gid
    return inverse, int(gid[-1]) + 1


def group_reduce_plain(keys: Sequence[GroupKey], states: Sequence[StateInput],
                       num_rows: torch.Tensor, cap: int):
    """Plain twin of K8: (key values [cap] per key, key validity [cap] or
    None per key, state arrays [cap] each, num_groups). Groups are the
    distinct canonical keys of the live rows, in sorted canonical order;
    each group's keys come from its first row; rows past num_groups are
    zero."""
    return group_ids_plain(keys, states, num_rows, cap)[:4]


def group_ids_plain(keys: Sequence[GroupKey], states: Sequence[StateInput],
                    num_rows: torch.Tensor, cap: int):
    """Plain twin of K28 (K8's group-id mode): group_reduce_plain's
    outputs and each row's group (int32 [cap]: its output row, in the
    twin's sorted order; num_groups for rows past num_rows) — the inverse
    of torch.unique over the canonical keys."""
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    parts = []
    for k in keys:
        parts += list(_canonical(k))
    inverse, g = _lex_groups([p.to(torch.int64)[live] for p in parts])
    seg = torch.full((cap,), g, dtype=torch.int64, device=dev)
    seg[live] = inverse
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    rep = torch.full((g + 1,), cap, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, seg, rows, "amin")[:g]

    def pad(per_group: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(cap, dtype=per_group.dtype, device=dev)
        out[:g] = per_group[:g]
        return out

    key_values, key_valid = [], []
    for k in keys:
        key_values.append(pad(k.values[rep]))
        key_valid.append(None if k.valid is None else pad(k.valid[rep]))
    results = []
    for s in states:
        elig, c = _row_contrib(s, live)
        if s.kind in (SUM, COUNT):
            acc = torch.zeros(g + 1, dtype=c.dtype, device=dev)
            acc.index_add_(0, seg, c)
            results.append(pad(acc))
            continue
        ident = c.new_full((g + 1,), _ident_key(s))
        red = ident.scatter_reduce(0, seg, c,
                                   "amin" if s.kind == MIN else "amax")
        has_nan = torch.zeros(g + 1, dtype=torch.bool, device=dev)
        if s.is_float:
            has_nan[seg[_nan_any(s, live)]] = True
        results.append(pad(_decode_minmax(s, red, has_nan)))
    return key_values, key_valid, results, \
        torch.tensor(g, dtype=torch.int32, device=dev), seg.to(torch.int32)


def hash_slots(rows: int) -> int:
    """Slots of an open-addressing table (K5, K8): a power of two, at
    least twice the rows, so linear probing always meets an empty slot."""
    s = 1024
    while s < 2 * rows:
        s *= 2
    return s


def _check_group_keys(keys: Sequence[GroupKey], cap: int, dev) -> None:
    for k in keys:
        v = k.values
        if v.device != dev or v.dim() != 1 or v.shape[0] != cap \
                or not v.is_contiguous() \
                or v.element_size() not in (1, 2, 4, 8) \
                or (v.is_floating_point() and v.element_size() not in (4, 8)):
            raise ValueError("group keys must be contiguous [cap] columns "
                             "on the device")


def _group_launch(keys: Sequence[GroupKey], states: Sequence[StateInput],
                  num_rows: torch.Tensor, cap: int, want_gid: bool):
    """One K8 launch (csrc/group_agg.cu group_aggregate); with `want_gid`
    its group-id mode (K28) also fills each row's output row."""
    dev = num_rows.device
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    _check_group_keys(keys, cap, dev)
    _check_states([k.valid for k in keys], states, cap, dev)
    k = len(states)
    slots = hash_slots(cap)
    key_values = [torch.empty(cap, dtype=kk.values.dtype, device=dev)
                  for kk in keys]
    key_valid = [None if kk.valid is None else
                 torch.empty(cap, dtype=torch.bool, device=dev)
                 for kk in keys]

    table = host_table(
        [x for kk, ov, om in zip(keys, key_values, key_valid)
         for x in (_ptr(kk.values), _ptr(kk.valid), kk.values.element_size(),
                   int(kk.values.is_floating_point()), _ptr(ov), _ptr(om))],
        _state_table(states))
    slot_rows = torch.empty(slots, dtype=torch.int32, device=dev)
    acc = torch.empty(slots * max(k, 1), dtype=torch.int64, device=dev)
    nan = torch.empty(slots * max(k, 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(-(-slots // 4096), dtype=torch.int64, device=dev)
    out = torch.empty(max(k, 1) * max(cap, 1), dtype=torch.int64,
                      device=dev)
    num_groups = torch.empty((), dtype=torch.int32, device=dev)
    gid = torch.empty(cap, dtype=torch.int32, device=dev) if want_gid \
        else None
    lib = native.library("group_agg")
    rc = lib.group_aggregate(
        table, ctypes.c_int64(len(keys)), ctypes.c_int64(k),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(slots), ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_void_p(acc.data_ptr()), ctypes.c_void_p(nan.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(cap), ctypes.c_void_p(num_groups.data_ptr()),
        ctypes.c_void_p(_ptr(gid)), ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "group_aggregate")
    results = []
    for j, s in enumerate(states):
        words = out[j * cap:(j + 1) * cap]
        results.append(words.view(torch.float64) if s.is_float else words)
    return key_values, key_valid, results, num_groups, gid


def group_reduce_cuda(keys: Sequence[GroupKey], states: Sequence[StateInput],
                      num_rows: torch.Tensor, cap: int):
    """K8 launch: see csrc/group_agg.cu."""
    out = _group_launch(keys, states, num_rows, cap, False)[:4]
    group_reduce_cuda.launches += 1
    return out


group_reduce_cuda.launches = 0


def group_ids_cuda(keys: Sequence[GroupKey], states: Sequence[StateInput],
                   num_rows: torch.Tensor, cap: int):
    """K28 launch: K8 in its group-id mode (csrc/group_agg.cu gid_kernel)."""
    out = _group_launch(keys, states, num_rows, cap, True)
    group_ids_cuda.launches += 1
    return out


group_ids_cuda.launches = 0


def group_ids(keys, states, num_rows, cap):
    """K28 wrapper: plain twin on the CPU, kernel on CUDA. Returns K8's
    outputs and each row's group (int32 [cap])."""
    run = group_ids_cuda if num_rows.is_cuda else group_ids_plain
    return run(keys, states, num_rows, cap)


def group_reduce(keys, states, num_rows, cap):
    """K8 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = group_reduce_cuda if num_rows.is_cuda else group_reduce_plain
    return run(keys, states, num_rows, cap)


def distinct_mask_plain(keys: Sequence[GroupKey],
                        eligible: torch.Tensor) -> torch.Tensor:
    """Plain twin of K8's distinct mode: bool[cap], true on the first
    eligible row of each distinct canonical key (the reference's sort +
    boundary scan marks a first row too; any one row of a pair serves)."""
    cap = eligible.shape[0]
    dev = eligible.device
    parts = []
    for k in keys:
        parts += list(_canonical(k))
    mark = torch.zeros(cap, dtype=torch.bool, device=dev)
    inverse, g = _lex_groups([p.to(torch.int64)[eligible] for p in parts])
    if not g:
        return mark
    rows = torch.nonzero(eligible).flatten()
    first = torch.full((g,), cap, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, inverse, rows, "amin")
    mark[first] = True
    return mark


def distinct_mask_cuda(keys: Sequence[GroupKey],
                       eligible: torch.Tensor) -> torch.Tensor:
    """K8 distinct-mode launch: see csrc/group_agg.cu group_distinct."""
    cap = eligible.shape[0]
    dev = eligible.device
    if eligible.dtype != torch.bool or eligible.dim() != 1 \
            or not eligible.is_contiguous():
        raise ValueError("eligible must be a contiguous bool [cap] mask")
    _check_group_keys(keys, cap, dev)
    slots = hash_slots(cap)
    slot_rows = torch.empty(slots, dtype=torch.int32, device=dev)
    mark = torch.empty(cap, dtype=torch.bool, device=dev)
    table = host_table([x for kk in keys
                        for x in (_ptr(kk.values), _ptr(kk.valid),
                                  kk.values.element_size(),
                                  int(kk.values.is_floating_point()), 0, 0)])
    lib = native.library("group_agg")
    rc = lib.group_distinct(
        table, ctypes.c_int64(len(keys)), ctypes.c_int64(cap),
        ctypes.c_void_p(eligible.data_ptr()), ctypes.c_int64(slots),
        ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_void_p(mark.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "group_distinct")
    distinct_mask_cuda.launches += 1
    return mark


distinct_mask_cuda.launches = 0


def distinct_mask(keys, eligible):
    """K8 distinct-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = distinct_mask_cuda if eligible.is_cuda else distinct_mask_plain
    return run(keys, eligible)


# ------------------------------------------------------------------ K4

GLOBAL_ROWS = 4096          # rows of capacity per block of K4's grid
GLOBAL_GRID_MAX = 512       # blocks of K4's grid at most
GLOBAL_THREADS = 256        # threads of a K4 block (csrc/global_agg.cu)
STATE_FIELDS = 5            # words of a state descriptor (csrc/common.cuh)
_GLOBAL_SCRATCH: dict = {}  # device index -> (partials, ticket)
_GLOBAL_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)


def global_reduce_plain(states: Sequence[StateInput], num_rows: torch.Tensor,
                        cap: int) -> List[torch.Tensor]:
    """Plain twin of K4: one [1]-shaped result per state."""
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    out = []
    for s in states:
        elig, c = _row_contrib(s, live)
        if s.kind in (SUM, COUNT):
            out.append(c.sum(dtype=c.dtype).reshape(1))
            continue
        red = c.new_full((1,), _ident_key(s))
        if cap:
            red = torch.minimum(red, c.amin()) if s.kind == MIN \
                else torch.maximum(red, c.amax())
        has_nan = torch.zeros(1, dtype=torch.bool, device=dev)
        if s.is_float:
            has_nan = _nan_any(s, live).any().reshape(1)
        out.append(_decode_minmax(s, red, has_nan))
    return out


def global_grid(cap: int) -> int:
    """Blocks of K4's grid: one per GLOBAL_ROWS rows of capacity, at most
    GLOBAL_GRID_MAX. It depends on the capacity alone, so the order in
    which a page's rows are folded never depends on num_rows."""
    return max(1, min(GLOBAL_GRID_MAX, -(-cap // GLOBAL_ROWS)))


def global_descriptors(states: Sequence[StateInput]) -> List[int]:
    """K4's parameter words: per state its values, validity and mask
    pointers (0 = none), kind and float flag (csrc/common.cuh
    STATE_FIELDS)."""
    words: List[int] = []
    for s in states:
        words += (0 if s.values is None else s.values.data_ptr(),
                  0 if s.valid is None else s.valid.data_ptr(),
                  0 if s.mask is None else s.mask.data_ptr(),
                  s.kind, int(s.is_float))
    return words


def global_fold_plain(values: Optional[np.ndarray],
                      valid: Optional[np.ndarray], mask: Optional[np.ndarray],
                      kind: int, is_float: bool, num_rows: int, cap: int
                      ) -> int:
    """NumPy model of K4's fold of one state (csrc/global_agg.cu) in the
    kernel's order with its grid: thread t of block b folds rows b * 256 +
    t + k * 256 * grid (k = 0, 1, ...) below num_rows, each block folds
    its 256 values in the warp-shuffle tree, and the last block folds the
    partials, thread t taking blocks t, t + 256, ..., then the same tree.
    Returns the state's output word (int64; a float state's float64
    bits)."""
    grid = global_grid(cap)
    n = max(0, min(int(num_rows), cap))
    width = grid * GLOBAL_THREADS
    span = -(-n // width) * width
    elig = np.zeros(span, dtype=bool)
    elig[:n] = True
    for m in (valid, mask):
        if m is not None:
            elig[:n] &= m[:n].astype(bool)
    fsum = kind == SUM and is_float
    vals = np.zeros(span, dtype=np.float64 if is_float else np.int64)
    if values is not None:
        vals[:n] = values[:n]
    nan = np.zeros(span, dtype=bool)
    ident = _I64_MAX if kind == MIN else _I64_MIN if kind == MAX else 0
    if is_float and kind in (MIN, MAX):
        ident = KEY_POS_INF if kind == MIN else KEY_NEG_INF
    if kind == COUNT:
        contrib = elig.astype(np.int64)
    elif fsum:
        ident = 0.0
        contrib = np.where(elig, vals, 0.0)
    elif is_float:
        nan = elig & np.isnan(vals)
        bits = vals.view(np.int64)
        keys = np.where(bits >= 0, bits, bits ^ _I64_MAX)
        contrib = np.where(elig & ~nan, keys, ident)
    else:
        contrib = np.where(elig, vals, ident)
    acc = np.full(width, ident, dtype=contrib.dtype)
    for k in range(0, span, width):
        acc = _fold_np(acc, contrib[k:k + width], kind)
    part = _tree_np(acc.reshape(grid, GLOBAL_THREADS), kind, ident)
    lanes = np.full(-(-grid // GLOBAL_THREADS) * GLOBAL_THREADS, ident,
                    dtype=part.dtype)
    lanes[:grid] = part
    acc = np.full(GLOBAL_THREADS, ident, dtype=part.dtype)
    for k in range(0, len(lanes), GLOBAL_THREADS):
        acc = _fold_np(acc, lanes[k:k + GLOBAL_THREADS], kind)
    word = _tree_np(acc.reshape(1, GLOBAL_THREADS), kind, ident)[0]
    if fsum:
        return int(np.float64(word).view(np.int64))
    if is_float and kind in (MIN, MAX):
        if nan.any():
            return 0x7FF8000000000000
        return int(word if word >= 0 else word ^ _I64_MAX)
    return int(word)


def _fold_np(a: np.ndarray, b: np.ndarray, kind: int) -> np.ndarray:
    if kind == MIN:
        return np.minimum(a, b)
    if kind == MAX:
        return np.maximum(a, b)
    with np.errstate(over="ignore", invalid="ignore"):
        return a + b


def _tree_np(vals: np.ndarray, kind: int, ident) -> np.ndarray:
    """Each row's fold in block_fold's order: per warp of 32 lanes,
    shuffles down by 16, 8, 4, 2, 1 (lane l folds lane l + o); then warp
    0 over the warp values, the lanes past them holding the identity."""
    def warp(v):
        for o in (16, 8, 4, 2, 1):
            v = np.concatenate([_fold_np(v[:, :32 - o], v[:, o:], kind),
                                v[:, 32 - o:]], axis=1)
        return v[:, 0]
    rows, threads = vals.shape
    per_warp = warp(vals.reshape(rows * threads // 32, 32))
    lanes = np.full((rows, 32), ident, dtype=vals.dtype)
    lanes[:, :threads // 32] = per_warp.reshape(rows, threads // 32)
    return warp(lanes)


def _global_scratch(index: int, words: int):
    """(partials, ticket) of the device: K4's per-block scratch, grown on
    demand, and its ticket, zero between calls (the last block resets
    it). Calls share them, so they must be ordered on one stream, as
    every launch of the port is (the device's current stream)."""
    part, ticket = _GLOBAL_SCRATCH.get(index, (None, None))
    if part is None or part.numel() < words:
        dev = torch.device("cuda", index)
        part = torch.empty(max(words, 2 * 8 * GLOBAL_GRID_MAX),
                           dtype=torch.int64, device=dev)
        if ticket is None:
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        _GLOBAL_SCRATCH[index] = (part, ticket)
    return part, ticket


def global_reduce_cuda(states: Sequence[StateInput], num_rows: torch.Tensor,
                       cap: int) -> List[torch.Tensor]:
    """K4 launch: see csrc/global_agg.cu. One launch for every state; the
    results are [1]-shaped views of one int64 word per state (float states
    viewed as float64)."""
    index = num_rows.get_device()
    if num_rows.dtype is not torch.int32 or num_rows.dim() != 0 \
            or index < 0:
        raise ValueError("num_rows must be a 0-d int32 CUDA tensor")
    for s in states:
        for b in (s.valid, s.mask):
            if b is not None and (b.dtype is not torch.bool
                                  or b.shape != (cap,)
                                  or b.get_device() != index
                                  or not b.is_contiguous()):
                raise ValueError("masks must be contiguous bool [cap]")
        v = s.values
        if v is None:
            if s.kind != COUNT:
                raise ValueError("only a count state may have no values")
        elif v.dtype is not (torch.float64 if s.is_float else torch.int64) \
                or v.shape != (cap,) or v.get_device() != index \
                or not v.is_contiguous():
            raise ValueError("state values must be contiguous int64/"
                             "float64 [cap]")
    k = len(states)
    if not k:
        return []
    grid = global_grid(cap)
    part, ticket = _global_scratch(index, 2 * k * grid)
    out = torch.empty(k, dtype=torch.int64, device=num_rows.device)
    table = array.array("q", global_descriptors(states))
    rc = native.function("global_agg", "global_reduce", _GLOBAL_ARGS)(
        table.buffer_info()[0], k, num_rows.data_ptr(), cap,
        part.data_ptr(), ticket.data_ptr(), out.data_ptr(), grid,
        native.raw_stream(index))
    native.check(rc, "global_reduce")
    global_reduce_cuda.launches += 1
    ints = out.view(k, 1).unbind(0)
    if not any(s.is_float for s in states):
        return list(ints)
    floats = out.view(torch.float64).view(k, 1).unbind(0)
    return [f if s.is_float else i
            for s, i, f in zip(states, ints, floats)]


global_reduce_cuda.launches = 0


def global_reduce(states, num_rows, cap):
    """K4 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = global_reduce_cuda if num_rows.is_cuda else global_reduce_plain
    return run(states, num_rows, cap)


# ------------------------------------------------------------------ K19

_TRITON_MAX_STATES = 8      # K19's states per Triton launch
_BYPASS_BLOCK = 1024
_BYPASS_KERNEL: dict = {}


def _state_identity(s: StateInput, dtype) -> int:
    """The identity a min/max state holds for a row that contributes
    nothing, in its state dtype (the reference's _ident_for); floats use
    +-inf in the kernel."""
    if dtype == torch.bool:
        return int(s.kind == MIN)
    if dtype.is_floating_point:
        return 0
    info = torch.iinfo(dtype)
    return info.max if s.kind == MIN else info.min


def passthrough_plain(states: Sequence[StateInput], copies: Sequence[bool],
                      num_rows: torch.Tensor, cap: int,
                      dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """Plain twin of K19: per state, every row's own contribution in its
    state dtype — count 1/0, a sum's value or 0, a min/max's value or the
    state's identity (a row past num_rows, NULL or filtered out
    contributes nothing); a `copies` state (a precomputed contribution)
    passes through."""
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    out = []
    for s, copy, dtype in zip(states, copies, dtypes):
        if copy:
            out.append(s.values.to(dtype))
            continue
        elig = live
        if s.valid is not None:
            elig = elig & s.valid
        if s.mask is not None:
            elig = elig & s.mask
        if s.kind == COUNT:
            out.append(elig.to(dtype))
            continue
        if s.kind == SUM:
            ident = torch.zeros((), dtype=s.values.dtype, device=dev)
        elif s.is_float:
            ident = torch.tensor(float("inf") if s.kind == MIN
                                 else float("-inf"), dtype=s.values.dtype,
                                 device=dev)
        else:
            ident = torch.tensor(_state_identity(s, dtype),
                                 dtype=s.values.dtype, device=dev)
        out.append(torch.where(elig, s.values, ident).to(dtype))
    return out


def _bypass_kernel():
    """Build (once per process) K19's Triton program.

    Replaces trino_tpu/ops/aggregate.py passthrough_partial (:916), whose
    per-state `contrib(vals, mask).astype(dtype)` XLA fuses into one
    elementwise pass. Bound on this card: bytes — each state's value,
    validity and FILTER mask read once, its contribution written once.
    One program per 1024-row block writes every state (up to 8 per
    launch): a masked select, no reduction, no cross-row step, stored in
    the state's own dtype."""
    if _BYPASS_KERNEL:
        return _BYPASS_KERNEL["k"]
    import triton
    import triton.language as tl
    globals()["tl"] = tl

    @triton.jit
    def bypass_kernel(num_rows_ptr,
                      v0, v1, v2, v3, v4, v5, v6, v7,
                      a0, a1, a2, a3, a4, a5, a6, a7,
                      m0, m1, m2, m3, m4, m5, m6, m7,
                      o0, o1, o2, o3, o4, o5, o6, o7,
                      i0, i1, i2, i3, i4, i5, i6, i7, cap,
                      K: tl.constexpr, KINDS: tl.constexpr,
                      FLOATS: tl.constexpr, VALIDS: tl.constexpr,
                      MASKS: tl.constexpr, COPIES: tl.constexpr,
                      BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        n = tl.load(num_rows_ptr).to(tl.int64)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        inb = offs < cap
        live = offs < n
        for j in tl.static_range(K):
            if j == 0:
                vp = v0
                ap = a0
                mp = m0
                op = o0
                ident = i0
            elif j == 1:
                vp = v1
                ap = a1
                mp = m1
                op = o1
                ident = i1
            elif j == 2:
                vp = v2
                ap = a2
                mp = m2
                op = o2
                ident = i2
            elif j == 3:
                vp = v3
                ap = a3
                mp = m3
                op = o3
                ident = i3
            elif j == 4:
                vp = v4
                ap = a4
                mp = m4
                op = o4
                ident = i4
            elif j == 5:
                vp = v5
                ap = a5
                mp = m5
                op = o5
                ident = i5
            elif j == 6:
                vp = v6
                ap = a6
                mp = m6
                op = o6
                ident = i6
            else:
                vp = v7
                ap = a7
                mp = m7
                op = o7
                ident = i7
            elig = live
            if (VALIDS >> j) & 1:
                elig = elig & (tl.load(ap + offs, mask=inb, other=0) != 0)
            if (MASKS >> j) & 1:
                elig = elig & (tl.load(mp + offs, mask=inb, other=0) != 0)
            if (COPIES >> j) & 1:
                c = tl.load(vp + offs, mask=inb, other=0)
            elif ((KINDS >> (2 * j)) & 3) == 1:
                c = elig.to(tl.int64)
            elif ((KINDS >> (2 * j)) & 3) == 0:
                c = tl.load(vp + offs, mask=inb & elig, other=0)
            else:
                x = tl.load(vp + offs, mask=inb, other=0)
                if (FLOATS >> j) & 1:
                    if ((KINDS >> (2 * j)) & 3) == 2:
                        c = tl.where(elig, x, float("inf"))
                    else:
                        c = tl.where(elig, x, float("-inf"))
                else:
                    c = tl.where(elig, x, ident)
            tl.store(op + offs, c.to(op.dtype.element_ty), mask=inb)

    _BYPASS_KERNEL["k"] = bypass_kernel
    return bypass_kernel


def passthrough_triton(states: Sequence[StateInput], copies: Sequence[bool],
                       num_rows: torch.Tensor, cap: int,
                       dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """K19 launch (one Triton program per group of up to 8 states)."""
    dev = num_rows.device
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    for s in states:
        for b in (s.valid, s.mask):
            if b is not None and (b.device != dev or b.dtype != torch.bool
                                  or b.shape != (cap,)
                                  or not b.is_contiguous()):
                raise ValueError("masks must be contiguous bool [cap]")
        if s.values is not None and (s.values.device != dev
                                     or s.values.shape != (cap,)
                                     or not s.values.is_contiguous()):
            raise ValueError("state values must be contiguous [cap]")
    kernel = _bypass_kernel()
    dummy_i = torch.empty(1, dtype=torch.int64, device=dev)  # never read
    dummy_b = torch.empty(1, dtype=torch.bool, device=dev)
    outs = [torch.empty(cap, dtype=d, device=dev) for d in dtypes]
    nblocks = max(1, -(-cap // _BYPASS_BLOCK))
    for g in range(0, len(states), _TRITON_MAX_STATES):
        group = list(states[g:g + _TRITON_MAX_STATES])
        gcopy = list(copies[g:g + _TRITON_MAX_STATES])
        gout = outs[g:g + _TRITON_MAX_STATES]
        k = len(group)
        pad = _TRITON_MAX_STATES - k
        vals = [s.values if s.values is not None else dummy_i
                for s in group] + [dummy_i] * pad
        valids = [s.valid if s.valid is not None else dummy_b
                  for s in group] + [dummy_b] * pad
        masks = [s.mask if s.mask is not None else dummy_b
                 for s in group] + [dummy_b] * pad
        idents = [_state_identity(s, o.dtype) for s, o in zip(group, gout)] \
            + [0] * pad
        kinds = sum(s.kind << (2 * j) for j, s in enumerate(group))
        floats = sum(int(s.is_float) << j for j, s in enumerate(group))
        has_v = sum(int(s.valid is not None) << j
                    for j, s in enumerate(group))
        has_m = sum(int(s.mask is not None) << j for j, s in enumerate(group))
        cps = sum(int(c) << j for j, c in enumerate(gcopy))
        kernel[(nblocks,)](
            num_rows, *vals, *valids, *masks, *(gout + [dummy_i] * pad),
            *idents, cap, K=k, KINDS=kinds, FLOATS=floats, VALIDS=has_v,
            MASKS=has_m, COPIES=cps, BLOCK=_BYPASS_BLOCK, num_warps=4)
    passthrough_triton.launches += 1
    return outs


passthrough_triton.launches = 0


def passthrough(states, copies, num_rows, cap, dtypes):
    """K19 wrapper: plain twin on the CPU, Triton kernel on CUDA."""
    run = passthrough_triton if num_rows.is_cuda else passthrough_plain
    return run(states, copies, num_rows, cap, dtypes)


def passthrough_partial(key_channels: Sequence[int],
                        aggs: Sequence[AggSpec]) -> Callable[[Page], Page]:
    """BYPASS-mode partial aggregation ("Partial Partial Aggregates" full
    bypass): ONE PARTIAL-layout state row per INPUT row — the key columns
    pass through, each aggregate's state columns hold that row's
    contribution (K19) — with no grouping. Layout-identical to
    Step.PARTIAL, so bypass pages, partial pages and compacted
    intermediate pages mix in one buffer or spill store; the adaptive
    executor sends pages here when the observed NDV is about the row
    count."""
    key_channels = tuple(key_channels)
    for a in aggs:
        if a.distinct or a.name in SINGLE_STEP_AGGREGATES:
            # as in PARTIAL: these need a whole group in one call
            raise NotImplementedError(f"{a.name}() in bypass partial")
    resolved = [get_aggregate(a.name,
                              a.input_type if a.input2 is None
                              else (a.input_type, a.input2_type))
                for a in aggs]

    def op(page: Page) -> Page:
        per_agg, dicts, flat = _step_inputs(page, aggs, resolved,
                                            Step.PARTIAL, None)
        scs = [sc for states in per_agg for sc in states]
        arrays = passthrough(flat, [sc.source == "contrib" for sc in scs],
                             page.num_rows, page.capacity,
                             [sc.type.dtype for sc in scs])
        out = [page.column(ch) for ch in key_channels]
        it = iter(arrays)
        for states, d in zip(per_agg, dicts):
            for sc in states:
                out.append(Column(next(it), None, sc.type,
                                  d if T.is_string(sc.type) else None))
        return Page(tuple(out), page.num_rows)

    return op


# ------------------------------------------------------------ K29-K31

HLL_P = 11                 # 2^11 registers, as the reference
HLL_M = 1 << HLL_P
_HLL_ALPHA = 0.7213 / (1.0 + 1.079 / float(HLL_M))
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_MAX_MASKS = 6


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words (the uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _hash_input(values: torch.Tensor) -> torch.Tensor:
    """The word the reference's _hash64 mixes, as int64: a float widened
    to float64 with -0.0 made +0.0 (a NaN keeps its bits; a float32 NaN
    widens as the CPU converts it: payload kept, quiet bit set); integers,
    dates, decimals and dictionary codes sign-extended; booleans 0/1."""
    if not values.is_floating_point():
        return values.to(torch.int64)
    if values.dtype == torch.float32:
        u = values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        nan_bits = torch.where((u >> 31) != 0, _I64_MIN, 0) \
            | 0x7FF8000000000000 | ((u & 0x7FFFFF) << 29)
        wide = torch.where(torch.isnan(values), nan_bits,
                           values.to(torch.float64).view(torch.int64))
    else:
        wide = values.view(torch.int64)
    return torch.where(values == 0, 0, wide)


def hash64_plain(values: torch.Tensor) -> torch.Tensor:
    """splitmix64 of each value (trino_tpu/ops/aggregate.py _hash64), as
    int64 words (int64 arithmetic wraps as uint64 does)."""
    x = _hash_input(values) + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _masks_of(masks) -> List[torch.Tensor]:
    return [m for m in masks if m is not None]


def _eligible(masks, num_rows: Optional[torch.Tensor], cap: int,
              dev) -> torch.Tensor:
    """Rows below num_rows (every row when None) passing every mask."""
    elig = torch.ones(cap, dtype=torch.bool, device=dev) if num_rows is None \
        else torch.arange(cap, dtype=torch.int32, device=dev) < num_rows
    for m in _masks_of(masks):
        elig = elig & m
    return elig


def _check_special(cols, masks, cap: int, dev) -> List[int]:
    """A special kernel's inputs: [cap] contiguous columns and bool masks
    on the device; returns the mask pointers."""
    for c in cols:
        if c is not None and (c.device != dev or c.shape != (cap,)
                              or not c.is_contiguous()
                              or c.element_size() not in (1, 2, 4, 8)):
            raise ValueError("special aggregate columns must be contiguous "
                             "[cap] tensors on the device")
    ms = _masks_of(masks)
    if len(ms) > _MAX_MASKS:
        raise ValueError(f"at most {_MAX_MASKS} masks")
    for m in ms:
        if m.device != dev or m.dtype != torch.bool or m.shape != (cap,) \
                or not m.is_contiguous():
            raise ValueError("masks must be contiguous bool [cap] on the "
                             "device")
    return [m.data_ptr() for m in ms]


def _hash_launch(mode: int, values, masks, num_rows, gid, out0, out1):
    cap = values.shape[0]
    dev = values.device
    ptrs = _check_special([values, gid], masks, cap, dev)
    if num_rows is not None and (num_rows.dtype != torch.int32
                                 or num_rows.device != dev):
        raise ValueError("num_rows must be an int32 scalar on the device")
    rc = native.library("special_agg").special_hash(
        ctypes.c_int64(mode), ctypes.c_void_p(values.data_ptr()),
        ctypes.c_int64(values.element_size()),
        ctypes.c_int64(int(values.is_floating_point())), ctypes.c_int64(cap),
        ctypes.c_void_p(_ptr(num_rows)), host_table(ptrs),
        ctypes.c_int64(len(ptrs)), ctypes.c_void_p(_ptr(gid)),
        ctypes.c_void_p(out0.data_ptr()), ctypes.c_void_p(_ptr(out1)),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "special_hash")


def checksum_contrib_plain(values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K29's checksum mode (_checksum_state's contribution):
    the value's hash where `mask`, else 0."""
    return torch.where(mask, hash64_plain(values), 0)


def checksum_contrib_cuda(values: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """K29 launch, checksum mode: see csrc/special_agg.cu."""
    out = torch.empty(values.shape[0], dtype=torch.int64,
                      device=values.device)
    _hash_launch(0, values.contiguous(), [mask.contiguous()], None, None,
                 out, None)
    checksum_contrib_cuda.launches += 1
    return out


checksum_contrib_cuda.launches = 0


def checksum_contrib(values, mask):
    """K29 checksum wrapper: plain twin on the CPU, kernel on CUDA."""
    run = checksum_contrib_cuda if values.is_cuda else checksum_contrib_plain
    return run(values, mask)


def hll_pairs_plain(values: torch.Tensor, masks, num_rows: torch.Tensor,
                    gid: Optional[torch.Tensor]):
    """Plain twin of K29's HLL mode (_hll_register_inputs): per row the
    pair group * 2^11 + bucket (bucket = h >> 53) and rho = 53 -
    floor(log2(h & (2^53 - 1))), 54 for a zero remainder; -1 and 0 for a
    row that does not take part."""
    cap = values.shape[0]
    dev = values.device
    elig = _eligible(masks, num_rows, cap, dev)
    h = hash64_plain(values)
    w = h & ((1 << 53) - 1)
    _, e = torch.frexp(w.to(torch.float64))     # exact: w < 2^53
    rho = torch.where(w > 0, 54 - e.to(torch.int64), 54)
    g = 0 if gid is None else gid.to(torch.int64)
    pair = torch.where(elig, g * HLL_M + _srl(h, 64 - HLL_P), -1)
    return pair, torch.where(elig, rho, 0)


def hll_pairs_cuda(values: torch.Tensor, masks, num_rows: torch.Tensor,
                   gid: Optional[torch.Tensor]):
    """K29 launch, HLL mode: see csrc/special_agg.cu."""
    cap = values.shape[0]
    pair = torch.empty(cap, dtype=torch.int64, device=values.device)
    rho = torch.empty(cap, dtype=torch.int64, device=values.device)
    _hash_launch(1, values.contiguous(), masks, num_rows, gid, pair, rho)
    hll_pairs_cuda.launches += 1
    return pair, rho


hll_pairs_cuda.launches = 0


def hll_pairs(values, masks, num_rows, gid):
    """K29 HLL wrapper: plain twin on the CPU, kernel on CUDA."""
    run = hll_pairs_cuda if values.is_cuda else hll_pairs_plain
    return run(values, masks, num_rows, gid)


def _hll_estimate(sum_present: torch.Tensor,
                  cnt_present: torch.Tensor) -> torch.Tensor:
    """trino_tpu/ops/aggregate.py _hll_estimate: the raw estimator with
    small-range linear counting, rounded half to even."""
    m = float(HLL_M)
    sum_full = sum_present + (m - cnt_present)
    est = _HLL_ALPHA * m * m / torch.clamp(sum_full, min=1e-12)
    zeros = m - cnt_present
    lc = m * torch.log(m / torch.clamp(zeros, min=1.0))
    use_lc = (est <= 2.5 * m) & (zeros > 0)
    return torch.round(torch.where(use_lc, lc, est)).to(torch.int64)


def hll_fold_plain(pairs: torch.Tensor, regs: torch.Tensor,
                   num_pairs: torch.Tensor, num_groups: Optional[torch.Tensor],
                   nseg: int) -> torch.Tensor:
    """Plain twin of K30's HLL mode: over K8's page of (pair, max rho)
    rows, each group's Σ2^-reg (exact: 2^(54 - reg) units of 2^-54 summed
    as two 32-bit halves, joined in one rounding) and present buckets,
    then the estimate (int64 [nseg])."""
    cap = pairs.shape[0]
    dev = pairs.device
    ok = (torch.arange(cap, dtype=torch.int32, device=dev) < num_pairs) \
        & (pairs >= 0) & (regs > 0)
    g = torch.where(ok, pairs >> HLL_P, nseg).clamp(max=nseg)
    t = torch.where(ok, torch.ones_like(regs) << (54 - regs).clamp(0, 53),
                    0)
    hi = torch.zeros(nseg + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, g, t >> 32)
    lo = torch.zeros(nseg + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, g, t & 0xFFFFFFFF)
    cnt = torch.zeros(nseg + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, g, ok.to(torch.int64))
    units = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
    return _hll_estimate(units * 2.0 ** -54, cnt.to(torch.float64))[:nseg]


def hll_fold_cuda(pairs: torch.Tensor, regs: torch.Tensor,
                  num_pairs: torch.Tensor, num_groups: Optional[torch.Tensor],
                  nseg: int) -> torch.Tensor:
    """K30 launch, HLL mode: see csrc/special_agg.cu (the first num_groups
    estimates written)."""
    cap = pairs.shape[0]
    dev = pairs.device
    _check_special([pairs, regs], [], cap, dev)
    if pairs.dtype != torch.int64 or regs.dtype != torch.int64:
        raise ValueError("pairs and registers must be int64")
    if nseg == 0:       # a grouped page of capacity 0
        return torch.zeros(0, dtype=torch.int64, device=dev)
    scratch = torch.empty(3 * nseg, dtype=torch.int64, device=dev)
    out = torch.empty(nseg, dtype=torch.int64, device=dev)
    rc = native.library("special_agg").special_hll(
        ctypes.c_void_p(pairs.data_ptr()), ctypes.c_void_p(regs.data_ptr()),
        ctypes.c_void_p(num_pairs.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(_ptr(num_groups)), ctypes.c_int64(nseg),
        ctypes.c_double(_HLL_ALPHA * HLL_M * HLL_M),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "special_hll")
    hll_fold_cuda.launches += 1
    return out


hll_fold_cuda.launches = 0


def hll_fold(pairs, regs, num_pairs, num_groups, nseg):
    """K30 HLL wrapper: plain twin on the CPU, kernel on CUDA."""
    run = hll_fold_cuda if pairs.is_cuda else hll_fold_plain
    return run(pairs, regs, num_pairs, num_groups, nseg)


# finalize codes of csrc/special_agg.cu CenteredKind
CENTERED_KIND = {"var_pop": 0, "stddev_pop": 1, "variance": 2,
                 "var_samp": 2, "stddev": 3, "stddev_samp": 3,
                 "covar_pop": 4, "covar_samp": 5, "corr": 6,
                 "regr_slope": 7, "regr_intercept": 8}


def _arg_double(v: torch.Tensor, div: Optional[float]) -> torch.Tensor:
    out = v.to(torch.float64)
    return out if div is None else out / div


def _centered_finalize(kind: int, cnt, sa, sb, caa, cbb, cab):
    """trino_tpu/ops/aggregate.py _centered_finalize by kind code; `a` is
    the dependent variable, `b` the independent one."""
    nf = torch.clamp(cnt.to(torch.float64), min=1.0)
    if kind in (0, 1):
        value, valid = caa / nf, cnt > 0
    elif kind in (2, 3):
        value, valid = caa / torch.clamp(nf - 1.0, min=1.0), cnt > 1
    elif kind == 4:
        value, valid = cab / nf, cnt > 0
    elif kind == 5:
        value, valid = cab / torch.clamp(nf - 1.0, min=1.0), cnt > 1
    elif kind == 6:
        denom = torch.sqrt(caa * cbb)
        value = cab / torch.where(denom > 0, denom, 1.0)
        valid = (cnt > 1) & (denom > 0)
    elif kind == 7:
        value = cab / torch.where(cbb > 0, cbb, 1.0)
        valid = (cnt > 0) & (cbb > 0)
    else:
        slope = cab / torch.where(cbb > 0, cbb, 1.0)
        value = sa / nf - slope * sb / nf
        valid = (cnt > 0) & (cbb > 0)
    if kind in (1, 3):
        value = torch.sqrt(torch.clamp(value, min=0.0))
    return value, valid


def centered_plain(kind: int, a: torch.Tensor, a_div: Optional[float],
                   b: Optional[torch.Tensor], b_div: Optional[float], masks,
                   num_rows, gid: Optional[torch.Tensor],
                   num_groups: Optional[torch.Tensor], nseg: int):
    """Plain twin of K30's centered mode (_centered_grouped/_global):
    per group the count, the means, then the centered sums of squares and
    products; (float64 [nseg], valid [nseg])."""
    cap = a.shape[0]
    dev = a.device
    elig = _eligible(masks, num_rows, cap, dev)
    g = torch.zeros(cap, dtype=torch.int64, device=dev) if gid is None \
        else gid.to(torch.int64)
    seg = torch.where(elig, g, nseg)

    def segsum(x):
        return torch.zeros(nseg + 1, dtype=x.dtype, device=dev) \
            .index_add_(0, seg, x)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    cnt = segsum(elig.to(torch.int64))
    nf = torch.clamp(cnt.to(torch.float64), min=1.0)
    av = _arg_double(a, a_div)
    sa = segsum(torch.where(elig, av, zero))
    da = torch.where(elig, av - (sa / nf)[seg], zero)
    caa = segsum(da * da)
    sb = cbb = cab = torch.zeros(nseg + 1, dtype=torch.float64, device=dev)
    if b is not None:
        bv = _arg_double(b, b_div)
        sb = segsum(torch.where(elig, bv, zero))
        db = torch.where(elig, bv - (sb / nf)[seg], zero)
        cbb = segsum(db * db)
        cab = segsum(da * db)
    value, valid = _centered_finalize(kind, cnt, sa, sb, caa, cbb, cab)
    return value[:nseg], valid[:nseg]


def centered_cuda(kind: int, a: torch.Tensor, a_div: Optional[float],
                  b: Optional[torch.Tensor], b_div: Optional[float], masks,
                  num_rows, gid: Optional[torch.Tensor],
                  num_groups: Optional[torch.Tensor], nseg: int):
    """K30 launch, centered mode: see csrc/special_agg.cu."""
    cap = a.shape[0]
    dev = a.device
    ptrs = _check_special([a, b, gid], masks, cap, dev)
    if nseg == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev), \
            torch.zeros(0, dtype=torch.bool, device=dev)
    bb = a if b is None else b
    moments = torch.empty(6 * nseg, dtype=torch.float64, device=dev)
    out = torch.empty(nseg, dtype=torch.float64, device=dev)
    valid = torch.empty(nseg, dtype=torch.bool, device=dev)
    rc = native.library("special_agg").special_centered(
        ctypes.c_int64(kind), ctypes.c_void_p(a.data_ptr()),
        ctypes.c_int64(a.element_size()),
        ctypes.c_int64(int(a.is_floating_point())),
        ctypes.c_double(a_div or 0.0), ctypes.c_void_p(bb.data_ptr()),
        ctypes.c_int64(bb.element_size()),
        ctypes.c_int64(int(bb.is_floating_point())),
        ctypes.c_double(b_div or 0.0), ctypes.c_int64(int(b is not None)),
        ctypes.c_int64(cap), ctypes.c_void_p(_ptr(num_rows)),
        host_table(ptrs), ctypes.c_int64(len(ptrs)),
        ctypes.c_void_p(_ptr(gid)), ctypes.c_void_p(_ptr(num_groups)),
        ctypes.c_int64(nseg), ctypes.c_void_p(moments.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "special_centered")
    centered_cuda.launches += 1
    return out, valid


centered_cuda.launches = 0


def centered(kind, a, a_div, b, b_div, masks, num_rows, gid, num_groups,
             nseg):
    """K30 centered wrapper: plain twin on the CPU, kernel on CUDA."""
    run = centered_cuda if a.is_cuda else centered_plain
    return run(kind, a, a_div, b, b_div, masks, num_rows, gid, num_groups,
               nseg)


ARBITRARY, MIN_BY, MAX_BY = 0, 1, 2
POSITIONAL_KIND = {"arbitrary": ARBITRARY, "min_by": MIN_BY,
                   "max_by": MAX_BY}


def _y_key(y: torch.Tensor) -> torch.Tensor:
    """y as an int64 order key: a float with -0.0 made +0.0 and NaN +inf
    (_nan_as_largest; -0.0 == +0.0 under the reference's `==`), an integer
    as itself."""
    if not y.is_floating_point():
        return y.to(torch.int64)
    x = y.to(torch.float64)
    x = torch.where(torch.isnan(x), float("inf"), x)
    return ordered_key(torch.where(x == 0, 0.0, x))


def positional_plain(kind: int, x: torch.Tensor,
                     x_valid: Optional[torch.Tensor],
                     y: Optional[torch.Tensor], masks, num_rows,
                     gid: Optional[torch.Tensor],
                     num_groups: Optional[torch.Tensor], nseg: int):
    """Plain twin of K30's positional mode (_positional_grouped/_global):
    per group the lowest eligible row at the y-extremum (arbitrary: the
    lowest eligible row), then x there; (x values [nseg], valid [nseg])."""
    cap = x.shape[0]
    dev = x.device
    elig = _eligible(masks, num_rows, cap, dev)
    g = torch.zeros(cap, dtype=torch.int64, device=dev) if gid is None \
        else gid.to(torch.int64)
    seg = torch.where(elig, g, nseg)
    if kind != ARBITRARY:
        key = _y_key(y)
        ident = _I64_MAX if kind == MIN_BY else _I64_MIN
        ext = torch.full((nseg + 1,), ident, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, seg, key,
                            "amin" if kind == MIN_BY else "amax")
        seg = torch.where(elig & (key == ext[seg]), seg, nseg)
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    first = torch.full((nseg + 1,), cap, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, seg, rows, "amin")[:nseg]
    has = first < cap
    idx = first.clamp(max=max(cap - 1, 0))
    if cap == 0:
        return torch.zeros(nseg, dtype=x.dtype, device=dev), has
    out = torch.where(has, x[idx], torch.zeros((), dtype=x.dtype,
                                                device=dev))
    valid = has if x_valid is None else has & x_valid[idx]
    return out, valid


def positional_cuda(kind: int, x: torch.Tensor,
                    x_valid: Optional[torch.Tensor],
                    y: Optional[torch.Tensor], masks, num_rows,
                    gid: Optional[torch.Tensor],
                    num_groups: Optional[torch.Tensor], nseg: int):
    """K30 launch, positional mode: see csrc/special_agg.cu."""
    cap = x.shape[0]
    dev = x.device
    ptrs = _check_special([x, y, gid], masks, cap, dev)
    _check_special([], [x_valid], cap, dev)
    if nseg == 0:
        return torch.zeros(0, dtype=x.dtype, device=dev), \
            torch.zeros(0, dtype=torch.bool, device=dev)
    yy = x if y is None else y
    scratch = torch.empty(2 * nseg, dtype=torch.int64, device=dev)
    out = torch.empty(nseg, dtype=x.dtype, device=dev)
    valid = torch.empty(nseg, dtype=torch.bool, device=dev)
    rc = native.library("special_agg").special_positional(
        ctypes.c_int64(kind), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_int64(x.element_size()), ctypes.c_void_p(_ptr(x_valid)),
        ctypes.c_void_p(yy.data_ptr()), ctypes.c_int64(yy.element_size()),
        ctypes.c_int64(int(yy.is_floating_point())), ctypes.c_int64(cap),
        ctypes.c_void_p(_ptr(num_rows)), host_table(ptrs),
        ctypes.c_int64(len(ptrs)),
        ctypes.c_void_p(_ptr(gid)), ctypes.c_void_p(_ptr(num_groups)),
        ctypes.c_int64(nseg), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "special_positional")
    positional_cuda.launches += 1
    return out, valid


positional_cuda.launches = 0


def positional(kind, x, x_valid, y, masks, num_rows, gid, num_groups, nseg):
    """K30 positional wrapper: plain twin on the CPU, kernel on CUDA."""
    run = positional_cuda if x.is_cuda else positional_plain
    return run(kind, x, x_valid, y, masks, num_rows, gid, num_groups, nseg)


def percentile_words_plain(x: torch.Tensor, masks, num_rows,
                           gid: Optional[torch.Tensor]) -> torch.Tensor:
    """The sort words of K31's first launch, int64 [2, cap] in K10's
    stored form (ops/sort.py radix_sort_words): word 0 the group and a
    not-eligible flag, word 1 the value's order key (NaN as +inf, -0.0 as
    +0.0; 0 for a row that does not take part). Rows past num_rows are
    0."""
    cap = x.shape[0]
    dev = x.device
    elig = _eligible(masks, num_rows, cap, dev)
    live = _eligible([], num_rows, cap, dev)
    g = torch.zeros(cap, dtype=torch.int64, device=dev) if gid is None \
        else gid.to(torch.int64)
    w0 = ((g << 32) | ((~elig).to(torch.int64) << 31)) ^ _I64_MIN
    w1 = torch.where(elig, _y_key(x), 0)
    return torch.stack([torch.where(live, w0, 0), torch.where(live, w1, 0)])


def percentile_pick_plain(perm: torch.Tensor, x: torch.Tensor,
                          p: torch.Tensor, masks, num_rows,
                          gid: Optional[torch.Tensor], nseg: int):
    """K31's pick over the sorted permutation: per group its start, its
    eligible count and p_g (the max of p over its live rows), then the
    original value at start + clip(ceil(p_g * cnt), 1, max(cnt, 1)) - 1;
    (values [nseg], valid = cnt > 0)."""
    cap = x.shape[0]
    dev = x.device
    n = int(torch.clamp(num_rows.to(torch.int64), 0, cap)) \
        if num_rows is not None else cap
    elig = _eligible(masks, num_rows, cap, dev)
    r = perm[:n].to(torch.int64)
    g = torch.zeros(n, dtype=torch.int64, device=dev) if gid is None \
        else gid.to(torch.int64)[r]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    start = torch.full((nseg,), n, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, g, pos, "amin")
    cnt = torch.zeros(nseg, dtype=torch.int64, device=dev) \
        .index_add_(0, g, elig[r].to(torch.int64))
    pg = torch.full((nseg,), float("-inf"), dtype=torch.float64,
                    device=dev).scatter_reduce(
        0, g, p.to(torch.float64)[r], "amax")
    k = torch.clamp(torch.ceil(pg * cnt.to(torch.float64)).to(torch.int32),
                    min=1).to(torch.int64)
    k = torch.minimum(k, torch.clamp(cnt, min=1))
    idx = torch.clamp(start + k - 1, 0, max(cap - 1, 0))
    valid = cnt > 0
    if cap == 0:
        return torch.zeros(nseg, dtype=x.dtype, device=dev), valid
    out = torch.where(valid, x[perm.to(torch.int64)[idx]],
                      torch.zeros((), dtype=x.dtype, device=dev))
    return out, valid


def _percentile_passes(grouped: bool) -> List[Tuple[int, int]]:
    """K10's digit passes over the words, least significant first: word
    1's eight bytes, then word 0's flag byte and (grouped) its group."""
    return [(1, 8 * b) for b in range(8)] + \
        [(0, 8 * b) for b in ((3, 4, 5, 6, 7) if grouped else (3,))]


def percentile_plain(x: torch.Tensor, p: torch.Tensor, masks, num_rows,
                     gid: Optional[torch.Tensor],
                     num_groups: Optional[torch.Tensor], nseg: int):
    """Plain twin of K31 (_percentile_grouped/_global): the words, a
    stable sort of the live prefix (ops/sort.py sort_permutation), the
    pick."""
    cap = x.shape[0]
    n = int(torch.clamp(num_rows.to(torch.int64), 0, cap)) \
        if num_rows is not None else cap
    words = percentile_words_plain(x, masks, num_rows, gid)
    head = sort_permutation([w[:n] for w in words]) if n else \
        torch.zeros(0, dtype=torch.int64, device=x.device)
    perm = torch.cat([head, torch.arange(n, cap, device=x.device)]) \
        .to(torch.int32)
    return percentile_pick_plain(perm, x, p, masks, num_rows, gid, nseg)


def percentile_cuda(x: torch.Tensor, p: torch.Tensor, masks, num_rows,
                    gid: Optional[torch.Tensor],
                    num_groups: Optional[torch.Tensor], nseg: int):
    """K31 launch: the words launch, K10's radix passes over the live
    prefix (ops/sort.py radix_sort_words), the pick launch; see
    csrc/special_agg.cu."""
    cap = x.shape[0]
    dev = x.device
    ptrs = _check_special([x, p, gid], masks, cap, dev)
    if num_rows is None or num_rows.dtype != torch.int32:
        raise ValueError("num_rows must be an int32 scalar on the device")
    if cap == 0:
        return torch.zeros(nseg, dtype=x.dtype, device=dev), \
            torch.zeros(nseg, dtype=torch.bool, device=dev)
    out = torch.empty(nseg, dtype=x.dtype, device=dev)
    valid = torch.empty(nseg, dtype=torch.bool, device=dev)
    lib = native.library("special_agg")
    words = torch.empty((2, cap), dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(native.stream_ptr(dev))
    rc = lib.special_percentile_words(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_int64(x.element_size()),
        ctypes.c_int64(int(x.is_floating_point())), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()), host_table(ptrs),
        ctypes.c_int64(len(ptrs)), ctypes.c_void_p(_ptr(gid)),
        ctypes.c_void_p(words.data_ptr()), stream)
    native.check(rc, "special_percentile_words")
    perm = radix_sort_words(words, num_rows,
                            _percentile_passes(gid is not None))
    scratch = torch.empty(3 * nseg, dtype=torch.int64, device=dev)
    rc = lib.special_percentile_pick(
        ctypes.c_void_p(perm.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()), host_table(ptrs),
        ctypes.c_int64(len(ptrs)), ctypes.c_void_p(_ptr(gid)),
        ctypes.c_void_p(_ptr(num_groups)),
        ctypes.c_void_p(p.data_ptr()), ctypes.c_int64(p.element_size()),
        ctypes.c_int64(int(p.is_floating_point())),
        ctypes.c_void_p(x.data_ptr()), ctypes.c_int64(x.element_size()),
        ctypes.c_int64(nseg), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        stream)
    native.check(rc, "special_percentile_pick")
    percentile_cuda.launches += 1
    return out, valid


percentile_cuda.launches = 0


def percentile(x, p, masks, num_rows, gid, num_groups, nseg):
    """K31 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = percentile_cuda if x.is_cuda else percentile_plain
    return run(x, p, masks, num_rows, gid, num_groups, nseg)


def _spec_masks(page: Page, spec: AggSpec, *cols) -> List[torch.Tensor]:
    """The masks of a special aggregate's rows: the listed columns'
    validity and the FILTER (its values and validity)."""
    out = [page.column(ch).valid for ch in cols]
    if spec.mask_channel is not None:
        fcol = page.column(spec.mask_channel)
        out += [fcol.values, fcol.valid]
    return [m.contiguous() for m in out if m is not None]


def _decimal_div(t: Optional[T.Type]) -> Optional[float]:
    if isinstance(t, T.DecimalType) and t.scale:
        return 10.0 ** t.scale
    return None


def _special_column(page: Page, spec: AggSpec, gid, num_groups, nseg: int,
                    dmask: Optional[torch.Tensor]) -> Column:
    """One special aggregate's output column over the page's rows, by
    group (`gid` from K28, or None: one global group)."""
    xcol = page.column(spec.input)
    x = xcol.values.contiguous()
    nr = page.num_rows
    if spec.name in CENTERED_AGGREGATES:
        b = None
        cols = (spec.input,)
        if spec.input2 is not None:
            b = page.column(spec.input2).values.contiguous()
            cols = (spec.input, spec.input2)
        masks = _spec_masks(page, spec, *cols)
        if dmask is not None:
            masks.append(dmask)
        value, valid = centered(
            CENTERED_KIND[spec.name], x, _decimal_div(spec.input_type), b,
            _decimal_div(spec.input2_type), masks, nr, gid, num_groups, nseg)
        return Column(value, valid, T.DOUBLE, None)
    if spec.name in POSITIONAL_AGGREGATES:
        kind = POSITIONAL_KIND[spec.name]
        y = None
        if kind == ARBITRARY:
            masks = _spec_masks(page, spec, spec.input)
        else:
            y = page.column(spec.input2).values.contiguous()
            masks = _spec_masks(page, spec, spec.input2)
        values, valid = positional(kind, x, xcol.valid, y, masks, nr, gid,
                                   num_groups, nseg)
        return Column(values, valid, xcol.type, xcol.dictionary)
    masks = _spec_masks(page, spec, spec.input)
    if spec.name == "approx_percentile":
        p = page.column(spec.input2).values.contiguous()
        values, valid = percentile(x, p, masks, nr, gid, num_groups, nseg)
        return Column(values, valid, xcol.type, xcol.dictionary)
    # approx_distinct: K29's (group, bucket) pairs, K8 grouped on the pair
    # with MAX(rho), K30's fold
    pair, rho = hll_pairs(x, masks, nr, gid)
    kv, _, regs, num_pairs = group_reduce(
        [GroupKey(pair, None)], [StateInput(rho, None, None, MAX, False)],
        nr, page.capacity)
    return Column(hll_fold(kv[0], regs[0], num_pairs, num_groups, nseg),
                  None, T.BIGINT, None)


# ------------------------------------------------------- hash_aggregate


def _unsupported(spec: AggSpec) -> Optional[str]:
    if spec.name not in SUPPORTED:
        return f"{spec.name}() is not an aggregate this package runs"
    return None


def _list_sizes(page: Page, gid, num_groups,
                list_len: Optional[int]) -> Tuple[int, int]:
    """The collecting aggregates' (L, rows) from K33's size mode, one
    fetch (reference: group_max_size and its executor's pre-pass): L the
    smallest power of two at least the largest group (at least 1) unless
    list_len is given; rows the next power of two above the group count
    (at least 1024, at most the page's capacity)."""
    largest, groups = lists.collect_sizes(gid, page.num_rows,
                                          num_groups).tolist()
    L = int(list_len) if list_len is not None else \
        1 << (max(largest, 1) - 1).bit_length()
    rows = max(1024, 1 << (max(groups, 1) - 1).bit_length())
    return L, max(1, min(rows, page.capacity))


def _collect_column(page: Page, spec: AggSpec, fn, gid, num_groups, L: int,
                    rows: int) -> Column:
    """One collecting aggregate's list column by group (K33; reference:
    _collect_grouped): NULL inputs, a NULL second argument and FILTER
    skip a row; DISTINCT does not narrow it (the reference's _accumulate
    never applies the mask to a collect aggregate)."""
    out_type = fn.output_type(None)
    xcol = page.column(spec.input)
    x = xcol.values.contiguous()
    nr = page.num_rows
    if spec.name == "array_agg":
        masks = _spec_masks(page, spec, spec.input)
        plane, lengths = lists.collect_array(x, masks, nr, gid, num_groups,
                                             L, rows)
        return Column(plane, None, out_type, xcol.dictionary, lengths)
    x2 = aux_dict = None
    cols = (spec.input,)
    if spec.name == "map_agg":
        col2 = page.column(spec.input2)
        x2, aux_dict, cols = col2.values.contiguous(), col2.dictionary, \
            (spec.input, spec.input2)
    keys, vals, lengths = lists.collect_map(
        x, x2, _spec_masks(page, spec, *cols), nr, gid, num_groups, L, rows)
    return Column(keys, None, out_type, xcol.dictionary, lengths, vals,
                  aux_dict)


def _refuse(aggs: Sequence[AggSpec], step: str) -> None:
    """What the reference's hash_aggregate refuses, with its text
    (trino_tpu/ops/aggregate.py :535-557); then what this package cannot
    run yet."""
    for a in aggs:
        if a.distinct and (a.name in POSITIONAL_AGGREGATES
                           or (a.name in CENTERED_AGGREGATES
                               and a.input2 is not None)):
            # DISTINCT over a row pair has no single-column first mask
            raise NotImplementedError(f"{a.name}(DISTINCT ...)")
    if step != Step.SINGLE:
        for a in aggs:
            if a.distinct:
                # distinctness is decidable only once a group's rows are
                # together: the optimizer keeps DISTINCT single-step
                raise NotImplementedError(
                    f"{a.name}(DISTINCT ...) in {step} step")
            if a.name in SINGLE_STEP_AGGREGATES:
                raise NotImplementedError(f"{a.name}() in {step} step")
    for a in aggs:
        reason = _unsupported(a)
        if reason is not None:
            raise NotImplementedError(reason)


def hash_aggregate(
    key_channels: Sequence[int],
    aggs: Sequence[AggSpec],
    step: str = Step.SINGLE,
    partial_state_channels: Optional[Sequence[Sequence[int]]] = None,
    list_len: Optional[int] = None,
) -> Callable[[Page], Page]:
    """Build a group-by aggregation operator. Output layout: [key
    columns..., per-agg output columns...]; PARTIAL and INTERMEDIATE
    emit the raw state columns that FINAL consumes through
    partial_state_channels (agg -> its state channels). A collecting
    aggregate's lists hold up to `list_len` elements, by default the
    largest group's row count rounded up to a power of two."""
    key_channels = tuple(key_channels)
    _refuse(aggs, step)
    resolved = [get_aggregate(a.name,
                              a.input_type if a.input2 is None
                              else (a.input_type, a.input2_type))
                for a in aggs]
    has_collect = any(a.name in COLLECT_AGGREGATES for a in aggs)

    def op(page: Page) -> Page:
        if any(page.column(ch).is_list for ch in key_channels):
            # the reference's sort refuses a [cap, L] key operand too
            raise NotImplementedError(
                "GROUP BY over a list column (ARRAY/MAP): ROADMAP B item 6 "
                "(B13)")
        if not key_channels:
            if has_collect:
                raise NotImplementedError(
                    "global array_agg/histogram/map_agg (no GROUP BY)")
            return _global_aggregate(page, aggs, resolved, step,
                                     partial_state_channels)
        sizes = _direct_key_sizes(page, key_channels, aggs)
        if sizes is None:
            return _group_aggregate(page, key_channels, aggs, resolved, step,
                                    partial_state_channels, list_len)
        return _direct_aggregate(page, key_channels, aggs, resolved, step,
                                 partial_state_channels, sizes)

    return op


_DIRECT_MAX_GROUPS = 4096


def _direct_key_sizes(page: Page, key_channels, aggs):
    """Per-key code-space sizes when every group key is dictionary-encoded
    and the combined key space is at most 4096 slots, else None. A special
    aggregate takes the general path (K8 with K28's group ids), as the
    reference's refuses the direct path for it (and for a collecting
    aggregate)."""
    if any(a.name in SINGLE_STEP_AGGREGATES for a in aggs):
        return None
    sizes = []
    total = 1
    for ch in key_channels:
        col = page.column(ch)
        if col.dictionary is None:
            return None
        sizes.append(len(col.dictionary) + 1)   # +1: the NULL slot
        total *= sizes[-1]
    if total > _DIRECT_MAX_GROUPS:
        return None
    return tuple(sizes)


def _distinct_first_mask(page: Page, key_channels: Sequence[int],
                         spec: AggSpec) -> torch.Tensor:
    """One eligible row per distinct (group keys, argument) pair (K8
    distinct mode): eligible = live, a non-NULL argument and the FILTER,
    so distinctness is decided over exactly the rows the aggregate sees."""
    col = page.column(spec.input)
    eligible = page.row_mask() & col.valid_mask()
    fmask = _filter_mask(page, spec)
    if fmask is not None:
        eligible = eligible & fmask
    keys = [GroupKey(page.column(ch).values.contiguous(),
                     page.column(ch).valid)
            for ch in tuple(key_channels) + (spec.input,)]
    return distinct_mask(keys, eligible.contiguous())


def _dmask(page: Page, key_channels, spec: AggSpec, dmasks: dict):
    """A DISTINCT aggregate's first-row mask; aggregates over one argument
    and FILTER share it."""
    key = (spec.input, spec.mask_channel)
    if key not in dmasks:
        dmasks[key] = _distinct_first_mask(page, key_channels, spec)
    return dmasks[key]


def _step_inputs(page, aggs, resolved, step, partial_state_channels,
                 key_channels=(), dmasks=None):
    """(per-agg states, per-agg dictionary, flat StateInput list)."""
    per_agg, dicts, flat = [], [], []
    dmasks = {} if dmasks is None else dmasks
    for ai, (spec, fn) in enumerate(zip(aggs, resolved)):
        states = fn.state(spec.input_type)
        if step in (Step.FINAL, Step.INTERMEDIATE):
            chans = partial_state_channels[ai]
            dicts.append(page.column(chans[0]).dictionary)
            flat.extend(_merge_inputs(page, states, chans))
        else:
            dicts.append(None if spec.input is None
                         else page.column(spec.input).dictionary)
            dmask = None
            if spec.distinct:
                dmask = _dmask(page, key_channels, spec, dmasks)
            flat.extend(_partial_inputs(page, spec, states, dmask))
        per_agg.append(states)
    return per_agg, dicts, flat


def _narrow(arr: torch.Tensor, dtype) -> torch.Tensor:
    """A reduced 8-byte lane back in its state dtype. Min/max identities
    were taken at int64 width; clamping maps them to the narrow type's
    identity (its max/min, or True/False), as the reference computes
    them in that type. Real values are in range and unchanged."""
    if arr.dtype == dtype or arr.is_floating_point():
        return arr.to(dtype)
    if dtype == torch.bool:
        return arr.clamp(0, 1).to(dtype)
    if dtype.is_floating_point:
        return arr.to(dtype)
    info = torch.iinfo(dtype)
    return arr.clamp(info.min, info.max).to(dtype)


def _emit(aggs, resolved, step, per_agg, dicts, arrays, n_out,
          valid_where, special=None) -> List[Column]:
    """Aggregate output columns from the reduced state arrays; `special`
    holds the special aggregates' columns by aggregate index."""
    out: List[Column] = []
    it = iter(arrays)
    for ai, (spec, fn, states, d) in enumerate(zip(aggs, resolved, per_agg,
                                                   dicts)):
        if special and ai in special:
            out.append(special[ai])
            continue
        arrs = [next(it) for _ in states]
        if step in (Step.PARTIAL, Step.INTERMEDIATE):
            for sc, arr in zip(states, arrs):
                sd = d if T.is_string(sc.type) else None
                out.append(Column(_narrow(arr, sc.type.dtype), None, sc.type,
                                  sd))
            continue
        states_typed = [_narrow(a, sc.type.dtype)
                        for sc, a in zip(states, arrs)]
        values, valid = fn.final(states_typed, None)
        out_t = fn.output_type(spec.input_type)
        out.append(Column(values.to(out_t.dtype),
                          None if valid is None else valid_where(valid),
                          out_t, d if T.is_string(out_t) else None))
    return out


def _direct_aggregate(page: Page, key_channels, aggs, resolved, step,
                      partial_state_channels, sizes) -> Page:
    """Group-by over a small static key space without sorting: the slot
    of a row is the mixed-radix combination of its key codes (K3)."""
    nseg = 1
    for s in sizes:
        nseg *= s
    keys, strides = [], []
    stride = nseg
    for ch, size in zip(key_channels, sizes):
        stride //= size
        strides.append(stride)
        col = page.column(ch)
        codes = col.values if col.values.dtype == torch.int32 \
            else col.values.to(torch.int32)
        keys.append(KeyInput(codes.contiguous(), col.valid, size, stride))
    per_agg, dicts, flat = _step_inputs(page, aggs, resolved, step,
                                        partial_state_channels, key_channels)
    slots, arrays, num_groups = direct_reduce(keys, flat, page.num_rows, nseg)
    out_cols: List[Column] = []
    slot64 = slots.to(torch.int64)
    for ch, size, stride in zip(key_channels, sizes, strides):
        col = page.column(ch)
        code = torch.div(slot64, stride, rounding_mode="trunc") % size
        valid = None if col.valid is None else (code != size - 1)
        out_cols.append(Column(code.to(col.values.dtype), valid, col.type,
                               col.dictionary))
    out_cols.extend(_emit(aggs, resolved, step, per_agg, dicts, arrays,
                          nseg, lambda v: v))
    return Page(tuple(out_cols), num_groups)


def _group_aggregate(page: Page, key_channels, aggs, resolved, step,
                     partial_state_channels, list_len=None) -> Page:
    """GROUP BY on keys the direct path does not take (K8). The output
    keeps the input's capacity (#groups <= #rows), as the reference's
    sorted path does, or the collecting aggregates' rows (_list_sizes);
    groups come out in the kernel's slot order."""
    keys = [GroupKey(page.column(ch).values.contiguous(),
                     page.column(ch).valid) for ch in key_channels]
    dmasks: dict = {}
    per_agg, dicts, flat = _step_inputs(page, aggs, resolved, step,
                                        partial_state_channels, key_channels,
                                        dmasks)
    special = {}
    rows = page.capacity
    if any(a.name in SINGLE_STEP_AGGREGATES for a in aggs):
        # K28: the same K8 launch also maps each row to its output row
        key_values, key_valid, arrays, num_groups, gid = group_ids(
            keys, flat, page.num_rows, page.capacity)
        special = _special_columns(page, key_channels, aggs, gid,
                                   num_groups, page.capacity, dmasks)
        if any(a.name in COLLECT_AGGREGATES for a in aggs):
            L, rows = _list_sizes(page, gid, num_groups, list_len)
        for ai, (spec, fn) in enumerate(zip(aggs, resolved)):
            if spec.name in COLLECT_AGGREGATES:
                special[ai] = _collect_column(page, spec, fn, gid,
                                              num_groups, L, rows)
    else:
        key_values, key_valid, arrays, num_groups = group_reduce(
            keys, flat, page.num_rows, page.capacity)
    out_cols: List[Column] = []
    for ch, values, valid in zip(key_channels, key_values, key_valid):
        col = page.column(ch)
        out_cols.append(Column(values, valid, col.type, col.dictionary))
    out_cols.extend(_emit(aggs, resolved, step, per_agg, dicts, arrays,
                          page.capacity, lambda v: v, special))
    return Page(tuple(out_cols), num_groups).shrink_to(rows)


def _special_columns(page, key_channels, aggs, gid, num_groups, nseg,
                     dmasks) -> dict:
    """Each special aggregate's column by aggregate index (DISTINCT over a
    centered aggregate narrows it with K8's distinct mode)."""
    out = {}
    for ai, spec in enumerate(aggs):
        if spec.name in SPECIAL_AGGREGATES:
            dmask = _dmask(page, key_channels, spec, dmasks) \
                if spec.distinct else None
            out[ai] = _special_column(page, spec, gid, num_groups, nseg,
                                      dmask)
    return out


def _global_aggregate(page, aggs, resolved, step, partial_state_channels):
    """No GROUP BY: one output row (reference: AggregationOperator.java)
    reduced by K4. INTERMEDIATE merges partial states like FINAL and
    re-emits the PARTIAL layout."""
    dmasks: dict = {}
    per_agg, dicts, flat = _step_inputs(page, aggs, resolved, step,
                                        partial_state_channels, (), dmasks)
    arrays = global_reduce(flat, page.num_rows, page.capacity)
    special = _special_columns(page, (), aggs, None, None, 1, dmasks)
    out_cols = _emit(aggs, resolved, step, per_agg, dicts, arrays, 1,
                     lambda v: v.reshape(1), special)
    return Page(tuple(out_cols), 1)
