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
  multi-column reduction to one row, a Triton kernel in this module.

Every state reaches a kernel as a `StateInput`: a value tensor (int64 or
float64), an optional validity and an optional FILTER mask, and a kind
(sum, count, min, max). Rows past `num_rows`, and rows whose validity or
mask is false, contribute the reducer's identity — the reference's
`jnp.where(m, v, ident)` contributions. One definition of that encoding
feeds both the kernels and their twins.

DISTINCT runs in a SINGLE step only (its mask narrows the aggregate's
input), as in the reference. The special aggregates (approx_distinct,
approx_percentile, checksum, the centered moments, the positional and
collecting aggregates) raise NotImplementedError naming ROADMAP B8.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
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
                       "bool_and", "bool_or", "geometric_mean"})


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
        # the reference's checksum state is a 64-bit hash sum (ROADMAP
        # B8); output type only until that kernel is ported
        return AggregateFunction(
            "checksum",
            lambda t: (StateColumn(T.BIGINT, "sum", "contrib"),
                       StateColumn(T.BIGINT, "sum", "count")),
            None, lambda t: T.BIGINT)
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


def group_reduce_plain(keys: Sequence[GroupKey], states: Sequence[StateInput],
                       num_rows: torch.Tensor, cap: int):
    """Plain twin of K8: (key values [cap] per key, key validity [cap] or
    None per key, state arrays [cap] each, num_groups). Groups are the
    distinct canonical keys of the live rows, in sorted canonical order;
    each group's keys come from its first row; rows past num_groups are
    zero."""
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    parts = []
    for k in keys:
        parts += list(_canonical(k))
    canon = torch.stack([p.to(torch.int64) for p in parts], 1)[live]
    if canon.shape[0]:
        uniq, inverse = torch.unique(canon, dim=0, return_inverse=True)
    else:
        uniq = canon
        inverse = torch.zeros(0, dtype=torch.int64, device=dev)
    g = uniq.shape[0]
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
        torch.tensor(g, dtype=torch.int32, device=dev)


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


def group_reduce_cuda(keys: Sequence[GroupKey], states: Sequence[StateInput],
                      num_rows: torch.Tensor, cap: int):
    """K8 launch: see csrc/group_agg.cu."""
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
    lib = native.library("group_agg")
    rc = lib.group_aggregate(
        table, ctypes.c_int64(len(keys)), ctypes.c_int64(k),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(slots), ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_void_p(acc.data_ptr()), ctypes.c_void_p(nan.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(cap), ctypes.c_void_p(num_groups.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "group_aggregate")
    group_reduce_cuda.launches += 1
    results = []
    for j, s in enumerate(states):
        words = out[j * cap:(j + 1) * cap]
        results.append(words.view(torch.float64) if s.is_float else words)
    return key_values, key_valid, results, num_groups


group_reduce_cuda.launches = 0


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
    canon = torch.stack([p.to(torch.int64) for p in parts], 1)[eligible]
    mark = torch.zeros(cap, dtype=torch.bool, device=dev)
    if not canon.shape[0]:
        return mark
    _, inverse = torch.unique(canon, dim=0, return_inverse=True)
    rows = torch.nonzero(eligible).flatten()
    g = int(inverse.max()) + 1
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

_TRITON_MAX_STATES = 8
_GLOBAL_BLOCK = 4096
_REDUCE_BLOCK = 1024
_GLOBAL_KERNELS: dict = {}


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


def _global_kernels():
    """Build (once per process) the two Triton programs of K4.

    Replaces trino_tpu/ops/aggregate.py _global_aggregate, whose per-state
    jnp.sum/min/max over the page XLA fuses into reductions. Bound on this
    card: bytes — each state column (and its validity and FILTER mask) is
    read once; the output is one word per state. Pass 1 has one program
    per 4096-row block reduce EVERY state column of the block (one launch
    for up to 8 states) into per-block partials; pass 2 is one program
    that folds the partials of each state in block order. Both passes
    reduce in a fixed tree order, so float64 sums repeat bit for bit from
    run to run. min/max reduce order-preserving int64 keys of the floats
    (-0.0 < +0.0) with NaN carried as a separate flag, as jnp.min/max
    propagate NaN."""
    if _GLOBAL_KERNELS:
        return _GLOBAL_KERNELS["partial"], _GLOBAL_KERNELS["final"]
    import triton
    import triton.language as tl
    # the kernels below resolve `tl` through this module's globals
    globals()["tl"] = tl

    @triton.jit
    def partial_kernel(num_rows_ptr,
                       v0, v1, v2, v3, v4, v5, v6, v7,
                       a0, a1, a2, a3, a4, a5, a6, a7,
                       m0, m1, m2, m3, m4, m5, m6, m7,
                       part_i, part_f, part_n, nblocks,
                       K: tl.constexpr, KINDS: tl.constexpr,
                       FLOATS: tl.constexpr, VALIDS: tl.constexpr,
                       MASKS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        n = tl.load(num_rows_ptr).to(tl.int64)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        live = offs < n
        for j in tl.static_range(K):
            if j == 0:
                vp = v0
                ap = a0
                mp = m0
            elif j == 1:
                vp = v1
                ap = a1
                mp = m1
            elif j == 2:
                vp = v2
                ap = a2
                mp = m2
            elif j == 3:
                vp = v3
                ap = a3
                mp = m3
            elif j == 4:
                vp = v4
                ap = a4
                mp = m4
            elif j == 5:
                vp = v5
                ap = a5
                mp = m5
            elif j == 6:
                vp = v6
                ap = a6
                mp = m6
            else:
                vp = v7
                ap = a7
                mp = m7
            elig = live
            if (VALIDS >> j) & 1:
                elig = elig & (tl.load(ap + offs, mask=live, other=0) != 0)
            if (MASKS >> j) & 1:
                elig = elig & (tl.load(mp + offs, mask=live, other=0) != 0)
            slot = j * nblocks + pid
            if ((KINDS >> (2 * j)) & 3) == 1:
                tl.store(part_i + slot, tl.sum(elig.to(tl.int64), axis=0))
            elif ((KINDS >> (2 * j)) & 3) == 0:
                x = tl.load(vp + offs, mask=elig, other=0)
                if ((FLOATS >> j) & 1) == 1:
                    tl.store(part_f + slot, tl.sum(x, axis=0))
                else:
                    tl.store(part_i + slot, tl.sum(x, axis=0))
            else:
                x = tl.load(vp + offs, mask=elig, other=0)
                if ((FLOATS >> j) & 1) == 1:
                    isnan = x != x
                    tl.store(part_n + slot,
                             tl.max((elig & isnan).to(tl.int32), axis=0))
                    b = x.to(tl.int64, bitcast=True)
                    key = tl.where(b >= 0, b, b ^ 9223372036854775807)
                    elig = elig & (x == x)
                    if ((KINDS >> (2 * j)) & 3) == 2:
                        key = tl.where(elig, key, 9218868437227405312)
                    else:
                        key = tl.where(elig, key, -9218868437227405313)
                else:
                    if ((KINDS >> (2 * j)) & 3) == 2:
                        key = tl.where(elig, x, 9223372036854775807)
                    else:
                        key = tl.where(elig, x, -9223372036854775807 - 1)
                if ((KINDS >> (2 * j)) & 3) == 2:
                    tl.store(part_i + slot, tl.min(key, axis=0))
                else:
                    tl.store(part_i + slot, tl.max(key, axis=0))

    @triton.jit
    def final_kernel(part_i, part_f, part_n, out_i, out_f, nblocks,
                     K: tl.constexpr, KINDS: tl.constexpr,
                     FLOATS: tl.constexpr, RBLOCK: tl.constexpr):
        for j in tl.static_range(K):
            acc_i = tl.zeros([RBLOCK], dtype=tl.int64)
            acc_f = tl.zeros([RBLOCK], dtype=tl.float64)
            acc_n = tl.zeros([RBLOCK], dtype=tl.int32)
            if ((KINDS >> (2 * j)) & 3) == 2:
                acc_i = acc_i + 9223372036854775807
            if ((KINDS >> (2 * j)) & 3) == 3:
                acc_i = acc_i + (-9223372036854775807 - 1)
            for start in range(0, nblocks, RBLOCK):
                idx = start + tl.arange(0, RBLOCK)
                ok = idx < nblocks
                slot = j * nblocks + idx
                if ((KINDS >> (2 * j)) & 3) == 0:
                    if ((FLOATS >> j) & 1) == 1:
                        acc_f = acc_f + tl.load(part_f + slot, mask=ok,
                                                other=0)
                    else:
                        acc_i = acc_i + tl.load(part_i + slot, mask=ok,
                                                other=0)
                elif ((KINDS >> (2 * j)) & 3) == 1:
                    acc_i = acc_i + tl.load(part_i + slot, mask=ok, other=0)
                elif ((KINDS >> (2 * j)) & 3) == 2:
                    acc_i = tl.minimum(acc_i, tl.load(
                        part_i + slot, mask=ok, other=9223372036854775807))
                    acc_n = tl.maximum(acc_n, tl.load(part_n + slot,
                                                      mask=ok, other=0))
                else:
                    acc_i = tl.maximum(acc_i, tl.load(
                        part_i + slot, mask=ok,
                        other=-9223372036854775807 - 1))
                    acc_n = tl.maximum(acc_n, tl.load(part_n + slot,
                                                      mask=ok, other=0))
            if ((KINDS >> (2 * j)) & 3) <= 1:
                if ((FLOATS >> j) & 1) == 1:
                    tl.store(out_f + j, tl.sum(acc_f, axis=0))
                else:
                    tl.store(out_i + j, tl.sum(acc_i, axis=0))
            else:
                if ((KINDS >> (2 * j)) & 3) == 2:
                    key = tl.min(acc_i, axis=0)
                else:
                    key = tl.max(acc_i, axis=0)
                if ((FLOATS >> j) & 1) == 1:
                    bits = tl.where(key >= 0, key, key ^ 9223372036854775807)
                    nan_bits = tl.where(tl.max(acc_n, axis=0) > 0,
                                        9221120237041090560, bits)
                    tl.store(out_f + j, nan_bits.to(tl.float64,
                                                    bitcast=True))
                else:
                    tl.store(out_i + j, key)

    _GLOBAL_KERNELS["partial"] = partial_kernel
    _GLOBAL_KERNELS["final"] = final_kernel
    return partial_kernel, final_kernel


def global_reduce_triton(states: Sequence[StateInput],
                         num_rows: torch.Tensor, cap: int
                         ) -> List[torch.Tensor]:
    """K4 launch (two Triton programs per group of up to 8 states)."""
    dev = num_rows.device
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    for s in states:
        for b in (s.valid, s.mask):
            if b is not None and (b.device != dev or b.dtype != torch.bool
                                  or b.shape != (cap,)
                                  or not b.is_contiguous()):
                raise ValueError("masks must be contiguous bool [cap]")
        if s.values is not None and (
                s.values.device != dev or s.values.shape != (cap,)
                or s.values.dtype != (torch.float64 if s.is_float
                                      else torch.int64)
                or not s.values.is_contiguous()):
            raise ValueError("state values must be contiguous int64/"
                             "float64 [cap]")
    partial_kernel, final_kernel = _global_kernels()
    nblocks = max(1, -(-cap // _GLOBAL_BLOCK))
    dummy_i = torch.empty(1, dtype=torch.int64, device=dev)  # never read
    dummy_b = torch.empty(1, dtype=torch.bool, device=dev)
    results: List[torch.Tensor] = []
    for g in range(0, len(states), _TRITON_MAX_STATES):
        group = list(states[g:g + _TRITON_MAX_STATES])
        k = len(group)
        pad = _TRITON_MAX_STATES - k
        vals = [s.values if s.values is not None else dummy_i
                for s in group] + [dummy_i] * pad
        valids = [s.valid if s.valid is not None else dummy_b
                  for s in group] + [dummy_b] * pad
        masks = [s.mask if s.mask is not None else dummy_b
                 for s in group] + [dummy_b] * pad
        kinds = sum(s.kind << (2 * j) for j, s in enumerate(group))
        floats = sum(int(s.is_float) << j for j, s in enumerate(group))
        has_v = sum(int(s.valid is not None) << j
                    for j, s in enumerate(group))
        has_m = sum(int(s.mask is not None) << j for j, s in enumerate(group))
        part_i = torch.empty(k * nblocks, dtype=torch.int64, device=dev)
        part_f = torch.empty(k * nblocks, dtype=torch.float64, device=dev)
        part_n = torch.zeros(k * nblocks, dtype=torch.int32, device=dev)
        partial_kernel[(nblocks,)](
            num_rows, *vals, *valids, *masks, part_i, part_f, part_n,
            nblocks, K=k, KINDS=kinds, FLOATS=floats, VALIDS=has_v,
            MASKS=has_m, BLOCK=_GLOBAL_BLOCK, num_warps=8)
        out_i = torch.zeros(k, dtype=torch.int64, device=dev)
        out_f = torch.zeros(k, dtype=torch.float64, device=dev)
        final_kernel[(1,)](part_i, part_f, part_n, out_i, out_f, nblocks,
                           K=k, KINDS=kinds, FLOATS=floats,
                           RBLOCK=_REDUCE_BLOCK, num_warps=4)
        global_reduce_triton.launches += 1
        for j, s in enumerate(group):
            results.append((out_f if s.is_float else out_i)[j:j + 1])
    return results


global_reduce_triton.launches = 0


def global_reduce(states, num_rows, cap):
    """K4 wrapper: plain twin on the CPU, Triton kernel on CUDA."""
    run = global_reduce_triton if num_rows.is_cuda else global_reduce_plain
    return run(states, num_rows, cap)


# ------------------------------------------------------- hash_aggregate


def _unsupported(spec: AggSpec) -> Optional[str]:
    if spec.name not in SUPPORTED:
        return f"{spec.name}() is a special aggregate (ROADMAP B8)"
    return None


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
    partial_state_channels (agg -> its state channels)."""
    key_channels = tuple(key_channels)
    for a in aggs:
        reason = _unsupported(a)
        if reason is not None:
            raise NotImplementedError(reason)
        if a.distinct and step != Step.SINGLE:
            # distinctness is decidable only once a group's rows are
            # together: the optimizer keeps DISTINCT single-step
            raise NotImplementedError(
                f"{a.name}(DISTINCT ...) in {step} step")
    resolved = [get_aggregate(a.name,
                              a.input_type if a.input2 is None
                              else (a.input_type, a.input2_type))
                for a in aggs]

    def op(page: Page) -> Page:
        if not key_channels:
            return _global_aggregate(page, aggs, resolved, step,
                                     partial_state_channels)
        sizes = _direct_key_sizes(page, key_channels)
        if sizes is None:
            return _group_aggregate(page, key_channels, aggs, resolved, step,
                                    partial_state_channels)
        return _direct_aggregate(page, key_channels, aggs, resolved, step,
                                 partial_state_channels, sizes)

    return op


_DIRECT_MAX_GROUPS = 4096


def _direct_key_sizes(page: Page, key_channels):
    """Per-key code-space sizes when every group key is dictionary-encoded
    and the combined key space is at most 4096 slots, else None."""
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


def _step_inputs(page, aggs, resolved, step, partial_state_channels,
                 key_channels=()):
    """(per-agg states, per-agg dictionary, flat StateInput list)."""
    per_agg, dicts, flat = [], [], []
    dmasks: dict = {}   # DISTINCT aggregates over one argument share a mask
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
                key = (spec.input, spec.mask_channel)
                if key not in dmasks:
                    dmasks[key] = _distinct_first_mask(page, key_channels,
                                                       spec)
                dmask = dmasks[key]
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
          valid_where) -> List[Column]:
    """Aggregate output columns from the reduced state arrays."""
    out: List[Column] = []
    it = iter(arrays)
    for spec, fn, states, d in zip(aggs, resolved, per_agg, dicts):
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
                     partial_state_channels) -> Page:
    """GROUP BY on keys the direct path does not take (K8). The output
    keeps the input's capacity (#groups <= #rows), as the reference's
    sorted path does; groups come out in the kernel's slot order."""
    keys = [GroupKey(page.column(ch).values.contiguous(),
                     page.column(ch).valid) for ch in key_channels]
    per_agg, dicts, flat = _step_inputs(page, aggs, resolved, step,
                                        partial_state_channels, key_channels)
    key_values, key_valid, arrays, num_groups = group_reduce(
        keys, flat, page.num_rows, page.capacity)
    out_cols: List[Column] = []
    for ch, values, valid in zip(key_channels, key_values, key_valid):
        col = page.column(ch)
        out_cols.append(Column(values, valid, col.type, col.dictionary))
    out_cols.extend(_emit(aggs, resolved, step, per_agg, dicts, arrays,
                          page.capacity, lambda v: v))
    return Page(tuple(out_cols), num_groups)


def _global_aggregate(page, aggs, resolved, step, partial_state_channels):
    """No GROUP BY: one output row (reference: AggregationOperator.java)
    reduced by K4. INTERMEDIATE merges partial states like FINAL and
    re-emits the PARTIAL layout."""
    per_agg, dicts, flat = _step_inputs(page, aggs, resolved, step,
                                        partial_state_channels)
    arrays = global_reduce(flat, page.num_rows, page.capacity)
    out_cols = _emit(aggs, resolved, step, per_agg, dicts, arrays, 1,
                     lambda v: v.reshape(1))
    return Page(tuple(out_cols), 1)
