"""K11: one generated Triton kernel per filter or project step.

The JAX package has no module for this: under `jax.jit`, XLA fuses each
step's expression tree into one device program. Trino's counterpart is
`PageFunctionCompiler`, which turns a step's RowExpressions into one
compiled PageProcessor. Here:

1. **Lowering.** The step's lowered, literal-free trees (expr/hoist.py)
   become a flat, straight-line `Program` of primitive ops over explicit
   (value, valid) pairs: column loads, operand slots, calls of the scalar
   and device functions of expr/functions.py, table gathers, Kleene
   logic, selects and casts. The node handlers mirror expr/compiler.py's
   one by one; the host-side work they need (dictionary folds, lookup
   tables, page-invariant subtrees, padded IN vectors) is the compiler's
   own operand functions, run by the Program's binders per query and per
   dictionary.
2. **Source.** The Program becomes the text of one `@triton.jit` kernel:
   each op a line, each scalar function its Triton emission from
   functions.py, the device helpers of expr/triton_lib.py above it. The
   text depends only on the cache key (exec/jit_cache.py): the canonical
   trees, each input column's dtype and validity, the output dtypes.
   Every value a literal, a dictionary or a page-invariant subtree gives
   travels in one int64 operand buffer, as do the table bounds, so a new
   literal never compiles a new kernel; `num_rows` is read on the device.
   A list column (ARRAY, MAP) is a 2-D operand: its plane pointer, its
   lengths and (MAP) its value plane, with the static L (the row stride)
   in the text. `cardinality` reads the length, `element_at` one element
   at the row's index, `contains` and `map_element_at` loop over L under
   the row's length for the first match; `array_ctor`'s elements stay
   values of the kernel, read by those calls in place or written as a
   plane output [rows, n].
3. **Launch.** A filter step is one launch writing a bool mask (value AND
   valid, false on dead rows), which K1 then compacts. A project step is
   one launch writing every projection's values and validity; a bare
   column is aliased and a page-invariant projection broadcast, with no
   launch. A tree with a node the generator cannot lower raises
   NotImplementedError while the step is built, naming the node: there
   is no fallback to the torch-op compiler on the card.

Bound on this card: bytes — the referenced live columns read once and the
outputs written once; the kernel is one elementwise pass (256 rows per
program, one a thread), its tables and operands L2-resident. Triton compiles a
generated kernel in about a second, nvcc would take several, which is
why this kernel is Triton. Generated files go to `_build/expr/`
(git-ignored), named by the hash of their text.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import importlib.util
import inspect
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.expr import compiler as C
from trino_tpu_torch.expr import functions as F
from trino_tpu_torch.expr import triton_lib
from trino_tpu_torch.expr.ir import (Call, InputRef, Literal,
                                     RowExpression, SpecialForm,
                                     SpecialKind)
from trino_tpu_torch.page import Column, Dictionary, Page

_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "expr")
# One row per thread: every value of a kernel then has one layout. With
# several rows per thread, Triton 3.6's TritonGPURemoveLayoutConversions
# pass failed ("operand does not dominate this use") on kernels that store
# a date's civil parts and compute with them too.
BLOCK = 256           # rows per Triton program
NUM_WARPS = 8

_TL = {torch.bool: "tl.int1", torch.int8: "tl.int8", torch.int16: "tl.int16",
       torch.int32: "tl.int32", torch.int64: "tl.int64",
       torch.float32: "tl.float32", torch.float64: "tl.float64"}


# ------------------------------------------------------------ the program

@dataclasses.dataclass(frozen=True)
class Val:
    """An SSA value of a Program: its name in the kernel text, its dtype,
    and whether it is the same for every row (an operand)."""
    name: str
    dtype: torch.dtype
    uniform: bool


@dataclasses.dataclass(frozen=True)
class Instr:
    op: str
    out: Val
    args: Tuple[Val, ...] = ()
    attrs: tuple = ()     # op-specific static data (hashable)


@dataclasses.dataclass
class Pair:
    """A lowered subtree: values, validity (None = never NULL) and the
    index of its dictionary among the Program's dictionaries (strings)."""
    value: Val
    valid: Optional[Val]
    dict: Optional[int] = None


@dataclasses.dataclass
class ListPair:
    """A lowered list: an input list column (`index`, its static L, its
    lengths and whether it has a MAP value plane) or array_ctor's element
    values (`elems`, length n), with the list's validity and dictionary
    (a MAP's value dictionary in `aux_dict`)."""
    valid: Optional[Val]
    dict: Optional[int] = None
    index: int = -1
    L: int = 0
    lengths: Optional[Val] = None
    aux: bool = False
    aux_dict: Optional[int] = None
    elems: Tuple[Val, ...] = ()


@dataclasses.dataclass
class Output:
    """One projection (or the filter's predicate): `kind` is "kernel",
    "alias" (a bare input column) or "invariant" (broadcast)."""
    kind: str
    pair: Optional[Pair] = None
    index: int = -1
    expr: Optional[RowExpression] = None


class Binding:
    """What one call hands the kernel besides the page: operand slot
    values (int64 bit patterns), lookup tables and dictionaries."""

    def __init__(self, nslots, ntables, ndicts, inv):
        self.slots: List[int] = [0] * nslots
        self.tables: List[Optional[torch.Tensor]] = [None] * ntables
        self.dicts: List[Optional[Dictionary]] = [None] * ndicts
        self.inv: Dict[int, Column] = inv   # the invariants' host values


@dataclasses.dataclass
class Program:
    instrs: List[Instr]
    outputs: List[Output]
    inputs: Tuple[int, ...]            # referenced column indices
    valid_inputs: Tuple[int, ...]      # those with validity
    list_inputs: Tuple[int, ...]       # list columns (lengths operand)
    aux_inputs: Tuple[int, ...]        # MAP columns (value plane operand)
    slot_dtypes: List[torch.dtype]
    table_dtypes: List[torch.dtype]
    ndicts: int
    param_binders: List[Callable]      # fn(binding, params, device)
    page_binders: List[Callable]       # fn(binding, page)
    invariants: List[RowExpression]    # evaluated per query on the host
    mode: str


def bind(prog: Program, page: Page, params, inv) -> Binding:
    """Run the Program's binders for one page: `inv(expr)` gives a
    page-invariant subtree's host value."""
    b = Binding(len(prog.slot_dtypes), len(prog.table_dtypes), prog.ndicts,
                {j: inv(e) for j, e in enumerate(prog.invariants)})
    for fn in prog.param_binders:
        fn(b, params, page.device)
    for fn in prog.page_binders:
        fn(b, page)
    return b


def _slot_bits(value, dtype: torch.dtype) -> int:
    """A host scalar as the int64 bit pattern the kernel decodes."""
    if dtype.is_floating_point:
        return int(np.asarray(float(value), dtype=np.float64)
                   .view(np.int64))
    if dtype == torch.bool:
        return int(bool(value))
    return int(value)


def _dummy(dtype, uniform):
    return torch.zeros(() if uniform else (1,), dtype=dtype)


def _run_fn(name: str, static: tuple, *vals):
    """The torch form of a device function (fn(*static, *values)) or a
    scalar (static = (out_type, arg_types))."""
    if name in F._DEVICE:
        return F.lookup_device(name)(*static, *vals)
    out_type, arg_types = static
    return F.lookup(name)(out_type, list(arg_types), *vals)


# -------------------------------------------------------------- lowering

class _Lower:
    """Builds a Program from a step's trees (expr/compiler.py's handlers,
    node by node). `page` supplies the input columns' dtypes and validity
    (part of the cache key), `inv` evaluates page-invariant subtrees on
    the host (their results' dtypes are fixed by the tree)."""

    def __init__(self, page: Page, invariant: set, inv_eval):
        self.page = page
        self.invariant = invariant
        self.inv_eval = inv_eval
        self.instrs: List[Instr] = []
        self.slot_dtypes: List[torch.dtype] = []
        self.table_dtypes: List[torch.dtype] = []
        self.ndicts = 0
        self.param_binders: List[Callable] = []
        self.page_binders: List[Callable] = []
        self.invariants: List[RowExpression] = []
        self.inputs: Dict[int, Pair] = {}
        self.memo: Dict[int, Tuple[RowExpression, Pair]] = {}
        self.n = 0

    # ---- program building
    def _new(self, dtype, uniform) -> Val:
        v = Val(f"v{self.n}", dtype, uniform)
        self.n += 1
        return v

    def emit(self, op, args=(), dtype=None, attrs=()) -> Val:
        uniform = all(a.uniform for a in args) if args else op == "slot"
        out = self._new(dtype, uniform)
        self.instrs.append(Instr(op, out, tuple(args), tuple(attrs)))
        return out

    def slot(self, dtype) -> Tuple[int, Val]:
        k = len(self.slot_dtypes)
        self.slot_dtypes.append(dtype)
        return k, self.emit("slot", (), dtype, (k,))

    def const(self, value, dtype) -> Val:
        """A type-derived constant (never a literal's value) as a slot."""
        k, v = self.slot(dtype)
        bits = _slot_bits(value, dtype)

        def bind(b, params, device, k=k, bits=bits):
            b.slots[k] = bits
        self.param_binders.append(bind)
        return v

    def table(self, dtype) -> Tuple[int, int]:
        """A lookup table operand and its clip bound's slot."""
        t = len(self.table_dtypes)
        self.table_dtypes.append(dtype)
        k = len(self.slot_dtypes)
        self.slot_dtypes.append(torch.int64)
        return t, k

    def take(self, t: int, k: int, codes: Val, dtype) -> Val:
        hi = self.emit("slot", (), torch.int64, (k,))
        return self.emit("take", (codes, hi), dtype, (t,))

    def new_dict(self) -> int:
        self.ndicts += 1
        return self.ndicts - 1

    def page_binder(self, fn):
        self.page_binders.append(fn)

    def call_fn(self, name, static, args: Sequence[Val]) -> Optional[Val]:
        """A functions.py function of `args`; its dtype is the torch
        form's on dummies of the same dtypes and shapes (None when the
        torch form returns None there)."""
        got = _run_fn(name, tuple(static),
                      *[_dummy(a.dtype, a.uniform) for a in args])
        if got is None:
            return None
        F.emission(name)     # raises for a function without an emission
        return self.emit("fn", args, got.dtype, (name, tuple(static)))

    def vand(self, a: Optional[Val], b: Optional[Val]) -> Optional[Val]:
        if a is None:
            return b
        if b is None:
            return a
        return self.emit("and", (a, b), torch.bool)

    def vor(self, a, b):
        return self.emit("or", (a, b), torch.bool)

    def vnot(self, a):
        return self.emit("not", (a,), torch.bool)

    def cast(self, a: Val, dtype) -> Val:
        return a if a.dtype == dtype else self.emit("cast", (a,), dtype,
                                                    (dtype,))

    def promote(self, *xs: Val) -> Tuple[Val, ...]:
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        return tuple(self.cast(x, dt) for x in xs)

    # ---- trees
    def pair(self, expr: RowExpression) -> Pair:
        hit = self.memo.get(id(expr))
        if hit is not None:
            return hit[1]
        if _is_list(expr.type):
            p = self._list(expr)
        elif id(expr) in self.invariant:
            p = self._invariant(expr)
        elif isinstance(expr, InputRef):
            p = self._input(expr.index)
        elif isinstance(expr, Call):
            p = self._call(expr)
        elif isinstance(expr, SpecialForm):
            p = self._special(expr)
        else:
            raise NotImplementedError(f"K11 cannot lower {expr!r}")
        self.memo[id(expr)] = (expr, p)   # keeps expr (and its id) alive
        return p

    def _input(self, i: int) -> Pair:
        got = self.inputs.get(i)
        if got is not None:
            return got
        col = self.page.columns[i]
        value = self.emit("col", (), col.values.dtype, (i,))
        valid = None
        if col.valid is not None:
            valid = self.emit("col_valid", (), torch.bool, (i,))
        d = None
        if col.dictionary is not None:
            d = self.new_dict()

            def bind(b, page, d=d, i=i):
                b.dicts[d] = page.columns[i].dictionary
            self.page_binder(bind)
        p = self.inputs[i] = Pair(value, valid, d)
        return p

    # ---- lists
    def _dict_of(self, i: int, aux: bool) -> int:
        d = self.new_dict()

        def bind(b, page, d=d, i=i):
            col = page.columns[i]
            b.dicts[d] = col.aux_dictionary if aux else col.dictionary
        self.page_binder(bind)
        return d

    def _list(self, expr) -> ListPair:
        """A list-typed subtree: an input list column or array_ctor."""
        if isinstance(expr, InputRef):
            return self._list_input(expr.index)
        if isinstance(expr, Call) and expr.name == "array_ctor":
            return self._array_ctor(expr)
        raise NotImplementedError(f"K11 cannot lower the list {expr!r}")

    def _list_input(self, i: int) -> ListPair:
        got = self.inputs.get(i)
        if got is not None:
            return got
        col = self.page.columns[i]
        valid = None
        if col.valid is not None:
            valid = self.emit("col_valid", (), torch.bool, (i,))
        lengths = self.emit("list_len", (), torch.int32, (i,))
        p = self.inputs[i] = ListPair(
            valid, None if col.dictionary is None else self._dict_of(i, False),
            i, col.values.shape[1], lengths, col.aux is not None,
            None if col.aux_dictionary is None else self._dict_of(i, True))
        return p

    def _array_ctor(self, e: Call) -> ListPair:
        """compiler._list_op array_ctor: the arguments as the list's
        elements (strings remapped onto the union of their pools), NULL
        when any argument is."""
        args = [self.pair(a) for a in e.args]
        elem_dt = e.type.element.dtype
        dicts = [a.dict for a in args if a.dict is not None]
        out_d = None
        if dicts:
            out_d = self.new_dict()
            tabs = {}
            for a in args:
                if a.dict is not None and a.dict not in tabs:
                    tabs[a.dict] = self.table(torch.int32)

            def bind(b, page, tabs=tabs, out_d=out_d):
                pools = [b.dicts[d] for d in tabs]
                union, remap = C.array_ctor_dictionary(pools, page.device)
                for d, (t, k) in tabs.items():
                    pool = b.dicts[d]
                    _set_table(b, t, k, _identity_table(pool, page.device)
                               if remap is None else remap[id(pool)])
                b.dicts[out_d] = union
            self.page_binder(bind)
            args = [Pair(self.take(*tabs[a.dict], a.value, torch.int32),
                         a.valid, out_d) if a.dict is not None else a
                    for a in args]
        valid = None
        for a in args:
            valid = self.vand(valid, a.valid)
        return ListPair(valid, out_d,
                        elems=tuple(self.cast(a.value, elem_dt)
                                    for a in args))

    def _length(self, arr: ListPair) -> Val:
        return arr.lengths if arr.index >= 0 else \
            self.const(len(arr.elems), torch.int32)

    def _list_call(self, e: Call) -> Pair:
        """compiler._list_op's calls over a lowered list."""
        name = e.name
        arr = self.pair(e.args[0])
        if not isinstance(arr, ListPair):
            raise NotImplementedError(f"{name} over a non-list column")
        if name == "cardinality":
            return Pair(self.cast(self._length(arr), torch.int64), arr.valid)
        if name == "element_at":
            i = self.pair(e.args[1])
            iv = self.cast(i.value, torch.int32)
            length = self._length(arr)
            zero = self.const(0, torch.int32)
            idx = self.emit("where", (
                self.emit("cmp", (iv, zero), torch.bool, ("lt",)),
                self.emit("iadd", (length, iv), torch.int32),
                self.emit("isub", (iv, self.const(1, torch.int32)),
                          torch.int32)), torch.int32)
            inb = self.vand(self.vand(
                self.emit("cmp", (iv, zero), torch.bool, ("ne",)),
                self.emit("cmp", (idx, zero), torch.bool, ("ge",))),
                self.emit("cmp", (idx, length), torch.bool, ("lt",)))
            if arr.index >= 0:
                dtype = self.page.columns[arr.index].values.dtype
                value = self.emit("list_elem", (idx,), dtype,
                                  (arr.index, arr.L, "c"))
            else:
                value = arr.elems[0]
                for j, el in enumerate(arr.elems[1:], 1):
                    at = self.emit("cmp", (idx, self.const(j, torch.int32)),
                                   torch.bool, ("eq",))
                    value = self.emit("where", (at, el, value), el.dtype)
            valid = self.vand(self.vand(arr.valid, i.valid), inb)
            return Pair(value, valid, arr.dict)
        needle, nvalid = self._needle(e, arr)
        if arr.index < 0:
            found = None
            for el in arr.elems:
                a, b = self.promote(el, needle)
                eq = self.emit("cmp", (a, b), torch.bool, ("eq",))
                found = eq if found is None else self.vor(found, eq)
            return Pair(found, self.vand(arr.valid, nvalid))
        plane = self.page.columns[arr.index].values.dtype
        dt = torch.promote_types(plane, needle.dtype)
        first = self.emit("list_first", (self.cast(needle, dt), arr.lengths),
                          torch.int32, (arr.index, arr.L))
        found = self.emit("cmp", (first, self.const(arr.L, torch.int32)),
                          torch.bool, ("lt",))
        if name == "contains":
            return Pair(found, self.vand(arr.valid, nvalid))
        value = self.emit("list_elem", (first,),
                          self.page.columns[arr.index].aux.dtype,
                          (arr.index, arr.L, "a"))
        return Pair(value, self.vand(self.vand(arr.valid, nvalid), found),
                    arr.aux_dict)

    def _needle(self, e: Call, arr: ListPair) -> Tuple[Val, Optional[Val]]:
        """contains / map_element_at's searched value in the list's element
        space (compiler.membership_needle): a string literal folds to its
        code in the list's pool; another string must share the pool."""
        arg = e.args[1]
        if arr.dict is not None and isinstance(arg, Literal):
            k, code = self.slot(torch.int32)

            def bind(b, page, k=k, d=arr.dict):
                b.slots[k] = b.dicts[d].code_of(arg.value)
            self.page_binder(bind)
            return code, None
        x = self.pair(arg)
        if arr.dict is not None:
            if x.dict is None:
                raise NotImplementedError(
                    "array membership across distinct dictionaries")

            def check(b, page, dx=x.dict, da=arr.dict):
                if b.dicts[dx] != b.dicts[da]:
                    raise NotImplementedError(
                        "array membership across distinct dictionaries")
            self.page_binder(check)
        return x.value, x.valid

    def _invariant(self, expr) -> Pair:
        col = self.inv_eval(expr)
        self.invariants.append(expr)
        j = len(self.invariants) - 1
        k, value = self.slot(col.values.dtype)
        kv, valid = (None, None) if col.valid is None \
            else self.slot(torch.bool)
        d = None if col.dictionary is None else self.new_dict()
        dtype = col.values.dtype

        def bind(b, params, device, j=j, k=k, kv=kv, d=d, dtype=dtype):
            c = b.inv[j]
            b.slots[k] = _slot_bits(c.values.item(), dtype)
            if kv is not None:
                b.slots[kv] = int(bool(c.valid.item()))
            if d is not None:
                b.dicts[d] = c.dictionary
        self.param_binders.append(bind)
        return Pair(value, valid, d)

    def _need_dict(self, p: Pair, what: str) -> int:
        if p.dict is None:
            raise NotImplementedError(f"{what} requires dictionary input")
        return p.dict

    def _call(self, e: Call) -> Pair:
        name = e.name
        if name in C._COMPARISONS and C._string_side(e.args):
            return self._string_comparison(e)
        if name == "like":
            return self._like(e)
        if name == "concat_ws":
            return self._concat_ws(e)
        if name in C.STRING_TRANSFORMS:
            return self._string_transform(e)
        if name in C._STRING_SCALAR_FNS:
            return self._string_scalar(e)
        if name in C.DATE_UNIT_CALLS:
            static = C.date_unit_static(e)
            args = [self.pair(a) for a in e.args[1:]]
            value = self.call_fn(name, static, [a.value for a in args])
            valid = None
            for a in args:
                valid = self.vand(valid, a.valid)
            return Pair(value, valid)
        if name == "try_cast":
            return self._try_cast(e)
        if name in C.LIST_CALLS:
            return self._list_call(e)
        if name in C.FORMAT_CALLS:
            return self._format_datetime(e)
        if name == "$in_padded":
            return self._in_padded(e)
        if name not in F._SCALARS or name not in F._EMITS:
            raise NotImplementedError(f"K11 cannot lower {name}: {e}")
        args = [self.pair(a) for a in e.args]
        value = self.call_fn(name, (e.type, tuple(a.type for a in e.args)),
                             [a.value for a in args])
        valid = None
        for a in args:
            valid = self.vand(valid, a.valid)
        return Pair(value, valid)

    def _string_comparison(self, e: Call) -> Pair:
        name, args = e.name, e.args
        a_lit, b_lit = C._literal_str(args[0]), C._literal_str(args[1])
        if b_lit is None and a_lit is not None:
            flip = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge",
                    "gt": "lt", "ge": "le"}[name]
            return self.pair(Call(flip, (args[1], args[0]), e.type))
        col = self.pair(args[0])
        if b_lit is not None:
            d = self._need_dict(col, "string comparison")
            k, bound = self.slot(torch.int32)

            def bind(b, page, d=d, k=k):
                _, b.slots[k] = C.fold_string_comparison(b.dicts[d], name,
                                                         b_lit)
            self.page_binder(bind)
            value = self.emit("cmp", (col.value, bound), torch.bool,
                              (C.FOLDED_COMPARISON[name],))
            return Pair(value, col.valid)
        other = self.pair(args[1])
        da = self._need_dict(col, "string comparison")
        db = self._need_dict(other, "string comparison")

        def check(b, page):
            C.check_same_dictionary(b.dicts[da], b.dicts[db])
        self.page_binder(check)
        value = self.call_fn(name, (e.type, (T.BIGINT, T.BIGINT)),
                             [col.value, other.value])
        return Pair(value, self.vand(col.valid, other.valid))

    def _like(self, e: Call) -> Pair:
        col = self.pair(e.args[0])
        if C._literal_str(e.args[1]) is None:
            raise NotImplementedError(
                "LIKE requires literal pattern + dictionary")
        d = self._need_dict(col, "LIKE")
        t, k = self.table(torch.bool)

        def bind(b, page, d=d, t=t, k=k):
            _set_table(b, t, k, C.like_operand(e, b.dicts[d], page.device))
        self.page_binder(bind)
        return Pair(self.take(t, k, col.value, torch.bool), col.valid)

    def _string_transform(self, e: Call) -> Pair:
        col = self.pair(e.args[C.column_arg(e)])
        d = self._need_dict(col, e.name)
        nullable = e.name in C._NULLABLE_STRING_FNS
        t, k = self.table(torch.int32)
        tok, kok = self.table(torch.bool) if nullable else (None, None)
        out_d = self.new_dict()

        def bind(b, page, d=d, t=t, k=k, tok=tok, kok=kok, out_d=out_d):
            nd, remap, ok = C.string_transform_operand(e, b.dicts[d],
                                                       page.device)
            _set_table(b, t, k, remap)
            if tok is not None:
                _set_table(b, tok, kok, ok)
            b.dicts[out_d] = nd
        self.page_binder(bind)
        codes = self.take(t, k, col.value, torch.int32)
        valid = col.valid
        if nullable:
            valid = self.vand(self.take(tok, kok, col.value, torch.bool),
                              col.valid)
        return Pair(codes, valid, out_d)

    def _concat_ws(self, e: Call) -> Pair:
        if not isinstance(e.args[0], Literal):
            raise NotImplementedError("concat_ws separator must be a literal")
        out_d = self.new_dict()
        if e.args[0].value is None:          # a NULL separator: NULL
            value = self.const(0, torch.int32)
            valid = self.const(False, torch.bool)

            def bind_null(b, params, device, out_d=out_d):
                b.dicts[out_d] = C._EMPTY_STRING
            self.param_binders.append(bind_null)
            return Pair(value, valid, out_d)
        col = self.pair(e.args[C.concat_ws_column(e)])
        d = self._need_dict(col, "concat_ws")
        t, k = self.table(torch.int32)
        knull, null_code = self.slot(torch.int32)

        def bind(b, page, d=d, t=t, k=k, knull=knull, out_d=out_d):
            nd, remap, code = C.concat_ws_operand(e, b.dicts[d], page.device)
            _set_table(b, t, k, remap)
            b.slots[knull] = code
            b.dicts[out_d] = nd
        self.page_binder(bind)
        out = self.take(t, k, col.value, torch.int32)
        if col.valid is not None:
            out = self.emit("where", (col.valid, out, null_code),
                            torch.int32)
        return Pair(out, None, out_d)

    def _string_scalar(self, e: Call) -> Pair:
        col = self.pair(e.args[C.column_arg(e)])
        d = self._need_dict(col, e.name)
        dtype = C._STRING_SCALAR_FNS[e.name][1]
        t, k = self.table(dtype)

        def bind(b, page, d=d, t=t, k=k):
            _set_table(b, t, k, C.string_scalar_operand(e, b.dicts[d],
                                                        page.device))
        self.page_binder(bind)
        return Pair(self.take(t, k, col.value, dtype), col.valid)

    def _try_cast(self, e: Call) -> Pair:
        target, src_t = e.type, e.args[0].type
        col = self.pair(e.args[0])
        if not T.is_string(src_t):
            value = self.call_fn("cast", (target, (src_t,)), [col.value])
            ok = self.call_fn("cast_ok", (src_t, target), [col.value])
            valid = col.valid if ok is None else self.vand(col.valid, ok)
            return Pair(value, valid,
                        col.dict if T.is_string(target) else None)
        d = self._need_dict(col, "try_cast")
        if T.is_string(target):
            return col
        tv, kv = self.table(target.dtype)
        tok, kok = self.table(torch.bool)

        def bind(b, page, d=d):
            vals, ok = C.try_cast_operand(target, b.dicts[d], page.device)
            _set_table(b, tv, kv, vals)
            _set_table(b, tok, kok, ok)
        self.page_binder(bind)
        okv = self.take(tok, kok, col.value, torch.bool)
        return Pair(self.take(tv, kv, col.value, target.dtype),
                    self.vand(okv, col.valid))

    def _format_datetime(self, e: Call) -> Pair:
        static = C.format_datetime_static(e)
        col = self.pair(e.args[0])
        off = self.call_fn("day_offset", static, [col.value])
        t, k = self.table(torch.int32)
        out_d = self.new_dict()

        def bind(b, params, device, t=t, k=k, out_d=out_d):
            d, table = C.format_datetime_operand(e, device)
            _set_table(b, t, k, table)
            b.dicts[out_d] = d
        self.param_binders.append(bind)
        return Pair(self.take(t, k, off, torch.int32), col.valid, out_d)

    def _in_padded(self, e: Call) -> Pair:
        col = self.pair(e.args[0])
        width = int(e.args[2].value)
        mtype = e.args[1].type.dtype
        ks, members = [], []
        for _ in range(width):
            k, v = self.slot(mtype)
            ks.append(k)
            members.append(v)

        def bind(b, params, device, ks=tuple(ks)):
            vec = C.in_padded_members(e, params)
            for k, x in zip(ks, vec.tolist()):
                b.slots[k] = _slot_bits(x, mtype)
        self.param_binders.append(bind)
        needle = col.value
        dt = torch.promote_types(needle.dtype, mtype)
        needle = self.cast(needle, dt)
        hit = None
        for m in members:
            eq = self.emit("cmp", (needle, self.cast(m, dt)), torch.bool,
                           ("eq",))
            hit = eq if hit is None else self.vor(hit, eq)
        return Pair(hit, col.valid)

    def _special(self, e: SpecialForm) -> Pair:
        kind = e.kind
        if kind is SpecialKind.AND:
            return self._kleene([self.pair(a) for a in e.args], True)
        if kind is SpecialKind.OR:
            return self._kleene([self.pair(a) for a in e.args], False)
        if kind is SpecialKind.NOT:
            a = self.pair(e.args[0])
            return Pair(self.vnot(a.value), a.valid)
        if kind is SpecialKind.IS_NULL:
            a = self.pair(e.args[0])
            if a.valid is None:
                return Pair(self.emit("false", (), torch.bool), None)
            return Pair(self.vnot(a.valid), None)
        if kind is SpecialKind.COALESCE:
            return self._coalesce([self.pair(a) for a in e.args])
        if kind is SpecialKind.IF:
            return self._if_merge(self.pair(e.args[0]),
                                  self.pair(e.args[1]),
                                  self.pair(e.args[2]))
        if kind is SpecialKind.SWITCH:
            args = list(e.args)
            out = self.pair(args[-1])
            for cond_e, val_e in reversed(list(zip(args[:-1:2],
                                                   args[1:-1:2]))):
                out = self._if_merge(self.pair(cond_e), self.pair(val_e),
                                     out)
            return out
        if kind is SpecialKind.IN:
            needle = e.args[0]
            return self._kleene([self.pair(Call("eq", (needle, v),
                                                T.BOOLEAN))
                                 for v in e.args[1:]], False)
        if kind is SpecialKind.BETWEEN:
            value, low, high = e.args
            return self.pair(SpecialForm(SpecialKind.AND, (
                Call("ge", (value, low), T.BOOLEAN),
                Call("le", (value, high), T.BOOLEAN)), T.BOOLEAN))
        raise NotImplementedError(f"K11 cannot lower {kind}")

    def _kleene(self, args: List[Pair], is_and: bool) -> Pair:
        """compiler._kleene_and / _kleene_or: a definite false (AND) or
        true (OR) decides whatever the other side is; a missing validity
        is always-valid."""
        value, valid = args[0].value, args[0].valid
        for a in args[1:]:
            av, an = a.value, a.valid
            new_value = self.emit("and" if is_and else "or", (value, av),
                                  torch.bool)

            def decides(x):
                return self.vnot(x) if is_and else x
            if valid is None and an is None:
                new_valid = None
            elif valid is None:      # the other valid, or this side decides
                new_valid = self.vor(an, decides(value))
            elif an is None:
                new_valid = self.vor(valid, decides(av))
            else:
                new_valid = self.vor(self.vor(
                    self.vand(valid, an), self.vand(valid, decides(value))),
                    self.vand(an, decides(av)))
            value, valid = new_value, new_valid
        return Pair(value, valid)

    def _coalesce(self, args: List[Pair]) -> Pair:
        dicts = [a.dict for a in args if a.dict is not None]
        if len(dicts) > 1:
            def check(b, page, dicts=tuple(dicts)):
                if len({b.dicts[d] for d in dicts}) > 1:
                    raise NotImplementedError(
                        "COALESCE over distinct dictionaries")
            self.page_binder(check)
        first = dicts[0] if dicts else None
        out = args[-1]
        for a in reversed(args[:-1]):
            if a.valid is None:
                out = a
                continue
            av, ov = self.promote(a.value, out.value)
            value = self.emit("where", (a.valid, av, ov), av.dtype)
            valid = None if out.valid is None else self.vor(a.valid,
                                                            out.valid)
            out = Pair(value, valid, first)
        return out

    def _if_merge(self, cond: Pair, then: Pair, els: Pair) -> Pair:
        take_then = self.vand(cond.value, cond.valid)
        d = then.dict if then.dict is not None else els.dict
        if then.dict is not None and els.dict is not None:
            ta, ka = self.table(torch.int32)
            tb, kb = self.table(torch.int32)
            d = self.new_dict()

            def bind(b, page, da=then.dict, db=els.dict, d=d):
                a, c = b.dicts[da], b.dicts[db]
                if a != c:
                    merged, ra, rb = C.merge_dictionaries_operand(
                        a, c, page.device)
                else:
                    merged = a
                    ra = rb = _identity_table(a, page.device)
                _set_table(b, ta, ka, ra)
                _set_table(b, tb, kb, rb)
                b.dicts[d] = merged
            self.page_binder(bind)
            then = Pair(self.take(ta, ka, then.value, torch.int32),
                        then.valid)
            els = Pair(self.take(tb, kb, els.value, torch.int32), els.valid)
        tv, ev = self.promote(then.value, els.value)
        value = self.emit("where", (take_then, tv, ev), tv.dtype)
        if then.valid is None and els.valid is None:
            valid = None
        elif then.valid is None:
            valid = self.vor(take_then, els.valid)
        elif els.valid is None:
            valid = self.vor(self.vnot(take_then), then.valid)
        else:
            valid = self.emit("where", (take_then, then.valid, els.valid),
                              torch.bool)
        return Pair(value, valid, d)


def _set_table(b: Binding, t: int, k: int, table: torch.Tensor) -> None:
    """A lookup table and its clip bound; an empty table gathers 0s (a
    one-entry table of 0), as compiler._take does."""
    if table.shape[0] == 0:
        table = torch.zeros(1, dtype=table.dtype, device=table.device)
        b.slots[k] = 0
    else:
        b.slots[k] = table.shape[0] - 1
    b.tables[t] = table.contiguous()


def _identity_table(d: Dictionary, device) -> torch.Tensor:
    cache = F._dict_cache(d)
    ck = ("identity", str(device))
    t = cache.get(ck)
    if t is None:
        t = cache[ck] = torch.arange(len(d), dtype=torch.int32,
                                     device=device)
    return t


def _is_list(t) -> bool:
    return isinstance(t, (T.ArrayType, T.MapType))


def lower(exprs: Sequence[RowExpression], mode: str, page: Page,
          inv_eval) -> Program:
    """The Program of one step ("filter": one predicate; "project": one
    output per expression)."""
    invariant: set = set()
    for e in exprs:
        C._invariant_ids(e, invariant)
    lw = _Lower(page, invariant, inv_eval)
    outputs = []
    for e in exprs:
        if mode == "project" and isinstance(e, InputRef):
            outputs.append(Output("alias", index=e.index))
        elif id(e) in invariant:
            outputs.append(Output("invariant", expr=e))
        else:
            p = lw.pair(e)
            if isinstance(p, ListPair) and p.index >= 0:
                raise NotImplementedError(
                    f"K11 cannot write the list column {p.index}")
            outputs.append(Output("kernel", pair=p))
    refs = tuple(sorted(lw.inputs))
    lists = tuple(i for i in refs if isinstance(lw.inputs[i], ListPair))
    return Program(lw.instrs, outputs, refs,
                   tuple(i for i in refs if lw.inputs[i].valid is not None),
                   lists, tuple(i for i in lists if lw.inputs[i].aux),
                   lw.slot_dtypes, lw.table_dtypes, lw.ndicts,
                   lw.param_binders, lw.page_binders, lw.invariants, mode)


# -------------------------------------------------- the torch evaluator

def evaluate(prog: Program, page: Page, b: Binding) -> List[Optional[Pair]]:
    """Run the Program's primitives as torch ops over the page (the test
    of the lowering against the plain compiler): the kernel outputs'
    (values, valid) tensors, in order; None for aliased or broadcast
    outputs."""
    env: Dict[str, torch.Tensor] = {}
    dev = page.device
    for ins in prog.instrs:
        a = [env[x.name] for x in ins.args]
        op = ins.op
        if op == "col":
            r = page.columns[ins.attrs[0]].values
        elif op == "col_valid":
            r = page.columns[ins.attrs[0]].valid
        elif op == "slot":
            bits = np.asarray(b.slots[ins.attrs[0]], dtype=np.int64)
            if ins.out.dtype.is_floating_point:
                r = torch.tensor(float(bits.view(np.float64)),
                                 dtype=torch.float64).to(ins.out.dtype)
            else:
                r = torch.tensor(int(bits)).to(ins.out.dtype)
            r = r.to(dev)
        elif op == "fn":
            name, static = ins.attrs
            r = _run_fn(name, static, *a)
        elif op == "and":
            r = a[0] & a[1]
        elif op == "or":
            r = a[0] | a[1]
        elif op == "not":
            r = ~a[0]
        elif op == "where":
            r = torch.where(*a)
        elif op == "cast":
            r = a[0].to(ins.attrs[0])
        elif op == "cmp":
            r = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
                 "le": torch.le, "gt": torch.gt, "ge": torch.ge}[
                ins.attrs[0]](a[0], a[1])
        elif op == "take":
            table = b.tables[ins.attrs[0]]
            r = table[a[0].long().clamp(0, int(a[1]))]
        elif op == "false":
            r = torch.zeros(page.capacity, dtype=torch.bool, device=dev)
        elif op == "iadd":
            r = a[0] + a[1]
        elif op == "isub":
            r = a[0] - a[1]
        elif op == "list_len":
            r = page.columns[ins.attrs[0]].lengths
        elif op == "list_elem":
            i, L, which = ins.attrs
            col = page.columns[i]
            plane = col.values if which == "c" else col.aux
            idx = a[0].expand(page.capacity).long().clamp(0, L - 1)
            r = plane.gather(1, idx[:, None])[:, 0]
        elif op == "list_first":
            i, L = ins.attrs
            plane = page.columns[i].values.to(a[0].dtype)
            inl = torch.arange(L, device=dev)[None, :] < a[1][:, None]
            match = (plane == a[0].expand(page.capacity)[:, None]) & inl
            r = torch.where(match.any(1), match.to(torch.uint8).argmax(1),
                            L).to(torch.int32)
        else:
            raise AssertionError(op)
        if r.dtype != ins.out.dtype:
            raise AssertionError(f"{ins}: dtype {r.dtype}")
        env[ins.out.name] = r
    out = []
    for o in prog.outputs:
        if o.kind != "kernel":
            out.append(None)
            continue
        m = None if o.pair.valid is None else env[o.pair.valid.name]
        if isinstance(o.pair, ListPair):    # array_ctor: the [cap, n] plane
            v = torch.stack([env[e.name].expand(page.capacity)
                             for e in o.pair.elems], 1)
        else:
            v = env[o.pair.value.name]
        out.append(Pair(v, m, o.pair.dict))
    return out


# ---------------------------------------------------------- Triton text

@dataclasses.dataclass(frozen=True)
class X:
    """A typed Triton expression inside an emission."""
    code: str
    dtype: torch.dtype
    uniform: bool


class Emitter:
    """What functions.py's emissions see: typed expressions, casts and
    temporaries, written into the kernel body in order."""

    def __init__(self, lines: List[str], const_slot: Callable):
        self.lines = lines
        self._const_slot = const_slot
        self.n = 0
        # one temporary per distinct expression: the kernel computes a
        # shared subexpression (a date's civil parts, a cast) once, which
        # also keeps Triton 3.6's layout pass from mis-ordering copies of
        # one inlined helper
        self._seen: Dict[Tuple[str, torch.dtype], object] = {}

    def _tmp(self, code: str, dtype, uniform) -> X:
        hit = self._seen.get((code, dtype))
        if hit is not None:
            return hit
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"    {name} = {code}")
        x = self._seen[(code, dtype)] = X(name, dtype, uniform)
        return x

    # typing
    @staticmethod
    def is_int(x: X) -> bool:
        return not x.dtype.is_floating_point and x.dtype != torch.bool

    @staticmethod
    def is_float(x: X) -> bool:
        return x.dtype.is_floating_point

    @staticmethod
    def tl_name(dtype) -> str:
        return _TL[dtype]

    def tl_dtype(self, x: X) -> str:
        return _TL[x.dtype]

    @staticmethod
    def int_lit(v: int) -> str:
        return "(-9223372036854775807 - 1)" if v == -(1 << 63) else str(v)

    # building
    def to(self, x: X, dtype) -> X:
        if x.dtype == dtype:
            return x
        return self._tmp(f"{x.code}.to({_TL[dtype]})", dtype, x.uniform)

    def i64(self, x: X) -> X:
        return self.to(x, torch.int64)

    def f64(self, x: X) -> X:
        return self.to(x, torch.float64)

    def promote(self, *xs: X) -> Tuple[X, ...]:
        """functions._promote: the common dtype by dtype alone."""
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        return tuple(self.to(x, dt) for x in xs)

    def arith(self, *xs: X) -> Tuple[X, ...]:
        """The dtype torch computes a binary op in (a 0-d operand does
        not widen a tensor of its own kind)."""
        dt = torch.result_type(*[_dummy(x.dtype, x.uniform) for x in xs])
        return tuple(self.to(x, dt) for x in xs)

    def op(self, fmt: str, *xs: X, dtype=None) -> X:
        dtype = dtype if dtype is not None else xs[0].dtype
        return self._tmp(fmt.format(*[x.code for x in xs]), dtype,
                         all(x.uniform for x in xs))

    def multi(self, fmt: str, count: int, dtype, *xs: X) -> List[X]:
        """`count` values of one helper call that returns a tuple."""
        code = fmt.format(*[x.code for x in xs])
        hit = self._seen.get((code, "multi"))
        if hit is not None:
            return hit
        names = [f"t{self.n + i}" for i in range(count)]
        self.n += count
        self.lines.append(f"    {', '.join(names)} = {code}")
        uniform = all(x.uniform for x in xs)
        out = self._seen[(code, "multi")] = [X(nm, dtype, uniform)
                                             for nm in names]
        return out

    def const(self, value, dtype) -> X:
        """A type-derived float constant, exact, from the operand
        buffer (a float literal in Triton text would be float32)."""
        return self._const_slot(value, dtype)


_OPS = {"and": "{} & {}", "or": "{} | {}", "not": "_not({})"}
_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
        "ge": ">="}


def _helper_source() -> str:
    """Every function of triton_lib, docstrings removed, under
    @triton.jit."""
    out = []
    for name, fn in inspect.getmembers(triton_lib, inspect.isfunction):
        if fn.__module__ != triton_lib.__name__:
            continue
        tree = ast.parse(inspect.getsource(fn))
        body = tree.body[0].body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant):
            tree.body[0].body = body[1:]
        out.append("@triton.jit\n" + ast.unparse(tree) + "\n")
    return "\n\n".join(out)


HEADER = '''import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:
    try:
        from triton.language.extra.cuda import libdevice
    except ImportError:
        from triton.language import math as libdevice
'''


def kernel_source(prog: Program) -> Tuple[str, List[float]]:
    """(text of the kernel function `k11`, the float constants the
    emissions asked for, appended to the operand slots in order)."""
    body: List[str] = []
    consts: List[Tuple[float, torch.dtype]] = []
    base = len(prog.slot_dtypes)

    def const_slot(value, dtype) -> X:
        k = base + len(consts)
        consts.append((value, dtype))
        code = f"_bits_f64(tl.load(ops + {k}))"
        if dtype != torch.float64:
            code += f".to({_TL[dtype]})"
        name = f"k{len(consts) - 1}"
        body.append(f"    {name} = {code}")
        return X(name, dtype, True)

    g = Emitter(body, const_slot)
    for ins in prog.instrs:
        o, a = ins.out, [X(x.name, x.dtype, x.uniform) for x in ins.args]
        if ins.op == "col":
            code = f"tl.load(c{ins.attrs[0]} + offs, mask=live, other=0)"
            if o.dtype == torch.bool:
                code += " != 0"
        elif ins.op == "col_valid":
            code = (f"tl.load(m{ins.attrs[0]} + offs, mask=live, other=0)"
                    " != 0")
        elif ins.op == "slot":
            code = f"tl.load(ops + {ins.attrs[0]})"
            if o.dtype == torch.bool:
                code += " != 0"
            elif o.dtype.is_floating_point:
                code = f"_bits_f64({code})"
                if o.dtype != torch.float64:
                    code += f".to({_TL[o.dtype]})"
            elif o.dtype != torch.int64:
                code += f".to({_TL[o.dtype]})"
        elif ins.op == "fn":
            name, static = ins.attrs
            x = F.emission(name)(g, *static, *a)
            if x is None or x.dtype != o.dtype:
                raise AssertionError(
                    f"{name}{static}: the emission gives "
                    f"{None if x is None else x.dtype}, the torch form "
                    f"{o.dtype}")
            code = x.code
        elif ins.op in _OPS:
            code = _OPS[ins.op].format(*[x.code for x in a])
        elif ins.op == "where":
            code = f"tl.where({a[0].code}, {a[1].code}, {a[2].code})"
        elif ins.op == "cast":
            code = f"{a[0].code}.to({_TL[o.dtype]})"
        elif ins.op == "cmp":
            code = f"{a[0].code} {_CMP[ins.attrs[0]]} {a[1].code}"
        elif ins.op == "take":
            t = ins.attrs[0]
            # a uniform code (a folded literal) reads one entry, unmasked
            code = (f"tl.load(tb{t} + tl.minimum(tl.maximum("
                    f"{a[0].code}.to(tl.int64), 0), {a[1].code})"
                    + (")" if a[0].uniform else ", mask=live, other=0)"))
            if o.dtype == torch.bool:
                code += " != 0"
        elif ins.op == "false":
            code = "offs < 0"
        elif ins.op in ("iadd", "isub"):
            code = f"{a[0].code} {'+' if ins.op == 'iadd' else '-'} " \
                f"{a[1].code}"
        elif ins.op == "list_len":
            code = f"tl.load(n{ins.attrs[0]} + offs, mask=live, other=0)"
        elif ins.op == "list_elem":
            i, L, which = ins.attrs
            code = (f"tl.load({which}{i} + (offs * {L} + tl.minimum("
                    f"tl.maximum({a[0].code}.to(tl.int64), 0), {L - 1})), "
                    f"mask=live, other=0)")
            if o.dtype == torch.bool:
                code += " != 0"
        elif ins.op == "list_first":
            # the first j < the row's length whose element equals the
            # needle, else L: a loop over the row's plane
            i, L = ins.attrs
            j, el = f"j_{o.name}", f"e_{o.name}"
            elem = el if a[0].dtype != torch.bool else f"({el} != 0)"
            body += [f"    {o.name} = tl.full([BLOCK], {L}, tl.int32)",
                     f"    for {j} in range(0, {L}):",
                     f"        {el} = tl.load(c{i} + (offs * {L} + {j}), "
                     f"mask=live & ({j} < {a[1].code}), other=0)",
                     f"        {o.name} = tl.where(({o.name} == {L}) & "
                     f"({j} < {a[1].code}) & ({elem}.to({_TL[a[0].dtype]})"
                     f" == {a[0].code}), {j}, {o.name})"]
            continue
        else:
            raise AssertionError(ins.op)
        body.append(f"    {o.name} = {code}")
    params = ["ops", "nrows", "cap"]
    params += [f"c{i}" for i in prog.inputs]
    params += [f"m{i}" for i in prog.valid_inputs]
    params += [f"n{i}" for i in prog.list_inputs]
    params += [f"a{i}" for i in prog.aux_inputs]
    params += [f"tb{t}" for t in range(len(prog.table_dtypes))]
    stores = []
    kernel_outs = [o for o in prog.outputs if o.kind == "kernel"]

    def block(v: Val) -> str:
        """A row block of v: a uniform value is spread over the rows."""
        return f"tl.where(inb, {v.name}, {v.name})" if v.uniform \
            else v.name
    for j, o in enumerate(kernel_outs):
        p = o.pair
        if prog.mode == "filter":
            value = block(p.value)
            if p.valid is not None:
                value = f"{value} & {block(p.valid)}"
            stores.append(f"    tl.store(o0 + offs, {value} & live, "
                          f"mask=inb)")
            params.append("o0")
            continue
        params.append(f"o{j}")
        if isinstance(p, ListPair):         # array_ctor: a [rows, n] plane
            n = len(p.elems)
            stores += [f"    tl.store(o{j} + (offs * {n} + {k}), "
                       f"{block(el)}, mask=inb)"
                       for k, el in enumerate(p.elems)]
        else:
            stores.append(f"    tl.store(o{j} + offs, {block(p.value)}, "
                          f"mask=inb)")
        if p.valid is not None:
            params.append(f"ov{j}")
            stores.append(f"    tl.store(ov{j} + offs, {block(p.valid)}, "
                          f"mask=inb)")
        if isinstance(p, ListPair):
            params.append(f"ol{j}")
            stores.append(f"    tl.store(ol{j} + offs, tl.full([BLOCK], "
                          f"{len(p.elems)}, tl.int32), mask=inb)")
    head = [f"@triton.jit(do_not_specialize=['cap'])",
            f"def k11({', '.join(params)}, BLOCK: tl.constexpr):",
            "    offs = tl.program_id(0).to(tl.int64) * BLOCK + "
            "tl.arange(0, BLOCK)",
            "    n = tl.load(nrows).to(tl.int64)",
            "    live = offs < n",
            "    inb = offs < cap"]
    text = "\n".join(head + body + stores) + "\n"
    return text, consts


def module_source(prog: Program) -> Tuple[str, List[tuple]]:
    """The whole generated file and its float constants."""
    kernel, consts = kernel_source(prog)
    return (f"# K11: one {prog.mode} step, generated by "
            f"trino_tpu_torch/expr/kernel_gen.py\n" + HEADER + "\n\n"
            + _helper_source() + "\n\n" + kernel), consts


_LOAD_LOCK = threading.Lock()


def load_kernel(text: str):
    """Write the text to _build/expr/<hash>.py (Triton reads a kernel's
    source with inspect, so it must live in a file) and import it."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:24]
    path = os.path.join(_BUILD, f"k11_{digest}.py")
    with _LOAD_LOCK:
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(f"k11_{digest}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod.k11


# ------------------------------------------------------------- the step

class _Compiled:
    """A Program with its kernel text, float constants and (built at the
    first launch) Triton kernel."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.text, self.consts = module_source(prog)
        self.const_bits = [_slot_bits(v, torch.float64)
                           for v, _ in self.consts]
        self._kernel = None

    def kernel(self):
        if self._kernel is None:
            self._kernel = load_kernel(self.text)
        return self._kernel


class ExprStep:
    """One filter (a predicate) or project (a list of expressions) step:
    fn(page, params) -> bool mask | tuple of Columns. CUDA pages run K11;
    CPU pages run the plain compiler (`plain`)."""

    def __init__(self, exprs: Sequence[RowExpression], mode: str):
        assert mode in ("filter", "project")
        self.exprs = tuple(exprs)
        self.mode = mode
        self._invariant: set = set()
        for e in self.exprs:
            C._invariant_ids(e, self._invariant)
        self._plain = None
        self._refs = _input_refs(self.exprs)
        self._by_sig: Dict[tuple, _Compiled] = {}
        self._params = None          # the last params tuple (identity)
        self._inv: Dict[int, Column] = {}
        self._bound: Dict[tuple, tuple] = {}

    def plain(self, page: Page, params=()):
        """The plain form: expr/compiler.py's torch ops."""
        if self._plain is None:
            if self.mode == "filter":
                self._plain = C.compile_filter(self.exprs[0])
            else:
                fns = [C.compile_expression(e) for e in self.exprs]
                self._plain = lambda p, g: tuple(f(p, g) for f in fns)
        return self._plain(page, params)

    def __call__(self, page: Page, params=()):
        if page.device.type == "cuda":
            return expr_step_cuda(self, page, params)
        return self.plain(page, params)

    # ---- K11 pieces
    def _inv_eval(self, params):
        if self._params is not params:
            self._params = params
            self._inv = {}
            self._bound = {}

        def get(expr):
            hit = self._inv.get(id(expr))
            if hit is None:
                hit = self._inv[id(expr)] = C.invariant_value(expr, params)
            return hit
        return get

    def compiled(self, page: Page, params) -> _Compiled:
        """The cached Program of this step for the page's input layout."""
        sig = tuple((page.columns[i].values.dtype,
                     page.columns[i].valid is not None,
                     page.columns[i].dictionary is not None,
                     tuple(page.columns[i].values.shape[1:]),
                     None if page.columns[i].aux is None
                     else page.columns[i].aux.dtype)
                    for i in self._refs)
        hit = self._by_sig.get(sig)
        if hit is not None:
            return hit
        key = ("k11", self.mode, self.exprs, self._refs,
               tuple(tuple(str(x) for x in t) for t in sig),
               tuple(str(e.type.dtype) for e in self.exprs))
        inv = self._inv_eval(params)
        from trino_tpu_torch.exec.jit_cache import cached_kernel
        hit = self._by_sig[sig] = cached_kernel(key, lambda: _Compiled(
            lower(self.exprs, self.mode, page, inv)))
        return hit

    def binding(self, comp: _Compiled, page: Page, params):
        """(operand buffer on the device, tables, dictionaries), memoized
        while the params tuple and the input dictionaries stay the
        same."""
        prog = comp.prog
        inv = self._inv_eval(params)
        dicts = tuple(page.columns[i].dictionary for i in prog.inputs)
        key = (id(comp),) + tuple(id(d) for d in dicts)
        hit = self._bound.get(key)
        if hit is not None and hit[0] is comp \
                and all(a is b for a, b in zip(hit[1], dicts)):
            return hit[2]
        b = bind(prog, page, params, inv)
        host = torch.tensor(b.slots + comp.const_bits + [0],
                            dtype=torch.int64)
        ops = host.pin_memory().to(page.device, non_blocking=True) \
            if page.device.type == "cuda" else host
        got = (ops, b.tables, b.dicts)
        if len(self._bound) > 8:
            self._bound.clear()
        self._bound[key] = (comp, dicts, got)
        return got


def _input_refs(exprs) -> Tuple[int, ...]:
    out = set()

    def visit(e):
        if isinstance(e, InputRef):
            out.add(e.index)
        for c in e.children():
            visit(c)
    for e in exprs:
        visit(e)
    return tuple(sorted(out))


def expr_step_cuda(step: ExprStep, page: Page, params=()):
    """K11 launch: one generated Triton kernel for the step (see the
    module docstring); aliased and broadcast projections launch
    nothing."""
    comp = step.compiled(page, params)
    prog = comp.prog
    cap = page.capacity
    dev = page.device
    outs = [o for o in prog.outputs if o.kind == "kernel"]
    results: List[tuple] = []
    if outs:
        ops, tables, dicts = step.binding(comp, page, params)
        args = [ops, page.num_rows, cap] + launch_inputs(prog, page) \
            + list(tables)
        results = output_tensors(prog, cap, dev)
        args += [t for r in results for t in r if t is not None]
        grid = (max(1, -(-cap // BLOCK)),)
        comp.kernel()[grid](*args, BLOCK=BLOCK, num_warps=NUM_WARPS)
        expr_step_cuda.launches += 1
    else:
        dicts = []
    inv = step._inv_eval(params)
    if prog.mode == "filter":
        o = prog.outputs[0]
        if o.kind == "kernel":
            return results[0][0]
        col = C._broadcast(C.on_device(inv(o.expr), dev), cap)
        mask = col.values if col.valid is None else col.values & col.valid
        return mask.contiguous()
    cols, it = [], iter(results)
    for o, e in zip(prog.outputs, step.exprs):
        if o.kind == "alias":
            cols.append(page.columns[o.index])
        elif o.kind == "invariant":
            c = C._broadcast(C.on_device(inv(o.expr), dev), cap)
            cols.append(Column(*[None if t is None else t.contiguous()
                                 for t in (c.values, c.valid)],
                               c.type, c.dictionary,
                               *[None if t is None else t.contiguous()
                                 for t in (c.lengths, c.aux)],
                               c.aux_dictionary))
        else:
            v, m, lengths = next(it)
            d = None if o.pair.dict is None else dicts[o.pair.dict]
            cols.append(Column(v, m, e.type, d, lengths))
    return tuple(cols)


expr_step_cuda.launches = 0


def launch_inputs(prog: Program, page: Page) -> List[torch.Tensor]:
    """The page's tensors a step's kernel reads, in its parameter order
    (values or planes, validity, list lengths, MAP value planes)."""
    cols = page.columns
    return [cols[i].values for i in prog.inputs] \
        + [cols[i].valid for i in prog.valid_inputs] \
        + [cols[i].lengths for i in prog.list_inputs] \
        + [cols[i].aux for i in prog.aux_inputs]


def output_tensors(prog: Program, cap: int, dev) -> List[tuple]:
    """The kernel's outputs per kernel output, in parameter order: (mask,
    None, None) for a filter; (values or an array_ctor's [cap, n] plane,
    its validity or None, the plane's lengths or None) for a
    projection."""
    out = []
    for o in prog.outputs:
        if o.kind != "kernel":
            continue
        if prog.mode == "filter":
            out.append((torch.empty(cap, dtype=torch.bool, device=dev),
                        None, None))
            continue
        p = o.pair
        m = None if p.valid is None else torch.empty(cap, dtype=torch.bool,
                                                     device=dev)
        if isinstance(p, ListPair):
            v = torch.empty((cap, len(p.elems)), dtype=p.elems[0].dtype,
                            device=dev)
            out.append((v, m, torch.empty(cap, dtype=torch.int32,
                                          device=dev)))
        else:
            out.append((torch.empty(cap, dtype=p.value.dtype, device=dev),
                        m, None))
    return out


def filter_step(expr: RowExpression) -> ExprStep:
    return ExprStep((expr,), "filter")


def project_step(exprs: Sequence[RowExpression]) -> ExprStep:
    return ExprStep(tuple(exprs), "project")
