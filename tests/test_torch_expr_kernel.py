"""K11 (trino_tpu_torch/expr/kernel_gen.py) against the plain compiler (CPU).

There is no Triton here, so the generator is held to the plain torch-op
compiler twice over, on the expression corpus chip_smoke.py runs on the
card (every scalar function, the special forms, the string and dictionary
paths, try_cast, the date unit calls, a padded IN list; NULLs, NaN, -0.0,
zero divisors, INT64_MIN, decimal half cases, dates before 1970) and on
test_torch_expr.py's cases:
- the flat Program, run by kernel_gen.evaluate (a torch evaluator of its
  primitives), must equal the plain compiler;
- the generated kernel text itself must parse, and run as written under a
  torch stand-in for `triton.language` (the intrinsics of
  expr/triton_lib.py, C division, bit casts and libdevice, bound to their
  torch forms) must equal it too.
Values compare where valid (validity exactly), integers and strings
exactly, doubles to 1e-9 relative with NaN equal to NaN and the sign of
zero kept. Every filter and project step of the 22 TPC-H queries at
`tiny` (captured from the port's planner) must lower with no uncovered
node, its text must parse, and two literal variants of one tree must give
the same text.
"""

import ast
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from trino_tpu_torch.exec import LocalQueryRunner
from trino_tpu_torch.expr import compiler as C
from trino_tpu_torch.expr import kernel_gen as K
from trino_tpu_torch.expr import triton_lib
from trino_tpu_torch.expr.hoist import hoist_literal_seq

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_corpus", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)     # defines, runs nothing
    return module


CS = _load_chip_smoke()
_NAMES = CS.corpus_page("cpu")[1]
CORPUS = {name: (mode, expr) for name, mode, expr in CS.expr_corpus(_NAMES)}


@pytest.fixture(scope="module")
def corpus_page():
    return CS.corpus_page("cpu")[0]


# --------------------------------------------- a torch stand-in for Triton

class _Ptr:
    """A pointer into a tensor's flat storage (a list plane [cap, L] is
    addressed row-major, as on the card)."""

    def __init__(self, t, off=None):
        self.t, self.off = t.view(-1) if t.dim() > 1 else t, off

    def __add__(self, off):
        return _Ptr(self.t, off)


def _as_tensor(v, like=None):
    if isinstance(v, torch.Tensor):
        return v
    if like is not None and isinstance(like, torch.Tensor):
        return torch.tensor(v, dtype=like.dtype)
    if isinstance(v, bool):
        return torch.tensor(v)
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64)
    return torch.tensor(v, dtype=torch.float32)


class _TL(types.SimpleNamespace):
    """The parts of triton.language the generated text and triton_lib's
    helpers use, as torch ops on one program's block of rows."""

    int1, int8, int16, int32 = torch.bool, torch.int8, torch.int16, \
        torch.int32
    int64, float32, float64 = torch.int64, torch.float32, torch.float64
    constexpr = int
    PropagateNan = types.SimpleNamespace(ALL=1, NONE=0)
    pid = 0

    def program_id(self, axis):
        return torch.tensor(self.pid, dtype=torch.int32)

    @staticmethod
    def arange(a, b):
        return torch.arange(a, b, dtype=torch.int32)

    @staticmethod
    def load(ptr, mask=None, other=None):
        t, off = ptr.t, ptr.off
        if off is None:
            return t.reshape(())
        if isinstance(off, int):
            return t[off]
        vals = t[off.clamp(0, t.numel() - 1)]
        if mask is not None:
            vals = torch.where(mask, vals,
                               torch.tensor(other or 0, dtype=t.dtype))
        return vals

    @staticmethod
    def store(ptr, val, mask=None):
        idx = ptr.off[mask]
        ptr.t[idx] = torch.broadcast_to(val, ptr.off.shape)[mask].to(
            ptr.t.dtype)

    @staticmethod
    def where(c, a, b):
        if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            a = _as_tensor(a, b)
        if not isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
            b = _as_tensor(b, a)
        return torch.where(c, _as_tensor(a), _as_tensor(b))

    @staticmethod
    def minimum(a, b, propagate_nan=None):
        b = _as_tensor(b, a)
        return torch.minimum(a, b)

    @staticmethod
    def maximum(a, b, propagate_nan=None):
        b = _as_tensor(b, a)
        return torch.maximum(a, b)

    @staticmethod
    def abs(x):
        return torch.abs(x)

    @staticmethod
    def broadcast_to(x, shape):
        return torch.broadcast_to(_as_tensor(x), tuple(shape))

    @staticmethod
    def static_range(*n):
        return range(*n)

    @staticmethod
    def full(shape, value, dtype):
        return torch.full(tuple(shape), value, dtype=dtype)


def _div_trunc(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def _lshr(a, s):
    s = torch.as_tensor(s)
    keep = (torch.ones_like(s) << (64 - s).clamp(max=63)) - 1
    keep = torch.where(s == 1, torch.full_like(s, (1 << 63) - 1), keep)
    return torch.where(s == 0, a, (a >> s) & keep)


def _libdevice(fn):
    """A libdevice function: like Triton's, it takes float tensors only,
    all of one dtype (a Python float constant is float32 there)."""
    def call(*args):
        dts = {a.dtype if isinstance(a, torch.Tensor) else "python float"
               for a in args}
        assert len(dts) == 1 and next(iter(dts)) in (
            torch.float32, torch.float64), f"libdevice over {dts}"
        return fn(*args)
    return call


_INTRINSICS = {
    "_idiv": _div_trunc, "_irem": torch.fmod, "_lshr64": _lshr,
    "_lshr_c": _lshr, "_bits_f64": lambda x: x.view(torch.float64),
    "_not": lambda x: ~x,
    "_max": lambda a, b: torch.maximum(a, _as_tensor(b, a)),
    "_min": lambda a, b: torch.minimum(a, _as_tensor(b, a)),
    **{f"_{n}": _libdevice(getattr(torch, n)) for n in (
        "floor", "ceil", "trunc", "sqrt", "pow", "exp", "log", "log10",
        "log2", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
        "tanh", "atan2", "fmod")},
}


def test_intrinsics_are_exactly_triton_libs():
    assert set(_INTRINSICS) == set(triton_lib.INTRINSICS)


def _jit(fn=None, **_):
    return fn if fn is not None else (lambda f: f)


class _TritonMinus(ast.NodeTransformer):
    """Triton's unary minus of a value is 0 - x (so -(0.0) is +0.0)."""

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.USub) and \
                not isinstance(node.operand, ast.Constant):
            return ast.BinOp(ast.Constant(0), ast.Sub(), node.operand)
        return node


class ShimKernel:
    """The generated kernel file's text (header aside) run under the
    stand-in, launched as Triton launches it: kernel[grid](*args, ...)."""

    def __init__(self, comp):
        self.tl = _TL()
        self.env = {"tl": self.tl, "triton": types.SimpleNamespace(jit=_jit),
                    "libdevice": None}
        tree = _TritonMinus().visit(ast.parse(comp.text.split(K.HEADER,
                                                              1)[1]))
        exec(compile(ast.fix_missing_locations(tree), "<k11>", "exec"),
             self.env)
        self.env.update(_INTRINSICS)

    def __getitem__(self, grid):
        def launch(*args, BLOCK, num_warps=None):
            args = [_Ptr(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in range(grid[0]):
                self.tl.pid = pid
                self.env["k11"](*args, BLOCK=BLOCK)
        return launch


def run_text(comp, page, ops, tables, outs, cap):
    """One launch of the step's kernel text under the stand-in."""
    args = [ops, page.num_rows, cap] + K.launch_inputs(comp.prog, page)
    args += list(tables) + list(outs)
    ShimKernel(comp)[(-(-cap // K.BLOCK),)](*args, BLOCK=K.BLOCK)


def kernel_outputs(step, page, params):
    """The step's K11 outputs on a CPU page: (Program outputs by the torch
    evaluator, the same from the text under the stand-in)."""
    comp = step.compiled(page, params)
    prog = comp.prog
    inv = step._inv_eval(params)
    b = K.bind(prog, page, params, inv)
    evaluated = K.evaluate(prog, page, b)
    ops = torch.tensor(b.slots + comp.const_bits + [0], dtype=torch.int64)
    cap = page.capacity
    made = iter(K.output_tensors(prog, cap, page.device))
    outs, results = [], []
    for o in prog.outputs:
        if o.kind != "kernel":
            results.append(None)
            continue
        got = tuple(None if t is None else t.zero_() for t in next(made))
        outs += [t for t in got if t is not None]
        results.append(got[:2])
    run_text(comp, page, ops, [t for t in b.tables], outs, cap)
    return prog, b, evaluated, results


def _same_values(got, want, valid, n, what):
    got, want = got[:n], want[:n]
    if valid is not None:
        valid = valid[:n]
        got, want = got[valid], want[valid]
    if got.dtype.is_floating_point:
        g64, w64 = got.double(), want.double()
        both_nan = torch.isnan(g64) & torch.isnan(w64)
        close = (g64 == w64) | ((g64 - w64).abs()
                               <= 1e-9 * torch.maximum(g64.abs(), w64.abs()))
        zero_sign = (w64 != 0) | (torch.signbit(g64) == torch.signbit(w64))
        bad = ~(both_nan | (close & zero_sign))
    else:
        bad = got != want
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} rows differ, first "
        f"{got[bad][:5].tolist()} vs {want[bad][:5].tolist()}")


def check_step(step, page, params, name):
    """Both K11 forms of the step against the plain compiler."""
    n = int(page.num_rows)
    prog, b, evaluated, ran = kernel_outputs(step, page, params)
    want = step.plain(page, params)
    text_parses = ast.parse(step.compiled(page, params).text)
    assert text_parses is not None
    if step.mode == "filter":
        o = prog.outputs[0]
        if o.kind == "kernel":
            e = evaluated[0]
            ev = e.value if e.valid is None else e.value & e.valid
            _same_values(ev, want, None, n, f"{name} (Program)")
            _same_values(ran[0][0], want, None, n, f"{name} (kernel text)")
        return
    for j, (o, w) in enumerate(zip(prog.outputs, want)):
        if o.kind != "kernel":
            continue
        wv = w.valid
        for label, (v, m) in (("Program", (evaluated[j].value,
                                           evaluated[j].valid)),
                              ("kernel text", ran[j])):
            what = f"{name} output {j} ({label})"
            v = v.expand(page.capacity) if v.dim() == 0 else v
            mv = m.expand(page.capacity) if m is not None and m.dim() == 0 \
                else m
            if wv is None:
                assert mv is None or bool(mv[:n].all()), what
            else:
                wvv = wv.expand(page.capacity) if wv.dim() == 0 else wv
                got_valid = torch.ones(n, dtype=torch.bool) if mv is None \
                    else mv[:n]
                assert torch.equal(got_valid, wvv[:n]), f"{what}: validity"
            valid = None if wv is None else (wv.expand(page.capacity)
                                             if wv.dim() == 0 else wv)
            wvals = w.values.expand(page.capacity) if w.values.dim() == 0 \
                else w.values
            if w.dictionary is not None:
                d = b.dicts[o.pair.dict]
                assert d == w.dictionary, f"{what}: dictionary"
            _same_values(v, wvals, valid, n, what)


@pytest.mark.parametrize("hoist", [False, True], ids=["literal", "hoisted"])
@pytest.mark.parametrize("case", sorted(CORPUS))
def test_corpus_case_matches_the_plain_compiler(corpus_page, case, hoist):
    mode, expr = CORPUS[case]
    exprs, params = (expr,), ()
    if hoist:
        exprs, params = hoist_literal_seq(exprs)
    step = K.ExprStep(exprs, mode)
    check_step(step, corpus_page, params, case)


def test_corpus_covers_every_scalar_and_form():
    """Every registered scalar with a Triton emission appears in the
    corpus, and every scalar has an emission."""
    from trino_tpu_torch.expr import functions as F
    from trino_tpu_torch.expr.ir import Call, SpecialForm

    seen, kinds = set(), set()

    def visit(e):
        if isinstance(e, Call):
            seen.add(e.name)
        if isinstance(e, SpecialForm):
            kinds.add(e.kind.name)
        for ch in e.children():
            visit(ch)
    for _, expr in CORPUS.values():
        visit(expr)
    assert set(F._SCALARS) <= set(F._EMITS)
    assert set(F._SCALARS) <= seen
    assert kinds == {"AND", "OR", "NOT", "IS_NULL", "COALESCE", "IF",
                     "SWITCH", "IN", "BETWEEN"}


@pytest.mark.parametrize("fn", ["sin", "cos", "tan", "asin", "acos", "atan",
                                "sinh", "cosh", "tanh"])
def test_trig_function_matches_the_plain_compiler(corpus_page, fn):
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr.ir import Call, InputRef
    names = _NAMES
    arg = InputRef(names.index("y" if fn in ("asin", "acos") else "x"),
                   T.DOUBLE)
    if fn in ("asin", "acos"):
        arg = Call("divide", (arg, InputRef(names.index("y"), T.DOUBLE)),
                   T.DOUBLE)
    step = K.ExprStep((Call(fn, (arg,), T.DOUBLE),), "project")
    check_step(step, corpus_page, (), fn)


def test_all_corpus_cases_in_one_kernel(corpus_page):
    """chip_smoke.py runs the corpus as a few wide project steps: one
    kernel holding many outputs must give each the same as alone."""
    exprs = tuple(e for m, e in CORPUS.values() if m == "project")[:40]
    exprs, params = hoist_literal_seq(exprs)
    check_step(K.ExprStep(exprs, "project"), corpus_page, params, "wide")


# ----------------------------------------- test_torch_expr.py's cases

def _expr_cases():
    import test_torch_expr as TE
    return TE


@pytest.mark.parametrize("hoist", [False, True], ids=["literal", "hoisted"])
@pytest.mark.parametrize("case", sorted(_expr_cases().CASES))
def test_expr_case_matches_the_plain_compiler(case, hoist):
    TE = _expr_cases()
    build, kind = TE.CASES[case]
    expr = build(TE.PORT)
    params = ()
    if hoist:
        expr, params = TE.PH.hoist_literals(expr)
    page = TE.make_page(TE.PORT)
    mode = "filter" if kind == "filter" else "project"
    check_step(K.ExprStep((expr,), mode), page, params, case)


# --------------------------------------------- the TPC-H steps at tiny

@pytest.fixture(scope="module")
def tpch_steps():
    """Every (step, page, params) the 22 queries hand a filter or project
    step at tiny, first call of each step."""
    from tpch_sql import QUERIES
    seen = {}
    real = K.ExprStep.__call__

    def record(self, page, params=()):
        seen.setdefault(id(self), (self, page, params))
        return real(self, page, params)
    K.ExprStep.__call__ = record
    try:
        runner = LocalQueryRunner.tpch("tiny", device="cpu")
        for name in sorted(QUERIES, key=lambda q: int(q[1:])):
            runner.execute(QUERIES[name][0])
    finally:
        K.ExprStep.__call__ = real
    return list(seen.values())


def test_every_tpch_step_lowers_and_parses(tpch_steps):
    assert len(tpch_steps) > 40
    modes = {s.mode for s, _, _ in tpch_steps}
    assert modes == {"filter", "project"}
    for step, page, params in tpch_steps:
        comp = step.compiled(page, params)   # raises on an uncovered node
        ast.parse(comp.text)
        check_step(step, page, params, repr(step.exprs)[:80])


def test_literal_variants_share_one_kernel_text():
    """q6 with other literals: the same canonical tree, key and text."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr.ir import (Call, InputRef, Literal,
                                         SpecialForm, SpecialKind)
    from trino_tpu_torch.page import Page
    D = T.DecimalType(12, 2)
    page = Page.from_numpy([np.arange(8, dtype=np.int32),
                            np.arange(8, dtype=np.int64),
                            np.arange(8, dtype=np.int64)],
                           [T.DATE, D, D], device="cpu")

    def q6(lo, disc, qty):
        return SpecialForm(SpecialKind.AND, (
            Call("ge", (InputRef(0, T.DATE), Literal(lo, T.DATE)),
                 T.BOOLEAN),
            SpecialForm(SpecialKind.BETWEEN, (InputRef(1, D),
                                              Literal(disc - 1, D),
                                              Literal(disc + 1, D)),
                        T.BOOLEAN),
            Call("lt", (InputRef(2, D), Literal(qty, D)), T.BOOLEAN)),
            T.BOOLEAN)
    texts = set()
    for lits in ((8766, 6, 2400), (9131, 7, 2500), (8035, 2, 100)):
        (canon,), params = hoist_literal_seq((q6(*lits),))
        texts.add(K.ExprStep((canon,), "filter").compiled(page, params).text)
    assert len(texts) == 1
    text = texts.pop()
    for v in ("8766", "9131", "2400", "2500"):
        assert v not in text


def test_uncovered_node_raises_at_build():
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr.ir import Call, InputRef
    from trino_tpu_torch.page import Page
    page = Page.from_numpy([np.arange(4, dtype=np.int64)], [T.BIGINT],
                           device="cpu")
    step = K.ExprStep((Call("cardinality", (InputRef(0, T.BIGINT),),
                            T.BIGINT),), "project")
    with pytest.raises(NotImplementedError, match="cardinality"):
        step.compiled(page, ())


def test_plain_compiler_counts_no_cuda_steps_on_the_cpu(corpus_page):
    before = C.cuda_evaluations
    mode, expr = CORPUS["add_bigint_int"]
    K.ExprStep((expr,), mode)(corpus_page, ())
    assert C.cuda_evaluations == before


@pytest.fixture(scope="module")
def tiny_runner():
    return LocalQueryRunner.tpch("tiny", device="cpu")


def _rows_close(got, want) -> bool:
    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return x == y or (x != x and y != y) or \
                abs(x - y) <= 1e-9 * max(abs(x), abs(y))
        return x == y
    return len(got) == len(want) and all(
        len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        for a, b in zip(got, want))


@pytest.mark.parametrize("query", [f"q{i}" for i in range(1, 23)])
def test_query_through_k11_gives_the_plain_rows(tiny_runner, query,
                                                monkeypatch):
    """A TPC-H query at tiny with every filter and project step taken
    through expr_step_cuda (binding, operand buffer, outputs, aliases and
    broadcasts) and its kernel text run under the stand-in: the rows of
    the plain run."""
    from tpch_sql import QUERIES
    sql = QUERIES[query][0]
    want = tiny_runner.execute(sql).rows
    launches = K.expr_step_cuda.launches
    monkeypatch.setattr(K.ExprStep, "__call__",
                        lambda self, page, params=():
                        K.expr_step_cuda(self, page, params))
    monkeypatch.setattr(K._Compiled, "kernel",
                        lambda self: ShimKernel(self))
    got = tiny_runner.execute(sql).rows
    assert K.expr_step_cuda.launches > launches
    assert _rows_close(got, want)
