"""The port stands alone: trino_tpu_torch (and chip_smoke.py) import
neither jax nor trino_tpu, run q6, q3 and q13 with both made
unimportable, and refuse to start on a missing CUDA device unless the
caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import trino_tpu_torch

torch.set_num_threads(1)

_PKG = pathlib.Path(trino_tpu_torch.__file__).parent
_REPO = _PKG.parent
FORBIDDEN = ("jax", "jaxlib", "trino_tpu")


def _sources():
    # _build/ holds what the package builds at run time, not its sources
    files = sorted(p for p in _PKG.rglob("*.py")
                   if "_build" not in p.relative_to(_PKG).parts) + \
        [_REPO / "chip_smoke.py"]
    return [str(p.relative_to(_REPO)) for p in files]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_inventory_covers_the_slice():
    files = set(_sources())
    for rel in ("trino_tpu_torch/page.py", "trino_tpu_torch/ops/aggregate.py",
                "trino_tpu_torch/ops/join.py",
                "trino_tpu_torch/exec/local_planner.py",
                "trino_tpu_torch/exec/runner.py",
                "trino_tpu_torch/connector/tpch_gen.py", "chip_smoke.py"):
        assert rel in files
    # every CUDA source native.py builds is in the package, and no source
    # of csrc/ is left out of the build
    from trino_tpu_torch import native
    cu = {p.stem for p in (_PKG / "csrc").glob("*.cu")}
    assert cu == set(native.SOURCES)
    assert {"gather", "join_build", "join_probe", "join_expand",
            "group_agg"} <= cu


@pytest.mark.parametrize("rel", _sources())
def test_no_jax_or_reference_import(rel):
    roots = set(_imported_roots(_REPO / rel))
    assert not roots & set(FORBIDDEN), f"{rel} imports {roots & set(FORBIDDEN)}"


_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "trino_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(1)
    from trino_tpu_torch.exec import LocalQueryRunner
    runner = LocalQueryRunner.tpch("tiny", device="cpu")
    rows = runner.execute(sys.argv[1]).rows
    assert not any(m.split(".")[0] in ("jax", "trino_tpu")
                   for m in sys.modules), "reference module loaded"
    print(rows)
""")


def _run_blocked(name: str) -> None:
    """Run one TPC-H query through the port in a process where jax and
    trino_tpu cannot be imported; its rows must be the reference's."""
    from tpch_sql import QUERIES
    sql = QUERIES[name][0]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, sql],
                         cwd=str(_REPO), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    from trino_tpu.exec import LocalQueryRunner as RefRunner
    want = RefRunner.tpch("tiny").execute(sql).rows
    assert out.stdout.strip().splitlines()[-1] == str(want)


def test_q6_runs_with_jax_and_reference_unimportable():
    _run_blocked("q6")


def test_q3_runs_with_jax_and_reference_unimportable():
    """The join path (the K5-K8 twins) imports nothing of JAX either."""
    _run_blocked("q3")


def test_q13_runs_with_jax_and_reference_unimportable():
    """The expanding probe (K5 runs mode and K9's twins, a LEFT join)
    imports nothing of JAX either."""
    _run_blocked("q13")


def test_default_device_is_cuda():
    from trino_tpu_torch.exec import LocalQueryRunner
    if torch.cuda.is_available():
        assert LocalQueryRunner.tpch("tiny").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalQueryRunner.tpch("tiny")
    assert LocalQueryRunner.tpch("tiny", device="cpu").device.type == "cpu"
