"""Build and bind the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), is
compiled by `nvcc` for `sm_90a` into a shared library at first use, and is
bound with `ctypes`: every pointer and the stream travel as `c_void_p`,
every size as `c_int64`. The build directory `_build/` beside this file is
keyed by a hash of the source, the headers and the flags, so an edited
kernel rebuilds and an unchanged one loads in milliseconds.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every CUDA source of the package (Triton kernels build through triton)
SOURCES = ("compact", "concat", "direct_agg", "gather", "join_build",
           "join_probe", "join_expand", "join_mxu", "group_agg", "sort",
           "tpch_gen", "join_spill", "spill_part", "window", "special_agg",
           "list", "exchange")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, f"{name}.cu")
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256()
    for path in (src, *headers):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start `nvcc` for one source unless its library is already built;
    returns (process, temporary output path) or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp,
           os.path.join(_CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source in parallel (one `nvcc` each, all
    started together); returns each build's compiler log (registers,
    shared memory and spills from `-Xptxas -v`)."""
    names = tuple(names)
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        try:
            return {n: _finish_build(n, s) for n, s in started.items()}
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return lib


TABLE_MAX = 2048   # entries of a launcher's by-value table (common.cuh)


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaGetLastError(), or
    -1 for a pointer table past TABLE_MAX entries."""
    if rc == -1:
        raise ValueError(f"{what}: more columns/pages than one launch's "
                         f"table holds ({TABLE_MAX} entries)")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
