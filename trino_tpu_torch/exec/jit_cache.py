"""Module-scope built-pipeline cache.

Port of `trino_tpu/exec/jit_cache.py`. The reference caches one jitted
page kernel per lowered expression tree / operator spec; PyTorch runs
eagerly, so the entry here is the built Python closure (compiled
expression functions, composed chains, operator factories). The key is
the same literal-free canonical tree (expr/hoist.py): hoisted literal
values ride in per call as `params`, so every literal variant of a query
shape reuses one entry. A hit whose parameter values changed since the
last call of that key counts as a *param hit*.

K11's generated kernels (expr/kernel_gen.py) live here too, one entry per
key ("k11", step mode, the canonical trees, each input column's index,
dtype, validity and dictionary presence, the output dtypes): the same key
always gives the same kernel text, and no literal value is part of it.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Hashable, Optional, Tuple

import numpy as np

# key -> [built callable, last-seen flattened param signature or None]
_CACHE: "collections.OrderedDict[Hashable, list]" = \
    collections.OrderedDict()
_LOCK = threading.RLock()   # reentrant: a build() may consult the cache
_MAX_KERNELS = 512
_STATS = {"hits": 0, "misses": 0, "param_hits": 0, "evictions": 0}


def _param_signature(params) -> Tuple:
    """Flatten a (possibly nested) tuple of scalar/vector arrays into a
    comparable value signature (shape + raw bytes per entry)."""
    out = []

    def visit(p):
        if isinstance(p, (tuple, list)):
            for x in p:
                visit(x)
        else:
            a = np.asarray(p)
            out.append((a.dtype.str, a.shape, a.tobytes()))
    visit(params)
    return tuple(out)


def cached_kernel(key: Hashable, build: Callable[[], Callable],
                  params: Optional[Any] = None) -> Callable:
    """Return the built callable for `key`, building it on first use.

    `build()` must construct the callable purely from information encoded
    in `key`, so a cache hit is always correct. `params`, when given, is
    the runtime literal tuple the caller will pass — used only to count
    param hits, never for keying."""
    sig = None if params is None else _param_signature(params)
    with _LOCK:
        entry = _CACHE.get(key)
        if entry is None:
            fn = build()
            while len(_CACHE) >= _MAX_KERNELS:
                _CACHE.popitem(last=False)
                _STATS["evictions"] += 1
            entry = _CACHE[key] = [fn, sig]
            _STATS["misses"] += 1
        else:
            _CACHE.move_to_end(key)
            _STATS["hits"] += 1
            if sig is not None:
                if entry[1] is not None and entry[1] != sig:
                    _STATS["param_hits"] += 1
                entry[1] = sig
    return entry[0]


def stats() -> dict:
    """Resident entries + lifetime hits/misses/param-hits/evictions."""
    with _LOCK:
        return {"size": len(_CACHE), **_STATS}

