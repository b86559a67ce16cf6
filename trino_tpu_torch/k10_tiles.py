"""Times K10's multi-block passes (csrc/sort.cu) at other tile sizes.

A tile is 256 threads of PASS_IPT keys. For each PASS_IPT given, a copy of
the package with PASS_IPT (csrc/sort.cu) and SORT_TILE (ops/sort.py)
rewritten is made under `_build/tiles/` and timed in its own process at
the two large shapes that chip_smoke.py's phase 4 times: W2's window sort
(5,999,956 live rows of 8,388,608, keys BIGINT, BIGINT, INTEGER as
l_partkey, l_orderkey, l_linenumber at sf1) and the u64 sort of 8,388,608
random words, each beside torch.sort(stable=True) of the same data (CUDA
events, median of 20 calls after 3). Needs the card:

    python3 -m trino_tpu_torch.k10_tiles 8 12 16
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))

_TIMING = r'''
import statistics
import numpy as np
import torch
from trino_tpu_torch import native, types as T
from trino_tpu_torch.ops import sort as S
from trino_tpu_torch.page import Page, row_count

def ms(fn):
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

dev = torch.device("cuda")
native.build_all(("sort",))
rng = np.random.default_rng(1)
cap, n = 8_388_608, 5_999_956
cols = [rng.integers(1, 200_001, cap).astype(np.int64),
        rng.integers(1, 6_000_001, cap).astype(np.int64),
        rng.integers(1, 8, cap).astype(np.int32)]
page = Page.from_numpy(cols, [T.BIGINT, T.BIGINT, T.INTEGER], device=dev)
page = Page(page.columns, row_count(n, dev))
keys = [S.SortKey(0), S.SortKey(1), S.SortKey(2)]
got, want = S.sort_rows_cuda(page, keys), S.sort_rows_plain(page, keys)
assert torch.equal(got[:n].to(torch.int64), want[:n])
word = S.encode_sort_keys(page, keys)[-1][:n].contiguous()
lo = -(1 << 63)
u64 = torch.randint(lo, -lo - 1, (cap,), dtype=torch.int64,
                    generator=torch.Generator().manual_seed(3)).to(dev)
assert torch.equal(S.sort_u64_cuda(u64),
                   torch.sort(u64 ^ lo, stable=True).values ^ lo)
flipped = u64 ^ lo
print(f"tile {S.SORT_TILE}: W2's sort "
      f"{ms(lambda: S.sort_rows_cuda(page, keys)):.4f} ms (torch.sort of "
      f"one word {ms(lambda: torch.sort(word, stable=True)):.4f}), u64 sort "
      f"{ms(lambda: S.sort_u64_cuda(u64)):.4f} ms (torch.sort "
      f"{ms(lambda: torch.sort(flipped, stable=True)):.4f})", flush=True)
'''


def variant(ipt: int) -> str:
    """A copy of the package with PASS_IPT = ipt; returns its root."""
    root = os.path.join(_PKG, "_build", "tiles", f"ipt{ipt}")
    dst = os.path.join(root, "trino_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns("_build"))
    for rel, pattern, repl in (
            ("csrc/sort.cu", r"constexpr int PASS_IPT = \d+;",
             f"constexpr int PASS_IPT = {ipt};"),
            ("ops/sort.py", r"SORT_TILE = \d+", f"SORT_TILE = {256 * ipt}")):
        path = os.path.join(dst, rel)
        with open(path) as f:
            text, count = re.subn(pattern, repl, f.read())
        if count != 1:
            raise RuntimeError(f"{rel}: {pattern} not found once")
        with open(path, "w") as f:
            f.write(text)
    return root


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for ipt in [int(a) for a in argv] or [8, 12, 16]:
        root = variant(ipt)
        try:
            out = subprocess.run([sys.executable, "-c", _TIMING], cwd=root,
                                 capture_output=True, text=True,
                                 timeout=600)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"PASS_IPT {ipt}: " + (out.stdout.strip() or out.stderr[-2000:]),
              flush=True)
        if out.returncode:
            return out.returncode
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card or torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
