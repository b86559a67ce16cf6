"""Columnar Page/Column data model over torch tensors.

Port of `trino_tpu/page.py`. A Column is a device value tensor plus an
optional bool validity tensor; strings are dictionary-encoded (int32 codes
on the device, the sorted string pool on the host). A Page is a tuple of
equal-capacity Columns plus `num_rows`, a 0-d int32 tensor on the page's
device: rows in [num_rows, capacity) are padding whose contents are
undefined, so every consumer masks with `row_mask()`.

Three device kernels live here, each beside its plain PyTorch twin:

* K1 `compact_rows` (Page.filter): stable compaction of the live rows where
  a mask is true, `csrc/compact.cu`; its range mode `compact_range` keeps
  the rows whose key lies in [lo, hi] (the join's dynamic filter,
  range_prefilter) without building the mask first.
* K2 `concat_rows` (device_concat): the live prefixes of N pages packed at
  device-side running offsets, `csrc/concat.cu`.
* K7 `gather_rows` (Column.gather / Page.gather, and the join's
  attach_build): every array of a page gathered at one index vector,
  clipped to the ends, `csrc/gather.cu`.

The public constructors (`Column.from_numpy`, `Page.from_numpy`,
`page_from_host`, `union_dictionaries`) place their tensors on `cuda`
unless the caller names a device, as the runner does.

A list column (ARRAY, MAP) carries element planes: `values` is
[capacity, L], row-major, `lengths` the live element count per row, and a
MAP's values ride in `aux` beside its keys (the reference's layout). K32,
the plane mode of K1, K7 and K2, moves a plane as one array of rows of
element size x L bytes in the same launch as the page's other arrays.
Element NULLs are not represented: `ARRAY[x, NULL]` is NULL as a whole.

A wrapper takes its plain twin only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import itertools
import operator
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T

_dict_ids = itertools.count()


class Dictionary:
    """Host-side sorted string pool backing a dictionary-encoded column.

    Codes index `values` (ascending), so integer comparison of codes is
    string comparison of values. Equality and hashing key on a content
    fingerprint, so byte-identical pools are interchangeable."""

    __slots__ = ("values", "id", "_table_cache", "_fp")

    def __init__(self, values: np.ndarray):
        import hashlib
        values = np.asarray(values, dtype=object)
        h = hashlib.blake2b(digest_size=16)
        prev = None
        for s in values:
            if prev is not None and not (prev <= s):
                raise ValueError("dictionary must be sorted")
            prev = s
            b = s.encode("utf-8", "surrogatepass") \
                if isinstance(s, str) else repr(s).encode()
            h.update(len(b).to_bytes(4, "little"))
            h.update(b)
        self.values = values
        self.id = next(_dict_ids)
        self._fp = h.digest()

    @property
    def fingerprint(self) -> bytes:
        return self._fp

    @classmethod
    def build(cls, strings: Sequence[str]) -> Tuple["Dictionary", np.ndarray]:
        """Encode `strings` -> (dictionary, int32 codes)."""
        uniq, codes = np.unique(np.asarray(strings, dtype=object),
                                return_inverse=True)
        return cls(uniq), codes.astype(np.int32)

    def code_of(self, s: str) -> int:
        """Exact-match lookup; -1 if absent (used to fold literals)."""
        i = int(np.searchsorted(self.values, s))
        if i < len(self.values) and self.values[i] == s:
            return i
        return -1

    def lower_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="left"))

    def upper_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="right"))

    def encode(self, strings: np.ndarray) -> np.ndarray:
        """Map strings -> int32 codes; raises KeyError if any is absent."""
        arr = np.asarray(strings, dtype=object)
        if len(self.values) == 0:
            if len(arr) == 0:
                return np.empty(0, dtype=np.int32)
            raise KeyError("value(s) not present in dictionary")
        codes = np.searchsorted(self.values, arr).astype(np.int32)
        codes = np.minimum(codes, len(self.values) - 1)
        if not np.array_equal(self.values[codes], arr):
            raise KeyError("value(s) not present in dictionary")
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out

    def __len__(self):
        return len(self.values)

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Dictionary):
            return NotImplemented
        return self.fingerprint == other.fingerprint

    def __repr__(self):  # pragma: no cover
        return f"Dictionary(id={self.id}, n={len(self.values)})"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another; raises when CUDA is wanted but absent (never quietly
    carries on on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class Column:
    """One columnar vector: values [capacity] (+ bool validity); for a
    list column values [capacity, L] element planes, lengths int32
    [capacity], and a MAP's value plane `aux` (its dictionary
    `aux_dictionary`)."""

    values: torch.Tensor
    valid: Optional[torch.Tensor]
    type: T.Type
    dictionary: Optional[Dictionary] = None
    lengths: Optional[torch.Tensor] = None
    aux: Optional[torch.Tensor] = None
    aux_dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.valid

    def gather(self, indices: torch.Tensor) -> "Column":
        """copyPositions analog; out-of-range indices clip to the ends
        (K7)."""
        return _rebuild((self,), gather_rows(_movable(self), indices))[0]

    def with_valid(self, valid: Optional[torch.Tensor]) -> "Column":
        return dataclasses.replace(self, valid=valid)

    @property
    def is_list(self) -> bool:
        return self.lengths is not None

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in _movable(self))

    @classmethod
    def from_numpy(cls, data: np.ndarray, typ: T.Type,
                   valid: Optional[np.ndarray] = None,
                   dictionary: Optional[Dictionary] = None,
                   device=None) -> "Column":
        device = resolve_device(device)
        if T.is_string(typ) and dictionary is None:
            dictionary, codes = Dictionary.build(data)
            data = codes
        arr = _to_device(np.asarray(data, dtype=T.to_numpy_dtype(typ)),
                         device)
        v = None if valid is None else _to_device(
            np.asarray(valid, dtype=np.bool_), device)
        return cls(arr, v, typ, dictionary)

    def to_numpy(self, num_rows: Optional[int] = None) -> np.ndarray:
        n = self.capacity if num_rows is None else int(num_rows)
        return Page((self,), row_count(n, self.device)).to_host(n)[0]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Stage a host array to `device` (through pinned memory for CUDA)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone() if dev.type == "cpu" else t.to(dev)


def device_scalar(value, dtype, device) -> torch.Tensor:
    """A host scalar as a 0-d tensor on `device`, filled there: a copy
    from pageable host memory would first wait for the whole stream."""
    return torch.full((), value, dtype=dtype, device=device)


def row_count(n, device) -> torch.Tensor:
    """A live-row count as a 0-d int32 tensor on `device`."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(())
    return device_scalar(int(n), torch.int32, device)


@dataclasses.dataclass
class Page:
    """Horizontal batch of Columns + a device-side live-row count."""

    columns: Tuple[Column, ...]
    num_rows: torch.Tensor

    def __post_init__(self):
        self.columns = tuple(self.columns)
        dev = self.columns[0].device if self.columns else (
            self.num_rows.device if isinstance(self.num_rows, torch.Tensor)
            else torch.device("cpu"))
        if not (isinstance(self.num_rows, torch.Tensor)
                and self.num_rows.dtype == torch.int32
                and self.num_rows.dim() == 0
                and self.num_rows.device == dev):
            self.num_rows = row_count(self.num_rows, dev)

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> Column:
        return self.columns[i]

    def row_mask(self) -> torch.Tensor:
        """Mask of live rows ([0, num_rows))."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def append_column(self, col: Column) -> "Page":
        return Page(self.columns + (col,), self.num_rows)

    def select_columns(self, indices: Sequence[int]) -> "Page":
        return Page(tuple(self.columns[i] for i in indices), self.num_rows)

    def filter(self, mask: torch.Tensor) -> "Page":
        """Compact live rows where mask is true (Page.getPositions
        analog): selected rows move to the front in order, num_rows
        becomes their count, capacity stays. Runs K1."""
        return compact_rows(self, mask)

    def gather(self, indices: torch.Tensor, count) -> "Page":
        """Every column at `indices` (clipped to the ends) in one K7
        launch; `count` becomes num_rows."""
        moved = gather_rows([a for c in self.columns for a in _movable(c)],
                            indices)
        return Page(_rebuild(self.columns, moved),
                    row_count(count, self.device))

    def shrink_to(self, capacity: int) -> "Page":
        """Slice every column to a smaller capacity (live rows are a
        prefix; the caller knows num_rows <= capacity)."""
        if capacity >= self.capacity:
            return self
        cols = tuple(_rebuild((c,), [a[:capacity] for a in _movable(c)])[0]
                     for c in self.columns)
        return Page(cols, self.num_rows)

    def pad_to(self, capacity: int) -> "Page":
        """Grow capacity without changing live rows."""
        if capacity < self.capacity:
            raise ValueError("pad_to cannot shrink")
        if capacity == self.capacity:
            return self
        cols = []
        for c in self.columns:
            grown = []
            for a in _movable(c):
                g = torch.zeros((capacity,) + tuple(a.shape[1:]),
                                dtype=a.dtype, device=a.device)
                g[:self.capacity] = a
                grown.append(g)
            cols.append(_rebuild((c,), grown)[0])
        return Page(tuple(cols), self.num_rows)

    @classmethod
    def from_numpy(cls, arrays: Sequence[np.ndarray], typs: Sequence[T.Type],
                   valids: Optional[Sequence[Optional[np.ndarray]]] = None,
                   dictionaries: Optional[Sequence[Optional[Dictionary]]]
                   = None, device=None) -> "Page":
        device = resolve_device(device)
        n = len(arrays[0]) if arrays else 0
        valids = valids or [None] * len(arrays)
        dictionaries = dictionaries or [None] * len(arrays)
        cols = tuple(
            Column.from_numpy(a, t, v, d, device=device)
            for a, t, v, d in zip(arrays, typs, valids, dictionaries))
        return cls(cols, row_count(n, device))

    def to_host(self, num_rows: Optional[int] = None) -> list:
        """All columns as decoded host arrays (the reference's row form)."""
        n = int(self.num_rows) if num_rows is None else int(num_rows)
        out = []
        for c in self.columns:
            vals = c.values[:n].cpu().numpy()
            valid = None if c.valid is None else c.valid[:n].cpu().numpy()
            if c.is_list:
                decoded = _decode_lists(c, vals, n)
            elif c.dictionary is not None:
                if valid is not None:
                    # a NULL row's code may lie past the pool (the NULL
                    # group slot of an aggregation): decode valid codes only
                    vals = np.where(valid, vals, -1)
                decoded = c.dictionary.decode(vals)
            else:
                decoded = vals.astype(object)
            if valid is not None:
                decoded = decoded.copy()
                decoded[~valid] = None
            out.append(decoded)
        return out

    def to_pylist(self) -> list:
        n = int(self.num_rows)
        cols = self.to_host(n)
        return [tuple(col[i] for col in cols) for i in range(n)]


def _decode_lists(c: Column, vals: np.ndarray, n: int) -> np.ndarray:
    """A list column's first n rows as Python lists (ARRAY) or dicts
    (MAP) of decoded elements (the reference's Page.to_host)."""
    lengths = c.lengths[:n].cpu().numpy()
    aux = None if c.aux is None else c.aux[:n].cpu().numpy()
    rows = np.empty(n, dtype=object)
    for i in range(n):
        ln = int(lengths[i])
        elems = vals[i, :ln]
        if c.dictionary is not None:
            elems = c.dictionary.decode(elems)
        if aux is None:
            rows[i] = list(elems.tolist())
            continue
        avals = aux[i, :ln]
        if c.aux_dictionary is not None:
            avals = c.aux_dictionary.decode(avals)
        rows[i] = dict(zip(elems.tolist(), avals.tolist()))
    return rows


def page_from_host(arrays: Sequence[np.ndarray],
                   valids: Sequence[Optional[np.ndarray]],
                   pools: Sequence[Optional[Sequence[str]]],
                   typs: Sequence[T.Type], num_rows: int,
                   device=None, lists: Optional[Sequence] = None) -> Page:
    """Build a Page from another engine's page carried across as host
    arrays: raw values (dictionary codes for strings; a list column's
    [rows, L] element plane), validity (or None), and each string
    column's sorted pool. `lists[i]`, for a list column, is (lengths,
    aux plane or None, aux pool or None); None elsewhere. The same bytes
    fed to two engines give the same page."""
    device = resolve_device(device)
    lists = lists or [None] * len(arrays)
    cols = []
    for a, v, pool, t, lst in zip(arrays, valids, pools, typs, lists):
        d = None if pool is None else Dictionary(np.asarray(pool,
                                                            dtype=object))
        if lst is None:
            cols.append(Column.from_numpy(a, t, v, d, device=device))
            continue
        lengths, aux, aux_pool = lst
        cols.append(Column(
            _to_device(np.asarray(a), device),
            None if v is None else _to_device(np.asarray(v, np.bool_),
                                              device),
            t, d, _to_device(np.asarray(lengths, np.int32), device),
            None if aux is None else _to_device(np.asarray(aux), device),
            None if aux_pool is None else Dictionary(
                np.asarray(aux_pool, dtype=object))))
    return Page(tuple(cols), row_count(num_rows, device))


def union_dictionaries(dicts: Sequence[Dictionary], device=None
                       ) -> Tuple[Dictionary, list]:
    """Rebase N dictionaries onto one union pool: (union, [int32 remap
    tensor per input]) with new_code = remap[i][old_code]."""
    device = resolve_device(device)
    union = Dictionary(np.unique(np.concatenate([d.values for d in dicts])))
    remaps = [_to_device(np.searchsorted(union.values, d.values)
                         .astype(np.int32), device) for d in dicts]
    return union, remaps


# ------------------------------------------------------------------ K1


def _movable(c: Column):
    """The arrays a page move carries for one column: values, then the
    validity, lengths and MAP value plane it has (planes are [cap, L])."""
    return [a for a in (c.values, c.valid, c.lengths, c.aux)
            if a is not None]


def _rebuild(page_cols: Sequence[Column], moved: List[torch.Tensor]
             ) -> Tuple[Column, ...]:
    it = iter(moved)
    out = []
    for c in page_cols:
        values = next(it)
        valid = next(it) if c.valid is not None else None
        lengths = next(it) if c.lengths is not None else None
        aux = next(it) if c.aux is not None else None
        out.append(Column(values, valid, c.type, c.dictionary, lengths, aux,
                          c.aux_dictionary))
    return tuple(out)


def row_bytes(a: torch.Tensor) -> int:
    """Bytes of one row of an array: its element size, times L for a
    [cap, L] plane (K32: a plane moves as rows of this many bytes)."""
    return a.element_size() * (a.shape[1] if a.dim() == 2 else 1)


def _movable_shape(a: torch.Tensor, cap: int) -> bool:
    """A [cap] array or a contiguous [cap, L] plane a page move takes."""
    return a.dim() in (1, 2) and a.shape[0] == cap and a.is_contiguous() \
        and (a.dim() == 2 or a.element_size() in (1, 2, 4, 8))


def compact_rows_plain(arrays: Sequence[torch.Tensor], mask: torch.Tensor,
                       num_rows: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain twin of K1: stable compaction of rows `i < num_rows` with
    `mask[i]` (the reference's one stable sort on the drop flag)."""
    cap = mask.shape[0]
    keep = mask & (torch.arange(cap, device=mask.device,
                                dtype=torch.int32) < num_rows)
    count = keep.sum(dtype=torch.int64).to(torch.int32)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return [a[order] for a in arrays], count


def _compact_launch(entry: str, keep_args: list, arrays, num_rows, cap: int,
                    dev) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One K1 launch through csrc/compact.cu's `entry` (its keep-mode
    arguments first, then the common ones)."""
    outs = [torch.empty_like(a) for a in arrays]
    count = torch.empty((), dtype=torch.int32, device=dev)
    table = host_table([a.data_ptr() for a in arrays],
                       [o.data_ptr() for o in outs],
                       [row_bytes(a) for a in arrays])
    nblocks = max(1, -(-cap // COMPACT_TILE))
    scratch = torch.empty(nblocks, dtype=torch.int64, device=dev)
    rc = getattr(native.library("compact"), entry)(
        *keep_args, ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(cap), ctypes.c_int64(len(arrays)), table,
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(count.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, entry)
    return outs, count


def compact_rows_cuda(arrays: Sequence[torch.Tensor], mask: torch.Tensor,
                      num_rows: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K1 launch: see csrc/compact.cu."""
    cap = mask.shape[0]
    _check_rows(arrays, mask, num_rows, cap)
    out = _compact_launch("compact_rows", [ctypes.c_void_p(mask.data_ptr())],
                          arrays, num_rows, cap, mask.device)
    compact_rows_cuda.launches += 1
    compact_rows_cuda.plane_launches += _has_plane(arrays)
    return out


compact_rows_cuda.launches = 0
compact_rows_cuda.plane_launches = 0    # K32: launches that moved a plane


def _has_plane(arrays) -> int:
    return int(any(a is not None and a.dim() == 2 for a in arrays))
COMPACT_TILE = 4096   # rows per block; matches csrc/compact.cu


def _check_rows(arrays, mask, num_rows, cap) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D bool tensor")
    _check_arrays(arrays, num_rows, cap, mask.device)


def _check_arrays(arrays, num_rows, cap, dev) -> None:
    if num_rows.dtype != torch.int32 or num_rows.device != dev:
        raise ValueError("num_rows must be an int32 tensor on the mask's "
                         "device")
    for a in arrays:
        if a.device != dev or not _movable_shape(a, cap):
            raise ValueError(
                f"column {a.dtype}{tuple(a.shape)} on {a.device} does not "
                "match the mask")


def host_table(*groups):
    """Pointers and sizes concatenated into a host int64 array; the
    launcher passes it to its kernels by value (csrc/common.cuh Table)."""
    flat = [int(x) for g in groups for x in g]
    return (ctypes.c_int64 * max(len(flat), 1))(*flat)


def compact_rows(page: Page, mask: torch.Tensor) -> Page:
    """K1 wrapper (Page.filter): plain twin on the CPU, kernel on CUDA."""
    arrays = [a for c in page.columns for a in _movable(c)]
    if mask.dim() == 0:
        mask = mask.expand(page.capacity)
    mask = mask.contiguous()
    run = compact_rows_cuda if mask.is_cuda else compact_rows_plain
    moved, count = run(arrays, mask, page.num_rows)
    if not page.columns:
        return Page((), count)
    return Page(_rebuild(page.columns, moved), count)


def compact_range_plain(arrays: Sequence[torch.Tensor], key: torch.Tensor,
                        key_valid: Optional[torch.Tensor], lo: torch.Tensor,
                        hi: torch.Tensor, num_rows: torch.Tensor
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain twin of K1's range mode: the reference's range_prefilter
    mask (key in [lo, hi], NULL keys dropped) and then the compaction."""
    keep = (key >= lo) & (key <= hi)
    if key_valid is not None:
        keep = keep & key_valid
    return compact_rows_plain(arrays, keep, num_rows)


def compact_range_cuda(arrays: Sequence[torch.Tensor], key: torch.Tensor,
                       key_valid: Optional[torch.Tensor], lo: torch.Tensor,
                       hi: torch.Tensor, num_rows: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K1 launch in range mode: see csrc/compact.cu."""
    cap = key.shape[0]
    dev = key.device
    if key.dim() != 1 or not key.is_contiguous() \
            or key.element_size() not in (1, 2, 4, 8) \
            or (key.is_floating_point() and key.element_size() not in (4, 8)):
        raise ValueError("range key must be a contiguous 1-D column")
    for b in (lo, hi):
        if b.dtype != key.dtype or b.numel() != 1 or b.device != dev:
            raise ValueError("lo/hi must be one element of the key's type "
                             "on its device")
    if key_valid is not None and (key_valid.dtype != torch.bool
                                  or key_valid.shape != key.shape
                                  or not key_valid.is_contiguous()):
        raise ValueError("key validity must be a contiguous bool [cap]")
    _check_arrays(arrays, num_rows, cap, dev)
    out = _compact_launch(
        "compact_rows_range",
        [ctypes.c_void_p(key.data_ptr()),
         ctypes.c_void_p(0 if key_valid is None else key_valid.data_ptr()),
         ctypes.c_int64(key.element_size()),
         ctypes.c_int64(int(key.is_floating_point())),
         ctypes.c_void_p(lo.data_ptr()), ctypes.c_void_p(hi.data_ptr())],
        arrays, num_rows, cap, dev)
    compact_range_cuda.launches += 1
    compact_range_cuda.plane_launches += _has_plane(arrays)
    return out


compact_range_cuda.launches = 0
compact_range_cuda.plane_launches = 0


def compact_range(page: Page, channel: int, lo: torch.Tensor,
                  hi: torch.Tensor) -> Page:
    """K1 range-mode wrapper (range_prefilter): keep the live rows whose
    column `channel` lies in [lo, hi] and is not NULL. Plain twin on the
    CPU, kernel on CUDA."""
    key = page.column(channel)
    arrays = [a for c in page.columns for a in _movable(c)]
    run = compact_range_cuda if key.values.is_cuda else compact_range_plain
    moved, count = run(arrays, key.values.contiguous(), key.valid, lo, hi,
                       page.num_rows)
    return Page(_rebuild(page.columns, moved), count)


# ------------------------------------------------------------------ K2


def _widest(arrays, c: int) -> torch.Tensor:
    """Column c's array of the page with the widest plane (any page's for
    a [cap] array): the output's dtype and row shape."""
    present = [a[c] for a in arrays if a[c] is not None]
    return max(present, key=lambda a: a.shape[1] if a.dim() == 2 else 0)


def concat_rows_plain(arrays: Sequence[Sequence[torch.Tensor]],
                      counts: Sequence[torch.Tensor], out_cap: int
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain twin of K2: page p's first counts[p] rows of every array
    land at the running offset; the rest of the output is padding.
    `arrays[p][c]` is None where page p has no validity for column c
    (written as all-valid). A plane narrower than the widest page's is
    padded with zeros past its row."""
    ncols = len(arrays[0])
    dev = counts[0].device
    ref = [_widest(arrays, c) for c in range(ncols)]
    outs = [torch.zeros((out_cap,) + tuple(r.shape[1:]), dtype=r.dtype,
                        device=dev) for r in ref]
    cnt = torch.stack([c.to(torch.int64) for c in counts])
    offs = (torch.cumsum(cnt, 0) - cnt).tolist()
    for p, page_arrays in enumerate(arrays):
        cap = next((a.shape[0] for a in page_arrays if a is not None), 0)
        n = max(0, min(int(cnt[p]), cap))
        o = offs[p]
        for c, a in enumerate(page_arrays):
            if a is None:
                outs[c][o:o + n] = True
            elif a.dim() == 2:
                outs[c][o:o + n, :a.shape[1]] = a[:n]
                outs[c][o:o + n, a.shape[1]:] = 0
            else:
                outs[c][o:o + n] = a[:n]
    return outs, cnt.sum().to(torch.int32)


CONCAT_TILE = 2048           # rows of one (page, tile) item (csrc/concat.cu)
CONCAT_BLOCKS_PER_SM = 4     # K2's persistent grid, per SM at most
_CONCAT_ARGS = (ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p)


def concat_grid(caps: Sequence[int], sms: int) -> int:
    """Blocks of K2's persistent grid: CONCAT_BLOCKS_PER_SM per SM, capped
    by the most (page, tile) items the pages' capacities allow; at least
    one (block 0 writes the total)."""
    items = sum(-(-cap // CONCAT_TILE) for cap in caps)
    return max(1, min(CONCAT_BLOCKS_PER_SM * sms, items))


def concat_table(count_ptrs, caps, src_ptrs, dst_ptrs, dst_rb,
                 src_rb=()) -> List[int]:
    """K2's parameter words (csrc/concat.cu): count pointers and
    capacities (one per page), source pointers (page by page, 0 for an
    absent validity), destination pointers and row bytes (one per
    column), then, when some page's plane is narrower than the output's,
    every source's row bytes."""
    return [*count_ptrs, *caps, *src_ptrs, *dst_ptrs, *dst_rb, *src_rb]


def concat_param_words(npages: int, words: int) -> int:
    """The parameter block K2's launch copies its table into: 256 words
    when the call fits, else native.TABLE_MAX; 0 when the call does not
    fit one launch (csrc/concat.cu concat_rows)."""
    if words <= 256 and npages <= 128:
        return 256
    if words <= native.TABLE_MAX and npages <= native.TABLE_MAX // 2:
        return native.TABLE_MAX
    return 0


def concat_items_plain(counts: Sequence[int], caps: Sequence[int],
                       grid: int) -> Tuple[List[Tuple[int, ...]], int]:
    """Plain model of K2's walk (csrc/concat.cu): (every (page, tile) item
    as (block, page, first row, end row, output offset), in the order each
    block takes them, and the total). Counts clamp to [0, cap]; a page's
    items are the CONCAT_TILE-row tiles of its live prefix, and block b
    takes items b, b + grid, b + 2 * grid, ..."""
    live = [max(0, min(int(c), cap)) for c, cap in zip(counts, caps)]
    offs = list(itertools.accumulate(live, initial=0))
    items = [(p, r0, min(r0 + CONCAT_TILE, n), offs[p])
             for p, n in enumerate(live) for r0 in range(0, n, CONCAT_TILE)]
    return [(b,) + items[i] for b in range(grid)
            for i in range(b, len(items), grid)], offs[-1]


_dtype = operator.attrgetter("dtype")
_shape = operator.attrgetter("shape")


def _concat_layout(arrays, present, flat) -> Optional[tuple]:
    """(reference array per column, its row bytes, each page's capacity,
    whether a column is a plane) when every present array is a [cap] or
    [cap, L] array of its column's dtype and rank, else None. A column's
    reference (the output's dtype and row shape) is page 0's array, or
    for a plane or an absent validity the widest page's. Pages with
    neither, the common case, are checked in bulk passes over all
    arrays (C-level maps and list compares)."""
    npages, ncols = len(arrays), len(arrays[0])
    shapes = list(map(_shape, present))
    if len(present) == len(flat) and all(len(s) == 1
                                         for s in shapes[:ncols]):
        dtypes = list(map(_dtype, present))
        caps = [s[0] for s in shapes[::ncols]] if ncols else [0] * npages
        want = []
        for cap in caps:
            want += [(cap,)] * ncols
        drb = [d.itemsize for d in dtypes[:ncols]]
        if shapes != want or dtypes != dtypes[:ncols] * npages \
                or not {1, 2, 4, 8}.issuperset(drb):
            return None
        return present[:ncols], drb, caps, False
    ref = [_widest(arrays, c) for c in range(ncols)]
    caps = []
    for pa in arrays:
        page = [(a, r) for a, r in zip(pa, ref) if a is not None]
        cap = page[0][0].shape[0] if page else 0
        caps.append(cap)
        if any(a is None and r.dtype is not torch.bool
               for a, r in zip(pa, ref)) \
                or any(a.dtype is not r.dtype or a.dim() != r.dim()
                       or a.shape[0] != cap or a.shape[1:] > r.shape[1:]
                       or a.dim() > 2 or (a.dim() == 1 and a.element_size()
                                          not in (1, 2, 4, 8))
                       for a, r in page):
            return None
    return ref, [row_bytes(r) for r in ref], caps, \
        any(r.dim() == 2 for r in ref)


def concat_rows_cuda(arrays: Sequence[Sequence[Optional[torch.Tensor]]],
                     counts: Sequence[torch.Tensor], out_cap: int
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K2 launch: see csrc/concat.cu. One launch whatever the number of
    pages. Every array must be a contiguous [cap] or [cap, L] array of
    its column's dtype on the counts' device (1-D arrays of 1, 2, 4 or 8
    bytes); the checks run as bulk passes over all arrays at once."""
    npages = len(arrays)
    index = counts[0].get_device()
    if index < 0 or set(map(_dtype, counts)) != {torch.int32} \
            or set(map(torch.Tensor.get_device, counts)) != {index}:
        raise ValueError("counts must be int32 tensors on one CUDA device")
    ncols = len(arrays[0])
    if any(len(pa) != ncols for pa in arrays):
        raise ValueError("every page must carry the same arrays")
    flat = [a for pa in arrays for a in pa]
    present = [a for a in flat if a is not None]
    layout = _concat_layout(arrays, present, flat)
    if layout is None or not all(map(torch.Tensor.is_contiguous, present)) \
            or (present and set(map(torch.Tensor.get_device, present))
                != {index}):
        raise ValueError("page arrays do not match their columns (only "
                         "validity columns may be absent)")
    ref, drb, caps, planes = layout
    if sum(caps) != out_cap:
        raise ValueError("out_cap must be the sum of the page capacities")
    outs = [r.new_empty((out_cap,) + r.shape[1:]) if planes
            else r.new_empty(out_cap) for r in ref]
    total = counts[0].new_empty(())
    # K32: each page's own row width, where some page's plane is narrower
    # than the output's (else the table stays as long as without planes)
    srb = []
    if planes:
        srb = [d if a is None else row_bytes(a)
               for pa in arrays for a, d in zip(pa, drb)]
        if srb == drb * npages:
            srb = []
    table = array.array("q", concat_table(
        map(torch.Tensor.data_ptr, counts), caps,
        [0 if a is None else a.data_ptr() for a in flat]
        if len(present) < len(flat) else map(torch.Tensor.data_ptr, flat),
        map(torch.Tensor.data_ptr, outs), drb, srb))
    if not concat_param_words(npages, len(table)):
        native.check(-1, "concat_rows")
    rc = native.function("concat", "concat_rows", _CONCAT_ARGS)(
        npages, ncols, int(bool(srb)), table.buffer_info()[0], len(table),
        total.data_ptr(), concat_grid(caps, native.sm_count(index)),
        native.raw_stream(index))
    native.check(rc, "concat_rows")
    concat_rows_cuda.launches += 1
    concat_rows_cuda.plane_launches += int(planes)
    return outs, total


concat_rows_cuda.launches = 0
concat_rows_cuda.plane_launches = 0


def device_concat(pages: Sequence[Page]) -> Page:
    """Concatenate pages on the device into one page of capacity
    sum(capacities), with no host round trip for the counts (K2).
    All pages must share column types and dictionaries; list planes pad
    to the widest page's L."""
    if not pages:
        raise ValueError("no pages")
    if len(pages) == 1:
        return pages[0]
    ncols = pages[0].num_columns
    for ci in range(ncols):
        ref = pages[0].column(ci)
        if any(p.column(ci).dictionary != ref.dictionary
               or p.column(ci).aux_dictionary != ref.aux_dictionary
               for p in pages):
            raise ValueError(
                f"column {ci}: pages use different dictionaries; re-encode "
                "to a shared dictionary before concatenating")
    needs_valid = [any(p.column(ci).valid is not None for p in pages)
                   for ci in range(ncols)]
    arrays = []
    for p in pages:
        pa = []
        for ci, c in enumerate(p.columns):
            pa.append(c.values)
            if needs_valid[ci]:
                pa.append(c.valid)
            pa += [a for a in (c.lengths, c.aux) if a is not None]
        arrays.append(pa)
    out_cap = sum(p.capacity for p in pages)
    counts = [p.num_rows for p in pages]
    run = concat_rows_cuda if pages[0].device.type == "cuda" \
        else concat_rows_plain
    moved, total = run(arrays, counts, out_cap)
    it = iter(moved)
    cols = []
    for ci, ref in enumerate(pages[0].columns):
        values = next(it)
        valid = next(it) if needs_valid[ci] else None
        lengths = next(it) if ref.lengths is not None else None
        aux = next(it) if ref.aux is not None else None
        cols.append(Column(values, valid, ref.type, ref.dictionary, lengths,
                           aux, ref.aux_dictionary))
    return Page(tuple(cols), total)


# ------------------------------------------------------------------ K7


def gather_rows_plain(arrays: Sequence[torch.Tensor], indices: torch.Tensor
                      ) -> List[torch.Tensor]:
    """Plain twin of K7: every array at `indices`, clipped to the ends (the
    reference's jnp.take(..., mode="clip") per column)."""
    if not arrays:
        return []
    idx = indices.long().clamp(0, max(arrays[0].shape[0] - 1, 0))
    return [a[idx] for a in arrays]


def gather_rows_cuda(arrays: Sequence[torch.Tensor], indices: torch.Tensor
                     ) -> List[torch.Tensor]:
    """K7 launch: see csrc/gather.cu."""
    if not arrays:
        return []
    dev = indices.device
    if indices.dim() != 1 or indices.dtype not in (torch.int32, torch.int64):
        raise ValueError("indices must be a 1-D int32/int64 tensor")
    idx = indices.to(torch.int64).contiguous()
    n = idx.shape[0]
    cap = arrays[0].shape[0]
    for a in arrays:
        if a.device != dev or not _movable_shape(a, cap):
            raise ValueError(f"array {a.dtype}{tuple(a.shape)} on {a.device} "
                             "does not match the gather")
    if cap == 0 and n > 0:
        raise IndexError("gather from an empty page")
    outs = [torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
            for a in arrays]
    table = host_table([a.data_ptr() for a in arrays],
                       [o.data_ptr() for o in outs],
                       [row_bytes(a) for a in arrays])
    lib = native.library("gather")
    rc = lib.gather_rows(ctypes.c_void_p(idx.data_ptr()), ctypes.c_int64(n),
                         ctypes.c_int64(cap), ctypes.c_int64(len(arrays)),
                         table, ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "gather_rows")
    gather_rows_cuda.launches += 1
    gather_rows_cuda.plane_launches += _has_plane(arrays)
    return outs


gather_rows_cuda.launches = 0
gather_rows_cuda.plane_launches = 0


def gather_rows(arrays: Sequence[torch.Tensor], indices: torch.Tensor
                ) -> List[torch.Tensor]:
    """K7 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = gather_rows_cuda if indices.is_cuda else gather_rows_plain
    return run(arrays, indices)
