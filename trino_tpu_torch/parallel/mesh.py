"""Query mesh: the shards a query runs over and the devices they run on.

Port of `trino_tpu/parallel/mesh.py`. The reference's mesh is a
`jax.sharding.Mesh` with one 'workers' axis that one process drives; here
it is a list of `torch.device`s, one per shard, that one process drives
the same way. A device may repeat: `["cpu"] * 8` runs eight shards on
the CPU (the tests), `["cuda:0"] * 8` eight on one card, as the
reference's tests run eight virtual XLA devices on one CPU. A sharded
page is a list of per-shard pages, and `shard_map` maps a function over
that list: local operators take one shard's page, the collectives of
`parallel/exchange.py` take and return the whole list.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from trino_tpu_torch.page import Column, Page, gather_rows, row_count, \
    union_dictionaries


def _next_pow2(n: int) -> int:
    out = 1024
    while out < n:
        out *= 2
    return out


class QueryMesh:
    """One query-engine worker per shard."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass devices=['cpu'] * n to run the "
                    "shards on the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device for the mesh")
        self.n = len(self.devices)

    def device_of(self, shard: int) -> torch.device:
        """The device executing worker `shard`'s task pipelines."""
        return self.devices[shard]

    def shard_pages(self, pages: List[Page]) -> List[Page]:
        """The split->node assignment step: n per-shard pages, each on its
        shard's device, normalized as the collectives need them (equal
        capacities, uniform validity presence, one dictionary per
        column)."""
        assert len(pages) == self.n, f"need {self.n} pages, got {len(pages)}"
        placed = [to_device(p, d) for p, d in zip(pages, self.devices)]
        return normalize_pages(placed)

    def shard_map(self, fn: Callable[[Page], Page]
                  ) -> Callable[[List[Page]], List[Page]]:
        """fn over every shard's page, in shard order (one Trino 'task'
        per shard; each shard's kernels queue on its device's stream)."""
        def run(pages: List[Page]) -> List[Page]:
            return [fn(p) for p in pages]
        return run


def to_device(page: Page, device: torch.device) -> Page:
    """The page on `device` (a peer copy when it lives on another one)."""
    if page.device == device:
        return page
    cols = []
    for c in page.columns:
        moved = [None if a is None else a.to(device, non_blocking=True)
                 for a in (c.values, c.valid, c.lengths, c.aux)]
        cols.append(Column(moved[0], moved[1], c.type, c.dictionary,
                           moved[2], moved[3], c.aux_dictionary))
    return Page(tuple(cols), page.num_rows.to(device, non_blocking=True))


def empty_like(ref: Page) -> Page:
    """A page of ref's layout with no live rows."""
    cols = tuple(Column(torch.zeros_like(c.values),
                        None if c.valid is None else torch.zeros_like(c.valid),
                        c.type, c.dictionary,
                        None if c.lengths is None
                        else torch.zeros_like(c.lengths),
                        None if c.aux is None else torch.zeros_like(c.aux),
                        c.aux_dictionary)
                 for c in ref.columns)
    return Page(cols, row_count(0, ref.device))


def normalize_pages(pages: List[Page]) -> List[Page]:
    """The reference's _normalize_pages: equal capacities, uniform
    validity presence, and one dictionary per column across shards (codes
    remapped onto the union pool by K7 where shards disagree)."""
    cap = max(p.capacity for p in pages)
    pages = [p.pad_to(_next_pow2(cap)) if p.capacity < cap else p
             for p in pages]
    cap = max(p.capacity for p in pages)
    pages = [p.pad_to(cap) for p in pages]
    out_cols: List[List[Column]] = [list(p.columns) for p in pages]
    for ci in range(pages[0].num_columns):
        cols = [p.column(ci) for p in pages]
        dicts = {}
        for c in cols:
            if c.dictionary is not None and not any(
                    c.dictionary == d for d in dicts.values()):
                dicts[id(c.dictionary)] = c.dictionary
        union, remaps = None, None
        if len(dicts) > 1:
            union, tables = union_dictionaries(list(dicts.values()),
                                               device="cpu")
            remaps = list(zip(dicts.values(), tables))
        any_valid = any(c.valid is not None for c in cols)
        for pi, c in enumerate(cols):
            values, dictionary, valid = c.values, c.dictionary, c.valid
            if remaps is not None and c.dictionary is not None:
                tbl = next(t for d, t in remaps if d == c.dictionary)
                tbl = tbl.to(values.device)
                values = gather_rows([tbl], values.clamp(min=0))[0]
                dictionary = union
            if any_valid and valid is None:
                valid = torch.ones(c.capacity, dtype=torch.bool,
                                   device=values.device)
            out_cols[pi][ci] = Column(values, valid, c.type, dictionary,
                                      c.lengths, c.aux, c.aux_dictionary)
    return [Page(tuple(cs), p.num_rows) for cs, p in zip(out_cols, pages)]
