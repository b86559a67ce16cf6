"""Column-wise constraint algebra for pushdown and pruning (host-side).

Reference parity: core/trino-spi/src/main/java/io/trino/spi/predicate/
(TupleDomain.java:49, Domain.java, SortedRangeSet.java). Pure Python — this
runs in the planner, never on device; scan kernels consume the compiled
min/max/in-set form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T


@dataclasses.dataclass(frozen=True)
class Range:
    """[low, high] with open/closed bounds; None bound = unbounded.

    Reference: spi/predicate/Range.java.
    """

    low: Optional[object]
    low_inclusive: bool
    high: Optional[object]
    high_inclusive: bool

    @classmethod
    def all(cls) -> "Range":
        return cls(None, False, None, False)

    @classmethod
    def equal(cls, value) -> "Range":
        return cls(value, True, value, True)

    @classmethod
    def greater_than(cls, value) -> "Range":
        return cls(value, False, None, False)

    @classmethod
    def greater_equal(cls, value) -> "Range":
        return cls(value, True, None, False)

    @classmethod
    def less_than(cls, value) -> "Range":
        return cls(None, False, value, False)

    @classmethod
    def less_equal(cls, value) -> "Range":
        return cls(None, False, value, True)

    @classmethod
    def between(cls, low, high) -> "Range":
        return cls(low, True, high, True)

    def is_single_value(self) -> bool:
        return (self.low is not None and self.low == self.high
                and self.low_inclusive and self.high_inclusive)

    def overlaps(self, other: "Range") -> bool:
        return not (self._strictly_before(other) or other._strictly_before(self))

    def _strictly_before(self, other: "Range") -> bool:
        if self.high is None or other.low is None:
            return False
        if self.high < other.low:
            return True
        if self.high == other.low:
            return not (self.high_inclusive and other.low_inclusive)
        return False

    def intersect(self, other: "Range") -> Optional["Range"]:
        if not self.overlaps(other):
            return None
        if self.low is None:
            lo, loi = other.low, other.low_inclusive
        elif other.low is None or self.low > other.low:
            lo, loi = self.low, self.low_inclusive
        elif self.low < other.low:
            lo, loi = other.low, other.low_inclusive
        else:
            lo, loi = self.low, self.low_inclusive and other.low_inclusive
        if self.high is None:
            hi, hii = other.high, other.high_inclusive
        elif other.high is None or self.high < other.high:
            hi, hii = self.high, self.high_inclusive
        elif self.high > other.high:
            hi, hii = other.high, other.high_inclusive
        else:
            hi, hii = self.high, self.high_inclusive and other.high_inclusive
        if (lo is not None and hi is not None
                and (lo > hi or (lo == hi and not (loi and hii)))):
            return None
        return Range(lo, loi, hi, hii)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Set of allowed values for one column: ranges + null flag.

    Reference: spi/predicate/Domain.java (SortedRangeSet values + nullAllowed).
    ranges == () and not null_allowed -> none(); ranges == (Range.all(),) and
    null_allowed -> all().
    """

    type: T.Type
    ranges: Tuple[Range, ...]
    null_allowed: bool

    @classmethod
    def all(cls, typ: T.Type) -> "Domain":
        return cls(typ, (Range.all(),), True)

    @classmethod
    def none(cls, typ: T.Type) -> "Domain":
        return cls(typ, (), False)

    @classmethod
    def only_null(cls, typ: T.Type) -> "Domain":
        return cls(typ, (), True)

    @classmethod
    def single_value(cls, typ: T.Type, value) -> "Domain":
        return cls(typ, (Range.equal(value),), False)

    @classmethod
    def multiple_values(cls, typ: T.Type, values: Sequence) -> "Domain":
        rs = tuple(Range.equal(v) for v in sorted(set(values)))
        return cls(typ, rs, False)

    @classmethod
    def from_range(cls, typ: T.Type, r: Range,
                   null_allowed: bool = False) -> "Domain":
        return cls(typ, (r,), null_allowed)

    def is_all(self) -> bool:
        return (self.null_allowed and len(self.ranges) == 1
                and self.ranges[0] == Range.all())

    def is_none(self) -> bool:
        return not self.ranges and not self.null_allowed

    def is_single_value(self) -> bool:
        return (not self.null_allowed and len(self.ranges) == 1
                and self.ranges[0].is_single_value())

    def get_single_value(self):
        assert self.is_single_value()
        return self.ranges[0].low

    def values_if_discrete(self) -> Optional[List]:
        if all(r.is_single_value() for r in self.ranges):
            return [r.low for r in self.ranges]
        return None

    def intersect(self, other: "Domain") -> "Domain":
        out: List[Range] = []
        for a in self.ranges:
            for b in other.ranges:
                r = a.intersect(b)
                if r is not None:
                    out.append(r)
        return Domain(self.type, tuple(out),
                      self.null_allowed and other.null_allowed)

    def union(self, other: "Domain") -> "Domain":
        # coarse union (no merge of adjacent ranges) — sound for pruning
        return Domain(self.type, tuple(self.ranges) + tuple(other.ranges),
                      self.null_allowed or other.null_allowed)

    def overlaps_range(self, low, high) -> bool:
        """May any allowed row fall in a split whose values span [low, high]?

        Used for split pruning; must be conservative. Nulls can occur in any
        split regardless of its value bounds, so a null-admitting domain never
        prunes.
        """
        if self.null_allowed:
            return True
        probe = Range.between(low, high)
        return any(r.overlaps(probe) for r in self.ranges)

    def bounds(self) -> Tuple[Optional[object], Optional[object]]:
        """(min, max) over all ranges; None = unbounded."""
        if not self.ranges:
            return (None, None)
        lows = [r.low for r in self.ranges]
        highs = [r.high for r in self.ranges]
        lo = None if any(l is None for l in lows) else min(lows)
        hi = None if any(h is None for h in highs) else max(highs)
        return (lo, hi)


@dataclasses.dataclass(frozen=True)
class TupleDomain:
    """Conjunction of per-column Domains; None = NONE (contradiction).

    Reference: spi/predicate/TupleDomain.java:49.
    """

    domains: Optional[Dict[Hashable, Domain]]  # None => none()

    @classmethod
    def all(cls) -> "TupleDomain":
        return cls({})

    @classmethod
    def none(cls) -> "TupleDomain":
        return cls(None)

    @classmethod
    def with_column_domains(cls, domains: Dict[Hashable, Domain]) -> "TupleDomain":
        for d in domains.values():
            if d.is_none():
                return cls.none()
        return cls({k: v for k, v in domains.items() if not v.is_all()})

    def is_all(self) -> bool:
        return self.domains == {}

    def is_none(self) -> bool:
        return self.domains is None

    def domain(self, column) -> Optional[Domain]:
        if self.domains is None:
            return None
        return self.domains.get(column)

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        if self.is_none() or other.is_none():
            return TupleDomain.none()
        merged = dict(self.domains)
        for col, dom in other.domains.items():
            merged[col] = merged[col].intersect(dom) if col in merged else dom
        return TupleDomain.with_column_domains(merged)

    def transform_keys(self, fn) -> "TupleDomain":
        if self.is_none():
            return self
        return TupleDomain.with_column_domains(
            {fn(k): v for k, v in self.domains.items()})

    def freeze(self) -> Hashable:
        """Hashable canonical form (TupleDomain holds a dict, so the
        dataclass itself cannot key a cache): sorted (column, Domain)
        pairs, or the NONE sentinel. Two equal domains freeze equal —
        the scan-cache key contract (a pruning connector's page set is a
        function of the effective constraint)."""
        if self.domains is None:
            return ("<none>",)
        return tuple(sorted(self.domains.items(), key=lambda kv: str(kv[0])))
