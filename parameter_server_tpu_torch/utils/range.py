"""Key/index ranges.

Counterpart of ``parameter_server_tpu/utils/range.py`` (the reference's
``src/util/range.h``, ``Range<T>``): half-open integer ranges that
describe key segments and feature blocks, with ``even_divide`` as
``Range::EvenDivide``.
"""

from __future__ import annotations

import dataclasses

UINT64_MAX = (1 << 64) - 1


@dataclasses.dataclass(frozen=True, order=True)
class Range:
    """Half-open range ``[begin, end)`` over integer keys or indices."""

    begin: int = 0
    end: int = 0

    @staticmethod
    def all() -> "Range":
        return Range(0, UINT64_MAX)

    def size(self) -> int:
        return max(0, self.end - self.begin)

    # no __len__: the 2^64-key range would overflow CPython's index-sized
    # __len__, and bool(Range.all()) calls it

    def empty(self) -> bool:
        return self.end <= self.begin

    def valid(self) -> bool:
        return self.end >= self.begin

    def __contains__(self, key: int) -> bool:
        return self.begin <= key < self.end

    def contains_range(self, other: "Range") -> bool:
        return self.begin <= other.begin and other.end <= self.end

    def intersection(self, other: "Range") -> "Range":
        b = max(self.begin, other.begin)
        e = min(self.end, other.end)
        return Range(b, max(b, e))

    def union(self, other: "Range") -> "Range":
        return Range(min(self.begin, other.begin), max(self.end, other.end))

    def shift(self, offset: int) -> "Range":
        return Range(self.begin + offset, self.end + offset)

    def even_divide(self, n: int, i: int) -> "Range":
        """The i-th of n near-equal consecutive parts."""
        if not (0 <= i < n):
            raise ValueError(f"partition {i} out of {n}")
        total = self.size()
        b = self.begin + (total * i) // n
        e = self.begin + (total * (i + 1)) // n
        return Range(b, e)

    def divide(self, n: int) -> list["Range"]:
        return [self.even_divide(n, i) for i in range(n)]

    def __str__(self) -> str:  # the reference's "[b, e)" logging style
        return f"[{self.begin}, {self.end})"
