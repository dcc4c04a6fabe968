"""Per-label interval merge structure (a copy of
``segma_tpu/structs/interval.py``): holds
``(start, end, label)`` tuples and merges overlapping *or adjacent* intervals
that share a label. Start/end may be ints (frames) or floats (seconds).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, TypeAlias

Interval: TypeAlias = tuple[float, float, int | str]


class Intervals:
    """Sorted collection of labeled intervals with per-label merging."""

    def __init__(self, intervals: list[Interval] | None = None) -> None:
        # bulk construction: ONE sort+merge pass over the whole list —
        # add() per element would re-sort and re-merge the accumulated
        # list each time (O(n^2 log n) on large RTTMs)
        self.intervals: list[Interval] = self._reduce_per_label(
            list(intervals or [])
        )

    def add(self, interval: Interval) -> None:
        """Insert an interval, re-merging per label."""
        self.intervals = self._reduce_per_label(self.intervals + [interval])

    @staticmethod
    def _reduce(intervals: list[Interval]) -> list[Interval]:
        """Merge overlapping/adjacent intervals in a single-label list."""
        if len(intervals) < 2:
            return intervals
        intervals = sorted(intervals)
        merged = [intervals[0]]
        for start, end, label in intervals[1:]:
            prev_start, prev_end, _ = merged[-1]
            if start <= prev_end:  # overlap or exact adjacency -> merge
                merged[-1] = (prev_start, max(prev_end, end), label)
            else:
                merged.append((start, end, label))
        return merged

    def _reduce_per_label(self, intervals: list[Interval]) -> list[Interval]:
        by_label: dict[int | str, list[Interval]] = defaultdict(list)
        for start, end, label in intervals:
            by_label[label].append((start, end, label))
        out: list[Interval] = []
        for sub in by_label.values():
            out.extend(self._reduce(sub))
        return sorted(out)

    def __iter__(self) -> Iterator[Interval]:
        return iter(self.intervals)

    def __len__(self) -> int:
        return len(self.intervals)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.intervals!r})"
