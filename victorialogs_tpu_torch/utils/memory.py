"""Memory budget of the stateful pipes (`sort`, `uniq`).

A pipe whose state grows past its fraction of the allowed memory fails
the query with QueryMemoryError instead of exhausting the process.  The
allowed memory is 60% of the machine's physical memory.
"""

from __future__ import annotations

import os

_cached: int | None = None


def allowed() -> int:
    global _cached
    if _cached is None:
        try:
            total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):
            total = 1 << 32
        _cached = int(total * 0.6)
    return _cached


class QueryMemoryError(Exception):
    """A stateful pipe exceeded its memory budget."""


class MemoryBudget:
    """Approximate state bytes of one pipe processor."""

    def __init__(self, fraction: float, what: str):
        self.limit = int(allowed() * fraction)
        self.used = 0
        self.what = what

    def add(self, nbytes: int) -> None:
        self.used += nbytes
        if self.used > self.limit:
            raise QueryMemoryError(
                f"memory limit exceeded for {self.what}: state needs more "
                f"than {self.limit} bytes; reduce the query's row/group "
                f"count (e.g. add filters or limits)")
