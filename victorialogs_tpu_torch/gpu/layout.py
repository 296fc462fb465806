"""Device staging: storage columns -> fixed-shape tensors.

A string column stages as a fixed-width matrix: each value at column 0
of its row, tail-padded with 0xFF (never a byte of UTF-8 text, so a
window reaching into the padding cannot match and 0xFF is not a word
byte).  The scan reads it lane-major: `lanes[q, r]` is the
little-endian uint32 of bytes [4q, 4q+4) of row r, so one thread per
row reads consecutive words across a warp.  Values longer than W-1
bytes are truncated; their rows are re-checked on the host.

A part's columns are staged over all its blocks at once by
gpu/fused.py (`stage_layout_column`); staged tensors are LRU-cached
across queries by (part uid, kind, ...) under a device-byte budget
(`StagingCache`); a part's entries go when the part is dropped
(`drop_part`, called as a flush replaces an in-memory part).  Each value
put counts `staged_entries` and `staged_bytes` on the active trace's
span.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ..obs import tracing

MAX_ROW_WIDTH = 2048  # values longer than W-1 overflow to the host path
STAGING_BUDGET_BYTES = 8 << 30  # device bytes a runner keeps staged


def row_width_bucket(max_len: int) -> int:
    """Fixed row width: power of two > max_len, capped at MAX_ROW_WIDTH."""
    w = 32
    while w <= max_len and w < MAX_ROW_WIDTH:
        w *= 2
    return w


def _ranges(lengths: np.ndarray) -> np.ndarray:
    """Concatenated [0..l) ranges for each l in lengths."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - lengths,
                                                        lengths)


def to_fixed_width(arena: np.ndarray, offsets: np.ndarray,
                   lengths: np.ndarray, rows: int, width: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Packed string column -> (uint8[rows, width] matrix, overflow row
    indices).  Values longer than width-1 are truncated."""
    r = int(offsets.shape[0])
    out = np.full((rows, width), 0xFF, dtype=np.uint8)
    if r:
        copy = np.minimum(lengths, width - 1).astype(np.int64)
        within = _ranges(copy)
        dst = np.repeat(np.arange(r, dtype=np.int64) * width, copy) + within
        src = np.repeat(offsets.astype(np.int64), copy) + within
        out.reshape(-1)[dst] = arena[src]
    return out, np.nonzero(lengths > width - 1)[0]


def to_lanes32(mat: np.ndarray) -> np.ndarray:
    """(R, W) uint8 matrix -> (W/4, R) little-endian uint32 lanes."""
    r, w = mat.shape
    assert w % 4 == 0
    return np.ascontiguousarray(
        mat.reshape(r, w // 4, 4).view("<u4")[:, :, 0].T)


def rows_with_multibyte(arena: np.ndarray, offsets: np.ndarray,
                        lengths: np.ndarray) -> np.ndarray:
    """Per-row any(byte >= 0x80) over the source values -> bool[r]."""
    r = int(offsets.shape[0])
    if not arena.size or not (arena >= 0x80).any():
        return np.zeros(r, dtype=bool)
    cs = np.zeros(arena.size + 1, dtype=np.int64)
    np.cumsum(arena >= 0x80, out=cs[1:])
    offs = offsets.astype(np.int64)
    return cs[offs + lengths.astype(np.int64)] > cs[offs]


class StagingCache:
    """LRU over staged values, bounded by device bytes.

    An entry's cost is its `device_bytes()` (a nominal 4096 for markers
    without one); `check_balanced()` proves the running total equals the
    sum over live entries."""

    def __init__(self, max_bytes: int = STAGING_BUDGET_BYTES):
        self.max_bytes = max_bytes
        self._lru: OrderedDict = OrderedDict()
        self._bytes = 0
        self._mu = threading.Lock()
        self._dropped: list = []     # part uids to drop at the next call

    def _drop_locked(self) -> None:
        while self._dropped:
            uid = self._dropped.pop()
            for key in [k for k in self._lru if k[0] == uid]:
                self._bytes -= self._cost(self._lru.pop(key))

    def drop_part(self, uid) -> None:
        """Release every entry of part `uid`.  It may run from a garbage
        collection inside another call of this cache, so it only queues
        the uid when the lock is taken."""
        self._dropped.append(uid)
        if self._mu.acquire(blocking=False):
            try:
                self._drop_locked()
            finally:
                self._mu.release()

    def part_uids(self) -> set:
        with self._mu:
            self._drop_locked()
            return {k[0] for k in self._lru}

    @staticmethod
    def _cost(v) -> int:
        return v.device_bytes() if hasattr(v, "device_bytes") else 4096

    def get(self, key):
        with self._mu:
            self._drop_locked()
            got = self._lru.get(key)
            if got is not None:
                self._lru.move_to_end(key)
            return got

    def put(self, key, value) -> None:
        cost = self._cost(value)
        with self._mu:
            self._drop_locked()
            if key in self._lru:
                return
            self._lru[key] = value
            self._bytes += cost
            while self._bytes > self.max_bytes and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self._bytes -= self._cost(old)
        # the active trace's staging counters (a no-op untraced); a
        # duplicate key returned above, so each value counts once
        sp = tracing.current_span()
        if sp.enabled:
            sp.add("staged_entries")
            sp.add("staged_bytes", cost)

    def bytes(self) -> int:
        with self._mu:
            return self._bytes

    def bytes_by_kind(self) -> dict:
        """Staged bytes by the kind in each key (part uid, kind, ...)."""
        out: dict = {}
        with self._mu:
            for key, v in self._lru.items():
                out[key[1]] = out.get(key[1], 0) + self._cost(v)
        return out

    def check_balanced(self) -> bool:
        with self._mu:
            return self._bytes == sum(self._cost(v)
                                      for v in self._lru.values())

    def clear(self) -> None:
        with self._mu:
            self._lru.clear()
            self._bytes = 0
            self._dropped.clear()
