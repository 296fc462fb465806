"""Storage: rows split by UTC day into partitions of in-memory parts.

Each partition pairs a stream index (stream id -> canonical tags, the
`_stream:{...}` resolution source) with the list of parts its flushes
minted.  Every batch added (rows or columns) is built into blocks at
once and buffered as a part of its own, which queries see at once
(`snapshot_parts` lists the buffered parts first, then the flushed
ones); a flush merges the buffered block lists into ONE part per
partition (storage/merge.py).  `debug_flush` flushes every partition,
and an add flushes its partition once more than MAX_INMEMORY_PARTS
batches wait.  There are no background threads, so `close()` only
drops state.
"""

from __future__ import annotations

import time

import numpy as np

from ..device import resolve_device
from .block_build import build_log_rows_blocks
from .log_rows import LogRows
from .merge import merge_block_streams
from .part import Part
from .stream_filter import parse_stream_tags

NSECS_PER_DAY = 86400 * 1_000_000_000
MAX_INMEMORY_PARTS = 8       # buffered batches a partition holds unflushed


def day_from_ts(ts_ns: int) -> int:
    return ts_ns // NSECS_PER_DAY


class Partition:
    """One UTC day: stream index + flushed parts + one in-memory part
    for each batch added since the last flush."""

    def __init__(self, day: int):
        self.day = day
        self.streams: dict = {}            # StreamID -> canonical tags
        self.parts: list[Part] = []
        self._pending: list[Part] = []     # one part a batch

    def must_add_rows(self, lr: LogRows, idxs=None) -> None:
        """Build rows `idxs` of `lr` (all of them when None)."""
        if idxs is None:
            for sid, tags in lr.streams():
                self.streams.setdefault(sid, tags)
        else:
            sub = LogRows()
            for i in idxs:
                sid = lr.stream_ids[i]
                self.streams.setdefault(sid, lr.stream_tags_str[i])
                sub.timestamps.append(lr.timestamps[i])
                sub.rows.append(lr.rows[i])
                sub.stream_ids.append(sid)
                sub.stream_tags_str.append(lr.stream_tags_str[i])
            lr = sub
        self._add_blocks(build_log_rows_blocks(lr))

    def must_add_columns(self, lc) -> None:
        """Build a LogColumns batch of this day."""
        for sid, tags in lc.unique_streams():
            self.streams.setdefault(sid, tags)
        self._add_blocks(lc.build_blocks())

    def _add_blocks(self, blocks: list) -> None:
        if blocks:
            self._pending.append(Part(blocks))
            if len(self._pending) > MAX_INMEMORY_PARTS:
                self.flush()

    def flush(self) -> None:
        """Merge the buffered batches into one part (a lone batch's part
        becomes the flushed part as it is)."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        self.parts.append(pending[0] if len(pending) == 1 else Part(
            list(merge_block_streams([p.blocks for p in pending]))))

    def search_stream_ids(self, tenants, sf) -> set:
        """Stream ids of `tenants` whose tags match the stream filter
        (absent labels read as the empty string)."""
        ts = set(tenants)
        return {sid for sid, tags in self.streams.items()
                if sid.tenant in ts and sf.matches(parse_stream_tags(tags))}

    def snapshot_parts(self) -> list[Part]:
        """The parts a query walks: the unflushed batches' in-memory
        parts, oldest first, then the flushed parts."""
        return self._pending + self.parts


class Storage:
    """Parts live in host memory; a TorchBatchRunner stages them on its
    own device.  `device` is only checked: "cuda" (the default) raises
    when CUDA is missing, so running without a card is an explicit
    device="cpu"."""

    def __init__(self, retention_days: float = 7.0,
                 future_retention_days: float = 2.0, device="cuda"):
        resolve_device(device)
        self.retention_days = retention_days
        self.future_retention_days = future_retention_days
        self.partitions: dict[int, Partition] = {}
        self.rows_dropped_too_old = 0
        self.rows_dropped_too_new = 0

    def _retention(self) -> tuple[int, int]:
        now_ns = time.time_ns()
        return (now_ns - int(self.retention_days * NSECS_PER_DAY),
                now_ns + int(self.future_retention_days * NSECS_PER_DAY))

    def _partition(self, day: int) -> Partition:
        pt = self.partitions.get(day)
        if pt is None:
            pt = self.partitions[day] = Partition(day)
        return pt

    def must_add_rows(self, lr: LogRows) -> None:
        """Split a batch by UTC day; rows outside the retention window
        are counted and dropped."""
        if not len(lr):
            return
        min_ts, max_ts = self._retention()
        ts = np.asarray(lr.timestamps, dtype=np.int64)
        old, new = ts < min_ts, ts > max_ts
        self.rows_dropped_too_old += int(old.sum())
        self.rows_dropped_too_new += int(new.sum())
        ok = ~(old | new)
        days = ts // NSECS_PER_DAY
        for day in np.unique(days[ok]).tolist():
            sel = ok & (days == day)
            self._partition(day).must_add_rows(
                lr, None if sel.all() else np.nonzero(sel)[0].tolist())

    def must_add_columns(self, lc) -> None:
        """The LogColumns twin of must_add_rows."""
        if lc.nrows == 0:
            return
        min_ts, max_ts = self._retention()
        by_day, old, new = lc.split_by_day(min_ts, max_ts, NSECS_PER_DAY)
        self.rows_dropped_too_old += old
        self.rows_dropped_too_new += new
        for day, sub in by_day.items():
            self._partition(day).must_add_columns(sub)

    def select_partitions(self, min_ts: int, max_ts: int) -> list:
        lo, hi = day_from_ts(min_ts), day_from_ts(max_ts)
        return [p for d, p in sorted(self.partitions.items())
                if lo <= d <= hi]

    def debug_flush(self) -> None:
        for p in self.partitions.values():
            p.flush()

    def close(self) -> None:
        self.partitions.clear()
