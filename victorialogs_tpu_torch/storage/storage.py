"""Storage: rows split by UTC day into partitions, in memory or on disk.

`Storage(path)` keeps each day's partition under
`path/partitions/YYYYMMDD` (storage/partition.py: a stream index and a
datadb of file parts) and reopens them when constructed; `.tmp`
leftovers there are removed.  `Storage()` (no path) keeps every part in
host memory and loses it at `close()`: each batch added is an in-memory
part that queries see at once, and a flush merges a partition's waiting
batches into one part.  `debug_flush` flushes every partition, and an
add flushes its partition once more than MAX_INMEMORY_PARTS batches
wait (a durable partition also once its oldest waiting batch is
`flush_interval` seconds old).

There are no background threads: retention (`drop_expired_partitions`)
and the disk limit (`enforce_max_disk_usage`) are methods the owner
calls, and a durable partition's merges run inside the flush that makes
them due.
"""

from __future__ import annotations

import datetime
import os
import shutil
import time

import numpy as np

from ..device import resolve_device
from .datadb import MAX_INMEMORY_PARTS
from .log_rows import LogRows
from .part import fsync_dir
from .partition import Partition

NSECS_PER_DAY = 86400 * 1_000_000_000
PARTITIONS_DIRNAME = "partitions"


def day_from_ts(ts_ns: int) -> int:
    return ts_ns // NSECS_PER_DAY


def day_dir_name(day: int) -> str:
    d = datetime.datetime.fromtimestamp(day * 86400, datetime.timezone.utc)
    return d.strftime("%Y%m%d")


def day_from_dir_name(name: str) -> int:
    d = datetime.datetime.strptime(name, "%Y%m%d") \
        .replace(tzinfo=datetime.timezone.utc)
    return int(d.timestamp()) // 86400


class Storage:
    """A TorchBatchRunner stages the parts on its own device.  `device`
    is only checked: "cuda" (the default) raises when CUDA is missing,
    so running without a card is an explicit device="cpu"."""

    def __init__(self, path: str | None = None, retention_days: float = 7.0,
                 flush_interval: float = 5.0,
                 future_retention_days: float = 2.0,
                 max_disk_usage_bytes: int = 0, device="cuda"):
        resolve_device(device)
        self.path = path
        self.retention_days = retention_days
        self.future_retention_days = future_retention_days
        self.flush_interval = flush_interval
        self.max_disk_usage_bytes = max_disk_usage_bytes
        self.partitions: dict[int, Partition] = {}
        self.rows_dropped_too_old = 0
        self.rows_dropped_too_new = 0
        if path is None:
            return
        pdir = self._pdir()
        os.makedirs(pdir, exist_ok=True)
        for entry in sorted(os.listdir(pdir)):
            full = os.path.join(pdir, entry)
            if entry.endswith(".tmp"):
                shutil.rmtree(full)
                continue
            try:
                day = day_from_dir_name(entry)
            except ValueError:
                continue
            self.partitions[day] = Partition(
                day, full, flush_interval, MAX_INMEMORY_PARTS)

    def _pdir(self) -> str:
        return os.path.join(self.path, PARTITIONS_DIRNAME)

    def _retention(self) -> tuple[int, int]:
        now_ns = time.time_ns()
        return (now_ns - int(self.retention_days * NSECS_PER_DAY),
                now_ns + int(self.future_retention_days * NSECS_PER_DAY))

    def _partition(self, day: int) -> Partition:
        pt = self.partitions.get(day)
        if pt is None:
            path = None
            if self.path is not None:
                path = os.path.join(self._pdir(), day_dir_name(day))
            pt = Partition(day, path, self.flush_interval,
                           MAX_INMEMORY_PARTS)
            if path is not None:
                fsync_dir(self._pdir())
            self.partitions[day] = pt
        return pt

    # ---- ingestion ----

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

    # ---- queries ----

    def select_partitions(self, min_ts: int, max_ts: int) -> list:
        lo, hi = day_from_ts(min_ts), day_from_ts(max_ts)
        return [p for d, p in sorted(self.partitions.items())
                if lo <= d <= hi]

    # ---- maintenance ----

    def debug_flush(self) -> None:
        for p in self.partitions.values():
            p.flush()

    def must_force_merge(self, partition_prefix: str = "") -> None:
        """Merge each partition whose YYYYMMDD name starts with the
        prefix into one part."""
        for d, p in list(self.partitions.items()):
            if day_dir_name(d).startswith(partition_prefix):
                p.force_merge()

    def _drop(self, day: int) -> None:
        p = self.partitions.pop(day)
        p.close()
        if p.path is not None:
            shutil.rmtree(p.path)
            fsync_dir(self._pdir())

    def drop_expired_partitions(self, now_ns: int | None = None) -> list:
        """Drop the partitions of days wholly older than the retention
        window; their days."""
        if now_ns is None:
            now_ns = time.time_ns()
        min_day = day_from_ts(now_ns - int(self.retention_days
                                           * NSECS_PER_DAY))
        dropped = [d for d in sorted(self.partitions) if d < min_day]
        for day in dropped:
            self._drop(day)
        return dropped

    def disk_usage_bytes(self) -> int:
        total = 0
        for root, _dirs, files in os.walk(self.path):
            for f in files:
                total += os.path.getsize(os.path.join(root, f))
        return total

    def enforce_max_disk_usage(self) -> list:
        """While the store's directory holds more than
        max_disk_usage_bytes, drop its oldest partition (never the
        newest); the days dropped."""
        if self.path is None or self.max_disk_usage_bytes <= 0:
            return []
        dropped: list[int] = []
        while len(self.partitions) > 1 and \
                self.disk_usage_bytes() > self.max_disk_usage_bytes:
            day = min(self.partitions)
            self._drop(day)
            dropped.append(day)
        return dropped

    def update_stats(self) -> dict:
        agg = {
            "partitions": len(self.partitions), "streams": 0,
            "inmemory_rows": 0, "file_rows": 0, "small_rows": 0,
            "big_rows": 0, "inmemory_parts": 0, "small_parts": 0,
            "big_parts": 0, "compressed_size": 0, "uncompressed_size": 0,
            "pending_merges": 0, "merges_done": 0,
            "flush_age_seconds": 0.0,
            "rows_dropped_too_old": self.rows_dropped_too_old,
            "rows_dropped_too_new": self.rows_dropped_too_new,
        }
        for p in self.partitions.values():
            s = p.stats()
            for k in ("streams", "inmemory_rows", "file_rows",
                      "small_rows", "big_rows", "inmemory_parts",
                      "small_parts", "big_parts", "compressed_size",
                      "uncompressed_size", "pending_merges", "merges_done"):
                agg[k] += s[k]
            agg["flush_age_seconds"] = max(agg["flush_age_seconds"],
                                           s["flush_age_seconds"])
        return agg

    def close(self) -> None:
        """Flush and close every durable partition; a memory-only store
        drops its state."""
        for p in self.partitions.values():
            p.close()
        self.partitions.clear()
