"""One UTC day of a store: a stream index and a datadb.

A durable partition keeps both under its directory (`indexdb/` and
`datadb/`); a memory-only one (no directory) keeps a dict of streams
and in-memory parts.  Unseen streams are registered, durably, before
their rows reach the datadb, so a part never names a stream the index
lacks.
"""

from __future__ import annotations

import os

from .block_build import build_log_rows_blocks
from .datadb import MAX_INMEMORY_PARTS, DataDB
from .indexdb import IndexDB, MemoryIndex
from .log_rows import LogRows

INDEXDB_DIRNAME = "indexdb"
DATADB_DIRNAME = "datadb"


class Partition:
    def __init__(self, day: int, path: str | None = None,
                 flush_interval: float = 5.0,
                 max_inmemory_parts: int = MAX_INMEMORY_PARTS):
        """day: days since the Unix epoch (its directory is YYYYMMDD)."""
        self.day = day
        self.path = path
        if path is None:
            self.idb = MemoryIndex()
            self.ddb = DataDB(None, flush_interval, max_inmemory_parts)
        else:
            os.makedirs(path, exist_ok=True)
            self.idb = IndexDB(os.path.join(path, INDEXDB_DIRNAME))
            self.ddb = DataDB(os.path.join(path, DATADB_DIRNAME),
                              flush_interval, max_inmemory_parts)

    @property
    def streams(self) -> dict:
        """Stream id -> canonical tags of a memory-only partition."""
        return self.idb.streams

    @streams.setter
    def streams(self, value: dict) -> None:
        self.idb.streams = value

    @property
    def parts(self) -> list:
        """The flushed parts: small, then big."""
        return self.ddb.small_parts + self.ddb.big_parts

    @parts.setter
    def parts(self, value: list) -> None:
        self.ddb.small_parts = list(value)
        self.ddb.big_parts = []

    @property
    def _pending(self) -> list:
        """The in-memory parts of the batches not flushed yet."""
        return self.ddb.inmemory_parts

    def must_add_rows(self, lr: LogRows, idxs=None) -> None:
        """Add rows `idxs` of `lr` (all of them when None)."""
        if idxs is None:
            streams = list(lr.streams())
        else:
            sub = LogRows()
            for i in idxs:
                sub.timestamps.append(lr.timestamps[i])
                sub.rows.append(lr.rows[i])
                sub.stream_ids.append(lr.stream_ids[i])
                sub.stream_tags_str.append(lr.stream_tags_str[i])
            lr = sub
            streams = dict(zip(lr.stream_ids, lr.stream_tags_str)).items()
        self.idb.must_register_streams(streams)
        self.ddb.must_add_blocks(build_log_rows_blocks(lr))

    def must_add_columns(self, lc) -> None:
        """Add a LogColumns batch of this day."""
        self.idb.must_register_streams(lc.unique_streams())
        self.ddb.must_add_blocks(lc.build_blocks())

    def flush(self) -> None:
        """Make the index's log durable and flush the waiting batches."""
        self.idb.flush()
        self.ddb.flush_inmemory_parts()

    def force_merge(self) -> None:
        self.idb.force_merge()
        self.ddb.force_merge()

    def has_stream_id(self, sid) -> bool:
        return self.idb.has_stream_id(sid)

    def search_stream_ids(self, tenants, sf) -> set:
        """Stream ids of `tenants` whose tags match the stream filter
        (absent labels read as the empty string)."""
        return set(self.idb.search_stream_ids(list(tenants), sf))

    def snapshot_parts(self) -> list:
        """The parts a query walks: the unflushed batches' in-memory
        parts, oldest first, then the flushed parts."""
        return self.ddb.snapshot_parts()

    def stats(self) -> dict:
        s = self.ddb.stats()
        s["streams"] = self.idb.num_streams()
        return s

    def close(self) -> None:
        self.ddb.close()
        self.idb.close()
