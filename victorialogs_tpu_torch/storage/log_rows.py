"""Ingestion row model: tenants, stream IDs, row and column batches.

A log stream is identified by (tenant, 128-bit hash of the canonical
sorted stream-label string); a tenant is (AccountID, ProjectID).
`LogRows` holds a batch row by row, `LogColumns` column by column
(the insert path's bulk form).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..utils.hashing import stream_id_hash


@dataclass(frozen=True, order=True)
class TenantID:
    account_id: int = 0
    project_id: int = 0


@dataclass(frozen=True, order=True)
class StreamID:
    tenant: TenantID
    hi: int
    lo: int

    def as_string(self) -> str:
        """48 hex chars: tenant, then the 128-bit hash."""
        return f"{self.tenant.account_id:08x}{self.tenant.project_id:08x}" \
               f"{self.hi:016x}{self.lo:016x}"


def parse_stream_id(s: str) -> StreamID | None:
    """The StreamID whose as_string() is `s`, else None."""
    if len(s) != 48:
        return None
    try:
        sid = StreamID(TenantID(int(s[:8], 16), int(s[8:16], 16)),
                       int(s[16:32], 16), int(s[32:], 16))
    except ValueError:
        return None
    return sid if sid.as_string() == s else None


def canonical_stream_tags(tags: list[tuple[str, str]]) -> str:
    """Canonical `{k1="v1",k2="v2"}` rendering, sorted by label name."""
    inner = ",".join(f'{k}={_quote(v)}' for k, v in sorted(tags))
    return "{" + inner + "}"


def _quote(v: str) -> str:
    return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'


@dataclass
class LogRows:
    """A batch of rows destined for one Storage, with per-row stream IDs.

    stream_fields: field names that define the stream (`_stream_fields`);
    ignore_fields: field names (or `prefix*` patterns) dropped on add;
    extra_fields: fields appended to every row;
    default_msg_value: the `_msg` of a row that has none.
    """

    stream_fields: list[str] = dc_field(default_factory=list)
    ignore_fields: list[str] = dc_field(default_factory=list)
    extra_fields: list[tuple[str, str]] = dc_field(default_factory=list)
    default_msg_value: str = ""

    timestamps: list[int] = dc_field(default_factory=list)
    rows: list[list[tuple[str, str]]] = dc_field(default_factory=list)
    stream_ids: list[StreamID] = dc_field(default_factory=list)
    stream_tags_str: list[str] = dc_field(default_factory=list)
    _stream_cache: dict = dc_field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.timestamps)

    def streams(self):
        """(stream id, canonical tags) of every stream added so far."""
        return self._stream_cache.values()

    def add(self, tenant: TenantID, timestamp: int,
            fields: list[tuple[str, str]]) -> None:
        """Append one row after the field rules; `_time` fields are
        dropped and a repeated field name keeps its first value."""
        if self.ignore_fields or self.extra_fields:
            fields = self._apply_field_rules(fields)
        seen: set[str] = set()
        clean: list[tuple[str, str]] = []
        has_msg = False
        for k, v in fields:
            if k == "_time":
                continue
            if k == "_msg":
                has_msg = True
            if k in seen:
                continue
            seen.add(k)
            clean.append((k, v))
        if not has_msg and self.default_msg_value:
            clean.append(("_msg", self.default_msg_value))
        stream_tags = tuple((k, v) for k, v in clean
                            if k in self.stream_fields)
        key = (tenant, stream_tags)
        cached = self._stream_cache.get(key)
        if cached is None:
            tags_str = canonical_stream_tags(list(stream_tags))
            hi, lo = stream_id_hash(tags_str.encode("utf-8"))
            cached = self._stream_cache[key] = (StreamID(tenant, hi, lo),
                                                tags_str)
        sid, tags_str = cached
        self.timestamps.append(timestamp)
        self.rows.append(clean)
        self.stream_ids.append(sid)
        self.stream_tags_str.append(tags_str)

    def _apply_field_rules(
            self, fields: list[tuple[str, str]]) -> list[tuple[str, str]]:
        out = [(k, v) for k, v in fields
               if not match_any(k, self.ignore_fields)]
        out.extend(self.extra_fields)
        return out

    def reset(self) -> None:
        self.timestamps.clear()
        self.rows.clear()
        self.stream_ids.clear()
        self.stream_tags_str.clear()


def match_any(name: str, patterns: list[str]) -> bool:
    """True when `name` equals a pattern or starts with a `prefix*` one."""
    for p in patterns:
        if p.endswith("*"):
            if name.startswith(p[:-1]):
                return True
        elif name == p:
            return True
    return False


class LogColumns:
    """Columnar ingestion batch: rows grouped by field schema (the exact
    name tuple), values kept per column, streams interned in a table per
    group (rows carry a small int ref).  The insert path's bulk form:
    a row added here as (names, values) yields exactly the row that
    LogRows.add(fields=zip(names, values)) would, so callers apply the
    time field, the `_msg` renaming and the field rules first
    (server/vlinsert._SchemaPlan does, once per schema)."""

    def __init__(self):
        self.groups: dict[tuple, _ColGroup] = {}
        self.nrows = 0
        self.stream_tags: dict = {}       # StreamID -> canonical tags

    def group(self, names: tuple, stream_pos: tuple) -> "_ColGroup":
        g = self.groups.get(names)
        if g is None:
            g = self.groups[names] = _ColGroup(names, stream_pos)
        return g

    def add(self, g: "_ColGroup", tenant: TenantID, ts: int, values: list,
            sid: StreamID, tags: str) -> None:
        g.ts.append(ts)
        g.sref.append(self.intern_stream(g, tenant, sid, tags))
        for col, v in zip(g.cols, values):
            col.append(v)
        self.nrows += 1

    def intern_stream(self, g: "_ColGroup", tenant: TenantID,
                      sid: StreamID, tags: str) -> int:
        """A stream's ref in g's table, registered batch-wide on first
        sight.  Callers that cache the ref under a cheap key (vlinsert's
        raw stream values) pay the StreamID hash once a stream."""
        si = g.stream_idx.get(sid)
        if si is None:
            si = g.stream_idx[sid] = len(g.streams)
            g.streams.append((sid, tenant, tags))
            self.stream_tags.setdefault(sid, tags)
        return si

    def add_bulk_refs(self, g: "_ColGroup", ts_list: list,
                      col_lists: list, srefs: list) -> None:
        """Append many rows of one schema whose stream refs are already
        interned: one extend a column."""
        g.ts.extend(ts_list)
        g.sref.extend(srefs)
        for col, vals in zip(g.cols, col_lists):
            col.extend(vals)
        self.nrows += len(ts_list)

    def add_bulk(self, g: "_ColGroup", tenant: TenantID, ts_list: list,
                 col_lists: list, sid_list: list, tags_list: list) -> None:
        """Append many rows of one schema with their stream ids."""
        srefs = [self.intern_stream(g, tenant, sid, tags)
                 for sid, tags in zip(sid_list, tags_list)]
        self.add_bulk_refs(g, ts_list, col_lists, srefs)

    def unique_streams(self) -> list:
        return list(self.stream_tags.items())

    def split_by_day(self, min_ts: int, max_ts: int, ns_per_day: int):
        """(day -> LogColumns, rows older than min_ts, rows newer than
        max_ts).  A batch of one day with nothing dropped is returned
        as it is."""
        days = set()
        old = new = 0
        masks = {}
        for key, g in self.groups.items():
            ts = np.asarray(g.ts, dtype=np.int64)
            ok = (ts >= min_ts) & (ts <= max_ts)
            old += int((ts < min_ts).sum())
            new += int((ts > max_ts).sum())
            d = ts // ns_per_day
            masks[key] = (ok, d)
            days.update(np.unique(d[ok]).tolist())
        if not days:
            return {}, old, new
        if len(days) == 1 and old == 0 and new == 0:
            return {next(iter(days)): self}, 0, 0
        out = {}
        for day in days:
            sub = LogColumns()
            for key, g in self.groups.items():
                ok, d = masks[key]
                idxs = np.nonzero(ok & (d == day))[0]
                if not idxs.size:
                    continue
                sg = sub.group(g.names, g.stream_pos)
                for i in idxs.tolist():
                    sid, tenant, tags = g.streams[g.sref[i]]
                    sub.add(sg, tenant, g.ts[i],
                            [c[i] for c in g.cols], sid, tags)
            out[day] = sub
        return out, old, new

    def build_blocks(self) -> list:
        """The batch as columnar blocks sorted by (stream, time)."""
        from .block_build import build_columns_blocks
        return build_columns_blocks(self)


class _ColGroup:
    """One schema group of a LogColumns batch."""

    __slots__ = ("names", "stream_pos", "cols", "ts", "sref",
                 "streams", "stream_idx", "key_idx")

    def __init__(self, names: tuple, stream_pos: tuple):
        self.names = names
        self.stream_pos = stream_pos
        self.cols = [[] for _ in names]
        self.ts: list = []
        self.sref: list = []
        self.streams: list = []        # (sid, tenant, tags_str)
        self.stream_idx: dict = {}
        # producer-side cache: raw stream values -> sref (vlinsert)
        self.key_idx: dict = {}
