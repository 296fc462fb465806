"""A partition's stream index: which stream ids match `{label=...}`, and
the canonical tags of a stream id.  It indexes stream labels only,
never message content.

`IndexDB` keeps a directory of levels, the JAX package's layout:

- immutable snapshot files (`streams.snap.NNNNNN`,
  storage/stream_snapshot.py), listed by the manifest
  `streams.parts.json`;
- a mutable tail of the streams registered since the last snapshot, in
  dicts and sets, backed by the append-only log `streams.jsonl`, which
  is fsynced before the rows that use the streams reach the datadb.

The tail becomes a new level once it holds COMPACT_TAIL_STREAMS streams
(or SNAPSHOT_MIN_TAIL at close); past MAX_SNAPSHOTS levels the
MERGE_BATCH smallest merge into one.  Nothing runs in the background:
the flush and the merges run inline in the registration that crosses
the bound, and `force_merge` merges every level into one.  Every file
is written to a `.tmp` name, fsynced and renamed, and the manifest's
rename is followed by an fsync of the directory.

On open, the levels of the manifest load and the log replays from the
offset the contiguous healthy levels cover; files the manifest does not
list and `.tmp` leftovers are removed.  When a level is torn, the whole
log replays and the replayed tail is written as a new level before the
manifest drops the torn one, so a stream of the torn level is never
left behind the replay offset of a later open.

The answers of `search_stream_ids` are kept in a two-generation cache
(utils/cache.py, the JAX package's filter cache), keyed by (tenants,
stream filter) and cleared wherever the streams or the levels change:
a registration, a new level, a merge.

`MemoryIndex` is the index of a memory-only partition: a dict.
"""

from __future__ import annotations

import heapq
import json
import os
import struct

import numpy as np

from ..utils.cache import TwoGenCache
from .log_rows import StreamID, TenantID
from .part import fsync_dir
from .stream_filter import StreamFilter, _compiled, parse_stream_tags
from .stream_snapshot import StreamSnapshot, merge_snapshots, write_snapshot

STREAMS_FILENAME = "streams.jsonl"
SNAPSHOT_FILENAME = "streams.snap"
MANIFEST_FILENAME = "streams.parts.json"

# a tail replayed at open (or left at close) of this many streams
# becomes a level at once
SNAPSHOT_MIN_TAIL = 10_000
# a live tail of this many streams becomes a level
COMPACT_TAIL_STREAMS = 250_000
# past MAX_SNAPSHOTS levels, the MERGE_BATCH smallest merge into one
MAX_SNAPSHOTS = 32
MERGE_BATCH = 10


def _ordered(grp):
    # '=' filters first: the cheapest and most selective
    return sorted(grp, key=lambda tf: 0 if tf.op == "=" else
                  1 if tf.op == "=~" else 2)


class MemoryIndex:
    """The stream index of a memory-only partition: stream id ->
    canonical tags."""

    def __init__(self):
        self.streams: dict = {}

    def has_stream_id(self, sid: StreamID) -> bool:
        return sid in self.streams

    def must_register_streams(self, streams) -> None:
        for sid, tags in streams:
            self.streams.setdefault(sid, tags)

    def get_stream_tags(self, sid: StreamID) -> str | None:
        return self.streams.get(sid)

    def search_stream_ids(self, tenants, sf: StreamFilter) -> list:
        """Stream ids of `tenants` whose tags match the filter (absent
        labels read as the empty string), sorted."""
        ts = set(tenants)
        return sorted(sid for sid, tags in self.streams.items()
                      if sid.tenant in ts
                      and sf.matches(parse_stream_tags(tags)))

    def all_stream_ids(self, tenants) -> list:
        ts = set(tenants)
        return sorted(sid for sid in self.streams if sid.tenant in ts)

    def num_streams(self) -> int:
        return len(self.streams)

    def flush(self) -> None:
        pass

    def force_merge(self) -> None:
        pass

    def close(self) -> None:
        pass


class IndexDB:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        # the tail: streams registered since the last level
        self._streams: dict[StreamID, str] = {}
        self._by_tenant: dict[TenantID, list[StreamID]] = {}
        self._postings: dict[TenantID, dict[str, dict[str, set]]] = {}
        self._label_any: dict[TenantID, dict[str, set]] = {}
        self._file_path = os.path.join(path, STREAMS_FILENAME)
        self._manifest_path = os.path.join(path, MANIFEST_FILENAME)
        self.snap_bytes_written = 0
        self.snap_files_written = 0
        self.merge_count = 0
        self._snaps: list[StreamSnapshot] = []      # oldest -> newest
        self._snap_files: list[str] = []            # parallel to _snaps
        self._snap_seq = 0
        # (tenants, stream filter) -> the matching stream ids
        self._filter_cache = TwoGenCache()
        replay_from, torn = self._load_levels()
        new_log = not os.path.exists(self._file_path)
        if not new_log:
            if replay_from > os.path.getsize(self._file_path):
                # the log is shorter than the levels say: trust none
                self._drop_all_levels()
                replay_from, torn = 0, True
            self._load(replay_from)
            # a torn last line would merge with the next append
            with open(self._file_path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size:
                    f.seek(size - 1)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                        f.flush()
                        os.fsync(f.fileno())
        self._file = open(self._file_path, "a", buffering=1 << 16)
        if new_log:
            fsync_dir(path)
        if torn and not self._streams:
            self._write_manifest()
        elif torn or len(self._streams) >= SNAPSHOT_MIN_TAIL:
            self._flush_tail()

    # ---- levels and manifest ----

    def _load_levels(self) -> tuple[int, bool]:
        """Load the manifest's levels; (the log offset to replay from,
        whether the manifest or a level was torn).  The offset is the
        coverage of the contiguous healthy levels, 0 once any is torn;
        later healthy levels stay loaded and dedupe the replay.  The
        manifest is not rewritten here: a torn level stays listed until
        its streams are in a new level."""
        files: list[str] = []
        torn = False
        if os.path.exists(self._manifest_path):
            try:
                with open(self._manifest_path) as f:
                    files = json.load(f)["files"]
            except (OSError, ValueError, KeyError, TypeError):
                files, torn = [], True
        loaded: list[tuple[str, StreamSnapshot | None]] = []
        for fn in files:
            try:
                loaded.append((fn, StreamSnapshot(os.path.join(self.path,
                                                               fn))))
            except (OSError, ValueError, KeyError, TypeError,
                    struct.error):
                loaded.append((fn, None))
                torn = True
        loaded.sort(key=lambda t: t[1].log_offset if t[1] else -1)
        replay_from = 0
        healthy_prefix = True
        for fn, snap in loaded:
            if snap is None:
                healthy_prefix = False
                continue
            if healthy_prefix:
                replay_from = max(replay_from, snap.log_offset)
            self._snaps.append(snap)
            self._snap_files.append(fn)
        listed = set(files)
        for fn in os.listdir(self.path):
            if (fn.startswith(SNAPSHOT_FILENAME) and fn not in listed) or \
                    fn.endswith(".tmp"):
                os.remove(os.path.join(self.path, fn))
        for fn in files:
            try:
                self._snap_seq = max(self._snap_seq,
                                     int(fn.rsplit(".", 1)[1]) + 1)
            except (IndexError, ValueError):
                pass
        return replay_from, torn

    def _drop_all_levels(self) -> None:
        for s in self._snaps:
            s.close()
        for fn in self._snap_files:
            os.remove(os.path.join(self.path, fn))
        self._snaps.clear()
        self._snap_files.clear()
        self._write_manifest()

    def _write_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"files": self._snap_files}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)
        fsync_dir(self.path)
        # files the manifest no longer lists (torn or merged levels)
        live = set(self._snap_files)
        for fn in os.listdir(self.path):
            if fn.startswith(SNAPSHOT_FILENAME) and fn not in live and \
                    not fn.endswith(".tmp"):
                os.remove(os.path.join(self.path, fn))

    def _next_snap_file(self) -> str:
        fn = f"{SNAPSHOT_FILENAME}.{self._snap_seq:06d}"
        self._snap_seq += 1
        return fn

    def _load(self, offset: int) -> None:
        with open(self._file_path) as f:
            if offset:
                f.seek(offset)
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a torn write before a crash
                sid = StreamID(TenantID(rec["a"], rec["p"]),
                               rec["h"], rec["l"])
                if any(s.find(sid) >= 0 for s in reversed(self._snaps)):
                    continue
                self._register_mem(sid, rec["t"])

    def _register_mem(self, sid: StreamID, tags_str: str) -> None:
        if sid in self._streams:
            return
        self._streams[sid] = tags_str
        self._by_tenant.setdefault(sid.tenant, []).append(sid)
        postings = self._postings.setdefault(sid.tenant, {})
        label_any = self._label_any.setdefault(sid.tenant, {})
        for label, value in parse_stream_tags(tags_str).items():
            postings.setdefault(label, {}).setdefault(value, set()).add(sid)
            label_any.setdefault(label, set()).add(sid)

    def _clear_tail(self) -> None:
        self._streams.clear()
        self._by_tenant.clear()
        self._postings.clear()
        self._label_any.clear()

    def _account(self, path: str) -> None:
        self.snap_bytes_written += os.path.getsize(path)
        self.snap_files_written += 1

    def _flush_tail(self) -> None:
        """The tail as a new level covering the whole log; the levels
        before it stay as they are."""
        self._file.flush()
        os.fsync(self._file.fileno())
        fn = self._next_snap_file()
        p = os.path.join(self.path, fn)
        write_snapshot(p, dict(self._streams),
                       os.path.getsize(self._file_path))
        self._account(p)
        self._snaps.append(StreamSnapshot(p))
        self._snap_files.append(fn)
        self._write_manifest()
        self._clear_tail()
        self._filter_cache.clear()

    def _merge(self, pick: list[int]) -> None:
        """Merge the levels at indexes `pick` into one, appended last."""
        srcs = [self._snaps[i] for i in pick]
        fn = self._next_snap_file()
        p = os.path.join(self.path, fn)
        merge_snapshots(p, srcs, max(s.log_offset for s in srcs))
        self._account(p)
        gone = set(pick)
        keep = [i for i in range(len(self._snaps)) if i not in gone]
        self._snaps = [self._snaps[i] for i in keep] + [StreamSnapshot(p)]
        self._snap_files = [self._snap_files[i] for i in keep] + [fn]
        self._write_manifest()
        self.merge_count += 1
        self._filter_cache.clear()
        for s in srcs:
            s.close()

    def _merge_levels_if_needed(self) -> None:
        while len(self._snaps) > MAX_SNAPSHOTS:
            order = sorted(range(len(self._snaps)),
                           key=lambda i: self._snaps[i].n)
            self._merge(sorted(order[:MERGE_BATCH]))

    def force_merge(self) -> None:
        """Every level, and the tail, into one level."""
        if self._streams:
            self._flush_tail()
        if len(self._snaps) > 1:
            self._merge(list(range(len(self._snaps))))

    def flush(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file.closed:
            return
        self.flush()
        if len(self._streams) >= SNAPSHOT_MIN_TAIL:
            self._flush_tail()
        self._file.close()
        for s in self._snaps:
            s.close()

    # ---- the write path ----

    def has_stream_id(self, sid: StreamID) -> bool:
        return sid in self._streams or any(
            s.find(sid) >= 0 for s in reversed(self._snaps))

    def must_register_streams(
            self, streams: list[tuple[StreamID, str]]) -> None:
        """Register the new streams among `streams`, durably: the log is
        fsynced before this returns, so rows that reach a part never
        name a stream the index lacks.  Membership in the levels is
        checked a tenant at a time, vectorized."""
        cand = [(sid, tags) for sid, tags in streams
                if sid not in self._streams]
        if cand and self._snaps:
            by_tenant: dict[TenantID, list[int]] = {}
            for k, (sid, _t) in enumerate(cand):
                by_tenant.setdefault(sid.tenant, []).append(k)
            known = np.zeros(len(cand), dtype=bool)
            for tenant, idxs in by_tenant.items():
                hi = np.fromiter((cand[k][0].hi for k in idxs),
                                 dtype=np.uint64, count=len(idxs))
                lo = np.fromiter((cand[k][0].lo for k in idxs),
                                 dtype=np.uint64, count=len(idxs))
                mask = np.zeros(len(idxs), dtype=bool)
                for s in reversed(self._snaps):
                    if mask.all():
                        break
                    mask |= s.contains_batch(tenant, hi, lo)
                known[np.asarray(idxs)[mask]] = True
            cand = [c for k, c in enumerate(cand) if not known[k]]
        wrote = False
        for sid, tags_str in cand:
            if sid in self._streams:
                continue
            self._register_mem(sid, tags_str)
            self._file.write(json.dumps({
                "a": sid.tenant.account_id, "p": sid.tenant.project_id,
                "h": sid.hi, "l": sid.lo, "t": tags_str,
            }, separators=(",", ":")) + "\n")
            wrote = True
        if wrote:
            self.flush()
            # registrations change what a filter matches
            self._filter_cache.clear()
            if len(self._streams) >= COMPACT_TAIL_STREAMS:
                self._flush_tail()
                self._merge_levels_if_needed()

    # ---- the read path ----

    def get_stream_tags(self, sid: StreamID) -> str | None:
        got = self._streams.get(sid)
        if got is not None:
            return got
        for s in reversed(self._snaps):
            i = s.find(sid)
            if i >= 0:
                return s.tags_at(i)
        return None

    def _match_tail(self, tenant: TenantID, tf, all_sids: set) -> set:
        """The tail's streams matching one tag filter; an absent label
        reads as the empty string."""
        postings = self._postings.get(tenant, {}).get(tf.label, {})
        label_any = self._label_any.get(tenant, {}).get(tf.label, set())
        if tf.op == "=":
            if tf.value == "":
                return all_sids - label_any
            return set(postings.get(tf.value, ()))
        if tf.op == "!=":
            if tf.value == "":
                return set(label_any)
            return all_sids - postings.get(tf.value, set())
        rx = _compiled(tf.value)
        hit: set = set()
        for value, sids in postings.items():
            if rx.fullmatch(value) is not None:
                hit |= sids
        if rx.fullmatch("") is not None:
            hit |= all_sids - label_any
        if tf.op == "=~":
            return hit
        return all_sids - hit                      # '!~'

    @staticmethod
    def _match_snap(snap: StreamSnapshot, tenant: TenantID, tf):
        """A level's rows matching one tag filter, as sorted uint32 row
        indexes."""
        s, e = snap.tenant_range(tenant)
        universe = np.arange(s, e, dtype=np.uint32)
        lp = snap.label_postings(tenant, tf.label)
        empty = np.empty(0, dtype=np.uint32)
        any_idx = lp.any_idx if lp is not None else empty
        if tf.op == "=":
            if tf.value == "":
                return np.setdiff1d(universe, any_idx, assume_unique=True)
            return lp.lookup(tf.value) if lp is not None else empty
        if tf.op == "!=":
            if tf.value == "":
                return any_idx
            miss = lp.lookup(tf.value) if lp is not None else empty
            return np.setdiff1d(universe, miss, assume_unique=True)
        rx = _compiled(tf.value)
        hits = [idxs for value, idxs in (lp.items() if lp is not None
                                         else ())
                if rx.fullmatch(value) is not None]
        hit = np.unique(np.concatenate(hits)) if hits else empty
        if rx.fullmatch("") is not None:
            hit = np.union1d(hit, np.setdiff1d(universe, any_idx,
                                               assume_unique=True))
        if tf.op == "=~":
            return hit
        return np.setdiff1d(universe, hit, assume_unique=True)  # '!~'

    def search_stream_ids(self, tenants: list[TenantID],
                          sf: StreamFilter) -> list[StreamID]:
        """Stream ids of `tenants` whose tags match the filter, sorted."""
        key = (tuple(tenants), sf)
        cached = self._filter_cache.get(key)
        if cached is not None:
            return cached
        result: set[StreamID] = set()
        for t in tenants:
            tail_all = set(self._by_tenant.get(t, ()))
            if not tail_all:
                continue
            for grp in sf.or_groups:
                cand: set | None = None
                for tf in _ordered(grp):
                    m = self._match_tail(t, tf, tail_all)
                    cand = m if cand is None else cand & m
                    if not cand:
                        break
                result |= cand if cand is not None else tail_all
        lists = [sorted(result)]
        for snap in self._snaps:
            chunks: list = []
            for t in tenants:
                s, e = snap.tenant_range(t)
                if s == e:
                    continue
                for grp in sf.or_groups:
                    scand = None
                    for tf in _ordered(grp):
                        m = self._match_snap(snap, t, tf)
                        scand = m if scand is None else \
                            np.intersect1d(scand, m, assume_unique=True)
                        if not scand.size:
                            break
                    if scand is None:
                        scand = np.arange(s, e, dtype=np.uint32)
                    if scand.size:
                        chunks.append(scand)
            if chunks:
                # rows are sorted by (tenant, hi, lo), StreamID's order
                lists.append(snap.streams_at(
                    np.unique(np.concatenate(chunks))))
        out = list(heapq.merge(*lists))
        self._filter_cache.put(key, out)
        return out

    def all_stream_ids(self, tenants: list[TenantID]) -> list[StreamID]:
        out: list[StreamID] = []
        for t in tenants:
            out.extend(self._by_tenant.get(t, ()))
        for snap in self._snaps:
            for t in tenants:
                s, e = snap.tenant_range(t)
                if s != e:
                    out.extend(snap.streams_at(
                        np.arange(s, e, dtype=np.uint32)))
        out.sort()
        return out

    def num_streams(self) -> int:
        return len(self._streams) + sum(s.n for s in self._snaps)
