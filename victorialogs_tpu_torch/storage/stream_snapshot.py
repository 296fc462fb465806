"""Stream-index snapshot files: the immutable levels of the stream index
(storage/indexdb.py).

A file (`streams.snap.NNNNNN`, format v2, the JAX package's) is
`VLSNAP2\\n`, a 4-byte big-endian header length, a JSON header (stream
count, tenants, the log offset it covers, the label directory and the
section directory), then the sections:

- the registry, raw: streams sorted by (tenant, hi, lo) as u32
  tenant_idx[], u64 hi[], u64 lo[] and u64 tag offsets, read as numpy
  views of a memory map, so opening a file reads only its header;
- the canonical tags of every stream, one compressed blob, decompressed
  at the first `tags_at`;
- one compressed section a (tenant, label): a sorted fixed-width value
  table (binary-searched for `=`, decoded for regexps), per-value slices
  of one u32 stream-index blob, and the label's "any" list.  A section
  decompresses the first time a query touches its label.

Files are written to a `.tmp` name, fsynced and renamed.
`merge_snapshots` is the level merge: an array-level k-way merge that
decodes no stream into Python objects.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np

from ..utils import zstd as _zstd
from .log_rows import StreamID, TenantID
from .stream_filter import parse_stream_tags

SNAP2_MAGIC = b"VLSNAP2\n"

_REGISTRY_SECTIONS = ("t_idx", "hi", "lo", "tag_off")
_MAX_SECTION_BYTES = 1 << 33


def _finish_snapshot(path: str, arrays: dict, n: int, tenants: list,
                     labels_meta: dict, log_offset: int) -> None:
    """Write the sections of `arrays` as the file `path` (tmp, fsync,
    rename)."""
    payloads: list = []
    sections: dict = {}
    off = 0

    def add(name: str, data, dtype: str, comp: str) -> None:
        nonlocal off
        sections[name] = {"off": off, "len": len(data), "dtype": dtype,
                          "comp": comp}
        payloads.append(data)
        off += len(data)

    for name in _REGISTRY_SECTIONS:
        arr = np.ascontiguousarray(arrays[name])
        add(name, memoryview(arr).cast("B"), str(arr.dtype), "raw")
    add("tags_blob", _zstd.compress(arrays["tags_blob"], level=3),
        "bytes", "zstd")
    for ti_s, labels in labels_meta.items():
        for label in labels:
            base = f"p{ti_s}:{label}"
            v = np.ascontiguousarray(arrays[base + ":v"])
            c = np.ascontiguousarray(arrays[base + ":c"], dtype=np.uint32)
            i = np.ascontiguousarray(arrays[base + ":i"], dtype=np.uint32)
            a = np.ascontiguousarray(arrays[base + ":a"], dtype=np.uint32)
            blob = struct.pack("<IIQQ", v.size, v.dtype.itemsize or 1,
                               i.size, a.size) + \
                v.tobytes() + c.tobytes() + i.tobytes() + a.tobytes()
            add(base, _zstd.compress(blob, level=3), "label", "zstd")

    header = json.dumps({
        "n": n, "tenants": tenants, "sections": sections,
        "labels": labels_meta, "log_offset": log_offset,
    }, separators=(",", ":")).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(SNAP2_MAGIC)
        f.write(struct.pack(">I", len(header)))
        f.write(header)
        for data in payloads:
            f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _emit_label(arrays: dict, labels_meta: dict, ti: int, label: str,
                values: dict, any_arr) -> None:
    """One (tenant, label) posting table into `arrays`."""
    vkeys = sorted(values, key=lambda v: v.encode("utf-8"))
    vbytes = [v.encode("utf-8") for v in vkeys]
    w = max((len(b) for b in vbytes), default=1) or 1
    vtab = np.zeros((len(vkeys),), dtype=f"S{w}")
    counts = np.empty(len(vkeys), dtype=np.uint32)
    chunks = []
    for k, (vk, vb) in enumerate(zip(vkeys, vbytes)):
        vtab[k] = vb
        ids = values[vk]
        counts[k] = len(ids)
        chunks.append(np.asarray(ids, dtype=np.uint32))
    base = f"p{ti}:{label}"
    arrays[base + ":v"] = vtab
    arrays[base + ":c"] = counts
    arrays[base + ":i"] = np.concatenate(chunks) if chunks else \
        np.empty(0, dtype=np.uint32)
    arrays[base + ":a"] = np.asarray(any_arr, dtype=np.uint32)
    labels_meta.setdefault(str(ti), {})[label] = {"w": w}


def write_snapshot(path: str, streams: dict, log_offset: int) -> None:
    """streams: StreamID -> canonical tags (any order)."""
    items = sorted(
        (sid.tenant.account_id, sid.tenant.project_id, sid.hi, sid.lo, tags)
        for sid, tags in streams.items())
    n = len(items)
    tenants: list[tuple[int, int]] = []
    tenant_idx_of: dict[tuple[int, int], int] = {}
    t_idx = np.empty(n, dtype=np.uint32)
    hi = np.empty(n, dtype=np.uint64)
    lo = np.empty(n, dtype=np.uint64)
    tag_off = np.empty(n + 1, dtype=np.uint64)
    tag_parts = []
    pos = 0
    for i, (a, p, h, lw, tags) in enumerate(items):
        ti = tenant_idx_of.get((a, p))
        if ti is None:
            ti = tenant_idx_of[(a, p)] = len(tenants)
            tenants.append((a, p))
        t_idx[i] = ti
        hi[i] = h
        lo[i] = lw
        tag_off[i] = pos
        b = tags.encode("utf-8")
        tag_parts.append(b)
        pos += len(b)
    tag_off[n] = pos

    # per (tenant, label): value -> [stream indexes]
    post: dict = {}
    for i, (a, p, _h, _l, tags) in enumerate(items):
        per = post.setdefault(tenant_idx_of[(a, p)], {})
        for label, value in parse_stream_tags(tags).items():
            per.setdefault(label, {}).setdefault(value, []).append(i)

    arrays = {"t_idx": t_idx, "hi": hi, "lo": lo, "tag_off": tag_off,
              "tags_blob": b"".join(tag_parts)}
    labels_meta: dict = {}
    for ti, per in post.items():
        for label, values in per.items():
            any_arr = np.fromiter(
                sorted({i for ids in values.values() for i in ids}),
                dtype=np.uint32)
            _emit_label(arrays, labels_meta, ti, label, values, any_arr)
    _finish_snapshot(path, arrays, n, tenants, labels_meta, log_offset)


def merge_snapshots(path: str, snaps: list["StreamSnapshot"],
                    log_offset: int) -> None:
    """Merge snapshot files into one.  The registry columns merge by one
    lexsort over the concatenated arrays, posting lists remap through
    the source-row -> new-row map and regroup by a stable two-pass
    sort, the tags copy by one byte gather.  A stream in several
    sources keeps one row."""
    n_srcs = [s.n for s in snaps]
    n_total = sum(n_srcs)
    base_of = np.zeros(len(snaps) + 1, dtype=np.int64)
    np.cumsum(np.asarray(n_srcs, dtype=np.int64), out=base_of[1:])

    tenant_keys = sorted({(t.account_id, t.project_id)
                          for s in snaps for t in s.tenants})
    tenant_idx_of = {t: i for i, t in enumerate(tenant_keys)}

    def src_cols(s):
        tn = np.asarray([[t.account_id, t.project_id] for t in s.tenants],
                        dtype=np.int64) if s.tenants else \
            np.empty((0, 2), dtype=np.int64)
        return tn[:, 0][s.t_idx], tn[:, 1][s.t_idx]

    cols = [src_cols(s) for s in snaps]
    acct = np.concatenate([c[0] for c in cols])
    proj = np.concatenate([c[1] for c in cols])
    hi = np.concatenate([s.hi for s in snaps])
    lo = np.concatenate([s.lo for s in snaps])
    perm = np.lexsort((lo, hi, proj, acct))

    sa, sp_, sh, sl = acct[perm], proj[perm], hi[perm], lo[perm]
    first = np.ones(n_total, dtype=bool)
    if n_total > 1:
        first[1:] = ~((sa[1:] == sa[:-1]) & (sp_[1:] == sp_[:-1]) &
                      (sh[1:] == sh[:-1]) & (sl[1:] == sl[:-1]))
    new_idx_sorted = np.cumsum(first) - 1          # sorted pos -> new row
    n = int(new_idx_sorted[-1]) + 1 if n_total else 0
    new_of = np.empty(n_total, dtype=np.int64)     # source pos -> new row
    new_of[perm] = new_idx_sorted

    keep_pos = perm[first]
    t_idx_all = np.fromiter(
        (tenant_idx_of[(int(a), int(p))]
         for a, p in zip(sa[first], sp_[first])),
        dtype=np.uint32, count=n)

    # tags: gather the kept rows' bytes from the concatenated blobs, in
    # chunks of ~8 MB of payload (an index entry a byte costs 8x that)
    blob_base = np.zeros(len(snaps) + 1, dtype=np.int64)
    np.cumsum(np.asarray([len(s.tags_blob) for s in snaps],
                         dtype=np.int64), out=blob_base[1:])
    if n_total:
        src_tag_start = np.concatenate(
            [s.tag_off[:s.n].astype(np.int64) + blob_base[k]
             for k, s in enumerate(snaps)])
        src_tag_len = np.concatenate(
            [np.diff(s.tag_off.astype(np.int64)) for s in snaps])
    else:
        src_tag_start = src_tag_len = np.empty(0, dtype=np.int64)
    lens_kept = src_tag_len[keep_pos]
    tag_off = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(lens_kept, out=tag_off[1:])
    total_bytes = int(tag_off[n])
    big_src = np.frombuffer(b"".join(s.tags_blob for s in snaps),
                            dtype=np.uint8)
    out_off = tag_off[:n].astype(np.int64)
    tags_out = np.empty(total_bytes, dtype=np.uint8)
    chunk_bytes = 8 << 20
    row = 0
    while row < n:
        hic = int(np.searchsorted(out_off, out_off[row] + chunk_bytes,
                                  "right"))
        hic = max(hic, row + 1)
        lens_c = lens_kept[row:hic]
        nb = int(lens_c.sum())
        if nb:
            dst0 = int(out_off[row])
            gather = (np.repeat(src_tag_start[keep_pos[row:hic]] -
                                (out_off[row:hic] - dst0), lens_c) +
                      np.arange(nb, dtype=np.int64))
            tags_out[dst0:dst0 + nb] = big_src[gather]
        row = hic

    arrays = {"t_idx": t_idx_all, "hi": sh[first], "lo": sl[first],
              "tag_off": tag_off, "tags_blob": tags_out.tobytes()}

    by_key: dict = {}            # (new tenant, label) -> [(vals, ids, any)]
    for k, s in enumerate(snaps):
        old_keys = [(t.account_id, t.project_id) for t in s.tenants]
        for old_ti_s, labels in s.labels_meta.items():
            old_ti = int(old_ti_s)
            ti = tenant_idx_of[old_keys[old_ti]]
            for label in labels:
                vtab, counts, idx_blob, any_blob = \
                    s.label_arrays(old_ti, label)
                ids = new_of[base_of[k] + idx_blob.astype(np.int64)]
                any_ids = new_of[base_of[k] + any_blob.astype(np.int64)]
                by_key.setdefault((ti, label), []).append(
                    (np.repeat(vtab, counts), ids, any_ids))

    labels_meta: dict = {}
    for (ti, label), parts in by_key.items():
        w = max(int(v.dtype.itemsize) for v, _i, _a in parts) or 1
        vcat = np.concatenate([v.astype(f"S{w}") for v, _i, _a in parts])
        icat = np.concatenate([i for _v, i, _a in parts])
        # a stable two-pass sort: by (value, id) without S-dtype keys
        o1 = np.argsort(icat, kind="stable")
        o2 = np.argsort(vcat[o1], kind="stable")
        order = o1[o2]
        sv, si = vcat[order], icat[order]
        if sv.size > 1:
            dup = (sv[1:] == sv[:-1]) & (si[1:] == si[:-1])
            if dup.any():
                keep = np.concatenate([[True], ~dup])
                sv, si = sv[keep], si[keep]
        if sv.size:
            starts = np.concatenate(
                [[True], sv[1:] != sv[:-1]]).nonzero()[0]
            vtab_new = sv[starts]
            counts_new = np.diff(
                np.concatenate([starts, [sv.size]])).astype(np.uint32)
        else:
            vtab_new = sv
            counts_new = np.empty(0, dtype=np.uint32)
        any_new = np.unique(np.concatenate([a for _v, _i, a in parts]))
        base = f"p{ti}:{label}"
        arrays[base + ":v"] = vtab_new
        arrays[base + ":c"] = counts_new
        arrays[base + ":i"] = si.astype(np.uint32)
        arrays[base + ":a"] = any_new.astype(np.uint32)
        labels_meta.setdefault(str(ti), {})[label] = {"w": w}

    _finish_snapshot(path, arrays, n, tenant_keys, labels_meta, log_offset)


class LabelPostings:
    """One (tenant, label)'s posting tables."""

    __slots__ = ("values", "counts", "idx_starts", "idx_blob", "any_idx",
                 "_decoded")

    def __init__(self, values, counts, idx_blob, any_idx):
        self.values = values                     # S-array, sorted
        self.counts = counts
        self.idx_starts = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.idx_starts[1:])
        self.idx_blob = idx_blob
        self.any_idx = any_idx
        self._decoded: list | None = None

    def lookup(self, value: str) -> np.ndarray:
        """Stream indexes of label == value (empty when absent)."""
        vb = value.encode("utf-8")
        if len(vb) > self.values.dtype.itemsize:
            return np.empty(0, dtype=np.uint32)
        k = np.searchsorted(self.values, np.bytes_(vb))
        if k >= len(self.values) or self.values[k] != vb:
            return np.empty(0, dtype=np.uint32)
        return self.idx_blob[self.idx_starts[k]:self.idx_starts[k + 1]]

    def items(self):
        """(value, indexes) pairs: regexps walk every value."""
        if self._decoded is None:
            self._decoded = [v.decode("utf-8") for v in self.values]
        for k, v in enumerate(self._decoded):
            yield v, self.idx_blob[self.idx_starts[k]:self.idx_starts[k + 1]]


class StreamSnapshot:
    """A read-only view of one snapshot file; `close()` drops its map."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(len(SNAP2_MAGIC)) != SNAP2_MAGIC:
                raise ValueError(f"{path}: not a v2 stream snapshot")
            hlen = struct.unpack(">I", f.read(4))[0]
            hdr = json.loads(f.read(hlen))
            self._sections = hdr["sections"]
            need = len(SNAP2_MAGIC) + 4 + hlen + max(
                (m["off"] + m["len"] for m in self._sections.values()),
                default=0)
            if os.fstat(f.fileno()).st_size < need:
                raise ValueError(f"{path}: truncated snapshot")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._data0 = len(SNAP2_MAGIC) + 4 + hlen
        self.n = hdr["n"]
        self.log_offset = hdr["log_offset"]
        self.tenants = [TenantID(a, p) for a, p in hdr["tenants"]]
        self.labels_meta = hdr["labels"]
        self.t_idx = self._reg_array("t_idx")
        self.hi = self._reg_array("hi")
        self.lo = self._reg_array("lo")
        self.tag_off = self._reg_array("tag_off")
        self._tags_blob: bytes | None = None
        self._tenant_idx = {t: i for i, t in enumerate(self.tenants)}
        self._postings_cache: dict = {}
        # rows are sorted by (tenant, hi, lo): one slice a tenant
        self._tenant_bounds = np.searchsorted(
            self.t_idx, np.arange(len(self.tenants) + 1, dtype=np.uint32))

    def close(self) -> None:
        """Drop the map once no view of it is left; views a caller still
        holds keep it until they go."""
        mm, self._mm = self._mm, None
        self.t_idx = self.hi = self.lo = self.tag_off = None
        self._postings_cache = {}
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass

    def _reg_array(self, name: str) -> np.ndarray:
        m = self._sections[name]
        dt = np.dtype(m["dtype"])
        return np.frombuffer(self._mm, dtype=dt,
                             count=m["len"] // dt.itemsize,
                             offset=self._data0 + m["off"])

    def _section_bytes(self, name: str) -> bytes:
        m = self._sections[name]
        start = self._data0 + m["off"]
        raw = self._mm[start:start + m["len"]]
        if m["comp"] == "zstd":
            return _zstd.decompress(raw, max_output_size=_MAX_SECTION_BYTES)
        return raw

    @property
    def tags_blob(self) -> bytes:
        if self._tags_blob is None:
            self._tags_blob = self._section_bytes("tags_blob")
        return self._tags_blob

    def label_arrays(self, ti: int, label: str):
        """(value table, counts, index blob, any) of one (tenant,
        label)."""
        blob = self._section_bytes(f"p{ti}:{label}")
        nv, w, ni, na = struct.unpack_from("<IIQQ", blob, 0)
        o = struct.calcsize("<IIQQ")
        v = np.frombuffer(blob, dtype=f"S{w}", count=nv, offset=o)
        o += nv * w
        c = np.frombuffer(blob, dtype=np.uint32, count=nv, offset=o)
        o += nv * 4
        i = np.frombuffer(blob, dtype=np.uint32, count=int(ni), offset=o)
        o += int(ni) * 4
        a = np.frombuffer(blob, dtype=np.uint32, count=int(na), offset=o)
        return v, c, i, a

    # ---- registry ----

    def find(self, sid: StreamID) -> int:
        """Row index of sid, or -1."""
        ti = self._tenant_idx.get(sid.tenant)
        if ti is None:
            return -1
        s, e = int(self._tenant_bounds[ti]), int(self._tenant_bounds[ti + 1])
        h = np.uint64(sid.hi)
        i = s + int(np.searchsorted(self.hi[s:e], h))
        while i < e and self.hi[i] == h:
            if int(self.lo[i]) == sid.lo:
                return i
            if int(self.lo[i]) > sid.lo:
                return -1
            i += 1
        return -1

    def contains_batch(self, tenant: TenantID, hi_arr: np.ndarray,
                       lo_arr: np.ndarray) -> np.ndarray:
        """Membership of one tenant's (hi, lo) ids: a searchsorted pair
        on hi, a loop only over ids whose hi has a run here."""
        out = np.zeros(hi_arr.size, dtype=bool)
        s, e = self.tenant_range(tenant)
        if s == e:
            return out
        seg_hi = self.hi[s:e]
        seg_lo = self.lo[s:e]
        h = hi_arr.astype(np.uint64, copy=False)
        left = np.searchsorted(seg_hi, h, side="left")
        right = np.searchsorted(seg_hi, h, side="right")
        for k in np.nonzero(right > left)[0].tolist():
            lw, r = int(left[k]), int(right[k])
            j = lw + int(np.searchsorted(seg_lo[lw:r], lo_arr[k]))
            if j < r and seg_lo[j] == lo_arr[k]:
                out[k] = True
        return out

    def tags_at(self, i: int) -> str:
        a, b = int(self.tag_off[i]), int(self.tag_off[i + 1])
        return self.tags_blob[a:b].decode("utf-8")

    def streams_at(self, idxs) -> list:
        """StreamIDs of rows `idxs` (ascending rows come out sorted)."""
        tis = self.t_idx[idxs].tolist()
        his = self.hi[idxs].tolist()
        los = self.lo[idxs].tolist()
        tenants = self.tenants
        return [StreamID(tenants[t], h, lw)
                for t, h, lw in zip(tis, his, los)]

    def tenant_range(self, tenant: TenantID) -> tuple[int, int]:
        ti = self._tenant_idx.get(tenant)
        if ti is None:
            return (0, 0)
        return (int(self._tenant_bounds[ti]),
                int(self._tenant_bounds[ti + 1]))

    # ---- postings ----

    def label_postings(self, tenant: TenantID,
                       label: str) -> LabelPostings | None:
        ti = self._tenant_idx.get(tenant)
        if ti is None:
            return None
        got = self._postings_cache.get((ti, label))
        if got is None:
            if label not in self.labels_meta.get(str(ti), {}):
                return None
            got = self._postings_cache[(ti, label)] = LabelPostings(
                *self.label_arrays(ti, label))
        return got
