"""Parts: immutable, time-range-indexed lists of blocks, in memory or on
disk.

Two classes give the executor the same accessors (stream id, tags, rows,
time range, consts, column metadata, column payload, bloom words,
timestamps), so it never asks which kind it walks:

- `Part` holds its blocks decoded in host memory.  It is what every
  batch becomes when added, and what a flush of a memory-only store
  makes; a part rebuilt from exported arrays (storage/convert.py) is
  one too.  It is the JAX package's `datadb.InmemoryPart`.
- `FilePart` reads a part directory lazily.  It is the JAX package's
  `part.Part`.

A part directory holds five files (format v2, the JAX package's), and
a sixth since the filter index (storage/filterindex):

  metadata.json    rows, blocks, time range, sizes, format version
  index.bin        a 4-byte big-endian length, a compressed JSON
                   metaindex (offset, length, block count and time range
                   of each header group), then the header groups of
                   HEADER_GROUP_SIZE blocks, each compressed on its own
  timestamps.bin   per block, the compressed int64 deltas of its
                   timestamps
  columns.bin      per (block, column), the compressed payload
  blooms.bin       the raw uint64 bloom words, memory-mapped when read
  filterindex.bin  split-block filters, xor aggregates and token -> block
                   maplets of the bloom columns, built at the seal
                   (absent with VL_FILTER_INDEX=v1)

Opening a part parses only the metaindex; a header group decodes the
first time a block of it is touched.  Bloom words stay uncompressed:
every block a query touches probes them.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import shutil
import struct
import time
from dataclasses import dataclass

import numpy as np

from ..utils import zstd as _zstd
from . import filterindex as _fidx
from .block import BlockData, column_token_hashes
from .log_rows import StreamID, TenantID
from .values_encoder import (EncodedColumn, VT_DICT, VT_FLOAT64, VT_INT64,
                             VT_IPV4, VT_STRING, VT_TIMESTAMP_ISO8601,
                             VT_UINT8, VT_UINT16, VT_UINT32, VT_UINT64)

FORMAT_VERSION = 2
HEADER_GROUP_SIZE = 256   # blocks per header group of index.bin

METADATA_FILENAME = "metadata.json"
INDEX_FILENAME = "index.bin"
TIMESTAMPS_FILENAME = "timestamps.bin"
COLUMNS_FILENAME = "columns.bin"
BLOOMS_FILENAME = "blooms.bin"

_NUM_DTYPES = {
    VT_UINT8: np.uint8, VT_UINT16: np.uint16, VT_UINT32: np.uint32,
    VT_UINT64: np.uint64, VT_INT64: np.int64, VT_FLOAT64: np.float64,
    VT_IPV4: np.uint32, VT_TIMESTAMP_ISO8601: np.int64,
}

# process-unique part identity for staging caches (id() is reused)
_part_uid_counter = itertools.count(1)


def next_part_uid() -> int:
    return next(_part_uid_counter)


class Part:
    """A part whose blocks are held decoded in host memory."""

    path = None

    def __init__(self, blocks: list[BlockData]):
        self.uid = next_part_uid()
        self.blocks = blocks
        self.num_blocks = len(blocks)
        self.num_rows = sum(b.num_rows for b in blocks)
        self.min_ts = min((b.min_ts for b in blocks), default=0)
        self.max_ts = max((b.max_ts for b in blocks), default=0)

    def candidate_blocks(self, min_ts: int, max_ts: int):
        for bi, b in enumerate(self.blocks):
            if b.min_ts <= max_ts and b.max_ts >= min_ts:
                yield bi

    def block_stream_id(self, i):
        return self.blocks[i].stream_id

    def block_tags(self, i) -> str:
        return self.blocks[i].stream_tags_str

    def block_rows(self, i) -> int:
        return self.blocks[i].num_rows

    def block_min_ts(self, i) -> int:
        return self.blocks[i].min_ts

    def block_max_ts(self, i) -> int:
        return self.blocks[i].max_ts

    def block_consts(self, i):
        return self.blocks[i].const_columns

    def block_col_names(self, i) -> list[str]:
        return [c.name for c in self.blocks[i].columns]

    def block_column_meta(self, i, name: str) -> dict | None:
        c = self.blocks[i].get_column(name)
        if c is None:
            return None
        meta = {"n": c.name, "t": c.vtype, "min": c.min_val,
                "max": c.max_val}
        if c.dict_values is not None:
            meta["dict"] = c.dict_values
        return meta

    def block_column_bloom(self, i, name: str):
        c = self.blocks[i].get_column(name)
        return c.bloom if c is not None else None

    def block_column(self, i, name: str):
        return self.blocks[i].get_column(name)

    def block_timestamps(self, i):
        return self.blocks[i].timestamps

    def read_block(self, i) -> BlockData:
        return self.blocks[i]

    def iter_blocks(self):
        return iter(self.blocks)

    def close(self) -> None:
        pass


# ---------------- the writer ----------------

def _compress(data: bytes, hi: bool = False) -> bytes:
    return _zstd.compress(data, level=3 if hi else 1)


def _column_payload(c: EncodedColumn) -> bytes:
    if c.vtype == VT_STRING:
        return c.lengths.astype(np.int32).tobytes() + c.arena.tobytes()
    if c.vtype == VT_DICT:
        return c.ids.tobytes()
    return c.nums.tobytes()


def fsync_dir(path: str) -> None:
    """Make a rename or removal inside `path` durable."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_part(path: str, blocks, big: bool = False) -> dict:
    """Write blocks (sorted by (stream_id, min_ts); any iterable, read
    once) as the part directory `path`; returns its metadata, with the
    filter index's build figures under "filter_index" when one was built
    (not with VL_FILTER_INDEX=v1, nor for a part of no blocks).

    Every file is written under `path + ".tmp"` and fsynced, the
    directory renamed to `path`, then its parent fsynced: the rename is
    the commit point, and a crash before it leaves only a `.tmp`
    directory, which the datadb removes when it opens (and a later
    write of the same part replaces).  `big` compresses
    the payloads harder (a merge into the big tier).

    This is the seal: the part never changes again, so its filter index
    (storage/filterindex) is built here from each bloom column's token
    hashes and written into the same `.tmp` directory, published by the
    same rename.  A fresh block carries its hashes from the block
    build; a block read back from disk (a merge passing it through)
    tokenizes its values again.  A failed build raises."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    headers = []
    total_rows = 0
    min_ts = max_ts = None
    uncomp_size = 0
    fi_builder = _fidx.SidecarBuilder() if _fidx.enabled() else None
    hash_s = 0.0          # tokenizing pass-through blocks again
    with open(os.path.join(tmp, TIMESTAMPS_FILENAME), "wb") as ts_f, \
         open(os.path.join(tmp, COLUMNS_FILENAME), "wb") as col_f, \
         open(os.path.join(tmp, BLOOMS_FILENAME), "wb") as bloom_f:
        ts_off = col_off = bloom_off = 0
        for b in blocks:
            total_rows += b.num_rows
            if min_ts is None or b.min_ts < min_ts:
                min_ts = b.min_ts
            if max_ts is None or b.max_ts > max_ts:
                max_ts = b.max_ts
            uncomp_size += b.uncompressed_size()
            ts = b.timestamps
            deltas = np.empty_like(ts)
            deltas[0] = ts[0]
            np.subtract(ts[1:], ts[:-1], out=deltas[1:])
            ts_z = _compress(deltas.tobytes(), hi=big)
            ts_f.write(ts_z)
            ts_region = [ts_off, len(ts_z)]
            ts_off += len(ts_z)

            cols_hdr = []
            for c in b.columns:
                cz = _compress(_column_payload(c), hi=big)
                col_f.write(cz)
                ch = {"n": c.name, "t": c.vtype, "r": [col_off, len(cz)]}
                col_off += len(cz)
                if c.bloom is not None:
                    bloom_f.write(c.bloom.tobytes())
                    ch["b"] = [bloom_off, int(c.bloom.shape[0])]
                    bloom_off += c.bloom.shape[0] * 8
                    if fi_builder is not None:
                        h = c.token_hashes
                        if h is None:
                            t_h = time.perf_counter()
                            h = column_token_hashes(c, b.num_rows)
                            hash_s += time.perf_counter() - t_h
                        if h is not None:
                            fi_builder.add(len(headers), c.name, h)
                if c.vtype == VT_DICT:
                    ch["dict"] = c.dict_values
                elif c.vtype != VT_STRING:
                    ch["min"] = c.min_val
                    ch["max"] = c.max_val
                    if c.vtype == VT_TIMESTAMP_ISO8601:
                        ch["fw"] = c.iso_frac_w
                cols_hdr.append(ch)

            sid = b.stream_id
            headers.append({
                "sid": [sid.tenant.account_id, sid.tenant.project_id,
                        sid.hi, sid.lo],
                "tags": b.stream_tags_str,
                "rows": b.num_rows,
                "min_ts": b.min_ts, "max_ts": b.max_ts,
                "ts": ts_region,
                "cols": cols_hdr,
                "consts": b.const_columns,
            })
        comp_size = ts_off + col_off + bloom_off
        for fh in (ts_f, col_f, bloom_f):
            fh.flush()
            os.fsync(fh.fileno())
    fi_stats = None
    if fi_builder is not None and headers:
        t0 = time.perf_counter()
        fi_cols, fi_stats = _fidx.build_sidecar(fi_builder, len(headers))
        fi_stats["file_bytes"] = _fidx.write_sidecar(tmp, fi_cols,
                                                     len(headers))
        fi_stats["build_s"] = time.perf_counter() - t0
        fi_stats["hash_recompute_s"] = hash_s
    groups_meta = []
    group_blobs = []
    goff = 0
    for g0 in range(0, len(headers), HEADER_GROUP_SIZE):
        grp = headers[g0:g0 + HEADER_GROUP_SIZE]
        blob = _compress(json.dumps(grp, separators=(",", ":"))
                         .encode("utf-8"), hi=True)
        groups_meta.append({
            "o": goff, "l": len(blob), "n": len(grp),
            "min_ts": min(h["min_ts"] for h in grp),
            "max_ts": max(h["max_ts"] for h in grp),
        })
        group_blobs.append(blob)
        goff += len(blob)
    metaindex_z = _compress(json.dumps(groups_meta, separators=(",", ":"))
                            .encode("utf-8"), hi=True)
    with open(os.path.join(tmp, INDEX_FILENAME), "wb") as f:
        f.write(struct.pack(">I", len(metaindex_z)))
        f.write(metaindex_z)
        for blob in group_blobs:
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    meta = {
        "format_version": FORMAT_VERSION,
        "rows": total_rows,
        "blocks": len(headers),
        "min_ts": min_ts or 0,
        "max_ts": max_ts or 0,
        "compressed_size": comp_size + 4 + len(metaindex_z) + goff,
        "uncompressed_size": uncomp_size,
    }
    with open(os.path.join(tmp, METADATA_FILENAME), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(path))
    return meta if fi_stats is None else dict(meta, filter_index=fi_stats)


# ---------------- the lazy reader ----------------

@dataclass
class BlockHeader:
    """The parsed header of one block of a part."""

    stream_id: StreamID
    stream_tags_str: str
    rows: int
    min_ts: int
    max_ts: int
    ts_region: tuple[int, int]
    cols: list[dict]
    consts: list[tuple[str, str]]

    def col_header(self, name: str) -> dict | None:
        for ch in self.cols:
            if ch["n"] == name:
                return ch
        return None


def _parse_header(h: dict) -> BlockHeader:
    a, p, hi, lo = h["sid"]
    return BlockHeader(
        stream_id=StreamID(TenantID(a, p), hi, lo),
        stream_tags_str=h.get("tags", ""),
        rows=h["rows"], min_ts=h["min_ts"], max_ts=h["max_ts"],
        ts_region=tuple(h["ts"]), cols=h["cols"],
        consts=[tuple(x) for x in h["consts"]],
    )


class LazyHeaders:
    """The block headers as a sequence: each header group decodes the
    first time one of its blocks is touched, and stays decoded."""

    def __init__(self, index_fd: int, base_off: int, groups_meta: list):
        self._fd = index_fd
        self._base = base_off
        self._meta = groups_meta
        self._starts = []          # first block index of each group
        pos = 0
        for g in groups_meta:
            self._starts.append(pos)
            pos += g["n"]
        self._n = pos
        self._groups: list = [None] * len(groups_meta)
        self.groups_loaded = 0

    def __len__(self) -> int:
        return self._n

    def load_group(self, gi: int) -> list[BlockHeader]:
        got = self._groups[gi]
        if got is None:
            m = self._meta[gi]
            raw = _zstd.decompress(os.pread(self._fd, m["l"],
                                            self._base + m["o"]))
            got = self._groups[gi] = [_parse_header(h)
                                      for h in json.loads(raw)]
            self.groups_loaded += 1
        return got

    def __getitem__(self, i: int) -> BlockHeader:
        if i < 0 or i >= self._n:
            raise IndexError(i)
        gi = bisect.bisect_right(self._starts, i) - 1
        return self.load_group(gi)[i - self._starts[gi]]

    def group_time_ranges(self):
        """(first block, blocks, min_ts, max_ts) of each group."""
        for gi, m in enumerate(self._meta):
            yield self._starts[gi], m["n"], m["min_ts"], m["max_ts"]


class FilePart:
    """A lazy reader over a part directory.  Reads go through os.pread
    and the memory-mapped bloom words; `close()` closes the files and
    drops the map."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)
        self.uid = next_part_uid()
        with open(os.path.join(path, METADATA_FILENAME)) as f:
            self.meta = json.load(f)
        version = self.meta.get("format_version", 1)
        if version != FORMAT_VERSION:
            raise ValueError(f"{path}: part format v{version} is not "
                             f"readable (v{FORMAT_VERSION} only)")
        self._idx_f = open(os.path.join(path, INDEX_FILENAME), "rb")
        self._ts_f = self._col_f = None
        try:
            hlen = struct.unpack(">I", self._idx_f.read(4))[0]
            groups_meta = json.loads(_zstd.decompress(self._idx_f.read(hlen)))
            self.headers = LazyHeaders(self._idx_f.fileno(), 4 + hlen,
                                       groups_meta)
            self._ts_f = open(os.path.join(path, TIMESTAMPS_FILENAME), "rb")
            self._col_f = open(os.path.join(path, COLUMNS_FILENAME), "rb")
            bloom_path = os.path.join(path, BLOOMS_FILENAME)
            self._blooms = np.memmap(bloom_path, dtype=np.uint64, mode="r") \
                if os.path.getsize(bloom_path) else \
                np.zeros(0, dtype=np.uint64)
        except BaseException:
            self.close()
            raise

    @property
    def num_rows(self) -> int:
        return self.meta["rows"]

    @property
    def num_blocks(self) -> int:
        return len(self.headers)

    @property
    def min_ts(self) -> int:
        return self.meta["min_ts"]

    @property
    def max_ts(self) -> int:
        return self.meta["max_ts"]

    @property
    def closed(self) -> bool:
        return self._blooms is None and all(
            f is None or f.closed
            for f in (self._idx_f, self._ts_f, self._col_f))

    def close(self) -> None:
        for f in (self._idx_f, self._ts_f, self._col_f):
            if f is not None:
                f.close()
        self._blooms = None

    def candidate_blocks(self, min_ts: int, max_ts: int):
        """Block indexes whose time range meets [min_ts, max_ts]; a
        header group outside it is skipped without being decoded."""
        for gi, (start, _n, g_min, g_max) in enumerate(
                self.headers.group_time_ranges()):
            if g_min > max_ts or g_max < min_ts:
                continue
            for off, h in enumerate(self.headers.load_group(gi)):
                if h.min_ts <= max_ts and h.max_ts >= min_ts:
                    yield start + off

    # ---- reads ----

    def read_timestamps(self, i: int) -> np.ndarray:
        off, ln = self.headers[i].ts_region
        deltas = np.frombuffer(
            _zstd.decompress(os.pread(self._ts_f.fileno(), ln, off)),
            dtype=np.int64)
        return np.cumsum(deltas)

    def read_bloom(self, ch: dict) -> np.ndarray | None:
        b = ch.get("b")
        if b is None:
            return None
        off_bytes, nwords = b
        start = off_bytes // 8
        return np.asarray(self._blooms[start:start + nwords])

    def read_column(self, i: int, ch: dict) -> EncodedColumn:
        """One column's payload, decoded; its arrays may be read-only
        views of the decompressed bytes."""
        nrows = self.headers[i].rows
        off, ln = ch["r"]
        payload = _zstd.decompress(os.pread(self._col_f.fileno(), ln, off))
        vt = ch["t"]
        col = EncodedColumn(name=ch["n"], vtype=vt)
        if vt == VT_STRING:
            lens = np.frombuffer(payload[:4 * nrows], dtype=np.int32) \
                .astype(np.int64)
            col.lengths = lens
            col.offsets = np.zeros(nrows, dtype=np.int64)
            np.cumsum(lens[:-1], out=col.offsets[1:])
            col.arena = np.frombuffer(payload[4 * nrows:], dtype=np.uint8)
        elif vt == VT_DICT:
            col.ids = np.frombuffer(payload, dtype=np.uint8)
            col.dict_values = ch["dict"]
        else:
            col.nums = np.frombuffer(payload, dtype=_NUM_DTYPES[vt])
            col.min_val = ch.get("min", 0.0)
            col.max_val = ch.get("max", 0.0)
            col.iso_frac_w = ch.get("fw", 0)
        col.bloom = self.read_bloom(ch)
        return col

    def read_block(self, i: int) -> BlockData:
        h = self.headers[i]
        return BlockData(
            stream_id=h.stream_id,
            timestamps=self.read_timestamps(i),
            columns=[self.read_column(i, ch) for ch in h.cols],
            const_columns=list(h.consts),
            stream_tags_str=h.stream_tags_str,
        )

    def iter_blocks(self):
        for i in range(self.num_blocks):
            yield self.read_block(i)

    # ---- the accessors shared with Part ----

    def block_stream_id(self, i: int) -> StreamID:
        return self.headers[i].stream_id

    def block_tags(self, i: int) -> str:
        return self.headers[i].stream_tags_str

    def block_rows(self, i: int) -> int:
        return self.headers[i].rows

    def block_min_ts(self, i: int) -> int:
        return self.headers[i].min_ts

    def block_max_ts(self, i: int) -> int:
        return self.headers[i].max_ts

    def block_consts(self, i: int) -> list[tuple[str, str]]:
        return self.headers[i].consts

    def block_col_names(self, i: int) -> list[str]:
        return [ch["n"] for ch in self.headers[i].cols]

    def block_column_meta(self, i: int, name: str) -> dict | None:
        """The column's header (type `t`, `min`/`max` of a numeric
        column, `dict` of a dict column) without reading its payload."""
        return self.headers[i].col_header(name)

    def block_column_bloom(self, i: int, name: str) -> np.ndarray | None:
        ch = self.headers[i].col_header(name)
        return None if ch is None else self.read_bloom(ch)

    def block_column(self, i: int, name: str) -> EncodedColumn | None:
        ch = self.headers[i].col_header(name)
        return None if ch is None else self.read_column(i, ch)

    def block_timestamps(self, i: int) -> np.ndarray:
        return self.read_timestamps(i)
