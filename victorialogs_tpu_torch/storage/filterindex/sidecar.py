"""The sealed part's filter index on disk: `filterindex.bin`.

One file a part, written into the part's `.tmp` directory by the same
`write_part` that seals it, so the rename publishes the part and its
index together; the part's removal takes it along.  `blooms.bin` stays
as it is: parts without the file (VL_FILTER_INDEX=v1, or an invalid
file) are served by it.

Layout (integers little-endian), byte for byte the JAX package's
(victorialogs_tpu/storage/filterindex/sidecar.py), so each package
reads the other's parts:

    magic     8  b"VLFIDX2\\n"
    version   u32
    nblocks   u32   (must equal the part's)
    hdrlen    u32   (JSON header bytes)
    crc32     u32   (zlib.crc32 of header + payload)
    header    JSON  (a column's arrays as [offset, length])
    payload   the arrays, each 8-byte aligned

`load_sidecar` checks magic, version, block count, header shape, the
arrays' ranges and the checksum, and raises SidecarInvalid on any
mismatch; the arrays are read-only views of one payload buffer.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from .maplet import Maplet, maplet_build
from .sbbloom import SB_LANES, sb_build
from .xorfilter import XorFilter, xor_build

FILTERINDEX_FILENAME = "filterindex.bin"
MAGIC = b"VLFIDX2\n"
VERSION = 2


class SidecarInvalid(Exception):
    """The file failed a check; the part is served without it."""


@dataclass
class ColumnArtifacts:
    """One column's three artifacts."""
    nsb: np.ndarray              # int32[nblocks] split blocks a block
    lanes: np.ndarray            # uint32[8 * sum(nsb)], blocks in order
    xor: XorFilter | None        # None unless every block is covered
    maplet: Maplet

    def lane_offsets(self) -> np.ndarray:
        """int64[nblocks]: each block's first lane in `lanes`."""
        off = np.zeros(self.nsb.shape[0], dtype=np.int64)
        np.cumsum(self.nsb[:-1].astype(np.int64) * SB_LANES, out=off[1:])
        return off

    def nbytes(self) -> int:
        n = int(self.nsb.nbytes + self.lanes.nbytes + self.maplet.nbytes())
        if self.xor is not None:
            n += self.xor.nbytes()
        return n


class SidecarBuilder:
    """Collects each (block, column)'s distinct token hashes as the part
    is written, then builds every column's artifacts."""

    def __init__(self):
        self._cols: dict[str, list] = {}

    def add(self, block_idx: int, name: str, hashes) -> None:
        """`hashes`: the block column's distinct token hashes (uint64),
        or None when it has none (the block stays uncovered)."""
        self._cols.setdefault(name, []).append((block_idx, hashes))

    def build(self, nblocks: int) -> dict[str, ColumnArtifacts]:
        """Columns in the order of their first `add`."""
        return {nm: self._build_column(nm, nblocks) for nm in self._cols}

    def _build_column(self, name: str, nblocks: int) -> ColumnArtifacts:
        per_block = self._cols[name]
        nsb = np.zeros(nblocks, dtype=np.int32)
        lane_parts = []
        for bi, h in per_block:
            if h is None:
                continue
            lanes = sb_build(np.asarray(h, dtype=np.uint64))
            nsb[bi] = lanes.shape[0] // SB_LANES
            lane_parts.append((bi, lanes))
        lane_parts.sort(key=lambda t: t[0])
        lanes = np.concatenate([lp for _bi, lp in lane_parts]) \
            if lane_parts else np.zeros(0, dtype=np.uint32)
        mp = maplet_build(per_block, nblocks)
        xf = xor_build(mp.uhashes) if mp.all_covered() else None
        return ColumnArtifacts(nsb=nsb, lanes=lanes, xor=xf, maplet=mp)


def build_sidecar(builder: SidecarBuilder, nblocks: int):
    """(columns' artifacts, stats) of a builder; no file written."""
    cols = builder.build(nblocks)
    keys = sum(int(c.maplet.uhashes.shape[0]) for c in cols.values())
    agg_bits = sum(8 * c.xor.fingerprints.shape[0]
                   for c in cols.values() if c.xor is not None)
    agg_keys = sum(int(c.maplet.uhashes.shape[0])
                   for c in cols.values() if c.xor is not None)
    stats = {
        "cols": len(cols),
        "tokens": keys,
        "bytes": sum(c.nbytes() for c in cols.values()),
        "agg_bits_per_key": round(agg_bits / agg_keys, 2)
        if agg_keys else 0.0,
    }
    return cols, stats


def _pack(chunks: list, arr: np.ndarray, dtype: str):
    """Append `arr`, 8-byte aligned -> its [offset, length]."""
    pos = sum(len(c) for c in chunks)
    pad = (-pos) % 8
    if pad:
        chunks.append(b"\0" * pad)
        pos += pad
    chunks.append(np.ascontiguousarray(arr).astype(dtype, copy=False)
                  .tobytes())
    return [pos, int(arr.shape[0])]


def write_sidecar(dir_path: str, cols: dict[str, ColumnArtifacts],
                  nblocks: int) -> int:
    """Write and fsync dir_path/filterindex.bin -> its bytes."""
    chunks: list[bytes] = []
    hdr_cols: dict = {}
    for name, c in cols.items():
        d = {
            "nsb": _pack(chunks, c.nsb, "<i4"),
            "sb": _pack(chunks, c.lanes, "<u4"),
            "mh": _pack(chunks, c.maplet.uhashes, "<u8"),
            "mo": _pack(chunks, c.maplet.offsets, "<i8"),
            "mb": _pack(chunks, c.maplet.blocks, "<i4"),
            "cov": _pack(chunks, c.maplet.covered, "<u1"),
        }
        if c.xor is not None:
            d["xor"] = {"seed": int(c.xor.seed),
                        "seglen": int(c.xor.seglen),
                        "fp": _pack(chunks, c.xor.fingerprints, "<u1")}
        hdr_cols[name] = d
    payload = b"".join(chunks)
    header = json.dumps({"cols": hdr_cols, "payload_bytes": len(payload)},
                        separators=(",", ":")).encode("utf-8")
    crc = zlib.crc32(header + payload) & 0xFFFFFFFF
    blob = (MAGIC + struct.pack("<III", VERSION, nblocks, len(header))
            + struct.pack("<I", crc) + header + payload)
    with open(os.path.join(dir_path, FILTERINDEX_FILENAME), "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    return len(blob)


def _view(payload: bytes, desc, dtype: str) -> np.ndarray:
    off, n = desc
    end = off + n * np.dtype(dtype).itemsize
    if off < 0 or n < 0 or end > len(payload):
        raise SidecarInvalid(f"array [{off},{n}]x{dtype} out of range")
    return np.frombuffer(payload, dtype=dtype, count=n, offset=off)


def load_sidecar(dir_path: str, nblocks: int):
    """-> (columns' artifacts, payload bytes).  Raises SidecarInvalid
    on any failed check, FileNotFoundError without the file."""
    with open(os.path.join(dir_path, FILTERINDEX_FILENAME), "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) + 16:
        raise SidecarInvalid("truncated header")
    if blob[:len(MAGIC)] != MAGIC:
        raise SidecarInvalid("bad magic")
    version, nb, hdrlen = struct.unpack_from("<III", blob, len(MAGIC))
    (crc,) = struct.unpack_from("<I", blob, len(MAGIC) + 12)
    if version != VERSION:
        raise SidecarInvalid(f"version {version}")
    if nb != nblocks:
        raise SidecarInvalid(f"nblocks {nb} != part {nblocks}")
    body = blob[len(MAGIC) + 16:]
    if hdrlen > len(body):
        raise SidecarInvalid("header past EOF")
    header, payload = body[:hdrlen], body[hdrlen:]
    if (zlib.crc32(header + payload) & 0xFFFFFFFF) != crc:
        raise SidecarInvalid("checksum mismatch")
    try:
        hdr = json.loads(header)
        if len(payload) != hdr["payload_bytes"]:
            raise SidecarInvalid("payload length mismatch")
        cols: dict[str, ColumnArtifacts] = {}
        for name, d in hdr["cols"].items():
            nsb = _view(payload, d["nsb"], "<i4")
            if nsb.shape[0] != nblocks:
                raise SidecarInvalid("nsb length")
            lanes = _view(payload, d["sb"], "<u4")
            if int(nsb.astype(np.int64).sum()) * SB_LANES != lanes.shape[0] \
                    or (nsb < 0).any():
                raise SidecarInvalid("sb lanes")
            mp = Maplet(uhashes=_view(payload, d["mh"], "<u8"),
                        offsets=_view(payload, d["mo"], "<i8"),
                        blocks=_view(payload, d["mb"], "<i4"),
                        covered=_view(payload, d["cov"], "<u1"),
                        nblocks=nblocks)
            if mp.offsets.shape[0] != mp.uhashes.shape[0] + 1 or \
                    (mp.offsets[-1:] > mp.blocks.shape[0]).any() or \
                    mp.covered.shape[0] != (nblocks + 7) // 8:
                raise SidecarInvalid("maplet shape")
            if mp.blocks.shape[0] and (int(mp.blocks.max()) >= nblocks
                                       or int(mp.blocks.min()) < 0):
                raise SidecarInvalid("maplet block id out of range")
            xf = None
            if "xor" in d:
                x = d["xor"]
                fp = _view(payload, x["fp"], "<u1")
                if fp.shape[0] != 3 * int(x["seglen"]):
                    raise SidecarInvalid("xor shape")
                xf = XorFilter(seed=int(x["seed"]), seglen=int(x["seglen"]),
                               fingerprints=fp)
            cols[name] = ColumnArtifacts(nsb=nsb, lanes=lanes, xor=xf,
                                         maplet=mp)
        return cols, len(payload)
    except SidecarInvalid:
        raise
    except Exception as e:  # any malformed header or descriptor
        raise SidecarInvalid(f"malformed header: {e!r}") from e
