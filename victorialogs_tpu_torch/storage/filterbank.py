"""Packed per-part bloom planes: one batched probe per (part, column).

Every block's bloom words for one column are packed into a zero-padded
uint32 matrix `[B, 2*Wmax]` (each uint64 word as two little-endian
uint32 lanes).  Probe positions are computed once per distinct filter
size and broadcast to per-block (lane index, bit shift) pairs, so
testing T tokens against B blocks is one gather + bit test.  The same
(plane, idx, shift, nwords) arguments drive the device probe
(gpu/bloom_device.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..obs import tracing
from .bloom import (BLOOM_HASHES, bloom_contains_all,
                    bloom_probe_positions_multi)

# planes beyond this fall back to the per-block probe
MAX_PLANE_BYTES = 256 << 20


def probe_np(plane: np.ndarray, idx: np.ndarray, shift: np.ndarray,
             nwords: np.ndarray) -> np.ndarray:
    """Host probe: True where every probed bit is set or nwords == 0."""
    if idx.shape[1] == 0:
        return np.ones(plane.shape[0], dtype=bool)
    words = np.take_along_axis(plane, idx, axis=1)
    bits = (words >> shift.astype(np.uint32)) & np.uint32(1)
    return (bits != 0).all(axis=1) | (nwords == 0)


@dataclass
class BloomPlane:
    plane: np.ndarray              # uint32[B, 2*Wmax], zero-padded
    nwords: np.ndarray             # int32[B]; 0 = block has no bloom
    sizes: tuple                   # distinct nonzero word counts, sorted
    size_id: np.ndarray            # int32[B] index into sizes (0 if none)

    def probe_tables(self, hashes: np.ndarray):
        """Per-size (idx, shift) int32[S, T*6] gather tables."""
        p = len(hashes) * BLOOM_HASHES
        pos = bloom_probe_positions_multi(hashes, self.sizes) \
            .reshape(len(self.sizes), p)
        idx = ((pos >> np.uint64(6)) * np.uint64(2)
               + ((pos >> np.uint64(5)) & np.uint64(1))).astype(np.int32)
        shift = (pos & np.uint64(31)).astype(np.int32)
        return idx, shift

    def block_probe_args(self, hashes: np.ndarray):
        """(idx, shift) int32[B, T*6] per-block gather arguments."""
        idx_s, shift_s = self.probe_tables(hashes)
        return idx_s[self.size_id], shift_s[self.size_id]

    def keep_mask(self, hashes: np.ndarray, bis) -> np.ndarray:
        sel = np.asarray(list(bis), dtype=np.int64)
        if len(hashes) == 0:
            return np.ones(sel.shape[0], dtype=bool)
        idx, shift = self.block_probe_args(hashes)
        return probe_np(self.plane[sel], idx[sel], shift[sel],
                        self.nwords[sel])


def _build_plane(part, field: str) -> BloomPlane | None:
    nblocks = part.num_blocks
    words_by_block: list = [None] * nblocks
    nwords = np.zeros(nblocks, dtype=np.int32)
    for bi in range(nblocks):
        w = part.block_column_bloom(bi, field)
        if w is not None and w.shape[0]:
            words_by_block[bi] = w
            nwords[bi] = w.shape[0]
    wmax = int(nwords.max(initial=0))
    if wmax == 0 or nblocks * wmax * 8 > MAX_PLANE_BYTES:
        return None
    plane = np.zeros((nblocks, 2 * wmax), dtype=np.uint32)
    for bi, w in enumerate(words_by_block):
        if w is not None:
            lanes = np.ascontiguousarray(w, dtype=np.uint64).view(np.uint32)
            plane[bi, :lanes.shape[0]] = lanes
    sizes = tuple(sorted(int(s) for s in np.unique(nwords[nwords > 0])))
    size_of = {s: i for i, s in enumerate(sizes)}
    size_id = np.array([size_of.get(int(n), 0) for n in nwords],
                       dtype=np.int32)
    return BloomPlane(plane=plane, nwords=nwords, sizes=sizes,
                      size_id=size_id)


_MISSING = object()


def bloom_plane(part, field: str) -> BloomPlane | None:
    """The part column's plane, built on first use and cached on the
    part (parts are immutable)."""
    planes = part.__dict__.setdefault("_bloom_planes", {})
    got = planes.get(field, _MISSING)
    if got is _MISSING:
        got = planes[field] = _build_plane(part, field)
    return got


def bloom_keep_mask(part, field: str, hashes: np.ndarray,
                    bis) -> np.ndarray:
    """bool keep-mask over `bis`: True where the block may contain ALL
    tokens (or has no bloom for the column)."""
    bis = list(bis)
    pl = bloom_plane(part, field)
    if pl is not None:
        return _observe_keep(pl.keep_mask(hashes, bis))
    keep = np.ones(len(bis), dtype=bool)
    if len(hashes) == 0:
        return keep
    for k, bi in enumerate(bis):
        w = part.block_column_bloom(bi, field)
        if w is not None and w.shape[0] and \
                not bloom_contains_all(w, hashes):
            keep[k] = False
    return _observe_keep(keep)


def _observe_keep(keep: np.ndarray) -> np.ndarray:
    """An active trace's span counts `blocks_probed_bloom` and
    `blocks_killed_bloom` of each probe."""
    n = int(keep.shape[0])
    if n:
        sp = tracing.current_span()
        if sp.enabled:
            sp.add("blocks_probed_bloom", n)
            sp.add("blocks_killed_bloom", n - int(keep.sum()))
    return keep
