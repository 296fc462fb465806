"""Packed per-part bloom planes, part aggregates and the filter
index's pruning: what rules out parts and blocks before a scan.

- **Planes.** Every block's bloom words for one column are packed into
  a zero-padded uint32 matrix `[B, 2*Wmax]` (each uint64 word as two
  little-endian uint32 lanes).  Probe positions are computed once per
  distinct filter size and broadcast to per-block (lane index, bit
  shift) pairs, so testing T tokens against B blocks is one gather +
  bit test.  The same (plane, idx, shift, nwords) arguments drive the
  device probe (gpu/bloom_device.py).
- **Part aggregates** (Bloofi, arXiv:1501.01941): one OR-fold of the
  block filters a distinct filter size (word i of a filter folds into
  word i % width), so a token whose probes miss every size's fold is in
  no block: the whole part is skipped (`part_aggregate_prunes`).  A
  sealed part with a filter index asks its xor aggregate first.
- **Maplet pruning.** On a sealed part the filter index's maplets give
  an AND-path leaf's exact candidate blocks in one lookup
  (`maplet_prune_candidates`), and `bloom_keep_mask` answers from them.

The JAX package's victorialogs_tpu/storage/filterbank.py, without the
global byte budget, the lock and the live-query registry; span
counters as JAX records them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..obs import tracing
from ..utils.hashing import cached_token_hashes
from .bloom import (BLOOM_HASHES, bloom_contains_all,
                    bloom_probe_positions_multi)
from .filterindex import part_index

# aggregate fold width cap, in uint64 words; smaller sizes fold at their
# own width
AGG_WORDS = 4096

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
    tokens (or has no bloom for the column).  A sealed part with a
    filter index answers from its maplet: exact, so strictly fewer
    blocks keep, never one that holds the tokens."""
    bis = list(bis)
    fi = part_index(part)
    if fi is not None:
        return _observe_keep(fi.keep_mask(field, hashes, bis))
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


# ---------------- part aggregates ----------------

@dataclass
class AggregateFilter:
    """The OR-folds of a part column's block filters, one a distinct
    filter size (a size-w filter's probes span w words only, so sizes
    never share a fold), padded into one matrix."""
    mat: np.ndarray                # uint64[S, Wcap]
    widths: np.ndarray             # uint64[S] fold width a size
    sizes: tuple                   # the distinct filter word counts
    all_have: bool                 # every block has a bloom

    def may_contain_all(self, hashes: np.ndarray) -> bool:
        """False only when some token is in no block's filter; a part
        with a block without a bloom may hold anything."""
        if not self.all_have or len(hashes) == 0:
            return True
        pos = bloom_probe_positions_multi(hashes, self.sizes)  # [S,T,6]
        wi = (pos >> np.uint64(6)) % self.widths[:, None, None]
        bit = (self.mat[np.arange(len(self.sizes))[:, None, None],
                        wi.astype(np.int64)]
               >> (pos & np.uint64(63))) & np.uint64(1)
        # a token may be present if some size's fold holds its probes
        return bool(bit.astype(bool).all(axis=2).any(axis=0).all())


def _fold_into(agg: np.ndarray, words: np.ndarray) -> None:
    aw = agg.shape[0]
    for start in range(0, words.shape[0], aw):
        chunk = np.asarray(words[start:start + aw], dtype=np.uint64)
        agg[:chunk.shape[0]] |= chunk


def _pack_aggs(aggs: dict, all_have: bool) -> AggregateFilter:
    sizes = tuple(sorted(aggs))
    wcap = max(a.shape[0] for a in aggs.values())
    mat = np.zeros((len(sizes), wcap), dtype=np.uint64)
    widths = np.empty(len(sizes), dtype=np.uint64)
    for si, sz in enumerate(sizes):
        a = aggs[sz]
        mat[si, :a.shape[0]] = a
        widths[si] = a.shape[0]
    return AggregateFilter(mat=mat, widths=widths, sizes=sizes,
                           all_have=all_have)


def _build_aggregate(part, field: str) -> AggregateFilter | None:
    """The folds from the part's plane when one is built already, else
    from each block's bloom words; None when no block has a bloom."""
    plane = part.__dict__.get("_bloom_planes", {}).get(field)
    if plane is not None:
        aggs = {}
        for si, w in enumerate(plane.sizes):
            rows = plane.plane[(plane.size_id == si) & (plane.nwords > 0)]
            col_or = np.bitwise_or.reduce(rows[:, :2 * w], axis=0)
            words = col_or[0::2].astype(np.uint64) | \
                (col_or[1::2].astype(np.uint64) << np.uint64(32))
            agg = np.zeros(min(w, AGG_WORDS), dtype=np.uint64)
            _fold_into(agg, words)
            aggs[w] = agg
        return _pack_aggs(aggs, bool((plane.nwords > 0).all()))
    aggs = {}
    have = 0
    for bi in range(part.num_blocks):
        w = part.block_column_bloom(bi, field)
        if w is None or w.shape[0] == 0:
            continue
        have += 1
        size = int(w.shape[0])
        agg = aggs.get(size)
        if agg is None:
            agg = aggs[size] = np.zeros(min(size, AGG_WORDS),
                                        dtype=np.uint64)
        _fold_into(agg, w)
    if not aggs:
        return None
    return _pack_aggs(aggs, have == part.num_blocks)


def part_aggregate(part, field: str, build: bool = True):
    """The part column's aggregate, built on first use (unless `build`
    is False: then only one built before) and cached on the part."""
    aggs = part.__dict__.setdefault("_bloom_aggs", {})
    got = aggs.get(field, _MISSING)
    if got is _MISSING:
        if not build:
            return None
        got = aggs[field] = _build_aggregate(part, field)
    return got


def aggregate_kill_leaf(part, leaves, build: bool = True):
    """The (field, tokens, filter, artifact) of the first AND-path leaf
    whose required tokens are in no block of the part, or None.  A
    sealed part asks its xor aggregate first (`xor_aggregate`): exact
    over the part's tokens, so where it covers the column and keeps the
    part, the coarser folds cannot kill it either; other parts ask the
    OR-folds (`bloom_fold`).  No span counters: a pure probe."""
    fi = part_index(part)
    for field, tokens, f in leaves:
        hashes = cached_token_hashes(f, tokens)
        if fi is not None:
            if fi.xor_kill(field, hashes):
                return field, tokens, f, "xor_aggregate"
            if fi.covers(field):
                continue
        agg = part_aggregate(part, field, build)
        if agg is not None and not agg.may_contain_all(hashes):
            return field, tokens, f, "bloom_fold"
    return None


def part_aggregate_prunes(part, leaves, build: bool = True) -> bool:
    """True when an AND-path leaf (`leaves`: logsql.filters.
    iter_and_path_token_leaves) needs a token that no block of the part
    holds: the part is skipped before any block is read.  `build=False`
    asks only aggregates built before (a cold fold reads every block's
    bloom, which a query touching few blocks should not pay)."""
    killed = aggregate_kill_leaf(part, leaves, build)
    if killed is None:
        return False
    sp = tracing.current_span()
    if sp.enabled:
        sp.add("parts_pruned_aggregate")
        sp.set("last_aggregate_prune_field", killed[0])
        sp.set("last_aggregate_prune_artifact", killed[3])
    return True


def maplet_leaf_keep(fi, leaves, bis):
    """(keep bool[len(bis)] or None, the leaf that emptied it or None):
    the AND of every AND-path leaf's maplet keep-mask over `bis`; None
    when no leaf's column has a maplet."""
    keep = None
    for field, tokens, f in leaves:
        if not fi.has(field):
            continue
        km = fi.keep_mask(field, cached_token_hashes(f, tokens), bis)
        keep = km if keep is None else keep & km
        if not keep.any():
            return keep, (field, tokens, f)
    return keep, None


def maplet_prune_candidates(part, leaves, bis):
    """The candidate blocks `bis` that may satisfy every AND-path leaf,
    by the sealed part's maplets (exact: the blocks it drops are those
    the per-leaf bloom would rule out, and more); `bis` itself for a
    part without a filter index or when nothing drops."""
    fi = part_index(part)
    if fi is None or not leaves or not bis:
        return bis
    keep, _leaf = maplet_leaf_keep(fi, leaves, bis)
    if keep is None:
        return bis
    n = len(bis)
    killed = n - int(keep.sum())
    sp = tracing.current_span()
    if sp.enabled:
        sp.add("blocks_probed_maplet", n)
        sp.add("blocks_killed_maplet", killed)
    if not killed:
        return bis
    return [bi for bi, k in zip(bis, keep) if k]
