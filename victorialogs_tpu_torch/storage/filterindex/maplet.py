"""Token -> block maplets: a sealed part column's exact block index.

The part column's distinct token hashes, sorted once at the seal, each
with the posting list of the blocks that hold it ("Time To Replace
Your Filter": a map that returns a value, not a bit).  Which blocks may
hold every token of an AND-path leaf is then one binary search a token
and an intersection: the exact candidate list, with no false positive
at block granularity (up to 64-bit hash collisions, which every filter
layer already assumes).

A block without token hashes for the column (the column missing, dict
encoded or without a bloom) may hold anything: it is marked uncovered
and always kept, as the classic path keeps a block without a bloom.
The JAX package's victorialogs_tpu/storage/filterindex/maplet.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Maplet:
    uhashes: np.ndarray      # uint64[U] sorted distinct token hashes
    offsets: np.ndarray      # int64[U+1] posting ranges into blocks
    blocks: np.ndarray       # int32[P] block ids, grouped a token
    covered: np.ndarray      # packbits of bool[nblocks]: block has hashes
    nblocks: int

    def nbytes(self) -> int:
        return int(self.uhashes.nbytes + self.offsets.nbytes
                   + self.blocks.nbytes + self.covered.nbytes)

    def covered_mask(self, bis: np.ndarray) -> np.ndarray:
        byte = self.covered[bis >> 3]
        return (byte >> (np.uint8(7) - (bis & 7).astype(np.uint8))) & 1 != 0

    def all_covered(self) -> bool:
        full, rem = divmod(self.nblocks, 8)
        if full and not (self.covered[:full] == 0xFF).all():
            return False
        if rem:
            want = np.uint8((0xFF << (8 - rem)) & 0xFF)
            return bool(self.covered[full] & want == want)
        return True

    def keep_mask(self, hashes: np.ndarray, bis=None) -> np.ndarray:
        """bool keep-mask over `bis` (or every block): True where the
        block may hold ALL tokens; exact on covered blocks, True on the
        others."""
        sel = np.arange(self.nblocks, dtype=np.int64) if bis is None \
            else np.asarray(list(bis), dtype=np.int64)
        if len(hashes) == 0:
            return np.ones(sel.shape[0], dtype=bool)
        t = len(hashes)
        cnt = np.zeros(self.nblocks, dtype=np.int32)
        pos = np.searchsorted(self.uhashes, hashes)
        u = self.uhashes.shape[0]
        for k in range(t):
            p = int(pos[k])
            if p >= u or self.uhashes[p] != hashes[k]:
                # in no covered block: only the uncovered ones may match
                return ~self.covered_mask(sel)
            cnt[self.blocks[self.offsets[p]:self.offsets[p + 1]]] += 1
        return (cnt[sel] == t) | ~self.covered_mask(sel)


def maplet_build(per_block: list, nblocks: int) -> Maplet:
    """From [(block idx, uint64 hashes or None)], an entry for each
    block with token hashes; every other block is uncovered."""
    covered = np.zeros(nblocks, dtype=bool)
    hs = []
    bs = []
    for bi, h in per_block:
        if h is None:
            continue
        covered[bi] = True
        if len(h):
            hs.append(np.asarray(h, dtype=np.uint64))
            bs.append(np.full(len(h), bi, dtype=np.int32))
    if hs:
        all_h = np.concatenate(hs)
        all_b = np.concatenate(bs)
        order = np.argsort(all_h, kind="stable")
        sh, sb = all_h[order], all_b[order]
        uhashes, starts = np.unique(sh, return_index=True)
        offsets = np.concatenate([starts.astype(np.int64), [sh.shape[0]]])
        blocks = sb
    else:
        uhashes = np.zeros(0, dtype=np.uint64)
        offsets = np.zeros(1, dtype=np.int64)
        blocks = np.zeros(0, dtype=np.int32)
    return Maplet(uhashes=uhashes, offsets=offsets, blocks=blocks,
                  covered=np.packbits(covered), nblocks=nblocks)
