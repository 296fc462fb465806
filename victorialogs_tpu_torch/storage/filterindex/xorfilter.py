"""Xor filters: a sealed part's per-column aggregate (~9.9 bits a key).

Graf and Lemire (arXiv:1912.08258): c = 32 + ceil(1.23 n) 8-bit slots
in three segments; a key is a member when the xor of its three slots
equals its fingerprint (no false negatives, a false positive rate of
about 2^-8).  The build peels the key graph and can fail; it retries
with another seed up to _MAX_TRIES times, then gives up (None: the
part has no xor aggregate for the column).  Seeds, slots, fingerprints
and the peel are the JAX package's
(victorialogs_tpu/storage/filterindex/xorfilter.py), so both build the
same bytes.

The peel is vectorized by rounds: each round takes every slot of
degree 1 at once, records (key, slot) and removes the keys.  The
assignment replays the rounds backwards; a key's other two slots were
peeled in later rounds, so each round assigns with one gather and xor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...utils.hashing import splitmix64_np

_MAX_TRIES = 16
FINGERPRINT_BITS = 8


def _slots_and_fp(hashes: np.ndarray, seed: int, seglen: int):
    """A key's three slots (one a segment, by fastrange) and its 8-bit
    fingerprint, from (hash, seed) alone."""
    z = splitmix64_np(hashes.astype(np.uint64) ^ np.uint64(seed))
    z2 = splitmix64_np(z)
    sl = np.uint64(seglen)
    h0 = ((z & np.uint64(0xFFFFFFFF)) * sl) >> np.uint64(32)
    h1 = (((z >> np.uint64(32)) * sl) >> np.uint64(32)) + sl
    h2 = (((z2 & np.uint64(0xFFFFFFFF)) * sl) >> np.uint64(32)) \
        + np.uint64(2) * sl
    fp = ((z2 >> np.uint64(56)) & np.uint64(0xFF)).astype(np.uint8)
    # fingerprint 0 would make an empty (all-zero) table claim members
    fp = np.where(fp == 0, np.uint8(0xA5), fp)
    return h0.astype(np.int64), h1.astype(np.int64), h2.astype(np.int64), fp


@dataclass
class XorFilter:
    seed: int
    seglen: int
    fingerprints: np.ndarray       # uint8[3 * seglen]

    def contains(self, hashes: np.ndarray) -> np.ndarray:
        """bool[T]: True for every built key (and ~2^-8 of the rest)."""
        if len(hashes) == 0:
            return np.ones(0, dtype=bool)
        h0, h1, h2, fp = _slots_and_fp(hashes, self.seed, self.seglen)
        f = self.fingerprints
        return (f[h0] ^ f[h1] ^ f[h2]) == fp

    def nbytes(self) -> int:
        return int(self.fingerprints.nbytes)


def xor_build(hashes: np.ndarray) -> XorFilter | None:
    """An xor filter over the distinct uint64 `hashes`, or None when
    the peel fails with each of _MAX_TRIES seeds."""
    keys = np.unique(hashes.astype(np.uint64))
    n = len(keys)
    seglen = max(4, (int(np.ceil(1.23 * n)) + 32 + 2) // 3)
    cap = 3 * seglen
    for attempt in range(_MAX_TRIES):
        seed = (0x9E3779B9 * (attempt + 1)) & 0xFFFFFFFF
        if n == 0:
            return XorFilter(seed=seed, seglen=seglen,
                             fingerprints=np.zeros(cap, dtype=np.uint8))
        h0, h1, h2, _fp = _slots_and_fp(keys, seed, seglen)
        slots = np.stack([h0, h1, h2], axis=1)         # int64[n, 3]
        count = np.zeros(cap, dtype=np.int64)
        xorkey = np.zeros(cap, dtype=np.int64)         # xor of key ids
        flat = slots.reshape(-1)
        np.add.at(count, flat, 1)
        np.bitwise_xor.at(xorkey, flat,
                          np.repeat(np.arange(n, dtype=np.int64), 3))
        alive = np.ones(n, dtype=bool)
        rounds: list = []
        remaining = n
        while remaining:
            single = np.nonzero(count == 1)[0]
            if single.shape[0] == 0:
                break                                   # a cycle: reseed
            kid = xorkey[single]
            # a key may hold several slots of degree 1: peel it once
            kid, first = np.unique(kid, return_index=True)
            peel_slots = single[first]
            live = alive[kid]
            kid, peel_slots = kid[live], peel_slots[live]
            if kid.shape[0] == 0:
                break
            alive[kid] = False
            remaining -= kid.shape[0]
            krows = slots[kid].reshape(-1)
            np.add.at(count, krows, -1)
            np.bitwise_xor.at(xorkey, krows, np.repeat(kid, 3))
            rounds.append((kid, peel_slots))
        if remaining:
            continue
        fps = np.zeros(cap, dtype=np.uint8)
        _, _, _, fp_all = _slots_and_fp(keys, seed, seglen)
        for kid, peel_slots in reversed(rounds):
            ks = slots[kid]
            # the peel slot is still 0: acc is the xor of the other two
            acc = fps[ks[:, 0]] ^ fps[ks[:, 1]] ^ fps[ks[:, 2]]
            fps[peel_slots] = fp_all[kid] ^ acc
        return XorFilter(seed=seed, seglen=seglen, fingerprints=fps)
    return None
