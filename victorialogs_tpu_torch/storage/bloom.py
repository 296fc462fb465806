"""Per-block split bloom filters over column tokens.

Same parameters as the reference (lib/logstorage/bloomfilter.go:15-19):
6 probe bits per token, 16 bits allotted per distinct token, one filter per
(block, column).  Probe positions are derived from the token's xxhash64 by an
iterated splitmix64 stream (the reference iterates xxhash on the hash —
bloomfilter.go:126-170; splitmix keeps the derivation pure integer math so the
same positions are computable on device from a staged uint64 hash without any
string access).

Build and probe are fully vectorized over numpy uint64 words.  The device
probe (gpu/bloom_device.py) reads the same words as 2x uint32 lanes.
"""

from __future__ import annotations

import numpy as np

from ..utils.hashing import splitmix64_np

BLOOM_HASHES = 6
BLOOM_BITS_PER_TOKEN = 16


def bloom_num_words(ntokens: int) -> int:
    bits = max(64, BLOOM_BITS_PER_TOKEN * ntokens)
    return (bits + 63) // 64


def bloom_build(token_hashes: np.ndarray) -> np.ndarray:
    """Build a bloom filter from uint64 token hashes -> uint64[W] words."""
    nwords = bloom_num_words(len(token_hashes))
    nbits = np.uint64(nwords * 64)
    words = np.zeros(nwords, dtype=np.uint64)
    h = token_hashes.astype(np.uint64, copy=True)
    one = np.uint64(1)
    for _ in range(BLOOM_HASHES):
        pos = h % nbits
        np.bitwise_or.at(words, (pos >> np.uint64(6)).astype(np.int64),
                         one << (pos & np.uint64(63)))
        h = splitmix64_np(h)
    return words


def bloom_contains_all(words: np.ndarray, token_hashes: np.ndarray) -> bool:
    """True if every token's 6 probe bits are set (possible false positives)."""
    if len(token_hashes) == 0:
        return True
    nbits = np.uint64(words.shape[0] * 64)
    h = token_hashes.astype(np.uint64, copy=True)
    one = np.uint64(1)
    ok = np.ones(len(h), dtype=bool)
    for _ in range(BLOOM_HASHES):
        pos = h % nbits
        bit = (words[(pos >> np.uint64(6)).astype(np.int64)]
               >> (pos & np.uint64(63))) & one
        ok &= bit.astype(bool)
        if not ok.any():
            return False
        h = splitmix64_np(h)
    return bool(ok.all())


def bloom_probe_positions(token_hashes: np.ndarray, nwords: int) -> np.ndarray:
    """Probe positions of one filter size -> uint64[T, 6] (the
    split-block filters' in-block positions are those of 4 words)."""
    return bloom_probe_positions_multi(token_hashes, (nwords,))[0]


def bloom_probe_positions_multi(token_hashes: np.ndarray,
                                nwords_list) -> np.ndarray:
    """Probe positions for SEVERAL filter sizes at once -> uint64[S, T, 6].

    A part's blocks carry different-size filters (word count tracks the
    block's distinct token count), so batched probing needs positions
    per distinct size; the splitmix64 stream depends only on the hashes
    and is iterated once here, then reduced modulo each size's bit
    count — a single broadcast instead of S separate iterations."""
    h = token_hashes.astype(np.uint64, copy=True)
    hs = np.empty((len(h), BLOOM_HASHES), dtype=np.uint64)
    for k in range(BLOOM_HASHES):
        hs[:, k] = h
        h = splitmix64_np(h)
    nbits = np.asarray(nwords_list, dtype=np.uint64) * np.uint64(64)
    return hs[None, :, :] % nbits[:, None, None]
