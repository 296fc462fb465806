"""Hashing primitives.

One xxhash64 base hash per token; bloom probe positions derive from it
by an iterated splitmix64 mixer, pure integer math that the host and the
device compute alike.  Stream IDs are 128-bit xxhash of the canonical
stream-label string.
"""

from __future__ import annotations

import numpy as np
import xxhash

_U64 = (1 << 64) - 1


def xxh64(data: bytes, seed: int = 0) -> int:
    return xxhash.xxh64_intdigest(data, seed)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a uint64 numpy array."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hash_tokens(tokens) -> np.ndarray:
    """xxhash64 of each token (bytes or str) -> uint64 array."""
    out = np.empty(len(tokens), dtype=np.uint64)
    h = xxhash.xxh64_intdigest
    for i, t in enumerate(tokens):
        out[i] = h(t.encode("utf-8") if isinstance(t, str) else t)
    return out


def cached_token_hashes(owner, tokens) -> np.ndarray:
    """hash_tokens memoized on the owning filter: a query hashes its
    tokens once, not once per part.  Keyed on the token tuple."""
    key = tuple(tokens)
    got = getattr(owner, "_token_hash_cache", None)
    if got is not None and got[0] == key:
        return got[1]
    h = hash_tokens(key)
    owner._token_hash_cache = (key, h)
    return h


def stream_id_hash(canonical_tags: bytes) -> tuple[int, int]:
    """128-bit stream hash -> (hi, lo) uint64 pair."""
    h = xxhash.xxh128_intdigest(canonical_tags)
    return (h >> 64) & _U64, h & _U64
