"""Split-block bloom filters: the sealed part's per-block layout.

A classic filter (storage/bloom.py) spreads a token's 6 probe bits over
the whole filter, so a probe reads 6 scattered words.  The split-block
layout (Lang et al., arXiv:2101.01719) first selects one 256-bit block
per token and puts all 6 bits in it: a probe reads 8 contiguous uint32
lanes, one 32-byte sector on the card.

Both derivations are integer math on the token's xxhash64, the JAX
package's (victorialogs_tpu/storage/filterindex/sbbloom.py) bit for bit:

- the in-block bit positions are the classic probe stream of a 4-word
  filter (`bloom_probe_positions(h, 4)`: 256 bits);
- the block is a fastrange reduction of a salted splitmix64 mix, so it
  shares no bits with the in-block stream.

16 bits a distinct token and 6 probe bits, as the classic filters.
"""

from __future__ import annotations

import numpy as np

from ...utils.hashing import splitmix64_np
from ..bloom import bloom_probe_positions

SB_BLOCK_BITS = 256
SB_LANES = 8                     # 256 bits as 8 uint32 lanes
SB_BITS_PER_TOKEN = 16
SB_HASHES = 6
_SB_SELECT_SALT = np.uint64(0xA076_1D64_78BD_642F)


def sb_num_blocks(ntokens: int) -> int:
    """256-bit blocks allotted to `ntokens` distinct tokens (>= 1)."""
    return max(1, (ntokens * SB_BITS_PER_TOKEN + SB_BLOCK_BITS - 1)
               // SB_BLOCK_BITS)


def sb_block_select(hashes: np.ndarray, m) -> np.ndarray:
    """Token -> 256-bit block index in [0, m) (fastrange); `m` a scalar
    or an int array broadcast against `hashes`."""
    r = splitmix64_np(hashes.astype(np.uint64) ^ _SB_SELECT_SALT) \
        >> np.uint64(32)
    return ((r * np.asarray(m, dtype=np.uint64)) >> np.uint64(32)) \
        .astype(np.int64)


def sb_bit_positions(hashes: np.ndarray) -> np.ndarray:
    """In-block bit positions -> uint64[T, 6] in [0, 256)."""
    return bloom_probe_positions(hashes.astype(np.uint64), 4)


def sb_build(hashes: np.ndarray) -> np.ndarray:
    """One split-block filter -> uint32 lanes [8 * m]; no tokens give one
    all-zero block, which every probe misses."""
    m = sb_num_blocks(len(hashes))
    lanes = np.zeros(SB_LANES * m, dtype=np.uint32)
    if len(hashes) == 0:
        return lanes
    h = hashes.astype(np.uint64)
    bsel = sb_block_select(h, m)
    pos = sb_bit_positions(h)
    lane = bsel[:, None] * SB_LANES + (pos >> np.uint64(5)).astype(np.int64)
    bit = np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32)
    np.bitwise_or.at(lanes, lane, bit)
    return lanes


def sb_token_masks(hashes: np.ndarray) -> np.ndarray:
    """Each token's 256-bit probe mask -> uint32[T, 8].  It does not
    depend on the filter's size, so one table serves every block."""
    t = len(hashes)
    masks = np.zeros((t, SB_LANES), dtype=np.uint32)
    if t == 0:
        return masks
    pos = sb_bit_positions(hashes)
    rows = np.broadcast_to(np.arange(t, dtype=np.int64)[:, None], pos.shape)
    bit = np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32)
    np.bitwise_or.at(masks, (rows, (pos >> np.uint64(5)).astype(np.int64)),
                     bit)
    return masks


def sb_contains_all(lanes: np.ndarray, hashes: np.ndarray) -> bool:
    """True when every token's 6 bits are set in its selected block
    (false positives possible, no false negatives)."""
    if len(hashes) == 0:
        return True
    m = lanes.shape[0] // SB_LANES
    base = sb_block_select(hashes.astype(np.uint64), m) * SB_LANES
    masks = sb_token_masks(hashes)
    words = lanes[base[:, None] + np.arange(SB_LANES)]
    return bool(((words & masks) == masks).all())
