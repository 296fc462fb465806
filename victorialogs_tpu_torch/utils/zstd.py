"""zstd helpers, with a zlib frame where `zstandard` is missing.

`compress` writes a zstd frame when the `zstandard` module imports,
else the `VLZ1` frame: the magic `VLZ1` followed by a zlib stream at
min(level, 9).  A zstd frame starts with the magic 28 B5 2F FD, so the
two cannot be confused, and `decompress` reads either.  The frames are
the JAX package's, byte for byte, so either package reads the other's
parts.  The port starts no threads, so one compressor per level and one
decompressor are kept at module level.
"""

from __future__ import annotations

import zlib

try:
    import zstandard
except ImportError:
    zstandard = None

_ZLIB_MAGIC = b"VLZ1"

_compressors: dict = {}
_decompressor = None


def compress(data: bytes, level: int = 1) -> bytes:
    if zstandard is None:
        return _ZLIB_MAGIC + zlib.compress(data, min(level, 9))
    zc = _compressors.get(level)
    if zc is None:
        zc = _compressors[level] = zstandard.ZstdCompressor(level=level)
    return zc.compress(data)


def decompress(data: bytes, max_output_size: int = 0) -> bytes:
    """The payload of a zstd or VLZ1 frame; a frame that would decode to
    more than `max_output_size` bytes (when non-zero) raises."""
    global _decompressor
    if data[:4] == _ZLIB_MAGIC:
        if max_output_size:
            d = zlib.decompressobj()
            out = d.decompress(data[4:], max_output_size)
            if d.unconsumed_tail:
                raise ValueError(
                    f"decompressed size exceeds limit {max_output_size}")
            return out
        return zlib.decompress(data[4:])
    if zstandard is None:
        raise RuntimeError(
            "zstd frame but the zstandard module is unavailable")
    if _decompressor is None:
        _decompressor = zstandard.ZstdDecompressor()
    return _decompressor.decompress(data, max_output_size=max_output_size)
