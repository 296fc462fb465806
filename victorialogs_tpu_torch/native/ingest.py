"""The insert path's host library: native/ingest.cpp through ctypes.

`ingest.cpp` holds the strict-subset JSON-lines scanner of
`/insert/jsonline` (`vl_jsonline_scan`) and the tokenizer and token
hashes of the block build (`vl_tokenize_arena`,
`vl_unique_token_hashes`).  It compiles at first use into
`_build/libvlingest_<hash>.so` (native/__init__.py `compile_library`),
a library of its own beside the serializer's.  A failed build or load
raises; the callers have no Python stand-in.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import compile_library, compiled_path

SRC = Path(__file__).resolve().parent / "ingest.cpp"
STEM = "libvlingest"

_mu = threading.Lock()
_lib = None


def library_path() -> Path:
    return compiled_path(SRC, STEM)


def build() -> float:
    """Compile the library unless it exists; returns the seconds spent."""
    return compile_library(SRC, STEM, "the ingest library")


def load():
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _mu:
        if _lib is None:
            build()
            try:
                lib = ctypes.CDLL(str(library_path()))
                scan = lib.vl_jsonline_scan
                tok = lib.vl_tokenize_arena
                uniq = lib.vl_unique_token_hashes
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"cannot load the ingest library "
                                   f"{library_path()}: {e}") from e
            p = ctypes.c_void_p
            i64 = ctypes.c_int64
            scan.argtypes = [p, i64, p, i64, p, i64, p, i64, p, p]
            scan.restype = i64
            tok.argtypes = [p, p, p, i64, p, p, p, i64]
            tok.restype = i64
            uniq.argtypes = [p, p, p, i64, p, i64]
            uniq.restype = i64
            _lib = lib
    return _lib


def _arena_args(arena, offsets, lengths):
    arena = np.ascontiguousarray(arena, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    n = int(offsets.shape[0])
    if lengths.shape != (n,) or (n and (
            offsets.min() < 0 or lengths.min() < 0
            or (offsets + lengths).max() > arena.size)):
        raise ValueError(f"offsets and lengths must lie in the arena "
                         f"({n} values, {arena.size} bytes)")
    return arena, offsets, lengths, n


def unique_token_hashes(arena, offsets, lengths) -> np.ndarray:
    """xxh64 of every distinct token of the values (first-seen order):
    tokenize, hash and dedupe in one pass.  Equal, as a set, to
    hash_tokens(unique_tokens_bytes(arena, *tokenize_arena(...)[:2]))."""
    lib = load()
    arena, offsets, lengths, n = _arena_args(arena, offsets, lengths)
    # a token takes at least one byte and one separator, bar the last
    cap = max(64, int(arena.shape[0]) // 2 + n + 1)
    out = np.empty(cap, dtype=np.uint64)
    got = lib.vl_unique_token_hashes(arena.ctypes.data, offsets.ctypes.data,
                                     lengths.ctypes.data, n,
                                     out.ctypes.data, cap)
    if got < 0:
        raise RuntimeError(f"vl_unique_token_hashes: more than {cap} "
                           f"tokens in {arena.size} bytes")
    return out[:got].copy()


def tokenize_arena(arena, offsets, lengths):
    """(tok_start, tok_end, tok_row) of every token of the values, as
    utils/tokenizer.tokenize_arena gives them."""
    lib = load()
    arena, offsets, lengths, n = _arena_args(arena, offsets, lengths)
    cap = max(64, int(arena.shape[0]) + 1)
    ts = np.empty(cap, dtype=np.int64)
    te = np.empty(cap, dtype=np.int64)
    tr = np.empty(cap, dtype=np.int64)
    got = lib.vl_tokenize_arena(arena.ctypes.data, offsets.ctypes.data,
                                lengths.ctypes.data, n, ts.ctypes.data,
                                te.ctypes.data, tr.ctypes.data, cap)
    if got < 0:
        raise RuntimeError(f"vl_tokenize_arena: more than {cap} tokens")
    return ts[:got].copy(), te[:got].copy(), tr[:got].copy()


def jsonline_scan(body: bytes):
    """Scan a newline-aligned chunk of JSON lines.  Returns (arena bytes,
    fields int32[N, 5], lines int32[M, 5], sigs int64[M], arena_is_ascii)
    as ingest.cpp lays them out, or None when the chunk is empty, too
    long for int32 offsets, or a capacity bound of the scan trips: the
    caller parses that chunk line by line in Python."""
    lib = load()
    if not body or len(body) >= (1 << 31) - 8:
        return None
    blen = len(body)
    buf = np.frombuffer(body, dtype=np.uint8)
    arena = np.empty(blen, dtype=np.uint8)
    fields_cap = blen // 4 + 64
    lines_cap = blen // 3 + 64
    fields = np.empty((fields_cap, 5), dtype=np.int32)
    lines = np.empty((lines_cap, 5), dtype=np.int32)
    sigs = np.empty(lines_cap, dtype=np.int64)
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.vl_jsonline_scan(buf.ctypes.data, blen, arena.ctypes.data,
                              blen, fields.ctypes.data, fields_cap,
                              lines.ctypes.data, lines_cap,
                              sigs.ctypes.data, counts.ctypes.data)
    if rc != 0:
        return None
    nl, nf, used, ascii_ = (int(counts[0]), int(counts[1]),
                            int(counts[2]), bool(counts[3]))
    return (arena[:used].tobytes(), fields[:nf], lines[:nl], sigs[:nl],
            ascii_)

