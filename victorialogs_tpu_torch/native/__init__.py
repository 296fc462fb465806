"""The host libraries of the port: native/*.cpp through ctypes.

Each source compiles with g++ (the host compiler nvcc also uses) into a
shared library with a plain C interface at first use, into
`victorialogs_tpu_torch/_build/` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  A failed build or load raises: nothing falls back to
Python for a missing library.  This module holds the NDJSON serializer
of query answers (emit.cpp); native/ingest.py the insert path's scanner
and token hashes (ingest.cpp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "emit.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_mu = threading.Lock()
_lib = None


def compiled_path(src: Path, stem: str) -> Path:
    """Where `src` compiles to: `<stem>_<hash of source and flags>.so`."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def compile_library(src: Path, stem: str, what: str) -> float:
    """Compile `src` unless its library exists; returns the seconds
    spent.  Each process writes its own temporary file and renames it
    into place, so concurrent builders never see a partial library.
    Raises with the compiler's output when the build fails."""
    t0 = time.perf_counter()
    out = compiled_path(src, stem)
    if out.exists():
        return 0.0
    rel = f"native/{src.name}"
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: {what} ({rel}) cannot be "
                           f"built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed on {rel}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def library_path() -> Path:
    return compiled_path(SRC, "libvlemit")


def build() -> float:
    """Compile the serializer unless it exists; returns the seconds."""
    return compile_library(SRC, "libvlemit", "the NDJSON serializer")


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
                fn = lib.vl_emit_ndjson
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"cannot load the NDJSON serializer "
                                   f"{library_path()}: {e}") from e
            p = ctypes.c_void_p
            i64 = ctypes.c_int64
            fn.argtypes = [i64, i64, p, p, p, p, p, p, p, p, i64]
            fn.restype = i64
            _lib = lib
    return _lib


_DUMMY_I64 = np.zeros(1, dtype=np.int64)


def emit_ndjson_native(key_tokens: list, cols: list,
                       nrows: int) -> bytes | None:
    """NDJSON bytes of `nrows` rows of `cols`, or None when a value holds
    invalid UTF-8 (the per-row path's errors="replace" decode defines
    that block's bytes).

    key_tokens: per column, the quoted key and colon (b'"key":');
    cols: per column a kind-tagged emit column (BlockResult.emit_columns):
      (0, arena uint8[], offsets int64[n], lengths int64[n]), length 0
          meaning "omit this field";
      (1, ts int64[n])          RFC3339Nano timestamps (_time);
      (2, ts int64[n], frac_w)  ISO8601, fixed fractional width;
      (3, nums int64[n])        signed decimal;
      (4, nums uint64[n])       unsigned decimal."""
    lib = load()
    ncols = len(cols)
    if len(key_tokens) != ncols:
        raise ValueError(f"{len(key_tokens)} keys for {ncols} columns")
    keys = [np.frombuffer(t, dtype=np.uint8) for t in key_tokens]
    arenas, offs, lens = [], [], []
    kinds = np.empty(ncols, dtype=np.int64)
    params = np.zeros(ncols, dtype=np.int64)
    total_val = 0
    total_typed = 0
    for ci, col in enumerate(cols):
        kind = col[0]
        kinds[ci] = kind
        if kind == 0:
            _k, arena, o, ln = col
            arenas.append(np.ascontiguousarray(arena, dtype=np.uint8))
            offs.append(np.ascontiguousarray(o, dtype=np.int64))
            lens.append(np.ascontiguousarray(ln, dtype=np.int64))
            if offs[-1].shape != (nrows,) or lens[-1].shape != (nrows,) or \
                    (nrows and (offs[-1].min() < 0 or lens[-1].min() < 0
                                or (offs[-1] + lens[-1]).max() >
                                arenas[-1].size)):
                raise ValueError(f"emit column {ci}: offsets and lengths "
                                 f"must lie in its arena, {nrows} rows")
            total_val += int(lens[-1].sum())
        elif kind in (1, 2, 3, 4):
            dt = np.uint64 if kind == 4 else np.int64
            arenas.append(np.ascontiguousarray(col[1], dtype=dt))
            if arenas[-1].shape != (nrows,):
                raise ValueError(f"emit column {ci}: want {nrows} values, "
                                 f"got {arenas[-1].shape}")
            offs.append(_DUMMY_I64)
            lens.append(_DUMMY_I64)
            if kind == 2:
                params[ci] = int(col[2])
                if not 0 <= params[ci] <= 9:
                    raise ValueError(f"emit column {ci}: fraction width "
                                     f"{params[ci]} outside 0-9")
            total_typed += 34 * nrows   # a timestamp or a decimal
        else:
            raise ValueError(f"emit column {ci}: unknown kind {kind}")
    total_key = sum(k.size for k in keys)
    cap = 6 * total_val + total_typed + \
        nrows * (total_key + 6 * ncols + 8) + 16
    out = np.empty(cap, dtype=np.uint8)

    def ptrs(arrs):
        return (ctypes.c_void_p * max(ncols, 1))(
            *[a.ctypes.data for a in arrs])

    key_lens = np.array([k.size for k in keys], dtype=np.int64)
    n = lib.vl_emit_ndjson(
        ncols, nrows, ptrs(keys), key_lens.ctypes.data, ptrs(arenas),
        ptrs(offs), ptrs(lens), kinds.ctypes.data, params.ctypes.data,
        out.ctypes.data, cap)
    if n == -1:
        return None
    if n < 0:
        raise RuntimeError(f"vl_emit_ndjson failed ({n}) on {nrows} rows "
                           f"of {ncols} columns")
    return out[:n].tobytes()
