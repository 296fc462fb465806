"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded through ctypes: pointers and the CUDA stream pass as
`c_void_p`, and every entry point returns `cudaGetLastError()` after its
launch, which the wrappers turn into an exception.  Libraries are built
at first use into `victorialogs_tpu_torch/_build/` (git-ignored), named
by a hash of the source, the shared headers (csrc/*.cuh) and the flags,
so an edited kernel rebuilds and an unchanged one loads at once.
`build_all()` starts one nvcc per source, all together, and waits for
them; what nvcc printed for each source (ptxas's registers, spills and
shared memory per kernel, from `-Xptxas -v`) is kept in `BUILD_LOGS`.
A source may export several entry points (`scan.cu`: the scan, the
bloom-gated scan, the ordered pair and the bloom-gated pair, each gated
one by a classic or a split-block gate; `count.cu`: the count and the
value reduction; `probe.cu`: both probes alone); `kernel(name)` loads
one by its name in `SIGNATURES`.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# kernel name -> (source in csrc/, C entry point, argtypes)
SIGNATURES = {
    "scan": ("scan", "vl_match_scan",
             (_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P)),
    "scan_gated": ("scan", "vl_match_scan_gated",
                   (_P, _P, _I, _P, _I, _I, _I, _I, _I,
                    _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P)),
    "pair": ("scan", "vl_match_pair",
             (_P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P)),
    "pair_gated": ("scan", "vl_match_pair_gated",
                   (_P, _P, _I, _I, _P, _I, _P, _I,
                    _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P)),
    "count": ("count", "vl_count_seg", (_P, _P, _P, _I, _I, _I, _P, _P)),
    "values": ("count", "vl_stats_values",
               (_P, _I, _P, _P, _I, _I, _P, _I, _IP, _P)),
    "probe": ("probe", "vl_plane_keep", (_P, _I, _I, _P, _P, _I, _P, _P, _P)),
    "probe_sb": ("probe", "vl_plane_keep_sb",
                 (_P, _I, _I, _P, _P, _I, _P, _P, _P)),
    "scan_gated_sb": ("scan", "vl_match_scan_gated_sb",
                      (_P, _P, _I, _P, _I, _I, _I, _I, _I,
                       _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P)),
    "pair_gated_sb": ("scan", "vl_match_pair_gated_sb",
                      (_P, _P, _I, _I, _P, _I, _P, _I,
                       _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P)),
}
SOURCES = tuple(dict.fromkeys(src for src, _e, _a in SIGNATURES.values()))

_mu = threading.Lock()
_fns: dict = {}
BUILD_LOGS: dict = {}      # source name -> nvcc's output of its last build


def nvcc_path() -> str:
    got = shutil.which("nvcc")
    if got:
        return got
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds
    spent.  Raises with nvcc's output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{BUILD_LOGS[name]}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def kernel(name: str):
    """The ctypes entry point `name` of SIGNATURES, building its source
    if needed."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _mu:
        fn = _fns.get(name)
        if fn is None:
            src, entry, argtypes = SIGNATURES[name]
            path = library_path(src)
            if not path.exists():
                build_all((src,))
            fn = getattr(ctypes.CDLL(str(path)), entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def check_cuda(t, dtype, ndim: int, name: str, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` with `ndim`
    dims (and `shape`, when given): what a kernel's pointer may hold."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} with {ndim} "
                         f"dims, got {t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: want shape {shape}, got "
                         f"{tuple(t.shape)}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
