"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is
missing; running on the CPU is an explicit request (``device="cpu"``),
which is how the CPU tests drive the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`.  On the card it goes through pinned
    memory as a non-blocking copy on the current stream: no host wait,
    so an upload does not stall behind the kernels already queued (the
    pinned buffer is held by PyTorch's host allocator until the copy is
    done).  On the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
