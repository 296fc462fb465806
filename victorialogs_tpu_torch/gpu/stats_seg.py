"""The masked (segment, bucket) count histogram (kernel 2).

`stats_count_seg(seg_ids, bucket_ids, mask, nseg, nb)` counts, for
every (segment, bucket) cell, the rows whose mask is set, flattened
seg-major (cell s*nb + b).  `seg_ids=None` puts every row in segment 0,
so `nseg=1` is the plain per-bucket count of a `stats count()` group-by.
Rows with an id outside its axis count nowhere.  On a CUDA tensor it
launches the hand-written kernel csrc/count.cu (an integer histogram:
warp sums for up to 32 cells, shared-memory bins up to 12288, global
atomics beyond; no float anywhere); on a CPU tensor it runs
`stats_count_seg_plain`.  Views at any storage offset are counted
right: inputs that are not 16-byte aligned take the kernel's scalar
loads instead of its 16-byte ones.  It
replaces the JAX package's TPU kernel tpu/stats_seg.py
stats_count_seg_pallas and the count reduction of
kernels.stats_count_local.

Counts are exact and returned as int32 (the uint32 bit pattern of the
TPU result; a part holds far fewer than 2**31 rows).

`stats_values(columns, ids, mask, nb)` reduces F uint32 value columns
(int32 bit patterns) over the same ids and mask to per-cell count, sum,
min and max of each column, over the rows whose mask is set and whose id
lies in [0, nb), packed in one int32[F, 5*nb] tensor (`split_values`
names the parts of a row).  On a CUDA tensor it launches csrc/count.cu
`vl_stats_values`, which takes up to 8 columns a launch (fewer where
their cell tables would not fit a CTA's shared memory) and reads each
row's id and mask once a launch; on a CPU tensor it runs
`stats_values_plain`, a chunked masked one-hot reduction.  It replaces
the JAX package's tpu/kernels.py stats_values_local, run once a column,
whose four byte-plane sums become one exact int64 sum.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import check, check_cuda, kernel, stream_ptr

STATS_CHUNK = 8192     # rows per one-hot step of the plain versions


def stats_count_seg_plain(seg_ids, bucket_ids, mask, nseg: int,
                          nb: int) -> torch.Tensor:
    """Plain PyTorch: chunked one-hot compare-and-sum, as on the TPU."""
    dev = bucket_ids.device
    b = bucket_ids.to(torch.int64)
    s = torch.zeros_like(b) if seg_ids is None else seg_ids.to(torch.int64)
    ok = mask & (s >= 0) & (s < nseg) & (b >= 0) & (b < nb)
    cell = torch.where(ok, s * nb + b, torch.full_like(b, -1))
    cells = torch.arange(nseg * nb, dtype=torch.int64, device=dev)
    acc = torch.zeros(nseg * nb, dtype=torch.int64, device=dev)
    # one-hot tiles of at most 32M cells
    step = max(1, min(STATS_CHUNK, (32 << 20) // (nseg * nb)))
    for i in range(0, cell.shape[0], step):
        acc += (cell[i:i + step, None] == cells[None, :]).sum(dim=0)
    return acc.to(torch.int32)


def stats_count_seg(seg_ids, bucket_ids: torch.Tensor, mask: torch.Tensor,
                    nseg: int, nb: int) -> torch.Tensor:
    """int32[nseg*nb] masked counts; seg_ids/bucket_ids int32[R] (seg_ids
    may be None), mask bool[R]."""
    if nseg <= 0 or nb <= 0:
        raise ValueError(f"nseg={nseg}, nb={nb} must be positive")
    if bucket_ids.device.type == "cpu":
        return stats_count_seg_plain(seg_ids, bucket_ids, mask, nseg, nb)
    r = bucket_ids.shape[0]
    check_cuda(bucket_ids, torch.int32, 1, "bucket_ids")
    check_cuda(mask, torch.bool, 1, "mask", (r,))
    if seg_ids is not None:
        check_cuda(seg_ids, torch.int32, 1, "seg_ids", (r,))
    out = torch.zeros(nseg * nb, dtype=torch.int32,
                      device=bucket_ids.device)
    check(kernel("count")(
        None if seg_ids is None else seg_ids.data_ptr(),
        bucket_ids.data_ptr(), mask.data_ptr(), r, nseg, nb,
        out.data_ptr(), stream_ptr(bucket_ids)), "count")
    stats_count_seg.launches += 1
    return out


stats_count_seg.launches = 0


def split_values(packed: torch.Tensor, nb: int):
    """(count int32, sum int64, min int32, max int32) views of one
    column's packed [sum as nb int64 | count | min | max] int32[5*nb];
    min and max are uint32 bit patterns, 0xFFFFFFFF and 0 in an empty
    cell.  The sum is a copy where the row starts at an odd word (a row
    of an [F, 5*nb] result with nb odd), which an int64 view cannot
    take."""
    sums = packed[:2 * nb]
    if sums.storage_offset() % 2:
        sums = sums.clone()
    return (packed[2 * nb:3 * nb], sums.view(torch.int64),
            packed[3 * nb:4 * nb], packed[4 * nb:])


def _pack_values(cnt, sums, mn, mx) -> torch.Tensor:
    """int64 per-cell results (min, max in [0, 2**32)) -> the packed
    int32 layout of one column of `stats_values`."""
    nb = cnt.shape[0]

    def bits(x):
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)

    out = torch.empty(5 * nb, dtype=torch.int32, device=cnt.device)
    out[:2 * nb].view(torch.int64).copy_(sums)
    out[2 * nb:3 * nb] = cnt.to(torch.int32)
    out[3 * nb:4 * nb] = bits(mn)
    out[4 * nb:] = bits(mx)
    return out


def _check_values_args(columns, nb: int) -> list:
    columns = list(columns)
    if nb <= 0 or not columns:
        raise ValueError(f"nb={nb} must be positive and columns "
                         f"({len(columns)}) non-empty")
    return columns


def stats_values_plain(columns, ids, mask, nb: int) -> torch.Tensor:
    """Plain PyTorch: chunked masked one-hot compare, then sum, min and
    max of every column over each tile, as the TPU's scan over row
    chunks."""
    columns = _check_values_args(columns, nb)
    dev = ids.device
    b = ids.to(torch.int64)
    cell = torch.where(mask & (b >= 0) & (b < nb), b, torch.full_like(b, -1))
    cells = torch.arange(nb, dtype=torch.int64, device=dev)
    vals = [c.to(torch.int64) & 0xFFFFFFFF for c in columns]
    f = len(vals)
    cnt = torch.zeros(nb, dtype=torch.int64, device=dev)
    sums = torch.zeros((f, nb), dtype=torch.int64, device=dev)
    mn = torch.full((f, nb), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    mx = torch.zeros((f, nb), dtype=torch.int64, device=dev)
    # int64 tiles of at most 4M cells
    step = max(1, min(STATS_CHUNK, (4 << 20) // nb))
    for i in range(0, cell.shape[0], step):
        hot = cell[i:i + step, None] == cells[None, :]
        cnt += hot.sum(dim=0)
        for k, v in enumerate(vals):
            vi = v[i:i + step, None]
            sums[k] += torch.where(hot, vi, 0).sum(dim=0)
            mn[k] = torch.minimum(
                mn[k], torch.where(hot, vi, 0xFFFFFFFF).amin(dim=0))
            mx[k] = torch.maximum(mx[k], torch.where(hot, vi, 0).amax(dim=0))
    return torch.stack([_pack_values(cnt, sums[k], mn[k], mx[k])
                        for k in range(f)])


def stats_values(columns, ids: torch.Tensor, mask: torch.Tensor,
                 nb: int) -> torch.Tensor:
    """int32[F, 5*nb]: each column's packed per-cell (count, sum, min,
    max), see `split_values`; columns a sequence of F int32[R] tensors
    (uint32 bits), ids int32[R], mask bool[R]."""
    columns = _check_values_args(columns, nb)
    if ids.device.type == "cpu":
        return stats_values_plain(columns, ids, mask, nb)
    r = ids.shape[0]
    check_cuda(ids, torch.int32, 1, "ids")
    check_cuda(mask, torch.bool, 1, "mask", (r,))
    for i, c in enumerate(columns):
        check_cuda(c, torch.int32, 1, f"columns[{i}]", (r,))
    # rows of an even number of words keep every column's int64 sums
    # 8-byte aligned for the kernel's 64-bit atomics
    out = torch.empty((len(columns), 5 * nb + nb % 2), dtype=torch.int32,
                      device=ids.device)
    ptrs = (ctypes.c_void_p * len(columns))(*[c.data_ptr()
                                              for c in columns])
    launched = ctypes.c_int(0)
    rc = kernel("values")(ptrs, len(columns), ids.data_ptr(),
                          mask.data_ptr(), r, nb, out.data_ptr(),
                          out.shape[1], ctypes.byref(launched),
                          stream_ptr(ids))
    stats_values.launches += launched.value
    check(rc, "values")
    return out[:, :5 * nb]


stats_values.launches = 0


# ---- the seg slot grid of a packed unit (host numpy) ----

SLOT_CHUNK = 1024      # the slot axis is a multiple of this


def pad_slots(n: int, k: int = 0) -> int:
    """Slot-axis length: a SLOT_CHUNK multiple >= max(n, k, 1)."""
    need = max(n, k, 1)
    return -(-need // SLOT_CHUNK) * SLOT_CHUNK


def build_seg_slot_map(part, layout, min_len: int = 0) -> np.ndarray:
    """int32[S, Lp]: the layout row of member s's slot j of a packed
    part, -1 on padding slots (the JAX package's
    tpu/stats_seg.py build_seg_slot_map).  Members occupy contiguous
    row ranges of the pack layout, so the table is host arithmetic over
    the block map; the packed top-k selects on it."""
    nseg = part.num_segments
    starts, lens = [], []
    for mi in range(nseg):
        first = part.block_offset(mi)
        nxt = part.block_offset(mi + 1) if mi + 1 < nseg else \
            part.num_blocks
        starts.append(layout.starts[first])
        lens.append(sum(part.block_rows(bi) for bi in range(first, nxt)))
    idx = np.full((nseg, pad_slots(max(lens), min_len)), -1,
                  dtype=np.int32)
    for mi, (st, ln) in enumerate(zip(starts, lens)):
        idx[mi, :ln] = np.arange(st, st + ln, dtype=np.int32)
    return idx
