"""The bloom plane probe (kernel 3) and its staging helpers.

`plane_keep(plane, idx, shift, nwords)` is the per-block keep-mask of
a packed bloom plane (storage/filterbank.py): True where every probed
bit `shift[b, j]` of uint32 lane `idx[b, j]` of block b is set, or where
`nwords[b] == 0` (the block has no bloom).  On a CUDA tensor it launches
the hand-written kernel csrc/probe.cu; on a CPU tensor it runs
`plane_keep_plain`.  It replaces the JAX package's TPU kernel
tpu/bloom_device.py plane_keep_pallas.

Inside a device filter the probe gates a scan: a `BloomGate` (the plane,
one leaf's probes and the layout's block starts) rides into the scan's
own launch (kernels.match_scan_gated), so a bloom leaf ANDed with a scan
costs one launch and no bytes of the blocks it rules out.  The planner
launches no standalone probe; `plane_keep` stays the probe's kernel on
its own, held against its plain version and the Pallas kernel.

A sealed part with a filter index (storage/filterindex) gates by its
split-block filters instead: a token's 6 probe bits lie in one 256-bit
block, so the keep of (block b, token t) reads the 8 contiguous lanes
at `plane[b, sbidx[b, t]:+8]` and compares them, ANDed, with the
token's mask `mask[t]`; a block with `nsb[b] == 0` (no filter) keeps.
`plane_keep_sb` is that probe alone (csrc/probe.cu `vl_plane_keep_sb`,
plain version `plane_keep_sb_plain`), and an `SbGate` rides into the
scan's launch as a `BloomGate` does (kernels.match_scan_gated_sb).  The
JAX package runs it as jnp inside its fused program
(tpu/bloom_device.py plane_keep_sb, the `bloom_sb` node), outside
Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import to_device

from .build import check, check_cuda, kernel, stream_ptr

PROBE_TILE_B = 128     # block-axis padding of staged planes
PROBE_LANE = 128       # lane-axis padding of staged planes


def probe_bits_plain(plane, idx, shift) -> torch.Tensor:
    """bool[B, P]: bit shift[b, j] of lane idx[b, j] of block b is set
    (a lane index outside the plane reads as a zero lane)."""
    wp = plane.shape[1]
    lanes = plane.to(torch.int64) & 0xFFFFFFFF
    i = idx.to(torch.int64)
    inside = (i >= 0) & (i < wp)
    words = torch.gather(lanes, 1, i.clamp(0, wp - 1))
    words = torch.where(inside, words, torch.zeros_like(words))
    return ((words >> (shift.to(torch.int64) & 31)) & 1) != 0


def plane_keep_plain(plane, idx, shift, nwords) -> torch.Tensor:
    """Plain PyTorch probe: gather + bit test in int64 lanes."""
    if idx.shape[1] == 0:
        return torch.ones(plane.shape[0], dtype=torch.bool,
                          device=plane.device)
    return probe_bits_plain(plane, idx, shift).all(dim=1) | (nwords == 0)


def plane_keep(plane: torch.Tensor, idx: torch.Tensor, shift: torch.Tensor,
               nwords: torch.Tensor) -> torch.Tensor:
    """bool[B]; plane int32[B, WP] (uint32 lanes), idx/shift int32[B, P],
    nwords int32[B]."""
    if plane.device.type == "cpu":
        return plane_keep_plain(plane, idx, shift, nwords)
    check_cuda(plane, torch.int32, 2, "plane")
    b, wp = plane.shape
    p = idx.shape[1]
    check_cuda(idx, torch.int32, 2, "idx", (b, p))
    check_cuda(shift, torch.int32, 2, "shift", (b, p))
    check_cuda(nwords, torch.int32, 1, "nwords", (b,))
    out = torch.empty(b, dtype=torch.bool, device=plane.device)
    check(kernel("probe")(plane.data_ptr(), b, wp, idx.data_ptr(),
                          shift.data_ptr(), p, nwords.data_ptr(),
                          out.data_ptr(), stream_ptr(plane)), "probe")
    plane_keep.launches += 1
    return out


plane_keep.launches = 0


@dataclass
class StagedBloomPlane:
    """One part column's bloom plane on the device."""
    plane: torch.Tensor            # int32[Bp, WP]
    nwords: torch.Tensor           # int32[Bp]; 0 = always keep
    bp: int                        # padded block count
    nbytes: int

    def device_bytes(self) -> int:
        return self.nbytes


def pad_plane(plane: np.ndarray, nwords: np.ndarray):
    """Pad the block axis to a PROBE_TILE_B multiple and the lanes to a
    PROBE_LANE multiple; pad blocks carry nwords=0 (always keep)."""
    b, wp = plane.shape
    bp = -(-b // PROBE_TILE_B) * PROBE_TILE_B
    wpp = max(PROBE_LANE, -(-wp // PROBE_LANE) * PROBE_LANE)
    out = np.zeros((bp, wpp), dtype=np.uint32)
    out[:b, :wp] = plane
    nw = np.zeros(bp, dtype=np.int32)
    nw[:b] = nwords
    return out, nw


def pad_probe_args(idx: np.ndarray, shift: np.ndarray, bp: int):
    """Pad per-block (idx, shift) to the padded block count."""
    b = idx.shape[0]
    out_i = np.zeros((bp, idx.shape[1]), dtype=np.int32)
    out_s = np.zeros((bp, idx.shape[1]), dtype=np.int32)
    out_i[:b] = idx
    out_s[:b] = shift
    return out_i, out_s


def stage_bloom_plane(plb, device) -> StagedBloomPlane:
    plane, nw = pad_plane(plb.plane, plb.nwords)
    return StagedBloomPlane(
        plane=to_device(plane.view(np.int32), device),
        nwords=to_device(nw, device), bp=plane.shape[0],
        nbytes=plane.nbytes + nw.nbytes)


def block_starts(part, layout) -> np.ndarray:
    """int32[B+1]: the first layout row of each block in index order,
    then the part's row count."""
    return np.array([layout.starts[bi] for bi in range(part.num_blocks)]
                    + [layout.nrows], dtype=np.int32)


def pad_sb_plane(plane: np.ndarray, nsb: np.ndarray):
    """Pad a split-block plane as pad_plane does; pad blocks carry
    nsb=0 (always keep) and zero lanes."""
    b, lp = plane.shape
    bp = -(-b // PROBE_TILE_B) * PROBE_TILE_B
    lpp = max(PROBE_LANE, -(-lp // PROBE_LANE) * PROBE_LANE)
    out = np.zeros((bp, lpp), dtype=np.uint32)
    out[:b, :lp] = plane
    ns = np.zeros(bp, dtype=np.int32)
    ns[:b] = nsb
    return out, ns


def pad_sb_idx(sbidx: np.ndarray, bp: int) -> np.ndarray:
    """Pad per-block lane bases to the padded block count."""
    out = np.zeros((bp, sbidx.shape[1]), dtype=np.int32)
    out[:sbidx.shape[0]] = sbidx
    return out


@dataclass
class StagedSBPlane:
    """One sealed part column's split-block plane on the device."""
    plane: torch.Tensor            # int32[Bp, LP] (uint32 lanes)
    nsb: torch.Tensor              # int32[Bp]; 0 = always keep
    bp: int                        # padded block count
    nbytes: int

    def device_bytes(self) -> int:
        return self.nbytes


def stage_sb_plane(plane: np.ndarray, nsb: np.ndarray,
                   device) -> StagedSBPlane:
    plane, ns = pad_sb_plane(plane, nsb)
    return StagedSBPlane(plane=to_device(plane.view(np.int32), device),
                         nsb=to_device(ns, device), bp=plane.shape[0],
                         nbytes=plane.nbytes + ns.nbytes)


SB_PROBE_LANES = 8


def probe_np_sb(plane: np.ndarray, sbidx: np.ndarray, mask: np.ndarray,
                nsb: np.ndarray) -> np.ndarray:
    """Host split-block probe (the JAX package's probe_np_sb): bool[B],
    True where every token's masked lanes are set or nsb == 0."""
    b, t = sbidx.shape
    if t == 0:
        return np.ones(b, dtype=bool)
    lane = (sbidx[:, :, None] + np.arange(SB_PROBE_LANES, dtype=np.int32)) \
        .reshape(b, t * SB_PROBE_LANES)
    words = np.take_along_axis(plane, lane, axis=1) \
        .reshape(b, t, SB_PROBE_LANES)
    ok = ((words & mask[None, :, :]) == mask[None, :, :]).all(axis=2)
    return ok.all(axis=1) | (nsb == 0)


def plane_keep_sb_plain(plane, sbidx, mask, nsb) -> torch.Tensor:
    """Plain PyTorch split-block probe on int32 lanes (uint32 bit
    patterns; AND and compare need no shift): bool[B].  A lane index
    outside the plane reads as a zero lane."""
    b, t = sbidx.shape
    if t == 0:
        return torch.ones(b, dtype=torch.bool, device=plane.device)
    lp = plane.shape[1]
    lane = (sbidx.to(torch.int64)[:, :, None]
            + torch.arange(SB_PROBE_LANES, device=plane.device)) \
        .reshape(b, t * SB_PROBE_LANES)
    inside = (lane >= 0) & (lane < lp)
    words = torch.gather(plane, 1, lane.clamp(0, lp - 1))
    words = torch.where(inside, words, torch.zeros_like(words)) \
        .reshape(b, t, SB_PROBE_LANES)
    m = mask[None, :, :]
    return ((words & m) == m).all(dim=2).all(dim=1) | (nsb == 0)


def plane_keep_sb(plane: torch.Tensor, sbidx: torch.Tensor,
                  mask: torch.Tensor, nsb: torch.Tensor) -> torch.Tensor:
    """bool[B]; plane int32[B, LP] (uint32 lanes), sbidx int32[B, T],
    mask int32[T, 8] (uint32 bits), nsb int32[B]."""
    if plane.device.type == "cpu":
        return plane_keep_sb_plain(plane, sbidx, mask, nsb)
    check_cuda(plane, torch.int32, 2, "plane")
    b, lp = plane.shape
    t = sbidx.shape[1]
    check_cuda(sbidx, torch.int32, 2, "sbidx", (b, t))
    check_cuda(mask, torch.int32, 2, "mask", (t, SB_PROBE_LANES))
    check_cuda(nsb, torch.int32, 1, "nsb", (b,))
    out = torch.empty(b, dtype=torch.bool, device=plane.device)
    check(kernel("probe_sb")(plane.data_ptr(), b, lp, sbidx.data_ptr(),
                             mask.data_ptr(), t, nsb.data_ptr(),
                             out.data_ptr(), stream_ptr(plane)), "probe_sb")
    plane_keep_sb.launches += 1
    return out


plane_keep_sb.launches = 0


@dataclass
class BloomGate:
    """What gates a scan by one bloom leaf: a part's staged plane, the
    leaf's per-block probes and the layout's block starts.  Row `row`
    belongs to the block b with starts[b] <= row < starts[b+1] (the last
    such b where blocks are empty); rows outside [starts[0], starts[B])
    belong to none and are ruled out."""
    plane: torch.Tensor            # int32[Bp, WP], Bp >= B
    nwords: torch.Tensor           # int32[Bp]
    idx: torch.Tensor              # int32[Bp, P]
    shift: torch.Tensor            # int32[Bp, P]
    starts: torch.Tensor           # int32[B+1], nondecreasing

    def keep_plain(self) -> torch.Tensor:
        return plane_keep_plain(self.plane, self.idx, self.shift,
                                self.nwords)


@dataclass
class SbGate:
    """What gates a scan by one bloom leaf on a sealed part: the staged
    split-block plane, the leaf's per-(block, token) lane bases, its
    tokens' masks and the layout's block starts (rows map to blocks as
    a BloomGate's do)."""
    plane: torch.Tensor            # int32[Bp, LP], Bp >= B
    nsb: torch.Tensor              # int32[Bp]
    sbidx: torch.Tensor            # int32[Bp, T]
    mask: torch.Tensor             # int32[T, 8]
    starts: torch.Tensor           # int32[B+1], nondecreasing

    def keep_plain(self) -> torch.Tensor:
        return plane_keep_sb_plain(self.plane, self.sbidx, self.mask,
                                   self.nsb)


def keep_rows_plain(gate, r: int) -> torch.Tensor:
    """bool[r]: the row's block is kept by the gate's probe (a BloomGate
    or an SbGate)."""
    keep = gate.keep_plain()
    starts = gate.starts.to(torch.int64)
    nb = starts.numel() - 1
    if nb < 1:
        return torch.zeros(r, dtype=torch.bool, device=starts.device)
    rows = torch.arange(r, dtype=torch.int64, device=starts.device)
    b = torch.searchsorted(starts, rows, right=True) - 1
    inside = (b >= 0) & (b < nb)
    return keep[b.clamp(0, nb - 1)] & inside
