"""The string scan (kernel 1) and the device helpers around it.

`match_scan` is the per-row match bitmap of one pattern over a
lane-major staged string column (gpu/layout.py): phrase, prefix,
substring, exact and exact-prefix modes, word boundaries on request,
optional ASCII case fold of the data.  On a CUDA tensor it launches the
hand-written kernel csrc/scan.cu; on a CPU tensor it runs
`match_scan_plain`, the same function in plain PyTorch.  It replaces
the JAX package's TPU kernels tpu/kernels_pallas.py
match_scan_pallas and kernels32.match_scan_t.

`match_scan_gated` is the same scan gated by a bloom leaf in the same
launch (csrc/scan.cu `vl_match_scan_gated`; plain version
`match_scan_gated_plain`): rows of blocks the bloom rules out are false
without being read.  It replaces the probe
(bloom_device.plane_keep_pallas), the gather of its keep-mask to rows
and the AND with the scan that the TPU program runs for a bloom leaf.

`match_pair` decides the regexp `A.*B` (literal A and B) per row:
(definite, maybe) where A's first occurrence ends at or before the
start of B's last, maybe for rows holding a newline or truncated by the
staging (csrc/scan.cu `vl_match_pair`; plain version
`match_pair_plain`).  It replaces the JAX package's device function
kernels32.match_ordered_pair_t.  `match_pair_gated` is the same pair
behind a bloom gate in one launch, as `match_scan_gated` is the scan's
(`vl_match_pair_gated`; plain version `match_pair_gated_plain`).
On a sealed part with a filter index the gate is an `SbGate`, the
split-block probe (bloom_device.py): `match_scan_gated_sb` and
`match_pair_gated_sb` launch the same kernels with that probe
(`vl_match_scan_gated_sb`, `vl_match_pair_gated_sb`); their plain
versions are the same `match_scan_gated_plain` and
`match_pair_gated_plain`, which take either gate.

Also here: `combine_ids` (row-major combined bucket ids) and
`packbits`/`unpackbits` pinned to numpy's bit order (first element in
the most significant bit).  torch.uint32 lacks shifts and arithmetic,
so u32 lanes ride int32 bit patterns and widen to int64 masked to
0xFFFFFFFF wherever bits are extracted.
"""

from __future__ import annotations

import ctypes

import torch

from ..logsql.filters import (MODE_EXACT, MODE_EXACT_PREFIX,  # noqa: F401
                             MODE_PHRASE, MODE_PREFIX, MODE_SUBSTRING)
from .bloom_device import SB_PROBE_LANES, BloomGate, SbGate, keep_rows_plain
from .build import check, check_cuda, kernel, stream_ptr

MAX_PATTERN_LEN = 64   # longer patterns stay on the host path


def lanes_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """int32[W/4, R] lane-major staging -> uint8[R, W] row-major."""
    u = lanes.to(torch.int64) & 0xFFFFFFFF
    parts = [(u >> (8 * k)) & 0xFF for k in range(4)]
    nl, r = lanes.shape
    return torch.stack(parts, dim=-1).permute(1, 0, 2).reshape(r, nl * 4) \
        .to(torch.uint8)


def is_word_byte(b: torch.Tensor) -> torch.Tensor:
    return ((b >= 97) & (b <= 122)) | ((b >= 65) & (b <= 90)) | \
        ((b >= 48) & (b <= 57)) | (b == 95) | ((b >= 128) & (b != 255))


def match_windows_plain(lanes: torch.Tensor, pattern: bytes, mode: int,
                        starts_tok: bool, ends_tok: bool,
                        fold: bool = False) -> torch.Tensor:
    """bool[R, W - len(pattern) + 1]: the pattern sits at window s of
    row r, with the word boundaries the mode asks for (the exact modes
    read window 0 only).  Windows reaching into the padding never match;
    the caller checks the row length."""
    rows = lanes_to_bytes(lanes)
    if fold:
        up = (rows >= 65) & (rows <= 90)
        rows = torch.where(up, rows + 32, rows)
    r, w = rows.shape
    plen = len(pattern)
    nwc = w - plen + 1
    acc = torch.ones((r, nwc), dtype=torch.bool, device=lanes.device)
    for j, c in enumerate(pattern):
        acc &= rows[:, j:j + nwc] == c
    if mode in (MODE_EXACT, MODE_EXACT_PREFIX):
        return acc
    if starts_tok and mode in (MODE_PHRASE, MODE_PREFIX):
        prev = ~is_word_byte(rows[:, :nwc - 1])
        acc &= torch.cat([torch.ones((r, 1), dtype=torch.bool,
                                     device=lanes.device), prev], dim=1)
    if ends_tok and mode == MODE_PHRASE:
        nxt = ~is_word_byte(rows[:, plen:])
        acc &= torch.cat([nxt, torch.ones((r, 1), dtype=torch.bool,
                                          device=lanes.device)], dim=1)
    return acc


def match_scan_plain(lanes: torch.Tensor, lengths: torch.Tensor,
                     pattern: bytes, mode: int, starts_tok: bool,
                     ends_tok: bool, fold: bool = False) -> torch.Tensor:
    """Plain PyTorch scan: window-equality over the row-major bytes."""
    plen = len(pattern)
    if plen > 4 * lanes.shape[0]:
        return torch.zeros(lanes.shape[1], dtype=torch.bool,
                           device=lanes.device)
    acc = match_windows_plain(lanes, pattern, mode, starts_tok, ends_tok,
                              fold)
    if mode == MODE_EXACT:
        return acc[:, 0] & (lengths == plen)
    if mode == MODE_EXACT_PREFIX:
        return acc[:, 0] & (lengths >= plen)
    return acc.any(dim=1) & (lengths >= plen)


def match_scan(lanes: torch.Tensor, lengths: torch.Tensor, pattern: bytes,
               mode: int, starts_tok: bool, ends_tok: bool,
               fold: bool = False) -> torch.Tensor:
    """bool[R] match bitmap; lanes int32[W/4, R], lengths int32[R],
    pattern 1..128 bytes (pre-lowered when fold)."""
    if not 0 < len(pattern) <= 128:
        raise ValueError(f"pattern length {len(pattern)} not in 1..128")
    if lanes.device.type == "cpu":
        return match_scan_plain(lanes, lengths, pattern, mode, starts_tok,
                                ends_tok, fold)
    check_cuda(lanes, torch.int32, 2, "lanes")
    r = lanes.shape[1]
    check_cuda(lengths, torch.int32, 1, "lengths", (r,))
    out = torch.empty(r, dtype=torch.bool, device=lanes.device)
    buf = ctypes.create_string_buffer(pattern, len(pattern))
    check(kernel("scan")(lanes.data_ptr(), lengths.data_ptr(), r, buf,
                         len(pattern), mode, int(starts_tok), int(ends_tok),
                         int(fold), out.data_ptr(), stream_ptr(lanes)),
          "scan")
    match_scan.launches += 1
    return out


match_scan.launches = 0


def _gate_args(gate: BloomGate) -> tuple:
    """The checked gate arguments of the gated kernels: plane, its lane
    count, word counts, lane indices, shifts, probes a block, block
    starts and the block count."""
    check_cuda(gate.plane, torch.int32, 2, "plane")
    bp, wp = gate.plane.shape
    p = gate.idx.shape[1]
    check_cuda(gate.nwords, torch.int32, 1, "nwords", (bp,))
    check_cuda(gate.idx, torch.int32, 2, "idx", (bp, p))
    check_cuda(gate.shift, torch.int32, 2, "shift", (bp, p))
    check_cuda(gate.starts, torch.int32, 1, "starts")
    nb = gate.starts.numel() - 1
    if not 0 <= nb <= bp:
        raise ValueError(f"starts: {nb + 1} entries for a plane of {bp} "
                         f"blocks")
    return (gate.plane.data_ptr(), wp, gate.nwords.data_ptr(),
            gate.idx.data_ptr(), gate.shift.data_ptr(), p,
            gate.starts.data_ptr(), nb)


def _sb_gate_args(gate: SbGate) -> tuple:
    """The checked split-block gate arguments, in the places of
    `_gate_args`': plane, its lane count, split blocks a block, lane
    bases, token masks, tokens, block starts and the block count."""
    check_cuda(gate.plane, torch.int32, 2, "plane")
    bp, lp = gate.plane.shape
    t = gate.sbidx.shape[1]
    check_cuda(gate.nsb, torch.int32, 1, "nsb", (bp,))
    check_cuda(gate.sbidx, torch.int32, 2, "sbidx", (bp, t))
    check_cuda(gate.mask, torch.int32, 2, "mask", (t, SB_PROBE_LANES))
    check_cuda(gate.starts, torch.int32, 1, "starts")
    nb = gate.starts.numel() - 1
    if not 0 <= nb <= bp:
        raise ValueError(f"starts: {nb + 1} entries for a plane of {bp} "
                         f"blocks")
    return (gate.plane.data_ptr(), lp, gate.nsb.data_ptr(),
            gate.sbidx.data_ptr(), gate.mask.data_ptr(), t,
            gate.starts.data_ptr(), nb)


def match_scan_gated_plain(lanes: torch.Tensor, lengths: torch.Tensor,
                           pattern: bytes, mode: int, starts_tok: bool,
                           ends_tok: bool, fold: bool, gate,
                           ovf: torch.Tensor | None = None):
    """Plain PyTorch: the probe's keep-mask expanded to rows through the
    block starts, ANDed with the plain scan; see `match_scan_gated`.
    `gate` is a BloomGate or an SbGate."""
    rows = keep_rows_plain(gate, lanes.shape[1])
    hit = match_scan_plain(lanes, lengths, pattern, mode, starts_tok,
                           ends_tok, fold) & rows
    if ovf is None:
        return hit, None
    return hit & ~ovf, ovf & rows


def _launch_scan_gated(name: str, gargs: tuple, lanes, lengths,
                       pattern: bytes, mode: int, starts_tok: bool,
                       ends_tok: bool, fold: bool, ovf):
    """One launch of the gated scan entry `name` with checked gate
    arguments `gargs` (`_gate_args` or `_sb_gate_args`): (definite,
    maybe)."""
    check_cuda(lanes, torch.int32, 2, "lanes")
    r = lanes.shape[1]
    check_cuda(lengths, torch.int32, 1, "lengths", (r,))
    if ovf is not None:
        check_cuda(ovf, torch.bool, 1, "ovf", (r,))
    out = torch.empty(r, dtype=torch.bool, device=lanes.device)
    maybe = None if ovf is None else torch.empty_like(out)
    buf = ctypes.create_string_buffer(pattern, len(pattern))
    check(kernel(name)(
        lanes.data_ptr(), lengths.data_ptr(), r, buf, len(pattern), mode,
        int(starts_tok), int(ends_tok), int(fold), *gargs,
        None if ovf is None else ovf.data_ptr(), out.data_ptr(),
        None if maybe is None else maybe.data_ptr(), stream_ptr(lanes)),
        name)
    return out, maybe


def match_scan_gated(lanes: torch.Tensor, lengths: torch.Tensor,
                     pattern: bytes, mode: int, starts_tok: bool,
                     ends_tok: bool, fold: bool, gate: BloomGate,
                     ovf: torch.Tensor | None = None):
    """(definite, maybe) bool[R]: with keep(row) the gate's bloom keep of
    the row's block, definite = hit & ~ovf & keep and maybe = ovf & keep;
    maybe is None without `ovf` (bool[R], the rows whose staged value was
    truncated).  Arguments as `match_scan`; any probe count P."""
    if not 0 < len(pattern) <= 128:
        raise ValueError(f"pattern length {len(pattern)} not in 1..128")
    if lanes.device.type == "cpu":
        return match_scan_gated_plain(lanes, lengths, pattern, mode,
                                      starts_tok, ends_tok, fold, gate, ovf)
    got = _launch_scan_gated("scan_gated", _gate_args(gate), lanes, lengths,
                             pattern, mode, starts_tok, ends_tok, fold, ovf)
    match_scan_gated.launches += 1
    return got


match_scan_gated.launches = 0


def match_scan_gated_sb(lanes: torch.Tensor, lengths: torch.Tensor,
                        pattern: bytes, mode: int, starts_tok: bool,
                        ends_tok: bool, fold: bool, gate: SbGate,
                        ovf: torch.Tensor | None = None):
    """`match_scan_gated` behind a split-block gate: keep(row) is the
    SbGate's probe of the row's block (csrc/scan.cu
    `vl_match_scan_gated_sb`, the same kernels with the split-block
    probe)."""
    if not 0 < len(pattern) <= 128:
        raise ValueError(f"pattern length {len(pattern)} not in 1..128")
    if lanes.device.type == "cpu":
        return match_scan_gated_plain(lanes, lengths, pattern, mode,
                                      starts_tok, ends_tok, fold, gate, ovf)
    got = _launch_scan_gated("scan_gated_sb", _sb_gate_args(gate), lanes,
                             lengths, pattern, mode, starts_tok, ends_tok,
                             fold, ovf)
    match_scan_gated_sb.launches += 1
    return got


match_scan_gated_sb.launches = 0


def match_pair_plain(lanes: torch.Tensor, lengths: torch.Tensor,
                     pat_a: bytes, pat_b: bytes,
                     ovf: torch.Tensor | None = None):
    """Plain PyTorch `A.*B`: the windows of A and of B inside each row's
    length, A's first against B's last, and a newline test over the
    row's bytes; see `match_pair`."""
    nl, r = lanes.shape
    w = 4 * nl
    dev = lanes.device
    lens = lengths.to(torch.int64).clamp(max=w)
    none = torch.zeros(r, dtype=torch.bool, device=dev)
    if max(len(pat_a), len(pat_b)) > w:
        d, m = none, none.clone()
    else:
        def hits(pat: bytes) -> torch.Tensor:
            acc = match_windows_plain(lanes, pat, MODE_SUBSTRING, False,
                                      False)
            s = torch.arange(acc.shape[1], device=dev)
            return acc & (s[None, :] <= (lens - len(pat))[:, None])

        ha, hb = hits(pat_a), hits(pat_b)
        first_a = ha.to(torch.uint8).argmax(dim=1)
        last_b = hb.shape[1] - 1 - hb.flip(1).to(torch.uint8).argmax(dim=1)
        ordered = ha.any(dim=1) & hb.any(dim=1) & \
            (first_a + len(pat_a) <= last_b)
        cols = torch.arange(w, device=dev)
        newline = ((lanes_to_bytes(lanes) == 0x0A) &
                   (cols[None, :] < lens[:, None])).any(dim=1)
        d, m = ordered & ~newline, ordered & newline
    if ovf is None:
        return d, m
    return d & ~ovf, m | ovf


def _check_pair_patterns(pat_a: bytes, pat_b: bytes) -> None:
    for p in (pat_a, pat_b):
        if not 0 < len(p) <= MAX_PATTERN_LEN or 0xFF in p:
            raise ValueError(f"pattern {p!r}: want 1..{MAX_PATTERN_LEN} "
                             f"bytes without 0xFF")


def _pair_args(lanes, lengths, pat_a, pat_b, ovf):
    """The checked leading arguments of both pair entry points and the
    two outputs."""
    check_cuda(lanes, torch.int32, 2, "lanes")
    nl, r = lanes.shape
    check_cuda(lengths, torch.int32, 1, "lengths", (r,))
    if ovf is not None:
        check_cuda(ovf, torch.bool, 1, "ovf", (r,))
    definite = torch.empty(r, dtype=torch.bool, device=lanes.device)
    maybe = torch.empty_like(definite)
    args = (lanes.data_ptr(), lengths.data_ptr(), r, nl,
            ctypes.create_string_buffer(pat_a, len(pat_a)), len(pat_a),
            ctypes.create_string_buffer(pat_b, len(pat_b)), len(pat_b))
    return args, definite, maybe


def match_pair(lanes: torch.Tensor, lengths: torch.Tensor, pat_a: bytes,
               pat_b: bytes, ovf: torch.Tensor | None = None):
    """(definite, maybe) bool[R] of the regexp `A.*B` over a lane-major
    staged column: ordered = A and B occur inside the row's length and
    A's first occurrence ends at or before the start of B's last;
    definite = ordered without a newline (0x0A) in the row, maybe =
    ordered with one.  With `ovf` (bool[R], the rows whose staged value
    was truncated) those rows are maybe rows and never definite.  lanes
    int32[W/4, R] with the layout's 0xFF padding past each row's length
    (the kernel reads the whole last word of a row), lengths int32[R], A
    and B 1..MAX_PATTERN_LEN bytes without 0xFF (never a byte of UTF-8
    text)."""
    _check_pair_patterns(pat_a, pat_b)
    if lanes.device.type == "cpu":
        return match_pair_plain(lanes, lengths, pat_a, pat_b, ovf)
    args, definite, maybe = _pair_args(lanes, lengths, pat_a, pat_b, ovf)
    check(kernel("pair")(*args, None if ovf is None else ovf.data_ptr(),
                         definite.data_ptr(), maybe.data_ptr(),
                         stream_ptr(lanes)), "pair")
    match_pair.launches += 1
    return definite, maybe


match_pair.launches = 0


def match_pair_gated_plain(lanes: torch.Tensor, lengths: torch.Tensor,
                           pat_a: bytes, pat_b: bytes, gate,
                           ovf: torch.Tensor | None = None):
    """Plain PyTorch: the probe's keep-mask expanded to rows through the
    block starts, ANDed with both outputs of the plain pair; see
    `match_pair_gated`.  `gate` is a BloomGate or an SbGate."""
    rows = keep_rows_plain(gate, lanes.shape[1])
    d, m = match_pair_plain(lanes, lengths, pat_a, pat_b, ovf)
    return d & rows, m & rows


def match_pair_gated(lanes: torch.Tensor, lengths: torch.Tensor,
                     pat_a: bytes, pat_b: bytes, gate: BloomGate,
                     ovf: torch.Tensor | None = None):
    """`match_pair` gated by a bloom leaf in the same launch (csrc/scan.cu
    `vl_match_pair_gated`): both outputs ANDed with keep(row), the gate's
    bloom keep of the row's block (as `match_scan_gated`); rows of blocks
    the bloom rules out are not read."""
    _check_pair_patterns(pat_a, pat_b)
    if lanes.device.type == "cpu":
        return match_pair_gated_plain(lanes, lengths, pat_a, pat_b, gate,
                                      ovf)
    args, definite, maybe = _pair_args(lanes, lengths, pat_a, pat_b, ovf)
    check(kernel("pair_gated")(
        *args, *_gate_args(gate), None if ovf is None else ovf.data_ptr(),
        definite.data_ptr(), maybe.data_ptr(), stream_ptr(lanes)),
        "pair_gated")
    match_pair_gated.launches += 1
    return definite, maybe


match_pair_gated.launches = 0


def match_pair_gated_sb(lanes: torch.Tensor, lengths: torch.Tensor,
                        pat_a: bytes, pat_b: bytes, gate: SbGate,
                        ovf: torch.Tensor | None = None):
    """`match_pair_gated` behind a split-block gate (csrc/scan.cu
    `vl_match_pair_gated_sb`)."""
    _check_pair_patterns(pat_a, pat_b)
    if lanes.device.type == "cpu":
        return match_pair_gated_plain(lanes, lengths, pat_a, pat_b, gate,
                                      ovf)
    args, definite, maybe = _pair_args(lanes, lengths, pat_a, pat_b, ovf)
    check(kernel("pair_gated_sb")(
        *args, *_sb_gate_args(gate), None if ovf is None else ovf.data_ptr(),
        definite.data_ptr(), maybe.data_ptr(), stream_ptr(lanes)),
        "pair_gated_sb")
    match_pair_gated_sb.launches += 1
    return definite, maybe


match_pair_gated_sb.launches = 0


def combine_ids(ids_tuple, strides) -> torch.Tensor:
    """Row-major combined bucket index from per-axis int id arrays."""
    c = None
    for a, s in zip(ids_tuple, strides):
        t = a.to(torch.int32)
        if s != 1:
            t = t * s
        c = t if c is None else c + t
    return c


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/8)], numpy bit order."""
    n = bits.shape[0]
    pad = (-n) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (bits.view(-1, 8).to(torch.int32) * w).sum(dim=1) \
        .to(torch.uint8)


def unpackbits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[m] -> bool[n], numpy bit order."""
    sh = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    return ((packed.to(torch.int32)[:, None] >> sh) & 1).reshape(-1)[:n] \
        .to(torch.bool)
