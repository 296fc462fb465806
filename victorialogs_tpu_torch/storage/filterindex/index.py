"""A sealed part's loaded filter index and its query entry points.

`part_index(part)` reads the part's `filterindex.bin` the first time a
query asks and keeps the outcome on the part (parts are immutable), as
storage/filterbank.py keeps its bloom planes.  A part without a
directory (an in-memory part, a pack) has none; a missing file or one
that fails any check of `load_sidecar` gives None too, and the part is
served by `blooms.bin` and the classic planes: a bad file costs speed,
never an answer.  VL_FILTER_INDEX=v1 neither writes nor reads the file.

The JAX package's victorialogs_tpu/storage/filterindex/index.py, without
its byte budget, its lock and its journal events: the port starts no
threads and has no journal.
"""

from __future__ import annotations

import numpy as np

from ... import config
from .sbbloom import SB_LANES, sb_block_select, sb_token_masks
from .sidecar import ColumnArtifacts, SidecarInvalid, load_sidecar


def mode() -> str:
    """`v2` (the default) or `v1` (the classic path alone)."""
    return "v1" if config.env("VL_FILTER_INDEX") == "v1" else "v2"


def enabled() -> bool:
    return mode() != "v1"


class PartFilterIndex:
    """One sealed part's artifacts, every indexed column."""

    def __init__(self, cols: dict[str, ColumnArtifacts], nblocks: int,
                 nbytes: int):
        self.cols = cols
        self.nblocks = nblocks
        self.nbytes = nbytes
        self._planes: dict = {}

    # ---- the maplet: exact block keep-masks ----

    def has(self, field: str) -> bool:
        return field in self.cols

    def keep_mask(self, field: str, hashes: np.ndarray,
                  bis=None) -> np.ndarray:
        """Exact keep-mask over `bis` (or every block), the contract of
        filterbank.bloom_keep_mask; a column without artifacts has no
        token hashes in the part: every block keeps."""
        c = self.cols.get(field)
        if c is None:
            return np.ones(self.nblocks if bis is None else len(bis),
                           dtype=bool)
        return c.maplet.keep_mask(hashes, bis)

    # ---- the xor aggregate: whole-part kills ----

    def covers(self, field: str) -> bool:
        """Every block of the part has the column's token hashes (a
        part kill's precondition)."""
        c = self.cols.get(field)
        return c is not None and c.xor is not None

    def xor_kill(self, field: str, hashes: np.ndarray) -> bool:
        """True when some token is in no block of the part."""
        c = self.cols.get(field)
        if c is None or c.xor is None or len(hashes) == 0:
            return False
        return not bool(c.xor.contains(hashes).all())

    # ---- the split-block plane: the card's gate layout ----

    def has_sb(self, field: str) -> bool:
        c = self.cols.get(field)
        return c is not None and bool(c.nsb.any())

    def sb_plane(self, field: str):
        """(plane uint32[B, 8 * Mmax], nsb int32[B]) for the device
        gather, or None without split-block filters; built once."""
        if field not in self._planes:
            self._planes[field] = self._build_plane(field)
        return self._planes[field]

    def _build_plane(self, field: str):
        c = self.cols.get(field)
        if c is None or not c.nsb.any():
            return None
        mmax = int(c.nsb.max())
        plane = np.zeros((self.nblocks, SB_LANES * mmax), dtype=np.uint32)
        off = c.lane_offsets()
        for bi in np.nonzero(c.nsb)[0]:
            n = int(c.nsb[bi]) * SB_LANES
            plane[bi, :n] = c.lanes[off[bi]:off[bi] + n]
        return plane, np.ascontiguousarray(c.nsb, dtype=np.int32)

    def sb_probe_idx(self, field: str, hashes: np.ndarray) -> np.ndarray:
        """int32[B, T]: the first lane of each token's selected 256-bit
        block in each block's filter (0 where the block has none, which
        the probe keeps by its nsb == 0 term); the selection sb_build
        inserted with."""
        c = self.cols[field]
        sel = sb_block_select(hashes, c.nsb.astype(np.uint64)[:, None])
        return (sel * SB_LANES).astype(np.int32)

    @staticmethod
    def sb_masks(hashes: np.ndarray) -> np.ndarray:
        return sb_token_masks(hashes)


_UNSET = object()


def part_index(part) -> PartFilterIndex | None:
    """The part's filter index, or None (VL_FILTER_INDEX=v1, no
    directory, no file or an invalid one); read once a part."""
    if not enabled():
        return None
    got = getattr(part, "_filter_index", _UNSET)
    if got is _UNSET:
        got = part._filter_index = _load(part) or False
    return got or None


def _load(part) -> PartFilterIndex | None:
    path = getattr(part, "path", None)
    if path is None:
        return None
    try:
        cols, nbytes = load_sidecar(path, part.num_blocks)
    except (FileNotFoundError, SidecarInvalid, OSError):
        return None
    return PartFilterIndex(cols, part.num_blocks, nbytes)


def sb_plane_for_staging(part, field: str):
    """(plane, nsb) for gpu/bloom_device.stage_sb_plane, or None."""
    fi = part_index(part)
    return None if fi is None else fi.sb_plane(field)
