"""The sealed part's filter index (v2), the JAX package's
victorialogs_tpu/storage/filterindex.

A part never changes after its seal, so `write_part` builds three
artifacts a bloom column once and writes them beside `blooms.bin` as
one checked file, `filterindex.bin` (sidecar.py):

- split-block bloom filters (sbbloom.py): a token's 6 probe bits in one
  256-bit block, so the card's gate reads 8 contiguous lanes a (block,
  token) (gpu/bloom_device.py `SbGate`);
- an xor filter over the column's distinct tokens (xorfilter.py): a
  part whose column lacks a required token is skipped whole;
- a token -> block maplet (maplet.py): the exact candidate blocks of an
  AND-path leaf in one lookup.

index.py loads the file (any failed check: none, and the classic path
serves) and answers the queries (storage/filterbank.py).
VL_FILTER_INDEX=v1 neither writes nor reads it.
"""

from __future__ import annotations

from .index import (PartFilterIndex, enabled, mode,  # noqa: F401
                    part_index, sb_plane_for_staging)
from .sidecar import (FILTERINDEX_FILENAME, SidecarBuilder,  # noqa: F401
                      SidecarInvalid, build_sidecar, load_sidecar,
                      write_sidecar)
