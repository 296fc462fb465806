"""The port's environment knobs: the dispatch window and small-part
packing (gpu/pipeline.py), the per-part result cache and the sealed
part's filter index, with the JAX
package's names, defaults and parsing.

- VL_INFLIGHT (4): dispatch units kept outstanding; 1 is the serial
  submit-then-harvest walk.
- VL_PACK_PARTS (8): small parts folded into one packed unit; 1 turns
  packing off.
- VL_PACK_TOPK_K (1024): the largest `sort ... limit` k a packed unit
  takes; 0 keeps sorts unpacked.
- VL_CROSS_PARTITION (1): 0 drains the window at every day boundary.
- VL_PACK_MAX_ROWS (unset): parts above this many rows never pack;
  unset, gpu/pipeline.py's floor of 16,384 rows holds.
- VL_RESULT_CACHE (1): the per-part result cache
  (engine/standing/resultcache.py); 0 recomputes every part.
- VL_RESULT_CACHE_MAX_BYTES (64 MiB): its byte budget; past it the
  least recently used entries are evicted.
- VL_FILTER_INDEX (v2): `v1` neither writes nor reads a sealed part's
  filter index (storage/filterindex); any other value is v2.
"""

from __future__ import annotations

import os

DEFAULTS = {
    "VL_INFLIGHT": "4",
    "VL_PACK_PARTS": "8",
    "VL_PACK_TOPK_K": "1024",
    "VL_CROSS_PARTITION": "1",
    "VL_PACK_MAX_ROWS": None,
    "VL_RESULT_CACHE": "1",
    "VL_RESULT_CACHE_MAX_BYTES": str(64 << 20),
    "VL_FILTER_INDEX": "v2",
}


def env(name: str) -> str | None:
    """The raw value, the default when unset."""
    v = os.environ.get(name)
    return DEFAULTS[name] if v is None else v


def env_int(name: str) -> int | None:
    """An int; unset, empty or unparseable gives the default."""
    v = os.environ.get(name)
    if v:
        try:
            return int(v)
        except ValueError:
            pass
    d = DEFAULTS[name]
    return None if d is None else int(d)


def env_flag(name: str) -> bool:
    """A kill switch: on unless the value is exactly "0"."""
    return os.environ.get(name, DEFAULTS[name] or "") != "0"
