"""The per-part result cache (resultcache.py): a repeated query replays
the cached stats partials or filter bitmaps of the parts it has seen,
and recomputes only the parts that are new."""

from .resultcache import (QueryCache, cache_check_balanced, cache_stats,
                          reset_for_tests)

__all__ = ["QueryCache", "cache_check_balanced", "cache_stats",
           "reset_for_tests"]
