"""Per-part query result cache: a repeated query recomputes only the
parts that are new since its last run.

Dashboard and alert traffic is mostly the SAME query re-run over a
sliding window.  Parts never change once listed, and each has a uid
that no other part gets (a merge makes a new part with a new uid), so
one part's share of a query's answer is a function of (query
fingerprint, part uid) alone: an entry can never go stale.  The entries
of a part go when the part is garbage collected (a `weakref.finalize`
returns their bytes to the budget).

What is cached, per (fingerprint, part uid):

- ``stats`` entries: the per-cell partial tuples of a part's stats
  launch as the dispatch window harvested them, before
  build_partial_states.  A replay absorbs them through the same path in
  the same part order, so the answer is bit-identical to the uncached
  one, float sums included;
- ``bms`` entries: per-block filter bitmaps (np.packbits), for row
  queries and the `sort ... limit` prefilter.  A top-k entry holds a
  superset of the part's rows at or above its k-th best key for THAT k
  only, so its key carries (field, desc, k).

Rules, held at both the store and the probe:

- the query's top-level AND-path time range must cover the whole part
  (the time filter, stripped from the fingerprint, then keeps every
  row of it), so every refresh of a sliding window finds the same keys;
- the candidate block list must match exactly (tenants and stream
  filters are in the fingerprint; the block list is checked as well);
- a query with an in(<subquery>) filter is never cached: the values it
  matches depend on what is stored, not on the query text;
- nor is one with a `_time` filter read from `now` under or/NOT
  (`err !_time:5m`): its text stays while its rows move with `now`.
  The JAX package caches such a query and replays stale rows; every
  query both packages cache has the same fingerprints.

Budget: VL_RESULT_CACHE_MAX_BYTES.  Each part keeps a list of its
entries' charges; past the budget the least recently used entries are
evicted; `cache_check_balanced()` proves the byte total equals the sum
of the live charges.  VL_RESULT_CACHE=0 turns the cache off.  The JAX
package's counterpart is victorialogs_tpu/engine/standing/resultcache.py;
its eviction events, /metrics samples and EXPLAIN's `peek` are not here
(the port has no events journal, /metrics or EXPLAIN).
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ... import config
from ...logsql.filters import FilterAnd, FilterNot, FilterOr, FilterTime
from ...logsql.parser import MAX_TS, MIN_TS


def cache_enabled() -> bool:
    return config.env_flag("VL_RESULT_CACHE")


def _cache_max_bytes() -> int:
    return config.env_int("VL_RESULT_CACHE_MAX_BYTES")


# ---------------- the byte-budgeted store ----------------

_cache_mu = threading.Lock()
_cache_bytes = 0
# (fingerprint, part uid) -> _Entry, least recently used first
_entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
# part uid -> its live keys, so that a part's finalizer drops its
# entries without a scan
_part_index: dict[int, set] = {}
# every live part whose ._rc_charged list a finalizer will release
_cache_owners: "weakref.WeakSet" = weakref.WeakSet()
_counts = {"hits": 0, "misses": 0, "evictions": 0, "stores": 0}


@dataclass
class _Entry:
    kind: str                     # "stats" | "bms"
    bis: tuple                    # the candidate block idxs it covers
    value: object                 # stats: list of partial tuples;
    #                               bms: {bi: (nrows, packed uint8)}
    nbytes: int
    charges: list                 # the owning part's live charge list


def _sizeof(v) -> int:
    """Recursive byte estimate for the budget (exact for the ndarrays
    that dominate; fixed overheads elsewhere)."""
    if isinstance(v, np.ndarray):
        return int(v.nbytes) + 64
    if isinstance(v, (bytes, bytearray, str)):
        return len(v) + 48
    if isinstance(v, (list, tuple, set, frozenset)):
        return 56 + sum(_sizeof(x) for x in v)
    if isinstance(v, dict):
        return 64 + sum(_sizeof(k) + _sizeof(x) for k, x in v.items())
    return 32


def _rc_try_charge(part, n: int) -> bool:
    """Reserve n bytes of the budget for one of `part`'s entries,
    evicting the least recently used entries if needed; False when n
    exceeds the whole budget."""
    global _cache_bytes
    with _cache_mu:
        maxb = _cache_max_bytes()
        if n > maxb:
            return False
        while _cache_bytes + n > maxb and _entries:
            key, e = _entries.popitem(last=False)
            _part_index.get(key[1], set()).discard(key)
            e.charges.remove(e.nbytes)
            _cache_bytes -= e.nbytes
            _counts["evictions"] += 1
        if _cache_bytes + n > maxb:
            return False
        charges = getattr(part, "_rc_charged", None)
        if charges is None:
            charges = part._rc_charged = []
            weakref.finalize(part, _rc_release, part.uid, charges)
            _cache_owners.add(part)
        charges.append(n)
        _cache_bytes += n
        return True


def _rc_release(uid, charges: list) -> None:
    """The finalizer of a part: its entries' bytes go back to the budget
    and its keys go (entries evicted before took their share already)."""
    global _cache_bytes
    with _cache_mu:
        for key in _part_index.pop(uid, ()):
            _entries.pop(key, None)
        _cache_bytes -= sum(charges)
        charges.clear()


def cache_check_balanced() -> tuple[bool, str]:
    """The byte total equals the sum of every live part's charges and
    the sum of the live entries' sizes, and is never negative.  Callers
    retry after gc.collect(): a part's finalizer may not have run yet."""
    with _cache_mu:
        used = _cache_bytes
        entry_bytes = sum(e.nbytes for e in _entries.values())
    live = sum(sum(o._rc_charged) for o in list(_cache_owners))
    ok = used == live == entry_bytes and used >= 0
    return ok, (f"cache_bytes={used} sum(live charges)={live} "
                f"sum(entry nbytes)={entry_bytes}")


def cache_stats() -> dict:
    with _cache_mu:
        return {"used_bytes": _cache_bytes,
                "max_bytes": _cache_max_bytes(),
                "entries": len(_entries), **_counts}


def reset_for_tests() -> None:
    """Drop every entry and zero the counters; the charges are released
    through the usual accounting, so the store stays balanced."""
    global _cache_bytes
    with _cache_mu:
        for _key, e in _entries.items():
            e.charges.remove(e.nbytes)
            _cache_bytes -= e.nbytes
        _entries.clear()
        _part_index.clear()
        for k in _counts:
            _counts[k] = 0


# ---------------- fingerprints ----------------

def tenant_str(tenant) -> str:
    """Canonical 'account:project' spelling of a tenant (a TenantID, a
    list of them, a string, None)."""
    if tenant is None:
        return "0:0"
    if isinstance(tenant, str):
        return tenant
    if isinstance(tenant, (list, tuple)):
        return tenant_str(tenant[0]) if tenant else "0:0"
    acc = getattr(tenant, "account_id", None)
    if acc is not None:
        return f"{acc}:{getattr(tenant, 'project_id', 0)}"
    return str(tenant)


def _has_subquery(f) -> bool:
    from ..searcher import _iter_subquery_filters
    return any(True for _ in _iter_subquery_filters(f))


def _moving_time_filter(f, on_and_path: bool = True) -> bool:
    """A `_time` filter read from `now` (`_time:5m`) under or/NOT.  Its
    text stays the same on every refresh while the rows it keeps move,
    and the coverage rule cannot make it a no-op, so no key names its
    rows.  On the AND path (nested ANDs too) the query's time range
    holds it, and a covered part keeps every row."""
    if isinstance(f, FilterTime):
        return f.relative and not on_and_path
    if isinstance(f, FilterAnd):
        return any(_moving_time_filter(s, on_and_path) for s in f.filters)
    if isinstance(f, FilterOr):
        return any(_moving_time_filter(s, False) for s in f.filters)
    if isinstance(f, FilterNot):
        return _moving_time_filter(f.inner, False)
    return False


def _time_free_filter_str(f) -> str:
    """The filter's to_string without its top-level AND-path FilterTime
    nodes: the sliding window of a dashboard query, which the coverage
    rule makes a no-op on every part an entry is kept for.  A time
    filter inside or/NOT stays: it narrows rows, so it keys the entry."""
    if isinstance(f, FilterTime):
        return "*"
    if isinstance(f, FilterAnd):
        subs = [s for s in f.filters if not isinstance(s, FilterTime)]
        if not subs:
            return "*"
        if len(subs) == 1:
            return subs[0].to_string()
        return FilterAnd(subs).to_string()
    return f.to_string()


class QueryCache:
    """One query's view of the store: its fingerprints, its time range
    and the parts it replayed.  `for_query` gives None where the cache
    cannot apply (turned off, a subquery filter, a moving `_time`
    filter under or/NOT): the walks then skip
    every hook."""

    def __init__(self, fp_probe: tuple, fp_store: str, kind: str,
                 min_ts: int, max_ts: int):
        self._fp_probe = fp_probe     # fingerprints to try, in order
        self._fp_store = fp_store     # the fingerprint new entries key on
        self.kind = kind              # "stats" | "bms"
        self._min_ts = min_ts
        self._max_ts = max_ts
        self.hit_uids: set = set()

    @staticmethod
    def for_query(q, tenants, stats_spec, sort_spec, min_ts, max_ts
                  ) -> "QueryCache | None":
        if not cache_enabled():
            return None
        if _has_subquery(q.filter) or _moving_time_filter(q.filter):
            return None
        tstr = ",".join(sorted(tenant_str(t) for t in tenants))
        base = hashlib.sha1(
            (_time_free_filter_str(q.filter) + "\x00" + tstr)
            .encode()).hexdigest()
        rows_fp = base + ":rows"
        if stats_spec is not None:
            # the stats pipe keys the partials; no fallback to rows
            # bitmaps: replayed partials keep the float summation order,
            # a rescan of bitmaps would not
            fp = base + ":stats:" + q.pipes[0].to_string()
            return QueryCache((fp,), fp, "stats", min_ts, max_ts)
        if sort_spec is not None:
            # a top-k prefilter keeps every row at or above the part's
            # k-th best key, so whole rows bitmaps serve it too; its own
            # entries stay under the top-k key (they are no rows answer)
            fp = (base + f":topk:{sort_spec.field}:"
                  f"{int(sort_spec.desc)}:{sort_spec.k}")
            return QueryCache((fp, rows_fp), fp, "bms", min_ts, max_ts)
        return QueryCache((rows_fp,), rows_fp, "bms", min_ts, max_ts)

    # -- validity --

    def _covers(self, part) -> bool:
        """The query's time range covers the whole part (the stripped
        top-level time filter keeps every row of it)."""
        return ((self._min_ts == MIN_TS or part.min_ts >= self._min_ts)
                and (self._max_ts == MAX_TS
                     or part.max_ts <= self._max_ts))

    # -- probe --

    def probe(self, part, bis):
        """The entry covering (part, bis), or None; counts the store's
        hits and misses."""
        e = None
        bist = tuple(bis)
        with _cache_mu:
            if self._covers(part):
                for fp in self._fp_probe:
                    got = _entries.get((fp, part.uid))
                    if got is not None and got.bis == bist:
                        _entries.move_to_end((fp, part.uid))
                        e = got
                        break
            _counts["hits" if e is not None else "misses"] += 1
        if e is not None:
            self.hit_uids.add(part.uid)
        return e

    # -- a hit's values --

    @staticmethod
    def entry_partials(e) -> list:
        return list(e.value)

    @staticmethod
    def entry_bms(e) -> dict:
        out = {}
        for bi, (nrows, packed) in e.value.items():
            out[bi] = np.unpackbits(packed, count=nrows).view(bool)
        return out

    # -- store --

    def _store(self, part, bis, kind: str, value) -> None:
        global _cache_bytes
        if part.uid in self.hit_uids or not self._covers(part):
            return
        if not isinstance(part.uid, int):
            return                    # never a PackedPart
        key = (self._fp_store, part.uid)
        nbytes = _sizeof(value)
        if not _rc_try_charge(part, nbytes):
            return
        with _cache_mu:
            old = _entries.pop(key, None)
            if old is not None:
                # stored already under this key: keep the new entry and
                # return the old one's bytes
                old.charges.remove(old.nbytes)
                _cache_bytes -= old.nbytes
            _entries[key] = _Entry(kind, tuple(bis), value, nbytes,
                                   part._rc_charged)
            _part_index.setdefault(part.uid, set()).add(key)
            _counts["stores"] += 1

    def store_member(self, m) -> None:
        """The dispatch window's store (gpu/pipeline.py emit): a
        harvested member's result, where its shape is the query's
        kind."""
        bis = [bi for bi, _bs in m.blocks]
        if self.kind == "stats":
            # only a member whose every block was reduced replays
            # exactly; a member with bitmaps among its results is not kept
            if m.handled == set(bis):
                self._store(m.part, bis, "stats", list(m.partials))
        elif not m.partials and not m.handled and \
                all(bi in m.bms for bi in bis):
            packed = {bi: (int(m.bms[bi].shape[0]),
                           np.packbits(m.bms[bi]))
                      for bi in bis}
            self._store(m.part, bis, "bms", packed)

    def store_bms(self, part, bis, bms: dict) -> None:
        """The host walk's store (engine/searcher.py)."""
        if self.kind != "bms" or any(bi not in bms for bi in bis):
            return
        packed = {bi: (int(bms[bi].shape[0]), np.packbits(bms[bi]))
                  for bi in bis}
        self._store(part, bis, "bms", packed)
