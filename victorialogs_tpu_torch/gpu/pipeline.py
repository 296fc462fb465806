"""The part walk of the device path: an in-flight dispatch window
across day partitions, and small-part packing.

The searcher (engine/searcher.py) feeds every selected partition's
parts, with their candidate blocks, through one stream
(`scan_device_stream`); this module folds the stream into dispatch
units and keeps several of them on the card at once:

1. **The window.**  Submitting a unit plans its filter, launches its
   kernels and starts a non-blocking copy of its packed bitmaps or
   stats partials into pinned host memory, with a CUDA event recorded
   after it (gpu/batch.py `run_part*_submit`); nothing waits.  Up to
   VL_INFLIGHT (4) units stay outstanding, and they are harvested
   strictly in submission order, so the blocks written downstream and
   the stats absorbed come in the serial walk's order.  Harvest waits
   on the unit's event, unpacks, settles maybe rows on the host and
   writes the blocks.  VL_INFLIGHT=1 is the serial walk.

2. **Small-part packing.**  A partition is full of small fresh parts:
   the unflushed batches and the parts waiting for a merge.
   Consecutive small parts sharing a padded-row bucket (`pack_bucket`)
   fold into ONE part-like value (`PackedPart`: the members' blocks
   concatenated in member order) that runs as one unit: the scans, the
   count and the value reduction launch once for the pack.  Row
   bitmaps split back per member; stats carry a leading member axis
   (stats_device.with_segment_axis) and split back to each member's
   partials, absorbed in member order; a `sort ... limit` selects each
   member's own k-th best key (fused.topk_rows_packed).  P small parts
   cost ceil(P / VL_PACK_PARTS) units.  A pack the planner or the
   stats staging cannot express runs member by member, each member its
   own unit's work on the card.

3. **Result-cache units.**  With the per-part result cache on
   (engine/standing/resultcache.py), each (part, candidate blocks) is
   probed before grouping, after the searcher's part and maplet
   pruning (engine/searcher.py `_prune`) left the part its blocks.  A
   hit becomes a unit of its own (its
   `_CacheHit` lies above every pack's row cap, so it never joins a
   pack) that holds the cached partials or bitmaps: it is never staged
   nor submitted, launches nothing, and rides the window in submission
   order, so the blocks written and the partials absorbed come in the
   order of the uncached walk and the answer is bit-identical.  `emit`
   stores every harvested member the query did not replay.

A satisfied limit stops the window: no unit is submitted after it, the
handles still in flight are dropped unwritten (each waits for its copy,
so its pinned buffers outlive it), and every staged tensor stays in the
runner's byte-accounted cache.  The JAX package's counterpart is
victorialogs_tpu/tpu/pipeline.py; its adaptive depth and pack cap (the
cost model), the shared device-slot scheduler and deadlines are not
here.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass

from .. import config
from ..engine.block_result import BlockResult
from ..engine.block_search import BlockSearch
from ..obs import tracing
from .batch import Ready
from .stats_device import with_segment_axis

# parts at or below this many rows pack when VL_PACK_MAX_ROWS is unset
# (the JAX package's floor before any round trip is measured)
PACK_ROWS_FLOOR = 16384
INFLIGHT_DEFAULT = 4


def inflight_depth() -> int:
    """VL_INFLIGHT: units with outstanding dispatches (>= 1); `auto`
    and unparseable values give the default."""
    try:
        return max(1, int(config.env("VL_INFLIGHT")))
    except ValueError:
        return INFLIGHT_DEFAULT


def pack_limit() -> int:
    """VL_PACK_PARTS: parts a packed unit takes at most (<= 1: none)."""
    return max(1, config.env_int("VL_PACK_PARTS"))


def pack_topk_k() -> int:
    """VL_PACK_TOPK_K: the largest `sort ... limit` k a packed unit
    takes (0: sorts never pack); the per-member slot rows hold >= k."""
    return max(0, config.env_int("VL_PACK_TOPK_K"))


def cross_partition_enabled() -> bool:
    """VL_CROSS_PARTITION=0 drains the window at every day boundary."""
    return config.env_flag("VL_CROSS_PARTITION")


def pack_rows_cap() -> int:
    """Parts above this many rows never pack: VL_PACK_MAX_ROWS, else
    PACK_ROWS_FLOOR."""
    v = config.env_int("VL_PACK_MAX_ROWS")
    return PACK_ROWS_FLOOR if v is None else max(1, v)


def pack_policy(sort_spec):
    """(packable, pack_max, rows_cap): sorts pack while their k fits
    VL_PACK_TOPK_K; row and stats queries pack whenever packing is
    on."""
    pack_max = pack_limit()
    packable = pack_max > 1 and (
        sort_spec is None or 0 < sort_spec.k <= pack_topk_k())
    return packable, pack_max, pack_rows_cap() if packable else 0


def pad_bucket(n: int, minimum: int = 8192) -> int:
    """Coarse padded sizes: powers of two refined by quarter steps (the
    JAX package's tpu/kernels.py pad_bucket)."""
    b = minimum
    while b < n:
        b *= 2
    for frac in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8,
                 b // 2 + b // 2):
        if n <= frac:
            return frac
    return b


def pack_bucket(part) -> int:
    """The padded-row bucket packing groups on."""
    return pad_bucket(max(part.num_rows, 1), minimum=1024)


# the widest time range one pack may cover: the JAX staging carries a
# pack's ns offsets as int32 planes, exact below 2**47 ns (~39 h).  The
# port stages int64 timestamps, but keeps the rule so that a part list
# gives the same packs in both packages.
PACK_TS_SPAN_MAX = 1 << 47


def iter_pack_groups(items, packable: bool, pack_max: int, rows_cap: int):
    """Fold pruned part items (tuples whose first element is the part)
    into unit groups: consecutive small parts (<= rows_cap rows)
    sharing a padded-row bucket group up to pack_max while the group's
    time range stays under PACK_TS_SPAN_MAX; every other part is a
    group of its own.  Lazy: it pulls `items` only as groups are taken,
    so an early stop ends the walk where the serial loop would."""
    group: list = []
    gmin = gmax = 0
    for it in items:
        part = it[0]
        small = packable and part.num_rows <= rows_cap
        if not small:
            if group:
                yield group
                group = []
            yield [it]
            continue
        if group and (
                pack_bucket(group[0][0]) != pack_bucket(part)
                or max(gmax, part.max_ts) - min(gmin, part.min_ts)
                >= PACK_TS_SPAN_MAX):
            yield group
            group = []
        if group:
            gmin = min(gmin, part.min_ts)
            gmax = max(gmax, part.max_ts)
        else:
            gmin, gmax = part.min_ts, part.max_ts
        group.append(it)
        if len(group) >= pack_max:
            yield group
            group = []
    if group:
        yield group


# ---------------- packed parts ----------------

class PackedPart:
    """Several small parts presented as ONE part-like value.

    Blocks are the members' blocks concatenated in member order, so
    every staging and planning routine that walks range(num_blocks)
    works unchanged over the pack; `segment_of_block` maps a pack block
    to its member, the segment id of a packed stats reduction.  The uid
    is ("pack", member uids...), so the runner's staged tensors of a
    pack are found again by a later query over the same members.

    Members are held weakly: a flush that drops an in-memory member
    finalizes it, and the runner then drops the pack and its staged
    tensors (TorchBatchRunner.get_pack).  A query holds its members
    through its units while it runs."""

    def __init__(self, members: list):
        self._refs = [weakref.ref(p) for p in members]
        self.uid = ("pack",) + tuple(p.uid for p in members)
        self._offsets = []
        self._map = []                  # pack block -> (member, block)
        for mi, p in enumerate(members):
            self._offsets.append(len(self._map))
            self._map.extend((mi, bi) for bi in range(p.num_blocks))
        self.num_rows = sum(p.num_rows for p in members)
        self.min_ts = min(p.min_ts for p in members)
        self.max_ts = max(p.max_ts for p in members)

    @property
    def members(self) -> list:
        return [self._member(mi) for mi in range(len(self._refs))]

    def _member(self, mi: int):
        p = self._refs[mi]()
        if p is None:
            raise RuntimeError(f"pack {self.uid}: member {mi} was released")
        return p

    def _at(self, bi: int):
        mi, b = self._map[bi]
        return self._member(mi), b

    @property
    def num_blocks(self) -> int:
        return len(self._map)

    @property
    def num_segments(self) -> int:
        return len(self._refs)

    def block_offset(self, mi: int) -> int:
        """The pack block index of member mi's block 0."""
        return self._offsets[mi]

    def segment_of_block(self, bi: int) -> int:
        return self._map[bi][0]

    def block_rows(self, bi: int) -> int:
        p, b = self._at(bi)
        return p.block_rows(b)

    def block_stream_id(self, bi: int):
        p, b = self._at(bi)
        return p.block_stream_id(b)

    def block_tags(self, bi: int) -> str:
        p, b = self._at(bi)
        return p.block_tags(b)

    def block_consts(self, bi: int):
        p, b = self._at(bi)
        return p.block_consts(b)

    def block_col_names(self, bi: int) -> list:
        p, b = self._at(bi)
        return p.block_col_names(b)

    def block_column_meta(self, bi: int, name: str):
        p, b = self._at(bi)
        return p.block_column_meta(b, name)

    def block_column(self, bi: int, name: str):
        p, b = self._at(bi)
        return p.block_column(b, name)

    def block_column_bloom(self, bi: int, name: str):
        p, b = self._at(bi)
        return p.block_column_bloom(b, name)

    def block_timestamps(self, bi: int):
        p, b = self._at(bi)
        return p.block_timestamps(b)


# ---------------- units and their harvest ----------------

@dataclass
class _Member:
    """One member part's share of a harvested unit."""
    part: object                   # the member part (never a pack)
    blocks: list                   # [(block idx, BlockSearch)]
    bms: dict                      # block idx -> bool bitmap
    handled: set                   # block idxs reduced in partials
    partials: list
    cached: bool = False           # replayed from the result cache


@dataclass
class _Unit:
    part: object                   # Part or PackedPart
    bss: dict                      # unit block idx -> BlockSearch
    members: list                  # [(member part, [(block idx, bs)])]
    pack: bool = False


class _CacheHit:
    """A part whose result the result cache holds, as the unit stream's
    planning sees it: num_rows lies above every pack cap, so
    iter_pack_groups keeps it in a group of its own; a cached part
    never joins a pack."""

    __slots__ = ("part", "entry")
    num_rows = 1 << 62

    def __init__(self, part, entry):
        self.part = part
        self.entry = entry


class _CachedUnit:
    """A unit answered wholly from the result cache: never staged nor
    submitted, it rides the window as a finished member, so it is
    harvested in submission order."""

    pack = False
    cached = True

    def __init__(self, member: _Member):
        self.ready = [member]


class _Harvest:
    """A submitted unit: `harvest(sync)` waits for its result and
    splits it into _Members (`kind`: "rows", "stats", or "members" for
    a list of _Members made at submit)."""

    def __init__(self, unit: _Unit, pending, kind: str):
        self.unit = unit
        self.pending = pending
        self.kind = kind

    def dispatched(self) -> bool:
        return not isinstance(self.pending, Ready)

    def release(self) -> None:
        self.pending.release()

    def harvest(self, sync) -> list:
        got = self.pending.harvest(sync)
        unit = self.unit
        if self.kind == "members":
            return got
        if not unit.pack:
            p, blocks = unit.members[0]
            if self.kind == "rows":
                return [_Member(p, blocks, got, set(), [])]
            bms, handled, partials = got
            return [_Member(p, blocks, bms, handled, partials)]
        out = []
        if self.kind == "rows":
            for mi, (p, blocks) in enumerate(unit.members):
                off = unit.part.block_offset(mi)
                out.append(_Member(p, blocks,
                                   {bi: got[off + bi] for bi, _bs in blocks},
                                   set(), []))
            return out
        # packed stats: the leading ("s", member) key part is the member
        # (absorb skips it); the partials are grouped as they are, since
        # copying a pack's thousands of them costs as much again in
        # allocations and garbage collection
        per_seg: dict[int, list] = {}
        for p in got[2]:
            per_seg.setdefault(p[0][0][1], []).append(p)
        for mi, (p, blocks) in enumerate(unit.members):
            out.append(_Member(p, blocks, {}, {bi for bi, _bs in blocks},
                               per_seg.get(mi, [])))
        return out


def _probed(items, qcache):
    """The part stream with each part the result cache holds for its
    candidate blocks as a _CacheHit."""
    for part, bis, ctx in items:
        e = qcache.probe(part, bis)
        yield (part if e is None else _CacheHit(part, e)), bis, ctx


def _cached_unit(hit: _CacheHit, bis, ctx, qcache) -> _CachedUnit:
    e = hit.entry
    if e.kind == "stats":
        member = _Member(hit.part, [], {}, set(), qcache.entry_partials(e),
                         cached=True)
    else:
        member = _Member(hit.part,
                         [(bi, BlockSearch(hit.part, bi, ctx)) for bi in bis],
                         qcache.entry_bms(e), set(), [], cached=True)
    return _CachedUnit(member)


def _unit_stream(runner, items, sort_spec, qcache=None):
    """Fold the pruned part stream, (part, candidate block idxs, ctx)
    items in walk order, into dispatch units, lazily."""
    packable, pack_max, rows_cap = pack_policy(sort_spec)
    if qcache is not None:
        items = _probed(items, qcache)
    for group in iter_pack_groups(items, packable, pack_max, rows_cap):
        if len(group) == 1 and isinstance(group[0][0], _CacheHit):
            yield _cached_unit(*group[0], qcache)
            continue
        if len(group) == 1:
            p, bis, ctx = group[0]
            blocks = [(bi, BlockSearch(p, bi, ctx)) for bi in bis]
            yield _Unit(p, dict(blocks), [(p, blocks)])
            continue
        pack = runner.get_pack([g[0] for g in group])
        bss = {}
        members = []
        for mi, (p, bis, ctx) in enumerate(group):
            off = pack.block_offset(mi)
            blocks = [(bi, BlockSearch(p, bi, ctx)) for bi in bis]
            bss.update((off + bi, bs) for bi, bs in blocks)
            members.append((p, blocks))
        yield _Unit(pack, bss, members, pack=True)


def _per_member(runner, f, unit: _Unit, stats_spec, sort_spec) -> Ready:
    """A pack the planner or the stats staging declined: each member
    runs as its own part, results equal to the unpacked walk."""
    out = []
    for p, blocks in unit.members:
        bss = dict(blocks)
        if stats_spec is not None:
            bms, handled, partials = runner.run_part_stats(f, p, bss,
                                                           stats_spec)
            out.append(_Member(p, blocks, bms, handled, partials))
            continue
        bms = None
        if sort_spec is not None:
            bms = runner.run_part_topk(f, p, bss, sort_spec)
        if bms is None:
            bms = runner.run_part(f, p, bss)
        out.append(_Member(p, blocks, bms, set(), []))
    return Ready(out)


def _submit(runner, f, unit: _Unit, stats_spec, sort_spec,
            spec_seg) -> _Harvest:
    kind = "rows"
    if stats_spec is not None:
        kind = "stats"
        pending = runner.run_part_stats_submit(
            f, unit.part, unit.bss, spec_seg if unit.pack else stats_spec)
    elif sort_spec is not None:
        pending = runner.run_part_topk_submit(f, unit.part, unit.bss,
                                              sort_spec)
        if pending is None and not unit.pack:
            pending = runner.run_part_submit(f, unit.part, unit.bss)
    else:
        pending = runner.run_part_submit(f, unit.part, unit.bss)
    if pending is None:
        return _Harvest(unit, _per_member(runner, f, unit, stats_spec,
                                          sort_spec), "members")
    h = _Harvest(unit, pending, kind)
    if unit.pack and h.dispatched():
        runner.stats_counters["packed_units"] += 1
        runner.stats_counters["packed_parts"] += len(unit.members)
    return h


def _sync(event) -> None:
    """The window's one deliberate host wait: a unit's copies landing
    in pinned memory; the wait is added to the current span."""
    t0 = time.perf_counter()
    event.synchronize()
    tracing.current_span().add("host_sync_wait_s",
                               time.perf_counter() - t0)


def scan_device_stream(items, f, head, runner, needed, stats_spec,
                       sort_spec, absorb, qcache=None) -> None:
    """Drive a part stream, (part, candidate block idxs, ctx) items from
    one or more partitions pulled lazily, through the dispatch window:
    up to VL_INFLIGHT units outstanding, harvested in submission order,
    each member's stats partials absorbed by `absorb(partials)` and its
    blocks written to `head` as the serial walk writes them.  `qcache`
    (engine/standing/resultcache.QueryCache, or None) answers the parts
    it holds and stores the members harvested."""
    depth = inflight_depth()
    spec_seg = with_segment_axis(stats_spec) \
        if stats_spec is not None and pack_limit() > 1 else None
    counters = runner.stats_counters
    window: deque = deque()       # (seq, unit, _Harvest)
    lookahead: deque = deque()
    stream = _unit_stream(runner, items, sort_spec, qcache)
    exhausted = False
    staged: set = set()
    seq = 0

    def refill(psp) -> None:
        # plan only the window's lookahead ahead of submission, so a
        # satisfied limit stops the part walk where the serial one would
        nonlocal exhausted
        if exhausted or len(lookahead) >= depth + 1:
            return
        with psp.span("prune") as prsp:
            planned = 0
            while not exhausted and len(lookahead) < depth + 1:
                try:
                    lookahead.append(next(stream))
                    planned += 1
                except StopIteration:
                    exhausted = True
            prsp.set("units_planned", planned)

    def emit(members: list) -> bool:
        """Write the harvested members; False once the head is done."""
        sp = tracing.current_span()
        for m in members:
            if qcache is not None:
                # skips the parts this query replayed
                qcache.store_member(m)
            if stats_spec is not None and m.partials:
                sp.add("stats_partials", len(m.partials))
                absorb(m.partials)
            for bi, bs in m.blocks:
                if bi in m.handled:
                    continue
                if head.is_done():
                    return False
                bm = m.bms[bi]
                if not bm.any():
                    continue
                br = BlockResult.from_block_search(bs, bm, needed)
                sp.add("blocks_out")
                sp.add("rows_out" if m.cached else "rows_downloaded",
                       br.nrows)
                head.write_block(br)
        return True

    def harvest_one(psp) -> bool:
        hseq, unit, pending = window.popleft()
        with psp.span("harvest", unit=hseq) as hsp:
            with hsp.span("device_sync"):
                members = pending.harvest(_sync)
            if hsp.enabled and unit.pack:
                hsp.set("pack_members", [str(p.uid)
                                         for p, _b in unit.members])
            with hsp.span("emit"):
                return emit(members)

    with tracing.current_span().span("pipeline",
                                     inflight_depth=depth) as plsp:
        try:
            while True:
                refill(plsp)
                if not lookahead or head.is_done():
                    break
                unit = lookahead.popleft()
                # stage the units in the lookahead: their host staging
                # and non-blocking uploads overlap the units on the card
                todo = [u for u in lookahead if not getattr(u, "cached", False)
                        and u.part.uid not in staged]
                if todo:
                    with plsp.span("stage", units=len(todo)):
                        for u in todo:
                            staged.add(u.part.uid)
                            runner.prefetch(
                                u.part, f, spec_seg if u.pack and spec_seg
                                else stats_spec, sort_spec)
                done = False
                while len(window) >= depth:
                    if not harvest_one(plsp):
                        done = True
                        break
                if done or head.is_done():
                    break
                if getattr(unit, "cached", False):
                    # a result-cache hit: in the window for the harvest
                    # order, never staged, submitted or launched
                    window.append((seq, unit, Ready(unit.ready)))
                    seq += 1
                    counters["result_cache_units"] += 1
                    counters["inflight_hwm"] = max(counters["inflight_hwm"],
                                                   len(window))
                    continue
                with plsp.span("submit", unit=seq,
                               blocks=len(unit.bss)) as ssp:
                    if ssp.enabled:
                        ssp.set("rows", sum(bs.nrows
                                            for bs in unit.bss.values()))
                        if unit.pack:
                            ssp.set("pack_size", len(unit.members))
                            ssp.set("pack_members",
                                    [str(p.uid) for p, _b in unit.members])
                        else:
                            ssp.set("part", str(unit.part.uid))
                    window.append((seq, unit, _submit(
                        runner, f, unit, stats_spec, sort_spec, spec_seg)))
                seq += 1
                counters["units"] += 1
                counters["inflight_hwm"] = max(counters["inflight_hwm"],
                                               len(window))
            while window:
                if not harvest_one(plsp):
                    break
            plsp.set("units", seq)
        finally:
            # a satisfied limit (or an error): drop the handles still in
            # flight unwritten, each after its copies land
            for _s, _u, pending in window:
                pending.release()
            window.clear()
            stream.close()
