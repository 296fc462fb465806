"""Query execution: partitions -> parts -> candidate blocks -> pipes.

`run_query` first runs the subqueries of `in(...)`, `contains_all(...)`
and `contains_any(...)` filters (`init_subqueries`: each must narrow
its output to one column with `| fields x`), then extracts the query's
time range, resolves AND-path `_stream:{...}` filters against each
partition's stream index, selects each part's candidate blocks (time
range, tenant, stream, AND-path `_stream_id:` ids), prunes them by the
AND-path leaves' required word tokens (`_prune`: a part whose aggregate
lacks a token is killed whole; on a sealed part the filter index's
maplets keep the exact candidate blocks), and feeds the matching rows
through the pipe chain.  Both walks prune a part before the result
cache is asked for it, as the JAX package does.

The runner is the seam the device path plugs into.  Without one, every
block is filtered on the host (`Filter.apply_to_block`), partition by
partition, part by part.  With one, every selected partition's parts
go through one dispatch window (gpu/pipeline.py `scan_device_stream`;
VL_CROSS_PARTITION=0 drains it at each day boundary), which hands the
runner a whole part's candidate blocks at a time, or a pack of small
parts as one part-like value: `runner.run_part_submit(f, part, bss)`
for row queries, whose harvest gives {block: bitmap}, and for `| stats`
queries with a device shape (`runner.stats_spec(q)`)
`runner.run_part_stats_submit(f, part, bss, spec)`, whose harvest gives
(bitmaps, handled, partials) where `handled` blocks are already reduced
in `partials` (one per nonempty cell: key parts, count, value stats,
uniq values, quantile numbers), which become the functions' partial
states and merge into the stats processor; the rest come back as
bitmaps for the row path.  A row query whose first pipe is `sort by
(field) limit N` (`gpu/sort_device.device_sort_spec`) asks
`runner.run_part_topk_submit(f, part, bss, sort_spec)` first: it keeps
only the rows at or above the part's k-th best key, or declines, and
then the part runs `run_part_submit`.  Units are harvested in
submission order, so the sort pipe sees the surviving rows in the
order of the serial walk.  Each partition is set up (stream filters
resolved, parts listed) when the walk reaches it, under a `partition`
span.

The storage-backed pipes (`join`, `union`, `stream_context`) get the
storage, tenants and runner before the processors are built, and run
their own queries through `run_query_collect_columns` with that runner.

The walk stops once the pipe chain reports itself done (a satisfied
`limit`): the host walk checks before each block it writes; the window
submits no unit after it and drops the units still in flight
unwritten.  Stored blocks enter the chain with the chain's needed
fields (`compute_needed_fields`), so a `| fields` query decodes no
other column.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gpu.pipeline import cross_partition_enabled, scan_device_stream
from ..gpu.sort_device import device_sort_spec
from ..gpu.stats_device import build_partial_states
from ..logsql.duration import format_rfc3339
from ..logsql.filters import (FilterAnd, FilterContainsAll,
                              FilterContainsAny, FilterIn, FilterNot,
                              FilterOr, FilterStream, FilterStreamID,
                              iter_and_path_token_leaves)
from ..logsql.parser import MAX_TS, MIN_TS, Query, parse_query
from ..logsql.pipes import (PipeStats, PipeWhere, SinkProcessor,
                            compute_needed_fields)
from ..obs import tracing
from ..storage.filterbank import (maplet_prune_candidates,
                                  part_aggregate_prunes)
from ..storage.log_rows import TenantID, parse_stream_id
from .block_result import BlockResult
from .block_search import BlockSearch
from .standing.resultcache import QueryCache


@dataclass
class SearchContext:
    partition: object
    tenants: tuple


def _stream_filters(f, out: list) -> list:
    """`_stream:{...}` and `_stream_id:` filters on the top-level AND
    path (usable for pruning)."""
    if isinstance(f, (FilterStream, FilterStreamID)):
        out.append(f)
    elif isinstance(f, FilterAnd):
        for sub in f.filters:
            _stream_filters(sub, out)
    return out


def _iter_subquery_filters(f):
    if isinstance(f, (FilterIn, FilterContainsAll, FilterContainsAny)):
        if f.subquery is not None:
            yield f
    elif isinstance(f, (FilterAnd, FilterOr)):
        for sub in f.filters:
            yield from _iter_subquery_filters(sub)
    elif isinstance(f, FilterNot):
        yield from _iter_subquery_filters(f.inner)


def _run_single_column_subquery(storage, tenants, sub, runner=None
                                ) -> list[str]:
    """The values of a subquery that yields exactly one column."""
    values: list[str] = []
    col_name: list = [None]

    def sink(br: BlockResult):
        if br.is_unprojected_block():
            raise ValueError(
                "in(<subquery>) must narrow its output to one column, "
                "e.g. `... | fields x`")
        names = br.column_names()
        if len(names) != 1:
            raise ValueError(
                f"in(<subquery>) must yield exactly one column, got "
                f"{names!r}")
        if col_name[0] is None:
            col_name[0] = names[0]
        elif col_name[0] != names[0]:
            raise ValueError(
                f"in(<subquery>) yielded inconsistent columns "
                f"{col_name[0]!r} vs {names[0]!r}")
        values.extend(br.column(names[0]))
    run_query(storage, tenants, sub, sink, runner=runner)
    return values


def init_subqueries(storage, tenants, q: Query, runner=None) -> None:
    """Give every `in(<subquery>)`-style filter of the query and of its
    `where` pipes its values by running its subquery."""
    subfilters = list(_iter_subquery_filters(q.filter))
    for p in q.pipes:
        if isinstance(p, PipeWhere):
            subfilters.extend(_iter_subquery_filters(p.filter))
    for f in subfilters:
        f.set_values(_run_single_column_subquery(storage, tenants,
                                                 f.subquery, runner))


def host_bitmap(f, bs) -> np.ndarray:
    """Bool bitmap of the filter over one block, evaluated on the host."""
    bm = np.ones(bs.nrows, dtype=bool)
    f.apply_to_block(bs, bm)
    return bm


def absorb_stats_partials(head, ps, spec, partials) -> None:
    """Merge a runner's per-cell partials into the stats processor
    `head` of pipe `ps`: ("t", bucket ns) key parts become RFC3339
    strings, as the host's bucketing, ("v", value) parts the value; a
    packed unit's ("s", member) part names the member and is no part of
    the key."""
    for key_parts, cnt, field_stats, uniq_vals, quant_vals in partials:
        key = tuple(format_rfc3339(v) if kind == "t" else v
                    for kind, v in key_parts if kind != "s")
        head.absorb_partials(key, build_partial_states(
            spec, ps.funcs, cnt, field_stats, uniq_vals, quant_vals))


def _allowed_streams(f, pt, tenants) -> set:
    """The partition's streams a `_stream` or `_stream_id` filter
    keeps."""
    if isinstance(f, FilterStream):
        return f.resolve(pt, tenants)
    out = set()
    for s in f._set:
        sid = parse_stream_id(s)
        if sid is not None and pt.has_stream_id(sid):
            out.add(sid)
    return out


def _partition_parts(pt, q: Query, tenants: tuple, min_ts: int,
                     max_ts: int, qsp):
    """(part, candidate block idxs, ctx) of the partition's parts with
    candidate blocks (time range, tenant, `_stream:{...}` filters), in
    walk order.  The partition is set up when the walk reaches it, under
    a short `partition` span (day, parts) of the query's span `qsp`:
    the span closes before the first part is yielded, so it never stays
    open across the window's pulls."""
    with qsp.span("partition", day=pt.day) as psp:
        ctx = SearchContext(partition=pt, tenants=tenants)
        sfs = _stream_filters(q.filter, [])
        allowed = None
        parts = []
        if sfs:
            allowed = set.intersection(*(_allowed_streams(f, pt, tenants)
                                         for f in sfs))
            if not allowed:
                psp.set("pruned_by_stream_filter", True)
        if allowed is None or allowed:
            parts = [p for p in pt.snapshot_parts()
                     if p.num_rows and p.min_ts <= max_ts
                     and p.max_ts >= min_ts]
            psp.set("parts", len(parts))
    tenant_set = set(tenants)
    for part in parts:
        bis = []
        for bi in part.candidate_blocks(min_ts, max_ts):
            sid = part.block_stream_id(bi)
            if sid.tenant in tenant_set and (allowed is None
                                             or sid in allowed):
                bis.append(bi)
        if bis:
            yield part, bis, ctx


def _prune(part, bis, leaves, counters=None):
    """A part's candidate blocks after the AND-path token leaves'
    pruning, in the JAX package's order: the part aggregate (the xor
    aggregate of a sealed part, else the bloom folds; built only when
    the candidates cover a quarter of the part) kills the part, else
    the sealed part's maplets drop blocks.  [] when the part is killed
    or every block dropped.  `counters` (a runner's stats_counters)
    counts `agg_pruned_parts` and `maplet_pruned_blocks`."""
    if not leaves:
        return bis
    if part_aggregate_prunes(part, leaves,
                             build=len(bis) * 4 >= part.num_blocks):
        if counters is not None:
            counters["agg_pruned_parts"] += 1
        return []
    kept = maplet_prune_candidates(part, leaves, bis)
    if counters is not None and len(kept) != len(bis):
        counters["maplet_pruned_blocks"] += len(bis) - len(kept)
    return kept


def _pruned_parts(items, leaves, counters):
    """The device walk's part stream after `_prune`: a part is pruned
    before the result cache's probe, its staging and its unit."""
    for part, bis, ctx in items:
        bis = _prune(part, bis, leaves, counters)
        if bis:
            yield part, bis, ctx


def _walk_host(items, f, head, needed, qcache=None, leaves=()) -> None:
    """The host executor's serial walk, block by block.  Each part's
    candidates are pruned (`_prune`) before the result cache's probe; a
    part the cache holds replays its bitmaps in block order; a part
    walked to its end stores its bitmaps."""
    sp = tracing.current_span()
    for part, bis, ctx in items:
        sp.add("blocks_candidate", len(bis))
        bis = _prune(part, bis, leaves)
        if not bis:
            continue
        cached = None
        if qcache is not None and qcache.kind == "bms":
            e = qcache.probe(part, bis)
            if e is not None:
                cached = qcache.entry_bms(e)
        collected: dict = {}
        for bi in bis:
            if head.is_done():
                return
            bs = BlockSearch(part, bi, ctx)
            if cached is not None:
                bm = cached[bi]
            else:
                bm = collected[bi] = host_bitmap(f, bs)
            if bm.any():
                br = BlockResult.from_block_search(bs, bm, needed)
                sp.add("blocks_out")
                sp.add("rows_out", br.nrows)
                head.write_block(br)
        if cached is None and qcache is not None:
            qcache.store_bms(part, bis, collected)


def run_query(storage, tenants, q: Query | str, write_block,
              timestamp: int | None = None, runner=None) -> None:
    """Execute a LogsQL query; write_block(BlockResult) receives results."""
    if isinstance(q, str):
        q = parse_query(q, timestamp)
    if isinstance(tenants, TenantID):
        tenants = [tenants]
    tenants = tuple(tenants)
    init_subqueries(storage, tenants, q, runner)
    # join, union and stream_context run their own queries
    for p in q.pipes:
        if hasattr(p, "init_with_storage"):
            p.init_with_storage(storage, tenants, runner)
    min_ts, max_ts = q.get_time_range()
    if min_ts != MIN_TS and max_ts != MAX_TS:
        # rate() and rate_sum() divide by the time filter's seconds
        for p in q.pipes:
            if isinstance(p, PipeStats):
                for fn in p.funcs:
                    if hasattr(fn, "step_seconds"):
                        fn.step_seconds = (max_ts - min_ts + 1) / 1e9
    head = SinkProcessor(write_block)
    for pipe in reversed(q.pipes):
        head = pipe.make_processor(head)
    needed = compute_needed_fields(q.pipes)
    spec = runner.stats_spec(q) if runner is not None else None
    sort_spec = device_sort_spec(q) if runner is not None and \
        spec is None else None
    # the per-part result cache: a part seen by an earlier run of the
    # query replays its stats partials or bitmaps (None: not applicable)
    qcache = QueryCache.for_query(q, tenants, spec, sort_spec, min_ts,
                                  max_ts)
    pts = storage.select_partitions(min_ts, max_ts)
    qsp = tracing.current_span()
    # the AND-path leaves that prune parts and blocks, hashed once
    leaves = list(iter_and_path_token_leaves(q.filter))

    def parts(pt):
        return _partition_parts(pt, q, tenants, min_ts, max_ts, qsp)

    if runner is None:
        _walk_host((it for pt in pts for it in parts(pt)), q.filter, head,
                   needed, qcache, leaves)
    else:
        def absorb(partials):
            absorb_stats_partials(head, q.pipes[0], spec, partials)

        def pruned(items):
            return _pruned_parts(items, leaves, runner.stats_counters)

        # one dispatch window across every selected partition, set up
        # lazily; VL_CROSS_PARTITION=0 drains it at each day boundary
        streams = [pruned(it for pt in pts for it in parts(pt))] \
            if cross_partition_enabled() else \
            [pruned(parts(pt)) for pt in pts]
        for items in streams:
            if head.is_done():
                break
            scan_device_stream(items, q.filter, head, runner, needed, spec,
                               sort_spec, absorb, qcache)
    head.flush()


def run_query_collect(storage, tenants, q: Query | str,
                      timestamp: int | None = None,
                      runner=None) -> list[dict]:
    """Execute and collect the result rows as dicts."""
    rows: list[dict] = []
    run_query(storage, tenants, q, lambda br: rows.extend(br.rows()),
              timestamp=timestamp, runner=runner)
    return rows


def run_query_collect_columns(storage, tenants, q: Query | str,
                              timestamp: int | None = None,
                              runner=None) -> tuple[dict, int]:
    """Columnar twin of run_query_collect: (cols, nrows), cols an
    insertion-ordered {name: [str, ...]} with every list nrows long
    (a name absent from a block reads "" there)."""
    blocks: list = []            # ({name: list}, nrows)
    order: dict[str, None] = {}

    def sink(br: BlockResult):
        names = br.column_names()
        blocks.append(({n: br.column(n) for n in names}, br.nrows))
        for n in names:
            order.setdefault(n, None)

    run_query(storage, tenants, q, sink, timestamp=timestamp, runner=runner)
    cols: dict[str, list] = {n: [] for n in order}
    for bc, n in blocks:
        for name, out in cols.items():
            vals = bc.get(name)
            out.extend(vals if vals is not None else [""] * n)
    return cols, sum(n for _bc, n in blocks)
