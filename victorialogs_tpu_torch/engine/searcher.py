"""Query execution: partitions -> parts -> candidate blocks -> pipes.

`run_query` first runs the subqueries of `in(...)`, `contains_all(...)`
and `contains_any(...)` filters (`init_subqueries`: each must narrow
its output to one column with `| fields x`), then extracts the query's
time range, resolves AND-path `_stream:{...}` filters against each
partition's stream index, selects each part's candidate blocks (time
range, tenant, stream, AND-path `_stream_id:` ids), and feeds the
matching rows through the pipe chain.

The runner is the seam the device path plugs into.  Without one, every
block is filtered on the host (`Filter.apply_to_block`).  With one, the
executor hands the runner a whole part's candidate blocks at a time:
`runner.run_part(f, part, bss) -> {block: bitmap}` for row queries, and
for `| stats` queries with a device shape (`runner.stats_spec(q)`)
`runner.run_part_stats(f, part, bss, spec) -> (bitmaps, handled, partials)`
where `handled` blocks are already reduced in `partials` (one per
nonempty cell: key parts, count, value stats, uniq values, quantile
numbers), which become the functions' partial states and merge into
the stats processor; the rest come back as bitmaps for the row path.
A row query whose first pipe is `sort by (field) limit N`
(`gpu/sort_device.device_sort_spec`) asks
`runner.run_part_topk(f, part, bss, sort_spec)` first: it returns only
the rows at or above the part's k-th best key, or None, and then the
part runs `run_part`.  The walk stays serial, so the sort pipe sees the
surviving rows in the order the host executor would.

The storage-backed pipes (`join`, `union`, `stream_context`) get the
storage, tenants and runner before the processors are built, and run
their own queries through `run_query_collect_columns` with that runner.

The walk stops once the pipe chain reports itself done (a satisfied
`limit`): it checks before each part's filter or stats program and
before each block it writes, so a query answered from its first part
runs no other.  Stored blocks enter the chain with the chain's needed
fields (`compute_needed_fields`), so a `| fields` query decodes no
other column.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gpu.sort_device import device_sort_spec
from ..gpu.stats_device import build_partial_states
from ..logsql.duration import format_rfc3339
from ..logsql.filters import (FilterAnd, FilterContainsAll,
                              FilterContainsAny, FilterIn, FilterNot,
                              FilterOr, FilterStream, FilterStreamID)
from ..logsql.parser import MAX_TS, MIN_TS, Query, parse_query
from ..logsql.pipes import (PipeStats, PipeWhere, SinkProcessor,
                            compute_needed_fields)
from ..storage.log_rows import TenantID
from .block_result import BlockResult
from .block_search import BlockSearch


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
    strings, as the host's bucketing, ("v", value) parts the value."""
    for key_parts, cnt, field_stats, uniq_vals, quant_vals in partials:
        key = tuple(format_rfc3339(v) if kind == "t" else v
                    for kind, v in key_parts)
        head.absorb_partials(key, build_partial_states(
            spec, ps.funcs, cnt, field_stats, uniq_vals, quant_vals))


def _allowed_streams(f, pt, tenants) -> set:
    """The partition's streams a `_stream` or `_stream_id` filter
    keeps."""
    if isinstance(f, FilterStream):
        return f.resolve(pt, tenants)
    return {sid for sid in pt.streams if sid.as_string() in f._set}


def _candidate_parts(storage, q: Query, tenants: tuple, min_ts: int,
                     max_ts: int):
    """(part, {block: BlockSearch}) of every part with candidate blocks
    (time range, tenant, `_stream:{...}` filters), in walk order."""
    tenant_set = set(tenants)
    sfs = _stream_filters(q.filter, [])
    for pt in storage.select_partitions(min_ts, max_ts):
        ctx = SearchContext(partition=pt, tenants=tenants)
        allowed = None
        if sfs:
            allowed = set.intersection(*(_allowed_streams(f, pt, tenants)
                                         for f in sfs))
            if not allowed:
                continue
        for part in pt.snapshot_parts():
            if not part.num_rows or part.min_ts > max_ts or \
                    part.max_ts < min_ts:
                continue
            bss = {}
            for bi in part.candidate_blocks(min_ts, max_ts):
                sid = part.block_stream_id(bi)
                if sid.tenant in tenant_set and (allowed is None
                                                 or sid in allowed):
                    bss[bi] = BlockSearch(part, bi, ctx)
            if bss:
                yield part, bss


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
    for part, bss in _candidate_parts(storage, q, tenants, min_ts, max_ts):
        if head.is_done():
            break
        handled: set = set()
        bms = None            # without a runner: block by block below
        if spec is not None:
            bms, handled, partials = runner.run_part_stats(
                q.filter, part, bss, spec)
            absorb_stats_partials(head, q.pipes[0], spec, partials)
        elif runner is not None:
            if sort_spec is not None:
                bms = runner.run_part_topk(q.filter, part, bss, sort_spec)
            if bms is None:
                bms = runner.run_part(q.filter, part, bss)
        for bi, bs in bss.items():
            if bi in handled:
                continue
            if head.is_done():
                break
            bm = host_bitmap(q.filter, bs) if bms is None else bms[bi]
            if bm.any():
                head.write_block(BlockResult.from_block_search(bs, bm,
                                                               needed))
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
