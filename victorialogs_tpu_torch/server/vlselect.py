"""Query API handlers: `/select/logsql/query`, `/select/logsql/stats_query`,
`/select/logsql/hits` and `/select/logsql/stats_query_range`, as
functions of (storage, args, headers).

`handle_query` answers NDJSON, one chunk a result block, each written
by the columnar emit (engine/emit.py); the endpoint appends `| offset
N` and `| limit N` (1000 unless `limit` says otherwise, 0 for none), so
the part walk stops once the limit is met.  `handle_stats_query`
answers a query ending in `stats` as a Prometheus instant vector at
`time`.  `handle_hits` (VMUI's histogram) appends `| stats by
(_time:<step> [offset <offset>], <field>...) count() hits` and answers
the hit counts per bucket and field values; `handle_stats_query_range`
(a Grafana time series) adds `_time:<step>` to the query's own `stats`
and answers a Prometheus range matrix.  All take `start`/`end` (added
as a time filter), `time` (the query's now) and the tenant's
AccountID/ProjectID.

All run the query's filter and stats programs on the card: by default
through the storage's own `TorchBatchRunner` (made on first use, kept
while the storage lives, so its staged parts stay warm), which raises
where CUDA is unavailable.  A caller passes its own runner (one with
device="cpu" runs the kernels' plain versions), or `runner=None` for
the host executor, which filters block by block with numpy.

`extra_filters` and `extra_stream_filters` AND a filter into the query:
a JSON object `{"field": ["v1", "v2"], ...}` becomes `field:in(v1, v2)`
filters, anything else is parsed as a LogsQL filter (HTTPError(400)
when it does not parse).

`trace=1` (or `true`, `yes`) traces the query (obs/tracing.py): the
root span is `query`; `handle_query` adds one last NDJSON line
`{"_trace": {...}}` after row lines byte-identical to the untraced
answer, and the other handlers add a `"trace"` key.  Without it no span
is made.

Not here yet: the HTTP server, the active-query registry and slow-query
log, `timeout` deadlines, and the facets and tail endpoints.
"""

from __future__ import annotations

import json
import time
import weakref

from ..engine.emit import ndjson_block
from ..engine.searcher import run_query, run_query_collect_columns
from ..gpu.batch import TorchBatchRunner
from ..logsql import stats_funcs as sf
from ..logsql.duration import parse_duration, parse_rfc3339, ts_bounds
from ..logsql.filters import FilterAnd, FilterIn
from ..logsql.parser import (MAX_TS, MIN_TS, ParseError, Query,
                             parse_filter_string, parse_query)
from ..logsql.pipes import ByField, PipeLimit, PipeOffset, PipeStats
from ..obs import tracing
from .insertutil import get_tenant_id, parse_timestamp


CARD = object()          # the handlers' default runner: card_runner(storage)
_card_runners: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def card_runner(storage) -> TorchBatchRunner:
    """The storage's own runner on the card, made on first use."""
    runner = _card_runners.get(storage)
    if runner is None:
        runner = _card_runners[storage] = TorchBatchRunner()
    return runner


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_time_arg(v: str, default: int, end: bool = False) -> int:
    if not v:
        return default
    if v == "now":
        return time.time_ns()
    d = parse_duration(v)
    if d is not None:
        return time.time_ns() - abs(d)
    tb = ts_bounds(v)
    if tb is not None:
        return tb[1] if end else tb[0]
    try:  # unix seconds / millis / nanos
        iv = float(v)
        return parse_timestamp(int(iv) if iv.is_integer() else iv)
    except (ValueError, OverflowError):
        raise HTTPError(400, f"cannot parse time arg {v!r}")


def _int_arg(args, name, default=0) -> int:
    v = args.get(name, "")
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        raise HTTPError(400, f"invalid {name} arg {v!r}")


def parse_common_args(args, headers) -> tuple[Query, list]:
    qs = args.get("query", "")
    if not qs:
        raise HTTPError(400, "missing query arg")
    ts = _parse_time_arg(args.get("time", ""), time.time_ns(), end=True)
    try:
        q = parse_query(qs, timestamp=ts)
    except (ParseError, ValueError) as e:
        raise HTTPError(400, f"cannot parse query: {e}")
    start = _parse_time_arg(args.get("start", ""), MIN_TS)
    end = _parse_time_arg(args.get("end", ""), MAX_TS, end=True)
    if start != MIN_TS or end != MAX_TS:
        q.add_time_filter(start, end)
    for extra_arg in ("extra_filters", "extra_stream_filters"):
        ef = args.get(extra_arg, "")
        if ef:
            _apply_extra_filters(q, ef)
    return q, [get_tenant_id(headers, args)]


def _apply_extra_filters(q: Query, ef: str) -> None:
    """AND `ef` (a JSON object of field -> value or values, or a LogsQL
    filter) into the query's filter."""
    try:
        obj = json.loads(ef)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict):
        fs = []
        for k, vals in obj.items():
            if isinstance(vals, str):
                vals = [vals]
            if not isinstance(vals, list):
                raise HTTPError(400, f"cannot parse extra_filters: the "
                                     f"value of {k!r} is not a string or "
                                     f"a list")
            fs.append(FilterIn(k, [str(v) for v in vals]))
        if not fs:
            return
        extra = FilterAnd(fs) if len(fs) > 1 else fs[0]
    else:
        try:
            extra = parse_filter_string(ef)
        except (ParseError, ValueError) as e:
            raise HTTPError(400, f"cannot parse extra_filters: {e}")
    if isinstance(q.filter, FilterAnd):
        q.filter.filters.insert(0, extra)
    else:
        q.filter = FilterAnd([extra, q.filter])


def want_trace(args) -> bool:
    return args.get("trace", "") in ("1", "true", "yes")


def _trace_root(args, q: Query):
    """The root span of a traced request, else None (no span at all)."""
    if want_trace(args):
        return tracing.make_root("query", query=q.to_string())
    return None


def _collect_traced(storage, tenants, q: Query, args, runner):
    """run_query_collect_columns under the request's trace: ((cols,
    nrows), the span tree or None)."""
    root = _trace_root(args, q)
    with tracing.activate(root):
        got = run_query_collect_columns(storage, tenants, q, runner=runner)
    return got, None if root is None else root.to_dict()


def _query_pipes(q: Query, args) -> None:
    """/select/logsql/query: offset and limit pushdown."""
    limit = _int_arg(args, "limit", 1000)
    offset = _int_arg(args, "offset", 0)
    if offset:
        q.pipes.append(PipeOffset(offset))
    if limit > 0:
        q.pipes.append(PipeLimit(limit))


def handle_query(storage, args, headers, runner=CARD) -> list[bytes]:
    """The NDJSON answer of /select/logsql/query: one chunk a non-empty
    result block."""
    q, tenants = parse_common_args(args, headers)
    _query_pipes(q, args)
    if runner is CARD:
        runner = card_runner(storage)
    chunks: list[bytes] = []

    def sink(br):
        data = ndjson_block(br)
        if data:
            chunks.append(data)

    root = _trace_root(args, q)
    with tracing.activate(root):
        run_query(storage, tenants, q, sink, runner=runner)
    if root is not None:
        chunks.append((json.dumps({"_trace": root.to_dict()},
                                  ensure_ascii=False,
                                  separators=(",", ":")) + "\n").encode())
    return chunks


def _require_stats_query(q: Query) -> PipeStats:
    for p in reversed(q.pipes):
        if isinstance(p, PipeStats):
            return p
    raise HTTPError(400, "query must end with a `stats` pipe")


def handle_stats_query(storage, args, headers, runner=CARD) -> dict:
    """The /select/logsql/stats_query answer: one sample a group and
    function at `time`."""
    q, tenants = parse_common_args(args, headers)
    sp = _require_stats_query(q)
    if runner is CARD:
        runner = card_runner(storage)
    ts = _parse_time_arg(args.get("time", ""), time.time_ns(), end=True)
    (cols, nrows), tree = _collect_traced(storage, tenants, q, args, runner)
    by_names = [b.name for b in sp.by]
    by_cols = [cols.get(n) or [""] * nrows for n in by_names]
    fn_cols = [cols.get(fn.out_name) or [""] * nrows for fn in sp.funcs]
    result = []
    for i in range(nrows):
        for fn, vc in zip(sp.funcs, fn_cols):
            metric = {"__name__": fn.out_name}
            for n, bc in zip(by_names, by_cols):
                if bc[i] != "":
                    metric[n] = bc[i]
            result.append({"metric": metric, "value": [ts / 1e9, vc[i]]})
    out = {"status": "success",
           "data": {"resultType": "vector", "result": result}}
    if tree is not None:
        out["trace"] = tree
    return out


def _step_arg(args) -> str:
    step = args.get("step", "1d")
    if parse_duration(step) is None:
        raise HTTPError(400, f"invalid step {step!r}")
    return step


def _hits_pipes(q: Query, args) -> list:
    """/select/logsql/hits: append `stats by (_time:<step> [offset],
    <field>...) count() hits`; returns the extra group fields."""
    step = _step_arg(args)
    offset_s = args.get("offset", "0s")
    fields = [f.strip() for name in ("field", "fields")
              for f in args.get(name, "").split(",") if f.strip()]
    by = [ByField("_time", bucket=step, bucket_offset=offset_s)] + \
        [ByField(f) for f in fields]
    fn = sf.StatsCount([])
    fn.out_name = "hits"
    q.pipes.append(PipeStats(by, [fn]))
    return fields


def handle_hits(storage, args, headers, runner=CARD) -> dict:
    """The /select/logsql/hits answer: per group of field values, the
    bucket times and hit counts, groups by total hits descending."""
    q, tenants = parse_common_args(args, headers)
    fields = _hits_pipes(q, args)
    if runner is CARD:
        runner = card_runner(storage)
    (cols, n), tree = _collect_traced(storage, tenants, q, args, runner)
    tcol = cols.get("_time") or [""] * n
    hcol = cols.get("hits") or [""] * n
    fcols = [cols.get(f) or [""] * n for f in fields]
    groups: dict = {}
    for i in range(n):
        key = tuple((f, fc[i]) for f, fc in zip(fields, fcols))
        g = groups.setdefault(key, {"fields": dict(key), "timestamps": [],
                                    "values": [], "total": 0})
        g["timestamps"].append(tcol[i])
        hits = int(hcol[i] or "0")
        g["values"].append(hits)
        g["total"] += hits
    out = {"hits": sorted(groups.values(), key=lambda g: -g["total"])}
    if tree is not None:
        out["trace"] = tree
    return out


def _stats_range_pipes(q: Query, args) -> PipeStats:
    """/select/logsql/stats_query_range: the query's `stats` grouped by
    `_time:<step>` first, unless it groups by `_time` already."""
    sp = _require_stats_query(q)
    step = _step_arg(args)
    if not any(b.name == "_time" for b in sp.by):
        sp.by.insert(0, ByField("_time", bucket=step))
    return sp


def handle_stats_query_range(storage, args, headers, runner=CARD) -> dict:
    """The /select/logsql/stats_query_range answer: one series a
    function and group, its samples in time order."""
    q, tenants = parse_common_args(args, headers)
    sp = _stats_range_pipes(q, args)
    if runner is CARD:
        runner = card_runner(storage)
    (cols, nrows), tree = _collect_traced(storage, tenants, q, args, runner)
    series: dict = {}
    by_names = [b.name for b in sp.by if b.name != "_time"]
    tcol = cols.get("_time") or [""] * nrows
    by_cols = [cols.get(n) or [""] * nrows for n in by_names]
    fn_cols = [cols.get(fn.out_name) or [""] * nrows for fn in sp.funcs]
    for i in range(nrows):
        t = parse_rfc3339(tcol[i]) or 0
        for fn, vc in zip(sp.funcs, fn_cols):
            key = (fn.out_name,) + tuple((n, bc[i])
                                         for n, bc in zip(by_names, by_cols))
            s = series.setdefault(key, {"metric": dict(
                [("__name__", fn.out_name)] +
                [(n, bc[i]) for n, bc in zip(by_names, by_cols)
                 if bc[i] != ""]), "values": []})
            s["values"].append([t / 1e9, vc[i]])
    for s in series.values():
        s["values"].sort()
    out = {"status": "success",
           "data": {"resultType": "matrix",
                    "result": list(series.values())}}
    if tree is not None:
        out["trace"] = tree
    return out
