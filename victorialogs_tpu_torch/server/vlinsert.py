"""Insert API handlers: `/insert/jsonline` and Elasticsearch `_bulk`, as
functions of (CommonParams, body, LogMessageProcessor) returning the
rows ingested (and, for `_bulk`, the response object).

`handle_jsonline` scans the body in newline-aligned chunks of up to
_NATIVE_CHUNK bytes with the native strict-subset scanner
(native/ingest.py `jsonline_scan`): flat objects of strings, numbers,
true and false become key/value spans, and every line of one schema
maps, through a plan compiled once per schema (`_SchemaPlan`), into a
LogColumns batch handed to the sink every _FAST_CHUNK_ROWS rows.  The
lines the scanner flags (nested values, nulls, duplicate keys, lone
surrogates, malformed JSON) are parsed with json.loads in arrival
order (`_ingest_line`): scalar rows join the columnar batch, the others
take the per-row path.  A chunk whose scan trips a capacity bound is
parsed line by line the same way.  Both count in INGEST_COUNTERS.
With `ignore_fields` or `extra_fields` set, or a sink without columnar
batches, every line takes the per-row path.  The handlers start no
thread; the caller flushes the processor when the request ends.

Not here yet: the HTTP server, Loki, OpenTelemetry, Datadog, journald
and syslog.
"""

from __future__ import annotations

import functools
import json
import time as _time

import numpy as np

from ..native import ingest
from ..storage.log_rows import LogColumns, StreamID, canonical_stream_tags
from ..utils.hashing import stream_id_hash
from .insertutil import CommonParams, LogMessageProcessor, parse_timestamp

# chunks whose native scan tripped a capacity bound and were parsed
# line by line in Python; lines the scanner flagged for json.loads
INGEST_COUNTERS = {"py_chunks": 0, "flagged_lines": 0}


class IngestError(ValueError):
    pass


# errors a malformed body can raise while a handler walks it: they
# answer as IngestError (400)
_PARSE_ERRORS = (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                 IndexError, TypeError, AttributeError, OverflowError,
                 ValueError, RecursionError)

# an exception raised inside these modules is a fault of the server, not
# of the body, and propagates as it is
_INTERNAL_MODULE_PREFIXES = ("victorialogs_tpu_torch.storage",
                             "victorialogs_tpu_torch.native",
                             "victorialogs_tpu_torch.server.insertutil")


def _raised_internally(e: BaseException) -> bool:
    tb = e.__traceback__
    while tb is not None:
        mod = tb.tb_frame.f_globals.get("__name__", "")
        if mod.startswith(_INTERNAL_MODULE_PREFIXES):
            return True
        tb = tb.tb_next
    return False


def _ingest_guard(proto: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(cp, body, lmp, *a, **kw):
            try:
                return fn(cp, body, lmp, *a, **kw)
            except IngestError:
                raise
            except _PARSE_ERRORS as e:
                if _raised_internally(e):
                    raise
                raise IngestError(
                    f"cannot parse {proto} request: "
                    f"{type(e).__name__}: {e}") from None
        return wrapper
    return deco


def _fields_from_json_obj(obj: dict, prefix: str = "") -> list:
    """A JSON object as (name, value) string fields: nested objects
    flattened with `.`, arrays as compact JSON, numbers as json.dumps
    writes them, bools as true/false, nulls dropped."""
    out = []
    for k, v in obj.items():
        name = f"{prefix}{k}"
        if isinstance(v, str):
            out.append((name, v))
        elif isinstance(v, bool):
            out.append((name, "true" if v else "false"))
        elif isinstance(v, (int, float)):
            out.append((name, json.dumps(v)))
        elif v is None:
            continue
        elif isinstance(v, dict):
            out.extend(_fields_from_json_obj(v, prefix=f"{name}."))
        else:
            out.append((name, json.dumps(v, separators=(",", ":"))))
    return out


def _pop_time(cp: CommonParams, fields: list) -> tuple[int | None, list]:
    ts = None
    rest = []
    for k, v in fields:
        if k == cp.time_field and ts is None:
            ts = parse_timestamp(v)
        else:
            rest.append((k, v))
    return ts, rest


def _rename_msg(cp: CommonParams, fields: list) -> list:
    """The first field named in msg_fields becomes _msg."""
    for mf in cp.msg_fields:
        if mf == "_msg":
            return fields
        for i, (k, v) in enumerate(fields):
            if k == mf:
                out = [f for j, f in enumerate(fields) if j != i
                       and f[0] != "_msg"]
                out.append(("_msg", v))
                return out
    return fields


# ---------------- jsonline ----------------

class _SchemaPlan:
    """The row pipeline of one schema (the exact JSON key tuple),
    compiled once: the time field (_pop_time), the `_msg` renaming
    (_rename_msg) and LogRows.add's `_time` drop, first-wins dedupe and
    default `_msg`.  Maps the raw value order to the column layout;
    stream_pos indexes the stream fields in that layout."""

    __slots__ = ("time_idx", "val_idx", "names", "msg_default",
                 "stream_pos", "stream_names")

    def __init__(self, cp: CommonParams, keys: tuple):
        time_idx = -1
        rest = []
        for i, k in enumerate(keys):
            if k == cp.time_field and time_idx < 0:
                time_idx = i
            else:
                rest.append((k, i))
        for mf in cp.msg_fields:
            if mf == "_msg":
                break
            hit = next((p for p, (k, _) in enumerate(rest) if k == mf),
                       None)
            if hit is not None:
                iv = rest[hit][1]
                rest = [kv for p, kv in enumerate(rest)
                        if p != hit and kv[0] != "_msg"]
                rest.append(("_msg", iv))
                break
        seen: set = set()
        clean = []
        has_msg = False
        for k, i in rest:
            if k == "_time":
                continue
            if k == "_msg":
                has_msg = True
            if k in seen:
                continue
            seen.add(k)
            clean.append((k, i))
        self.time_idx = time_idx
        self.msg_default = (not has_msg) and bool(cp.default_msg_value)
        names = [k for k, _ in clean]
        if self.msg_default:
            names.append("_msg")
        self.names = tuple(names)
        self.val_idx = tuple(i for _, i in clean)
        sf = set(cp.stream_fields)
        self.stream_pos = tuple(p for p, k in enumerate(self.names)
                                if k in sf)
        self.stream_names = tuple(self.names[p] for p in self.stream_pos)


_FAST_CHUNK_ROWS = 200_000     # rows a LogColumns batch takes
_NATIVE_CHUNK = 4 << 20        # body bytes a native scan takes


class _FastState:
    """One request's columnar batch and its plan, stream and timestamp
    caches."""

    __slots__ = ("cp", "lmp", "lc", "plans", "scache", "tcache", "n")

    def __init__(self, cp: CommonParams, lmp: LogMessageProcessor):
        self.cp = cp
        self.lmp = lmp
        self.lc = LogColumns()
        self.plans: dict = {}
        self.scache: dict = {}
        self.tcache: dict = {}
        self.n = 0


def _fast_fallback_obj(st: _FastState, obj: dict) -> None:
    """A row the columnar form cannot hold (nested objects, arrays,
    nulls) takes the per-row path, after the columnar rows before it."""
    if st.lc.nrows:
        st.lmp.ingest_columns(st.lc)
        st.lc = LogColumns()
    fields = _fields_from_json_obj(obj)
    ts, fields = _pop_time(st.cp, fields)
    fields = _rename_msg(st.cp, fields)
    st.lmp.add_row(ts, fields)
    st.n += 1


def _stream_info(st: _FastState, snames: tuple, skv: tuple):
    """(StreamID, tags) of the stream with labels snames = skv."""
    info = st.scache.get((snames, skv))
    if info is None:
        tags = canonical_stream_tags(list(zip(snames, skv)))
        hi, lo = stream_id_hash(tags.encode("utf-8"))
        info = st.scache[(snames, skv)] = (StreamID(st.cp.tenant, hi, lo),
                                           tags)
    return info


def _parse_ts(st: _FastState, tval: str) -> int:
    """The timestamp of a stringified time value (now when it is empty
    or unparsable), as _pop_time would give it."""
    ts = None
    if tval:
        ts = st.tcache.get(tval)
        if ts is None:
            ts = parse_timestamp(tval)
            if ts is not None and len(st.tcache) < 65536:
                st.tcache[tval] = ts
    return ts if ts is not None else _time.time_ns()


def _fast_add(st: _FastState, plan: _SchemaPlan, vals: list) -> None:
    """One row, its values in raw key order and stringified as the
    per-row path does, into the columnar batch."""
    ts = _parse_ts(st, vals[plan.time_idx] if plan.time_idx >= 0 else "")
    out_vals = [vals[i] for i in plan.val_idx]
    if plan.msg_default:
        out_vals.append(st.cp.default_msg_value)
    sid, tags = _stream_info(st, plan.stream_names,
                             tuple(out_vals[p] for p in plan.stream_pos))
    lc = st.lc
    lc.add(lc.group(plan.names, plan.stream_pos), st.cp.tenant, ts,
           out_vals, sid, tags)
    st.n += 1
    if lc.nrows >= _FAST_CHUNK_ROWS:
        st.lmp.ingest_columns(lc)
        st.lc = LogColumns()


def _scan_chunk_py(st: _FastState, text: str) -> None:
    """A chunk parsed line by line with json.loads: the path of a chunk
    whose native scan tripped a bound, and the plain version the native
    scan is held against."""
    for line in text.split("\n"):
        if line:
            _ingest_line(st, line)


def _ingest_line(st: _FastState, line) -> None:
    """Parse one JSON line with json.loads and ingest it: a row of
    scalars joins the columnar batch, any other row takes the per-row
    path."""
    # ASCII whitespace only, as bytes.strip takes it (str.strip would
    # also take NBSP and U+2028)
    ws = " \t\n\r\x0b\x0c" if isinstance(line, str) \
        else b" \t\n\r\x0b\x0c"
    line = line.strip(ws)
    if not line:
        return
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        raise IngestError(f"cannot parse JSON line: {e}") from None
    if not isinstance(obj, dict):
        raise IngestError("JSON line must be an object")
    vals = list(obj.values())
    for p, v in enumerate(vals):
        t = type(v)
        if t is str:
            continue
        if t is bool:
            vals[p] = "true" if v else "false"
        elif t is int or t is float:
            vals[p] = json.dumps(v)
        else:           # nested object, array or null
            _fast_fallback_obj(st, obj)
            return
    keys = tuple(obj.keys())
    plan = st.plans.get(keys)
    if plan is None:
        plan = st.plans[keys] = _SchemaPlan(st.cp, keys)
    _fast_add(st, plan, vals)


_U32 = 1 << 32


def _vector_ts(tvals: list) -> list | None:
    """parse_timestamp over a column of unix-number strings at once;
    None when a value is not an int64 decimal or is 0 (now)."""
    try:
        ints = np.array(tvals, dtype=np.int64)
    except (ValueError, OverflowError):
        return None
    if (ints == 0).any():
        return None
    ns = np.where(
        ints < _U32, ints * 1_000_000_000,
        np.where(ints < _U32 * 1_000, ints * 1_000_000,
                 np.where(ints < _U32 * 1_000_000, ints * 1_000, ints)))
    return ns.tolist()


def _scan_chunk_native(st: _FastState, chunk: bytes, scan) -> None:
    """Ingest one chunk's native scan column by column: each run of
    unflagged lines is grouped by schema signature, a group's columns
    are sliced from the arena, its timestamps parsed at once and its
    rows appended with one extend a column; a flagged line is parsed
    by _ingest_line where it stands, so arrival order holds."""
    arena, fields, lines, sigs, is_ascii = scan
    arena_s = arena.decode("utf-8") if is_ascii else None
    vo_np = fields[:, 2]
    ve_np = vo_np + fields[:, 3]
    kd_np = fields[:, 4]
    ko_np = fields[:, 0]
    ke_np = ko_np + fields[:, 1]
    fs_np = lines[:, 0]
    fl_np = lines[:, 2]
    M = lines.shape[0]

    def text(o: int, e: int) -> str:
        return arena_s[o:e] if arena_s is not None \
            else arena[o:e].decode("utf-8")

    def col_values(fseg: np.ndarray, jraw: int) -> list:
        idx = fseg + jraw
        kds = kd_np[idx]
        vos = vo_np[idx].tolist()
        ves = ve_np[idx].tolist()
        if int(kds.max(initial=0)) <= 1:     # strings and exact ints
            if arena_s is not None:
                return [arena_s[o:e] for o, e in zip(vos, ves)]
            return [arena[o:e].decode("utf-8") for o, e in zip(vos, ves)]
        out = []
        for o, e, k in zip(vos, ves, kds.tolist()):
            if k <= 1:
                out.append(text(o, e))
            elif k == 2:            # a float, as json.dumps writes it
                out.append(json.dumps(float(text(o, e))))
            else:
                out.append("true" if k == 3 else "false")
        return out

    def segment(a: int, b: int) -> None:
        seg_sigs = sigs[a:b]
        seg_fs = fs_np[a:b]
        # a stable argsort groups the schemas, lines in order within one
        order = np.argsort(seg_sigs, kind="stable")
        ssorted = seg_sigs[order]
        bounds = [0] + (np.nonzero(np.diff(ssorted))[0] + 1).tolist() \
            + [order.shape[0]]
        for gi in range(len(bounds) - 1):
            rows = order[bounds[gi]:bounds[gi + 1]]
            fseg = seg_fs[rows]
            li0 = a + int(rows[0])
            nfl = int(lines[li0, 1])
            pkey = (nfl, int(ssorted[bounds[gi]]))
            plan = st.plans.get(pkey)
            if plan is None:
                f0 = int(fs_np[li0])
                keys = tuple(text(int(ko_np[f0 + j]), int(ke_np[f0 + j]))
                             for j in range(nfl))
                plan = st.plans[pkey] = _SchemaPlan(st.cp, keys)
            n = rows.shape[0]
            out_cols = [col_values(fseg, j) for j in plan.val_idx]
            if plan.msg_default:
                out_cols.append([st.cp.default_msg_value] * n)
            if plan.time_idx >= 0:
                tvals = col_values(fseg, plan.time_idx)
                ts_list = _vector_ts(tvals)
                if ts_list is None:
                    ts_list = [_parse_ts(st, tv) for tv in tvals]
            else:
                ts_list = [_time.time_ns() for _ in range(n)]
            # stream refs cached under the raw stream values: the
            # StreamID is hashed once a stream, not once a row
            lc = st.lc
            g = lc.group(plan.names, plan.stream_pos)
            kidx = g.key_idx
            snames = plan.stream_names
            scols = [out_cols[p] for p in plan.stream_pos]
            srefs = []
            for skv in zip(*scols) if scols else [()] * n:
                si = kidx.get(skv)
                if si is None:
                    sid, tags = _stream_info(st, snames, skv)
                    si = kidx[skv] = lc.intern_stream(g, st.cp.tenant,
                                                      sid, tags)
                srefs.append(si)
            lc.add_bulk_refs(g, ts_list, out_cols, srefs)
            st.n += n
            if lc.nrows >= _FAST_CHUNK_ROWS:
                st.lmp.ingest_columns(lc)
                st.lc = LogColumns()

    fb = np.nonzero(fl_np)[0].tolist()
    INGEST_COUNTERS["flagged_lines"] += len(fb)
    seg_start = 0
    for stop in fb + [M]:
        if stop > seg_start:
            segment(seg_start, stop)
        if stop < M:
            ro, rl = int(lines[stop, 3]), int(lines[stop, 4])
            _ingest_line(st, chunk[ro:ro + rl])
        seg_start = stop + 1


def _scan_span(st: _FastState, body: bytes) -> None:
    """Scan the body in newline-aligned chunks of up to _NATIVE_CHUNK
    bytes into st."""
    pos, end_all = 0, len(body)
    while pos < end_all:
        end = min(pos + _NATIVE_CHUNK, end_all)
        if end < end_all:
            nl = body.rfind(b"\n", pos, end)
            end = nl + 1 if nl > pos else end_all
        chunk = body[pos:end]
        pos = end
        scan = ingest.jsonline_scan(chunk)
        if scan is None:
            INGEST_COUNTERS["py_chunks"] += 1
            _scan_chunk_py(st, chunk.decode("utf-8"))
        else:
            _scan_chunk_native(st, chunk, scan)


def _jsonline_fast(cp: CommonParams, body: bytes,
                   lmp: LogMessageProcessor) -> int:
    """The columnar jsonline path; rows reach the sink in body order."""
    try:
        # the whole body is checked before any row is ingested
        body.decode("utf-8")
    except UnicodeDecodeError as e:
        raise IngestError(f"request body is not valid UTF-8: {e}") \
            from None
    st = _FastState(cp, lmp)
    _scan_span(st, body)
    lmp.ingest_columns(st.lc)
    return st.n


@_ingest_guard("jsonline")
def handle_jsonline(cp: CommonParams, body: bytes,
                    lmp: LogMessageProcessor) -> int:
    if not cp.ignore_fields and not cp.extra_fields and \
            lmp.supports_columns():
        return _jsonline_fast(cp, body, lmp)
    n = 0
    for line in body.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise IngestError(f"cannot parse JSON line: {e}") from None
        if not isinstance(obj, dict):
            raise IngestError("JSON line must be an object")
        fields = _fields_from_json_obj(obj)
        ts, fields = _pop_time(cp, fields)
        fields = _rename_msg(cp, fields)
        lmp.add_row(ts, fields)
        n += 1
    return n


# ---------------- elasticsearch bulk ----------------

@_ingest_guard("Elasticsearch bulk")
def handle_elasticsearch_bulk(cp: CommonParams, body: bytes,
                              lmp: LogMessageProcessor) -> tuple[int, dict]:
    """Action/document line pairs; `create` and `index` ingest their
    document (`@timestamp` or `timestamp` is the time, `message` or
    `msg` the `_msg`), other actions are skipped."""
    lines = body.split(b"\n")
    n = 0
    i = 0
    while i < len(lines):
        action_line = lines[i].strip()
        i += 1
        if not action_line:
            continue
        try:
            action = json.loads(action_line)
        except json.JSONDecodeError:
            raise IngestError("invalid bulk action line") from None
        op = next(iter(action), "")
        if op not in ("create", "index"):
            continue
        if i >= len(lines):
            break
        doc_line = lines[i].strip()
        i += 1
        if not doc_line:
            continue
        try:
            obj = json.loads(doc_line)
        except json.JSONDecodeError:
            raise IngestError("invalid bulk document line") from None
        fields = _fields_from_json_obj(obj)
        ts = None
        rest = []
        for k, v in fields:
            if ts is None and k in ("@timestamp", "timestamp",
                                    cp.time_field):
                ts = parse_timestamp(v)
            else:
                rest.append((k, v))
        has_msg = any(k == "_msg" for k, _ in rest)
        out = [("_msg", v) if k in ("message", "msg") and not has_msg
               else (k, v) for k, v in rest]
        lmp.add_row(ts, _rename_msg(cp, out))
        n += 1
    resp = {"took": 0, "errors": False,
            "items": [{"create": {"status": 201}}] * n}
    return n, resp
