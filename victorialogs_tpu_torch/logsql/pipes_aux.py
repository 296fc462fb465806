"""Auxiliary pipes: the storage-backed `join`, `union` and
`stream_context`, and the row pipes `collapse_nums`, `decolorize`,
`hash`, `json_array_len` and `block_stats`.

`join`, `union` and `stream_context` run queries of their own:
engine/searcher.py `run_query` hands them the storage, tenants and
runner (`init_with_storage`) before it builds the processors, and
their inner queries go through `run_query_collect_columns` with that
runner, so under a device runner their filters run on the card too.
`join` runs its query as its processor is built, `union` and
`stream_context` as they flush.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field as dc_field

from ..engine.block_result import BlockResult
from ..storage.values_encoder import VT_NAMES
from ..utils.hashing import xxh64
from .duration import format_rfc3339, parse_duration, parse_rfc3339
from .lexer import quote_token_if_needed
from .pipes import (ParseError, Pipe, Processor, _parse_field_name,
                    _parse_paren_fields, _parse_uint, if_mask, if_str,
                    maybe_if, register_pipe)

NS = 1_000_000_000


class _StorageBackedPipe(Pipe):
    """Base for pipes that must run additional queries against storage."""

    def __init__(self):
        self._storage = None
        self._tenants = None
        self._runner = None

    def init_with_storage(self, storage, tenants, runner) -> None:
        self._storage = storage
        self._tenants = list(tenants)
        self._runner = runner

    def _collect_columns(self, q):
        """(cols, nrows) — the columnar collect contract
        (engine.searcher.run_query_collect_columns): bulk column
        lists, no per-row dicts, shared by local and cluster paths."""
        from ..engine.searcher import run_query_collect_columns
        if self._storage is None:
            raise ParseError(
                f"{self.name} requires storage-backed execution")
        return run_query_collect_columns(self._storage, self._tenants,
                                         q, runner=self._runner)


# ---------------- join ----------------

@dataclass(repr=False)
class PipeJoin(_StorageBackedPipe):
    by: list = dc_field(default_factory=list)
    query: object = None          # parsed Query
    inner: bool = False
    prefix: str = ""

    name = "join"

    def __post_init__(self):
        _StorageBackedPipe.__init__(self)

    def to_string(self):
        s = (f"join by ({', '.join(self.by)}) "
             f"({self.query.to_string()})")
        if self.inner:
            s += " inner"
        if self.prefix:
            s += " prefix " + quote_token_if_needed(self.prefix)
        return s

    def needed_fields(self):
        return set(self.by)

    def make_processor(self, next_p):
        pipe = self
        # hash-join map built from the subquery once (reference builds it in
        # storage_search.go:212-272); the subquery result arrives as
        # bulk columns and only the per-GROUP extras become dicts
        cols, nr = pipe._collect_columns(pipe.query)
        by = pipe.by
        by_cols = [cols.get(f) or [""] * nr for f in by]
        extra_items = [(pipe.prefix + k, v) for k, v in cols.items()
                       if k not in by]
        jmap: dict[tuple, list[dict]] = {}
        for i in range(nr):
            key = tuple(bc[i] for bc in by_cols)
            extra = {k: vc[i] for k, vc in extra_items
                     if vc[i] != ""}
            jmap.setdefault(key, []).append(extra)

        class P(Processor):
            def write_block(self, br):
                names = br.column_names()
                cols = {n: br.column(n) for n in names}
                out_rows: list[dict] = []
                for i in range(br.nrows):
                    key = tuple(cols.get(f, [""] * br.nrows)[i] for f in by)
                    base = {n: cols[n][i] for n in names}
                    matches = jmap.get(key)
                    if not matches:
                        if not pipe.inner:
                            out_rows.append(base)
                        continue
                    for m in matches:
                        out_rows.append({**base, **m})
                if out_rows:
                    all_names: dict[str, None] = {}
                    for r in out_rows:
                        for k in r:
                            all_names.setdefault(k, None)
                    out_cols = {n: [r.get(n, "") for r in out_rows]
                                for n in all_names}
                    self.next_p.write_block(
                        BlockResult.from_columns(out_cols))
        return P(next_p)


# ---------------- union ----------------

@dataclass(repr=False)
class PipeUnion(_StorageBackedPipe):
    query: object = None

    name = "union"

    def __post_init__(self):
        _StorageBackedPipe.__init__(self)

    def to_string(self):
        return f"union ({self.query.to_string()})"

    def input_fields(self, out_needed):
        return out_needed

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                self.next_p.write_block(br)

            def flush(self):
                # the union'd query runs after the main one finishes
                # (reference pipe_union.go); its columns pass straight
                # through — no row-dict round trip
                cols, nr = pipe._collect_columns(pipe.query)
                if nr and cols:
                    self.next_p.write_block(BlockResult.from_columns(cols))
                self.next_p.flush()
        return P(next_p)


# ---------------- stream_context ----------------

@dataclass(repr=False)
class PipeStreamContext(_StorageBackedPipe):
    before: int = 0
    after: int = 0
    time_window_ns: int = 3600 * NS

    name = "stream_context"

    def __post_init__(self):
        _StorageBackedPipe.__init__(self)

    def to_string(self):
        s = "stream_context"
        if self.before > 0:
            s += f" before {self.before}"
        if self.after > 0:
            s += f" after {self.after}"
        if self.before <= 0 and self.after <= 0:
            s += " after 0"
        if self.time_window_ns != 3600 * NS:
            s += f" time_window {self.time_window_ns // NS}s"
        return s

    def input_fields(self, out_needed):
        return {"*"}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                # stream_id -> sorted set of matched timestamps
                self.matched: dict[str, set] = {}

            def write_block(self, br):
                sids = br.column("_stream_id")
                ts = br.timestamps or [None] * br.nrows
                for i in range(br.nrows):
                    t = ts[i]
                    if t is None:
                        t = parse_rfc3339(br.column("_time")[i])
                    if t is not None:
                        self.matched.setdefault(sids[i], set()).add(t)

            def flush(self):
                w = pipe.time_window_ns
                for sid, tset in self.matched.items():
                    times = sorted(tset)
                    lo = format_rfc3339(times[0] - w)
                    hi = format_rfc3339(times[-1] + w)
                    qs = (f"_stream_id:{sid} "
                          f"_time:[{lo}, {hi}] | sort by (_time)")
                    cols, nr = pipe._collect_columns(qs)
                    keep_idx: set[int] = set()
                    row_ts = [parse_rfc3339(v) or 0
                              for v in cols.get("_time") or [""] * nr]
                    for t in times:
                        # locate matched rows by bisect (row_ts is sorted)
                        # and take the surrounding window
                        # (reference pipe_stream_context.go)
                        i = bisect.bisect_left(row_ts, t)
                        while i < len(row_ts) and row_ts[i] == t:
                            a = max(0, i - pipe.before)
                            b = min(nr, i + pipe.after + 1)
                            keep_idx.update(range(a, b))
                            i += 1
                    keep = sorted(keep_idx)
                    if not keep:
                        continue
                    out_cols = {n: [vals[i] for i in keep]
                                for n, vals in cols.items()}
                    self.next_p.write_block(
                        BlockResult.from_columns(out_cols))
                self.next_p.flush()
        return P(next_p)


# ---------------- collapse_nums ----------------

_HEX_CHARS = set("0123456789abcdefABCDEF")
_SPECIAL_START = set("TXxvshm")
_SPECIAL_END = set("TZsmhunμ")


def _is_token_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _can_be_num(s: str) -> bool:
    if all(ch.isdigit() for ch in s):
        return True
    # hex runs: require >=4 chars and an even count ("be", "abc" stay text)
    return len(s) >= 4 and len(s) % 2 == 0


def collapse_nums(s: str) -> str:
    out = []
    start = 0
    num_start = -1
    for i, c in enumerate(s):
        if c in _HEX_CHARS:
            if num_start < 0 and (i == 0 or s[i - 1] in _SPECIAL_START or
                                  not _is_token_char(s[i - 1])):
                num_start = i
            continue
        if num_start < 0:
            continue
        out.append(s[start:num_start])
        if (c not in _SPECIAL_END and _is_token_char(c)) or \
                not _can_be_num(s[num_start:i]):
            out.append(s[num_start:i])
        else:
            out.append("<N>")
        start = i
        num_start = -1
    if num_start >= 0 and _can_be_num(s[num_start:]):
        out.append(s[start:num_start])
        out.append("<N>")
    else:
        out.append(s[start:])
    return "".join(out)


def _replace_skip_tail(s: str, old: str, new: str, skip_tail=None) -> str:
    out = []
    while True:
        n = s.find(old)
        if n < 0:
            out.append(s)
            return "".join(out)
        out.append(s[:n])
        out.append(new)
        s = s[n + len(old):]
        if skip_tail is not None:
            s = skip_tail(s)


def _skip_subsecs(s: str) -> str:
    if s.startswith(".<N>") or s.startswith(",<N>"):
        return s[4:]
    return s


def _skip_tz(s: str) -> str:
    if s.startswith("Z"):
        return s[1:]
    if s.startswith("-<N>:<N>") or s.startswith("+<N>:<N>"):
        return s[8:]
    return s


def prettify_collapsed(s: str) -> str:
    s = _replace_skip_tail(s, "<N>-<N>-<N>-<N>-<N>", "<UUID>")
    s = _replace_skip_tail(s, "<N>.<N>.<N>.<N>", "<IP4>")
    s = _replace_skip_tail(s, "<N>:<N>:<N>", "<TIME>", _skip_subsecs)
    s = _replace_skip_tail(s, "<N>-<N>-<N>", "<DATE>")
    s = _replace_skip_tail(s, "<N>/<N>/<N>", "<DATE>")
    s = _replace_skip_tail(s, "<DATE>T<TIME>", "<DATETIME>", _skip_tz)
    s = _replace_skip_tail(s, "<DATE> <TIME>", "<DATETIME>", _skip_tz)
    return s


@dataclass(repr=False)
class PipeCollapseNums(Pipe):
    field: str = "_msg"
    prettify: bool = False
    iff: object = None

    name = "collapse_nums"

    def to_string(self):
        s = "collapse_nums" + if_str(self.iff)
        if self.field != "_msg":
            s += " at " + quote_token_if_needed(self.field)
        if self.prettify:
            s += " prettify"
        return s

    def needed_fields(self):
        out = {self.field}
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                vals = br.column(pipe.field)
                out_vals = []
                for i, v in enumerate(vals):
                    if mask is not None and not mask[i]:
                        out_vals.append(v)
                        continue
                    c = collapse_nums(v)
                    if pipe.prettify:
                        c = prettify_collapsed(c)
                    out_vals.append(c)
                out = br.materialize()
                out._cols[pipe.field] = out_vals
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- decolorize ----------------

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")


@dataclass(repr=False)
class PipeDecolorize(Pipe):
    field: str = "_msg"

    name = "decolorize"

    def to_string(self):
        s = "decolorize"
        if self.field != "_msg":
            s += " at " + quote_token_if_needed(self.field)
        return s

    def needed_fields(self):
        return {self.field}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                vals = br.column(pipe.field)
                out = br.materialize()
                out._cols[pipe.field] = [_ANSI_RE.sub("", v) for v in vals]
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- hash / json_array_len / block_stats ----------------

@dataclass(repr=False)
class PipeHash(Pipe):
    field: str = "_msg"
    result_field: str = "_msg"

    name = "hash"

    def to_string(self):
        s = f"hash({quote_token_if_needed(self.field)})"
        if self.result_field != "_msg":
            s += " as " + quote_token_if_needed(self.result_field)
        return s

    def needed_fields(self):
        return {self.field}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                vals = br.column(pipe.field)
                out = br.materialize()
                out._cols[pipe.result_field] = [
                    str(xxh64(v.encode("utf-8"))) for v in vals]
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipeJSONArrayLen(Pipe):
    field: str = "_msg"
    result_field: str = "_msg"

    name = "json_array_len"

    def to_string(self):
        s = f"json_array_len({quote_token_if_needed(self.field)})"
        if self.result_field != "_msg":
            s += " as " + quote_token_if_needed(self.result_field)
        return s

    def needed_fields(self):
        return {self.field}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                vals = br.column(pipe.field)
                out_vals = []
                for v in vals:
                    try:
                        arr = json.loads(v)
                        out_vals.append(str(len(arr))
                                        if isinstance(arr, list) else "0")
                    except (ValueError, RecursionError):
                        out_vals.append("0")
                out = br.materialize()
                out._cols[pipe.result_field] = out_vals
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipeBlockStats(Pipe):
    """Per-block per-column stats rows (reference pipe_block_stats.go:
    field/type/rows columns for storage debugging)."""

    name = "block_stats"

    def to_string(self):
        return "block_stats"

    def input_fields(self, out_needed):
        return {"*"}

    def make_processor(self, next_p):
        class P(Processor):
            def write_block(self, br):
                # fields-restricted views report like materialized blocks
                bs = br._bs if br._restrict is None else None
                rows_out = []
                if bs is not None:
                    part = bs.part
                    for name in bs.column_names():
                        meta = bs.column_meta(name)
                        vtype = "const" if meta is None else \
                            VT_NAMES[meta["t"]]
                        rows_out.append({
                            "field": name, "type": vtype,
                            "rows": str(bs.nrows),
                            "part_path": str(getattr(part, "path", "")
                                             or "inmemory")})
                else:
                    for name in br.column_names():
                        rows_out.append({"field": name, "type": "values",
                                         "rows": str(br.nrows),
                                         "part_path": ""})
                if rows_out:
                    names = ["field", "type", "rows", "part_path"]
                    cols = {n: [r[n] for r in rows_out] for n in names}
                    self.next_p.write_block(BlockResult.from_columns(cols))
        return P(next_p)


# ---------------- parsers + registration ----------------

def _parse_join(lex):
    from .parser import parse_query_in_parens
    if lex.is_keyword("by"):
        lex.next_token()
    by = _parse_paren_fields(lex)
    if not lex.is_keyword("("):
        raise ParseError("missing '(' with join query")
    q = parse_query_in_parens(lex)
    p = PipeJoin(by, q)
    if lex.is_keyword("inner"):
        p.inner = True
        lex.next_token()
    if lex.is_keyword("prefix"):
        lex.next_token()
        p.prefix = _parse_field_name(lex)
    return p


def _parse_union(lex):
    from .parser import parse_query_in_parens
    if not lex.is_keyword("("):
        raise ParseError("missing '(' with union query")
    return PipeUnion(parse_query_in_parens(lex))


def _parse_stream_context(lex):
    p = PipeStreamContext()
    while True:
        if lex.is_keyword("before"):
            lex.next_token()
            p.before = _parse_uint(lex, "before")
        elif lex.is_keyword("after"):
            lex.next_token()
            p.after = _parse_uint(lex, "after")
        elif lex.is_keyword("time_window"):
            lex.next_token()
            d = parse_duration(lex.token)
            if d is None or d <= 0:
                raise ParseError(f"bad time_window {lex.token!r}")
            p.time_window_ns = d
            lex.next_token()
        else:
            break
    return p


def _parse_collapse_nums(lex):
    iff = maybe_if(lex)
    p = PipeCollapseNums(iff=iff)
    if lex.is_keyword("at"):
        lex.next_token()
        p.field = _parse_field_name(lex)
    if lex.is_keyword("prettify"):
        p.prettify = True
        lex.next_token()
    return p


def _parse_decolorize(lex):
    p = PipeDecolorize()
    if lex.is_keyword("at"):
        lex.next_token()
        p.field = _parse_field_name(lex)
    return p


def _parse_fn_as(lex, cls, what: str):
    if not lex.is_keyword("("):
        raise ParseError(f"missing '(' after {what}")
    lex.next_token()
    fld = _parse_field_name(lex)
    if not lex.is_keyword(")"):
        raise ParseError(f"missing ')' after {what} field")
    lex.next_token()
    p = cls(fld)
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_field = _parse_field_name(lex)
    elif not lex.is_end() and not lex.is_keyword("|"):
        p.result_field = _parse_field_name(lex)
    return p


register_pipe("join", _parse_join)
register_pipe("union", _parse_union)
register_pipe("stream_context", _parse_stream_context)
register_pipe("collapse_nums", _parse_collapse_nums)
register_pipe("decolorize", _parse_decolorize)
register_pipe("hash", lambda lex: _parse_fn_as(lex, PipeHash, "hash"))
register_pipe("json_array_len",
              lambda lex: _parse_fn_as(lex, PipeJSONArrayLen,
                                       "json_array_len"))
register_pipe("block_stats", lambda lex: PipeBlockStats())
