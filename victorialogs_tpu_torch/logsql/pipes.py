"""LogsQL pipes of the slice: `| stats [by (...)] <funcs...>`, then
`limit`/`head`, `offset`/`skip` and `fields`/`keep` in any chain.

The stats processor groups rows by plain fields, `_time:<duration>`
buckets and numeric buckets (`by (dur:100 [offset 7])`), keeps one
state per group and function (logsql/stats_funcs.py), and at flush
emits one row per group in sorted key order.  Device runners bypass the
row path and hand it per-group partial states (`absorb_partials`),
which merge exactly like states updated from rows.

`limit` passes its first N rows and then reports itself done
(`Processor.is_done`), which stops the executor's part walk; `offset`
drops the first N rows; `fields` projects each block to its names
(a trailing `*` selects by prefix) without leaving the stored block,
so the NDJSON emit keeps its typed columns.  `compute_needed_fields`
tells the executor which fields the chain can read.

Stats functions: count, count_empty, count_uniq, sum, sum_len, min,
max, avg, median, quantile, rate and rate_sum.  Other LogsQL stats
functions, per-function `if (...)` guards, calendar `_time` buckets, a
`stats` pipe after another pipe and every other pipe raise
NotImplementedError; an unknown function name raises ParseError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..engine.block_result import BlockResult
from . import stats_funcs as sf
from .duration import format_rfc3339_many, parse_duration
from .lexer import quote_token_if_needed
from .matchers import parse_number


class ParseError(ValueError):
    pass


class Processor:
    def __init__(self, next_p):
        self.next_p = next_p

    def write_block(self, br: BlockResult) -> None:
        self.next_p.write_block(br)

    def flush(self) -> None:
        self.next_p.flush()

    def is_done(self) -> bool:
        """True once no further input can change the output."""
        return self.next_p.is_done() if self.next_p else False


class SinkProcessor(Processor):
    """Terminal processor: hands blocks to a callback."""

    def __init__(self, write_fn):
        super().__init__(None)
        self.write_fn = write_fn

    def write_block(self, br):
        self.write_fn(br)

    def flush(self):
        pass


@dataclass(repr=False)
class ByField:
    name: str
    bucket: str = ""       # `_time` duration or numeric step, e.g. "5m"
    bucket_offset: str = ""

    def to_string(self):
        s = self.name
        if self.bucket:
            s += f":{self.bucket}"
            if self.bucket_offset:
                s += f" offset {self.bucket_offset}"
        return s

    def step_ns(self) -> int:
        return parse_duration(self.bucket)

    def offset_ns(self) -> int:
        return parse_duration(self.bucket_offset) if self.bucket_offset \
            else 0

    def num_step(self) -> tuple[float, float] | None:
        """(step, offset) of a numeric bucket, or None when the step is
        not a positive number (the raw values are the keys then)."""
        step = parse_number(self.bucket)
        if math.isnan(step) or step <= 0:
            return None
        off = parse_number(self.bucket_offset) if self.bucket_offset \
            else 0.0
        return step, 0.0 if math.isnan(off) else off


@dataclass(repr=False)
class PipeStats:
    by: list            # list[ByField]
    funcs: list         # list[stats_funcs.StatsFunc]

    def to_string(self):
        s = "stats"
        if self.by:
            s += " by (" + ", ".join(b.to_string() for b in self.by) + ")"
        return s + " " + ", ".join(f.to_string() for f in self.funcs)

    def __repr__(self):
        return f"<pipe {self.to_string()}>"

    def input_fields(self, out_needed: set) -> set:
        # stats replaces the rows: only its keys and inputs are read
        out = {b.name for b in self.by}
        for fn in self.funcs:
            out |= set(fn.fields)
        return out

    def make_processor(self, next_p: Processor) -> "StatsProcessor":
        return StatsProcessor(self, next_p)


def _factorize(vals) -> tuple[np.ndarray, list]:
    """(int64 codes, distinct values in first-seen order)."""
    mapping: dict = {}
    codes = np.fromiter((mapping.setdefault(v, len(mapping)) for v in vals),
                        dtype=np.int64, count=len(vals))
    return codes, list(mapping)


def bucket_value(v: str, step: float, off: float) -> str:
    """The group key of value `v` under a numeric bucket: floor((v - off)
    / step) * step + off, or `v` itself when it is not a number."""
    f = parse_number(v)
    if math.isnan(f):
        return v
    return sf.format_number(math.floor((f - off) / step) * step + off)


class StatsProcessor(Processor):
    def __init__(self, pipe: PipeStats, next_p: Processor):
        super().__init__(next_p)
        self.pipe = pipe
        self.groups: dict[tuple, list] = {}   # key -> state per func

    def _key_codes(self, br: BlockResult, b: ByField):
        """(int64 code per row, distinct key values) of one by-field."""
        if b.bucket and b.name == "_time":
            step, off = b.step_ns(), b.offset_ns()
            uniq, inv = np.unique((br.timestamps_np() - off) // step * step
                                  + off, return_inverse=True)
            return inv.reshape(-1), format_rfc3339_many(uniq)
        ns = b.num_step() if b.bucket else None
        if ns is not None:
            step, off = ns
            num = br.numeric_column(b.name)
            if num is not None and not np.isnan(num).any():
                uniq, inv = np.unique(np.floor((num - off) / step) * step
                                      + off, return_inverse=True)
                keys = [sf.format_number(x) for x in uniq.tolist()]
                remap, values = _factorize(keys)
                return remap[inv.reshape(-1)], values
            return _factorize([bucket_value(v, step, off)
                               for v in br.column(b.name)])
        dc = br.dict_column(b.name)
        if dc is not None:
            ids, dvals = dc
            remap, values = _factorize(dvals)
            return remap[ids.astype(np.int64)], values
        return _factorize(br.column(b.name))

    def _row_groups(self, br: BlockResult):
        """[(key, row list)] of the block's rows, each list ascending."""
        n = br.nrows
        if not self.pipe.by:
            return [((), list(range(n)))]
        cols = [self._key_codes(br, b) for b in self.pipe.by]
        code = cols[0][0]
        for c, values in cols[1:]:
            code = code * len(values) + c
            code = np.unique(code, return_inverse=True)[1].reshape(-1)
        order = np.argsort(code, kind="stable")
        ends = np.cumsum(np.bincount(code))
        out = []
        start = 0
        for end in ends.tolist():
            if end == start:
                continue
            idxs = order[start:end]
            first = int(idxs[0])
            out.append((tuple(values[c[first]] for c, values in cols),
                        idxs.tolist()))
            start = end
        return out

    def _states(self, key: tuple) -> list:
        states = self.groups.get(key)
        if states is None:
            states = self.groups[key] = [fn.new_state()
                                         for fn in self.pipe.funcs]
        return states

    def write_block(self, br: BlockResult) -> None:
        if br.nrows == 0:
            return
        groups = self._row_groups(br)
        cols = [fn.block_cols(br) for fn in self.pipe.funcs]
        for key, idxs in groups:
            states = self._states(key)
            for k, fn in enumerate(self.pipe.funcs):
                states[k] = fn.update(states[k], cols[k], idxs)

    def absorb_partials(self, key: tuple, states: list) -> None:
        """Merge one group's partial states (a device cell, one per
        function) with the functions' own merge."""
        cur = self.groups.get(key)
        if cur is None:
            self.groups[key] = states
            return
        for k, fn in enumerate(self.pipe.funcs):
            cur[k] = fn.merge(cur[k], states[k])

    def flush(self) -> None:
        by_names = [b.name for b in self.pipe.by]
        keys = sorted(self.groups)
        cols: dict[str, list[str]] = {n: [] for n in by_names}
        for fn in self.pipe.funcs:
            cols[fn.out_name] = []
        for key in keys:
            for n, kv in zip(by_names, key):
                cols[n].append(kv)
            for fn, st in zip(self.pipe.funcs, self.groups[key]):
                cols[fn.out_name].append(fn.finalize(st))
        if not keys and not self.pipe.by:
            for fn in self.pipe.funcs:
                cols[fn.out_name].append(fn.finalize(fn.new_state()))
        self.next_p.write_block(BlockResult.from_columns(cols)
                                if any(cols.values()) else BlockResult(0))
        self.next_p.flush()


# ---------------- fields / limit / offset ----------------

def expand_field_patterns(patterns: list, names: list) -> list:
    """Trailing-`*` patterns expanded against the block's names."""
    out: dict[str, None] = {}
    for p in patterns:
        if p.endswith("*"):
            for n in names:
                if n.startswith(p[:-1]):
                    out.setdefault(n, None)
        else:
            out.setdefault(p, None)
    return list(out)


class _FieldsProcessor(Processor):
    def __init__(self, fields: list, next_p: Processor):
        super().__init__(next_p)
        self.fields = fields
        self.wildcard = any(f.endswith("*") for f in fields)

    def write_block(self, br):
        use = expand_field_patterns(self.fields, br.column_names()) \
            if self.wildcard else self.fields
        self.next_p.write_block(br.restrict_fields(use))


@dataclass(repr=False)
class PipeFields:
    fields: list

    def to_string(self):
        return "fields " + ", ".join(quote_token_if_needed(f)
                                     for f in self.fields)

    def input_fields(self, out_needed: set) -> set:
        if any(f.endswith("*") for f in self.fields):
            return {"*"}
        return set(self.fields)

    def make_processor(self, next_p: Processor) -> Processor:
        return _FieldsProcessor(self.fields, next_p)


def _head_rows(br: BlockResult, lo: int, hi: int) -> BlockResult:
    """Rows [lo, hi) of the block."""
    mask = np.zeros(br.nrows, dtype=bool)
    mask[lo:hi] = True
    return br.filter_rows(mask)


class _LimitProcessor(Processor):
    def __init__(self, limit: int, next_p: Processor):
        super().__init__(next_p)
        self.limit = limit
        self.seen = 0

    def write_block(self, br):
        if self.seen >= self.limit:
            return
        take = min(br.nrows, self.limit - self.seen)
        self.seen += take
        if take < br.nrows:
            br = _head_rows(br, 0, take)
        self.next_p.write_block(br)

    def is_done(self):
        return self.seen >= self.limit or super().is_done()


@dataclass(repr=False)
class PipeLimit:
    n: int

    def to_string(self):
        return f"limit {self.n}"

    def input_fields(self, out_needed: set) -> set:
        return out_needed

    def make_processor(self, next_p: Processor) -> Processor:
        return _LimitProcessor(self.n, next_p)


class _OffsetProcessor(Processor):
    def __init__(self, offset: int, next_p: Processor):
        super().__init__(next_p)
        self.offset = offset
        self.skipped = 0

    def write_block(self, br):
        if self.skipped >= self.offset:
            self.next_p.write_block(br)
            return
        skip = min(br.nrows, self.offset - self.skipped)
        self.skipped += skip
        if skip < br.nrows:
            self.next_p.write_block(_head_rows(br, skip, br.nrows))


@dataclass(repr=False)
class PipeOffset:
    n: int

    def to_string(self):
        return f"offset {self.n}"

    def input_fields(self, out_needed: set) -> set:
        return out_needed

    def make_processor(self, next_p: Processor) -> Processor:
        return _OffsetProcessor(self.n, next_p)


def compute_needed_fields(pipes: list) -> set:
    """The fields the chain can read from a stored block, back to front;
    a set holding "*" means all."""
    needed = {"*"}
    for p in reversed(pipes):
        needed = p.input_fields(needed)
    return needed


# ---------------- parsing ----------------

def parse_pipes(lex) -> list:
    pipes = []
    while True:
        name = lex.token.lower()
        if name == "stats":
            if pipes:
                raise NotImplementedError("a stats pipe after another pipe")
            lex.next_token()
            pipes.append(_parse_stats(lex))
        elif name == "count" and not pipes:
            lex.next_token()
            pipes.append(_parse_count_shorthand(lex))
        elif name in _PIPE_PARSERS:
            lex.next_token()
            pipes.append(_PIPE_PARSERS[name](lex))
        else:
            raise NotImplementedError(f"pipe {lex.token!r} is not supported")
        if not lex.is_keyword("|"):
            break
        lex.next_token()
    return pipes


def _parse_field_name(lex) -> str:
    from .parser import _get_compound_token
    return _get_compound_token(lex, stop=(",", "(", ")", "[", "]", "|",
                                          "*", ""))


def _parse_by_fields(lex) -> list:
    if not lex.is_keyword("("):
        raise ParseError("missing '(' after by")
    lex.next_token()
    out = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        bf = ByField(lex.token)
        lex.next_token()
        if lex.is_keyword(":"):
            lex.next_token()
            bf.bucket = lex.token
            lex.next_token()
            if lex.is_keyword("offset"):
                lex.next_token()
                bf.bucket_offset = lex.token
                lex.next_token()
            if bf.name == "_time" and (
                    not parse_duration(bf.bucket) or
                    parse_duration(bf.bucket) <= 0 or
                    (bf.bucket_offset and
                     parse_duration(bf.bucket_offset) is None)):
                raise NotImplementedError(
                    f"group-by bucket {bf.to_string()!r}: only "
                    f"_time:<duration> buckets are supported")
        out.append(bf)
    lex.next_token()
    return out


def _parse_uint(lex, what: str) -> int:
    v = parse_number(lex.token)
    if math.isnan(v) or v < 0 or v != int(v):
        raise ParseError(f"invalid {what} {lex.token!r}")
    lex.next_token()
    return int(v)


def _parse_field_list(lex) -> list:
    fields = []
    while True:
        name = _parse_field_name(lex)
        if lex.is_keyword("*") and not lex.is_skipped_space:
            name += "*"          # prefix selection: `fields req_*`
            lex.next_token()
        fields.append(name)
        if not lex.is_keyword(","):
            return fields
        lex.next_token()


_PIPE_PARSERS = {
    "fields": lambda lex: PipeFields(_parse_field_list(lex)),
    "keep": lambda lex: PipeFields(_parse_field_list(lex)),
    "limit": lambda lex: PipeLimit(_parse_uint(lex, "limit")),
    "head": lambda lex: PipeLimit(_parse_uint(lex, "limit")),
    "offset": lambda lex: PipeOffset(_parse_uint(lex, "offset")),
    "skip": lambda lex: PipeOffset(_parse_uint(lex, "offset")),
}


def _quantile_ctor(args):
    if len(args) < 2:
        raise ParseError("quantile(phi, field) expects 2+ args")
    phi = parse_number(args[0])
    if math.isnan(phi) or not 0 <= phi <= 1:
        raise ParseError(f"invalid quantile phi {args[0]!r}")
    return sf.StatsQuantile(phi, args[1:])


_STATS_FUNCS = {
    "count": sf.StatsCount,
    "count_empty": sf.StatsCountEmpty,
    "count_uniq": sf.StatsCountUniq,
    "sum": sf.StatsSum,
    "sum_len": sf.StatsSumLen,
    "min": sf.StatsMin,
    "max": sf.StatsMax,
    "avg": sf.StatsAvg,
    "median": sf.StatsMedian,
    "quantile": _quantile_ctor,
    "rate": sf.StatsRate,
    "rate_sum": sf.StatsRateSum,
}
# LogsQL functions the slice leaves out
_HOST_ONLY_FUNCS = ("count_uniq_hash", "uniq_values", "values", "histogram",
                    "row_any", "row_min", "row_max", "json_values")


def parse_stats_func(lex):
    name = lex.token.lower()
    ctor = _STATS_FUNCS.get(name)
    if ctor is None:
        if name in _HOST_ONLY_FUNCS:
            raise NotImplementedError(f"stats function {lex.token!r}")
        raise ParseError(f"unknown stats function {lex.token!r}")
    lex.next_token()
    if not lex.is_keyword("("):
        raise ParseError(f"missing '(' after {name}")
    lex.next_token()
    args = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(",", "*"):
            lex.next_token()
            continue
        args.append(_parse_field_name(lex))
    lex.next_token()
    fn = ctor(args)
    if lex.is_keyword("limit") and hasattr(fn, "limit"):
        lex.next_token()
        fn.limit = _parse_uint(lex, "limit")
    if lex.is_keyword("if"):
        raise NotImplementedError("stats modifier 'if'")
    if lex.is_keyword("as"):
        lex.next_token()
        fn.out_name = _parse_field_name(lex)
    elif not lex.is_end() and not lex.is_keyword(",", "|", ")", "by"):
        fn.out_name = _parse_field_name(lex)
    return fn


def _parse_stats(lex) -> PipeStats:
    by = []
    if lex.is_keyword("by"):
        lex.next_token()
        by = _parse_by_fields(lex)
    funcs = [parse_stats_func(lex)]
    while lex.is_keyword(","):
        lex.next_token()
        funcs.append(parse_stats_func(lex))
    if lex.is_keyword("by") and not by:
        lex.next_token()
        by = _parse_by_fields(lex)
    return PipeStats(by, funcs)


def _parse_count_shorthand(lex) -> PipeStats:
    """`| count()` == `| stats count()`."""
    if lex.is_keyword("("):
        lex.next_token()
        if not lex.is_keyword(")"):
            raise ParseError("count() takes no args")
        lex.next_token()
    fn = sf.StatsCount([])
    if lex.is_keyword("as"):
        lex.next_token()
        fn.out_name = _parse_field_name(lex)
    return PipeStats([], [fn])
