"""LogsQL pipes of the port: `stats`, `limit`/`head`, `offset`/`skip`,
`fields`/`keep`, `delete` (`del`, `rm`, `drop`), `copy` (`cp`), `rename`
(`mv`), `where` (`filter`), `sort` (`order`) with `first`/`last`, and
`uniq`, in any chain.

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

`delete` projects like `fields`; `copy` and `rename` rewrite columns on
a detached copy of the block.  `where` filters the rows in the chain:
a stored block through the filter's block evaluation, any other batch
through `Filter.apply_to_values`.  `sort` orders rows with
`_cmp_values` (numbers as numbers, then RFC3339 times, then strings;
ties by arrival order); with `limit` it keeps only offset + limit rows
(`first N by (...)` and `last N by (...)` are `sort ... limit N`), with
`partition by` it sorts each partition apart.  `uniq` keeps the
distinct (field, value) tuples, optionally with their counts.  The
state of `sort` and `uniq` is charged to a memory budget
(utils/memory.py).  Device runners may prefilter a `sort ... limit`
(gpu/sort_device.py): the processor then sees a superset of the rows
that can reach its output, in the same order.

Stats functions: every one of logsql/stats_funcs.py, each optionally
guarded by `if (filter)` (it then sees only the rows the filter keeps).
`_time` buckets are durations or the calendar's `week` (starting on
Monday), `month` and `year` (`truncate_timestamps`).

The transform pipes (`extract`, `format`, `math`, `unpack_*`, `top`,
...; logsql/pipes_transform.py) and the auxiliary ones (`join`,
`union`, `stream_context`, `collapse_nums`, ...; logsql/pipes_aux.py)
register their parsers here (`register_pipe`).  An unknown pipe or
stats function name raises ParseError.
"""

from __future__ import annotations

import datetime
import heapq
import math
from dataclasses import dataclass, field as dc_field
from functools import cmp_to_key, lru_cache

import numpy as np

from ..engine.block_result import BlockResult
from ..utils.memory import MemoryBudget
from . import stats_funcs as sf
from .duration import format_rfc3339_many, parse_duration, parse_rfc3339
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


class Pipe:
    """A pipe passes through the fields its output needs plus its own."""

    def needed_fields(self) -> set:
        return set()

    def input_fields(self, out_needed: set) -> set:
        return out_needed | self.needed_fields()

    def __repr__(self):
        return f"<pipe {self.to_string()}>"


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

    def offset_ns(self) -> int:
        """The offset in ns; 0 when absent or not a duration."""
        d = parse_duration(self.bucket_offset) if self.bucket_offset \
            else None
        return d if d is not None else 0

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
class PipeStats(Pipe):
    by: list            # list[ByField]
    funcs: list         # list[stats_funcs.StatsFunc]

    def to_string(self):
        s = "stats"
        if self.by:
            s += " by (" + ", ".join(b.to_string() for b in self.by) + ")"
        return s + " " + ", ".join(f.to_string() for f in self.funcs)

    def input_fields(self, out_needed: set) -> set:
        # stats replaces the rows: only its keys and inputs are read
        out = {b.name for b in self.by}
        for fn in self.funcs:
            out |= fn.needed_fields()
        return out

    def make_processor(self, next_p: Processor) -> "StatsProcessor":
        return StatsProcessor(self, next_p)


def _factorize(vals) -> tuple[np.ndarray, list]:
    """(int64 codes, distinct values in first-seen order)."""
    mapping: dict = {}
    codes = np.fromiter((mapping.setdefault(v, len(mapping)) for v in vals),
                        dtype=np.int64, count=len(vals))
    return codes, list(mapping)


_NS_DAY = 86400 * 1_000_000_000


def _calendar_start(ts: int, name: str, off: int) -> int:
    """The start of `ts`'s month or year (`name`) after moving it back by
    `off` ns, plus `off`; through float seconds rounded to microseconds,
    as in the JAX package."""
    utc = datetime.timezone.utc
    dt = datetime.datetime.fromtimestamp((ts - off) / 1e9, tz=utc)
    start = datetime.datetime(dt.year, dt.month if name == "month" else 1,
                              1, tzinfo=utc)
    return int(start.timestamp()) * 1_000_000_000 + off


def truncate_timestamps(ts: np.ndarray, b: ByField) -> np.ndarray | None:
    """The start of each int64 timestamp's `_time` bucket: fixed-size
    buckets and the calendar's weeks (from Monday), months and years;
    None when the bucket is neither.  Months and years come from each
    row's UTC day; a row in the last millisecond of its day takes
    `_calendar_start`, whose microsecond rounding may carry it into the
    next day."""
    name = b.bucket.lower()
    off = b.offset_ns()
    if name in ("month", "year"):
        t = ts - off
        day = t // _NS_DAY
        unit = "datetime64[M]" if name == "month" else "datetime64[Y]"
        out = day.astype("datetime64[D]").astype(unit).astype(
            "datetime64[D]").astype(np.int64) * _NS_DAY + off
        for i in np.nonzero(t - day * _NS_DAY >= _NS_DAY - 1_000_000)[0]:
            out[i] = _calendar_start(int(ts[i]), name, off)
        return out
    if name == "week":
        # epoch day 0 was a Thursday
        off, step = off + 4 * _NS_DAY, 7 * _NS_DAY
    else:
        step = parse_duration(b.bucket)
        if not step:
            return None
    return (ts - off) // step * step + off


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
        self.budget = MemoryBudget(0.3, "stats")
        for fn in pipe.funcs:
            fn.budget = self.budget

    def _key_codes(self, br: BlockResult, b: ByField):
        """(int64 code per row, distinct key values) of one by-field."""
        if b.bucket and b.name == "_time":
            ts = br.timestamps_np()
            starts = None if ts is None else truncate_timestamps(ts, b)
            if starts is None:
                # no timestamps (a batch a pipe built) or no bucket: the
                # rows' `_time` values are the keys, as in the JAX package
                return _factorize(br.column("_time"))
            uniq, inv = np.unique(starts, return_inverse=True)
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
            self.budget.add(sum(len(k) for k in key) + 80)
        return states

    def write_block(self, br: BlockResult) -> None:
        if br.nrows == 0:
            return
        groups = self._row_groups(br)
        cols = [fn.block_cols(br) for fn in self.pipe.funcs]
        masks = [if_mask(fn.iff, br) for fn in self.pipe.funcs]
        for key, idxs in groups:
            states = self._states(key)
            for k, fn in enumerate(self.pipe.funcs):
                use = idxs if masks[k] is None else \
                    [i for i in idxs if masks[k][i]]
                states[k] = fn.update(states[k], cols[k], use)

    def absorb_partials(self, key: tuple, states: list) -> None:
        """Merge one group's partial states (a device cell, one per
        function) with the functions' own merge."""
        cur = self.groups.get(key)
        if cur is None:
            self.groups[key] = states
            self.budget.add(sum(len(k) for k in key) + 80)
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


# ---------------- `if (filter)` guards ----------------

def parse_if_filter(lex):
    """`if (filter)`, the lexer on `if`."""
    lex.next_token()
    if not lex.is_keyword("("):
        raise ParseError("missing '(' after if")
    lex.next_token()
    from .parser import parse_filter_or
    f = parse_filter_or(lex, "")
    if not lex.is_keyword(")"):
        raise ParseError("missing ')' after if filter")
    lex.next_token()
    return f


def maybe_if(lex):
    return parse_if_filter(lex) if lex.is_keyword("if") else None


def if_str(iff) -> str:
    return f" if ({iff.to_string()})" if iff is not None else ""


def if_mask(iff, br: BlockResult):
    """bool per row of the block that the guard keeps, or None."""
    if iff is None:
        return None
    return iff.apply_to_values(br.column, br.nrows)


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
class PipeFields(Pipe):
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
class PipeLimit(Pipe):
    n: int

    def to_string(self):
        return f"limit {self.n}"

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
class PipeOffset(Pipe):
    n: int

    def to_string(self):
        return f"offset {self.n}"

    def make_processor(self, next_p: Processor) -> Processor:
        return _OffsetProcessor(self.n, next_p)


# ---------------- delete / copy / rename ----------------

class _DeleteProcessor(Processor):
    def __init__(self, fields: list, next_p: Processor):
        super().__init__(next_p)
        self.drop = set(fields)

    def write_block(self, br):
        self.next_p.write_block(br.restrict_fields(
            [n for n in br.column_names() if n not in self.drop]))


@dataclass(repr=False)
class PipeDelete(Pipe):
    fields: list

    def to_string(self):
        return "delete " + ", ".join(quote_token_if_needed(f)
                                     for f in self.fields)

    def input_fields(self, out_needed: set) -> set:
        if "*" in out_needed:
            return out_needed
        return out_needed - set(self.fields)

    def make_processor(self, next_p: Processor) -> Processor:
        return _DeleteProcessor(self.fields, next_p)


class _CopyProcessor(Processor):
    def __init__(self, pairs: list, next_p: Processor):
        super().__init__(next_p)
        self.pairs = pairs

    def write_block(self, br):
        out = br.materialize()
        for s, d in self.pairs:
            out._cols[d] = list(br.column(s))
        self.next_p.write_block(out)


@dataclass(repr=False)
class PipeCopy(Pipe):
    pairs: list         # [(src, dst)]

    def to_string(self):
        return "copy " + ", ".join(f"{s} as {d}" for s, d in self.pairs)

    def input_fields(self, out_needed: set) -> set:
        # every pair reads its src from the incoming block: a needed dst
        # needs its src as it was, not through an earlier pair
        if "*" in out_needed:
            return out_needed
        out = set(out_needed)
        for _s, d in self.pairs:
            out.discard(d)
        for s, d in self.pairs:
            if d in out_needed:
                out.add(s)
        return out

    def make_processor(self, next_p: Processor) -> Processor:
        return _CopyProcessor(self.pairs, next_p)


class _RenameProcessor(Processor):
    def __init__(self, pairs: list, next_p: Processor):
        super().__init__(next_p)
        self.pairs = pairs

    def write_block(self, br):
        out = br.materialize()
        for s, d in self.pairs:
            vals = out._cols.pop(s, None)
            if vals is None:
                vals = br.column(s)
            out._cols[d] = vals
        self.next_p.write_block(out)


@dataclass(repr=False)
class PipeRename(Pipe):
    pairs: list         # [(src, dst)]

    def to_string(self):
        return "rename " + ", ".join(f"{s} as {d}" for s, d in self.pairs)

    def input_fields(self, out_needed: set) -> set:
        # a needed dst maps back to its src; the src itself is gone
        # downstream
        if "*" in out_needed:
            return out_needed
        out = set(out_needed)
        for s, d in reversed(self.pairs):
            if d in out:
                out.discard(d)
                out.add(s)
            else:
                out.discard(s)
        return out

    def make_processor(self, next_p: Processor) -> Processor:
        return _RenameProcessor(self.pairs, next_p)


# ---------------- where ----------------

class _WhereProcessor(Processor):
    def __init__(self, flt, next_p: Processor):
        super().__init__(next_p)
        self.flt = flt

    def write_block(self, br):
        bs = br._bs
        # a projected batch never takes the block path: a projected-out
        # field must read "" there, not its stored value
        if bs is not None and not br._cols and br._restrict is None:
            full = np.ones(bs.nrows, dtype=bool)
            self.flt.apply_to_block(bs, full)
            mask = full[br._sel]
        else:
            mask = self.flt.apply_to_values(br.column, br.nrows)
        if mask.all():
            self.next_p.write_block(br)
        elif mask.any():
            self.next_p.write_block(br.filter_rows(mask))


@dataclass(repr=False)
class PipeWhere(Pipe):
    filter: object      # logsql.filters.Filter

    def to_string(self):
        return f"filter {self.filter.to_string()}"

    def needed_fields(self) -> set:
        return self.filter.needed_fields()

    def make_processor(self, next_p: Processor) -> Processor:
        return _WhereProcessor(self.filter, next_p)


# ---------------- sort ----------------

# a sort compares each value many times: parse each distinct one once
_sort_number = lru_cache(maxsize=1 << 16)(parse_number)


def _cmp_values(a: str, b: str) -> int:
    """Numbers before other values and by value, then RFC3339 times by
    time, then strings."""
    fa, fb = _sort_number(a), _sort_number(b)
    na, nb = not math.isnan(fa), not math.isnan(fb)
    if na and nb:
        if fa != fb:
            return -1 if fa < fb else 1
        return -1 if a < b else (1 if a > b else 0)
    if na:
        return -1
    if nb:
        return 1
    if a and b and a[0].isdigit() and b[0].isdigit():
        # RFC3339 trims trailing fraction zeros: "..00Z" sorts after
        # "..00.5Z" as a string
        ta, tb = parse_rfc3339(a), parse_rfc3339(b)
        if ta is not None and tb is not None and ta != tb:
            return -1 if ta < tb else 1
    return -1 if a < b else (1 if a > b else 0)


def _block_rows_cost(cols) -> int:
    return sum(sum(len(v) + 8 for v in vals) for vals in cols) + 64


def _columns_of(rows: list, names_of, values_of) -> dict:
    """{name: values} over rows holding different column sets ("" where
    a row lacks the name)."""
    names: dict[str, None] = {}
    for r in rows:
        for n in names_of(r):
            names.setdefault(n, None)
    return {n: [values_of(r, n) for r in rows] for n in names}


class _SortProcessor(Processor):
    """The whole input, sorted at flush."""

    def __init__(self, pipe, next_p: Processor):
        super().__init__(next_p)
        self.pipe = pipe
        self.blocks: list = []
        self.budget = MemoryBudget(0.2, "sort")

    def write_block(self, br):
        br = br.materialize()
        self.budget.add(_block_rows_cost(br._cols.values()))
        self.blocks.append(br)

    def flush(self):
        pipe = self.pipe
        rows = []           # (sort key values, block idx, row idx)
        for bi, br in enumerate(self.blocks):
            cols = [br.column(f) for f, _ in pipe.by]
            for ri in range(br.nrows):
                rows.append(([c[ri] for c in cols], bi, ri))
        rows.sort(key=cmp_to_key(pipe._sort_cmp()))
        if pipe.offset:
            rows = rows[pipe.offset:]
        if pipe.limit:
            rows = rows[:pipe.limit]
        names: dict[str, None] = {}
        for br in self.blocks:
            for n in br.column_names():
                names.setdefault(n, None)
        out = {n: [self.blocks[bi].column(n)[ri] for _k, bi, ri in rows]
               for n in names}
        if pipe.rank_field:
            out[pipe.rank_field] = [str(pipe.offset + 1 + i)
                                    for i in range(len(rows))]
        if rows or not self.blocks:
            self.next_p.write_block(BlockResult.from_columns(out)
                                    if out else BlockResult(0))
        self.blocks = []
        self.next_p.flush()


class _TopKProcessor(Processor):
    """`sort ... limit N`: only the offset + N best rows so far, each
    (key values, arrival seq, name -> index, values).  A block's rows
    compete by their keys alone; only the winners copy their values."""

    def __init__(self, pipe, next_p: Processor):
        super().__init__(next_p)
        self.pipe = pipe
        self.k = pipe.limit + pipe.offset
        self.key = cmp_to_key(pipe._sort_cmp())
        self.top: list = []
        self.seq = 0

    def _contenders(self, br):
        """The block's rows that can be among its k best: all of them, or
        where the one sort field is a stored numeric column (finite
        numbers, each what its string parses to), those whose number is
        at least the block's k-th best: `_cmp_values` puts a strictly
        worse number after k rows of this block."""
        by = self.pipe.by
        if len(by) != 1 or br.nrows <= self.k:
            return range(br.nrows)
        f = br.numeric_column(by[0][0])
        if f is None:
            return range(br.nrows)
        if by[0][1] != self.pipe.desc:
            f = -f
        kth = np.partition(f, self.k - 1)[self.k - 1]
        return np.nonzero(f <= kth)[0].tolist()

    def write_block(self, br):
        cols = [br.column(f) for f, _ in self.pipe.by]
        seq0 = self.seq
        self.seq += br.nrows
        # (keys, seq, None, row index) until the row wins a place
        rows = [([c[ri] for c in cols], seq0 + ri, None, ri)
                for ri in self._contenders(br)]
        key = self.key
        top = heapq.nsmallest(self.k, self.top + rows,
                              key=lambda r: (key(r), r[1]))
        if any(r[2] is None for r in top):
            names = br.column_names()
            all_cols = [br.column(n) for n in names]
            idx = {n: j for j, n in enumerate(names)}
            top = [r if r[2] is not None else
                   (r[0], r[1], idx, [v[r[3]] for v in all_cols])
                   for r in top]
        self.top = top

    def flush(self):
        pipe = self.pipe
        rows = self.top[pipe.offset:]
        out = _columns_of(rows, lambda r: r[2],
                          lambda r, n: r[3][r[2][n]] if n in r[2] else "")
        if pipe.rank_field:
            out[pipe.rank_field] = [str(pipe.offset + 1 + i)
                                    for i in range(len(rows))]
        self.next_p.write_block(BlockResult.from_columns(out)
                                if out else BlockResult(0))
        self.top = []
        self.next_p.flush()


class _PartitionedSortProcessor(Processor):
    """`sort ... partition by (...)`: offset and limit apply to each
    partition's rows."""

    def __init__(self, pipe, next_p: Processor):
        super().__init__(next_p)
        self.pipe = pipe
        self.key = cmp_to_key(pipe._sort_cmp())
        self.budget = MemoryBudget(0.2, "sort")
        self.groups: dict[tuple, list] = {}  # key -> [(keys, seq, row)]
        self.seq = 0

    def write_block(self, br):
        pipe = self.pipe
        cols = [br.column(f) for f, _ in pipe.by]
        pcols = [br.column(f) for f in pipe.partition_by]
        all_cols = [(n, br.column(n)) for n in br.column_names()]
        self.budget.add(_block_rows_cost(v for _n, v in all_cols))
        for ri in range(br.nrows):
            pkey = tuple(c[ri] for c in pcols)
            self.groups.setdefault(pkey, []).append(
                ([c[ri] for c in cols], self.seq,
                 {n: v[ri] for n, v in all_cols}))
            self.seq += 1

    def flush(self):
        pipe = self.pipe
        key = self.key
        out_rows: list[dict] = []
        for pkey in sorted(self.groups):
            rows = sorted(self.groups[pkey], key=lambda r: (key(r), r[1]))
            if pipe.offset:
                rows = rows[pipe.offset:]
            if pipe.limit:
                rows = rows[:pipe.limit]
            for i, (_k, _s, rd) in enumerate(rows):
                if pipe.rank_field:
                    rd = {**rd, pipe.rank_field: str(pipe.offset + 1 + i)}
                out_rows.append(rd)
        out = _columns_of(out_rows, lambda rd: rd,
                          lambda rd, n: rd.get(n, ""))
        self.next_p.write_block(BlockResult.from_columns(out)
                                if out_rows else BlockResult(0))
        self.groups = {}
        self.next_p.flush()


@dataclass(repr=False)
class PipeSort(Pipe):
    by: list                    # [(field, desc)]
    desc: bool = False          # reverses the whole order
    limit: int = 0
    offset: int = 0
    rank_field: str = ""
    partition_by: list = dc_field(default_factory=list)

    def to_string(self):
        s = "sort"
        if self.by:
            s += " by (" + ", ".join(
                f + (" desc" if d else "") for f, d in self.by) + ")"
        if self.desc:
            s += " desc"
        if self.partition_by:
            s += " partition by (" + ", ".join(self.partition_by) + ")"
        if self.offset:
            s += f" offset {self.offset}"
        if self.limit:
            s += f" limit {self.limit}"
        if self.rank_field:
            s += f" rank as {self.rank_field}"
        return s

    def needed_fields(self) -> set:
        return {f for f, _ in self.by} | set(self.partition_by)

    def _sort_cmp(self):
        by, desc = self.by, self.desc

        def cmp(x, y):
            # a field's desc flag XOR the global one
            for k, (_f, d) in enumerate(by):
                c = _cmp_values(x[0][k], y[0][k])
                if c:
                    return -c if d != desc else c
            return 0
        return cmp

    def make_processor(self, next_p: Processor) -> Processor:
        if self.partition_by:
            return _PartitionedSortProcessor(self, next_p)
        if self.limit > 0:
            return _TopKProcessor(self, next_p)
        return _SortProcessor(self, next_p)


# ---------------- uniq ----------------

class _UniqProcessor(Processor):
    """Distinct tuples of (field, value) pairs, empty values left out,
    so that blocks with different column sets mix."""

    def __init__(self, pipe, next_p: Processor):
        super().__init__(next_p)
        self.pipe = pipe
        self.seen: dict[tuple, int] = {}
        self.budget = MemoryBudget(0.4, "uniq")

    def _exceeded(self) -> bool:
        return bool(self.pipe.limit) and len(self.seen) > self.pipe.limit

    def _count(self, key: tuple, n: int) -> None:
        if key in self.seen:
            self.seen[key] += n
        else:
            self.seen[key] = n
            self.budget.add(sum(len(f) + len(v) for f, v in key) + 80)

    def write_block(self, br):
        if self._exceeded():
            return
        by = self.pipe.by
        if len(by) == 1:
            pairs = br.dict_value_counts(by[0])
            if pairs is not None:
                for v, cnt in pairs:
                    self._count(((by[0], v),) if v != "" else (), cnt)
                return
        cols = [(f, br.column(f)) for f in (by or br.column_names())]
        for ri in range(br.nrows):
            self._count(tuple((f, c[ri]) for f, c in cols if c[ri] != ""),
                        1)

    def is_done(self):
        # past its limit no input changes the output
        return self._exceeded() or super().is_done()

    def flush(self):
        pipe = self.pipe
        exceeded = self._exceeded()
        keys = sorted(self.seen)
        if pipe.limit:
            keys = keys[:pipe.limit]
        names: dict[str, None] = dict.fromkeys(pipe.by)
        for k in keys:
            for f, _v in k:
                names.setdefault(f, None)
        cols = {f: [dict(k).get(f, "") for k in keys] for f in names}
        if pipe.with_hits:
            # past the limit the counts are incomplete: 0, as in the
            # reference
            cols["hits"] = ["0" if exceeded else str(self.seen[k])
                            for k in keys]
        self.next_p.write_block(BlockResult.from_columns(cols)
                                if keys else BlockResult(0))
        self.next_p.flush()


@dataclass(repr=False)
class PipeUniq(Pipe):
    by: list
    limit: int = 0
    with_hits: bool = False

    def to_string(self):
        s = "uniq"
        if self.by:
            s += " by (" + ", ".join(self.by) + ")"
        if self.with_hits:
            s += " with hits"
        if self.limit:
            s += f" limit {self.limit}"
        return s

    def input_fields(self, out_needed: set) -> set:
        return set(self.by) if self.by else {"*"}

    def make_processor(self, next_p: Processor) -> Processor:
        return _UniqProcessor(self, next_p)


def compute_needed_fields(pipes: list) -> set:
    """The fields the chain can read from a stored block, back to front;
    a set holding "*" means all."""
    needed = {"*"}
    for p in reversed(pipes):
        needed = p.input_fields(needed)
        if "*" in needed:
            needed = {"*"} | needed
    return needed


# ---------------- parsing ----------------

def parse_pipes(lex) -> list:
    pipes = []
    while True:
        parse = _PIPE_PARSERS.get(lex.token.lower())
        if parse is None:
            raise ParseError(f"unknown pipe {lex.token!r}")
        lex.next_token()
        pipes.append(parse(lex))
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


def _parse_paren_fields(lex) -> list:
    if not lex.is_keyword("("):
        raise ParseError("missing '('")
    lex.next_token()
    out = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        name = _parse_field_name(lex)
        if lex.is_keyword("*") and not lex.is_skipped_space:
            name += "*"          # wildcard: `fields (req_*)`
            lex.next_token()
        out.append(name)
    lex.next_token()
    return out


def _parse_as_pairs(lex) -> list:
    pairs = []
    while True:
        src = _parse_field_name(lex)
        if lex.is_keyword("as"):
            lex.next_token()
        pairs.append((src, _parse_field_name(lex)))
        if not lex.is_keyword(","):
            return pairs
        lex.next_token()


def _parse_where(lex) -> PipeWhere:
    from .parser import parse_filter_or
    return PipeWhere(parse_filter_or(lex, ""))


def _parse_sort_fields(lex, what: str, asc_keyword: bool) -> list:
    """`(f1 [desc], f2, ...)` -> [(field, desc)]."""
    if not lex.is_keyword("("):
        raise ParseError(f"missing '(' after {what}")
    lex.next_token()
    by = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        f = _parse_field_name(lex)
        desc = False
        if lex.is_keyword("desc"):
            desc = True
            lex.next_token()
        elif asc_keyword and lex.is_keyword("asc"):
            lex.next_token()
        by.append((f, desc))
    lex.next_token()
    return by


def _parse_sort(lex) -> PipeSort:
    by = []
    if lex.is_keyword("by"):
        lex.next_token()
        by = _parse_sort_fields(lex, "sort by", True)
    p = PipeSort(by)
    while True:
        if lex.is_keyword("desc"):
            p.desc = True
            lex.next_token()
        elif lex.is_keyword("asc"):
            lex.next_token()
        elif lex.is_keyword("limit"):
            lex.next_token()
            p.limit = _parse_uint(lex, "limit")
        elif lex.is_keyword("offset"):
            lex.next_token()
            p.offset = _parse_uint(lex, "offset")
        elif lex.is_keyword("rank"):
            lex.next_token()
            if lex.is_keyword("as"):
                lex.next_token()
            p.rank_field = _parse_field_name(lex)
        elif lex.is_keyword("partition"):
            lex.next_token()
            if lex.is_keyword("by"):
                lex.next_token()
            if not lex.is_keyword("("):
                raise ParseError("missing '(' after partition by")
            lex.next_token()
            while not lex.is_keyword(")"):
                if lex.is_keyword(","):
                    lex.next_token()
                    continue
                p.partition_by.append(_parse_field_name(lex))
            lex.next_token()
        else:
            return p


def _parse_first_last(lex, desc: bool) -> PipeSort:
    """`first N by (f)` == `sort by (f) limit N`; `last` sorts desc.
    Without `by` the rows sort by `_time`."""
    n = 1
    if not lex.is_keyword("by") and not lex.is_end() and \
            not lex.is_keyword("|"):
        n = _parse_uint(lex, "first/last count")
    by = []
    if lex.is_keyword("by"):
        lex.next_token()
        by = _parse_sort_fields(lex, "by", False)
    return PipeSort(by or [("_time", False)], desc=desc, limit=n)


def _parse_uniq(lex) -> PipeUniq:
    by = []
    if lex.is_keyword("by"):
        lex.next_token()
        by = [b.name for b in _parse_by_fields(lex)]
    p = PipeUniq(by)
    while True:
        if lex.is_keyword("with"):
            lex.next_token()
            if lex.is_keyword("hits"):
                p.with_hits = True
                lex.next_token()
        elif lex.is_keyword("limit"):
            lex.next_token()
            p.limit = _parse_uint(lex, "limit")
        else:
            return p


def _parse_fields(lex) -> PipeFields:
    return PipeFields(_parse_field_list(lex))


def _parse_delete(lex) -> PipeDelete:
    return PipeDelete(_parse_field_list(lex))


def _parse_copy(lex) -> PipeCopy:
    return PipeCopy(_parse_as_pairs(lex))


def _parse_rename(lex) -> PipeRename:
    return PipeRename(_parse_as_pairs(lex))


def _parse_limit(lex) -> PipeLimit:
    return PipeLimit(_parse_uint(lex, "limit"))


def _parse_offset(lex) -> PipeOffset:
    return PipeOffset(_parse_uint(lex, "offset"))


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
    "count_uniq_hash": sf.StatsCountUniqHash,
    "uniq_values": sf.StatsUniqValues,
    "values": sf.StatsValues,
    "histogram": sf.StatsHistogram,
    "row_any": sf.StatsRowAny,
    "row_min": sf.StatsRowMin,
    "row_max": sf.StatsRowMax,
    "json_values": sf.StatsJSONValues,
}


def parse_stats_func(lex):
    name = lex.token.lower()
    ctor = _STATS_FUNCS.get(name)
    if ctor is None:
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
        fn.iff = parse_if_filter(lex)
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


_PIPE_PARSERS = {
    "fields": _parse_fields,
    "keep": _parse_fields,
    "delete": _parse_delete,
    "del": _parse_delete,
    "rm": _parse_delete,
    "drop": _parse_delete,
    "copy": _parse_copy,
    "cp": _parse_copy,
    "rename": _parse_rename,
    "mv": _parse_rename,
    "limit": _parse_limit,
    "head": _parse_limit,
    "offset": _parse_offset,
    "skip": _parse_offset,
    "where": _parse_where,
    "filter": _parse_where,
    "sort": _parse_sort,
    "order": _parse_sort,
    "uniq": _parse_uniq,
    "stats": _parse_stats,
    "count": _parse_count_shorthand,
    "first": lambda lex: _parse_first_last(lex, desc=False),
    "last": lambda lex: _parse_first_last(lex, desc=True),
}


def register_pipe(name: str, parse_fn) -> None:
    _PIPE_PARSERS[name] = parse_fn


# the transform and auxiliary pipes register themselves on import, once
# the registry exists
from . import pipes_transform  # noqa: E402,F401
from . import pipes_aux        # noqa: E402,F401
