"""LogsQL parser: query -> (options, filter tree, pipes).

Implicit AND between adjacent filters, `or`/`and`/`not` (`!`, `-`),
parentheses, `field:filter` scoping, compound phrases glued from
adjacent unspaced tokens, `*`, `prefix*`, `=exact`, `=prefix*`,
`~"regexp"`, the numeric comparisons `>`, `>=`, `<`, `<=`, the
function filters (`in`, `contains_all`, `contains_any`, `seq`,
`range`, `len_range`, `string_range`, `ipv4_range`, `value_type`,
`eq_field`, `le_field`, `lt_field`, `exact`, `re`, `i`; `in` and
`contains_*` also over a `(subquery | fields x)`), `{...}` stream
filters, `_stream_id:`, `_time:` filters (ranges, durations, numeric
unix bounds, `day_range`, `week_range`, `offset`), a leading
`options(...)` and the trailing pipes (logsql/pipes.py and the
modules that register pipes there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

from ..storage.stream_filter import StreamFilter, TagFilter
from .duration import NS, parse_duration, ts_bounds
from .filters import (Filter, FilterAnd, FilterAnyCasePhrase,
                      FilterAnyCasePrefix, FilterContainsAll,
                      FilterContainsAny, FilterDayRange, FilterEqField,
                      FilterExact, FilterExactPrefix, FilterIn,
                      FilterIPv4Range, FilterLeField, FilterLenRange,
                      FilterNoop, FilterNot, FilterOr, FilterPhrase,
                      FilterPrefix, FilterRange, FilterRegexp,
                      FilterSequence, FilterStream, FilterStreamID,
                      FilterStringRange, FilterTime, FilterValueType,
                      FilterWeekRange)
from .lexer import Lexer
from .matchers import parse_ipv4, parse_number
from .pipes import ParseError, parse_pipes

MAX_TS = (1 << 63) - 1
MIN_TS = -(1 << 63)


@dataclass
class QueryOptions:
    concurrency: int = 0
    ignore_global_time_filter: bool = False


@dataclass
class Query:
    filter: Filter
    pipes: list = dc_field(default_factory=list)
    opts: QueryOptions = dc_field(default_factory=QueryOptions)
    timestamp: int | None = None

    def to_string(self) -> str:
        s = self.filter.to_string()
        for p in self.pipes:
            s += f" | {p.to_string()}"
        return s

    def add_time_filter(self, start_ns: int, end_ns: int) -> None:
        """AND `_time:[start_ns, end_ns]` (inclusive) into the filter."""
        tf = FilterTime(min_ts=start_ns, max_ts=end_ns)
        if isinstance(self.filter, FilterAnd):
            self.filter.filters.insert(0, tf)
        else:
            self.filter = FilterAnd([tf, self.filter])

    def get_time_range(self) -> tuple[int, int]:
        """Overall [min_ts, max_ts] from the top-level AND-ed time
        filters."""
        return _filter_time_range(self.filter)


def _filter_time_range(f: Filter) -> tuple[int, int]:
    if isinstance(f, FilterTime):
        return f.min_ts, f.max_ts
    if isinstance(f, FilterAnd):
        lo, hi = MIN_TS, MAX_TS
        for sub in f.filters:
            slo, shi = _filter_time_range(sub)
            lo, hi = max(lo, slo), min(hi, shi)
        return lo, hi
    if isinstance(f, FilterOr):
        lo, hi = MAX_TS, MIN_TS
        for sub in f.filters:
            slo, shi = _filter_time_range(sub)
            lo, hi = min(lo, slo), max(hi, shi)
        return (MIN_TS, MAX_TS) if lo > hi else (lo, hi)
    return MIN_TS, MAX_TS


def parse_query(s: str, timestamp: int | None = None) -> Query:
    lex = Lexer(s, timestamp=timestamp)
    q = _parse_query_internal(lex)
    if not lex.is_end():
        raise ParseError(f"unexpected trailing token {lex.token!r} "
                         f"near ...{lex.context()}")
    return q


def parse_query_in_parens(lex: Lexer) -> Query:
    """`(query)` of the join and union pipes."""
    if not lex.is_keyword("("):
        raise ParseError("missing '('")
    lex.next_token()
    q = _parse_query_internal(lex)
    if not lex.is_keyword(")"):
        raise ParseError("missing ')' after query")
    lex.next_token()
    return q


def parse_filter_string(s: str) -> Filter:
    """A standalone filter expression (`extra_filters`)."""
    lex = Lexer(s)
    f = parse_filter_or(lex, "")
    if not lex.is_end():
        raise ParseError(f"unexpected trailing token {lex.token!r}")
    return f


def _parse_query_internal(lex: Lexer) -> Query:
    opts = _parse_options(lex) if lex.is_keyword("options") else \
        QueryOptions()
    f = parse_filter_or(lex, "")
    pipes = []
    if lex.is_keyword("|"):
        lex.next_token()
        pipes = parse_pipes(lex)
    return Query(filter=f, pipes=pipes, opts=opts, timestamp=lex.timestamp)


def _parse_options(lex: Lexer) -> QueryOptions:
    opts = QueryOptions()
    lex.next_token()
    if not lex.is_keyword("("):
        raise ParseError("missing '(' after options")
    lex.next_token()
    while not lex.is_keyword(")"):
        name = lex.token
        lex.next_token()
        if not lex.is_keyword("="):
            raise ParseError(f"missing '=' after option {name!r}")
        lex.next_token()
        value = lex.token
        lex.next_token()
        if name == "concurrency":
            opts.concurrency = int(value)
        elif name == "ignore_global_time_filter":
            opts.ignore_global_time_filter = value.lower() == "true"
        else:
            raise ParseError(f"unknown query option {name!r}")
        if lex.is_keyword(","):
            lex.next_token()
    lex.next_token()
    return opts


def parse_filter_or(lex: Lexer, field_name: str) -> Filter:
    filters = [parse_filter_and(lex, field_name)]
    while lex.is_keyword("or"):
        lex.next_token()
        filters.append(parse_filter_and(lex, field_name))
    return filters[0] if len(filters) == 1 else FilterOr(filters)


def parse_filter_and(lex: Lexer, field_name: str) -> Filter:
    filters = [parse_generic_filter(lex, field_name)]
    while not (lex.is_end() or lex.is_keyword("or", "|", ")", "]", ",")):
        if lex.is_keyword("and"):
            lex.next_token()
        filters.append(parse_generic_filter(lex, field_name))
    return filters[0] if len(filters) == 1 else FilterAnd(filters)


def parse_generic_filter(lex: Lexer, field_name: str) -> Filter:
    if lex.is_keyword("{"):
        if field_name not in ("", "_stream"):
            raise ParseError("stream filter can only apply to _stream")
        return _parse_filter_stream(lex)
    if lex.is_keyword(":"):
        lex.next_token()
        return parse_generic_filter(lex, field_name)
    if lex.is_keyword("*"):
        lex.next_token()
        return FilterPrefix(field_name, "") if field_name else FilterNoop()
    if lex.is_keyword("("):
        lex.next_token()
        f = parse_filter_or(lex, field_name)
        if not lex.is_keyword(")"):
            raise ParseError(f"missing ')' ; got {lex.token!r}")
        lex.next_token()
        return f
    if lex.is_keyword(">", "<"):
        return _parse_compare(lex, field_name)
    if lex.is_keyword("="):
        lex.next_token()
        return _parse_eq_tail(lex, field_name)
    if lex.is_keyword("!="):
        lex.next_token()
        return FilterNot(_parse_eq_tail(lex, field_name))
    if lex.is_keyword("~"):
        lex.next_token()
        return _parse_regexp_tail(lex, field_name)
    if lex.is_keyword("!~"):
        lex.next_token()
        return FilterNot(_parse_regexp_tail(lex, field_name))
    if lex.is_keyword("not", "!", "-"):
        lex.next_token()
        return FilterNot(parse_generic_filter(lex, field_name))
    for kw, fn in _FUNC_FILTERS.items():
        if lex.is_keyword(kw) and (
                _peek_is_lparen(lex)
                or (kw == "range" and lex.pos < len(lex.s)
                    and lex.s[lex.pos] == "[")):
            return fn(lex, field_name)
    if lex.is_keyword(",", ")", "[", "]", "|") or lex.is_end():
        raise ParseError(f"unexpected token {lex.token!r} "
                         f"near ...{lex.context()}")
    if lex.is_keyword("and", "or"):
        raise ParseError(f"reserved keyword {lex.token!r} cannot be used "
                         f"as a search phrase; quote it to search literally")
    # a field-scoped phrase may contain ':'; a bare one stops at it,
    # since `name:` starts a field filter
    stop = _STOP_TOKENS if field_name else _STOP_TOKENS + (":",)
    phrase = _get_compound_token(lex, stop=stop)
    return _parse_filter_for_phrase(lex, phrase, field_name)


def _peek_is_lparen(lex: Lexer) -> bool:
    """A function filter's name is followed right away by '('."""
    return lex.pos < len(lex.s) and lex.s[lex.pos] == "("


_STOP_TOKENS = ("*", ",", "(", ")", "[", "]", "|", "")


def _get_compound_token(lex: Lexer,
                        stop=(",", "(", ")", "[", "]", "|", "")) -> str:
    if lex.is_keyword(*stop):
        raise ParseError(f"compound token cannot start with {lex.token!r}")
    s, raw, was_quoted = lex.token, lex.raw_token, lex.is_quoted
    lex.next_token()
    suffix = ""
    while not lex.is_skipped_space and not lex.is_keyword(*stop) \
            and not lex.is_end():
        suffix += lex.raw_token if not lex.is_quoted else lex.token
        lex.next_token()
    if not suffix:
        return s
    return (s if was_quoted else raw) + suffix


def _parse_filter_for_phrase(lex: Lexer, phrase: str,
                             field_name: str) -> Filter:
    if field_name or not lex.is_keyword(":"):
        if lex.is_keyword("*") and not lex.is_skipped_space:
            lex.next_token()
            return FilterPrefix(field_name, phrase)
        return FilterPhrase(field_name, phrase)
    # the phrase was a field name
    lex.next_token()
    if phrase == "_time":
        return _parse_filter_time_generic(lex)
    if phrase == "_stream_id":
        return _parse_filter_stream_id(lex)
    return parse_generic_filter(lex, phrase)


def _parse_regexp_tail(lex: Lexer, field_name: str) -> Filter:
    if lex.is_quoted:
        pat = lex.token
        lex.next_token()
    else:
        pat = _get_compound_token(lex)
    return FilterRegexp(field_name, pat)


def _parse_eq_tail(lex: Lexer, field_name: str) -> Filter:
    if lex.is_keyword("*"):
        lex.next_token()
        return FilterExactPrefix(field_name, "")
    value = _get_compound_token(lex, stop=_STOP_TOKENS)
    if lex.is_keyword("*") and not lex.is_skipped_space:
        lex.next_token()
        return FilterExactPrefix(field_name, value)
    return FilterExact(field_name, value)


def _parse_compare(lex: Lexer, field_name: str) -> Filter:
    """`>x`, `>=x`, `<x`, `<=x`: a range with one infinite bound; a
    strict bound moves to the next float."""
    gt = lex.is_keyword(">")
    lex.next_token()
    eq = lex.is_keyword("=") and not lex.is_skipped_space
    if eq:
        lex.next_token()
    v = _get_compound_token(lex)
    fv = parse_number(v)
    if math.isnan(fv):
        raise ParseError(f"cannot parse number {v!r} after "
                         f"'{'>' if gt else '<'}'")
    op = (">" if gt else "<") + ("=" if eq else "")
    if gt:
        lo = fv if eq else math.nextafter(fv, math.inf)
        return FilterRange(field_name, lo, math.inf, repr_str=f"{op}{v}")
    hi = fv if eq else math.nextafter(fv, -math.inf)
    return FilterRange(field_name, -math.inf, hi, repr_str=f"{op}{v}")


# ---- function-style filters ----

def _parse_func_args(lex: Lexer) -> list[str]:
    """`(arg, arg, ...)`, each a compound token or a quoted string."""
    if not lex.is_keyword("("):
        raise ParseError(f"missing '(' ; got {lex.token!r}")
    lex.next_token()
    args: list[str] = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        if lex.is_keyword("*"):
            args.append("*")
            lex.next_token()
            continue
        args.append(_get_compound_token(lex))
    lex.next_token()
    return args


def _parse_func_args_raw_star(lex: Lexer) -> list[tuple[str, bool]]:
    """Args where a trailing `*` marks a prefix: exact(foo*), i(foo*)."""
    if not lex.is_keyword("("):
        raise ParseError("missing '('")
    lex.next_token()
    args: list[tuple[str, bool]] = []
    while not lex.is_keyword(")"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        tok = _get_compound_token(lex, stop=("*", ",", "(", ")", "|", ""))
        star = lex.is_keyword("*") and not lex.is_skipped_space
        if star:
            lex.next_token()
        args.append((tok, star))
    lex.next_token()
    return args


def _try_parse_subquery(lex: Lexer):
    """`(query | pipes)` of in()/contains_*(): the Query, or None (and
    the lexer back where it was) when the parentheses hold plain
    arguments; a subquery has at least one pipe."""
    save = (lex.pos, lex.token, lex.raw_token, lex.is_quoted,
            lex.is_skipped_space)
    try:
        if not lex.is_keyword("("):
            return None
        lex.next_token()
        q = _parse_query_internal(lex)
        if not lex.is_keyword(")") or not q.pipes:
            raise ParseError("not a subquery")
        lex.next_token()
        return q
    except (ParseError, ValueError):
        (lex.pos, lex.token, lex.raw_token, lex.is_quoted,
         lex.is_skipped_space) = save
        return None


def _parse_in(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    sub = _try_parse_subquery(lex)
    if sub is not None:
        return FilterIn(field_name, [], subquery=sub)
    args = _parse_func_args(lex)
    if args == ["*"]:
        return FilterNoop()
    return FilterIn(field_name, args)


def _contains_parser(cls):
    def parse(lex: Lexer, field_name: str) -> Filter:
        lex.next_token()
        sub = _try_parse_subquery(lex)
        if sub is not None:
            return cls(field_name, [], subquery=sub)
        return cls(field_name, _parse_func_args(lex))
    return parse


def _parse_exact(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    args = _parse_func_args_raw_star(lex)
    if len(args) != 1:
        raise ParseError("exact() expects one arg")
    value, star = args[0]
    if star:
        return FilterExactPrefix(field_name, value)
    return FilterExact(field_name, value)


def _parse_i(lex: Lexer, field_name: str) -> Filter:
    """`i(phrase)` or `i(prefix*)`: one argument, any case."""
    lex.next_token()
    args = _parse_func_args_raw_star(lex)
    if len(args) != 1:
        raise ParseError("i() expects one arg")
    phrase, star = args[0]
    if star:
        return FilterAnyCasePrefix(field_name, phrase)
    return FilterAnyCasePhrase(field_name, phrase)


def _parse_regexp_func(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    args = _parse_func_args(lex)
    if len(args) != 1:
        raise ParseError("re() expects one arg")
    return FilterRegexp(field_name, args[0])


def _parse_range(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    if not lex.is_keyword("(", "["):
        raise ParseError("range must be followed by '(' or '['")
    inc_lo = lex.is_keyword("[")
    lex.next_token()
    lo_s = _get_compound_token(lex)
    if not lex.is_keyword(","):
        raise ParseError("missing ',' in range()")
    lex.next_token()
    hi_s = _get_compound_token(lex)
    if not lex.is_keyword(")", "]"):
        raise ParseError("missing ')' or ']' in range()")
    inc_hi = lex.is_keyword("]")
    lex.next_token()
    lo, hi = parse_number(lo_s), parse_number(hi_s)
    if math.isnan(lo) or math.isnan(hi):
        raise ParseError(f"cannot parse range bounds ({lo_s},{hi_s})")
    rs = f"range{'[' if inc_lo else '('}{lo_s},{hi_s}{']' if inc_hi else ')'}"
    if not inc_lo:
        lo = math.nextafter(lo, math.inf)
    if not inc_hi:
        hi = math.nextafter(hi, -math.inf)
    return FilterRange(field_name, lo, hi, repr_str=rs)


def _parse_ipv4_range(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    args = _parse_func_args(lex)
    if len(args) == 1:
        s = args[0]
        if "/" in s:
            base, bits = s.rsplit("/", 1)
            ip = parse_ipv4(base)
            if ip is None or not bits.isdigit() or int(bits) > 32:
                raise ParseError(f"invalid CIDR {s!r}")
            shift = 32 - int(bits)
            lo = (ip >> shift) << shift
            return FilterIPv4Range(field_name, lo, lo | ((1 << shift) - 1))
        ip = parse_ipv4(s)
        if ip is None:
            raise ParseError(f"invalid IP {s!r}")
        return FilterIPv4Range(field_name, ip, ip)
    if len(args) != 2:
        raise ParseError("ipv4_range() expects 1 or 2 args")
    lo, hi = parse_ipv4(args[0]), parse_ipv4(args[1])
    if lo is None or hi is None:
        raise ParseError(f"invalid IPs in ipv4_range{args}")
    return FilterIPv4Range(field_name, lo, hi)


def _parse_len_range(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    args = _parse_func_args(lex)
    if len(args) != 2:
        raise ParseError("len_range() expects 2 args")

    def bound(s, dflt):
        if s.lower() == "inf":
            return dflt
        v = parse_number(s)
        if math.isnan(v):
            raise ParseError(f"bad len_range bound {s!r}")
        return int(v)
    return FilterLenRange(field_name, bound(args[0], 0),
                          bound(args[1], 1 << 62))


def _parse_string_range(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    args = _parse_func_args(lex)
    if len(args) != 2:
        raise ParseError("string_range() expects 2 args")
    return FilterStringRange(field_name, args[0], args[1])


def _one_arg_parser(cls, name: str):
    def parse(lex: Lexer, field_name: str) -> Filter:
        lex.next_token()
        args = _parse_func_args(lex)
        if len(args) != 1:
            raise ParseError(f"{name}() expects 1 arg")
        return cls(field_name, args[0])
    return parse


def _field_cmp_parser(strict: bool):
    def parse(lex: Lexer, field_name: str) -> Filter:
        lex.next_token()
        args = _parse_func_args(lex)
        if len(args) != 1:
            raise ParseError(f"{'lt' if strict else 'le'}_field() expects "
                             f"1 arg")
        return FilterLeField(field_name, args[0], strict=strict)
    return parse


def _parse_seq(lex: Lexer, field_name: str) -> Filter:
    lex.next_token()
    return FilterSequence(field_name, _parse_func_args(lex))


_FUNC_FILTERS = {
    "contains_all": _contains_parser(FilterContainsAll),
    "contains_any": _contains_parser(FilterContainsAny),
    "eq_field": _one_arg_parser(FilterEqField, "eq_field"),
    "exact": _parse_exact,
    "i": _parse_i,
    "in": _parse_in,
    "ipv4_range": _parse_ipv4_range,
    "le_field": _field_cmp_parser(strict=False),
    "len_range": _parse_len_range,
    "lt_field": _field_cmp_parser(strict=True),
    "range": _parse_range,
    "re": _parse_regexp_func,
    "seq": _parse_seq,
    "string_range": _parse_string_range,
    "value_type": _one_arg_parser(FilterValueType, "value_type"),
}


# ---- _time filters ----

def _now_ns(lex: Lexer) -> int:
    lex.now_reads += 1
    if lex.timestamp is not None:
        return lex.timestamp
    import time
    return time.time_ns()


def _parse_filter_time_generic(lex: Lexer) -> Filter:
    if lex.is_keyword("day_range"):
        return _parse_day_range(lex)
    if lex.is_keyword("week_range"):
        return _parse_week_range(lex)
    reads = lex.now_reads
    f = _parse_filter_time(lex)
    if lex.is_keyword("offset"):
        lex.next_token()
        tok = _get_compound_token(lex)
        off = parse_duration(tok)
        if off is None:
            raise ParseError(f"invalid offset duration {tok!r}")
        f = FilterTime(f.min_ts - off, f.max_ts - off,
                       repr_str=f"{f.repr_str} offset {tok}".strip())
    f.relative = lex.now_reads > reads
    return f


def _parse_filter_time(lex: Lexer) -> FilterTime:
    if lex.is_keyword("[", "("):
        inc_lo = lex.is_keyword("[")
        lex.next_token()
        lo_s = _get_compound_token(lex)
        if not lex.is_keyword(","):
            raise ParseError("missing ',' in _time range")
        lex.next_token()
        hi_s = _get_compound_token(lex)
        if not lex.is_keyword("]", ")"):
            raise ParseError("missing ']' or ')' in _time range")
        inc_hi = lex.is_keyword("]")
        lex.next_token()
        lo = _time_bound(lex, lo_s, end=False)
        hi = _time_bound(lex, hi_s, end=True)
        if not inc_lo:
            lo += 1
        if not inc_hi:
            # an exclusive end stops at the START of the named instant
            hi = _time_bound(lex, hi_s, end=False) - 1
        rs = f"{'[' if inc_lo else '('}{lo_s},{hi_s}{']' if inc_hi else ')'}"
        return FilterTime(lo, hi, repr_str=rs)
    if lex.is_keyword(">", "<"):
        gt = lex.is_keyword(">")
        lex.next_token()
        eq = False
        if lex.is_keyword("=") and not lex.is_skipped_space:
            eq = True
            lex.next_token()
        tok = _get_compound_token(lex)
        op = (">" if gt else "<") + ("=" if eq else "")
        if gt:
            t = _time_bound(lex, tok, end=not eq)
            return FilterTime(t if eq else t + 1, MAX_TS,
                              repr_str=f"{op}{tok}")
        t = _time_bound(lex, tok, end=True) if eq else \
            _time_bound(lex, tok, end=False) - 1
        return FilterTime(MIN_TS, t, repr_str=f"{op}{tok}")
    if lex.is_keyword("="):
        lex.next_token()
    tok = _get_compound_token(lex)
    d = parse_duration(tok)
    if d is not None:
        now = _now_ns(lex)
        return FilterTime(now - abs(d), now, repr_str=tok)
    tb = ts_bounds(tok)
    if tb is not None:
        return FilterTime(tb[0], tb[1], repr_str=tok)
    raise ParseError(f"cannot parse _time filter value {tok!r}")


def _time_bound(lex: Lexer, s: str, end: bool) -> int:
    if s == "now":
        return _now_ns(lex)
    d = parse_duration(s)
    if d is not None:
        return _now_ns(lex) + d if d < 0 else _now_ns(lex) - d
    tb = ts_bounds(s)
    if tb is None:
        if s.isdigit() or (s[:1] == "-" and s[1:].isdigit()):
            # unix seconds, milliseconds, microseconds or nanoseconds by
            # magnitude: FilterTime.to_string() renders raw nanoseconds
            from ..server.insertutil import parse_timestamp
            return parse_timestamp(int(s))
        raise ParseError(f"cannot parse time bound {s!r}")
    return tb[1] if end else tb[0]


def _parse_offset_modifier(lex: Lexer) -> int:
    if not lex.is_keyword("offset"):
        return 0
    lex.next_token()
    tok = _get_compound_token(lex)
    d = parse_duration(tok)
    if d is None:
        raise ParseError(f"invalid offset duration {tok!r}")
    return d


def _parse_bracket_pair(lex: Lexer, what: str):
    """`[lo, hi]` with `(`/`)` for exclusive ends, then an optional
    `offset d`: (lo, hi, inc_lo, inc_hi, offset ns, repr)."""
    lex.next_token()
    if not lex.is_keyword("[", "("):
        raise ParseError(f"{what} must be followed by '[' or '('")
    inc_lo = lex.is_keyword("[")
    lex.next_token()
    lo_s = _get_compound_token(lex)
    if not lex.is_keyword(","):
        raise ParseError(f"missing ',' in {what}")
    lex.next_token()
    hi_s = _get_compound_token(lex)
    if not lex.is_keyword("]", ")"):
        raise ParseError(f"missing ']' or ')' in {what}")
    inc_hi = lex.is_keyword("]")
    lex.next_token()
    off = _parse_offset_modifier(lex)
    rs = f"{'[' if inc_lo else '('}{lo_s},{hi_s}{']' if inc_hi else ')'}"
    return lo_s, hi_s, inc_lo, inc_hi, off, rs


def _parse_day_range(lex: Lexer) -> Filter:
    lo_s, hi_s, inc_lo, inc_hi, off, rs = _parse_bracket_pair(lex,
                                                              "day_range")

    def day_off(s):
        parts = s.split(":")
        if len(parts) != 2 or not parts[0].isdigit() or \
                not parts[1].isdigit():
            raise ParseError(f"invalid day_range bound {s!r}; want hh:mm")
        return (int(parts[0]) * 3600 + int(parts[1]) * 60) * NS
    lo, hi = day_off(lo_s), day_off(hi_s)
    return FilterDayRange(lo if inc_lo else lo + 1,
                          hi if inc_hi else hi - 1, tz_offset_ns=-off,
                          repr_str=rs)


_WEEKDAYS = {
    "sun": 0, "sunday": 0, "mon": 1, "monday": 1, "tue": 2, "tuesday": 2,
    "wed": 3, "wednesday": 3, "thu": 4, "thursday": 4, "fri": 5,
    "friday": 5, "sat": 6, "saturday": 6,
}


def _parse_week_range(lex: Lexer) -> Filter:
    lo_s, hi_s, inc_lo, inc_hi, off, rs = _parse_bracket_pair(lex,
                                                              "week_range")
    try:
        lo, hi = _WEEKDAYS[lo_s.lower()], _WEEKDAYS[hi_s.lower()]
    except KeyError:
        raise ParseError(f"invalid week_range bounds [{lo_s},{hi_s}]")
    return FilterWeekRange(lo if inc_lo else lo + 1,
                           hi if inc_hi else hi - 1, tz_offset_ns=-off,
                           repr_str=rs)


# ---- _stream ----

def _parse_filter_stream(lex: Lexer) -> Filter:
    """`{tag op "value" [,...] [or ...]}`."""
    lex.next_token()
    or_groups: list[tuple[TagFilter, ...]] = []
    cur: list[TagFilter] = []
    while not lex.is_keyword("}"):
        if lex.is_keyword(","):
            lex.next_token()
            continue
        if lex.is_keyword("or"):
            if cur:
                or_groups.append(tuple(cur))
                cur = []
            lex.next_token()
            continue
        label = _get_compound_token(lex, stop=("=", "!=", "=~", "!~", "{",
                                               "}", ",", "(", ")", "|", ""))
        if not lex.is_keyword("=", "!=", "=~", "!~"):
            raise ParseError(f"missing stream filter op after {label!r}")
        op = lex.token
        lex.next_token()
        if lex.is_keyword("in") and not lex.is_quoted:
            raise ParseError("label in(...) inside stream filter "
                             "not supported yet")
        cur.append(TagFilter(label, op, lex.token))
        lex.next_token()
    lex.next_token()
    if cur:
        or_groups.append(tuple(cur))
    if not or_groups:
        return FilterNoop()
    return FilterStream(StreamFilter(tuple(or_groups)))


def _parse_filter_stream_id(lex: Lexer) -> Filter:
    if lex.is_keyword("in") and _peek_is_lparen(lex):
        lex.next_token()
        return FilterStreamID(_parse_func_args(lex))
    return FilterStreamID([_get_compound_token(lex)])
