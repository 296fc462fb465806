"""LogsQL parser for the slice: query -> (filter tree, pipes).

Implicit AND between adjacent filters, `or`/`and`/`not` (`!`, `-`),
parentheses, `field:filter` scoping, compound phrases glued from
adjacent unspaced tokens, `*`, `prefix*`, `=exact`, `=prefix*`,
`~"regexp"`, `i(phrase)` and `i(prefix*)`, `{...}` stream filters,
`_time:` filters and the trailing pipes.  Constructs outside the slice raise
NotImplementedError instead of parsing into something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..storage.stream_filter import StreamFilter, TagFilter
from .duration import parse_duration, ts_bounds
from .filters import (Filter, FilterAnd, FilterAnyCasePhrase,
                      FilterAnyCasePrefix, FilterExact, FilterExactPrefix,
                      FilterNoop, FilterNot, FilterOr, FilterPhrase,
                      FilterPrefix, FilterRegexp, FilterStream, FilterTime)
from .lexer import Lexer
from .pipes import ParseError, parse_pipes

MAX_TS = (1 << 63) - 1
MIN_TS = -(1 << 63)

# function-style filters of the full language outside the slice (`i` is
# in it)
_FUNC_FILTERS = ("contains_all", "contains_any", "eq_field", "exact", "in",
                 "ipv4_range", "le_field", "len_range", "lt_field", "range",
                 "re", "seq", "string_range", "value_type")


@dataclass
class Query:
    filter: Filter
    pipes: list = dc_field(default_factory=list)
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
    if lex.is_keyword("options"):
        raise NotImplementedError("query options")
    f = parse_filter_or(lex, "")
    pipes = []
    if lex.is_keyword("|"):
        lex.next_token()
        pipes = parse_pipes(lex)
    if not lex.is_end():
        raise ParseError(f"unexpected trailing token {lex.token!r} "
                         f"near ...{lex.context()}")
    return Query(filter=f, pipes=pipes, timestamp=lex.timestamp)


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
        raise NotImplementedError("numeric range filters")
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
    if lex.is_keyword("i") and lex.pos < len(lex.s) and \
            lex.s[lex.pos] == "(":
        return _parse_i(lex, field_name)
    for kw in _FUNC_FILTERS:
        if lex.is_keyword(kw) and lex.pos < len(lex.s) and \
                lex.s[lex.pos] in "([":
            raise NotImplementedError(f"{kw}() filter")
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
        raise NotImplementedError("_stream_id filters")
    return parse_generic_filter(lex, phrase)


def _parse_regexp_tail(lex: Lexer, field_name: str) -> Filter:
    if lex.is_quoted:
        pat = lex.token
        lex.next_token()
    else:
        pat = _get_compound_token(lex)
    return FilterRegexp(field_name, pat)


def _parse_i(lex: Lexer, field_name: str) -> Filter:
    """`i(phrase)` or `i(prefix*)`: one argument, any case."""
    lex.next_token()
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
    if len(args) != 1:
        raise ParseError("i() expects one arg")
    phrase, star = args[0]
    if star:
        return FilterAnyCasePrefix(field_name, phrase)
    return FilterAnyCasePhrase(field_name, phrase)


def _parse_eq_tail(lex: Lexer, field_name: str) -> Filter:
    if lex.is_keyword("*"):
        lex.next_token()
        return FilterExactPrefix(field_name, "")
    value = _get_compound_token(lex, stop=_STOP_TOKENS)
    if lex.is_keyword("*") and not lex.is_skipped_space:
        lex.next_token()
        return FilterExactPrefix(field_name, value)
    return FilterExact(field_name, value)


# ---- _time filters ----

def _now_ns(lex: Lexer) -> int:
    if lex.timestamp is not None:
        return lex.timestamp
    import time
    return time.time_ns()


def _parse_filter_time_generic(lex: Lexer) -> Filter:
    if lex.is_keyword("day_range", "week_range"):
        raise NotImplementedError(f"_time:{lex.token} filters")
    f = _parse_filter_time(lex)
    if lex.is_keyword("offset"):
        lex.next_token()
        tok = _get_compound_token(lex)
        off = parse_duration(tok)
        if off is None:
            raise ParseError(f"invalid offset duration {tok!r}")
        f = FilterTime(f.min_ts - off, f.max_ts - off,
                       repr_str=f"{f.repr_str} offset {tok}".strip())
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
        if s.lstrip("-").isdigit():
            raise NotImplementedError("numeric _time bounds")
        raise ParseError(f"cannot parse time bound {s!r}")
    return tb[1] if end else tb[0]


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
            raise NotImplementedError("label in(...) inside stream filter")
        cur.append(TagFilter(label, op, lex.token))
        lex.next_token()
    lex.next_token()
    if cur:
        or_groups.append(tuple(cur))
    if not or_groups:
        return FilterNoop()
    return FilterStream(StreamFilter(tuple(or_groups)))
