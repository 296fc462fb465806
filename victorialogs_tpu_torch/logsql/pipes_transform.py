"""LogsQL transform pipes: extract, extract_regexp, format, math,
unpack_json, unpack_logfmt, unpack_syslog, unpack_words, replace,
replace_regexp, top, len, pack_json, pack_logfmt, sample, unroll,
facets, field_names, field_values, blocks_count and drop_empty_fields.

All of them run on the host, after the filter (which runs on the card
under a device runner).  Most rewrite or add columns block by block on
a detached copy of the block (`BlockResult.materialize`); `top`,
`facets`, `field_names`, `field_values` and `blocks_count` accumulate
and emit at flush.  Where a pipe takes an `if (filter)` guard, the rows
the guard drops pass through unchanged.  Each pipe's `input_fields`
(pipes.compute_needed_fields) names every field it reads, so a device
runner stages no less than the host reads.

`sample` and `math`'s `rand()` draw from a `random.Random` the caller
may seed (the pipe's `rng`); without one each processor makes an
unseeded generator.
"""

from __future__ import annotations

import base64
import binascii
import json
import math
import random
import re
import time as _time
from dataclasses import dataclass, field as dc_field
from urllib.parse import quote as _url_quote, unquote as _url_unquote

import numpy as np

from ..engine.block_result import BlockResult
from ..server.syslog import parse_syslog_message
from ..utils.memory import MemoryBudget
from ..utils.tokenizer import tokenize_string
from .duration import format_rfc3339, parse_duration, parse_rfc3339
from .lexer import quote_token_if_needed
from .matchers import parse_ipv4, parse_number
from .pipes import (ParseError, Pipe, Processor, _parse_field_name,
                    _parse_paren_fields, _parse_uint, if_mask, if_str,
                    maybe_if, register_pipe)
from .stats_funcs import format_number


# ---------------- pattern engine (reference pattern.go) ----------------

@dataclass
class PatternStep:
    prefix: str
    field: str = ""
    opt: str = ""


_HTML_UNESCAPES = {"&lt;": "<", "&gt;": ">", "&amp;": "&",
                   "&quot;": '"', "&apos;": "'"}


def _html_unescape(s: str) -> str:
    for k, v in _HTML_UNESCAPES.items():
        s = s.replace(k, v)
    return s


class Pattern:
    """'text<field>text...' extraction pattern (reference pattern.go:1-251).

    Greedy-less matching: each unquoted field matches up to the next literal
    prefix; `<q:field>` tries Go-unquoting first; prefixes between fields
    must be non-empty; prefixes support &lt;/&gt; escapes."""

    def __init__(self, pattern_str: str):
        self.pattern_str = pattern_str
        self.steps = self._parse_steps(pattern_str)
        if not any(st.field for st in self.steps):
            raise ParseError(
                f"pattern {pattern_str!r} needs at least one <field>")
        for i in range(1, len(self.steps)):
            if not self.steps[i].prefix:
                raise ParseError(
                    f"missing delimiter between <{self.steps[i-1].field}> "
                    f"and <{self.steps[i].field}>")
        self.fields = [st.field for st in self.steps if st.field]

    @staticmethod
    def _parse_steps(s: str) -> list:
        steps = []
        i, n = 0, len(s)
        prefix = []
        while i < n:
            c = s[i]
            if c != "<":
                prefix.append(c)
                i += 1
                continue
            j = s.find(">", i + 1)
            if j < 0:
                prefix.append(c)
                i += 1
                continue
            name = s[i + 1:j]
            opt = ""
            if ":" in name:
                opt, name = name.split(":", 1)
                opt = opt.strip()
            name = name.strip()
            if name == "_":
                name = ""        # <_> is an anonymous skip like <>
            steps.append(PatternStep(_html_unescape("".join(prefix)),
                                     name, opt))
            prefix = []
            i = j + 1
        if prefix:
            steps.append(PatternStep(_html_unescape("".join(prefix))))
        if steps and not steps[0].prefix and not steps[0].field and \
                len(steps) > 1:
            steps = steps[1:]
        return steps

    def apply(self, s: str) -> dict:
        """Extract fields from s; mismatch => all fields empty."""
        out = {f: "" for f in self.fields}
        steps = self.steps
        idx = s.find(steps[0].prefix) if steps[0].prefix else 0
        if idx < 0:
            return out
        s = s[idx + len(steps[0].prefix):]
        for i, st in enumerate(steps):
            nxt = steps[i + 1].prefix if i + 1 < len(steps) else ""
            if st.opt != "plain":
                us, off = _try_unquote_prefix(s)
                if off >= 0:
                    if st.field:
                        out[st.field] = us
                    s = s[off:]
                    if not s.startswith(nxt):
                        # mid-pattern mismatch keeps fields extracted so
                        # far (reference pattern.apply — pattern.go:125)
                        return out
                    s = s[len(nxt):]
                    continue
            if not nxt:
                if st.field:
                    out[st.field] = s
                return out
            pos = s.find(nxt)
            if pos < 0:
                return out
            if st.field:
                out[st.field] = s[:pos]
            s = s[pos + len(nxt):]
        return out


def _try_unquote_prefix(s: str):
    """Go strconv.QuotedPrefix + Unquote; returns (value, consumed|-1)."""
    if not s or s[0] not in "\"`":
        return "", -1
    q = s[0]
    if q == "`":
        j = s.find("`", 1)
        if j < 0:
            return "", -1
        return s[1:j], j + 1
    i, n = 1, len(s)
    out = []
    while i < n:
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\" and i + 1 < n:
            e = s[i + 1]
            mapping = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                       '"': '"', "'": "'", "a": "\a", "b": "\b",
                       "f": "\f", "v": "\v", "/": "/"}
            if e in mapping:
                out.append(mapping[e])
                i += 2
                continue
            if e == "x" and i + 3 < n:
                try:
                    out.append(chr(int(s[i + 2:i + 4], 16)))
                    i += 4
                    continue
                except ValueError:
                    return "", -1
            if e == "u" and i + 5 < n:
                try:
                    out.append(chr(int(s[i + 2:i + 6], 16)))
                    i += 6
                    continue
                except ValueError:
                    return "", -1
            return "", -1
        out.append(c)
        i += 1
    return "", -1


# ---------------- extract / extract_regexp ----------------

def _merge_extracted(br, out_cols, names, mask, keep_original, skip_empty):
    """Apply keep_original_fields / skip_empty_results / if-mask merging."""
    for name in names:
        newv = out_cols[name]
        if keep_original or skip_empty or mask is not None:
            orig = br.column(name) if br.has_column(name) else [""] * br.nrows
            for i in range(br.nrows):
                if mask is not None and not mask[i]:
                    newv[i] = orig[i]
                elif keep_original and orig[i] != "":
                    newv[i] = orig[i]
                elif skip_empty and newv[i] == "" and orig[i] != "":
                    newv[i] = orig[i]


@dataclass(repr=False)
class PipeExtract(Pipe):
    pattern_str: str
    from_field: str = "_msg"
    keep_original_fields: bool = False
    skip_empty_results: bool = False
    iff: object = None

    name = "extract"

    def __post_init__(self):
        self.ptn = Pattern(self.pattern_str)

    def to_string(self):
        s = "extract" + if_str(self.iff) + " " + \
            quote_token_if_needed(self.pattern_str)
        if self.from_field != "_msg":
            s += " from " + quote_token_if_needed(self.from_field)
        if self.keep_original_fields:
            s += " keep_original_fields"
        if self.skip_empty_results:
            s += " skip_empty_results"
        return s

    def needed_fields(self):
        out = {self.from_field}
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                vals = br.column(pipe.from_field)
                out_cols = {f: [""] * br.nrows for f in pipe.ptn.fields}
                prev_v, prev = None, None
                for i in range(br.nrows):
                    if mask is not None and not mask[i]:
                        continue
                    v = vals[i]
                    if v != prev_v:
                        prev_v, prev = v, pipe.ptn.apply(v)
                    for f in pipe.ptn.fields:
                        out_cols[f][i] = prev[f]
                _merge_extracted(br, out_cols, pipe.ptn.fields, mask,
                                 pipe.keep_original_fields,
                                 pipe.skip_empty_results)
                out = br.materialize()
                for f in pipe.ptn.fields:
                    out._cols[f] = out_cols[f]
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipeExtractRegexp(Pipe):
    pattern_str: str
    from_field: str = "_msg"
    keep_original_fields: bool = False
    skip_empty_results: bool = False
    iff: object = None

    name = "extract_regexp"

    def __post_init__(self):
        self.re = re.compile(self.pattern_str)
        self.fields = [g for g in self.re.groupindex]
        if not self.fields:
            raise ParseError(
                "extract_regexp needs at least one named group "
                "(?P<name>...)")

    def to_string(self):
        s = "extract_regexp" + if_str(self.iff) + " " + \
            quote_token_if_needed(self.pattern_str)
        if self.from_field != "_msg":
            s += " from " + quote_token_if_needed(self.from_field)
        if self.keep_original_fields:
            s += " keep_original_fields"
        if self.skip_empty_results:
            s += " skip_empty_results"
        return s

    def needed_fields(self):
        out = {self.from_field}
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                vals = br.column(pipe.from_field)
                out_cols = {f: [""] * br.nrows for f in pipe.fields}
                for i in range(br.nrows):
                    if mask is not None and not mask[i]:
                        continue
                    m = pipe.re.search(vals[i])
                    if m is None:
                        continue
                    for f in pipe.fields:
                        out_cols[f][i] = m.group(f) or ""
                _merge_extracted(br, out_cols, pipe.fields, mask,
                                 pipe.keep_original_fields,
                                 pipe.skip_empty_results)
                out = br.materialize()
                for f in pipe.fields:
                    out._cols[f] = out_cols[f]
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- format ----------------

def _format_duration(ns: float) -> str:
    """Go time.Duration.String() rendering (the reference formats
    durations with Go's stdlib — e.g. 210123456789ns -> '3m30.123456789s',
    1500µs -> '1.5ms')."""
    if math.isnan(ns):
        return ""
    n = int(ns)
    if n == 0:
        return "0s"
    sign = "-" if n < 0 else ""
    n = abs(n)

    def frac(val: int, digits: int) -> str:
        s = f"{val:0{digits}d}".rstrip("0")
        return "." + s if s else ""

    if n < 1000:
        return f"{sign}{n}ns"
    if n < 10**6:
        return f"{sign}{n // 1000}{frac(n % 1000, 3)}µs"
    if n < 10**9:
        return f"{sign}{n // 10**6}{frac(n % 10**6, 6)}ms"
    secs, sub = divmod(n, 10**9)
    out = f"{secs % 60}{frac(sub, 9)}s"
    mins = secs // 60
    if mins:
        out = f"{mins % 60}m" + out
        hours = mins // 60
        if hours:
            out = f"{hours}h" + out
    return sign + out


def _format_value(v: str, opt: str) -> str:
    """Apply a format option (reference pipe_format.go:180-250)."""
    if opt in ("", "plain"):
        return v
    if opt == "q":
        return json.dumps(v, ensure_ascii=False)
    if opt == "uc":
        return v.upper()
    if opt == "lc":
        return v.lower()
    if opt == "hexencode":
        return v.encode("utf-8").hex().upper()
    if opt == "hexdecode":
        try:
            return bytes.fromhex(v).decode("utf-8", "replace")
        except ValueError:
            return v
    if opt == "hexnumencode":
        try:
            n = int(v)
            if not 0 <= n < 2**64:
                return v
        except ValueError:
            return v
        return f"{n:016X}"
    if opt == "hexnumdecode":
        if 0 < len(v) <= 16:
            try:
                return str(int(v, 16))
            except ValueError:
                return v
        return v
    if opt == "base64encode":
        return base64.b64encode(v.encode("utf-8")).decode()
    if opt == "base64decode":
        try:
            return base64.b64decode(v, validate=True).decode("utf-8",
                                                             "replace")
        except (ValueError, binascii.Error):
            return v
    if opt == "urlencode":
        return _url_quote(v, safe="")
    if opt == "urldecode":
        return _url_unquote(v)
    if opt == "duration":
        n = parse_number(v)
        return _format_duration(n) if not math.isnan(n) else v
    if opt == "duration_seconds":
        d = parse_duration(v)
        return str(d // 10**9) if d is not None else v
    if opt == "ipv4":
        n = parse_number(v)
        if math.isnan(n) or not 0 <= n <= 2**32 - 1:
            return v
        n = int(n)
        return f"{(n >> 24) & 255}.{(n >> 16) & 255}." \
               f"{(n >> 8) & 255}.{n & 255}"
    if opt == "time":
        ns = _parse_unix_timestamp_ns(v)
        if ns is None:
            return v
        return format_rfc3339(ns)
    return v


def _parse_unix_timestamp_ns(v: str) -> int | None:
    """Unix timestamp (secs/millis/micros/nanos, optional decimal
    fraction) -> int64 ns without float precision loss (reference
    timeutil.TryParseUnixTimestamp)."""
    s = v.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    whole, _, fraction = s.partition(".")
    if not whole.isdigit() or (fraction and not fraction.isdigit()):
        return None
    n = int(whole)
    if fraction:                      # decimal seconds
        scale = 9
    elif n < 10**11:
        scale = 9                     # seconds
    elif n < 10**14:
        scale = 6                     # millis
    elif n < 10**17:
        scale = 3                     # micros
    else:
        scale = 0                     # nanos
    frac_ns = int((fraction + "0" * scale)[:scale] or "0")
    ns = n * 10**scale + frac_ns
    return -ns if neg else ns


@dataclass(repr=False)
class PipeFormat(Pipe):
    format_str: str
    result_field: str = "_msg"
    keep_original_fields: bool = False
    skip_empty_results: bool = False
    iff: object = None

    name = "format"

    def __post_init__(self):
        self.steps = Pattern._parse_steps(self.format_str)

    def to_string(self):
        s = "format" + if_str(self.iff) + " " + \
            quote_token_if_needed(self.format_str)
        if self.result_field != "_msg":
            s += " as " + quote_token_if_needed(self.result_field)
        if self.keep_original_fields:
            s += " keep_original_fields"
        if self.skip_empty_results:
            s += " skip_empty_results"
        return s

    def needed_fields(self):
        out = {st.field for st in self.steps if st.field}
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                cols = {st.field: br.column(st.field)
                        for st in pipe.steps if st.field}
                orig = br.column(pipe.result_field) \
                    if br.has_column(pipe.result_field) else [""] * br.nrows
                out_vals = []
                for i in range(br.nrows):
                    if mask is not None and not mask[i]:
                        out_vals.append(orig[i])
                        continue
                    buf = []
                    for st in pipe.steps:
                        buf.append(st.prefix)
                        if st.field:
                            buf.append(_format_value(cols[st.field][i],
                                                     st.opt))
                    v = "".join(buf)
                    if (pipe.keep_original_fields or
                            (pipe.skip_empty_results and v == "")) and \
                            orig[i] != "":
                        v = orig[i]
                    out_vals.append(v)
                out = br.materialize()
                out._cols[pipe.result_field] = out_vals
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- math ----------------

def _math_num(s: str) -> float:
    """Reference parseMathNumber order: number (incl. 0x hex), duration,
    IPv4, RFC3339 timestamp (pipe_math.go:1066)."""
    if s[:2].lower() == "0x":
        try:
            return float(int(s, 16))
        except ValueError:
            pass
    v = parse_number(s)
    if not math.isnan(v):
        return v
    d = parse_duration(s)
    if d is not None:
        return float(d)
    ip = parse_ipv4(s)
    if ip is not None:
        return float(ip)
    t = parse_rfc3339(s)
    if t is not None:
        return float(t)
    return math.nan


def _to_u64(v: float) -> int:
    if math.isnan(v) or math.isinf(v):
        return 0
    return int(v) & (2**64 - 1)


_MATH_BINOPS = {
    "^": (1, lambda a, b: math.nan if (math.isnan(a) or math.isnan(b))
          else _safe_pow(a, b)),
    "*": (2, lambda a, b: a * b),
    "/": (2, lambda a, b: a / b if b else math.nan),
    "%": (2, lambda a, b: math.fmod(a, b) if b else math.nan),
    "+": (3, lambda a, b: a + b),
    "-": (3, lambda a, b: a - b),
    "&": (4, lambda a, b: float(_to_u64(a) & _to_u64(b))),
    "xor": (5, lambda a, b: float(_to_u64(a) ^ _to_u64(b))),
    "or": (6, lambda a, b: float(_to_u64(a) | _to_u64(b))),
    "default": (10, lambda a, b: b if math.isnan(a) else a),
}


def _safe_pow(a, b):
    try:
        r = a ** b
        return r if isinstance(r, (int, float)) else math.nan
    except (OverflowError, ValueError, ZeroDivisionError):
        return math.nan


def _m_round(args):
    if len(args) == 1:
        v = args[0]
        return float(round(v)) if not math.isnan(v) else v
    v, nearest = args[0], args[1]
    if math.isnan(v) or math.isnan(nearest) or nearest == 0:
        return math.nan
    return round(v / nearest) * nearest


_MATH_FUNCS = {
    "abs": (1, lambda a: abs(a[0])),
    "exp": (1, lambda a: _safe_pow(math.e, a[0])),
    "ln": (1, lambda a: math.log(a[0]) if a[0] > 0 else math.nan),
    "max": (-1, lambda a: max(a) if a else math.nan),
    "min": (-1, lambda a: min(a) if a else math.nan),
    "round": (-2, _m_round),
    "ceil": (1, lambda a: float(math.ceil(a[0]))
             if not (math.isnan(a[0]) or math.isinf(a[0])) else a[0]),
    "floor": (1, lambda a: float(math.floor(a[0]))
              if not (math.isnan(a[0]) or math.isinf(a[0])) else a[0]),
    "now": (0, lambda a: float(_time.time_ns())),
    "rand": (0, None),        # the pipe's generator: MathExpr.eval_row
}


class MathExpr:
    def __init__(self, kind, value=None, args=None, op=None):
        self.kind = kind          # const | field | func | binop
        self.value = value
        self.args = args or []
        self.op = op

    def needed_fields(self) -> set:
        if self.kind == "field":
            return {self.value}
        out = set()
        for a in self.args:
            out |= a.needed_fields()
        return out

    def eval_row(self, get, i, rng: random.Random) -> float:
        k = self.kind
        if k == "const":
            return self.value
        if k == "field":
            return _math_num(get(self.value)[i])
        vals = [a.eval_row(get, i, rng) for a in self.args]
        if k == "func":
            if self.op == "rand":
                return rng.random()
            try:
                return _MATH_FUNCS[self.op][1](vals)
            except (ValueError, OverflowError):
                return math.nan
        fn = _MATH_BINOPS[self.op][1]
        try:
            return fn(vals[0], vals[1])
        except (ValueError, OverflowError, ZeroDivisionError):
            return math.nan

    # vectorizable core: const/field/{+,-,*,/} over storage-typed numeric
    # columns — identical IEEE semantics to the per-row path (division by
    # zero maps to NaN exactly like eval_row).  Anything else returns
    # None and the per-row interpreter runs.
    _VEC_OPS = {"+", "-", "*", "/"}

    def eval_vec(self, br, n, produced=None):
        k = self.kind
        if k == "const":
            return np.full(n, float(self.value))
        if k == "field":
            if produced and self.value in produced:
                # an earlier entry (re)wrote this field: its vec result,
                # or None when it took the row path (bail to rows too)
                return produced[self.value]
            return br.numeric_column(self.value)
        if k == "binop" and self.op in self._VEC_OPS:
            a = self.args[0].eval_vec(br, n, produced)
            if a is None:
                return None
            b = self.args[1].eval_vec(br, n, produced)
            if b is None:
                return None
            with np.errstate(all="ignore"):
                if self.op == "+":
                    return a + b
                if self.op == "-":
                    return a - b
                if self.op == "*":
                    return a * b
                return np.where(b == 0.0, np.nan, a / b)
        return None

    def to_string(self) -> str:
        if self.kind == "const":
            return format_number(self.value)
        if self.kind == "field":
            return quote_token_if_needed(self.value)
        if self.kind == "func":
            return f"{self.op}({', '.join(a.to_string() for a in self.args)})"
        return f"({self.args[0].to_string()} {self.op} " \
               f"{self.args[1].to_string()})"


def parse_math_expr(lex) -> MathExpr:
    left = _parse_math_operand(lex)
    return _parse_math_binop(lex, left, 20)


def _parse_math_binop(lex, left: MathExpr, max_prio: int) -> MathExpr:
    while True:
        op = lex.token.lower()
        if op not in _MATH_BINOPS:
            return left
        prio = _MATH_BINOPS[op][0]
        if prio > max_prio:
            return left
        lex.next_token()
        right = _parse_math_operand(lex)
        # bind tighter ops on the right first
        while True:
            nop = lex.token.lower()
            if nop in _MATH_BINOPS and _MATH_BINOPS[nop][0] < prio:
                right = _parse_math_binop(lex, right,
                                          _MATH_BINOPS[nop][0])
                continue
            break
        left = MathExpr("binop", args=[left, right], op=op)


def _parse_math_operand(lex) -> MathExpr:
    tok = lex.token
    low = tok.lower()
    if lex.is_keyword("("):
        lex.next_token()
        e = parse_math_expr(lex)
        if not lex.is_keyword(")"):
            raise ParseError("missing ')' in math expr")
        lex.next_token()
        return e
    if low in _MATH_FUNCS:
        lex.next_token()
        if not lex.is_keyword("("):
            # field named like a function
            return MathExpr("field", value=tok)
        lex.next_token()
        args = []
        while not lex.is_keyword(")"):
            if lex.is_keyword(","):
                lex.next_token()
                continue
            args.append(parse_math_expr(lex))
        lex.next_token()
        arity = _MATH_FUNCS[low][0]
        if arity >= 0 and len(args) != arity:
            raise ParseError(f"{low}() expects {arity} args")
        if arity == -2 and not 1 <= len(args) <= 2:
            raise ParseError(f"{low}() expects 1 or 2 args")
        if arity == -1 and not args:
            raise ParseError(f"{low}() expects at least one arg")
        return MathExpr("func", args=args, op=low)
    if lex.is_keyword("-"):
        lex.next_token()
        inner = _parse_math_operand(lex)
        if inner.kind == "const":
            return MathExpr("const", value=-inner.value)
        return MathExpr("binop", args=[MathExpr("const", value=0.0), inner],
                        op="-")
    if lex.is_keyword("+"):
        lex.next_token()
        return _parse_math_operand(lex)
    quoted = getattr(lex, "is_quoted", False)
    v = _math_num(tok) if tok else math.nan
    if tok and not math.isnan(v) and (quoted or tok[0].isdigit() or
                                      tok[0] in ".-+" or
                                      low in ("inf", "nan")):
        # consts: numbers (incl. 0x/size suffixes), durations, and quoted
        # IPv4/timestamp values like '2024-05-30T01:02:03Z'
        lex.next_token()
        return MathExpr("const", value=v)
    # field operand: a SINGLE token — compound gluing would swallow
    # operators like the '+' in `b+1`
    if not tok or tok in (",", ")", "|", "(", "as"):
        raise ParseError(f"bad math operand near {tok!r}")
    lex.next_token()
    return MathExpr("field", value=tok)


@dataclass(repr=False)
class PipeMath(Pipe):
    entries: list  # [(MathExpr, result_field)]
    rng: random.Random | None = dc_field(default=None, compare=False)

    name = "math"

    def to_string(self):
        return "math " + ", ".join(
            f"{e.to_string()} as {quote_token_if_needed(r)}"
            for e, r in self.entries)

    def needed_fields(self):
        out = set()
        for e, _r in self.entries:
            out |= e.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self
        rng = pipe.rng if pipe.rng is not None else random.Random()

        class P(Processor):
            def write_block(self, br):
                out = br.materialize()

                def get(name):
                    return out.column(name) if out.has_column(name) \
                        else [""] * out.nrows
                produced: dict = {}
                for expr, res in pipe.entries:
                    vec = expr.eval_vec(br, br.nrows, produced)
                    if vec is not None:
                        vals = [
                            "NaN" if math.isnan(v) else format_number(v)
                            for v in vec.tolist()]
                        out._cols[res] = vals
                    else:
                        vals = []
                        for i in range(br.nrows):
                            v = expr.eval_row(get, i, rng)
                            vals.append("NaN" if math.isnan(v)
                                        else format_number(v))
                        out._cols[res] = vals
                    produced[res] = vec
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- unpack_json / unpack_logfmt / unpack_syslog ----------------

def _flatten_json(obj, prefix="") -> list:
    """Flatten a JSON object into (path, scalar-string) pairs the way the
    reference unpacks (nested keys joined with '.')."""
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out.extend(_flatten_json(v, key))
            elif isinstance(v, list):
                out.append((key, json.dumps(v, separators=(",", ":"),
                                            ensure_ascii=False)))
            elif isinstance(v, bool):
                out.append((key, "true" if v else "false"))
            elif v is None:
                out.append((key, ""))
            elif isinstance(v, str):
                out.append((key, v))
            else:
                out.append((key, format_number(v)
                            if isinstance(v, float) else str(v)))
    return out


def parse_logfmt(s: str) -> list:
    """k=v pairs with Go-quoted values (reference logfmt_parser.go).

    Reference edge semantics (logfmt_parser_test.go): a bare word becomes
    a key with an empty value; a bare `=value` goes to `_msg`."""
    out = []
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i] == " ":
            i += 1
        if i >= n:
            break
        j = i
        while j < n and s[j] not in " =":
            j += 1
        key = s[i:j]
        if j >= n or s[j] == " ":
            out.append((key, ""))       # bare word: empty value
            i = j
            continue
        if not key:
            key = "_msg"                # `=value` with no key
        i = j + 1
        if i < n and s[i] in "\"`":
            v, off = _try_unquote_prefix(s[i:])
            if off >= 0:
                out.append((key, v))
                i += off
                continue
        sp = s.find(" ", i)
        if sp < 0:
            sp = n
        out.append((key, s[i:sp]))
        i = sp
    return out


class _UnpackBase(Pipe):
    """Shared unpack scaffolding: from-field, field filter, result_prefix,
    keep_original_fields/skip_empty_results, if-guard."""

    def __init__(self, from_field="_msg", fields=None, result_prefix="",
                 keep_original_fields=False, skip_empty_results=False,
                 iff=None):
        self.from_field = from_field
        self.fields = fields or []
        self.result_prefix = result_prefix
        self.keep_original_fields = keep_original_fields
        self.skip_empty_results = skip_empty_results
        self.iff = iff

    def _unpack_value(self, v: str) -> list:
        raise NotImplementedError

    def to_string(self):
        s = self.name + if_str(self.iff)
        if self.from_field != "_msg":
            s += " from " + quote_token_if_needed(self.from_field)
        if self.fields:
            s += " fields (" + ", ".join(self.fields) + ")"
        if self.result_prefix:
            s += " result_prefix " + quote_token_if_needed(self.result_prefix)
        if self.keep_original_fields:
            s += " keep_original_fields"
        if self.skip_empty_results:
            s += " skip_empty_results"
        return s

    def needed_fields(self):
        out = {self.from_field}
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self
        allow = set(pipe.fields) or None
        allow_prefixes = tuple(f[:-1] for f in pipe.fields
                               if f.endswith("*")) if allow else ()

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                vals = br.column(pipe.from_field)
                out_cols: dict[str, list] = {}
                prev_v, prev = None, None
                for i in range(br.nrows):
                    if mask is not None and not mask[i]:
                        continue
                    v = vals[i]
                    if v != prev_v:
                        prev_v, prev = v, pipe._unpack_value(v)
                    for k, val in prev:
                        if allow is not None and k not in allow and \
                                not (allow_prefixes and
                                     k.startswith(allow_prefixes)):
                            continue
                        key = pipe.result_prefix + k
                        col = out_cols.get(key)
                        if col is None:
                            col = out_cols[key] = [""] * br.nrows
                        col[i] = val
                names = list(out_cols)
                _merge_extracted(br, out_cols, names, mask,
                                 pipe.keep_original_fields,
                                 pipe.skip_empty_results)
                out = br.materialize()
                for k in names:
                    out._cols[k] = out_cols[k]
                self.next_p.write_block(out)
        return P(next_p)


class PipeUnpackJson(_UnpackBase):
    name = "unpack_json"

    def _unpack_value(self, v):
        try:
            obj = json.loads(v)
        except (ValueError, RecursionError):
            return []
        return _flatten_json(obj) if isinstance(obj, dict) else []


class PipeUnpackLogfmt(_UnpackBase):
    name = "unpack_logfmt"

    def _unpack_value(self, v):
        return parse_logfmt(v)


class PipeUnpackSyslog(_UnpackBase):
    name = "unpack_syslog"

    def __init__(self, *args, offset_ns=0, **kw):
        super().__init__(*args, **kw)
        self.offset_ns = offset_ns

    def to_string(self):
        s = super().to_string()
        if self.offset_ns:
            # render offset right after the from clause like the reference
            s += f" offset {self.offset_ns // 3600_000_000_000}h"
        return s

    def _unpack_value(self, v):
        fields = parse_syslog_message(v, tz_offset_ns=self.offset_ns)
        return [(k, val) for k, val in fields if k != "_msg"] + \
            [(k, val) for k, val in fields if k == "_msg" and val != v]


class PipeUnpackWords(_UnpackBase):
    """unpack_words: tokenize the field into a JSON array of words
    (reference pipe_unpack_words.go)."""

    name = "unpack_words"

    def __init__(self, from_field="_msg", dst_field="words",
                 drop_duplicates=False, iff=None):
        super().__init__(from_field=from_field, iff=iff)
        self.dst_field = dst_field
        self.drop_duplicates = drop_duplicates

    def to_string(self):
        s = "unpack_words"
        if self.from_field != "_msg":
            s += " from " + quote_token_if_needed(self.from_field)
        if self.dst_field != "words":
            s += " as " + quote_token_if_needed(self.dst_field)
        if self.drop_duplicates:
            s += " drop_duplicates"
        return s

    def _unpack_value(self, v):
        toks = tokenize_string(v)
        if self.drop_duplicates:
            toks = list(dict.fromkeys(toks))
        return [(self.dst_field,
                 json.dumps(toks, separators=(",", ":"),
                            ensure_ascii=False))]


# ---------------- replace / replace_regexp ----------------

@dataclass(repr=False)
class PipeReplace(Pipe):
    old: str
    new: str
    field: str = "_msg"
    limit: int = 0
    iff: object = None
    regexp: bool = False

    name = "replace"

    def __post_init__(self):
        if self.regexp:
            self._re = re.compile(self.old)

    def to_string(self):
        nm = "replace_regexp" if self.regexp else "replace"
        s = nm + if_str(self.iff) + \
            f" ({quote_token_if_needed(self.old)}, " \
            f"{quote_token_if_needed(self.new)})"
        if self.field != "_msg":
            s += " at " + quote_token_if_needed(self.field)
        if self.limit:
            s += f" limit {self.limit}"
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
                limit = pipe.limit if pipe.limit > 0 else 0
                out_vals = []
                for i, v in enumerate(vals):
                    if mask is not None and not mask[i]:
                        out_vals.append(v)
                        continue
                    if pipe.regexp:
                        out_vals.append(pipe._re.sub(pipe.new, v,
                                                     count=limit))
                    else:
                        out_vals.append(v.replace(pipe.old, pipe.new,
                                                  limit or -1))
                out = br.materialize()
                out._cols[pipe.field] = out_vals
                self.next_p.write_block(out)
        return P(next_p)


# ---------------- top ----------------

@dataclass(repr=False)
class PipeTop(Pipe):
    by: list
    limit: int = 10
    hits_field: str = "hits"
    rank_field: str = ""

    name = "top"

    def input_fields(self, out_needed):
        return set(self.by) if self.by else {"*"}

    def to_string(self):
        s = "top"
        if self.limit != 10:
            s += f" {self.limit}"
        if self.by:
            s += " by (" + ", ".join(self.by) + ")"
        if self.hits_field != "hits":
            s += " hits as " + quote_token_if_needed(self.hits_field)
        if self.rank_field:
            s += " rank as " + quote_token_if_needed(self.rank_field)
        return s

    def needed_fields(self):
        return set(self.by)

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.counts: dict[tuple, int] = {}
                self.budget = MemoryBudget(0.4, "top")

            def write_block(self, br):
                if len(pipe.by) == 1:
                    # typed fast path: const/dict columns count through
                    # their stored codes, no per-row Python
                    pairs = br.dict_value_counts(pipe.by[0])
                    if pairs is not None:
                        for v, cnt in pairs:
                            key = (v,)
                            if key not in self.counts:
                                self.counts[key] = cnt
                                self.budget.add(len(v) + 80)
                            else:
                                self.counts[key] += cnt
                        return
                if pipe.by:
                    cols = [br.column(f) for f in pipe.by]
                    keys = (tuple(c[i] for c in cols)
                            for i in range(br.nrows))
                else:
                    # keys carry (field, value) pairs so blocks with
                    # different column sets mix safely
                    names = br.column_names()
                    cols = [(f, br.column(f)) for f in names]
                    keys = (tuple((f, c[i]) for f, c in cols if c[i] != "")
                            for i in range(br.nrows))
                for key in keys:
                    if key not in self.counts:
                        self.counts[key] = 1
                        self.budget.add(sum(len(str(k)) for k in key) + 80)
                    else:
                        self.counts[key] += 1

            def flush(self):
                # hits desc, then key asc (reference pipe_top ordering)
                items = sorted(self.counts.items(),
                               key=lambda kv: (-kv[1], kv[0]))
                items = items[:pipe.limit]
                if pipe.by:
                    cols = {f: [k[j] for k, _ in items]
                            for j, f in enumerate(pipe.by)}
                else:
                    names: dict[str, None] = {}
                    for k, _h in items:
                        for f, _v in k:
                            names.setdefault(f, None)
                    cols = {f: [dict(k).get(f, "") for k, _ in items]
                            for f in names}
                cols[pipe.hits_field] = [str(h) for _, h in items]
                if pipe.rank_field:
                    cols[pipe.rank_field] = [str(i + 1)
                                             for i in range(len(items))]
                self.next_p.write_block(BlockResult.from_columns(cols)
                                        if items else BlockResult(0))
                self.next_p.flush()
        return P(next_p)


# ---------------- drop_empty_fields / len / pack / sample / unroll ----------

@dataclass(repr=False)
class PipeDropEmptyFields(Pipe):
    name = "drop_empty_fields"

    def to_string(self):
        return "drop_empty_fields"

    def make_processor(self, next_p):
        class P(Processor):
            def write_block(self, br):
                out = br.materialize()
                # drop all-empty columns; drop rows with no non-empty field
                keep_cols = {n: v for n, v in out._cols.items()
                             if any(x != "" for x in v)}
                if len(keep_cols) != len(out._cols):
                    out._cols = keep_cols
                if keep_cols:
                    rows_mask = np.zeros(out.nrows, dtype=bool)
                    for v in keep_cols.values():
                        for i, x in enumerate(v):
                            if x != "":
                                rows_mask[i] = True
                    if not rows_mask.all():
                        out = out.filter_rows(rows_mask)
                elif out.nrows:
                    out = BlockResult(0)
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipeLen(Pipe):
    field: str
    result_field: str = "_msg"

    name = "len"

    def to_string(self):
        s = f"len({quote_token_if_needed(self.field)})"
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
                    str(len(v.encode("utf-8"))) for v in vals]
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipePackJson(Pipe):
    result_field: str = "_msg"
    fields: list = dc_field(default_factory=list)
    logfmt: bool = False

    name = "pack_json"

    def to_string(self):
        s = "pack_logfmt" if self.logfmt else "pack_json"
        if self.fields:
            s += " fields (" + ", ".join(self.fields) + ")"
        if self.result_field != "_msg":
            s += " as " + quote_token_if_needed(self.result_field)
        return s

    def needed_fields(self):
        return set(self.fields)

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                names = pipe.fields or br.column_names()
                cols = [(n, br.column(n)) for n in names]
                out_vals = []
                for i in range(br.nrows):
                    if pipe.logfmt:
                        parts = []
                        for n, c in cols:
                            v = c[i]
                            if re.search(r'[\s"=]', v) or v == "":
                                v = json.dumps(v, ensure_ascii=False)
                            parts.append(f"{n}={v}")
                        out_vals.append(" ".join(parts))
                    else:
                        out_vals.append(json.dumps(
                            {n: c[i] for n, c in cols},
                            separators=(",", ":"), ensure_ascii=False))
                out = br.materialize()
                out._cols[pipe.result_field] = out_vals
                self.next_p.write_block(out)
        return P(next_p)


@dataclass(repr=False)
class PipeSample(Pipe):
    n: int
    rng: random.Random | None = dc_field(default=None, compare=False)

    name = "sample"

    def to_string(self):
        return f"sample {self.n}"

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.rng = pipe.rng if pipe.rng is not None \
                    else random.Random()
                self.next_row = self._step() - 1
                self.seen = 0

            def _step(self):
                # expected-gap sampling: mean gap == n (pipe_sample.go)
                if pipe.n <= 1:
                    return 1
                return 1 + int(self.rng.uniform(0, 2 * (pipe.n - 1)))

            def write_block(self, br):
                if pipe.n <= 1:
                    self.next_p.write_block(br)
                    return
                keep = []
                lo = self.seen
                hi = self.seen + br.nrows
                while self.next_row < hi:
                    keep.append(self.next_row - lo)
                    self.next_row += self._step()
                self.seen = hi
                if keep:
                    mask = np.zeros(br.nrows, dtype=bool)
                    mask[keep] = True
                    self.next_p.write_block(br.filter_rows(mask))
        return P(next_p)


def unpack_json_array(v: str) -> list:
    try:
        arr = json.loads(v)
    except (ValueError, RecursionError):
        return []
    if not isinstance(arr, list):
        return []
    out = []
    for x in arr:
        if isinstance(x, str):
            out.append(x)
        elif isinstance(x, bool):
            out.append("true" if x else "false")
        elif x is None:
            out.append("")
        elif isinstance(x, (dict, list)):
            out.append(json.dumps(x, separators=(",", ":"),
                                  ensure_ascii=False))
        else:
            out.append(format_number(x) if isinstance(x, float) else str(x))
    return out


@dataclass(repr=False)
class PipeUnroll(Pipe):
    fields: list
    iff: object = None

    name = "unroll"

    def to_string(self):
        return "unroll" + if_str(self.iff) + \
            " by (" + ", ".join(self.fields) + ")"

    def needed_fields(self):
        out = set(self.fields)
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def write_block(self, br):
                mask = if_mask(pipe.iff, br)
                names = br.column_names()
                cols = {n: br.column(n) for n in names}
                out_cols: dict[str, list] = {n: [] for n in names}
                for n in pipe.fields:
                    out_cols.setdefault(n, [])
                for i in range(br.nrows):
                    if mask is not None and not mask[i]:
                        unrolled = {f: [cols.get(f, [""] * br.nrows)[i]]
                                    for f in pipe.fields}
                        count = 1
                    else:
                        unrolled = {
                            f: unpack_json_array(
                                cols.get(f, [""] * br.nrows)[i])
                            for f in pipe.fields}
                        count = max((len(v) for v in unrolled.values()),
                                    default=0) or 1
                    for k in range(count):
                        for n in out_cols:
                            if n in unrolled:
                                vs = unrolled[n]
                                out_cols[n].append(vs[k] if k < len(vs)
                                                   else "")
                            else:
                                out_cols[n].append(cols[n][i])
                self.next_p.write_block(
                    BlockResult.from_columns(out_cols)
                    if out_cols and any(out_cols.values())
                    else BlockResult(0))
        return P(next_p)


# ---------------- field_names / field_values / blocks_count ----------------

@dataclass(repr=False)
class PipeFieldNames(Pipe):
    result_name: str = "name"

    name = "field_names"

    def to_string(self):
        s = "field_names"
        if self.result_name != "name":
            s += " as " + quote_token_if_needed(self.result_name)
        return s

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.hits: dict[str, int] = {}

            def write_block(self, br):
                for n in br.column_names():
                    cnt = sum(1 for v in br.column(n) if v != "")
                    if n in ("_time", "_stream", "_stream_id"):
                        cnt = br.nrows
                    if cnt:
                        self.hits[n] = self.hits.get(n, 0) + cnt

            def flush(self):
                keys = sorted(self.hits)
                cols = {pipe.result_name: list(keys),
                        "hits": [str(self.hits[k]) for k in keys]}
                self.next_p.write_block(BlockResult.from_columns(cols)
                                        if keys else BlockResult(0))
                self.next_p.flush()
        return P(next_p)


@dataclass(repr=False)
class PipeFieldValues(Pipe):
    field: str
    limit: int = 0

    name = "field_values"

    def input_fields(self, out_needed):
        return {self.field}

    def to_string(self):
        s = "field_values " + quote_token_if_needed(self.field)
        if self.limit:
            s += f" limit {self.limit}"
        return s

    def needed_fields(self):
        return {self.field}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.hits: dict[str, int] = {}

            def write_block(self, br):
                for v in br.column(pipe.field):
                    if v != "":
                        self.hits[v] = self.hits.get(v, 0) + 1

            def flush(self):
                keys = sorted(self.hits)
                if pipe.limit and len(keys) > pipe.limit:
                    keys = keys[:pipe.limit]
                cols = {pipe.field: list(keys),
                        "hits": [str(self.hits[k]) for k in keys]}
                self.next_p.write_block(BlockResult.from_columns(cols)
                                        if keys else BlockResult(0))
                self.next_p.flush()
        return P(next_p)


@dataclass(repr=False)
class PipeFacets(Pipe):
    """Per-field top values with hit counts (reference pipe_facets.go:
    output columns field_name/field_value/hits)."""

    limit: int = 10
    max_values_per_field: int = 1000
    max_value_len: int = 1000
    keep_const_fields: bool = False

    name = "facets"

    def to_string(self):
        s = "facets"
        if self.limit != 10:
            s += f" {self.limit}"
        if self.max_values_per_field != 1000:
            s += f" max_values_per_field {self.max_values_per_field}"
        if self.max_value_len != 1000:
            s += f" max_value_len {self.max_value_len}"
        if self.keep_const_fields:
            s += " keep_const_fields"
        return s

    def input_fields(self, out_needed):
        return {"*"}

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.counts: dict[str, dict[str, int]] = {}
                self.rows_total = 0

            def write_block(self, br):
                self.rows_total += br.nrows
                names = [n for n in br.column_names()
                         if n not in ("_time", "_stream_id", "_stream")]
                for n in names:
                    per = self.counts.setdefault(n, {})
                    if per is None:
                        continue
                    for v in br.column(n):
                        if v == "" or len(v) > pipe.max_value_len:
                            continue
                        if len(per) >= pipe.max_values_per_field and \
                                v not in per:
                            # too many distinct values: not a facet
                            self.counts[n] = None
                            break
                        per[v] = per.get(v, 0) + 1

            def flush(self):
                out = {"field_name": [], "field_value": [], "hits": []}
                for field in sorted(self.counts):
                    per = self.counts[field]
                    if per is None:
                        continue
                    if not pipe.keep_const_fields and len(per) == 1 and \
                            next(iter(per.values())) == self.rows_total:
                        continue  # constant field: not a useful facet
                    items = sorted(per.items(),
                                   key=lambda kv: (-kv[1], kv[0]))
                    for v, hits in items[:pipe.limit]:
                        out["field_name"].append(field)
                        out["field_value"].append(v)
                        out["hits"].append(str(hits))
                self.next_p.write_block(
                    BlockResult.from_columns(out)
                    if out["field_name"] else BlockResult(0))
                self.next_p.flush()
        return P(next_p)


@dataclass(repr=False)
class PipeBlocksCount(Pipe):
    result_name: str = "blocks_count"

    name = "blocks_count"

    def input_fields(self, out_needed):
        return set()

    def to_string(self):
        s = "blocks_count"
        if self.result_name != "blocks_count":
            s += " as " + quote_token_if_needed(self.result_name)
        return s

    def make_processor(self, next_p):
        pipe = self

        class P(Processor):
            def __init__(self, np_):
                super().__init__(np_)
                self.blocks = 0

            def write_block(self, br):
                if br.nrows:
                    self.blocks += 1

            def flush(self):
                self.next_p.write_block(BlockResult.from_columns(
                    {pipe.result_name: [str(self.blocks)]}))
                self.next_p.flush()
        return P(next_p)


# ---------------- parsers + registration ----------------

def _parse_quoted_arg(lex) -> str:
    from .parser import _get_compound_token
    return _get_compound_token(lex, stop=(",", ")", "|", ""))


def _parse_from_clause(lex) -> str:
    if lex.is_keyword("from"):
        lex.next_token()
        return _parse_field_name(lex)
    return "_msg"


def _parse_unpack_opts(lex, pipe) -> None:
    while True:
        if lex.is_keyword("result_prefix"):
            lex.next_token()
            pipe.result_prefix = _parse_field_name(lex)
        elif lex.is_keyword("keep_original_fields"):
            pipe.keep_original_fields = True
            lex.next_token()
        elif lex.is_keyword("skip_empty_results"):
            pipe.skip_empty_results = True
            lex.next_token()
        elif lex.is_keyword("fields"):
            lex.next_token()
            pipe.fields = _parse_paren_fields(lex)
        else:
            return


def _parse_extract(lex):
    iff = maybe_if(lex)
    pattern = _parse_quoted_arg(lex)
    p = PipeExtract(pattern, iff=iff)
    p.from_field = _parse_from_clause(lex)
    _parse_unpack_opts(lex, p)
    return p


def _parse_extract_regexp(lex):
    iff = maybe_if(lex)
    pattern = _parse_quoted_arg(lex)
    p = PipeExtractRegexp(pattern, iff=iff)
    p.from_field = _parse_from_clause(lex)
    _parse_unpack_opts(lex, p)
    return p


def _parse_format(lex):
    iff = maybe_if(lex)
    fmt = _parse_quoted_arg(lex)
    p = PipeFormat(fmt, iff=iff)
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_field = _parse_field_name(lex)
    while True:
        if lex.is_keyword("keep_original_fields"):
            p.keep_original_fields = True
            lex.next_token()
        elif lex.is_keyword("skip_empty_results"):
            p.skip_empty_results = True
            lex.next_token()
        else:
            break
    return p


def _parse_math(lex):
    entries = []
    while True:
        expr = parse_math_expr(lex)
        if lex.is_keyword("as"):
            lex.next_token()
            res = _parse_field_name(lex)
            if not res:
                raise ParseError("math: missing result field after 'as'")
        elif lex.is_keyword(",", "|", ")") or lex.is_end():
            # optional result name: default to the expression rendering
            # (reference allows `math a / b default c`)
            res = expr.to_string()
        else:
            res = _parse_field_name(lex)
            if not res:
                raise ParseError(
                    "math: missing result field after expression")
        entries.append((expr, res))
        if lex.is_keyword(","):
            lex.next_token()
            continue
        break
    return PipeMath(entries)


def _parse_unpack_json(lex):
    iff = maybe_if(lex)
    p = PipeUnpackJson(iff=iff)
    p.from_field = _parse_from_clause(lex)
    _parse_unpack_opts(lex, p)
    return p


def _parse_unpack_logfmt(lex):
    iff = maybe_if(lex)
    p = PipeUnpackLogfmt(iff=iff)
    p.from_field = _parse_from_clause(lex)
    _parse_unpack_opts(lex, p)
    return p


def _parse_unpack_syslog(lex):
    iff = maybe_if(lex)
    p = PipeUnpackSyslog(iff=iff)
    p.from_field = _parse_from_clause(lex)
    if lex.is_keyword("offset"):
        lex.next_token()
        d = parse_duration(lex.token)
        if d is None:
            raise ParseError(f"bad unpack_syslog offset {lex.token!r}")
        p.offset_ns = d
        lex.next_token()
    _parse_unpack_opts(lex, p)
    return p


def _parse_unpack_words(lex):
    iff = maybe_if(lex)
    p = PipeUnpackWords(iff=iff)
    p.from_field = _parse_from_clause(lex)
    if lex.is_keyword("as"):
        lex.next_token()
        p.dst_field = _parse_field_name(lex)
    if lex.is_keyword("drop_duplicates"):
        p.drop_duplicates = True
        lex.next_token()
    return p


def _parse_replace(lex, regexp: bool):
    iff = maybe_if(lex)
    if not lex.is_keyword("("):
        raise ParseError("missing '(' after replace")
    lex.next_token()
    old = _parse_quoted_arg(lex)
    if not lex.is_keyword(","):
        raise ParseError("replace needs (old, new)")
    lex.next_token()
    new = _parse_quoted_arg(lex)
    if not lex.is_keyword(")"):
        raise ParseError("missing ')' after replace args")
    lex.next_token()
    p = PipeReplace(old, new, iff=iff, regexp=regexp)
    if lex.is_keyword("at"):
        lex.next_token()
        p.field = _parse_field_name(lex)
    if lex.is_keyword("limit"):
        lex.next_token()
        p.limit = _parse_uint(lex, "limit")
    if regexp:
        p.__post_init__()
    return p


def _parse_top(lex):
    limit = 10
    if not lex.is_keyword("by", "(") and not lex.is_end() and \
            not lex.is_keyword("|") and lex.token.isdigit():
        limit = _parse_uint(lex, "top limit")
    by = []
    if lex.is_keyword("by"):
        lex.next_token()
    if lex.is_keyword("("):
        by = _parse_paren_fields(lex)
    elif not lex.is_end() and not lex.is_keyword("|", "hits", "rank"):
        # bare field list: `top b hits abc` (reference parsePipeTop)
        while True:
            by.append(_parse_field_name(lex))
            if lex.is_keyword(","):
                lex.next_token()
                continue
            break
    p = PipeTop(by, limit=limit)
    while True:
        if lex.is_keyword("hits"):
            lex.next_token()
            if lex.is_keyword("as"):
                lex.next_token()
            p.hits_field = _parse_field_name(lex)
        elif lex.is_keyword("rank"):
            lex.next_token()
            if lex.is_keyword("as"):
                lex.next_token()
            if lex.is_end() or lex.is_keyword("|"):
                p.rank_field = "rank"     # bare `rank`
            else:
                p.rank_field = _parse_field_name(lex)
        else:
            break
    return p


def _parse_len(lex):
    if not lex.is_keyword("("):
        raise ParseError("missing '(' after len")
    lex.next_token()
    fld = _parse_field_name(lex)
    if not lex.is_keyword(")"):
        raise ParseError("missing ')' after len field")
    lex.next_token()
    p = PipeLen(fld)
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_field = _parse_field_name(lex)
    elif not lex.is_end() and not lex.is_keyword("|"):
        p.result_field = _parse_field_name(lex)
    return p


def _parse_pack(lex, logfmt: bool):
    p = PipePackJson(logfmt=logfmt)
    if lex.is_keyword("fields"):
        lex.next_token()
        p.fields = _parse_paren_fields(lex)
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_field = _parse_field_name(lex)
    elif not lex.is_end() and not lex.is_keyword("|"):
        p.result_field = _parse_field_name(lex)
    return p


def _parse_sample(lex):
    n = _parse_uint(lex, "sample")
    if n < 1:
        raise ParseError("sample must be >= 1")
    return PipeSample(n)


def _parse_unroll(lex):
    iff = maybe_if(lex)
    if lex.is_keyword("by"):
        lex.next_token()
    fields = _parse_paren_fields(lex)
    if not fields:
        raise ParseError("unroll needs at least one field")
    return PipeUnroll(fields, iff=iff)


def _parse_field_names(lex):
    p = PipeFieldNames()
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_name = _parse_field_name(lex)
    return p


def _parse_field_values(lex):
    fld = _parse_field_name(lex)
    p = PipeFieldValues(fld)
    if lex.is_keyword("limit"):
        lex.next_token()
        p.limit = _parse_uint(lex, "limit")
    return p


def _parse_facets(lex):
    p = PipeFacets()
    if not lex.is_end() and not lex.is_keyword("|") and \
            lex.token.isdigit():
        p.limit = _parse_uint(lex, "facets limit")
    while True:
        if lex.is_keyword("max_values_per_field"):
            lex.next_token()
            p.max_values_per_field = _parse_uint(lex,
                                                 "max_values_per_field")
        elif lex.is_keyword("max_value_len"):
            lex.next_token()
            p.max_value_len = _parse_uint(lex, "max_value_len")
        elif lex.is_keyword("keep_const_fields"):
            p.keep_const_fields = True
            lex.next_token()
        else:
            break
    return p


def _parse_blocks_count(lex):
    p = PipeBlocksCount()
    if lex.is_keyword("as"):
        lex.next_token()
        p.result_name = _parse_field_name(lex)
    return p


def _parse_drop_empty_fields(lex):
    return PipeDropEmptyFields()


register_pipe("extract", _parse_extract)
register_pipe("extract_regexp", _parse_extract_regexp)
register_pipe("format", _parse_format)
register_pipe("fmt", _parse_format)     # reference alias
register_pipe("math", _parse_math)
register_pipe("eval", _parse_math)
register_pipe("unpack_json", _parse_unpack_json)
register_pipe("unpack_logfmt", _parse_unpack_logfmt)
register_pipe("unpack_syslog", _parse_unpack_syslog)
register_pipe("unpack_words", _parse_unpack_words)
register_pipe("replace", lambda lex: _parse_replace(lex, regexp=False))
register_pipe("replace_regexp", lambda lex: _parse_replace(lex, regexp=True))
register_pipe("top", _parse_top)
register_pipe("len", _parse_len)
register_pipe("pack_json", lambda lex: _parse_pack(lex, logfmt=False))
register_pipe("pack_logfmt", lambda lex: _parse_pack(lex, logfmt=True))
register_pipe("sample", _parse_sample)
register_pipe("unroll", _parse_unroll)
register_pipe("facets", _parse_facets)
register_pipe("field_names", _parse_field_names)
register_pipe("field_values", _parse_field_values)
register_pipe("blocks_count", _parse_blocks_count)
register_pipe("drop_empty_fields", _parse_drop_empty_fields)
