"""LogsQL filter tree: nodes + host (CPU) block evaluation.

Each node ANDs itself into a numpy bool bitmap over one storage block
(`apply_to_block`).  Value filters first probe the column's token bloom
(a required token absent from the bloom kills the block), then scan:
a VT_STRING column is matched over its byte arena in one pass
(`_arena_scan`; `contains_all`, `contains_any` and `seq` AND or OR one
pass a phrase, `seq` checking the order of its survivors with its
predicate), every other encoding through the per-value predicate,
evaluated once per dict entry or const.  The predicates in
logsql/matchers.py are the semantics both paths and the device scan
must reproduce.

Any-case leaves (`i(...)`) scan an ASCII-lowered copy of the arena and
settle rows holding a byte >= 0x80 with their predicate, as Unicode
lowering can differ from the byte fold there.  A regexp ANDs one
arena scan per mandatory literal run (`regex_literal_runs`) and runs
`re.search` on the survivors; `A.*B` with literal A and B is decided
per row from A's first and B's last occurrence (`_pair_rows`, the
device pair kernel's predicate), only rows holding a newline going to
`re.search`.

Numeric filters (`range`, `>`/`<`, `ipv4_range`) compare a typed
column's numbers at once, after its header's min/max rules the block
out or not; `len_range` counts a string column's code points from its
arena.  Per-block constant filters (`_stream:{...}`, `_stream_id:`,
`value_type()`) test the block once; `day_range`/`week_range` and the
cross-field filters (`eq_field`, `le_field`, `lt_field`) go row by row.

`apply_to_values(get_values, n)` evaluates a node over rows already in
the pipe chain (the `where` pipe): `get_values(field)` gives a column's
strings.  `needed_fields` names the fields a node reads.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

from ..engine.block_search import BlockSearch, visit_values
from ..storage.stream_filter import parse_stream_tags
from ..storage.bloom import bloom_contains_all
from ..storage.values_encoder import (VT_FLOAT64, VT_INT64, VT_IPV4,
                                      VT_STRING, VT_UINT8, VT_UINT16,
                                      VT_UINT32, VT_UINT64)
from ..utils.hashing import cached_token_hashes
from ..utils.tokenizer import is_word_char_table, tokenize_string
from .duration import parse_rfc3339
from .matchers import (is_word_char, match_any_case_phrase,
                       match_any_case_prefix, match_exact_prefix,
                       match_ipv4_range, match_len_range, match_phrase,
                       match_prefix, match_range, match_sequence,
                       match_string_range, match_value_type, parse_number)

_NUMERIC_VTS = (VT_UINT8, VT_UINT16, VT_UINT32, VT_UINT64, VT_INT64,
                VT_FLOAT64)

# scan modes of the host arena scan and the device scan (gpu/kernels.py)
MODE_PHRASE = 0        # substring with word boundaries on both sides
MODE_PREFIX = 1        # substring with a word boundary before only
MODE_SUBSTRING = 2     # plain substring
MODE_EXACT = 3         # whole value equality
MODE_EXACT_PREFIX = 4  # value startswith


def quote_str(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _q(field: str) -> str:
    return f"{field}:" if field else ""


def canonical_field(field: str) -> str:
    """An empty field name targets the message column."""
    return field or "_msg"


def iter_and_path_token_leaves(f):
    """(field, tokens, leaf) of each leaf on the top-level AND path with
    required word tokens: where one of its tokens is in no block of a
    part, the query matches nothing there (storage/filterbank.py
    part_aggregate_prunes, maplet_prune_candidates).  Only FilterAnd is
    recursed: under OR or NOT an empty leaf says nothing of the tree."""
    if isinstance(f, FilterAnd):
        for sub in f.filters:
            yield from iter_and_path_token_leaves(sub)
    elif isinstance(f, _ValuePredFilter):
        toks = f._tokens()
        if toks:
            yield canonical_field(f.field), toks, f


class Filter:
    def apply_to_block(self, bs: BlockSearch, bm: np.ndarray) -> None:
        raise NotImplementedError

    def apply_to_values(self, get_values, nrows: int) -> np.ndarray:
        raise NotImplementedError

    def needed_fields(self) -> set:
        return set()

    def to_string(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.to_string()}>"


def _arena_scan(col, pat: bytes, mode: int, starts_tok: bool,
                ends_tok: bool, arena=None) -> np.ndarray:
    """One pass over a VT_STRING column's byte arena (or `arena`, bytes
    laid out as the column's) -> bool[R].

    Byte-level matching equals the str-level predicates: values are
    valid UTF-8 (a pattern cannot match from inside a multibyte
    character) and every byte >= 0x80 is a word byte, as every
    non-ASCII character is a word character."""
    offs, lens = col.offsets, col.lengths
    if arena is None:
        arena = col.arena
    out = np.zeros(offs.shape[0], dtype=bool)
    plen = len(pat)
    if mode in (MODE_EXACT, MODE_EXACT_PREFIX):
        cand = lens == plen if mode == MODE_EXACT else lens >= plen
        idx = np.nonzero(cand)[0]
        if idx.size:
            got = arena[offs[idx][:, None] + np.arange(plen)]
            out[idx[(got == np.frombuffer(pat, dtype=np.uint8)).all(1)]] = \
                True
        return out
    offs = offs.astype(np.int64)
    ends = offs + lens
    row, pos = _occurrences(arena, offs, ends, pat)
    tail = pos + plen
    ok = np.ones(pos.shape[0], dtype=bool)
    word = is_word_char_table()
    if starts_tok and mode in (MODE_PHRASE, MODE_PREFIX):
        prev = arena[np.maximum(pos - 1, 0)]
        ok &= (pos == offs[row]) | ~word[prev]
    if ends_tok and mode == MODE_PHRASE:
        nxt = arena[np.minimum(tail, arena.shape[0] - 1)]
        ok &= (tail >= ends[row]) | ~word[nxt]
    out[row[ok]] = True
    return out


def _occurrences(arena: np.ndarray, offs: np.ndarray, ends: np.ndarray,
                 pat: bytes):
    """(row, arena position) of every occurrence of `pat` lying wholly
    inside one row (int64 `offs`/`ends`), overlapping ones included, in
    arena order."""
    p = np.frombuffer(pat, dtype=np.uint8)
    n = arena.shape[0] - p.shape[0] + 1
    if n <= 0 or not offs.shape[0]:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    pos = np.nonzero(arena[:n] == p[0])[0]
    for j in range(1, p.shape[0]):
        pos = pos[arena[pos + j] == p[j]]
    row = np.searchsorted(offs, pos, side="right") - 1
    ok = (row >= 0) & (pos + p.shape[0] <= ends[np.maximum(row, 0)])
    return row[ok], pos[ok]


def _rows_holding(arena: np.ndarray, offs: np.ndarray, ends: np.ndarray,
                  byte_mask: np.ndarray) -> np.ndarray:
    """bool[R]: the row holds a byte that `byte_mask` (bool per arena
    byte) marks."""
    return _rows_holding_count(arena, offs, ends, byte_mask) > 0


def _rows_holding_count(arena: np.ndarray, offs: np.ndarray,
                        ends: np.ndarray, byte_mask: np.ndarray
                        ) -> np.ndarray:
    """int64[R]: how many bytes of each row `byte_mask` marks."""
    cs = np.zeros(arena.shape[0] + 1, dtype=np.int64)
    np.cumsum(byte_mask, out=cs[1:])
    return cs[ends] - cs[offs]


def _arena_compare(col, rows: np.ndarray, ref: bytes) -> np.ndarray:
    """int[len(rows)]: the sign of each listed VT_STRING row's bytes
    compared with `ref` in lexicographic order (a proper prefix sorts
    first: bytes past a row's end read as -1)."""
    k = len(ref) + 1
    j = np.arange(k)
    inside = j < col.lengths[rows][:, None]
    mat = np.full((rows.shape[0], k), -1, dtype=np.int16)
    if col.arena.size:
        pos = np.minimum(col.offsets[rows].astype(np.int64)[:, None] + j,
                         col.arena.size - 1)
        mat = np.where(inside, col.arena[pos].astype(np.int16), mat)
    want = np.full(k, -1, dtype=np.int16)
    want[:len(ref)] = np.frombuffer(ref, dtype=np.uint8)
    d = mat - want
    # the first differing byte decides; none differs: d[:, 0] is 0
    return np.sign(d[np.arange(rows.shape[0]), (d != 0).argmax(axis=1)])


def _pair_rows(col, a: bytes, b: bytes):
    """`A.*B` per row of a VT_STRING column -> (definite, verify) bool[R]:
    ordered = A and B occur and A's first occurrence ends at or before
    the start of B's last; rows holding a newline (which `.` does not
    cross) go to verify, the others are definite."""
    arena = col.arena
    offs = col.offsets.astype(np.int64)
    ends = offs + col.lengths
    r = offs.shape[0]
    first_end = np.full(r, np.iinfo(np.int64).max, dtype=np.int64)
    rows, pos = _occurrences(arena, offs, ends, a)
    np.minimum.at(first_end, rows, pos + len(a))
    last_b = np.full(r, -1, dtype=np.int64)
    rows, pos = _occurrences(arena, offs, ends, b)
    np.maximum.at(last_b, rows, pos)
    ordered = first_end <= last_b
    nl = _rows_holding(arena, offs, ends, arena == 0x0A)
    return ordered & ~nl, ordered & nl


def _bloom_prunes(bs: BlockSearch, fld: str, f) -> bool:
    """True where the column's bloom proves that no row holds every
    required token of filter `f`."""
    tokens = f._tokens()
    if not tokens:
        return False
    words = bs.bloom(fld)
    return words is not None and words.shape[0] > 0 and \
        not bloom_contains_all(words, cached_token_hashes(f, tokens))


def _scan_column(bs: BlockSearch, fld: str):
    """The VT_STRING column an arena scan reads, or None (special
    fields, consts and other encodings take the per-value path)."""
    if fld in ("_time", "_stream", "_stream_id") or fld in bs.consts():
        return None
    col = bs.column(fld)
    return col if col is not None and col.vtype == VT_STRING else None


def _verify_rows(col, bm: np.ndarray, pred) -> None:
    """Clear the set rows of `bm` whose value fails `pred`."""
    idx = np.nonzero(bm)[0]
    if not idx.size:
        return
    buf = col.arena.tobytes()
    starts = col.offsets[idx].tolist()
    ends = (col.offsets[idx] + col.lengths[idx]).tolist()
    bm[idx] = [pred(buf[a:b].decode("utf-8", "replace"))
               for a, b in zip(starts, ends)]


class _ValuePredFilter(Filter):
    """Single-field filter evaluated as a per-value predicate."""

    field: str

    def _pred(self, v: str) -> bool:
        raise NotImplementedError

    def _tokens(self) -> list[str]:
        return []

    def scan_spec(self) -> tuple | None:
        """(pattern bytes, mode, starts_tok, ends_tok) of the equivalent
        arena scan, or None when only the predicate applies."""
        return None

    def multi_scan_spec(self) -> tuple | None:
        """(scan specs, "and" | "or", verify) of a filter that is several
        arena scans combined, `verify` asking the predicate to settle
        the survivors; None when only the predicate applies."""
        return None

    def apply_to_block(self, bs: BlockSearch, bm: np.ndarray) -> None:
        fld = canonical_field(self.field)
        if _bloom_prunes(bs, fld, self):
            bm[:] = False
            return
        spec = self.scan_spec()
        multi = self.multi_scan_spec() if spec is None else None
        col = _scan_column(bs, fld) if spec or multi else None
        if col is None:
            visit_values(bs, fld, bm, self._pred)
        elif spec is not None:
            bm &= _arena_scan(col, *spec)
        else:
            specs, combine, verify = multi
            acc = None
            for sp in specs:
                hit = _arena_scan(col, *sp)
                acc = hit if acc is None else \
                    acc & hit if combine == "and" else acc | hit
                if combine == "and" and not (acc & bm).any():
                    break
            bm &= acc
            if verify:
                _verify_rows(col, bm, self._pred)

    def apply_to_values(self, get_values, nrows: int) -> np.ndarray:
        vals = get_values(canonical_field(self.field))
        return np.fromiter((self._pred(v) for v in vals), dtype=bool,
                           count=nrows)

    def needed_fields(self) -> set:
        return {canonical_field(self.field)}


@dataclass(repr=False)
class FilterAnd(Filter):
    filters: list

    def apply_to_block(self, bs, bm):
        for f in self.filters:
            if not bm.any():
                return
            f.apply_to_block(bs, bm)

    def apply_to_values(self, get_values, nrows):
        mask = np.ones(nrows, dtype=bool)
        for f in self.filters:
            mask &= f.apply_to_values(get_values, nrows)
        return mask

    def needed_fields(self):
        out = set()
        for f in self.filters:
            out |= f.needed_fields()
        return out

    def to_string(self):
        return " ".join(f"({f.to_string()})" if isinstance(f, FilterOr)
                        else f.to_string() for f in self.filters)


@dataclass(repr=False)
class FilterOr(Filter):
    filters: list

    def apply_to_block(self, bs, bm):
        acc = np.zeros(bs.nrows, dtype=bool)
        for f in self.filters:
            sub = bm.copy()
            f.apply_to_block(bs, sub)
            acc |= sub
            if acc.all():
                break
        bm &= acc

    def apply_to_values(self, get_values, nrows):
        mask = np.zeros(nrows, dtype=bool)
        for f in self.filters:
            mask |= f.apply_to_values(get_values, nrows)
        return mask

    def needed_fields(self):
        out = set()
        for f in self.filters:
            out |= f.needed_fields()
        return out

    def to_string(self):
        return " or ".join(f"({f.to_string()})" if isinstance(f, FilterOr)
                           else f.to_string() for f in self.filters)


@dataclass(repr=False)
class FilterNot(Filter):
    inner: Filter

    def apply_to_block(self, bs, bm):
        sub = np.ones(bs.nrows, dtype=bool)
        self.inner.apply_to_block(bs, sub)
        bm &= ~sub

    def apply_to_values(self, get_values, nrows):
        return ~self.inner.apply_to_values(get_values, nrows)

    def needed_fields(self):
        return self.inner.needed_fields()

    def to_string(self):
        s = self.inner.to_string()
        if isinstance(self.inner, (FilterAnd, FilterOr)):
            s = f"({s})"
        return f"!{s}"


@dataclass(repr=False)
class FilterNoop(Filter):
    """Matches everything: `*`."""

    def apply_to_block(self, bs, bm):
        pass

    def apply_to_values(self, get_values, nrows):
        return np.ones(nrows, dtype=bool)

    def to_string(self):
        return "*"


@dataclass(repr=False)
class FilterNone(Filter):
    """Matches nothing."""

    def apply_to_block(self, bs, bm):
        bm[:] = False

    def apply_to_values(self, get_values, nrows):
        return np.zeros(nrows, dtype=bool)

    def to_string(self):
        return "_none_"


@dataclass(repr=False)
class FilterPhrase(_ValuePredFilter):
    field: str
    phrase: str

    def _pred(self, v):
        return match_phrase(v, self.phrase)

    def scan_spec(self):
        if not self.phrase:
            return None
        return (self.phrase.encode("utf-8"), MODE_PHRASE,
                is_word_char(self.phrase[0]), is_word_char(self.phrase[-1]))

    def _tokens(self):
        return tokenize_string(self.phrase)

    def to_string(self):
        return f"{_q(self.field)}{quote_str(self.phrase)}"


@dataclass(repr=False)
class FilterPrefix(_ValuePredFilter):
    field: str
    prefix: str

    def _pred(self, v):
        return match_prefix(v, self.prefix)

    def scan_spec(self):
        if not self.prefix:
            return None
        return (self.prefix.encode("utf-8"), MODE_PREFIX,
                is_word_char(self.prefix[0]), False)

    def _tokens(self):
        # the trailing partial token cannot be bloom-probed
        toks = tokenize_string(self.prefix)
        if toks and (self.prefix[-1].isalnum() or self.prefix[-1] == "_"
                     or not self.prefix[-1].isascii()):
            toks = toks[:-1]
        return toks

    def to_string(self):
        return f"{_q(self.field)}{quote_str(self.prefix)}*"


@dataclass(repr=False)
class FilterExact(_ValuePredFilter):
    field: str
    value: str

    def _pred(self, v):
        return v == self.value

    def scan_spec(self):
        if not self.value:
            return None
        return (self.value.encode("utf-8"), MODE_EXACT, False, False)

    def _tokens(self):
        return tokenize_string(self.value)

    def apply_to_block(self, bs, bm):
        # a numeric column holds only numbers between its min and max
        meta = bs.column_meta(canonical_field(self.field))
        if meta is not None and meta["t"] in _NUMERIC_VTS:
            v = parse_number(self.value)
            if math.isnan(v) or not meta["min"] <= v <= meta["max"]:
                bm[:] = False
                return
        super().apply_to_block(bs, bm)

    def to_string(self):
        return f"{_q(self.field)}={quote_str(self.value)}"


@dataclass(repr=False)
class FilterExactPrefix(_ValuePredFilter):
    field: str
    prefix: str

    def _pred(self, v):
        return match_exact_prefix(v, self.prefix)

    def scan_spec(self):
        if not self.prefix:
            return None
        return (self.prefix.encode("utf-8"), MODE_EXACT_PREFIX, False,
                False)

    def _tokens(self):
        toks = tokenize_string(self.prefix)
        return toks[:-1] if toks else []

    def to_string(self):
        return f"{_q(self.field)}={quote_str(self.prefix)}*"


class _AnyCaseFilter(_ValuePredFilter):
    """`i(...)`: the value's Unicode lower case against the lowered
    pattern (`_lower`), in scan mode MODE."""

    MODE = MODE_PHRASE

    def __post_init__(self):
        self._lower = self._text().lower()

    def _text(self) -> str:
        raise NotImplementedError

    def apply_to_block(self, bs, bm):
        fld = canonical_field(self.field)
        col = _scan_column(bs, fld)
        low = self._lower
        if col is None or not low or not low.isascii():
            visit_values(bs, fld, bm, self._pred)
            return
        # the byte fold of the arena decides the ASCII rows; rows holding
        # a byte >= 0x80 are settled by the predicate, as Unicode lowering
        # can map non-ASCII onto ASCII (U+212A -> 'k') or change lengths
        arena = col.arena.copy()
        arena[(arena >= 65) & (arena <= 90)] += 32
        hit = _arena_scan(col, low.encode(), self.MODE, is_word_char(low[0]),
                          self.MODE == MODE_PHRASE and is_word_char(low[-1]),
                          arena=arena)
        offs = col.offsets.astype(np.int64)
        high = _rows_holding(col.arena, offs, offs + col.lengths,
                             col.arena >= 0x80)
        bm &= hit | high
        check = bm & high
        if check.any():
            _verify_rows(col, check, self._pred)
            bm &= ~high | check


@dataclass(repr=False)
class FilterAnyCasePhrase(_AnyCaseFilter):
    field: str
    phrase: str

    def _text(self):
        return self.phrase

    def _pred(self, v):
        return match_any_case_phrase(v, self._lower)

    def to_string(self):
        return f"{_q(self.field)}i({quote_str(self.phrase)})"


@dataclass(repr=False)
class FilterAnyCasePrefix(_AnyCaseFilter):
    field: str
    prefix: str

    MODE = MODE_PREFIX

    def _text(self):
        return self.prefix

    def _pred(self, v):
        return match_any_case_prefix(v, self._lower)

    def to_string(self):
        return f"{_q(self.field)}i({quote_str(self.prefix)}*)"


@dataclass(repr=False)
class FilterRegexp(_ValuePredFilter):
    """`~"re"`: `re.search` semantics.  Every match holds each of the
    pattern's mandatory literal runs, so an arena scan per run prunes
    the rows `re.search` has to see; a pattern that is one literal
    (`_pure`) is that scan alone, and `A.*B` with literal A and B
    (`_pair`) is decided by `_pair_rows`."""

    field: str
    pattern: str

    def __post_init__(self):
        self._re = re.compile(self.pattern)
        self._substr_literals = regex_literal_runs(self.pattern)
        self._bloom_tokens = regex_literal_tokens(self.pattern)
        self._pure = bool(self.pattern) and \
            re.escape(self.pattern) == self.pattern
        parts = self.pattern.split(".*")
        self._pair = None
        if len(parts) == 2 and all(p and re.escape(p) == p for p in parts):
            self._pair = (parts[0].encode("utf-8"),
                          parts[1].encode("utf-8"))

    def _pred(self, v):
        return self._re.search(v) is not None

    def _tokens(self):
        return self._bloom_tokens

    def apply_to_block(self, bs, bm):
        fld = canonical_field(self.field)
        if _bloom_prunes(bs, fld, self):
            bm[:] = False
            return
        col = _scan_column(bs, fld)
        if col is not None and self._pair is not None:
            definite, verify = _pair_rows(col, *self._pair)
            bm &= definite | verify
            check = bm & verify
            if check.any():
                _verify_rows(col, check, self._pred)
                bm &= ~verify | check
            return
        if col is None or not self._substr_literals:
            visit_values(bs, fld, bm, self._pred)
            return
        for lit in self._substr_literals:
            bm &= _arena_scan(col, lit.encode("utf-8"), MODE_SUBSTRING, False,
                              False)
            if not bm.any():
                return
        if not self._pure:
            _verify_rows(col, bm, self._pred)

    def to_string(self):
        return f"{_q(self.field)}~{quote_str(self.pattern)}"


def regex_literal_tokens(pattern: str) -> list[str]:
    """Whole word tokens every match must contain, for bloom probes:
    the tokens of each mandatory literal run (`_regex_literal_parts`)
    less the first and the last, which may be parts of longer words."""
    out = []
    for lit, drop_last, is_final in _regex_literal_parts(pattern):
        toks = tokenize_string(lit)
        if not toks:
            continue
        start = 1 if (lit and (lit[0].isalnum() or lit[0] == "_")) else 0
        end = len(toks)
        if drop_last or not is_final:
            end -= 1
        else:
            if lit and (lit[-1].isalnum() or lit[-1] == "_"):
                end -= 1
        out.extend(toks[start:end])
    return out


def regex_literal_runs(pattern: str) -> list[str]:
    """Maximal literal substrings every match must contain, untokenized:
    sound for plain substring prefilters (a scan for "dead" prefilters
    `~"dead.*exceeded"`), partial words included."""
    return [lit for lit, _d, _f in _regex_literal_parts(pattern) if lit]


def _regex_literal_parts(pattern: str) -> list[tuple[str, bool, bool]]:
    """(literal run, last char dropped, is final) parts of a pattern.
    Inline flags (`(?i)`), alternation at the top level, backreferences
    and octal escapes give no parts; what lies inside a group, a class
    or a counted repetition is not mandatory; a character followed by
    `*`, `?` or `+` ends its run and leaves it."""
    if "(?" in pattern:
        return []
    literals = []
    cur = []
    i, n = 0, len(pattern)
    depth_unsafe = 0
    while i < n:
        c = pattern[i]
        if c == "\\":
            e = pattern[i + 1] if i + 1 < n else ""
            # control escapes denote real characters, not the escape letter
            ctrl = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                    "a": "\a", "0": "\0"}
            if e == "0" and i + 2 < n and pattern[i + 2] in "01234567":
                return []
            if e in ctrl:
                if depth_unsafe == 0:
                    cur.append(ctrl[e])
                i += 2
                continue
            # \xNN, \uNNNN and \UNNNNNNNN denote one character
            if e in ("x", "u", "U"):
                width = {"x": 2, "u": 4, "U": 8}[e]
                hexs = pattern[i + 2:i + 2 + width]
                if len(hexs) != width or \
                        any(h not in "0123456789abcdefABCDEF"
                            for h in hexs):
                    return []
                if depth_unsafe == 0:
                    cur.append(chr(int(hexs, 16)))
                i += 2 + width
                continue
            if e in "123456789":
                return []
            if e and e not in "wWdDsSbBAZ":
                if depth_unsafe == 0:
                    cur.append(e)
                i += 2
                continue
            # a class escape stands for unknown characters
            cur = _flush_literal(cur, literals, drop_last=True)
            i += 2
            continue
        if c in "|([{":
            if c == "|":
                if depth_unsafe == 0:
                    return []
                i += 1
                continue
            if c == "{" and cur and depth_unsafe == 0:
                # the quantifier may be {0,n}: the char before is optional
                cur.pop()
            cur = _flush_literal(cur, literals, drop_last=True)
            depth_unsafe += 1
            i += 1
            continue
        if c in ")]}":
            depth_unsafe = max(0, depth_unsafe - 1)
            cur = []
            i += 1
            continue
        if c in "*?+":
            if cur and depth_unsafe == 0:
                cur.pop()
                cur = _flush_literal(cur, literals, drop_last=True)
            i += 1
            continue
        if c in ".^$":
            cur = _flush_literal(cur, literals, drop_last=True)
            i += 1
            continue
        if depth_unsafe == 0:
            cur.append(c)
        i += 1
    _flush_literal(cur, literals, drop_last=False, final=True)
    return literals


def _flush_literal(cur, literals, drop_last, final=False):
    if cur:
        literals.append(("".join(cur), drop_last, final))
    return []


def _phrase_specs(phrases: list) -> list | None:
    """One MODE_PHRASE arena scan a phrase; None when one is empty (the
    predicate keeps its own semantics there)."""
    if not phrases or not all(phrases):
        return None
    return [(p.encode("utf-8"), MODE_PHRASE, is_word_char(p[0]),
             is_word_char(p[-1])) for p in phrases]


# ---------------- multi-value filters ----------------

@dataclass(repr=False)
class FilterIn(_ValuePredFilter):
    """`in(a, b, ...)`: the whole value equals one of them; `subquery`
    (a parsed Query) supplies the values once init_subqueries has run
    it."""

    field: str
    values: list
    subquery: object = None

    def __post_init__(self):
        self._set = set(self.values)

    def set_values(self, values):
        self.values = list(values)
        self._set = set(self.values)

    def _pred(self, v):
        return v in self._set

    def to_string(self):
        if self.subquery is not None:
            return f"{_q(self.field)}in({self.subquery.to_string()})"
        return (f"{_q(self.field)}in("
                f"{','.join(quote_str(v) for v in self.values)})")


@dataclass(repr=False)
class FilterContainsAll(_ValuePredFilter):
    """`contains_all(a, b, ...)`: every phrase occurs."""

    field: str
    values: list
    subquery: object = None

    def set_values(self, values):
        self.values = list(values)

    def _pred(self, v):
        return all(match_phrase(v, p) for p in self.values)

    def multi_scan_spec(self):
        specs = _phrase_specs(self.values)
        return None if specs is None else (specs, "and", False)

    def _tokens(self):
        return [t for p in self.values for t in tokenize_string(p)]

    def to_string(self):
        return (f"{_q(self.field)}contains_all("
                f"{','.join(quote_str(v) for v in self.values)})")


@dataclass(repr=False)
class FilterContainsAny(_ValuePredFilter):
    """`contains_any(a, b, ...)`: some phrase occurs."""

    field: str
    values: list
    subquery: object = None

    def set_values(self, values):
        self.values = list(values)

    def _pred(self, v):
        return any(match_phrase(v, p) for p in self.values)

    def multi_scan_spec(self):
        specs = _phrase_specs(self.values)
        return None if specs is None else (specs, "or", False)

    def to_string(self):
        return (f"{_q(self.field)}contains_any("
                f"{','.join(quote_str(v) for v in self.values)})")


@dataclass(repr=False)
class FilterSequence(_ValuePredFilter):
    """`seq(a, b, ...)`: the phrases occur in this order, each at word
    boundaries; their scans prefilter and, for two or more, the
    predicate checks the order."""

    field: str
    phrases: list

    def _pred(self, v):
        return match_sequence(v, self.phrases)

    def multi_scan_spec(self):
        specs = _phrase_specs(self.phrases)
        return None if specs is None else \
            (specs, "and", len(self.phrases) > 1)

    def _tokens(self):
        return [t for p in self.phrases for t in tokenize_string(p)]

    def to_string(self):
        return (f"{_q(self.field)}seq("
                f"{','.join(quote_str(v) for v in self.phrases)})")


# ---------------- range / numeric filters ----------------

@dataclass(repr=False)
class FilterRange(_ValuePredFilter):
    """`range[lo, hi]`, `>x`, `<=x`...: the value as a number inside
    inclusive bounds (the parser moves exclusive bounds to the next
    float)."""

    field: str
    min_value: float
    max_value: float
    repr_str: str = ""

    def _pred(self, v):
        return match_range(v, self.min_value, self.max_value)

    def apply_to_block(self, bs, bm):
        fld = canonical_field(self.field)
        meta = bs.column_meta(fld)
        if meta is None or meta["t"] not in _NUMERIC_VTS:
            super().apply_to_block(bs, bm)
            return
        if meta["max"] < self.min_value or meta["min"] > self.max_value:
            bm[:] = False
            return
        nums = bs.column(fld).nums
        if nums.dtype == np.uint64:
            # integer-exact bounds: the ceil of the lower, the floor of
            # the upper (an infinite bound saturates)
            lo = 0 if self.min_value <= 0 else \
                2**64 - 1 if math.isinf(self.min_value) else \
                min(math.ceil(self.min_value), 2**64 - 1)
            hi = -1 if self.max_value < 0 else \
                2**64 - 1 if math.isinf(self.max_value) else \
                min(math.floor(self.max_value), 2**64 - 1)
            if lo > hi:
                bm[:] = False
                return
            bm &= (nums >= np.uint64(lo)) & (nums <= np.uint64(hi))
        else:
            bm &= (nums >= self.min_value) & (nums <= self.max_value)

    def to_string(self):
        if self.repr_str:
            return f"{_q(self.field)}{self.repr_str}"
        return f"{_q(self.field)}range[{self.min_value},{self.max_value}]"


@dataclass(repr=False)
class FilterStringRange(_ValuePredFilter):
    """`string_range(lo, hi)`: lo <= value < hi."""

    field: str
    min_value: str
    max_value: str
    repr_str: str = ""

    def _pred(self, v):
        return match_string_range(v, self.min_value, self.max_value)

    def apply_to_block(self, bs, bm):
        col = _scan_column(bs, canonical_field(self.field))
        if col is None:
            super().apply_to_block(bs, bm)
            return
        # UTF-8 byte order is code-point order, which str comparison is
        rows = np.nonzero(bm)[0]
        bm[rows] = \
            (_arena_compare(col, rows, self.min_value.encode()) >= 0) & \
            (_arena_compare(col, rows, self.max_value.encode()) < 0)

    def to_string(self):
        if self.repr_str:
            return f"{_q(self.field)}{self.repr_str}"
        return (f"{_q(self.field)}string_range({quote_str(self.min_value)},"
                f"{quote_str(self.max_value)})")


@dataclass(repr=False)
class FilterLenRange(_ValuePredFilter):
    """`len_range(lo, hi)`: the value's length in code points.  A
    VT_STRING column counts the arena bytes that are not UTF-8
    continuation bytes."""

    field: str
    min_len: int
    max_len: int

    def _pred(self, v):
        return match_len_range(v, self.min_len, self.max_len)

    def apply_to_block(self, bs, bm):
        col = _scan_column(bs, canonical_field(self.field))
        if col is None:
            super().apply_to_block(bs, bm)
            return
        offs = col.offsets.astype(np.int64)
        cont = _rows_holding_count(col.arena, offs, offs + col.lengths,
                                   (col.arena & 0xC0) == 0x80)
        runes = col.lengths - cont
        bm &= (runes >= self.min_len) & (runes <= self.max_len)

    def to_string(self):
        return f"{_q(self.field)}len_range({self.min_len},{self.max_len})"


@dataclass(repr=False)
class FilterIPv4Range(_ValuePredFilter):
    """`ipv4_range(lo, hi)` or `ipv4_range(cidr)`: the value as a
    dotted-quad address inside inclusive bounds."""

    field: str
    min_value: int
    max_value: int

    def _pred(self, v):
        return match_ipv4_range(v, self.min_value, self.max_value)

    def apply_to_block(self, bs, bm):
        fld = canonical_field(self.field)
        meta = bs.column_meta(fld)
        if meta is not None and meta["t"] == VT_IPV4:
            nums = bs.column(fld).nums
            bm &= (nums >= np.uint32(self.min_value)) & \
                (nums <= np.uint32(self.max_value))
            return
        super().apply_to_block(bs, bm)

    def to_string(self):
        def ip(v):
            return f"{(v >> 24) & 255}.{(v >> 16) & 255}." \
                   f"{(v >> 8) & 255}.{v & 255}"
        return (f"{_q(self.field)}ipv4_range({ip(self.min_value)},"
                f"{ip(self.max_value)})")


@dataclass(repr=False)
class FilterValueType(Filter):
    """`value_type(name)`: the block stores the column in this encoding
    (`BlockSearch.value_type_name`)."""

    field: str
    type_name: str

    def matches(self, bs) -> bool:
        return match_value_type(bs.value_type_name(
            canonical_field(self.field)), self.type_name)

    def apply_to_block(self, bs, bm):
        if not self.matches(bs):
            bm[:] = False

    def apply_to_values(self, get_values, nrows):
        # rows in the pipe chain have lost their storage type: all pass
        # only for `string`, as in the reference
        return np.full(nrows, self.type_name == "string", dtype=bool)

    def needed_fields(self):
        return {canonical_field(self.field)}

    def to_string(self):
        return f"{_q(self.field)}value_type({self.type_name})"


# ---------------- cross-field filters ----------------

@dataclass(repr=False)
class FilterEqField(Filter):
    """`eq_field(other)`: the two fields hold equal values."""

    field: str
    other: str

    def apply_to_block(self, bs, bm):
        a = bs.values(canonical_field(self.field))
        b = bs.values(self.other)
        for i in np.nonzero(bm)[0].tolist():
            if a[i] != b[i]:
                bm[i] = False

    def apply_to_values(self, get_values, nrows):
        a = get_values(self.field)
        b = get_values(self.other)
        return np.fromiter((x == y for x, y in zip(a, b)), dtype=bool,
                           count=nrows)

    def needed_fields(self):
        return {canonical_field(self.field), self.other}

    def to_string(self):
        return f"{_q(self.field)}eq_field({self.other})"


@dataclass(repr=False)
class FilterLeField(Filter):
    """`le_field(other)` (`lt_field` when strict): numbers compared as
    numbers, anything else as strings."""

    field: str
    other: str
    strict: bool = False

    def _cmp(self, x: str, y: str) -> bool:
        a, b = parse_number(x), parse_number(y)
        if not (math.isnan(a) or math.isnan(b)):
            return a < b if self.strict else a <= b
        return x < y if self.strict else x <= y

    def apply_to_block(self, bs, bm):
        a = bs.values(canonical_field(self.field))
        b = bs.values(self.other)
        for i in np.nonzero(bm)[0].tolist():
            if not self._cmp(a[i], b[i]):
                bm[i] = False

    def apply_to_values(self, get_values, nrows):
        a = get_values(self.field)
        b = get_values(self.other)
        return np.fromiter((self._cmp(x, y) for x, y in zip(a, b)),
                           dtype=bool, count=nrows)

    def needed_fields(self):
        return {canonical_field(self.field), self.other}

    def to_string(self):
        fn = "lt_field" if self.strict else "le_field"
        return f"{_q(self.field)}{fn}({self.other})"


@dataclass(repr=False)
class FilterTime(Filter):
    min_ts: int                      # inclusive, ns
    max_ts: int                      # inclusive, ns
    repr_str: str = ""
    relative: bool = False           # a bound was read from `now`

    def apply_to_block(self, bs, bm):
        ts = bs.timestamps()
        if ts[0] >= self.min_ts and ts[-1] <= self.max_ts:
            return
        bm &= (ts >= self.min_ts) & (ts <= self.max_ts)

    def apply_to_values(self, get_values, nrows):
        out = np.zeros(nrows, dtype=bool)
        for i, v in enumerate(get_values("_time")):
            t = parse_rfc3339(v)
            out[i] = t is not None and self.min_ts <= t <= self.max_ts
        return out

    def needed_fields(self):
        return {"_time"}

    def to_string(self):
        return f"_time:{self.repr_str}" if self.repr_str else \
            f"_time:[{self.min_ts},{self.max_ts}]"


@dataclass(repr=False)
class FilterStream(Filter):
    """`{label="value", ...}`, resolved against the partition's stream
    index once per (partition, tenants)."""

    stream_filter: object  # storage.stream_filter.StreamFilter

    def __post_init__(self):
        self._resolved: dict = {}

    def resolve(self, partition, tenants) -> set:
        key = (id(partition), tuple(tenants))
        got = self._resolved.get(key)
        if got is None:
            got = self._resolved[key] = partition.search_stream_ids(
                tenants, self.stream_filter)
        return got

    def apply_to_block(self, bs, bm):
        ctx = bs.ctx
        if ctx is not None and bs.stream_id not in self.resolve(
                ctx.partition, ctx.tenants):
            bm[:] = False

    def apply_to_values(self, get_values, nrows):
        out = np.zeros(nrows, dtype=bool)
        for i, v in enumerate(get_values("_stream")):
            out[i] = self.stream_filter.matches(parse_stream_tags(v))
        return out

    def needed_fields(self):
        return {"_stream"}

    def to_string(self):
        return self.stream_filter.to_string()


_NS_PER_DAY = 86400 * 1_000_000_000


@dataclass(repr=False)
class FilterDayRange(Filter):
    """`_time:day_range[hh:mm, hh:mm]`: the time of day, inclusive
    offsets into a day shifted by the `offset` modifier."""

    start_offset_ns: int
    end_offset_ns: int
    tz_offset_ns: int = 0
    repr_str: str = ""

    def apply_to_block(self, bs, bm):
        day_off = (bs.timestamps() + self.tz_offset_ns) % _NS_PER_DAY
        bm &= (day_off >= self.start_offset_ns) & \
            (day_off <= self.end_offset_ns)

    def apply_to_values(self, get_values, nrows):
        out = np.zeros(nrows, dtype=bool)
        for i, v in enumerate(get_values("_time")):
            t = parse_rfc3339(v)
            if t is not None:
                off = (t + self.tz_offset_ns) % _NS_PER_DAY
                out[i] = self.start_offset_ns <= off <= self.end_offset_ns
        return out

    def needed_fields(self):
        return {"_time"}

    def to_string(self):
        return f"_time:day_range{self.repr_str}"


@dataclass(repr=False)
class FilterWeekRange(Filter):
    """`_time:week_range[Mon, Fri]`: the weekday, 0 = Sunday to
    6 = Saturday, inclusive."""

    start_day: int
    end_day: int
    tz_offset_ns: int = 0
    repr_str: str = ""

    def apply_to_block(self, bs, bm):
        # 1970-01-01 was a Thursday (4 with Sunday 0)
        days = (bs.timestamps() + self.tz_offset_ns) // _NS_PER_DAY
        wd = (days + 4) % 7
        bm &= (wd >= self.start_day) & (wd <= self.end_day)

    def apply_to_values(self, get_values, nrows):
        out = np.zeros(nrows, dtype=bool)
        for i, v in enumerate(get_values("_time")):
            t = parse_rfc3339(v)
            if t is not None:
                wd = ((t + self.tz_offset_ns) // _NS_PER_DAY + 4) % 7
                out[i] = self.start_day <= wd <= self.end_day
        return out

    def needed_fields(self):
        return {"_time"}

    def to_string(self):
        return f"_time:week_range{self.repr_str}"


@dataclass(repr=False)
class FilterStreamID(Filter):
    """`_stream_id:<id>` or `_stream_id:in(<id>, ...)` (hex strings)."""

    stream_ids: list

    def __post_init__(self):
        self._set = set(self.stream_ids)

    def apply_to_block(self, bs, bm):
        if bs.stream_id.as_string() not in self._set:
            bm[:] = False

    def apply_to_values(self, get_values, nrows):
        return np.fromiter((v in self._set
                            for v in get_values("_stream_id")),
                           dtype=bool, count=nrows)

    def needed_fields(self):
        return {"_stream_id"}

    def to_string(self):
        if len(self.stream_ids) == 1:
            return f"_stream_id:{self.stream_ids[0]}"
        return "_stream_id:in(" + ",".join(self.stream_ids) + ")"
