"""Scalar value-match semantics: the correctness oracle of the host
executor and of the device scan.

- match_phrase: substring occurrence with word-boundary checks on both
  sides; match_prefix: a boundary before it only, and an empty prefix
  matches any non-empty string; match_any_case_*: the same over the
  value's Unicode lower case (the pattern arrives lowered).
- word chars: ASCII [A-Za-z0-9_] plus every non-ASCII character, the
  same table the byte tokenizer and the scan kernel use.
- match_exact_prefix: plain startswith; match_sequence: ordered
  phrase occurrences, each at word boundaries (`phrase_pos`), none
  overlapping the one before;
- match_string_range: min <= s < max; match_len_range: a length in
  code points; match_range / match_ipv4_range: the parsed number or
  IPv4 address inside inclusive bounds;
- parse_number: a LogsQL number with size suffixes, the value that
  stats functions, numeric group-by buckets and range filters read
  from a string.
"""

from __future__ import annotations

import math
import re


def is_word_char(c: str) -> bool:
    return c.isascii() and (c.isalnum() or c == "_") or not c.isascii()


def match_phrase(s: str, phrase: str) -> bool:
    if not phrase:
        return not s
    starts_tok = is_word_char(phrase[0])
    ends_tok = is_word_char(phrase[-1])
    pos = 0
    while True:
        n = s.find(phrase, pos)
        if n < 0:
            return False
        if starts_tok and n > 0 and is_word_char(s[n - 1]):
            pos = n + 1
            continue
        end = n + len(phrase)
        if ends_tok and end < len(s) and is_word_char(s[end]):
            pos = n + 1
            continue
        return True


def match_prefix(s: str, prefix: str) -> bool:
    if not prefix:
        return len(s) > 0
    starts_tok = is_word_char(prefix[0])
    pos = 0
    while True:
        n = s.find(prefix, pos)
        if n < 0:
            return False
        if starts_tok and n > 0 and is_word_char(s[n - 1]):
            pos = n + 1
            continue
        return True


def match_exact_prefix(s: str, prefix: str) -> bool:
    return s.startswith(prefix)


def match_any_case_phrase(s: str, phrase_lower: str) -> bool:
    return match_phrase(s.lower(), phrase_lower)


def match_any_case_prefix(s: str, prefix_lower: str) -> bool:
    return match_prefix(s.lower(), prefix_lower)


def phrase_pos(s: str, phrase: str) -> int:
    """Index of the first word-boundary occurrence of `phrase` in `s`;
    -1 when there is none, 0 for an empty phrase."""
    if not phrase:
        return 0
    starts_tok = is_word_char(phrase[0])
    ends_tok = is_word_char(phrase[-1])
    pos = 0
    while True:
        n = s.find(phrase, pos)
        if n < 0:
            return -1
        if starts_tok and n > 0 and is_word_char(s[n - 1]):
            pos = n + 1
            continue
        end = n + len(phrase)
        if ends_tok and end < len(s) and is_word_char(s[end]):
            pos = n + 1
            continue
        return n


def match_sequence(s: str, phrases: list[str]) -> bool:
    for p in phrases:
        n = phrase_pos(s, p)
        if n < 0:
            return False
        s = s[n + len(p):]
    return True


def match_string_range(s: str, min_value: str, max_value: str) -> bool:
    return min_value <= s < max_value


def match_len_range(s: str, min_len: int, max_len: int) -> bool:
    return min_len <= len(s) <= max_len


_FLOAT_RE = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")
_SUFFIXES = {
    "k": 1e3, "m": 1e6, "g": 1e9, "t": 1e12,
    "ki": 1024.0, "mi": 1024.0 ** 2, "gi": 1024.0 ** 3, "ti": 1024.0 ** 4,
    "kb": 1e3, "mb": 1e6, "gb": 1e9, "tb": 1e12,
    "kib": 1024.0, "mib": 1024.0 ** 2, "gib": 1024.0 ** 3, "tib": 1024.0 ** 4,
    "b": 1.0,
}


def parse_number(s: str) -> float:
    """Parse a LogsQL number, with size suffixes (10KB, 5MiB) and inf/nan;
    NaN when `s` is not a number."""
    if not s:
        return math.nan
    t = s.strip().lower().replace("_", "")
    if t in ("inf", "+inf"):
        return math.inf
    if t == "-inf":
        return -math.inf
    if t == "nan":
        return math.nan
    mult = 1.0
    for suf in ("kib", "mib", "gib", "tib", "kb", "mb", "gb", "tb",
                "ki", "mi", "gi", "ti", "k", "m", "g", "t", "b"):
        if t.endswith(suf):
            base = t[: -len(suf)]
            if base and _FLOAT_RE.match(base):
                t = base
                mult = _SUFFIXES[suf]
            break
    try:
        return float(t) * mult
    except ValueError:
        return math.nan


def match_range(s: str, min_value: float, max_value: float) -> bool:
    v = parse_number(s)
    return not math.isnan(v) and min_value <= v <= max_value


def parse_ipv4(s: str) -> int | None:
    """A dotted-quad IPv4 address as an int, or None."""
    parts = s.split(".")
    if len(parts) != 4:
        return None
    v = 0
    for p in parts:
        if not p.isdigit() or len(p) > 3:
            return None
        n = int(p)
        if n > 255:
            return None
        v = (v << 8) | n
    return v


def match_ipv4_range(s: str, min_value: int, max_value: int) -> bool:
    v = parse_ipv4(s)
    return v is not None and min_value <= v <= max_value


def match_value_type(type_name: str, want: str) -> bool:
    return type_name == want
