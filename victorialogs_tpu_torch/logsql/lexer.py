"""LogsQL lexer.

Token rules mirror the reference lexer (lib/logstorage/parser.go:150-245):
word tokens are maximal runs of token runes plus '.', strings quote with
double/back/single quotes (Go strconv unquoting rules), `=~` / `!=` / `!~`
are two-char tokens, `#` starts a line comment, and the lexer exposes
`raw_token` / `is_skipped_space` so the parser can reassemble compound
phrases like `foo-bar:baz` exactly the way the reference does.
"""

from __future__ import annotations


def _is_token_char(c: str) -> bool:
    return (c.isascii() and (c.isalnum() or c == "_")) or \
        (not c.isascii() and (c.isalpha() or c.isdigit() or c == "_"))


def quote_token_if_needed(s: str) -> str:
    if s and all(_is_token_char(c) or c == "." for c in s):
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def unquote(raw: str) -> str:
    """Go-style strconv.Unquote for the three LogsQL quote kinds."""
    if len(raw) >= 2 and raw[0] == "`" and raw[-1] == "`":
        return raw[1:-1]
    if len(raw) < 2 or raw[0] not in "\"'" or raw[-1] != raw[0]:
        raise ValueError(f"invalid quoted string: {raw!r}")
    q = raw[0]
    s = raw[1:-1]
    out = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= n:
            raise ValueError(f"trailing backslash in {raw!r}")
        e = s[i + 1]
        i += 2
        if e == "n":
            out.append("\n")
        elif e == "t":
            out.append("\t")
        elif e == "r":
            out.append("\r")
        elif e == "a":
            out.append("\a")
        elif e == "b":
            out.append("\b")
        elif e == "f":
            out.append("\f")
        elif e == "v":
            out.append("\v")
        elif e == "\\":
            out.append("\\")
        elif e == q:
            out.append(q)
        elif e in "\"'":
            out.append(e)
        elif e == "x":
            out.append(chr(int(s[i:i + 2], 16)))
            i += 2
        elif e == "u":
            out.append(chr(int(s[i:i + 4], 16)))
            i += 4
        elif e == "U":
            out.append(chr(int(s[i:i + 8], 16)))
            i += 8
        elif e in "01234567":
            out.append(chr(int(s[i - 1:i + 2], 8)))
            i += 2
        else:
            raise ValueError(f"unknown escape \\{e} in {raw!r}")
    return "".join(out)


class Lexer:
    def __init__(self, s: str, timestamp: int | None = None):
        self.s = s
        self.pos = 0
        self.token = ""
        self.raw_token = ""
        self.is_skipped_space = False
        self.is_quoted = False
        self.timestamp = timestamp
        self.now_reads = 0          # times a `_time` bound read `now`
        self.next_token()

    def is_end(self) -> bool:
        return self.token == "" and not self.is_quoted and \
            self.pos >= len(self.s)

    def is_keyword(self, *kws: str) -> bool:
        if self.is_quoted:
            return False
        t = self.token.lower()
        return any(t == k for k in kws)

    def context(self) -> str:
        return self.s[max(0, self.pos - 30):self.pos]

    def next_token(self) -> None:
        s, i, n = self.s, self.pos, len(self.s)
        self.token = ""
        self.raw_token = ""
        self.is_quoted = False
        self.is_skipped_space = False

        while True:
            # skip whitespace
            while i < n and s[i].isspace():
                self.is_skipped_space = True
                i += 1
            # skip comments
            if i < n and s[i] == "#":
                nl = s.find("\n", i)
                i = n if nl < 0 else nl + 1
                continue
            break
        if i >= n:
            self.pos = i
            return

        start = i
        c = s[i]
        # word token: token runes plus '.'
        if _is_token_char(c) or c == ".":
            while i < n and (_is_token_char(s[i]) or s[i] == "."):
                i += 1
            self.token = s[start:i]
            self.raw_token = self.token
            self.pos = i
            return

        if c in "\"'`":
            j = i + 1
            while j < n:
                if s[j] == "\\" and c != "`" and j + 1 < n:
                    j += 2
                    continue
                if s[j] == c:
                    break
                j += 1
            if j >= n:
                raise ValueError(
                    f"missing closing quote for [{s[i:]}]")
            raw = s[i:j + 1]
            self.token = unquote(raw)
            self.raw_token = raw
            self.is_quoted = True
            self.pos = j + 1
            return

        if c == "=" and i + 1 < n and s[i + 1] == "~":
            self.token = self.raw_token = "=~"
            self.pos = i + 2
            return
        if c == "!" and i + 1 < n and s[i + 1] in "~=":
            self.token = self.raw_token = s[i:i + 2]
            self.pos = i + 2
            return

        self.token = self.raw_token = c
        self.pos = i + 1
