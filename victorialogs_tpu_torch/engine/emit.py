"""Columnar NDJSON emit: BlockResult -> response bytes, no per-row dicts.

    BlockResult.emit_columns()  one kind-tagged column per output field,
        gathered with numpy from the stored arenas and typed arrays;
    native.emit_ndjson_native   the columns in, escaped NDJSON bytes out
        (native/emit.cpp `vl_emit_ndjson`).

The bytes equal the per-row path's, `ndjson_block_py`:
json.dumps(row, ensure_ascii=False, separators=(",", ":")) over rows()
dicts, one line a row: same key order (column order), same escapes,
empty values omitted, "{}" for a row with no value.  The one block
that the per-row path writes is one holding invalid UTF-8, where the
per-row path's errors="replace" decode defines the bytes; such blocks
are counted in EMIT_COUNTERS["py_blocks"].
"""

from __future__ import annotations

import json

from ..native import emit_ndjson_native

EMIT_COUNTERS = {"py_blocks": 0}

# quoted b'"key":' tokens: json.dumps escapes the names, so a key reads
# exactly as on the per-row path
_KEY_TOKENS: dict[str, bytes] = {}


def _key_token(name: str) -> bytes:
    tok = _KEY_TOKENS.get(name)
    if tok is None:
        if len(_KEY_TOKENS) > 4096:
            _KEY_TOKENS.clear()
        tok = (json.dumps(name, ensure_ascii=False) + ":").encode("utf-8")
        _KEY_TOKENS[name] = tok
    return tok


def ndjson_block(br, fields: list[str] | None = None) -> bytes:
    """One result block as NDJSON bytes (one line a row, each ended by a
    newline); b"" for an empty block."""
    if br.nrows == 0:
        return b""
    names, cols = br.emit_columns(fields)
    data = emit_ndjson_native([_key_token(n) for n in names], cols,
                              br.nrows)
    if data is not None:
        return data
    EMIT_COUNTERS["py_blocks"] += 1
    return ndjson_block_py(br, fields)


def ndjson_block_py(br, fields: list[str] | None = None) -> bytes:
    """The per-row path: a dict a row through json.dumps."""
    out = [json.dumps(row, ensure_ascii=False, separators=(",", ":"))
           for row in br.rows(fields)]
    out.append("")                     # the last line's newline
    return "\n".join(out).encode("utf-8")
