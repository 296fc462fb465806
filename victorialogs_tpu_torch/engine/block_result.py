"""Result batches flowing into the pipe chain.

Straight from storage a batch wraps a BlockSearch plus the selected row
indices and decodes columns on demand; after the stats pipe it is a
plain dict of equal-length string lists.  A storage-backed batch may
carry the pipe chain's needed fields (`from_block_search(..., needed)`:
`column_names` lists only those) and a `fields` projection
(`restrict_fields`: names outside it read as absent) without leaving
its block, so the NDJSON emit (engine/emit.py) reads its columns
through `emit_columns`: typed arrays and byte arenas gathered through
the selection, no per-row Python objects.  Pipes that rewrite columns
(`copy`, `rename`) work on a detached copy (`materialize`), which keeps
the rows' timestamps for `_time` buckets further down the chain.
"""

from __future__ import annotations

import numpy as np

from ..logsql.duration import format_rfc3339_many
from ..storage.values_encoder import (VT_CONST, VT_DICT, VT_FLOAT64,
                                      VT_INT64, VT_STRING,
                                      VT_TIMESTAMP_ISO8601, VT_UINT8,
                                      VT_UINT16, VT_UINT32, VT_UINT64,
                                      _format_floats)
from .block_search import _VIRTUAL, values_at

_INT_VTYPES = (VT_UINT8, VT_UINT16, VT_UINT32, VT_UINT64, VT_INT64)

# ---- emit columns ----
#
# An emit column is a kind-tagged tuple (native.emit_ndjson_native):
#   (0, arena uint8[], offsets int64[n], lengths int64[n])  bytes
#   (1, ts int64[n])            RFC3339Nano timestamps (_time)
#   (2, ts int64[n], frac_w)    ISO8601, fixed fractional width
#   (3, nums int64[n])          signed decimal
#   (4, nums uint64[n])         unsigned decimal
# The serializer formats the typed kinds itself.  Length 0 on kind 0
# means "omit the field on this row".


def _const_emit_col(v: str, n: int):
    b = v.encode("utf-8")
    return (0, np.frombuffer(b, dtype=np.uint8),
            np.zeros(n, dtype=np.int64),
            np.full(n, len(b), dtype=np.int64))


def _pack_str_column(vals: list):
    """A Python string list (pipe-made columns, dict values, IPv4) as a
    kind-0 emit column."""
    n = len(vals)
    bvals = [v.encode("utf-8") for v in vals]
    lengths = np.fromiter(map(len, bvals), dtype=np.int64, count=n)
    offsets = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lengths[:-1], out=offsets[1:])
    return (0, np.frombuffer(b"".join(bvals), dtype=np.uint8), offsets,
            lengths)


def _fixed_emit_col(sb: np.ndarray):
    """A kind-0 emit column over a fixed-width ASCII bytes array
    (`astype("S32")`: values left-aligned and NUL padded; the canonical
    float strings hold no NUL)."""
    n = sb.shape[0]
    w = sb.dtype.itemsize
    mat = sb.view(np.uint8).reshape(n, w)
    lengths = (mat != 0).sum(axis=1).astype(np.int64)
    return (0, np.ascontiguousarray(mat).reshape(-1),
            np.arange(n, dtype=np.int64) * w, lengths)


class BlockResult:
    """Invariant: on a storage-backed batch (`_bs` set), `_cols` only
    holds cache fills of what `column` decodes, so the typed accessors
    stay valid after a consumer decoded a column's strings."""

    def __init__(self, nrows: int):
        self.nrows = nrows
        self._cols: dict[str, list[str]] = {}
        self._bs = None
        self._sel: np.ndarray | None = None
        self._ts_np: np.ndarray | None = None
        self._needed: set | None = None       # the chain's needed fields
        # `fields` projection: ordered output names; others read as ""
        self._restrict: list[str] | None = None
        self._restrict_set: frozenset | None = None

    @staticmethod
    def from_block_search(bs, bm: np.ndarray,
                          needed: set | None = None) -> "BlockResult":
        """`needed` (None or a set holding "*" for all): the fields the
        pipe chain reads; `column_names` lists only those."""
        sel = np.nonzero(bm)[0]
        br = BlockResult(int(sel.shape[0]))
        br._bs = bs
        br._sel = sel
        br._needed = None if needed is None or "*" in needed else needed
        return br

    @staticmethod
    def from_columns(cols: dict[str, list[str]]) -> "BlockResult":
        br = BlockResult(len(next(iter(cols.values()))) if cols else 0)
        br._cols = dict(cols)
        return br

    def is_unprojected_block(self) -> bool:
        """A stored block that no `fields` pipe has projected."""
        return self._bs is not None and self._restrict is None

    def _hidden(self, name: str) -> bool:
        return self._restrict_set is not None and \
            name not in self._restrict_set

    @property
    def timestamps(self) -> list | None:
        """The rows' timestamps as ints, or None (see timestamps_np)."""
        ts = self.timestamps_np()
        return None if ts is None else ts.tolist()

    def has_column(self, name: str) -> bool:
        """Whether the batch holds `name` (a stored block: its virtual
        fields, consts and columns)."""
        if self._restrict_set is not None:
            return name in self._restrict_set
        if name in self._cols:
            return True
        return self._bs is not None and self._bs.has_column(name)

    def timestamps_np(self) -> np.ndarray | None:
        """int64 timestamps of the rows, or None for a batch that holds
        none (built by a pipe from string columns)."""
        if self._ts_np is None and self._bs is not None:
            self._ts_np = self._bs.timestamps()[self._sel]
        return self._ts_np

    def column(self, name: str) -> list[str]:
        if self._hidden(name):
            return [""] * self.nrows
        vals = self._cols.get(name)
        if vals is None:
            if self._bs is None:
                vals = [""] * self.nrows
            elif name == "_time":
                vals = format_rfc3339_many(self.timestamps_np())
            else:
                vals = values_at(self._bs, name, self._sel)
            self._cols[name] = vals
        return vals

    def _storage_column(self, name: str):
        """The block's encoded column `name`, or None for virtual, const,
        absent and projected-out fields and for batches not read from
        storage."""
        if self._bs is None or name in _VIRTUAL or self._hidden(name) or \
                name in self._bs.consts():
            return None
        return self._bs.column(name)

    def const_value(self, name: str) -> str | None:
        """The one value of a column known to be constant over the block
        (const columns; `_stream` and `_stream_id` are per block), or
        None."""
        if self.nrows == 0 or self._bs is None or self._hidden(name):
            return None
        c = self._bs.consts().get(name)
        if c is not None:
            return c
        if name == "_stream":
            return self._bs.stream_tags_str
        if name == "_stream_id":
            return self._bs.stream_id.as_string()
        return None

    def dict_value_counts(self, name: str):
        """[(value, count)] over the selected rows of a const or dict
        column, or None."""
        cv = self.const_value(name)
        if cv is not None:
            return [(cv, self.nrows)]
        dc = self.dict_column(name)
        if dc is None:
            return None
        ids, dvals = dc
        binc = np.bincount(ids, minlength=len(dvals))
        return [(dvals[j], int(binc[j])) for j in np.nonzero(binc)[0]]

    def dict_column(self, name: str):
        """(selected dict ids, dict values) of a dict-encoded storage
        column, or None."""
        col = self._storage_column(name)
        if col is None or col.vtype != VT_DICT:
            return None
        return col.ids[self._sel], col.dict_values

    def typed_numeric(self, name: str):
        """(selected values, is_int) of a uint/int/float storage column
        in its stored dtype, or None.  Numeric encodings round-trip, so
        a value maps back to its stored string."""
        col = self._storage_column(name)
        if col is None or col.vtype not in _INT_VTYPES + (VT_FLOAT64,):
            return None
        return col.nums[self._sel], col.vtype != VT_FLOAT64

    def numeric_column(self, name: str):
        """float64 values of a uint/int/float storage column, or None:
        what parse_number reads from each stored string, without the
        strings."""
        got = self.typed_numeric(name)
        return None if got is None else got[0].astype(np.float64)

    def header_min_max(self, name: str):
        """(min, max) of a numeric column from the block header, or
        None."""
        col = self._storage_column(name)
        if col is None or col.vtype not in _INT_VTYPES + (VT_FLOAT64,):
            return None
        return float(col.min_val), float(col.max_val)

    def column_names(self) -> list[str]:
        if self._restrict is not None:
            return list(self._restrict)
        names: dict[str, None] = {}
        if self._bs is not None:
            for n in list(_VIRTUAL) + self._bs.column_names():
                if self._needed is None or n in self._needed:
                    names[n] = None
        for n in self._cols:
            names[n] = None
        return list(names)

    def materialize(self, fields: list[str] | None = None) -> "BlockResult":
        """A detached copy of the named columns (all by default), with
        the rows' timestamps."""
        names = fields if fields is not None else self.column_names()
        out = BlockResult.from_columns({n: self.column(n) for n in names})
        out.nrows = self.nrows
        out._ts_np = self.timestamps_np()
        return out

    def restrict_fields(self, fields: list[str]) -> "BlockResult":
        """Project to exactly `fields`, in order, without leaving the
        block: names outside read as "", and the typed access of the
        names kept survives for the emit.  Chained projections only
        narrow."""
        fields = list(dict.fromkeys(fields))
        if self._bs is None:          # a detached copy of those columns
            return self.materialize(fields)
        br = BlockResult(self.nrows)
        br._bs = self._bs
        br._sel = self._sel
        br._ts_np = self._ts_np
        br._restrict = fields
        br._restrict_set = frozenset(fields) if self._restrict_set is None \
            else frozenset(fields) & self._restrict_set
        for n in fields:
            vals = self._cols.get(n)
            if vals is not None:
                br._cols[n] = vals
        return br

    def filter_rows(self, mask: np.ndarray) -> "BlockResult":
        keep = np.nonzero(mask)[0]
        br = BlockResult(int(keep.shape[0]))
        br._needed = self._needed
        br._restrict = self._restrict
        br._restrict_set = self._restrict_set
        kl = keep.tolist()
        for n, vals in self._cols.items():
            br._cols[n] = [vals[i] for i in kl]
        if self._bs is not None:
            br._bs = self._bs
            br._sel = self._sel[keep]
        if self._ts_np is not None:
            br._ts_np = self._ts_np[keep]
        return br

    def rows(self, fields: list[str] | None = None) -> list[dict]:
        """Row dicts; empty values are omitted.  The dict-rows oracle:
        the NDJSON emit reads `emit_columns` instead."""
        names = fields if fields is not None else self.column_names()
        if not names:
            return [{} for _ in range(self.nrows)]
        cols = [self.column(n) for n in names]
        return [{n: v for n, v in zip(names, tup) if v != ""}
                for tup in zip(*cols)]

    def emit_columns(self, fields: list[str] | None = None):
        """(names, [emit column per name]) of the selected rows: vector
        gathers from the stored arenas and typed arrays."""
        names = fields if fields is not None else self.column_names()
        return names, [self._emit_column(n) for n in names]

    def _emit_column(self, name: str):
        n = self.nrows
        if n == 0 or self._hidden(name):
            return _const_emit_col("", n)
        if self._bs is None:
            return _pack_str_column(self._cols.get(name) or [""] * n)
        if name == "_time":
            return (1, self.timestamps_np())
        cv = self.const_value(name)
        if cv is not None:
            return _const_emit_col(cv, n)
        col = self._bs.column(name)
        if col is None:
            return _const_emit_col("", n)
        vt = col.vtype
        if vt == VT_STRING:
            # zero copy: the stored arena is the emit arena
            return (0, col.arena, col.offsets[self._sel],
                    col.lengths[self._sel])
        if vt == VT_DICT:
            _k, arena, doffs, dlens = _pack_str_column(col.dict_values)
            ids = col.ids[self._sel]
            return 0, arena, doffs[ids], dlens[ids]
        if vt == VT_CONST:
            return _const_emit_col(col.const_value, n)
        if vt == VT_INT64:
            return (3, col.nums[self._sel])
        if vt in (VT_UINT8, VT_UINT16, VT_UINT32, VT_UINT64):
            return (4, col.nums[self._sel].astype(np.uint64))
        if vt == VT_FLOAT64:
            # Python's shortest round-trip repr, as the stored strings
            return _fixed_emit_col(
                _format_floats(col.nums[self._sel]).astype("S32"))
        if vt == VT_TIMESTAMP_ISO8601:
            return (2, col.nums[self._sel], col.iso_frac_w)
        # VT_IPV4: the decoded strings, gathered and packed
        full = col.to_strings(self._bs.nrows)
        return _pack_str_column([full[i] for i in self._sel.tolist()])
