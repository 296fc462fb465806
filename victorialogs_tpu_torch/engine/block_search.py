"""Per-block scan state: lazy column access for the filter tree.

Wraps one (part, block) pair, caches lazily read timestamps, columns
and decoded values (a file part decompresses a column at each read),
and is what filters AND themselves against.
"""

from __future__ import annotations

import numpy as np

from ..storage.values_encoder import VT_DICT, VT_NAMES, decode_values

_VIRTUAL = ("_time", "_stream", "_stream_id")


class BlockSearch:
    def __init__(self, part, block_idx: int, ctx=None):
        self.part = part
        self.block_idx = block_idx
        self.ctx = ctx                 # SearchContext (partition, tenants)
        self.nrows = part.block_rows(block_idx)
        self.stream_id = part.block_stream_id(block_idx)
        self.stream_tags_str = part.block_tags(block_idx)
        self._consts: dict[str, str] | None = None
        self._timestamps: np.ndarray | None = None
        self._columns: dict = {}
        self._values: dict[str, list[str]] = {}

    def timestamps(self) -> np.ndarray:
        if self._timestamps is None:
            self._timestamps = self.part.block_timestamps(self.block_idx)
        return self._timestamps

    def consts(self) -> dict[str, str]:
        if self._consts is None:
            self._consts = dict(self.part.block_consts(self.block_idx))
        return self._consts

    def column(self, name: str):
        if name not in self._columns:
            self._columns[name] = self.part.block_column(self.block_idx,
                                                         name)
        return self._columns[name]

    def column_meta(self, name: str) -> dict | None:
        """The column's header: type `t`, `min`/`max` of a numeric
        column; None for a const or missing column."""
        return self.part.block_column_meta(self.block_idx, name)

    def value_type_name(self, name: str) -> str:
        """The column's encoding as value_type() names it: "const" for
        a const column, "" for a missing one."""
        if name in self.consts():
            return "const"
        meta = self.column_meta(name)
        return "" if meta is None else VT_NAMES[meta["t"]]

    def bloom(self, name: str):
        return self.part.block_column_bloom(self.block_idx, name)

    def column_names(self) -> list[str]:
        return list(self.consts()) + self.part.block_col_names(
            self.block_idx)

    def has_column(self, name: str) -> bool:
        if name in ("_time", "_stream", "_stream_id"):
            return True
        return name in self.consts() or self.column_meta(name) is not None

    def values(self, name: str) -> list[str]:
        """Decoded string values of a column (virtual columns included);
        an absent field reads as ''."""
        vals = self._values.get(name)
        if vals is not None:
            return vals
        if name == "_time":
            from ..logsql.duration import format_rfc3339_many
            vals = format_rfc3339_many(self.timestamps())
        elif name == "_stream":
            vals = [self.stream_tags_str] * self.nrows
        elif name == "_stream_id":
            vals = [self.stream_id.as_string()] * self.nrows
        elif name in self.consts():
            vals = [self.consts()[name]] * self.nrows
        else:
            col = self.column(name)
            vals = [""] * self.nrows if col is None else \
                col.to_strings(self.nrows)
        self._values[name] = vals
        return vals


def values_at(bs: BlockSearch, name: str, rows: np.ndarray) -> list[str]:
    """bs.values(name) at the int indexes `rows`.  A stored column not
    decoded yet decodes only those rows: a file part's column is read
    anew by each query, so its other rows would be decoded for
    nothing."""
    if name not in _VIRTUAL and name not in bs.consts():
        col = bs.column(name)
        if col is None:
            return [""] * len(rows)
        if col._strings_cache is None:
            return decode_values(col, bs.nrows, rows)
    full = bs.values(name)
    return [full[i] for i in rows.tolist()]


def visit_values(bs: BlockSearch, name: str, bm: np.ndarray, pred) -> None:
    """AND pred(value) into bm: once per dict entry for dict columns,
    once in total for const/missing columns, else per set row."""
    if not bm.any():
        return
    if name not in ("_time", "_stream", "_stream_id"):
        c = bs.consts().get(name)
        col = bs.column(name) if c is None else None
        if c is not None or col is None:
            if not pred("" if c is None else c):
                bm[:] = False
            return
        if col.vtype == VT_DICT:
            lut = np.fromiter((pred(v) for v in col.dict_values),
                              dtype=bool, count=len(col.dict_values))
            bm &= lut[col.ids]
            return
    vals = bs.values(name)
    for i in np.nonzero(bm)[0].tolist():
        if not pred(vals[i]):
            bm[i] = False
