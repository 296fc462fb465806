"""Columnar blocks: one stream's time-sorted rows, size-bounded.

A block holds up to MAX_ROWS_PER_BLOCK rows of a single stream sorted by
timestamp.  Every present field becomes a column through the values
encoder; a column identical across all rows becomes a const column, and
every other non-dict column gets a token bloom filter.  A batch becomes
blocks in storage/block_build.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain

import numpy as np

from ..native import ingest
from .bloom import bloom_build
from .log_rows import StreamID
from .values_encoder import (EncodedColumn, VT_CONST, VT_DICT, VT_STRING,
                             encode_values)

MAX_ROWS_PER_BLOCK = 128 * 1024
MAX_UNCOMPRESSED_BLOCK_SIZE = 8 << 20


@dataclass
class BlockData:
    """One decoded columnar block."""

    stream_id: StreamID
    timestamps: np.ndarray                      # int64[R] ns, sorted
    columns: list[EncodedColumn]                # per-row columns
    const_columns: list[tuple[str, str]]        # (name, value)
    stream_tags_str: str = ""                   # canonical {k="v"} labels

    @property
    def num_rows(self) -> int:
        return int(self.timestamps.shape[0])

    @property
    def min_ts(self) -> int:
        return int(self.timestamps[0]) if self.num_rows else 0

    @property
    def max_ts(self) -> int:
        return int(self.timestamps[-1]) if self.num_rows else 0

    def uncompressed_size(self) -> int:
        """The bytes of the block's decoded columns and timestamps, as a
        part's metadata counts them."""
        sz = 8 * self.num_rows
        for c in self.columns:
            if c.vtype == VT_STRING:
                sz += int(c.lengths.sum()) + 8 * self.num_rows
            elif c.vtype == VT_DICT:
                sz += self.num_rows
            else:
                sz += c.nums.itemsize * self.num_rows
        return sz

    def get_column(self, name: str) -> EncodedColumn | None:
        for c in self.columns:
            if c.name == name:
                return c
        return None


def column_token_hashes(col: EncodedColumn, nrows: int):
    """Distinct token hashes of a column; None for const/dict columns
    (they carry no bloom).  One native pass tokenizes, hashes and
    dedupes (native/ingest.py); typed (numeric/IPv4/ISO8601) columns
    decode to ASCII, where the byte tokenizer equals tokenize_string,
    so every column tokenizes as one arena."""
    if col.vtype in (VT_CONST, VT_DICT):
        return None
    if col.vtype == VT_STRING:
        return ingest.unique_token_hashes(col.arena, col.offsets,
                                          col.lengths)
    enc = [v.encode("utf-8") for v in col.to_strings(nrows)]
    lens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
    offs = np.zeros(len(enc), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return ingest.unique_token_hashes(
        np.frombuffer(b"".join(enc), dtype=np.uint8), offs, lens)


def build_column_bloom(col: EncodedColumn, nrows: int) -> None:
    """Attach the token bloom filter and keep its token hashes (none
    for const/dict columns)."""
    hashes = column_token_hashes(col, nrows)
    if hashes is not None:
        col.token_hashes = hashes
        col.bloom = bloom_build(hashes)


def row_cost_cum(rows: list[list[tuple[str, str]]]) -> np.ndarray:
    """Inclusive running total of per-row size estimates:
    len(k)+len(v)+16 per field plus 8 per row."""
    nf = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
    flat = list(chain.from_iterable(chain.from_iterable(rows)))
    cl = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, flat), dtype=np.int64, count=len(flat)),
              out=cl[1:])
    ends = np.cumsum(2 * nf)
    return np.cumsum(cl[ends] - cl[ends - 2 * nf] + 16 * nf + 8)


def chunk_end(cum: np.ndarray, start: int,
              max_rows: int = MAX_ROWS_PER_BLOCK,
              max_bytes: int = MAX_UNCOMPRESSED_BLOCK_SIZE) -> int:
    """End (exclusive) of the size-bounded chunk starting at `start`: a
    row joins while the byte budget before it is still positive, with
    at least one and at most `max_rows` rows per chunk."""
    n = int(cum.shape[0])
    base = int(cum[start - 1]) if start else 0
    e = start + 1 + int(np.searchsorted(cum[start:], base + max_bytes,
                                        side="left"))
    return min(e, start + max_rows, n)


def _columns_of(rows: list[list[tuple[str, str]]]) -> dict[str, list]:
    """Column name -> per-row values ('' where a row lacks the field),
    names in first-seen order."""
    nrows = len(rows)
    if len(set(map(len, rows))) == 1:
        # one schema (the common case): transpose at C speed
        flat = list(zip(*map(chain.from_iterable, rows)))
        names = flat[0::2]
        if all(len(set(n)) == 1 for n in names):
            return {n[0]: list(v) for n, v in zip(names, flat[1::2])}
    cols: dict[str, list] = {}
    for r in rows:
        for k, _ in r:
            cols.setdefault(k, None)
    cols = {n: [""] * nrows for n in cols}
    for ri, r in enumerate(rows):
        for k, v in r:
            cols[k][ri] = v
    return cols


def build_block_from_columns(stream_id: StreamID, timestamps,
                             col_values: dict[str, list],
                             stream_tags_str: str) -> BlockData:
    """Encode one block from its columns (name -> per-row values, in
    column order) of one stream's time-sorted rows."""
    ts = np.asarray(timestamps, dtype=np.int64)
    nrows = int(ts.shape[0])
    columns: list[EncodedColumn] = []
    const_columns: list[tuple[str, str]] = []
    for name, values in col_values.items():
        col = encode_values(name, values)
        if col.vtype == VT_CONST:
            const_columns.append((name, col.const_value))
            continue
        build_column_bloom(col, nrows)
        columns.append(col)
    return BlockData(stream_id=stream_id, timestamps=ts, columns=columns,
                     const_columns=const_columns,
                     stream_tags_str=stream_tags_str)


def build_block(stream_id: StreamID, timestamps: np.ndarray,
                rows: list[list[tuple[str, str]]],
                stream_tags_str: str) -> BlockData:
    """Encode one chunk of time-sorted rows of one stream."""
    return build_block_from_columns(stream_id, timestamps,
                                    _columns_of(rows), stream_tags_str)


def build_blocks(stream_id: StreamID, timestamps: np.ndarray,
                 rows: list[list[tuple[str, str]]],
                 stream_tags_str: str) -> list[BlockData]:
    """One stream's time-sorted rows cut into size-bounded blocks."""
    out: list[BlockData] = []
    if not rows:
        return out
    cum = row_cost_cum(rows)
    s = 0
    while s < len(rows):
        e = chunk_end(cum, s)
        out.append(build_block(stream_id, timestamps[s:e], rows[s:e],
                               stream_tags_str))
        s = e
    return out
