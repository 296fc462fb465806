"""The flush merge: the block lists of a partition's buffered batches
-> the block list of one part.

Each batch's blocks are sorted by (stream_id, min_ts).  A k-way merge
walks them in that order: a block that overlaps no other batch's block
of its stream passes through when it holds COALESCE_MIN_ROWS rows or
more, and runs of smaller same-stream blocks are concatenated column by
column and re-encoded in chunks of MERGE_TARGET_ROWS rows; only
same-stream blocks whose time ranges overlap are merged row by row.
"""

from __future__ import annotations

import heapq

import numpy as np

from .block import BlockData, build_block_from_columns, build_blocks

MERGE_TARGET_ROWS = 128 * 1024   # coalesce small same-stream blocks up to
COALESCE_MIN_ROWS = 64 * 1024    # blocks >= this pass through unchanged


def _block_rows(blocks: list[BlockData]):
    """(stream_id, ts, fields, tags) of every row of the blocks: the
    non-empty column values, then the const columns."""
    for b in blocks:
        nrows = b.num_rows
        col_strs = [(c.name, c.to_strings(nrows)) for c in b.columns]
        consts = b.const_columns
        ts = b.timestamps.tolist()
        for ri in range(nrows):
            fields = [(n, vals[ri]) for n, vals in col_strs
                      if vals[ri] != ""]
            fields += [(k, v) for k, v in consts]
            yield (b.stream_id, ts[ri], fields, b.stream_tags_str)


def _row_merge_blocks(blocks: list[BlockData]) -> list[BlockData]:
    """Same-stream blocks with overlapping time ranges, merged by row."""
    rows = sorted(_block_rows(blocks), key=lambda r: (r[0], r[1]))
    ts = np.fromiter((r[1] for r in rows), dtype=np.int64, count=len(rows))
    return build_blocks(rows[0][0], ts, [r[2] for r in rows], rows[0][3])


def _block_columns(b: BlockData) -> dict[str, list[str]]:
    n = b.num_rows
    out = {c.name: c.to_strings(n) for c in b.columns}
    for k, v in b.const_columns:
        out[k] = [v] * n
    return out


def _coalesce_same_stream(blocks: list[BlockData]) -> list[BlockData]:
    """Adjacent small blocks of one stream concatenated column by column
    (their time ranges are already in order) and re-encoded."""
    names: dict[str, None] = {}
    for b in blocks:
        for c in b.columns:
            names.setdefault(c.name, None)
        for k, _v in b.const_columns:
            names.setdefault(k, None)
    cols: dict[str, list[str]] = {n: [] for n in names}
    for b in blocks:
        bc = _block_columns(b)
        n = b.num_rows
        for name in names:
            vals = bc.get(name)
            cols[name].extend(vals if vals is not None else [""] * n)
    ts = np.concatenate([b.timestamps for b in blocks])
    total = int(ts.shape[0])
    out = []
    for i in range(0, total, MERGE_TARGET_ROWS):
        j = min(i + MERGE_TARGET_ROWS, total)
        out.append(build_block_from_columns(
            blocks[0].stream_id, ts[i:j],
            {n: v[i:j] for n, v in cols.items()},
            blocks[0].stream_tags_str))
    return out


def merge_block_streams(parts_blocks):
    """k-way merge of block lists, each sorted by (stream_id, min_ts),
    into one list in that order."""
    heap = []
    seq = 0
    for blocks in parts_blocks:
        it = iter(blocks)
        b = next(it, None)
        if b is not None:
            heapq.heappush(heap, (b.stream_id, b.min_ts, seq, b, it))
            seq += 1

    pending: list[BlockData] = []   # small same-stream blocks to coalesce
    pending_rows = 0

    def flush_pending():
        nonlocal pending, pending_rows
        out = _coalesce_same_stream(pending) if len(pending) > 1 \
            else pending
        pending = []
        pending_rows = 0
        return out

    while heap:
        sid, _mt, _s, b, it = heapq.heappop(heap)
        nb = next(it, None)
        if nb is not None:
            heapq.heappush(heap, (nb.stream_id, nb.min_ts, seq, nb, it))
            seq += 1
        # the same stream's blocks of other batches that overlap it
        group = [b]
        gmax = b.max_ts
        while heap:
            sid2, mt2, _s2, _b2, it2 = heap[0]
            if sid2 != sid or mt2 > gmax:
                break
            b2 = heapq.heappop(heap)[3]
            group.append(b2)
            gmax = max(gmax, b2.max_ts)
            nb2 = next(it2, None)
            if nb2 is not None:
                heapq.heappush(
                    heap, (nb2.stream_id, nb2.min_ts, seq, nb2, it2))
                seq += 1
        merged = _row_merge_blocks(group) if len(group) > 1 else group
        for mb in merged:
            if pending and pending[0].stream_id != mb.stream_id:
                yield from flush_pending()
            if mb.num_rows >= COALESCE_MIN_ROWS:
                yield from flush_pending()
                yield mb
                continue
            if pending_rows + mb.num_rows > MERGE_TARGET_ROWS:
                yield from flush_pending()
            pending.append(mb)
            pending_rows += mb.num_rows
    yield from flush_pending()
