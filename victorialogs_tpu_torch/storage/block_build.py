"""The block build of the flush: a row or column batch -> (stream,
time)-sorted columnar blocks, serially.

Both batch forms share one size-bounded chunking rule (block.chunk_end
over per-row size estimates) and one encoder (values_encoder), so the
same rows give the same blocks whichever way they came in.  A column
kept as one byte arena (`ArenaColumn`) encodes without per-row Python
strings on the paths its vectorized gates can prove
(`encode_arena_column`), byte for byte what `encode_values` gives for
the same values; anything they cannot prove goes through
`encode_values` itself.  Token hashes come from the native library
(native/ingest.py).
"""

from __future__ import annotations

import numpy as np

from ..native import ingest
from .block import BlockData, build_blocks, build_column_bloom, chunk_end
from .bloom import bloom_build
from .values_encoder import (_IPV4_RE, MAX_DICT_BYTES, MAX_DICT_ENTRIES,
                             VT_CONST, VT_DICT, VT_STRING, EncodedColumn,
                             encode_values, try_typed_encoding)


class ArenaColumn:
    """A value column kept as one ASCII byte arena with per-row offsets
    and lengths (byte offsets equal character offsets).  Reads like a
    read-only list of str for the paths that need one value or all of
    them; the block build reads `u8`/`offs`/`lens` directly."""

    __slots__ = ("u8", "offs", "lens", "text", "_mat")

    def __init__(self, raw: bytes, offs, lens, text: str):
        self.u8 = np.frombuffer(raw, dtype=np.uint8)
        self.offs = np.asarray(offs).astype(np.int64)
        self.lens = np.asarray(lens).astype(np.int64)
        self.text = text
        self._mat = None

    def __len__(self) -> int:
        return int(self.lens.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.materialize()[i]
        o = int(self.offs[i])
        return self.text[o:o + int(self.lens[i])]

    def __iter__(self):
        return iter(self.materialize())

    def materialize(self) -> list:
        """The values as a list of str (cached)."""
        m = self._mat
        if m is None:
            t = self.text
            ends = (self.offs + self.lens).tolist()
            m = self._mat = [t[s:e]
                             for s, e in zip(self.offs.tolist(), ends)]
        return m


def _gather(ac: ArenaColumn, idx: np.ndarray):
    """Rows `idx` of an arena column as one dense (sub, offs, lens)
    sub-arena in `idx` order."""
    lens = ac.lens[idx]
    total = int(lens.sum())
    offs = np.zeros(idx.shape[0], dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    if total:
        src = np.repeat(ac.offs[idx] - offs, lens) \
            + np.arange(total, dtype=np.int64)
        sub = ac.u8[src]
    else:
        sub = np.zeros(0, dtype=np.uint8)
    return sub, offs, lens


def _materialize(sub: np.ndarray, offs: np.ndarray,
                 lens: np.ndarray) -> list:
    t = sub.tobytes().decode("utf-8")
    ends = (offs + lens).tolist()
    return [t[s:e] for s, e in zip(offs.tolist(), ends)]


def encode_arena_column(name: str, sub: np.ndarray, offs: np.ndarray,
                        lens: np.ndarray) -> EncodedColumn:
    """`encode_values` over one dense ASCII sub-arena (offs: exclusive
    cumsum of lens): exactly what ``encode_values(name,
    _materialize(sub, offs, lens))`` returns, without per-row strings
    where a vectorized gate proves the outcome."""
    n = int(lens.shape[0])
    assert n > 0
    # numpy's S/U dtypes pad with NUL, so "12\x00" would alias "12" in
    # the padded trials: a column with a NUL takes encode_values
    if int(sub.shape[0]) and bool((sub == 0).any()):
        return encode_values(name, _materialize(sub, offs, lens))

    # const: one length, every row equal to the first
    first_len = int(lens[0])
    if bool((lens == first_len).all()):
        if first_len == 0 or bool(
                (sub.reshape(n, first_len) == sub[:first_len]).all()):
            return EncodedColumn(
                name=name, vtype=VT_CONST,
                const_value=sub[:first_len].tobytes().decode("utf-8"))

    W = int(lens.max())
    # dict: a single value over MAX_DICT_BYTES already overflows the
    # distinct-bytes budget, so W also bounds the padded matrix
    if W <= MAX_DICT_BYTES:
        col = _try_dict_arena(name, sub, offs, lens, n, W)
        if col is not None:
            return col

    first = sub[:first_len].tobytes().decode("utf-8")
    if _typed_gate(first):
        arr = _padded_u(sub, offs, lens, n, W)
        col = try_typed_encoding(
            name, arr, first, lambda: _materialize(sub, offs, lens))
        if col is not None:
            return col

    # the gathered sub-arena is the string payload
    return EncodedColumn(name=name, vtype=VT_STRING, arena=sub,
                         offsets=offs, lengths=lens)


def _typed_gate(first: str) -> bool:
    """True when any numeric/IPv4/ISO8601 trial could accept a column
    whose first value is `first`.  Exact: each trial either checks the
    first value the same way or (float64) parses element 0 first."""
    if first[:1].isdigit() or first[:1] == "-":
        return True
    if _IPV4_RE.match(first):
        return True
    if len(first) >= 20 and first[4:5] == "-" and first.endswith("Z"):
        return True
    try:
        np.asarray([first], dtype="U").astype(np.float64)
        return True
    except ValueError:
        return False


def _padded_u(sub: np.ndarray, offs: np.ndarray, lens: np.ndarray,
              n: int, W: int) -> np.ndarray:
    """The rows as one U<W> array, element for element what
    ``np.asarray(values, dtype="U")`` gives encode_values: the arena is
    ASCII and NUL-free here, so S->U padding is unambiguous."""
    mat = np.zeros((n, W), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        row = np.repeat(np.arange(n, dtype=np.int64) * W, lens)
        inrow = np.arange(total, dtype=np.int64) - np.repeat(offs, lens)
        mat.reshape(-1)[row + inrow] = sub
    return mat.reshape(-1).view(f"S{W}").astype(f"U{W}")


def _void_rows(sub: np.ndarray, offs: np.ndarray, lens: np.ndarray,
               n: int, W: int) -> np.ndarray:
    """(n,) void view of the rows padded to W bytes plus a u16 length,
    so "a" and "a\\x00" never share a key."""
    Wp = W + 2
    mat = np.zeros((n, Wp), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        row = np.repeat(np.arange(n, dtype=np.int64) * Wp, lens)
        inrow = np.arange(total, dtype=np.int64) - np.repeat(offs, lens)
        mat.reshape(-1)[row + inrow] = sub
    mat[:, W] = (lens & 0xFF).astype(np.uint8)
    mat[:, W + 1] = (lens >> 8).astype(np.uint8)
    return mat.reshape(-1).view(np.dtype((np.void, Wp)))


_DICT_PREGATE_ROWS = 512


def _try_dict_arena(name: str, sub: np.ndarray, offs: np.ndarray,
                    lens: np.ndarray, n: int, W: int):
    """The VT_DICT trial over the arena: distinct rows by np.unique, ids
    in first-seen order (encode_values' order); None exactly when
    encode_values rejects."""
    if n > _DICT_PREGATE_ROWS:
        # a prefix over either budget rejects the whole column, so
        # high-cardinality columns never pay the full matrix
        p = _DICT_PREGATE_ROWS
        pend = int(offs[p - 1] + lens[p - 1])
        pu, pidx = np.unique(
            _void_rows(sub[:pend], offs[:p], lens[:p], p, W),
            return_index=True)
        if pu.shape[0] > MAX_DICT_ENTRIES or \
                int(lens[pidx].sum()) > MAX_DICT_BYTES:
            return None
    uniq, first_idx, inv = np.unique(
        _void_rows(sub, offs, lens, n, W),
        return_index=True, return_inverse=True)
    k = int(uniq.shape[0])
    if k > MAX_DICT_ENTRIES or int(lens[first_idx].sum()) > MAX_DICT_BYTES:
        return None
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(k, dtype=np.uint8)
    rank[order] = np.arange(k, dtype=np.uint8)
    dvals = []
    for i in first_idx[order].tolist():
        o = int(offs[i])
        dvals.append(sub[o:o + int(lens[i])].tobytes().decode("utf-8"))
    return EncodedColumn(name=name, vtype=VT_DICT, dict_values=dvals,
                         ids=rank[inv.reshape(-1)])


def _typed_column_bloom(col: EncodedColumn, arena) -> None:
    """The bloom of a typed column from its arena before encoding: the
    encoding round-trips exactly, so these are its values and the
    distinct-token-hash set is the one build_column_bloom would take
    (kept on the column for the filter index, as there)."""
    col.token_hashes = ingest.unique_token_hashes(*arena)
    col.bloom = bloom_build(col.token_hashes)


def _chunk_block(sid, ts: np.ndarray, chunk_cols: list,
                 tags: str) -> BlockData:
    """One (stream, chunk) block.  chunk_cols: (name, payload) in schema
    order; a payload is a value list or an (ArenaColumn, row indices)
    pair gathered here."""
    nrows = int(ts.shape[0])
    columns: list = []
    const_columns: list = []
    for name, payload in chunk_cols:
        arena = None
        if type(payload) is tuple:
            ac, idx = payload
            arena = _gather(ac, idx)
            col = encode_arena_column(name, *arena)
        else:
            col = encode_values(name, payload)
        if col.vtype == VT_CONST:
            const_columns.append((name, col.const_value))
            continue
        if arena is not None and col.vtype not in (VT_DICT, VT_STRING):
            _typed_column_bloom(col, arena)
        else:
            build_column_bloom(col, nrows)
        columns.append(col)
    return BlockData(stream_id=sid, timestamps=ts, columns=columns,
                     const_columns=const_columns, stream_tags_str=tags)


def build_columns_blocks(lc) -> list:
    """LogColumns -> blocks sorted by (stream_id, first timestamp).  A
    stream whose rows span several schema groups goes through the row
    build, so each stream still gets non-overlapping time-sorted blocks
    (the flush merge's input invariant)."""
    gcount: dict = {}
    for g in lc.groups.values():
        for sid, _t, _s in g.streams:
            gcount[sid] = gcount.get(sid, 0) + 1
    slow: list = []          # (sid, ts, fields, tags) across groups
    out: list = []
    for g in lc.groups.values():
        n = len(g.ts)
        if not n:
            continue
        ts = np.asarray(g.ts, dtype=np.int64)
        # streams ranked in StreamID order, the row build's sort order
        by_sid = sorted(range(len(g.streams)),
                        key=lambda k: g.streams[k][0])
        rank = np.empty(len(g.streams), dtype=np.int64)
        rank[by_sid] = np.arange(len(by_sid), dtype=np.int64)
        rr = rank[np.asarray(g.sref, dtype=np.int64)]
        order = np.lexsort((ts, rr))
        rro = rr[order]
        bounds = [0] + (np.nonzero(np.diff(rro))[0] + 1).tolist() + [n]
        for b in range(len(bounds) - 1):
            idxs = order[bounds[b]:bounds[b + 1]]
            sid, _tenant, tags = g.streams[g.sref[idxs[0]]]
            if gcount[sid] > 1:
                for k in idxs.tolist():
                    fields = [(nm, c[k]) for nm, c in zip(g.names, g.cols)]
                    slow.append((sid, g.ts[k], fields, tags))
                continue
            run_ts = ts[idxs]
            # per-row size estimates as row_cost_cum counts them: value
            # lengths (an arena column's byte lengths equal its character
            # lengths) plus len(name) + 16 a field and 8 a row
            rb = np.zeros(idxs.shape[0], dtype=np.int64)
            il = None
            mats: list = []
            for nm, c in zip(g.names, g.cols):
                if type(c) is ArenaColumn:
                    rb += c.lens[idxs]
                    mats.append(None)
                else:
                    if il is None:
                        il = idxs.tolist()
                    vals = [c[k] for k in il]
                    rb += np.fromiter(map(len, vals), dtype=np.int64,
                                      count=len(vals))
                    mats.append(vals)
                rb += len(nm) + 16
            cum = np.cumsum(rb + 8)
            s = 0
            nrun = int(idxs.shape[0])
            while s < nrun:
                e = chunk_end(cum, s)
                chunk_cols = [(nm, (c, idxs[s:e]) if vals is None
                               else vals[s:e])
                              for nm, c, vals in zip(g.names, g.cols, mats)]
                out.append(_chunk_block(sid, run_ts[s:e], chunk_cols, tags))
                s = e
    if slow:
        slow.sort(key=lambda r: (r[0], r[1]))
        i = 0
        while i < len(slow):
            sid = slow[i][0]
            j = i
            while j < len(slow) and slow[j][0] == sid:
                j += 1
            run = slow[i:j]
            out.extend(build_blocks(
                sid, np.array([r[1] for r in run], dtype=np.int64),
                [r[2] for r in run], run[0][3]))
            i = j
    out.sort(key=lambda b: (b.stream_id, int(b.timestamps[0])))
    return out


def build_log_rows_blocks(lr) -> list[BlockData]:
    """LogRows -> blocks: rows sorted by (stream_id, timestamp), each
    stream's run cut into size-bounded blocks."""
    n = len(lr)
    if n == 0:
        return []
    sids = lr.stream_ids
    # rank streams by StreamID order (tenant, hi, lo); rows share their
    # stream's StreamID objects, so factorize by identity first
    _, first, inv = np.unique(np.fromiter(map(id, sids), dtype=np.int64,
                                          count=n), return_index=True,
                              return_inverse=True)
    uniq = [sids[i] for i in first.tolist()]
    rank_of: dict = {}
    for sid in sorted(uniq):
        rank_of.setdefault(sid, len(rank_of))
    rank = np.array([rank_of[s] for s in uniq], dtype=np.int64)[
        inv.reshape(-1)]
    ts_arr = np.asarray(lr.timestamps, dtype=np.int64)
    order = np.lexsort((ts_arr, rank))
    r_sorted = rank[order]
    bounds = [0] + (np.nonzero(np.diff(r_sorted))[0] + 1).tolist() + [n]
    out: list[BlockData] = []
    for i, j in zip(bounds[:-1], bounds[1:]):
        idxs = order[i:j]
        k0 = int(idxs[0])
        out.extend(build_blocks(sids[k0], ts_arr[idxs],
                                [lr.rows[k] for k in idxs.tolist()],
                                lr.stream_tags_str[k0]))
    return out
