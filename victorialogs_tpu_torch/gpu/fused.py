"""One device program per part: filter tree -> row bitmap or counts.

The host planner (`_Planner`) walks a query's filter tree against one
part and emits a small program plus the device tensors it reads:

- leaves become `scan` (kernel 1 over the part's staged column), `pair`
  (the regexp `A.*B`: kernels.match_pair, truncated rows applied in its
  launch), `time` (timestamp compare), `maskleaf` (a per-block-constant
  filter: `_stream:{...}`, `_stream_id:`, `value_type()`, expanded to
  rows), `nonempty` and `empty` (length compares), `numrange` (a range
  over an int column's staged uint32 offsets, compared unsigned),
  `lenrange` (len_range over the staged lengths) and `ovfmaybe`;
  `in(...)` is an OR of exact scans, `contains_all`/`contains_any` an
  AND/OR of phrase scans; a regexp that is neither one literal nor a
  pair, and a `seq()` of two or more phrases, become `verify` over the
  AND of their scans: no row is definite, the candidates are maybe
  rows;
- a bloom-prunable scan whose required tokens rule out some (not all)
  candidate blocks becomes a `gscan` node: one launch that probes each
  block's packed bloom plane on the card and scans only the rows of the
  blocks it keeps (kernels.match_scan_gated); a pair leaf so pruned
  becomes a `gpair` node the same way (kernels.match_pair_gated: the
  JAX planner ANDs the pair with its bloom node).  When the tokens rule
  out every block the leaf folds to false with no scan at all.  An
  `ovfmaybe` leaf is not gated: its rows are maybe rows, which the host
  settles with the filter's own predicate anyway.  On a sealed part
  with a filter index the keep-mask comes from the exact maplet, and
  the gate is the split-block probe: `gscan_sb` and `gpair_sb` nodes
  (kernels.match_scan_gated_sb, match_pair_gated_sb; the JAX planner's
  `bloom_sb` node).  The walk has already dropped the blocks an
  AND-path leaf rules out, so there such a leaf keeps every candidate
  and goes ungated; a leaf under `or` or NOT keeps its gate;
- constant subtrees fold away.

`eval_node` evaluates the program three-valued: every node yields
(definite, maybe) row masks.  `maybe` collects rows whose staged value
was truncated (longer than the staged width), a pair's rows holding a
newline, a verify leaf's candidates, for an any-case scan the rows
holding a byte >= 0x80 (Unicode lowering can map non-ASCII onto ASCII,
U+212A -> 'k', which the byte fold cannot see) and for `lenrange` the
multibyte rows whose byte length leaves the code-point count open: the
host settles them with the filter's own predicate, so results equal the
host executor's.  Filters the planner cannot express raise `_NoFuse`;
the runner then walks the tree leaf by leaf (gpu/batch.py).

`topk_rows` is the sort prefilter's k-selection over a program's masks
(`torch.topk`: the JAX package's `lax.top_k` also runs outside any
Pallas kernel), `topk_rows_packed` its per-member form over a packed
unit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import to_device
from ..logsql import filters as F
from ..logsql.matchers import is_word_char, parse_number
from ..logsql.stats_funcs import format_number
from ..storage.filterbank import bloom_keep_mask, bloom_plane
from ..storage.filterindex import part_index
from ..storage.values_encoder import VT_DICT, VT_STRING
from ..utils.hashing import cached_token_hashes
from . import kernels as K
from .bloom_device import BloomGate, SbGate, pad_probe_args, pad_sb_idx
from .layout import row_width_bucket, to_fixed_width, to_lanes32
from .stats_device import SYNTH_EMPTY, SYNTH_LEN


@dataclass
class StatsLayout:
    """Whole-part row layout: every block in index order."""
    starts: dict                   # block_idx -> first row
    nrows: int
    nrows_padded: int              # a multiple of 8 (bit packing)

    def device_bytes(self) -> int:
        return 64 * len(self.starts)


def part_layout(part) -> StatsLayout:
    starts = {}
    pos = 0
    for bi in range(part.num_blocks):
        starts[bi] = pos
        pos += part.block_rows(bi)
    return StatsLayout(starts=starts, nrows=pos,
                       nrows_padded=max(8, -(-pos // 8) * 8))


@dataclass
class FusedField:
    """One column staged over EVERY block of a part, layout coords."""
    lanes: torch.Tensor            # int32[W/4, RLp]
    lengths: torch.Tensor          # int32[RLp]
    width: int
    ovf: torch.Tensor | None       # bool[RLp] truncated rows, or None
    nbytes: int

    def device_bytes(self) -> int:
        return self.nbytes


def stage_layout_column(part, field: str, layout: StatsLayout,
                        device) -> FusedField | None:
    """Materialize `field` for all blocks into one (RLp, W) matrix:
    string blocks copy their values, dict blocks gather per code, const
    and missing blocks broadcast one value ('' when missing).  None when
    any block is numeric-typed (the host decodes those)."""
    virtual = field in ("_stream", "_stream_id")
    plans = []        # (start, n, kind, payload)
    max_len = 0
    for bi in range(part.num_blocks):
        start, n = layout.starts[bi], part.block_rows(bi)
        if virtual:
            v = part.block_tags(bi) if field == "_stream" else \
                part.block_stream_id(bi).as_string()
            plans.append((start, n, "const", v.encode("utf-8")))
            continue
        meta = part.block_column_meta(bi, field)
        if meta is None:
            b = dict(part.block_consts(bi)).get(field, "").encode("utf-8")
            plans.append((start, n, "const", b))
            continue
        col = part.block_column(bi, field)
        if meta["t"] == VT_STRING:
            plans.append((start, n, "str", col))
            if col.lengths.size:
                max_len = max(max_len, int(col.lengths.max()))
        elif meta["t"] == VT_DICT:
            enc = [v.encode("utf-8") for v in col.dict_values]
            plans.append((start, n, "dict", (col.ids, enc)))
            max_len = max([max_len] + [len(b) for b in enc])
        else:
            return None
    for _s, _n, kind, payload in plans:
        if kind == "const":
            max_len = max(max_len, len(payload))
    w = row_width_bucket(max_len)
    rlp = layout.nrows_padded
    mat = np.full((rlp, w), 0xFF, dtype=np.uint8)
    lens = np.zeros(rlp, dtype=np.int32)
    ovf = np.zeros(rlp, dtype=bool)

    def fill(rows, b: bytes):
        cl = min(len(b), w - 1)
        mat[rows, :cl] = np.frombuffer(b[:cl], dtype=np.uint8)
        lens[rows] = cl
        ovf[rows] = len(b) > w - 1

    for start, n, kind, payload in plans:
        if kind == "str":
            col = payload
            sub, ov = to_fixed_width(col.arena, col.offsets, col.lengths, n,
                                     w)
            mat[start:start + n] = sub
            lens[start:start + n] = np.minimum(col.lengths, w - 1)
            ovf[start + ov] = True
        elif kind == "dict":
            ids, enc = payload
            for code, b in enumerate(enc):
                sel = np.nonzero(ids == code)[0]
                if sel.size:
                    fill(start + sel, b)
        else:
            fill(slice(start, start + n), payload)
    has_ovf = bool(ovf.any())
    return FusedField(
        lanes=to_device(to_lanes32(mat).view(np.int32), device),
        lengths=to_device(lens, device), width=w,
        ovf=to_device(ovf, device) if has_ovf else None,
        nbytes=rlp * (w + 5))


# ---------------- leaf plans ----------------

@dataclass
class ScanOp:
    pattern: bytes
    mode: int
    starts_tok: bool = False
    ends_tok: bool = False
    match_nonempty: bool = False   # prefix "": any non-empty value
    match_empty: bool = False      # contains "": only the empty value
    # ASCII case fold of the data (pattern pre-lowered); rows holding a
    # byte >= 0x80 are maybe rows
    fold: bool = False


@dataclass
class LeafPlan:
    filter: object                 # the Filter (host settling + pred)
    field: str
    ops: list                      # ScanOps
    combine: str                   # 'and' | 'or'
    bloom_tokens: list
    verify: bool = False           # the ops only prefilter: maybe rows
    pair: tuple | None = None      # (A, B) of the regexp `A.*B`


def device_plan(f) -> LeafPlan | None:
    """One filter leaf as device scan ops; None => host-only leaf."""
    if not isinstance(f, F._ValuePredFilter):
        return None

    def ok(s: str) -> bool:
        return s.isascii() and 0 < len(s) <= K.MAX_PATTERN_LEN

    fld = F.canonical_field(f.field)
    if isinstance(f, F.FilterSequence):
        if not f.phrases or not all(ok(p) for p in f.phrases):
            return None
        # each phrase at word boundaries is exact per phrase; the order
        # of two or more is the host's to check
        return LeafPlan(f, fld, [ScanOp(p.encode(), K.MODE_PHRASE,
                                        is_word_char(p[0]),
                                        is_word_char(p[-1]))
                                 for p in f.phrases], "and", f._tokens(),
                        verify=len(f.phrases) > 1)
    if isinstance(f, (F.FilterContainsAll, F.FilterContainsAny)):
        if not f.values or any(p and not ok(p) for p in f.values):
            return None
        every = isinstance(f, F.FilterContainsAll)
        return LeafPlan(f, fld, [
            ScanOp(p.encode(), K.MODE_PHRASE, is_word_char(p[0]),
                   is_word_char(p[-1])) if p else
            ScanOp(b"", 0, match_empty=True) for p in f.values],
            "and" if every else "or", f._tokens() if every else [])
    if isinstance(f, F.FilterPrefix) and not f.prefix or \
            isinstance(f, F.FilterAnyCasePrefix) and not f._lower:
        return LeafPlan(f, fld, [ScanOp(b"", 0, match_nonempty=True)],
                        "and", [])
    if isinstance(f, (F.FilterAnyCasePhrase, F.FilterAnyCasePrefix)):
        low = f._lower
        if not ok(low):
            return None
        phrase = isinstance(f, F.FilterAnyCasePhrase)
        return LeafPlan(f, fld, [ScanOp(
            low.encode(), K.MODE_PHRASE if phrase else K.MODE_PREFIX,
            is_word_char(low[0]), phrase and is_word_char(low[-1]),
            fold=True)], "and", [])
    if isinstance(f, F.FilterRegexp):
        if f._pair is not None and all(len(p) <= K.MAX_PATTERN_LEN
                                       for p in f._pair):
            return LeafPlan(f, fld, [], "and", f._tokens(), pair=f._pair)
        literals = [t for t in f._substr_literals if ok(t)]
        return LeafPlan(f, fld, [ScanOp(t.encode(), K.MODE_SUBSTRING)
                                 for t in literals], "and", f._tokens(),
                        verify=not (f._pure and literals == [f.pattern]))
    spec = f.scan_spec()
    if spec is None or not (spec[0].isascii()
                            and len(spec[0]) <= K.MAX_PATTERN_LEN):
        return None
    return LeafPlan(f, fld, [ScanOp(*spec)], "and", f._tokens())


# ---------------- the planner ----------------

class _NoFuse(Exception):
    pass


class _Planner:
    """Walks the filter tree of one part, staging what it needs, and
    emits a program tuple plus the parallel list of device tensors."""

    def __init__(self, runner, part, bss, layout):
        self.runner = runner
        self.part = part
        self.bss = bss
        self.layout = layout
        self.args: list = []
        self.fields: dict[str, tuple] = {}
        self.has_maybe = False

    def arg(self, a) -> int:
        self.args.append(a)
        return len(self.args) - 1

    def field_slot(self, field: str):
        got = self.fields.get(field)
        if got is None:
            ff = self.runner.stage_fused_field(self.part, field,
                                               self.layout)
            if ff is None:
                raise _NoFuse(field)
            got = self.fields[field] = (
                ff, self.arg(ff.lanes), self.arg(ff.lengths),
                self.arg(ff.ovf) if ff.ovf is not None else -1)
        return got

    def plan(self, f):
        if isinstance(f, F.FilterAnd):
            return _combine("and", [self.plan(s) for s in f.filters])
        if isinstance(f, F.FilterOr):
            return _combine("or", [self.plan(s) for s in f.filters])
        if isinstance(f, F.FilterNot):
            inner = self.plan(f.inner)
            if inner in (("true",), ("false",)):
                return ("false",) if inner == ("true",) else ("true",)
            return ("not", inner)
        if isinstance(f, F.FilterNoop):
            return ("true",)
        if isinstance(f, F.FilterNone):
            return ("false",)
        if isinstance(f, F.FilterTime):
            return self._time_leaf(f)
        if isinstance(f, (F.FilterStream, F.FilterStreamID,
                          F.FilterValueType)):
            return self._block_uniform_leaf(f)
        if isinstance(f, F.FilterRange):
            return self._numrange_leaf(f)
        if isinstance(f, F.FilterIn):
            return self._in_leaf(f)
        if isinstance(f, F.FilterLenRange):
            return self._lenrange_leaf(f)
        return self._scan_leaf(f)

    def _time_leaf(self, f: F.FilterTime):
        if f.max_ts < self.part.min_ts or f.min_ts > self.part.max_ts:
            return ("false",)
        if f.min_ts <= self.part.min_ts and f.max_ts >= self.part.max_ts:
            return ("true",)
        ts = self.runner.stage_timestamps(self.part, self.layout)
        return ("time", self.arg(ts), f.min_ts, f.max_ts)

    def _block_uniform_leaf(self, f):
        """A per-block constant (`_stream:{...}`, `_stream_id:`,
        `value_type()`): uniform over the candidates -> a constant,
        mixed -> a row mask built from block ranges."""
        truths = {}
        for bi, bs in self.bss.items():
            if isinstance(f, F.FilterStream):
                ctx = bs.ctx
                truths[bi] = ctx is None or bs.stream_id in f.resolve(
                    ctx.partition, ctx.tenants)
            elif isinstance(f, F.FilterValueType):
                truths[bi] = f.matches(bs)
            else:
                truths[bi] = bs.stream_id.as_string() in f._set
        vals = set(truths.values())
        if vals == {True}:
            return ("true",)
        if vals == {False}:
            return ("false",)
        m = np.zeros(self.layout.nrows_padded, dtype=bool)
        for bi, t in truths.items():
            if t:
                s = self.layout.starts[bi]
                m[s:s + self.part.block_rows(bi)] = True
        return ("maskleaf", self.arg(self.runner.put(m)))

    def _numrange_leaf(self, f: F.FilterRange):
        """A range over an int column: its staged uint32 offsets from
        the part minimum against the bounds made integer (the ceil of
        the lower, the floor of the upper, an infinite bound saturating
        outward).  Declines unless every candidate block is int-typed
        and the column stages (range below 2**32, magnitudes the stats
        path accepts)."""
        fld = F.canonical_field(f.field)
        if math.isnan(f.min_value) or math.isnan(f.max_value):
            raise _NoFuse("numrange-nan")
        sn = self.runner.stage_numeric(self.part, fld, self.layout)
        if sn is None or any(bi not in sn.eligible for bi in self.bss):
            raise _NoFuse("numrange")
        lo = (-(1 << 62) if f.min_value < 0 else 1 << 62) \
            if math.isinf(f.min_value) else math.ceil(f.min_value)
        hi = (1 << 62 if f.max_value > 0 else -(1 << 62)) \
            if math.isinf(f.max_value) else math.floor(f.max_value)
        lo_off, hi_off = lo - sn.vmin, hi - sn.vmin
        if lo_off > hi_off or hi_off < 0 or lo_off >= 1 << 32:
            return ("false",)
        return ("numrange", self.arg(sn.values), max(0, lo_off),
                min(hi_off, (1 << 32) - 1))

    def _lenrange_leaf(self, f: F.FilterLenRange):
        """len_range(lo, hi) over the staged byte lengths, which equal
        code-point counts on ASCII rows.  A multibyte row (bytes >= 0x80)
        is a maybe row when its byte length lies in [lo, 4*hi]; a
        truncated row is a maybe row unless even W-1 bytes exceed
        4*hi."""
        if f.max_len < max(0, f.min_len):
            return ("false",)
        fld = F.canonical_field(f.field)
        if fld == "_time":
            raise _NoFuse("_time-as-string")
        ff, _ri, li, oi = self.field_slot(fld)
        mb = self.runner.stage_multibyte(self.part, fld, self.layout)
        mi = -1 if mb is None else self.arg(mb)
        imax = (1 << 31) - 1
        a = min(max(0, f.min_len), imax)
        b = min(f.max_len, imax)
        b4 = min(4 * f.max_len, imax)
        if ff.width - 1 > b4:
            oi = -1
        if mi >= 0 or oi >= 0:
            self.has_maybe = True
        return ("lenrange", li, oi, mi, a, b, b4)

    def _in_leaf(self, f: F.FilterIn):
        """`in(a, b, ...)`: an OR of exact scans over the staged column
        (dict, const and stream-tag blocks materialized), an empty value
        an `empty` node; at most 16 ASCII values."""
        if f.subquery is not None and not f.values:
            raise _NoFuse("in-subquery")
        if len(f.values) > 16:
            raise _NoFuse("in-cardinality")
        fld = F.canonical_field(f.field)
        if fld == "_time":
            raise _NoFuse("_time-as-string")
        ff, ri, li, oi = self.field_slot(fld)
        kids = []
        for v in f.values:
            if not v:
                kids.append(("empty", li))
                continue
            if not v.isascii() or len(v) > K.MAX_PATTERN_LEN:
                raise _NoFuse("in-value")
            if len(v) >= ff.width:
                kids.append(self._ovf_only(oi))
                continue
            if oi >= 0:
                self.has_maybe = True
            kids.append(("scan", ri, li, oi, -1, v.encode(), K.MODE_EXACT,
                         False, False, False))
        return _combine("or", kids)

    def _scan_leaf(self, f):
        plan = device_plan(f)
        if plan is None:
            raise _NoFuse(type(f).__name__)
        if plan.verify and not plan.ops:
            raise _NoFuse("regexp without a literal run")
        if plan.field == "_time":
            raise _NoFuse("_time-as-string")
        keep = hashes = None
        if plan.bloom_tokens:
            hashes = cached_token_hashes(plan.filter, plan.bloom_tokens)
            bis = list(self.bss)
            keep = bloom_keep_mask(self.part, plan.field, hashes, bis)
            if part_index(self.part) is not None:
                # the maplet, not a bloom plane, answered the probe
                self.runner.stats_counters["maplet_probes"] += 1
            if not keep.any():
                return ("false",)
        ff, ri, li, oi = self.field_slot(plan.field)
        if plan.pair is not None:
            a, b = plan.pair
            if max(len(a), len(b)) >= ff.width:
                return self._ovf_only(oi)
            self.has_maybe = True
            node = ("pair", ri, li, oi, a, b)
            gate = self._leaf_gate(plan, keep, hashes)
            if gate is None:
                return node
            return (("gpair" if gate[0] == "bloom" else "gpair_sb"),
                    *node[1:], *gate[1:])
        mi = -1
        if any(op.fold for op in plan.ops):
            mb = self.runner.stage_multibyte(self.part, plan.field,
                                             self.layout)
            if mb is not None:
                mi = self.arg(mb)
                self.has_maybe = True
        gate = self._leaf_gate(plan, keep, hashes)
        kids = []
        for op in plan.ops:
            if op.match_nonempty:
                kids.append(("nonempty", li))
                continue
            if op.match_empty:
                # a truncated row is longer than W-1 > 0: never empty
                kids.append(("empty", li))
                continue
            if len(op.pattern) >= ff.width:
                kids.append(self._ovf_only(oi))
                continue
            if oi >= 0:
                self.has_maybe = True
            node = ("scan", ri, li, oi, mi if op.fold else -1, op.pattern,
                    op.mode, op.starts_tok, op.ends_tok, op.fold)
            if gate is not None:
                # one gated scan rules the leaf's blocks out for all
                node = (("gscan" if gate[0] == "bloom" else "gscan_sb"),
                        *node[1:], *gate[1:])
                gate = None
            kids.append(node)
        res = _combine(plan.combine, kids)
        if not plan.verify or res == ("false",):
            return res
        self.has_maybe = True
        return ("verify", res)

    def _leaf_gate(self, plan: LeafPlan, keep, hashes):
        """The leaf's gate when its keep-mask keeps some of the candidate
        blocks but not all (the JAX planner's `_with_bloom`), else None:
        ("sb", plane, nsb, sbidx, mask, block starts) arg slots on a
        sealed part whose column has split-block filters (the JAX
        planner's `_bloom_sb_node`), else ("bloom", plane, nwords, idx,
        shift, block starts); None without a plane."""
        if keep is None or keep.all():
            return None
        fi = part_index(self.part)
        if fi is not None and fi.has_sb(plan.field):
            sp = self.runner.stage_sb_plane(self.part, plan.field)
            sbidx = self.runner.put(pad_sb_idx(
                fi.sb_probe_idx(plan.field, hashes), sp.bp))
            mask = self.runner.put(fi.sb_masks(hashes).view(np.int32))
            starts = self.runner.stage_block_starts(self.part, self.layout)
            return ("sb", self.arg(sp.plane), self.arg(sp.nsb),
                    self.arg(sbidx), self.arg(mask), self.arg(starts))
        plb = bloom_plane(self.part, plan.field)
        if plb is None:
            return None
        sp = self.runner.stage_bloom_plane(self.part, plan.field, plb)
        idx, shift = plb.block_probe_args(hashes)
        idx, shift = pad_probe_args(idx, shift, sp.bp)
        starts = self.runner.stage_block_starts(self.part, self.layout)
        return ("bloom", self.arg(sp.plane), self.arg(sp.nwords),
                self.arg(self.runner.put(idx)),
                self.arg(self.runner.put(shift)), self.arg(starts))

    def _ovf_only(self, oi: int):
        """Pattern wider than the staging: only truncated rows may
        match."""
        if oi < 0:
            return ("false",)
        self.has_maybe = True
        return ("ovfmaybe", oi)


def _combine(op, kids):
    flat = []
    for k in kids:
        if k == (("false",) if op == "and" else ("true",)):
            return k
        if k == (("true",) if op == "and" else ("false",)):
            continue
        flat.append(k)
    if not flat:
        return ("true",) if op == "and" else ("false",)
    return flat[0] if len(flat) == 1 else (op, tuple(flat))


_SIGN = -(1 << 31)     # the int32 sign bit


def eval_node(node, args, rlp: int, device):
    """(definite, maybe) bool[rlp] row masks; maybe None means none."""
    kind = node[0]
    if kind == "true":
        return torch.ones(rlp, dtype=torch.bool, device=device), None
    if kind == "false":
        return torch.zeros(rlp, dtype=torch.bool, device=device), None
    if kind == "maskleaf":
        return args[node[1]], None
    if kind == "nonempty":
        return args[node[1]] > 0, None
    if kind == "empty":
        return args[node[1]] == 0, None
    if kind == "numrange":
        # uint32 offsets held as int32 bits: flipping the sign bit of
        # both sides keeps unsigned order in a signed compare
        _, vi, lo, hi = node
        v = args[vi] ^ _SIGN
        return (v >= lo + _SIGN) & (v <= hi + _SIGN), None
    if kind == "lenrange":
        _, li, oi, mi, a, b, b4 = node
        lens = args[li]
        d = (lens >= a) & (lens <= b)
        may = None
        if mi >= 0:
            may = args[mi] & (lens >= a) & (lens <= b4)
        if oi >= 0:
            may = args[oi] if may is None else may | args[oi]
        if may is None:
            return d, None
        return d & ~may, may
    if kind == "ovfmaybe":
        return torch.zeros(rlp, dtype=torch.bool, device=device), \
            args[node[1]]
    if kind == "time":
        ts = args[node[1]]
        return (ts >= node[2]) & (ts <= node[3]), None
    if kind == "scan":
        _, ri, li, oi, mi, pat, mode, st, et, fold = node
        d = K.match_scan(args[ri], args[li], pat, mode, st, et, fold)
        may = None
        for i in (oi, mi):
            if i >= 0:
                may = args[i] if may is None else may | args[i]
        if may is None:
            return d, None
        return d & ~may, may
    if kind in ("gscan", "gscan_sb"):
        # the gate's slots: a BloomGate's (plane, nwords, idx, shift) or
        # an SbGate's (plane, nsb, sbidx, mask), then the block starts
        _, ri, li, oi, mi, pat, mode, st, et, fold, *g = node
        if kind == "gscan":
            scan, gate = K.match_scan_gated, BloomGate(*(args[i] for i in g))
        else:
            scan, gate = K.match_scan_gated_sb, SbGate(*(args[i] for i in g))
        d, may = scan(args[ri], args[li], pat, mode, st, et, fold, gate,
                      args[oi] if oi >= 0 else None)
        if mi < 0:
            return d, may
        mb = args[mi]
        return d & ~mb, mb if may is None else may | mb
    if kind == "pair":
        _, ri, li, oi, a, b = node
        return K.match_pair(args[ri], args[li], a, b,
                            args[oi] if oi >= 0 else None)
    if kind in ("gpair", "gpair_sb"):
        _, ri, li, oi, a, b, *g = node
        if kind == "gpair":
            pair, gate = K.match_pair_gated, BloomGate(*(args[i] for i in g))
        else:
            pair, gate = K.match_pair_gated_sb, SbGate(*(args[i] for i in g))
        return pair(args[ri], args[li], a, b, gate,
                    args[oi] if oi >= 0 else None)
    if kind == "verify":
        d, m = eval_node(node[1], args, rlp, device)
        return torch.zeros_like(d), d if m is None else d | m
    if kind == "not":
        d, m = eval_node(node[1], args, rlp, device)
        if m is None:
            return ~d, None
        return ~(d | m), m
    kids = [eval_node(k, args, rlp, device) for k in node[1]]
    d = kids[0][0]
    pos = d if kids[0][1] is None else d | kids[0][1]
    for kd, km in kids[1:]:
        kp = kd if km is None else kd | km
        if kind == "and":
            d, pos = d & kd, pos & kp
        else:
            d, pos = d | kd, pos | kp
    if all(km is None for _, km in kids):
        return d, None
    return d, pos & ~d


# ---------------- filter | sort-topk prefilter ----------------

TOPK_SCORE_MAX = (1 << 31) - 2     # the widest staged range a score holds


def topk_rows(d, m, values, k: int, desc: bool):
    """The rows of the definite mask `d` and the maybe mask `m` (None
    for none) at or above the k-th best score among the definite rows
    (gpu/sort_device.py).  `values` holds the sort field's staged int32
    offsets, all in [0, TOPK_SCORE_MAX]; ascending sorts score
    TOPK_SCORE_MAX - v.  Rows outside `d` score -1, so with fewer than k
    definite rows every row of `d` and `m` stays."""
    v = values if desc else TOPK_SCORE_MAX - values
    s = torch.where(d, v, -1)
    kv = torch.topk(s, k).values[k - 1]
    out_d = d & (s >= kv)
    if m is None:
        return out_d, None
    return out_d, m & (torch.where(m, v, -1) >= kv)


def topk_rows_packed(d, m, values, k: int, desc: bool, seg_ids, seg_map):
    """`topk_rows` of a packed unit: each member's own k-th best score.
    seg_map is int32[S, Lp] (gpu/stats_seg.build_seg_slot_map, Lp >= k):
    the members' rows gather into their own slot rows, padding slots
    score -1 as non-matches do, one `torch.topk` over the slot axis
    gives every member's threshold at once, and seg_ids (int32[RLp])
    scatters it back to the rows: each member keeps exactly the rows
    its own `topk_rows` keeps (the JAX package's packed
    `_topk_dispatch`)."""
    v = values if desc else TOPK_SCORE_MAX - values
    s = torch.where(d, v, -1)
    s2 = torch.where(seg_map >= 0, s[seg_map.clamp(min=0).long()], -1)
    thr = torch.topk(s2, k, dim=1).values[:, k - 1][seg_ids.long()]
    out_d = d & (s >= thr)
    if m is None:
        return out_d, None
    return out_d, m & (torch.where(m, v, -1) >= thr)


# ---------------- host residue: settle the maybe rows ----------------

def settle_maybe(f, bss, layout, d_np: np.ndarray, m_np) -> dict:
    """Per-block bitmaps: definite rows plus the maybe rows the filter's
    own host evaluation accepts."""
    out = {}
    for bi, bs in bss.items():
        start = layout.starts[bi]
        bm = d_np[start:start + bs.nrows].copy()
        if m_np is not None:
            sel = m_np[start:start + bs.nrows]
            if sel.any():
                vbm = sel.copy()
                f.apply_to_block(bs, vbm)
                bm |= vbm
        out[bi] = bm
    return out


def residue_partials(f, bss, spec, layout, m_np: np.ndarray,
                     part=None) -> list:
    """One partial per maybe row the filter accepts on the host, keyed
    exactly like the device cells: (key parts, 1, value stats, uniq
    values, quantile values) for stats spec `spec`
    (gpu/stats_device.py).  A "seg" key (a packed unit's member axis)
    is the member of the row's block in `part`, a PackedPart."""
    partials = []
    for bi, bs in bss.items():
        start = layout.starts[bi]
        sel = m_np[start:start + bs.nrows]
        if not sel.any():
            continue
        bm = sel.copy()
        f.apply_to_block(bs, bm)
        rows = np.nonzero(bm)[0]
        if not rows.size:
            continue
        ts = bs.timestamps()
        vals = bs.values
        for i in rows.tolist():
            key_parts = []
            for bk in spec.by:
                if bk.kind == "seg":
                    key_parts.append(("s", part.segment_of_block(bi)))
                elif bk.kind == "time":
                    t = int(ts[i])
                    key_parts.append(("t", (t - bk.offset) // bk.step
                                      * bk.step + bk.offset))
                elif bk.kind == "numbucket":
                    v = parse_number(vals(bk.name)[i])
                    key_parts.append(("v", format_number(
                        np.floor((v - bk.foff) / bk.fstep) * bk.fstep
                        + bk.foff)))
                else:
                    key_parts.append(("v", vals(bk.name)[i]))
            uniq = {fld: vals(fld)[i] for fld in spec.uniq_fields}
            qv = {fld: parse_number(vals(fld)[i])
                  for fld in spec.quantile_fields}
            fs = {}
            for fld in spec.value_fields:
                if fld.startswith(SYNTH_LEN):
                    v = len(vals(fld[len(SYNTH_LEN):])[i])
                elif fld.startswith(SYNTH_EMPTY):
                    v = 1 if vals(fld[len(SYNTH_EMPTY):])[i] == "" else 0
                else:
                    v = int(vals(fld)[i])
                fs[fld] = (v, v, v)
            partials.append((tuple(key_parts), 1, fs, uniq, qv))
    return partials
