"""TorchBatchRunner: the device side of the query executor.

The executor (engine/searcher.py) hands the runner one part's candidate
blocks at a time.  The runner stages the part's columns once (cached by
part uid under a device-byte budget), plans the filter tree into one
device program (gpu/fused.py), runs it, and either

- downloads the bit-packed (definite, maybe) row bitmaps of a row query
  (`run_part`), or
- for a `| stats` query whose shape has a device form
  (gpu/stats_device.py), reduces the definite rows per cell of the
  group-by, count_uniq and quantile axes: one count launch (kernel 2)
  without a value column, else one value-reduction call for all value
  columns, whose count rows are the count; only the per-cell results
  are downloaded (`run_part_stats`), or
- for a `sort by (field) limit N` query (gpu/sort_device.py), keeps
  only the matched rows at or above the part's k-th best sort key
  (`run_part_topk`, `topk_parts`) and downloads those.

Maybe rows (values truncated by the staging) are settled on the host
with the filter's own predicate.  Where the planner cannot express the
whole tree, the runner walks it leaf by leaf (`_LeafWalk`): AND and OR
stop early per block, as the host's do; each leaf the planner can
express runs on the card as a one-leaf program, only over the rows
whose answer is still open; any other leaf runs `apply_to_block` on the
host (`cpu_fallbacks` counts them).  A stats query's declined tree then
uploads the matched rows as one mask and reduces them with the same
count or value launch, unless fewer than `stats_host_threshold` rows
matched (the host pipe takes those).  Parts with a candidate block that
some axis or value column cannot stage run their filter on the card and
leave the stats to the host pipe.  Every result equals the host
executor's.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..logsql import filters as F
from ..storage.values_encoder import VT_DICT, VT_STRING
from .bloom_device import block_starts, stage_bloom_plane
from .fused import (TOPK_SCORE_MAX, _NoFuse, _Planner, eval_node,
                    part_layout, residue_partials, settle_maybe,
                    stage_layout_column, topk_rows)
from .kernels import combine_ids, packbits
from .layout import StagingCache, rows_with_multibyte
from .stats_device import (MAX_ABS_TIMES_ROWS, MAX_BUCKETS,
                           MAX_QUANTILE_RANGE, SYNTH_EMPTY, SYNTH_LEN,
                           StatsSpec, device_stats_spec)
from .stats_seg import split_values, stats_count_seg, stats_values
from .sort_device import SortSpec
from .stats_stage import (stage_dict_codes, stage_empty_column,
                          stage_len_column, stage_num_buckets,
                          stage_numeric, stage_time_buckets)


@dataclass
class _Staged:
    """A device tensor (or tensor tuple) plus host metadata."""
    value: object
    meta: object
    nbytes: int

    def device_bytes(self) -> int:
        return self.nbytes


_UNSTAGEABLE = _Staged(None, None, 4096)


def _drop_staged(cache_ref, uid) -> None:
    cache = cache_ref()
    if cache is not None:
        cache.drop_part(uid)


def multibyte_rows(part, field: str, layout) -> np.ndarray:
    """bool[RLp]: the rows whose `field` value holds a byte >= 0x80, over
    every block of the part in layout coordinates (string, dict and
    const blocks, `_stream` and `_stream_id`; a numeric block's values
    are ASCII)."""
    virtual = field in ("_stream", "_stream_id")
    mb = np.zeros(layout.nrows_padded, dtype=bool)

    def high(v: str) -> bool:
        return max(v.encode("utf-8", "replace"), default=0) >= 0x80

    for bi in range(part.num_blocks):
        start, n = layout.starts[bi], part.block_rows(bi)
        if virtual:
            v = part.block_tags(bi) if field == "_stream" else \
                part.block_stream_id(bi).as_string()
            mb[start:start + n] = high(v)
            continue
        meta = part.block_column_meta(bi, field)
        if meta is None:
            mb[start:start + n] = high(dict(part.block_consts(bi))
                                       .get(field, ""))
            continue
        if meta["t"] == VT_STRING:
            col = part.block_column(bi, field)
            mb[start:start + n] = rows_with_multibyte(
                col.arena, col.offsets, col.lengths)
        elif meta["t"] == VT_DICT:
            col = part.block_column(bi, field)
            flags = np.array([high(v) for v in col.dict_values], dtype=bool)
            if flags.any():
                mb[start:start + n] = flags[col.ids]
    return mb


@dataclass
class AxesAssembly:
    """What one part's stats launch reads: value columns, and the axes
    (kind, ids, size, payload) whose row-major product is the cells.
    Kinds: "t" time buckets (payload (base, step)), "v" group-by keys
    (payload (field or None when bucketed, values)), "u" count_uniq
    values (payload (field, values)), "q" quantile numbers (payload
    (field, vmin))."""
    numerics: dict                 # value field -> StagedNumeric
    axes: list
    eligibility: list              # frozensets of eligible block idxs
    strides: tuple
    nb: int
    uniq_shared: list              # (field, axis idx): a by-field's axis


class TorchBatchRunner:
    # below this many matched rows a declined tree's stats go to the
    # host pipe instead of a mask upload and a launch
    stats_host_threshold = 1024

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.cache = StagingCache()
        self.stats_counters = {"device_parts": 0, "device_rows": 0,
                               "host_parts": 0, "maybe_rows": 0,
                               "cpu_fallbacks": 0, "topk_parts": 0,
                               "topk_declines": 0, "topk_rows": 0}

    def close(self) -> None:
        self.cache.clear()

    # ---- staging (cached per part uid) ----

    def put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _cached(self, key, build):
        got = self.cache.get(key)
        if got is None:
            got = build()
            self.cache.put(key, got)
        return got

    def layout(self, part):
        """The part's layout; every staging of a part asks for it first,
        so its first build ties the part's entries to the part's life:
        once a flush drops an in-memory part, its tensors go too."""
        key = (part.uid, "layout")
        got = self.cache.get(key)
        if got is None:
            got = part_layout(part)
            self.cache.put(key, got)
            weakref.finalize(part, _drop_staged, weakref.ref(self.cache),
                             part.uid)
        return got

    def stage_fused_field(self, part, field: str, layout):
        return self._stage((part.uid, "field", field), lambda:
                           stage_layout_column(part, field, layout,
                                               self.device))

    def stage_timestamps(self, part, layout) -> torch.Tensor:
        def build():
            ts = np.zeros(layout.nrows_padded, dtype=np.int64)
            for bi in range(part.num_blocks):
                t = part.block_timestamps(bi)
                ts[layout.starts[bi]:layout.starts[bi] + t.shape[0]] = t
            return _Staged(self.put(ts), None, ts.nbytes)
        return self._cached((part.uid, "ts"), build).value

    def stage_bloom_plane(self, part, field: str, plb):
        return self._cached((part.uid, "bloom", field),
                            lambda: stage_bloom_plane(plb, self.device))

    def stage_multibyte(self, part, field: str, layout):
        """bool[RLp] rows of `field` holding a byte >= 0x80 (the maybe
        rows of an any-case scan), or None when no row does."""
        def build():
            mb = multibyte_rows(part, field, layout)
            if not mb.any():
                return _Staged(None, None, 64)
            return _Staged(self.put(mb), None, mb.nbytes)
        return self._cached((part.uid, "multibyte", field), build).value

    def stage_block_starts(self, part, layout) -> torch.Tensor:
        """int32[B+1] block starts: the gated kernels' row -> block map."""
        return self._cached(
            (part.uid, "starts"),
            lambda: _Staged(self.put(block_starts(part, layout)), None,
                            4 * (part.num_blocks + 1))).value

    def _stage(self, key, build):
        """A cached staging result, or None where `build` returned None
        (remembered too)."""
        got = self._cached(key, lambda: build() or _UNSTAGEABLE)
        return None if got is _UNSTAGEABLE else got

    def stage_numeric(self, part, field: str, layout):
        """A value column, or a SYNTH_LEN/SYNTH_EMPTY derived one."""
        def build():
            if field.startswith(SYNTH_LEN):
                return stage_len_column(part, field[len(SYNTH_LEN):],
                                        layout, MAX_ABS_TIMES_ROWS, self.put)
            if field.startswith(SYNTH_EMPTY):
                return stage_empty_column(part, field[len(SYNTH_EMPTY):],
                                          layout, self.put)
            return stage_numeric(part, field, layout, MAX_ABS_TIMES_ROWS,
                                 self.put)
        return self._stage((part.uid, "num", field), build)

    def stage_dict(self, part, field: str, layout):
        return self._stage((part.uid, "dict", field), lambda:
                           stage_dict_codes(part, field, layout, self.put))

    def _assemble_axes(self, part, spec: StatsSpec):
        """Stage the value columns and axes of one part's stats launch;
        None when one cannot be staged or the cells exceed
        MAX_BUCKETS."""
        layout = self.layout(part)
        numerics = {}
        for fld in spec.value_fields:
            sn = self.stage_numeric(part, fld, layout)
            if sn is None:
                return None
            numerics[fld] = sn
        axes = []
        eligibility = [sn.eligible for sn in numerics.values()]
        for bk in spec.by:
            if bk.kind == "time":
                sb = self._stage(
                    (part.uid, "tb", bk.step, bk.offset),
                    lambda: stage_time_buckets(part, layout, bk.step,
                                               bk.offset, MAX_BUCKETS,
                                               self.put))
                if sb is None:
                    return None
                axes.append(("t", sb.ids, sb.num_buckets,
                             (sb.base, bk.step)))
                eligibility.append(sb.eligible)
                continue
            if bk.kind == "numbucket":
                sd = self._stage(
                    (part.uid, "nb", bk.name, bk.fstep, bk.foff),
                    lambda: stage_num_buckets(part, bk.name, layout,
                                              bk.fstep, bk.foff, self.put))
                name = None     # a uniq axis never shares a bucketed one
            else:
                sd = self.stage_dict(part, bk.name, layout)
                name = bk.name
            if sd is None:
                return None
            axes.append(("v", sd.ids, len(sd.values), (name, sd.values)))
            eligibility.append(sd.eligible)
        uniq_shared = []
        for fld in spec.uniq_fields:
            shared = next((i for i, (k, _i, _s, p) in enumerate(axes)
                           if k == "v" and p[0] == fld), None)
            if shared is not None:
                # grouped and counted: the group axis already enumerates
                # the values
                uniq_shared.append((fld, shared))
                continue
            sd = self.stage_dict(part, fld, layout)
            if sd is None:
                return None
            axes.append(("u", sd.ids, len(sd.values), (fld, sd.values)))
            eligibility.append(sd.eligible)
        for fld in spec.quantile_fields:
            # the value staging doubles as the histogram axis
            sn = self.stage_numeric(part, fld, layout)
            if sn is None or sn.vmax - sn.vmin + 1 > MAX_QUANTILE_RANGE:
                return None
            axes.append(("q", sn.values, sn.vmax - sn.vmin + 1,
                         (fld, sn.vmin)))
            eligibility.append(sn.eligible)
        nb = int(np.prod([a[2] for a in axes])) if axes else 1
        if nb > MAX_BUCKETS:
            return None
        strides = []
        s = 1
        for _k, _i, size, _p in reversed(axes):
            strides.append(s)
            s *= size
        return AxesAssembly(numerics=numerics, axes=axes,
                            eligibility=eligibility,
                            strides=tuple(reversed(strides)), nb=nb,
                            uniq_shared=uniq_shared)

    @staticmethod
    def _key_parts(asm: AxesAssembly, idx: int) -> tuple:
        """(group-key parts, uniq values, quantile numbers) of cell
        `idx`."""
        ks = [(idx // stride) % size
              for (_k, _i, size, _p), stride in zip(asm.axes, asm.strides)]
        out = []
        uniq = {}
        qv = {}
        for (kind, _ids, _size, payload), k in zip(asm.axes, ks):
            if kind == "t":
                base, step = payload
                out.append(("t", base + k * step))
            elif kind == "v":
                out.append(("v", payload[1][k]))
            elif kind == "q":
                qv[payload[0]] = payload[1] + k
            else:
                uniq[payload[0]] = payload[1][k]
        for fld, ai in asm.uniq_shared:
            uniq[fld] = asm.axes[ai][3][1][ks[ai]]
        return tuple(out), uniq, qv

    def _partials(self, asm: AxesAssembly, counts, stats_np: dict) -> list:
        """(key parts, count, value stats, uniq values, quantile numbers)
        of every nonempty cell; value stats are (sum, min, max) of the
        stored values (the staged offsets plus vmin)."""
        partials = []
        for idx in np.nonzero(counts)[0].tolist():
            cnt = int(counts[idx])
            fs = {}
            for fld, (sums, mn, mx) in stats_np.items():
                vmin = asm.numerics[fld].vmin
                fs[fld] = (int(sums[idx]) + cnt * vmin,
                           (int(mn[idx]) & 0xFFFFFFFF) + vmin,
                           (int(mx[idx]) & 0xFFFFFFFF) + vmin)
            kp, uniq, qv = self._key_parts(asm, idx)
            partials.append((kp, cnt, fs, uniq, qv))
        return partials

    # ---- query seams ----

    @staticmethod
    def stats_spec(q) -> StatsSpec | None:
        """The device stats shape of a query, or None (row queries and
        stats the card cannot reduce)."""
        return device_stats_spec(q)

    def _rows_mask(self, part, layout, blocks: dict):
        """bool[RLp] on the card: the rows of `blocks` (block idx -> a
        bool row mask, or None for all its rows)."""
        if len(blocks) == part.num_blocks and \
                all(m is None or m.all() for m in blocks.values()):
            return torch.arange(layout.nrows_padded,
                                device=self.device) < layout.nrows
        m = np.zeros(layout.nrows_padded, dtype=bool)
        for bi, rows in blocks.items():
            s = layout.starts[bi]
            m[s:s + part.block_rows(bi)] = True if rows is None else rows
        return self.put(m)

    def _program(self, f, part, bss):
        """(tree, args, layout, has_maybe, cand) or None when the planner
        declines the tree."""
        layout = self.layout(part)
        planner = _Planner(self, part, bss, layout)
        try:
            tree = planner.plan(f)
        except _NoFuse:
            return None
        cand = self._rows_mask(part, layout, dict.fromkeys(bss))
        return tree, planner.args, layout, planner.has_maybe, cand

    def _count_device_part(self, layout) -> None:
        self.stats_counters["device_parts"] += 1
        self.stats_counters["device_rows"] += layout.nrows

    def _download(self, d, m, cand, has_maybe: bool, rlp: int):
        """Host copies of the definite and maybe rows among `cand`
        (maybe None when there are none)."""
        packed = [packbits(d & cand)]
        if has_maybe and m is not None:
            packed.append(packbits(m & cand))
        host = torch.stack(packed).cpu().numpy()
        d_np = np.unpackbits(host[0])[:rlp].astype(bool)
        m_np = np.unpackbits(host[1])[:rlp].astype(bool) \
            if len(packed) > 1 else None
        if m_np is not None:
            self.stats_counters["maybe_rows"] += int(m_np.sum())
        return d_np, m_np

    def run_part(self, f, part, bss: dict) -> dict:
        """block_idx -> bool bitmap of the filter over the candidate
        blocks, bit-identical to the host executor."""
        prog = self._program(f, part, bss)
        if prog is None:
            bms, on_card = self._run_leaves(f, part, bss)
            if on_card:
                self._count_device_part(self.layout(part))
            else:
                self.stats_counters["host_parts"] += 1
            return bms
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(layout)
        if tree in (("true",), ("false",)):
            return {bi: np.full(bs.nrows, tree == ("true",))
                    for bi, bs in bss.items()}
        d, m = eval_node(tree, args, layout.nrows_padded, self.device)
        d_np, m_np = self._download(d, m, cand, has_maybe,
                                    layout.nrows_padded)
        return settle_maybe(f, bss, layout, d_np, m_np)

    def run_part_topk(self, f, part, bss: dict, spec: SortSpec):
        """block_idx -> bitmap of the filter's rows at or above the
        part's k-th best `spec.field` key, maybe rows settled on the
        host (a superset of the part's rows in the query's top k), or
        None where the part declines: a candidate block whose sort field
        is not int-typed, a staged range over TOPK_SCORE_MAX, or a tree
        the planner cannot express (`topk_declines`).  `topk_rows`
        counts the rows it downloads."""
        layout = self.layout(part)
        sn = self.stage_numeric(part, spec.field, layout)
        if sn is None or any(bi not in sn.eligible for bi in bss) or \
                sn.vmax - sn.vmin > TOPK_SCORE_MAX:
            self.stats_counters["topk_declines"] += 1
            return None
        prog = self._program(f, part, bss)
        if prog is None:
            self.stats_counters["topk_declines"] += 1
            return None
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(layout)
        self.stats_counters["topk_parts"] += 1
        if tree == ("false",):
            return {bi: np.zeros(bs.nrows, dtype=bool)
                    for bi, bs in bss.items()}
        rlp = layout.nrows_padded
        d, m = eval_node(tree, args, rlp, self.device)
        m = m & cand if has_maybe and m is not None else None
        d, m = topk_rows(d & cand, m, sn.values, min(spec.k, rlp),
                         spec.desc)
        d_np, m_np = self._download(d, m, cand, m is not None, rlp)
        self.stats_counters["topk_rows"] += int(d_np.sum()) + (
            0 if m_np is None else int(m_np.sum()))
        return settle_maybe(f, bss, layout, d_np, m_np)

    # ---- the per-leaf path of a tree the planner declines ----

    def _run_leaves(self, f, part, bss: dict):
        """(block idx -> bitmap, whether a leaf ran on the card)."""
        walk = _LeafWalk(self, part, bss)
        care = {bi: np.ones(bs.nrows, dtype=bool) for bi, bs in bss.items()}
        return walk.eval(f, care), walk.on_card

    # ---- stats ----

    def _reduce(self, asm: AxesAssembly, spec: StatsSpec, mask) -> list:
        """Partials of the rows of `mask` (bool[RLp] on the card): one
        count launch, or one value-reduction call for all value
        columns."""
        rlp = mask.shape[0]
        if asm.axes:
            ids = combine_ids([a[1] for a in asm.axes], asm.strides)
        else:
            ids = torch.zeros(rlp, dtype=torch.int32, device=self.device)
        stats_np = {}
        if spec.value_fields:
            packed = stats_values(
                [asm.numerics[fld].values for fld in spec.value_fields],
                ids, mask, asm.nb).cpu()
            for fld, row in zip(spec.value_fields, packed):
                cnt, sums, mn, mx = split_values(row, asm.nb)
                counts = cnt.numpy()
                stats_np[fld] = (sums.numpy(), mn.numpy(), mx.numpy())
        else:
            counts = stats_count_seg(None, ids, mask, 1, asm.nb).cpu() \
                .numpy()
        return self._partials(asm, counts, stats_np)

    def run_part_stats(self, f, part, bss: dict, spec: StatsSpec):
        """(bitmaps, handled, partials): the filter and the stats of one
        part on the card.  Partials, for the handled blocks, are (key
        parts, count, value stats, uniq values, quantile numbers) as
        `_partials` and fused.residue_partials build them; bitmaps
        cover the rest."""
        asm = self._assemble_axes(part, spec)
        if asm is None or any(bi not in el for el in asm.eligibility
                              for bi in bss):
            return self.run_part(f, part, bss), set(), []
        prog = self._program(f, part, bss)
        if prog is None:
            return self._run_part_stats_unfused(f, part, bss, spec, asm)
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(layout)
        handled = set(bss)
        if tree == ("false",):
            return {}, handled, []
        rlp = layout.nrows_padded
        d, m = eval_node(tree, args, rlp, self.device)
        partials = self._reduce(asm, spec, d & cand)
        if has_maybe and m is not None:
            m_np = np.unpackbits(packbits(m & cand).cpu().numpy())[:rlp] \
                .astype(bool)
            self.stats_counters["maybe_rows"] += int(m_np.sum())
            partials.extend(residue_partials(f, bss, spec, layout, m_np))
        return {}, handled, partials

    def _run_part_stats_unfused(self, f, part, bss: dict,
                                spec: StatsSpec, asm: AxesAssembly):
        """A declined tree's stats: the per-leaf bitmaps uploaded as one
        row mask, reduced by the same launch as the fused path; under
        `stats_host_threshold` matched rows the host pipe takes them."""
        bms, on_card = self._run_leaves(f, part, bss)
        layout = self.layout(part)
        handled = {bi for bi in bss
                   if all(bi in el for el in asm.eligibility)}
        mask = np.zeros(layout.nrows_padded, dtype=bool)
        matched = 0
        for bi in handled:
            bm = bms[bi]
            if bm.any():
                start = layout.starts[bi]
                mask[start:start + bm.shape[0]] = bm
                matched += int(bm.sum())
        partials = []
        if matched < self.stats_host_threshold:
            if matched:
                handled = set()
        else:
            on_card = True
            partials = self._reduce(asm, spec, self.put(mask))
        if on_card:
            self._count_device_part(layout)
        else:
            self.stats_counters["host_parts"] += 1
        return bms, handled, partials


class _LeafWalk:
    """One part's filter tree walked leaf by leaf.  `eval(f, care)`
    returns, per block of `care` (block idx -> bool rows whose answer is
    still open), the filter's bitmap, exact on those rows and False
    elsewhere: AND narrows the open rows to those still true, OR to
    those not yet true, and a block leaves the walk once none are open."""

    def __init__(self, runner: TorchBatchRunner, part, bss: dict):
        self.runner = runner
        self.part = part
        self.bss = bss
        self.layout = runner.layout(part)
        self.on_card = False

    def eval(self, f, care: dict) -> dict:
        if isinstance(f, F.FilterAnd):
            acc = {bi: c.copy() for bi, c in care.items()}
            live = [bi for bi in acc if acc[bi].any()]
            for sub in f.filters:
                if not live:
                    break
                got = self.eval(sub, {bi: acc[bi] for bi in live})
                for bi in live:
                    acc[bi] &= got[bi]
                live = [bi for bi in live if acc[bi].any()]
            return acc
        if isinstance(f, F.FilterOr):
            acc = {bi: np.zeros_like(c) for bi, c in care.items()}
            open_ = {bi: c for bi, c in care.items() if c.any()}
            for sub in f.filters:
                if not open_:
                    break
                got = self.eval(sub, open_)
                for bi, c in open_.items():
                    acc[bi] |= got[bi]
                open_ = {bi: care[bi] & ~acc[bi] for bi in open_}
                open_ = {bi: c for bi, c in open_.items() if c.any()}
            return acc
        if isinstance(f, F.FilterNot):
            inner = self.eval(f.inner, care)
            return {bi: c & ~inner[bi] for bi, c in care.items()}
        return self._leaf(f, care)

    def _leaf(self, f, care: dict) -> dict:
        r = self.runner
        bss = {bi: self.bss[bi] for bi in care}
        planner = _Planner(r, self.part, bss, self.layout)
        try:
            tree = planner.plan(f)
        except _NoFuse:
            r.stats_counters["cpu_fallbacks"] += 1
            out = {}
            for bi, c in care.items():
                bm = c.copy()
                if bm.any():
                    f.apply_to_block(bss[bi], bm)
                out[bi] = bm
            return out
        self.on_card = True
        if tree in (("true",), ("false",)):
            return {bi: c & (tree == ("true",)) for bi, c in care.items()}
        rlp = self.layout.nrows_padded
        d, m = eval_node(tree, planner.args, rlp, r.device)
        cand = r._rows_mask(self.part, self.layout, care)
        d_np, m_np = r._download(d, m, cand, planner.has_maybe, rlp)
        out = settle_maybe(f, bss, self.layout, d_np, m_np)
        return {bi: bm & care[bi] for bi, bm in out.items()}
