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

Each of the three has a submit form (`run_part_submit`,
`run_part_stats_submit`, `run_part_topk_submit`) that launches and
returns a handle without waiting: its results go to the host as a
non-blocking copy into pinned memory followed by a CUDA event
(`Download`), and `harvest()` waits on the event, unpacks and settles;
the dispatch window (gpu/pipeline.py) keeps several handles in flight.
The part may be a pack of small parts (pipeline.PackedPart, made by
`get_pack`): one program over the members' concatenated rows, stats
with a leading member axis, a top-k per member.

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
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..logsql import filters as F
from ..storage.filterindex import sb_plane_for_staging
from ..storage.values_encoder import VT_DICT, VT_STRING
from .bloom_device import block_starts, stage_bloom_plane, stage_sb_plane
from .fused import (TOPK_SCORE_MAX, _NoFuse, _Planner, device_plan,
                    eval_node, part_layout, residue_partials, settle_maybe,
                    stage_layout_column, topk_rows, topk_rows_packed)
from .kernels import combine_ids, packbits
from .layout import StagingCache, rows_with_multibyte
from .stats_device import (MAX_ABS_TIMES_ROWS, MAX_BUCKETS,
                           MAX_QUANTILE_RANGE, SYNTH_EMPTY, SYNTH_LEN,
                           StatsSpec, device_stats_spec)
from .stats_seg import (build_seg_slot_map, split_values, stats_count_seg,
                        stats_values)
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


def _drop_pack(runner_ref, key) -> None:
    runner = runner_ref()
    if runner is not None:
        runner._packs.pop(key, None)
        runner._pack_ties.discard(key)
        runner.cache.drop_part(("pack",) + key)


class Ready:
    """A unit result made at submit (a constant tree, a walk on the
    host): nothing in flight."""

    def __init__(self, value):
        self.value = value

    def harvest(self, sync=None):
        return self.value

    def release(self) -> None:
        pass


class Download:
    """Device tensors on their way to the host.  On the card: a
    non-blocking copy of each into pinned memory, then a CUDA event on
    the current stream; `harvest` waits on the event (through `sync`
    when given) and hands the numpy arrays to `finish`.  On the CPU the
    tensors are the host arrays, and nothing is in flight."""

    def __init__(self, tensors: list, finish):
        self.finish = finish
        self.event = None
        if tensors[0].device.type == "cpu":
            self.host = tensors
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def harvest(self, sync=None):
        if self.event is not None:
            (sync or torch.cuda.Event.synchronize)(self.event)
        return self.finish([h.numpy() for h in self.host])

    def release(self) -> None:
        """A handle dropped unharvested: its pinned buffers must outlive
        its copies."""
        if self.event is not None:
            self.event.synchronize()


class _Then:
    """A pending result passed through `fn` at harvest."""

    def __init__(self, pending, fn):
        self.pending = pending
        self.fn = fn

    def harvest(self, sync=None):
        return self.fn(self.pending.harvest(sync))

    def release(self) -> None:
        self.pending.release()


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
    Kinds: "s" the members of a packed unit (always first, payload
    None), "t" time buckets (payload (base, step)), "v" group-by keys
    (payload (field or None when bucketed, values)), "u" count_uniq
    values (payload (field, values)), "q" quantile numbers (payload
    (field, vmin))."""
    numerics: dict                 # value field -> StagedNumeric
    axes: list
    eligibility: list              # frozensets of eligible block idxs
    strides: tuple
    nb: int
    uniq_shared: list              # (field, axis idx): a by-field's axis
    nseg: int = 0                  # a packed unit's members ("s" axis)


# packs a runner keeps (their members held weakly): enough for the hot
# packs' bloom planes to stay built across queries
PACK_CACHE_MAX = 32


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
                               "topk_declines": 0, "topk_rows": 0,
                               "units": 0, "packed_units": 0,
                               "packed_parts": 0, "inflight_hwm": 0,
                               "result_cache_units": 0,
                               "agg_pruned_parts": 0, "maplet_probes": 0,
                               "maplet_pruned_blocks": 0}
        self._packs: OrderedDict = OrderedDict()
        self._pack_ties: set = set()

    def close(self) -> None:
        self.cache.clear()
        self._packs.clear()

    def get_pack(self, members: list):
        """The PackedPart of `members`, kept while each member lives:
        the first member finalized (a flush dropping an in-memory part)
        drops the pack and its staged tensors."""
        from .pipeline import PackedPart
        key = tuple(p.uid for p in members)
        got = self._packs.get(key)
        if got is None:
            got = self._packs[key] = PackedPart(members)
        self._packs.move_to_end(key)
        while len(self._packs) > PACK_CACHE_MAX:
            self._packs.popitem(last=False)
        if key not in self._pack_ties:
            self._pack_ties.add(key)
            for p in members:
                weakref.finalize(p, _drop_pack, weakref.ref(self), key)
        return got

    # ---- staging (cached per part uid) ----

    def put(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self.device)

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

    def stage_sb_plane(self, part, field: str):
        """The sealed part column's split-block plane on the device,
        staged once (the part's filter index has one for the column)."""
        def build():
            plane, nsb = sb_plane_for_staging(part, field)
            return stage_sb_plane(plane, nsb, self.device)
        return self._cached((part.uid, "sb", field), build)

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

    def stage_segments(self, part, layout) -> torch.Tensor:
        """int32[RLp] member ids of a packed part's rows."""
        def build():
            ids = np.zeros(layout.nrows_padded, dtype=np.int32)
            for bi in range(part.num_blocks):
                start = layout.starts[bi]
                ids[start:start + part.block_rows(bi)] = \
                    part.segment_of_block(bi)
            return _Staged(self.put(ids), None, ids.nbytes)
        return self._cached((part.uid, "seg"), build).value

    def stage_seg_slots(self, part, layout, k: int) -> torch.Tensor:
        """int32[S, Lp] slot grid of a packed part, Lp >= k."""
        def build():
            idx = build_seg_slot_map(part, layout, k)
            return _Staged(self.put(idx), None, idx.nbytes)
        return self._cached((part.uid, "segslots", k), build).value

    def prefetch(self, part, f, spec, sort_spec) -> None:
        """Stage what a unit's submit will read (its layout, the columns
        of the filter's scan leaves, its stats axes or sort column), so
        that the host work and the uploads of a unit in the window's
        lookahead overlap the units already on the card."""
        layout = self.layout(part)
        for fld in _scan_fields(f, set()):
            self.stage_fused_field(part, fld, layout)
        if spec is not None:
            self._assemble_axes(part, spec)
        if sort_spec is not None:
            self.stage_numeric(part, sort_spec.field, layout)

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
        nseg = 0
        for bk in spec.by:
            if bk.kind == "seg":
                # the pack's block -> member map as per-row ids
                nseg = part.num_segments
                axes.append(("s", self.stage_segments(part, layout), nseg,
                             None))
                continue
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
        # the member axis does not count toward the cap: a pack reduces
        # at most VL_PACK_PARTS * MAX_BUCKETS cells
        if nb // max(nseg, 1) > MAX_BUCKETS:
            return None
        strides = []
        s = 1
        for _k, _i, size, _p in reversed(axes):
            strides.append(s)
            s *= size
        return AxesAssembly(numerics=numerics, axes=axes,
                            eligibility=eligibility,
                            strides=tuple(reversed(strides)), nb=nb,
                            uniq_shared=uniq_shared, nseg=nseg)

    @staticmethod
    def _partials(asm: AxesAssembly, counts, stats_np: dict) -> list:
        """(key parts, count, value stats, uniq values, quantile numbers)
        of every nonempty cell; value stats are (sum, min, max) of the
        stored values (the staged offsets plus vmin).  Each axis's value
        of every nonempty cell is decoded at once: a pack's cells are
        many, and a cell at a time costs ~10 us of Python."""
        idxs = np.nonzero(counts)[0]
        cnts = counts[idxs].tolist()
        vals = []             # per axis: its value in each nonempty cell
        for (kind, _ids, size, payload), stride in zip(asm.axes,
                                                        asm.strides):
            ks = (idxs // stride % size).tolist()
            if kind == "s":
                vals.append(ks)
            elif kind == "t":
                base, step = payload
                vals.append([base + k * step for k in ks])
            elif kind == "q":
                vals.append([payload[1] + k for k in ks])
            else:
                table = payload[1]
                vals.append([table[k] for k in ks])
        keyed = [(kind, vals[ai])
                 for ai, (kind, _i, _s, _p) in enumerate(asm.axes)
                 if kind in ("s", "t", "v")]
        uniq_axes = [(p[0], vals[ai]) for ai, (kind, _i, _s, p)
                     in enumerate(asm.axes) if kind == "u"] + \
            [(fld, vals[ai]) for fld, ai in asm.uniq_shared]
        q_axes = [(p[0], vals[ai]) for ai, (kind, _i, _s, p)
                  in enumerate(asm.axes) if kind == "q"]
        fields = [(fld, asm.numerics[fld].vmin, sums[idxs].tolist(),
                   mn[idxs].tolist(), mx[idxs].tolist())
                  for fld, (sums, mn, mx) in stats_np.items()]
        partials = []
        for j, cnt in enumerate(cnts):
            fs = {fld: (su[j] + cnt * vmin, (lo[j] & 0xFFFFFFFF) + vmin,
                        (hi[j] & 0xFFFFFFFF) + vmin)
                  for fld, vmin, su, lo, hi in fields}
            partials.append((tuple((kind, v[j]) for kind, v in keyed), cnt,
                             fs, {fld: v[j] for fld, v in uniq_axes},
                             {fld: v[j] for fld, v in q_axes}))
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

    def _count_device_part(self, part, layout) -> None:
        self.stats_counters["device_parts"] += \
            getattr(part, "num_segments", 0) or 1
        self.stats_counters["device_rows"] += layout.nrows

    def _unpack(self, host: list, rlp: int):
        """(definite, maybe or None) bool rows from downloaded packed
        bitmaps."""
        d_np = np.unpackbits(host[0][0])[:rlp].astype(bool)
        m_np = None
        if host[0].shape[0] > 1:
            m_np = np.unpackbits(host[0][1])[:rlp].astype(bool)
            self.stats_counters["maybe_rows"] += int(m_np.sum())
        return d_np, m_np

    def _rows_download(self, d, m, cand, has_maybe: bool, rlp: int,
                       finish) -> Download:
        """The definite and maybe rows among `cand`, bit-packed, on
        their way to the host; `finish(d_np, m_np)` at harvest."""
        packed = [packbits(d & cand)]
        if has_maybe and m is not None:
            packed.append(packbits(m & cand))
        return Download([torch.stack(packed)],
                        lambda host: finish(*self._unpack(host, rlp)))

    def _download(self, d, m, cand, has_maybe: bool, rlp: int):
        """Host copies of the definite and maybe rows among `cand`
        (maybe None when there are none), waited for now."""
        return self._rows_download(d, m, cand, has_maybe, rlp,
                                   lambda d_np, m_np: (d_np, m_np)).harvest()

    def run_part_submit(self, f, part, bss: dict):
        """Plan the filter over the candidate blocks, launch it and
        start the download of its bitmaps; the handle's harvest() gives
        block_idx -> bool bitmap, bit-identical to the host executor.
        A tree the planner declines walks leaf by leaf now (Ready), or,
        over a packed part, gives None: the pack runs member by member."""
        prog = self._program(f, part, bss)
        if prog is None:
            if getattr(part, "num_segments", 0):
                return None
            bms, on_card = self._run_leaves(f, part, bss)
            if on_card:
                self._count_device_part(part, self.layout(part))
            else:
                self.stats_counters["host_parts"] += 1
            return Ready(bms)
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(part, layout)
        if tree in (("true",), ("false",)):
            return Ready({bi: np.full(bs.nrows, tree == ("true",))
                          for bi, bs in bss.items()})
        d, m = eval_node(tree, args, layout.nrows_padded, self.device)
        return self._rows_download(
            d, m, cand, has_maybe, layout.nrows_padded,
            lambda d_np, m_np: settle_maybe(f, bss, layout, d_np, m_np))

    def run_part(self, f, part, bss: dict) -> dict:
        """block_idx -> bool bitmap of the filter over the candidate
        blocks, bit-identical to the host executor."""
        return self.run_part_submit(f, part, bss).harvest()

    def run_part_topk_submit(self, f, part, bss: dict, spec: SortSpec):
        """The submit form of `run_part_topk`: a handle, or None where
        the part declines.  Over a packed part each member keeps the
        rows at or above its own k-th best key (topk_rows_packed), as
        its own run would; a declined pack runs member by member."""
        packed = getattr(part, "num_segments", 0)
        layout = self.layout(part)
        sn = self.stage_numeric(part, spec.field, layout)
        prog = None
        if sn is not None and all(bi in sn.eligible for bi in bss) and \
                sn.vmax - sn.vmin <= TOPK_SCORE_MAX:
            prog = self._program(f, part, bss)
        if prog is None:
            if not packed:
                self.stats_counters["topk_declines"] += 1
            return None
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(part, layout)
        self.stats_counters["topk_parts"] += packed or 1
        if tree == ("false",):
            return Ready({bi: np.zeros(bs.nrows, dtype=bool)
                          for bi, bs in bss.items()})
        rlp = layout.nrows_padded
        d, m = eval_node(tree, args, rlp, self.device)
        m = m & cand if has_maybe and m is not None else None
        k = min(spec.k, rlp)
        if packed:
            d, m = topk_rows_packed(
                d & cand, m, sn.values, k, spec.desc,
                self.stage_segments(part, layout),
                self.stage_seg_slots(part, layout, k))
        else:
            d, m = topk_rows(d & cand, m, sn.values, k, spec.desc)

        def finish(d_np, m_np):
            self.stats_counters["topk_rows"] += int(d_np.sum()) + (
                0 if m_np is None else int(m_np.sum()))
            return settle_maybe(f, bss, layout, d_np, m_np)

        return self._rows_download(d, m, cand, m is not None, rlp, finish)

    def run_part_topk(self, f, part, bss: dict, spec: SortSpec):
        """block_idx -> bitmap of the filter's rows at or above the
        part's k-th best `spec.field` key, maybe rows settled on the
        host (a superset of the part's rows in the query's top k), or
        None where the part declines: a candidate block whose sort field
        is not int-typed, a staged range over TOPK_SCORE_MAX, or a tree
        the planner cannot express (`topk_declines`).  `topk_rows`
        counts the rows it downloads."""
        pending = self.run_part_topk_submit(f, part, bss, spec)
        return None if pending is None else pending.harvest()

    # ---- the per-leaf path of a tree the planner declines ----

    def _run_leaves(self, f, part, bss: dict):
        """(block idx -> bitmap, whether a leaf ran on the card)."""
        walk = _LeafWalk(self, part, bss)
        care = {bi: np.ones(bs.nrows, dtype=bool) for bi, bs in bss.items()}
        return walk.eval(f, care), walk.on_card

    # ---- stats ----

    def _reduce_submit(self, asm: AxesAssembly, spec: StatsSpec, mask):
        """Launch the reduction of the rows of `mask` (bool[RLp] on the
        card): one count launch, or one value-reduction call for all
        value columns.  Returns (tensors to download, decode(host arrays)
        -> partials).  A packed unit's member axis goes to the count as
        its segment axis (nseg members x the other axes' cells); the
        value reduction takes it folded into the cell id (member * nb +
        cell, one axis of nseg * nb cells), both seg-major."""
        rlp = mask.shape[0]
        ids = combine_ids([a[1] for a in asm.axes], asm.strides) \
            if asm.axes else \
            torch.zeros(rlp, dtype=torch.int32, device=self.device)
        if spec.value_fields:
            out = stats_values(
                [asm.numerics[fld].values for fld in spec.value_fields],
                ids, mask, asm.nb)

            def decode(host):
                stats_np = {}
                for fld, row in zip(spec.value_fields,
                                    torch.from_numpy(host[0])):
                    cnt, sums, mn, mx = split_values(row, asm.nb)
                    counts = cnt.numpy()
                    stats_np[fld] = (sums.numpy(), mn.numpy(), mx.numpy())
                return self._partials(asm, counts, stats_np)
            return [out], decode
        if asm.nseg:
            rest = asm.axes[1:]
            base = combine_ids([a[1] for a in rest], asm.strides[1:]) \
                if rest else torch.zeros_like(ids)
            out = stats_count_seg(asm.axes[0][1], base, mask, asm.nseg,
                                  asm.nb // asm.nseg)
        else:
            out = stats_count_seg(None, ids, mask, 1, asm.nb)
        return [out], lambda host: self._partials(asm, host[0], {})

    def _reduce(self, asm: AxesAssembly, spec: StatsSpec, mask) -> list:
        """Partials of the rows of `mask`, waited for now."""
        tensors, decode = self._reduce_submit(asm, spec, mask)
        return Download(tensors, decode).harvest()

    def run_part_stats_submit(self, f, part, bss: dict, spec: StatsSpec):
        """The submit form of `run_part_stats`: the handle's harvest()
        gives (bitmaps, handled, partials).  Over a packed part (`spec`
        with its member axis) the partials' keys lead with ("s",
        member); where the pack's axes cannot stage or the planner
        declines its tree, None: the pack runs member by member."""
        packed = getattr(part, "num_segments", 0)
        asm = self._assemble_axes(part, spec)
        if asm is None or any(bi not in el for el in asm.eligibility
                              for bi in bss):
            if packed:
                return None
            return _Then(self.run_part_submit(f, part, bss),
                         lambda bms: (bms, set(), []))
        prog = self._program(f, part, bss)
        if prog is None:
            if packed:
                return None
            return Ready(self._run_part_stats_unfused(f, part, bss, spec,
                                                      asm))
        tree, args, layout, has_maybe, cand = prog
        self._count_device_part(part, layout)
        handled = set(bss)
        if tree == ("false",):
            return Ready(({}, handled, []))
        rlp = layout.nrows_padded
        d, m = eval_node(tree, args, rlp, self.device)
        tensors, decode = self._reduce_submit(asm, spec, d & cand)
        maybe = has_maybe and m is not None
        if maybe:
            tensors.append(packbits(m & cand))

        def finish(host):
            partials = decode(host)
            if maybe:
                m_np = np.unpackbits(host[1])[:rlp].astype(bool)
                self.stats_counters["maybe_rows"] += int(m_np.sum())
                partials.extend(residue_partials(f, bss, spec, layout,
                                                 m_np, part))
            return {}, handled, partials

        return Download(tensors, finish)

    def run_part_stats(self, f, part, bss: dict, spec: StatsSpec):
        """(bitmaps, handled, partials): the filter and the stats of one
        part on the card.  Partials, for the handled blocks, are (key
        parts, count, value stats, uniq values, quantile numbers) as
        `_partials` and fused.residue_partials build them; bitmaps
        cover the rest."""
        return self.run_part_stats_submit(f, part, bss, spec).harvest()

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
            self._count_device_part(part, layout)
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


def _scan_fields(f, out: set) -> set:
    """The fields of the filter's leaves that plan as scans."""
    if isinstance(f, (F.FilterAnd, F.FilterOr)):
        for sub in f.filters:
            _scan_fields(sub, out)
    elif isinstance(f, F.FilterNot):
        _scan_fields(f.inner, out)
    else:
        plan = device_plan(f)
        if plan is not None and plan.field != "_time":
            out.add(plan.field)
    return out
