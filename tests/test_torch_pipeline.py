"""The port's dispatch window and small-part packing against the JAX
package.

- Pack groups: gpu/pipeline.iter_pack_groups gives the JAX package's
  groups on seeded part lists (mixed sizes, bucket changes, time spans
  at PACK_TS_SPAN_MAX, VL_PACK_PARTS 1 and 8, packing off).
- The parity matrix (the JAX package's test_pipeline_parity_matrix
  without its timing): VL_INFLIGHT {1, 4} x VL_PACK_PARTS {1, 8} x six
  query families on a store of three UTC days, each of many small
  parts (flushed ones, a part too big to pack, unflushed batches).
  Every cell equals the JAX host executor's answer as sorted rows
  (the JAX walk is serial here: `options(concurrency=1)`) and the
  port's serial walk (VL_INFLIGHT=1, VL_PACK_PARTS=1) row for row.
  This store is the exception to the port tests' one-day rule: its
  rows span three days, strictly increasing within each.
- Seg-major partials: the count with its segment axis and the value
  reduction over member-folded cell ids equal the JAX package's
  stats_count_seg_local, stats_values_seg_local, stats_count_slots
  and stats_values_slots on the same inputs; the seg slot map equals
  the JAX one; the packed top-k keeps each member's own rows.
- Counts: P small parts cost ceil(P / 8) units and scan calls; a tree
  the planner declines runs member by member.
- Release: a flush between two queries drops the pack of the
  in-memory parts with its staged tensors, and the second answer sees
  the merged part.
- A satisfied limit stops the window with at most its depth in flight
  and the staging cache balanced.
"""

import gc
import math
import weakref

import numpy as np
import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.storage import datadb as JDD
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu import pipeline as JP
from victorialogs_tpu.tpu import stats_seg as JSS

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)

STREAMS = ["app", "host"]
DAYS = 3
HOUR = 3600 * 10**9
# rows of each day's flushed parts, then of its unflushed batches; 700
# and 900 rows fall in other pad buckets than 600, 20,000 rows is above
# the pack cap
FLUSHED = [(600, 640, 700, 600), (600, 20000, 600, 900), (600, 600, 600, 600)]
UNFLUSHED = [(600, 600, 600), (600, 700), (600,)]

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = None
P = T = None


def _load_port():
    global torch, P, T
    import torch
    from types import SimpleNamespace
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu import batch, fused, kernels, pipeline
    from victorialogs_tpu_torch.gpu import stats_seg
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.storage import log_rows
    from victorialogs_tpu_torch.storage.storage import Storage
    P = SimpleNamespace(run=run_query_collect, batch=batch, fused=fused,
                        K=kernels, pipeline=pipeline, seg=stats_seg,
                        tracing=tracing, LR=log_rows, Storage=Storage,
                        Runner=lambda: batch.TorchBatchRunner(device="cpu"))
    T = [log_rows.TenantID(0, 0)]


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rows(n, seed, start):
    """n generator rows from `start`, two a second, every 40th with a
    multibyte `_msg` (maybe rows of an any-case leaf)."""
    rows = generate(n, seed, start, n * 10**9 // 2, streams=16)
    for i in range(7, n, 40):
        ts, fields = rows[i]
        rows[i] = (ts, [("_msg", "Größe ÄRROR error " + fields[0][1])]
                   + fields[1:])
    return rows


def _add(port, jax_st, rows):
    lr = P.LR.LogRows(stream_fields=STREAMS)
    jl = JLR.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(P.LR.TenantID(0, 0), ts, fields)
        jl.add(JLR.TenantID(0, 0), ts, fields)
    port.must_add_rows(lr)
    jax_st.must_add_rows(jl)


@pytest.fixture(scope="module")
def days_store(tmp_path_factory):
    """DAYS UTC days of small parts in both packages: each day's flushed
    parts (one flush a batch), then, after every flush, each day's
    unflushed batches."""
    _load_port()
    old = JDD.MAX_INMEMORY_PARTS
    JDD.MAX_INMEMORY_PARTS = 1 << 30
    port = P.Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("jaxdays")),
                        flush_interval=3600)
    day0 = today_start_ns() - (DAYS - 1) * NS_PER_DAY
    seed = 0
    try:
        for d in range(DAYS):
            t = day0 + d * NS_PER_DAY
            for n in FLUSHED[d]:
                seed += 1
                _add(port, jax_st, _rows(n, seed, t))
                port.debug_flush()
                jax_st.debug_flush()
                t += HOUR * 5
        for d in range(DAYS):
            t = day0 + d * NS_PER_DAY + HOUR * 5 * len(FLUSHED[d])
            for n in UNFLUSHED[d]:
                seed += 1
                _add(port, jax_st, _rows(n, seed, t))
                t += n * 10**9
        yield port, jax_st, day0
    finally:
        JDD.MAX_INMEMORY_PARTS = old
        jax_st.close()
        port.close()


FAMILIES = {
    "rows": "error | fields _time, app, dur",
    "rows_limit": "error | fields _time, app, dur | limit 300",
    "stats": "* | stats by (_time:1h, app) count() c",
    "value_stats": "error | stats by (lvl) count() c, sum(dur) s, "
                   "min(dur) mn, max(dur) mx, count_uniq(app) u",
    "sort": "error | sort by (dur desc) limit 7 | fields dur, app",
    "maybe_stats": "i(error) | stats by (app) count() c, sum(dur) s",
}


def _sorted(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def _port_run(port, q, ts, inflight, pack, monkeypatch):
    monkeypatch.setenv("VL_INFLIGHT", inflight)
    monkeypatch.setenv("VL_PACK_PARTS", pack)
    runner = P.Runner()
    try:
        rows = P.run(port, T, q, timestamp=ts, runner=runner)
    finally:
        runner.close()
    c = runner.stats_counters
    assert c["host_parts"] == 0 and c["device_parts"] >= 1, c
    assert runner.cache.check_balanced()
    return rows, c


def test_store_shape(days_store):
    port, _jax_st, _day0 = days_store
    assert len(port.partitions) == DAYS
    for d, pt in enumerate(sorted(port.partitions.values(),
                                  key=lambda p: p.day)):
        assert [p.num_rows for p in pt.parts] == list(FLUSHED[d])
        assert [p.num_rows for p in pt._pending] == list(UNFLUSHED[d])


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("inflight,pack",
                         [("1", "1"), ("4", "1"), ("1", "8"), ("4", "8")])
def test_parity_matrix(days_store, monkeypatch, inflight, pack, family):
    port, jax_st, day0 = days_store
    q = FAMILIES[family]
    ts = day0 + DAYS * NS_PER_DAY
    want = jax_run(jax_st, [JLR.TenantID(0, 0)],
                   "options(concurrency=1) " + q, timestamp=ts)
    assert want, q
    serial, _c = _port_run(port, q, ts, "1", "1", monkeypatch)
    got, c = _port_run(port, q, ts, inflight, pack, monkeypatch)
    assert got == serial, (q, inflight, pack)
    assert _sorted(got) == _sorted(want), (q, inflight, pack)
    assert (c["packed_units"] > 0) == (pack == "8"), c
    if pack == "8":
        assert c["packed_parts"] >= 2 * c["packed_units"], c
    if family == "maybe_stats":
        assert c["maybe_rows"] > 0, c


def test_cross_partition_off_drains_at_each_day(days_store, monkeypatch):
    """VL_CROSS_PARTITION=0: no pack spans a day boundary, answers
    unchanged."""
    port, _jax_st, day0 = days_store
    q = FAMILIES["stats"]
    ts = day0 + DAYS * NS_PER_DAY
    on, c_on = _port_run(port, q, ts, "4", "8", monkeypatch)
    monkeypatch.setenv("VL_CROSS_PARTITION", "0")
    off, c_off = _port_run(port, q, ts, "4", "8", monkeypatch)
    assert on == off
    assert c_off["units"] > c_on["units"]


class _FakePart:
    def __init__(self, uid, num_rows, min_ts, max_ts):
        self.uid = uid
        self.num_rows = num_rows
        self.min_ts = min_ts
        self.max_ts = max_ts


def _fake_parts(seed):
    rng = np.random.default_rng(seed)
    parts = []
    t = 0
    for i in range(60):
        n = int(rng.choice([1, 300, 600, 640, 641, 700, 900, 1000, 5000,
                            16384, 16385, 70000]))
        span = int(rng.choice([10**9, 1 << 46, (1 << 47) - 1, 1 << 47]))
        t += int(rng.integers(0, 1 << 45))
        parts.append(_FakePart(i, n, t, t + span))
    return parts


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("packable,pack_max", [(True, 8), (True, 1),
                                               (True, 3), (False, 8)])
def test_pack_groups_match_jax(seed, packable, pack_max):
    parts = _fake_parts(seed)
    items = [(p, i) for i, p in enumerate(parts)]

    def groups(fn):
        return [[it[1] for it in g] for g in fn(iter(items), packable,
                                                pack_max, 16384)]
    want = groups(JP.iter_pack_groups)
    assert groups(P.pipeline.iter_pack_groups) == want
    assert any(len(g) > 1 for g in want) == (packable and pack_max > 1)
    for p in parts:
        assert P.pipeline.pack_bucket(p) == JP.pack_bucket(p)
    assert P.pipeline.PACK_TS_SPAN_MAX == JP.PACK_TS_SPAN_MAX


def test_knobs_parse_as_jax(monkeypatch):
    for name, val in (("VL_INFLIGHT", "7"), ("VL_INFLIGHT", "x"),
                      ("VL_INFLIGHT", "0"), ("VL_PACK_PARTS", "3"),
                      ("VL_PACK_PARTS", ""), ("VL_PACK_TOPK_K", "9"),
                      ("VL_PACK_MAX_ROWS", "5000"),
                      ("VL_CROSS_PARTITION", "0")):
        monkeypatch.setenv(name, val)
        assert P.pipeline.inflight_depth() == JP.inflight_depth(None)
        assert P.pipeline.pack_limit() == JP.pack_limit()
        assert P.pipeline.pack_topk_k() == JP.pack_topk_k()
        assert P.pipeline.cross_partition_enabled() == \
            JP.cross_partition_enabled()
        monkeypatch.delenv(name)
    monkeypatch.setenv("VL_PACK_MAX_ROWS", "5000")
    assert P.pipeline.pack_rows_cap() == JP.pack_rows_cap(None) == 5000
    monkeypatch.delenv("VL_PACK_MAX_ROWS")
    assert P.pipeline.pack_rows_cap() == JP._PACK_ROWS_FLOOR


# ---------------- seg-major partials ----------------

class _FakePack:
    """The block map of a packed part: member block rows."""

    def __init__(self, members):
        self.members = members
        self.num_segments = len(members)
        self._rows = [r for m in members for r in m]
        self.num_blocks = len(self._rows)
        self._off = np.cumsum([0] + [len(m) for m in members]).tolist()

    def block_offset(self, mi):
        return self._off[mi]

    def block_rows(self, bi):
        return self._rows[bi]


class _Layout:
    def __init__(self, pack):
        self.starts = dict(enumerate(np.cumsum(
            [0] + pack._rows[:-1]).tolist()))
        n = sum(pack._rows)
        self.nrows = n
        self.nrows_padded = -(-n // 8192) * 8192


SEG_CASES = [
    # (member block rows, base cells, masked-in share)
    ([[3000, 1000], [5000], [100, 100, 90]], 5, 0.7),
    ([[1000]] * 8, 33, 0.5),
    ([[8192], [1]], 1, 1.0),
    ([[2000, 2000], [3000], [1500], [700]], 300, 0.9),
]


def _seg_inputs(case, seed):
    members, nb, share = case
    pack = _FakePack(members)
    layout = _Layout(pack)
    rlp = layout.nrows_padded
    rng = np.random.default_rng(seed)
    seg = np.zeros(rlp, dtype=np.int32)
    for bi in range(pack.num_blocks):
        s = layout.starts[bi]
        seg[s:s + pack.block_rows(bi)] = \
            next(mi for mi in range(pack.num_segments)
                 if pack.block_offset(mi) <= bi
                 and (mi + 1 == pack.num_segments
                      or bi < pack.block_offset(mi + 1)))
    base = rng.integers(0, nb, size=rlp).astype(np.int32)
    base[rng.random(rlp) < 0.05] = nb          # outside the axis
    mask = rng.random(rlp) < share
    mask[layout.nrows:] = False
    vals = rng.integers(0, 1 << 32, size=rlp, dtype=np.uint64)
    vals[rng.random(rlp) < 0.1] = 0xFFFFFFFF
    return pack, layout, seg, base, mask, vals.astype(np.uint32)


def _plane_sum(sums):
    s = np.asarray(sums).astype(np.int64)
    return sum(s[p] << (8 * p) for p in range(4))


@pytest.mark.parametrize("ci", range(len(SEG_CASES)))
def test_seg_major_partials_equal_jax(ci):
    import jax.numpy as jnp
    pack, layout, seg, base, mask, vals = _seg_inputs(SEG_CASES[ci], ci)
    nseg, nb = pack.num_segments, SEG_CASES[ci][1]
    slot = P.seg.build_seg_slot_map(pack, layout)
    assert np.array_equal(slot, JSS.build_seg_slot_map(pack, layout))
    tseg, tbase = torch.from_numpy(seg), torch.from_numpy(base)
    tmask = torch.from_numpy(mask)
    # the count with its segment axis, seg-major
    got_c = P.seg.stats_count_seg(tseg, tbase, tmask, nseg, nb).numpy()
    jseg, jbase, jmask = jnp.asarray(seg), jnp.asarray(base), \
        jnp.asarray(mask)
    assert np.array_equal(got_c, np.asarray(JSS.stats_count_seg_local(
        jseg, jbase, jmask, nseg, nb)).astype(np.int32))
    assert np.array_equal(got_c, np.asarray(JSS.stats_count_slots(
        jnp.asarray(slot), jbase, jmask, nb)).astype(np.int32))
    # the value reduction over the folded cell id member * nb + cell
    # (a base id outside the axis counts nowhere in JAX: kept outside)
    cell = np.where(base < nb, seg * nb + base, -1).astype(np.int32)
    packed = P.seg.stats_values(
        [torch.from_numpy(vals.view(np.int32))], torch.from_numpy(cell),
        tmask, nseg * nb)
    cnt, sums, mn, mx = P.seg.split_values(packed[0], nseg * nb)
    jv = jnp.asarray(vals)
    for jax_out in (JSS.stats_values_seg_local(jv, jseg, jbase, jmask,
                                               nseg, nb),
                    JSS.stats_values_slots(jv, jnp.asarray(slot), jbase,
                                           jmask, nb)):
        jc, js, jlo, jhi = jax_out
        assert np.array_equal(cnt.numpy(), np.asarray(jc).astype(np.int32))
        assert np.array_equal(sums.numpy(), _plane_sum(js))
        assert np.array_equal(mn.numpy().view(np.uint32), np.asarray(jlo))
        assert np.array_equal(mx.numpy().view(np.uint32), np.asarray(jhi))


@pytest.mark.parametrize("k", [1, 7, 600])
@pytest.mark.parametrize("desc", [True, False])
def test_packed_topk_keeps_each_members_rows(k, desc):
    pack, layout, seg, _base, mask, vals = _seg_inputs(SEG_CASES[3], k)
    rlp = layout.nrows_padded
    rng = np.random.default_rng(k)
    v = torch.from_numpy((vals >> 2).view(np.int32))   # < 2**30
    d = torch.from_numpy(mask)
    m = torch.from_numpy(~mask & (rng.random(rlp) < 0.1))
    m[layout.nrows:] = False
    slot = torch.from_numpy(P.seg.build_seg_slot_map(pack, layout, k))
    got_d, got_m = P.fused.topk_rows_packed(d, m, v, k, desc,
                                            torch.from_numpy(seg), slot)
    for mi in range(pack.num_segments):
        rows = torch.from_numpy(seg == mi) & \
            (torch.arange(rlp) < layout.nrows)
        want_d, want_m = P.fused.topk_rows(d & rows, m & rows, v,
                                           min(k, int(rows.sum())), desc)
        assert torch.equal(got_d & rows, want_d)
        assert torch.equal(got_m & rows, want_m)


# ---------------- counts, declines, release, early stop ----------------

def _counting(monkeypatch):
    calls = {"scan": 0, "count": 0, "values": 0}

    def wrap(mod, name, key):
        inner = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    wrap(P.K, "match_scan", "scan")
    wrap(P.batch, "stats_count_seg", "count")
    wrap(P.batch, "stats_values", "values")
    return calls


def test_packing_collapses_dispatches(days_store, monkeypatch):
    """Per run of packable parts of one pad bucket, P parts cost
    ceil(P / 8) units: one scan and one count each."""
    port, _jax_st, day0 = days_store
    q = "error | stats by (app) count() c"
    ts = day0 + DAYS * NS_PER_DAY
    parts = [p for _d, pt in sorted(port.partitions.items())
             for p in pt.snapshot_parts()]
    want_units = len(list(JP.iter_pack_groups(((p,) for p in parts), True,
                                              8, 16384)))
    runs = []                       # lengths of same-bucket small runs
    for p in parts:
        key = P.pipeline.pack_bucket(p) if p.num_rows <= 16384 else None
        if runs and key is not None and runs[-1][0] == key:
            runs[-1][1] += 1
        else:
            runs.append([key, 1])
    assert want_units >= sum(1 if key is None else math.ceil(n / 8)
                             for key, n in runs)
    calls = _counting(monkeypatch)
    serial, c1 = _port_run(port, q, ts, "1", "1", monkeypatch)
    assert c1["units"] == calls["scan"] == calls["count"] == len(parts)
    for k in calls:
        calls[k] = 0
    packed, c8 = _port_run(port, q, ts, "4", "8", monkeypatch)
    assert packed == serial
    assert c8["units"] == calls["scan"] == calls["count"] == want_units
    assert want_units < len(parts)
    assert c8["device_parts"] == c1["device_parts"] == len(parts)
    assert c8["packed_parts"] == len(parts) - (c8["units"] -
                                               c8["packed_units"])


def test_pack_declines_fall_back_per_member(days_store, monkeypatch):
    """A leaf the planner cannot express (eq_field) declines the pack:
    each member runs as its own part, the answer unchanged."""
    port, jax_st, day0 = days_store
    q = "lvl:eq_field(app) or error | stats count() c"
    ts = day0 + DAYS * NS_PER_DAY
    want = jax_run(jax_st, [JLR.TenantID(0, 0)], q, timestamp=ts)
    got, c = _port_run(port, q, ts, "4", "8", monkeypatch)
    assert got == want
    assert c["packed_units"] == 0 and c["cpu_fallbacks"] > 0, c


def test_limit_stops_the_window(days_store, monkeypatch):
    port, _jax_st, day0 = days_store
    q = "error | limit 3"
    ts = day0 + DAYS * NS_PER_DAY
    nparts = sum(len(pt.snapshot_parts())
                 for pt in port.partitions.values())
    serial, c1 = _port_run(port, q, ts, "1", "1", monkeypatch)
    assert c1["units"] == 1
    root = P.tracing.make_root("query")
    with P.tracing.activate(root):
        got, c = _port_run(port, q, ts, "2", "1", monkeypatch)
    assert got == serial and len(got) == 3
    assert c["units"] == c["inflight_hwm"] == 2 < nparts
    assert root.open_spans() == 0


def test_flush_releases_the_packs_staging(tmp_path, monkeypatch):
    """The in-memory parts of a day pack into one unit; a flush drops
    them, and with them the pack and its staged tensors; the next
    answer sees the merged part and equals the first."""
    old = JDD.MAX_INMEMORY_PARTS
    JDD.MAX_INMEMORY_PARTS = 1 << 30
    port = P.Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path / "jax"), flush_interval=3600)
    t0 = today_start_ns()
    runner = P.Runner()
    try:
        for b in range(4):
            _add(port, jax_st, _rows(500, 90 + b, t0 + b * 1000 * 10**9))
        (pt,) = port.partitions.values()
        refs = [weakref.ref(p) for p in pt._pending]
        uids = tuple(p.uid for p in pt._pending)
        q = "error | stats by (app) count() c"
        before = P.run(port, T, q, timestamp=t0, runner=runner)
        assert runner.cache.part_uids() == {("pack",) + uids}
        assert runner.stats_counters["packed_parts"] == 4
        port.debug_flush()
        gc.collect()
        assert all(r() is None for r in refs)
        assert runner.cache.part_uids() == set()
        assert not runner._packs
        assert runner.cache.check_balanced()
        after = P.run(port, T, q, timestamp=t0, runner=runner)
        assert after == before == jax_run(
            jax_st, [JLR.TenantID(0, 0)], q, timestamp=t0)
        assert runner.cache.part_uids() == {pt.parts[0].uid}
    finally:
        JDD.MAX_INMEMORY_PARTS = old
        runner.close()
        jax_st.close()
        port.close()
