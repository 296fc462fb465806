"""Rows added and not yet flushed: the port against the JAX package.

Each batch a partition buffers is an in-memory part that queries see at
once, listed before the flushed parts as the JAX package lists its
in-memory parts; an add flushes its partition once more than
MAX_INMEMORY_PARTS (8) batches wait.  Here

- batches added through `must_add_rows`, `must_add_columns` and
  `handle_jsonline`, before any flush, answer the JAX package's rows
  through the host executor and through `TorchBatchRunner(device=
  "cpu")`, and again after `debug_flush`;
- more than 8 batches trigger the in-call flush, `_pending` never holds
  more than 8 after an add returns, and the answers stay the JAX
  package's;
- a flush releases the runner's staged tensors of the in-memory parts
  it replaced, and the parts themselves.

The JAX package's flusher thread would flush on its own once more than
its MAX_INMEMORY_PARTS batches wait; it is raised here, so its parts
stay in memory until `debug_flush`.
"""

import gc
import weakref

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.server import insertutil as JI
from victorialogs_tpu.server import vlinsert as JV
from victorialogs_tpu.storage import datadb as JDD
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       jsonline_body,
                                                       today_start_ns)

STREAMS = ["app", "host"]

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = Storage = TorchBatchRunner = run_query_collect = None
TLR = TI = TV = TS = None


def _load_port():
    global torch, Storage, TorchBatchRunner, run_query_collect
    global TLR, TI, TV, TS
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.server import insertutil as TI
    from victorialogs_tpu_torch.server import vlinsert as TV
    from victorialogs_tpu_torch.storage import log_rows as TLR
    from victorialogs_tpu_torch.storage import storage as TS
    from victorialogs_tpu_torch.storage.storage import Storage


@pytest.fixture(autouse=True)
def _torch_threads(monkeypatch):
    _load_port()
    monkeypatch.setattr(JDD, "MAX_INMEMORY_PARTS", 1 << 30)
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


QUERIES = [
    "error | fields _time, _msg, app, dur",
    "* | stats count() c",
    "quota | stats by (app) count() c, sum(dur) s",
    "warn | sort by (dur desc) limit 7 | fields dur, app",
    "error lvl:error | stats by (_time:1h) count() c",
    "alloc | blocks_count",
    "free | block_stats",
    "timeout | uniq by (lvl) with hits",
]


def _answers(port, jax_st, q, ts, ordered=True):
    want = jax_run(jax_st, [JLR.TenantID(0, 0)], q, timestamp=ts)
    t = [TLR.TenantID(0, 0)]
    runner = TorchBatchRunner(device="cpu")
    try:
        got = [run_query_collect(port, t, q, timestamp=ts),
               run_query_collect(port, t, q, timestamp=ts, runner=runner)]
    finally:
        runner.close()
    assert runner.stats_counters["host_parts"] == 0, q
    assert runner.stats_counters["device_parts"] >= 1, q
    if not ordered:
        key = lambda r: sorted(r.items())   # noqa: E731
        want = sorted(want, key=key)
        got = [sorted(g, key=key) for g in got]
    return want, got


def _batches(k, n, seed=3):
    """k batches of n generator rows each, one UTC day, times strictly
    increasing across the batches."""
    rows = generate(k * n, seed, today_start_ns(), NS_PER_DAY // 2,
                    streams=8)
    return [rows[i * n:(i + 1) * n] for i in range(k)]


def _add(route, port, jax_st, rows):
    """One batch into both packages by `route`."""
    if route == "jsonline":
        body = jsonline_body(rows)
        for I, V, st in ((TI, TV, port), (JI, JV, jax_st)):
            cp = I.CommonParams(stream_fields=STREAMS)
            lmp = I.LogMessageProcessor(cp, I.LocalLogRowsStorage(st))
            V.handle_jsonline(cp, body, lmp)
            lmp.flush()
        return
    lr = TLR.LogRows(stream_fields=STREAMS)
    jl = JLR.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(TLR.TenantID(0, 0), ts, fields)
        jl.add(JLR.TenantID(0, 0), ts, fields)
    if route == "rows":
        port.must_add_rows(lr)
        jax_st.must_add_rows(jl)
        return
    for LC, src, st in ((TLR.LogColumns, lr, port),
                        (JLR.LogColumns, jl, jax_st)):
        lc = LC()
        for ts, row, sid, tags in zip(src.timestamps, src.rows,
                                      src.stream_ids, src.stream_tags_str):
            g = lc.group(tuple(k for k, _ in row), ())
            lc.add(g, sid.tenant, ts, [v for _, v in row], sid, tags)
        st.must_add_columns(lc)


@pytest.fixture
def stores(tmp_path):
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path / "jax"), flush_interval=3600)
    yield port, jax_st
    jax_st.close()
    port.close()


@pytest.mark.parametrize("route", ["rows", "columns", "jsonline"])
@pytest.mark.parametrize("q", QUERIES)
def test_unflushed_rows_answer_as_jax(stores, route, q):
    port, jax_st = stores
    for rows in _batches(3, 700):
        _add(route, port, jax_st, rows)
    (pt,) = port.partitions.values()
    assert len(pt._pending) == 3 and not pt.parts
    (jpt,) = jax_st.partitions.values()
    assert len(jpt.ddb.snapshot_parts()) == 3
    ts = today_start_ns()
    want, got = _answers(port, jax_st, q, ts)
    assert want and got == [want, want]
    port.debug_flush()
    jax_st.debug_flush()
    assert not pt._pending and len(pt.parts) == 1
    want, got = _answers(port, jax_st, q, ts)
    if "block_stats" in q:
        # a flushed JAX part reports its directory, every port part
        # `inmemory`
        assert {r["part_path"] for g in got for r in g} == {"inmemory"}
        want, got = _without_path(want), [_without_path(g) for g in got]
    assert got == [want, want]


def _without_path(rows):
    return [{k: v for k, v in r.items() if k != "part_path"} for r in rows]


def test_unflushed_error_rows_are_seen(stores):
    """Five rows added, no flush: a query sees all five."""
    port, jax_st = stores
    rows = [(today_start_ns() + i, [("_msg", f"error {i}"), ("app", "a"),
                                    ("host", "h")]) for i in range(5)]
    _add("rows", port, jax_st, rows)
    want, got = _answers(port, jax_st, "error | stats count() c",
                         today_start_ns())
    assert want == [{"c": "5"}] and got == [want, want]


@pytest.mark.parametrize("route", ["rows", "columns"])
def test_more_than_eight_batches_flush_in_the_call(stores, route):
    port, jax_st = stores
    seen = []
    for k, rows in enumerate(_batches(20, 120)):
        _add(route, port, jax_st, rows)
        (pt,) = port.partitions.values()
        assert len(pt._pending) <= TS.MAX_INMEMORY_PARTS == 8
        seen.append((len(pt.parts), len(pt._pending)))
    # a flush after the 9th and the 18th batch, each of all 9
    assert seen[7] == (0, 8) and seen[8] == (1, 0) and seen[17] == (2, 0)
    assert seen[-1] == (2, 2)
    assert sum(p.num_rows for p in pt.snapshot_parts()) == 20 * 120
    ts = today_start_ns()
    # the parts differ from the JAX package's twenty in-memory ones, so
    # rows compare as sets; stats equal exactly
    for q in QUERIES[:5] + ["* | uniq by (app, lvl) with hits"]:
        ordered = "stats" in q or "sort" in q or "uniq" in q
        want, got = _answers(port, jax_st, q, ts, ordered=ordered)
        assert want and got == [want, want], q


def test_flush_releases_staged_in_memory_parts(stores, monkeypatch):
    """The runner stages the in-memory parts; a flush replaces them with
    one part, and their entries leave the staging cache with them.
    Unpacked, so the entries are the parts' own (a pack's:
    tests/test_torch_pipeline.py)."""
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    port, jax_st = stores
    for rows in _batches(4, 500):
        _add("rows", port, jax_st, rows)
    (pt,) = port.partitions.values()
    pending = list(pt._pending)
    uids = {p.uid for p in pending}
    refs = [weakref.ref(p) for p in pending]
    del pending
    ts = today_start_ns()
    runner = TorchBatchRunner(device="cpu")
    t = [TLR.TenantID(0, 0)]
    try:
        q = "error | stats by (app) count() c"
        before = run_query_collect(port, t, q, timestamp=ts, runner=runner)
        run_query_collect(port, t, "quota", timestamp=ts, runner=runner)
        assert runner.cache.part_uids() == uids
        port.debug_flush()
        gc.collect()
        assert all(r() is None for r in refs)
        assert runner.cache.part_uids() == set()
        assert runner.cache.check_balanced()
        after = run_query_collect(port, t, q, timestamp=ts, runner=runner)
        assert after == before == jax_run(jax_st, [JLR.TenantID(0, 0)], q,
                                          timestamp=ts)
        assert runner.cache.part_uids() == {pt.parts[0].uid}
    finally:
        runner.close()


def test_a_lone_batch_becomes_the_flushed_part(stores):
    """One batch flushes into its own part: staged tensors stay valid."""
    port, jax_st = stores
    (rows,) = _batches(1, 400)
    _add("rows", port, jax_st, rows)
    (pt,) = port.partitions.values()
    (part,) = pt._pending
    runner = TorchBatchRunner(device="cpu")
    try:
        run_query_collect(port, [TLR.TenantID(0, 0)], "error",
                          timestamp=today_start_ns(), runner=runner)
        port.debug_flush()
        assert pt.parts == [part] and not pt._pending
        assert runner.cache.part_uids() == {part.uid}
    finally:
        runner.close()


def test_staging_cache_drop_during_a_locked_call():
    """A part dropped while the cache's lock is held (a collection inside
    one of its calls) is released at the cache's next call."""
    from victorialogs_tpu_torch.gpu.layout import StagingCache
    c = StagingCache()
    c.put((1, "a"), b"x")
    c.put((2, "a"), b"y")
    with c._mu:
        c.drop_part(1)
    assert c.part_uids() == {2}
    assert c.bytes() == 4096 and c.check_balanced()
