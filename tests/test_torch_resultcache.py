"""The port's per-part result cache (engine/standing/resultcache.py)
against the JAX package's.

- Fingerprints: for the same query and tenants, `_time_free_filter_str`
  and `QueryCache.for_query`'s kind and fingerprints are the JAX
  package's, on the host walk and with the device specs.
- Byte accounting: `_sizeof` is the JAX package's on the same values,
  and one sequence of store, probe, eviction past a small
  VL_RESULT_CACHE_MAX_BYTES and release gives the same `cache_stats()`
  in both packages.
- Bit-identity: for each shape (tests/test_standing.py's SHAPES, value
  stats, a `_time` window that cuts a part, `in(<subquery>)`), cold,
  warm and VL_RESULT_CACHE=0 runs give the same answer, on the host
  walk and on the device path (device="cpu") at VL_INFLIGHT/
  VL_PACK_PARTS 1/1 and 4/8, equal to the JAX package's uncached answer
  on the same rows (one UTC day; compared as sorted rows).
- Replay: a warm stats run stages and submits nothing; each covered
  part is one result-cache unit.
- A new batch misses alone; bitmaps stored by the device path replay on
  the host walk; after a force merge and a collection the merged-away
  parts' entries are gone, the store balances, and the next run misses
  and gives the same answer; a top-k re-ask with another k does not hit
  the entries of the first.

Every test runs with VL_RESULT_CACHE=1 (tests/conftest.py sets 0), the
port's store reset before and after it and balanced after it.
"""

import gc
import json
import weakref

import numpy as np
import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.engine.standing import resultcache as JRC
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu.sort_device import device_sort_spec as jax_sort
from victorialogs_tpu.tpu.stats_device import device_stats_spec as jax_stats

T0 = 1_753_660_800_000_000_000  # 2025-07-28T00:00:00Z
T0_S = T0 // 10**9
TS = T0 + 10**14                # query time past every row, same day
N_PARTS = 6
ROWS_PER_PART = 200

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = P = None


def _load_port():
    global torch, P
    import torch
    from types import SimpleNamespace
    from victorialogs_tpu_torch.engine import standing
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.engine.standing import resultcache
    from victorialogs_tpu_torch.gpu import batch
    from victorialogs_tpu_torch.gpu.sort_device import device_sort_spec
    from victorialogs_tpu_torch.logsql.parser import parse_query
    from victorialogs_tpu_torch.storage import log_rows
    from victorialogs_tpu_torch.storage.storage import Storage
    P = SimpleNamespace(run=run_query_collect, standing=standing,
                        RC=resultcache, batch=batch, parse=parse_query,
                        sort_spec=device_sort_spec, LR=log_rows,
                        Storage=Storage, T=[log_rows.TenantID(0, 0)],
                        Runner=lambda: batch.TorchBatchRunner(device="cpu"))


def _balanced():
    ok, detail = P.standing.cache_check_balanced()
    if not ok:
        gc.collect()
        ok, detail = P.standing.cache_check_balanced()
    return ok, detail


@pytest.fixture(autouse=True)
def _cache_on(monkeypatch):
    _load_port()
    monkeypatch.setenv("VL_RESULT_CACHE", "1")
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    P.standing.reset_for_tests()
    JRC.reset_for_tests()
    yield
    ok, detail = _balanced()
    P.standing.reset_for_tests()
    JRC.reset_for_tests()
    torch.set_num_threads(old)
    assert ok, detail


def _rows(n, base, seed):
    """n rows of one UTC day, one a second from T0 + base seconds."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 211, size=n).tolist()
    out = []
    for i in range(n):
        g = base + i
        out.append((T0 + g * 10**9, [
            ("app", f"app{g % 3}"),
            ("_msg", f"m {'err' if g % 3 == 0 else 'ok'} x{g % 37} of {g}"),
            ("lvl", ["info", "warn", "err"][g % 3]),
            ("dur", str(dur[i]))]))
    return out


def _add(store, rows, lr_mod):
    lr = lr_mod.LogRows(stream_fields=["app"])
    for ts, fields in rows:
        lr.add(lr_mod.TenantID(0, 0), ts, fields)
    store.must_add_rows(lr)


def _port_store(n_parts=N_PARTS):
    port = P.Storage(retention_days=100000, device="cpu")
    for k in range(n_parts):
        _add(port, _rows(ROWS_PER_PART, k * ROWS_PER_PART, k), P.LR)
        port.debug_flush()
    return port


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """N_PARTS flushed parts of one UTC day in both packages."""
    _load_port()
    port = _port_store()
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("rcstore")),
                        retention_days=100000, flush_interval=3600)
    for k in range(N_PARTS):
        _add(jax_st, _rows(ROWS_PER_PART, k * ROWS_PER_PART, k), JLR)
        jax_st.debug_flush()
    yield port, jax_st
    jax_st.close()
    port.close()


def _parts(port):
    return [p for pt in port.partitions.values()
            for p in pt.snapshot_parts()]


def _sorted(rows):
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


# ---------------- fingerprints ----------------

WINDOW = f"_time:[{T0_S + 100}, {T0_S + 1000})"

FP_QUERIES = [
    "err",
    f"{WINDOW} err",
    f"{WINDOW} err | fields _time, app",
    f"err {WINDOW} x7",
    f"(err or {WINDOW}) | fields dur",
    f"err and not {WINDOW}",
    f"{WINDOW}",
    "* | stats by (app) count() c",
    f"{WINDOW} err | stats by (lvl) count() n, max(dur) mx",
    "* | stats count() c, sum(dur) s",
    "err | sort by (dur desc) limit 5 | fields dur, app",
    f"{WINDOW} * | sort by (dur) limit 7 | fields dur, lvl",
    "app:in(lvl:err | fields app) | stats count() c",
    "err app:in(lvl:warn | fields app)",
    "_stream:{app=\"app1\"} x7 | fields dur",
    "lvl:err | stats by (_time:1h) count() c",
    "_time:5m err | stats count() c",
    "err _time:<now | fields dur",
]
# a `_time` filter read from `now` under or/NOT: its rows move with
# `now` while its text stays, so the port keeps no entry for it (the
# JAX package does, and replays stale rows)
MOVING_QUERIES = [
    "err !_time:5m",
    "(err or _time:5m) | stats count() c",
    "err (lvl:warn or not _time:>1h) | sort by (dur) limit 3",
    "(x7 (app:app1 or _time:>=now)) | fields dur",
]


def _fp(qc):
    return None if qc is None else (qc.kind, qc._fp_probe, qc._fp_store,
                                    qc._min_ts, qc._max_ts)


@pytest.mark.parametrize("qs", FP_QUERIES)
def test_fingerprints_match_jax(qs):
    pq, jq = P.parse(qs, TS), jax_parse(qs, TS)
    assert P.RC._time_free_filter_str(pq.filter) == \
        JRC._time_free_filter_str(jq.filter)
    tenants = [P.LR.TenantID(0, 0), P.LR.TenantID(3, 7)]
    jtenants = [JLR.TenantID(0, 0), JLR.TenantID(3, 7)]
    lo, hi = pq.get_time_range()
    assert (lo, hi) == jq.get_time_range()
    # the host walk: no device shape
    got = P.RC.QueryCache.for_query(pq, tenants, None, None, lo, hi)
    want = JRC.QueryCache.for_query(jq, jtenants, None, None, lo, hi)
    assert _fp(got) == _fp(want)
    # the device path: the runner's stats and top-k shapes
    spec = P.batch.TorchBatchRunner.stats_spec(pq)
    jspec = jax_stats(jq)
    assert (spec is None) == (jspec is None)
    sort = P.sort_spec(pq) if spec is None else None
    jsort = jax_sort(jq) if jspec is None else None
    got = P.RC.QueryCache.for_query(pq, tenants, spec, sort, lo, hi)
    want = JRC.QueryCache.for_query(jq, jtenants, jspec, jsort, lo, hi)
    assert _fp(got) == _fp(want)
    assert (got is None) == (":in(" in qs)


@pytest.mark.parametrize("qs", MOVING_QUERIES)
def test_moving_time_filter_is_not_cached(qs):
    pq, jq = P.parse(qs, TS), jax_parse(qs, TS)
    assert P.RC._time_free_filter_str(pq.filter) == \
        JRC._time_free_filter_str(jq.filter)
    lo, hi = pq.get_time_range()
    spec = P.batch.TorchBatchRunner.stats_spec(pq)
    sort = P.sort_spec(pq) if spec is None else None
    for ss, so in ((None, None), (spec, sort)):
        assert P.RC.QueryCache.for_query(pq, P.T, ss, so, lo, hi) is None


@pytest.mark.parametrize("tenant", [None, "5:6", [], ["0:1"]])
def test_tenant_str_matches_jax(tenant):
    from victorialogs_tpu.obs.activity import tenant_str
    assert P.RC.tenant_str(tenant) == tenant_str(tenant)


# ---------------- byte accounting ----------------

SIZEOF_VALUES = [
    np.zeros(13, dtype=np.uint8), b"abc", "text", (1, 2.5, "x"),
    [np.ones((3, 4)), {"k": (7, np.packbits(np.ones(9, dtype=bool)))}],
    {0: (9, np.zeros(2, dtype=np.uint8)), 5: (1, np.ones(1, np.uint8))},
    frozenset({1, 2}), None, 3.5,
    [((("t", 5),), 3, {"dur": (1, 2)}, {}, {})],
]


@pytest.mark.parametrize("k", range(len(SIZEOF_VALUES)))
def test_sizeof_matches_jax(k):
    assert P.RC._sizeof(SIZEOF_VALUES[k]) == JRC._sizeof(SIZEOF_VALUES[k])


class _StandIn:
    """A part as the store sees it: uid, time range, collectable."""

    def __init__(self, uid, min_ts, max_ts):
        self.uid, self.min_ts, self.max_ts = uid, min_ts, max_ts


def _store_sequence(rc, monkeypatch) -> list:
    """One sequence of stores, probes, evictions and releases on stand-in
    parts; cache_stats() after each step."""
    monkeypatch.setenv("VL_RESULT_CACHE_MAX_BYTES", str(64 << 20))
    rc.reset_for_tests()
    parts = [_StandIn(900_000 + i, 10 * i, 10 * i + 9) for i in range(5)]
    qc = rc.QueryCache(("fp:rows",), "fp:rows", "bms", 0, 100)
    narrow = rc.QueryCache(("fp:rows",), "fp:rows", "bms", 12, 100)
    out = []
    bms = {bi: np.arange(40 + bi) % 3 == 0 for bi in range(3)}
    for p in parts[:3]:
        qc.store_bms(p, [0, 1, 2], bms)
        out.append(rc.cache_stats())
    out.append((qc.probe(parts[0], [0, 1, 2]) is not None,
                qc.probe(parts[0], [0, 1]) is not None,
                narrow.probe(parts[1], [0, 1, 2]) is not None,
                rc.cache_stats()))
    narrow.store_bms(parts[3], [0], bms)       # covered: stored
    narrow.store_bms(parts[1], [0], bms)       # cut by 12: not stored
    out.append(rc.cache_stats())
    # a budget of about two entries: the least recently used go
    one = rc.cache_stats()["used_bytes"] // 4
    monkeypatch.setenv("VL_RESULT_CACHE_MAX_BYTES", str(2 * one + 8))
    qc.store_bms(parts[4], [0, 1, 2], bms)
    out.append(rc.cache_stats())
    out.append(qc.probe(parts[0], [0, 1, 2]) is not None)
    stats = qc.__class__(("fp:stats",), "fp:stats", "stats", 0, 100)
    member = type("M", (), {})()
    member.part, member.blocks = parts[2], [(0, None), (1, None)]
    member.handled, member.partials, member.bms = {0, 1}, [(("a",), 3)], {}
    stats.store_member(member)
    member.handled = {0}
    member.part = parts[3]
    stats.store_member(member)                 # not fully reduced: no
    out.append(rc.cache_stats())
    out.append(rc.cache_check_balanced()[0])
    del parts[:], member, p
    gc.collect()
    out.append(rc.cache_stats())
    out.append(rc.cache_check_balanced()[0])
    return out


def test_store_sequence_matches_jax(monkeypatch):
    got = _store_sequence(P.RC, monkeypatch)
    want = _store_sequence(JRC, monkeypatch)
    assert got == want
    assert got[-2]["entries"] == 0 and got[-2]["used_bytes"] == 0
    assert got[5]["evictions"] > 0


# ---------------- bit-identity ----------------

SHAPES = [
    "* | stats by (app) count() c",
    "* | stats count() c, sum(dur) s",
    "err | stats by (lvl) count() n, max(dur) mx",
    "* | stats by (app, lvl) count() c",
    "* | stats min(dur) mn, sum(dur) s, count() c",
    "err | sort by (dur desc) limit 5 | fields dur, app",
    "* | sort by (dur) limit 7 | fields dur, lvl",
    "err | fields _time, app, dur",
    "lvl:err | fields _msg, dur",
    "app:app1 | stats count() c",
    "x7 | fields dur, app",
    # value stats
    "ok | stats by (app) count() c, sum(dur) s, avg(dur) a, min(dur) mn, "
    "max(dur) mx",
    # a window that cuts the first part, covers four and leaves the last
    f"{WINDOW} err | stats by (app) count() c, sum(dur) s",
    f"{WINDOW} x7 | fields _time, dur",
    # a subquery: never cached
    "app:in(lvl:warn | fields app) x5 | stats count() c",
]
PATHS = ["host", "1/1", "4/8"]


def _port(port, qs, path, monkeypatch, ts=TS):
    """(rows, runner counters or None) of one run on `path` at `ts`."""
    if path == "host":
        return P.run(port, P.T, qs, timestamp=ts), None
    inflight, pack = path.split("/")
    monkeypatch.setenv("VL_INFLIGHT", inflight)
    monkeypatch.setenv("VL_PACK_PARTS", pack)
    runner = P.Runner()
    try:
        rows = P.run(port, P.T, qs, timestamp=ts, runner=runner)
    finally:
        runner.close()
    assert runner.cache.check_balanced()
    return rows, runner.stats_counters


def _jax_uncached(jax_st, qs, monkeypatch):
    monkeypatch.setenv("VL_RESULT_CACHE", "0")
    try:
        return jax_run(jax_st, [JLR.TenantID(0, 0)],
                       "options(concurrency=1) " + qs, timestamp=TS)
    finally:
        monkeypatch.setenv("VL_RESULT_CACHE", "1")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("qs", SHAPES)
def test_cache_bit_identity(stores, qs, path, monkeypatch):
    port, jax_st = stores
    cold, _c = _port(port, qs, path, monkeypatch)
    s0 = P.standing.cache_stats()
    warm, c = _port(port, qs, path, monkeypatch)
    s1 = P.standing.cache_stats()
    assert warm == cold
    hits = s1["hits"] - s0["hits"]
    if ":in(" in qs:
        # the subquery's rows are kept and replayed; the outer query,
        # whose values come from it, is never kept
        assert hits == N_PARTS == s0["entries"] == s1["entries"], (s0, s1)
        assert c is None or c["device_parts"] >= 1, c
    elif qs.startswith(WINDOW):
        # the cut part and the part outside the window are never kept
        assert hits == N_PARTS - 2 == s0["entries"], (s0, s1)
    else:
        assert hits == N_PARTS == s0["entries"], (s0, s1)
    if c is not None:
        assert c["result_cache_units"] == hits, c
    monkeypatch.setenv("VL_RESULT_CACHE", "0")
    off, _c = _port(port, qs, path, monkeypatch)
    monkeypatch.setenv("VL_RESULT_CACHE", "1")
    assert off == cold
    want = _jax_uncached(jax_st, qs, monkeypatch)
    assert want, qs
    assert _sorted(cold) == _sorted(want)


# ---------------- replay, the head, paths, merges, top-k ----------------

STATS_Q = "err | stats by (app) count() c, sum(dur) s"


def test_warm_stats_run_launches_nothing(stores, monkeypatch):
    port, _jax_st = stores
    monkeypatch.setenv("VL_INFLIGHT", "4")
    monkeypatch.setenv("VL_PACK_PARTS", "8")
    runner = P.Runner()
    calls = []
    for name in ("prefetch", "run_part_stats_submit", "run_part_stats",
                 "run_part_submit"):
        inner = getattr(runner, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            calls.append(_name)
            return _inner(*a, **kw)
        setattr(runner, name, spy)
    try:
        cold = P.run(port, P.T, STATS_Q, timestamp=TS, runner=runner)
        assert calls and runner.stats_counters["units"] >= 1
        staged = runner.cache.bytes()
        del calls[:]
        for k in runner.stats_counters:
            runner.stats_counters[k] = 0
        warm = P.run(port, P.T, STATS_Q, timestamp=TS, runner=runner)
        c = dict(runner.stats_counters)
        assert runner.cache.bytes() == staged
    finally:
        runner.close()
    assert warm == cold
    assert calls == []
    assert c["units"] == 0 and c["device_parts"] == 0, c
    assert c["result_cache_units"] == N_PARTS, c


@pytest.mark.parametrize("path", ["host", "1/1", "4/8"])
def test_new_batch_misses_alone(monkeypatch, path):
    port = _port_store()
    try:
        cold, _c = _port(port, STATS_Q, path, monkeypatch)
        _add(port, _rows(150, N_PARTS * ROWS_PER_PART, 99), P.LR)
        assert len(_parts(port)) == N_PARTS + 1
        s0 = P.standing.cache_stats()
        warm, c = _port(port, STATS_Q, path, monkeypatch)
        s1 = P.standing.cache_stats()
        assert (s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]) == \
            (N_PARTS, 1)
        if c is not None:
            assert (c["result_cache_units"], c["units"]) == (N_PARTS, 1), c
        monkeypatch.setenv("VL_RESULT_CACHE", "0")
        off, _c = _port(port, STATS_Q, path, monkeypatch)
        assert warm == off and warm != cold
    finally:
        port.close()


def test_device_bitmaps_replay_on_the_host_walk(stores, monkeypatch):
    port, _jax_st = stores
    qs = "err | fields _time, app, dur"
    dev, _c = _port(port, qs, "4/8", monkeypatch)
    h0 = P.standing.cache_stats()["hits"]
    host, _c = _port(port, qs, "host", monkeypatch)
    assert P.standing.cache_stats()["hits"] - h0 == N_PARTS
    assert host == dev


@pytest.mark.parametrize("path", ["host", "4/8"])
def test_force_merge_drops_entries(monkeypatch, path):
    port = _port_store()
    try:
        qs = "err | fields _time, app, dur"
        cold, _c = _port(port, qs, path, monkeypatch)
        old = [weakref.ref(p) for p in _parts(port)]
        assert P.standing.cache_stats()["entries"] == N_PARTS
        port.must_force_merge()
        gc.collect()
        assert all(r() is None for r in old)
        ok, detail = P.standing.cache_check_balanced()
        assert ok, detail
        assert P.standing.cache_stats()["entries"] == 0
        m0 = P.standing.cache_stats()["misses"]
        again, _c = _port(port, qs, path, monkeypatch)
        assert P.standing.cache_stats()["misses"] - m0 == 1
        assert P.standing.cache_stats()["entries"] == 1
        assert _sorted(again) == _sorted(cold)
    finally:
        port.close()


def test_topk_other_k_does_not_hit(stores, monkeypatch):
    port, _jax_st = stores
    q5 = "err | sort by (dur desc) limit 5 | fields dur, app"
    q7 = q5.replace("limit 5", "limit 7")
    _port(port, q5, "1/1", monkeypatch)
    s0 = P.standing.cache_stats()
    got, c = _port(port, q7, "1/1", monkeypatch)
    s1 = P.standing.cache_stats()
    assert s1["hits"] == s0["hits"] and c["result_cache_units"] == 0
    assert s1["misses"] - s0["misses"] == N_PARTS
    monkeypatch.setenv("VL_RESULT_CACHE", "0")
    assert _port(port, q7, "1/1", monkeypatch)[0] == got


# a refresh of a dashboard query whose `_time:5m` sits under NOT or or:
# the first run is at the last row, the second ten minutes later, when
# no row is in the window any more
REFRESH_QUERIES = ["err !_time:5m | fields _time, dur",
                   "(err or _time:5m) | stats by (app) count() c"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("qs", REFRESH_QUERIES)
def test_moving_time_filter_refresh_is_not_stale(stores, qs, path,
                                                monkeypatch):
    port, _jax_st = stores
    now1 = T0 + N_PARTS * ROWS_PER_PART * 10**9
    now2 = now1 + 600 * 10**9
    first, _c = _port(port, qs, path, monkeypatch, ts=now1)
    s0 = P.standing.cache_stats()
    again, c = _port(port, qs, path, monkeypatch, ts=now2)
    s1 = P.standing.cache_stats()
    assert s1["entries"] == 0 and s1["hits"] == s0["hits"], (s0, s1)
    if c is not None:
        assert c["result_cache_units"] == 0, c
    monkeypatch.setenv("VL_RESULT_CACHE", "0")
    off, _c = _port(port, qs, path, monkeypatch, ts=now2)
    assert again == off
    assert _sorted(again) != _sorted(first)
