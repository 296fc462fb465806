"""The port's span counters and the stream index's filter cache against
the JAX package.

- Span counters on one UTC day of seeded generator rows: the host
  walk's `blocks_candidate`, `blocks_out` and `rows_out`, and the device
  path's `blocks_probed_bloom`, `blocks_killed_bloom`, `blocks_out` and
  `rows_downloaded`, summed over the trace, equal the JAX package's
  traced run of the same query (its host walk at concurrency 1, its
  BatchRunner); the JAX store is written with VL_FILTER_INDEX=v1, so
  its bloom probes read the same blooms as the port's.  A direct
  `bloom_keep_mask` counts as JAX's, over every block or every other.
- `staged_entries` equals the number of values the runner's staging
  cache took during a traced query, `staged_bytes` their cost; a second
  run stages nothing; an untraced query, warm result cache included,
  makes no span.
- TwoGenCache (utils/cache.py) gives the JAX package's hits, misses and
  sizes under a patched clock and a seeded `random`: promotion on a hit
  in the previous generation, rotation, and the clear after an idle
  period.
- IndexDB's filter cache: a repeated `_stream:` search is a hit, equal
  to the uncached answer; a registration of a new stream, a new level
  and a merge clear it, re-registering a known stream does not.
"""

import random
from types import SimpleNamespace

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.obs import tracing as JT
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu.batch import BatchRunner
from victorialogs_tpu.utils import cache as JC
from victorialogs_tpu.utils.hashing import stream_id_hash

from victorialogs_tpu_torch.cli.vlogsgenerator import generate

T0 = 1_753_660_800_000_000_000  # 2025-07-28T00:00:00Z
HOUR = 3600 * 10**9
PART_ROWS = (2000, 1500, 2500)

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = P = None


def _load_port():
    global torch, P
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.engine import standing
    from victorialogs_tpu_torch.gpu import batch
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.storage import indexdb, log_rows
    from victorialogs_tpu_torch.storage.storage import Storage
    from victorialogs_tpu_torch.storage.stream_filter import (StreamFilter,
                                                              TagFilter)
    from victorialogs_tpu_torch.utils import cache
    P = SimpleNamespace(run=run_query_collect, standing=standing,
                        tracing=tracing, IDX=indexdb, LR=log_rows,
                        Storage=Storage, SF=StreamFilter, TF=TagFilter,
                        cache=cache, T=[log_rows.TenantID(0, 0)],
                        Runner=lambda: batch.TorchBatchRunner(device="cpu"))


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Three flushed parts of generator rows in one UTC day, in both
    packages (`quota` only in apps 0 and 1, so its bloom rules out the
    blocks of the other apps)."""
    _load_port()
    port = P.Storage(retention_days=100000, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VL_FILTER_INDEX", "v1")
        jax_st = JS.Storage(str(tmp_path_factory.mktemp("ctrstore")),
                            retention_days=100000, flush_interval=3600)
        for k, n in enumerate(PART_ROWS):
            rows = generate(n, 40 + k, T0 + k * 4 * HOUR, 4 * HOUR,
                            streams=16)
            lr = P.LR.LogRows(stream_fields=["app", "host"])
            jl = JLR.LogRows(stream_fields=["app", "host"])
            for ts, fields in rows:
                lr.add(P.LR.TenantID(0, 0), ts, fields)
                jl.add(JLR.TenantID(0, 0), ts, fields)
            port.must_add_rows(lr)
            port.debug_flush()
            jax_st.must_add_rows(jl)
            jax_st.debug_flush()
    yield port, jax_st
    jax_st.close()
    port.close()


def _sum(tree: dict, key: str) -> int:
    n = tree.get("attrs", {}).get(key, 0)
    return n + sum(_sum(c, key) for c in tree.get("children", ()))


def _port_traced(port, q, runner):
    root = P.tracing.make_root("query", query=q)
    with P.tracing.activate(root):
        rows = P.run(port, P.T, q, runner=runner)
    return rows, root.to_dict()


def _jax_traced(jax_st, q, runner):
    root = JT.make_root("query", query=q)
    with JT.activate(root):
        rows = jax_run(jax_st, [JLR.TenantID(0, 0)], q, runner=runner)
    return rows, root.to_dict()


def _sorted(rows):
    return sorted(map(str, rows))


HOST_QUERIES = ["quota", "error | stats count() c",
                "quota timeout | fields _time, app", "quota:nomatch"]


@pytest.mark.parametrize("q", HOST_QUERIES)
def test_host_walk_counters_match_jax(stores, q):
    port, jax_st = stores
    rows, tree = _port_traced(port, q, None)
    jrows, jtree = _jax_traced(jax_st, "options(concurrency=1) " + q, None)
    assert _sorted(rows) == _sorted(jrows)
    got = {k: _sum(tree, k) for k in ("blocks_candidate", "blocks_out",
                                      "rows_out")}
    assert got == {k: _sum(jtree, k) for k in got}
    assert got["blocks_candidate"] > 0


DEVICE_QUERIES = ["quota", "quota | stats by (app) count() c",
                  "quota error | fields _time, dur", "error"]


@pytest.mark.parametrize("inflight,pack", [("1", "1"), ("4", "8")])
@pytest.mark.parametrize("q", DEVICE_QUERIES)
def test_device_counters_match_jax(stores, q, inflight, pack, monkeypatch):
    port, jax_st = stores
    monkeypatch.setenv("VL_INFLIGHT", inflight)
    monkeypatch.setenv("VL_PACK_PARTS", pack)
    monkeypatch.setenv("VL_FILTER_INDEX", "v1")
    runner, jr = P.Runner(), BatchRunner()
    try:
        rows, tree = _port_traced(port, q, runner)
        jrows, jtree = _jax_traced(jax_st, q, jr)
    finally:
        jr.close()
        runner.close()
    assert _sorted(rows) == _sorted(jrows)
    keys = ("blocks_probed_bloom", "blocks_killed_bloom", "blocks_out",
            "rows_downloaded")
    got = {k: _sum(tree, k) for k in keys}
    assert got == {k: _sum(jtree, k) for k in keys}
    if q.startswith("quota"):
        assert 0 < got["blocks_killed_bloom"] < got["blocks_probed_bloom"]
    else:
        # `error` is in every block: each probed, none ruled out
        assert got["blocks_probed_bloom"] > 0 == got["blocks_killed_bloom"]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("token", ["quota", "error", "nomatch"])
def test_bloom_probe_counters_match_jax(stores, token, stride,
                                        monkeypatch):
    """A direct probe over every `stride`-th block counts as JAX's
    does: each block probed once."""
    from victorialogs_tpu.storage import filterbank as JFB
    from victorialogs_tpu.utils.hashing import hash_tokens as jax_hash
    from victorialogs_tpu_torch.storage import filterbank as PFB
    from victorialogs_tpu_torch.utils.hashing import hash_tokens
    monkeypatch.setenv("VL_FILTER_INDEX", "v1")
    port, jax_st = stores
    keys = ("blocks_probed_bloom", "blocks_killed_bloom")
    got, want = [], []
    pparts = [p for pt in port.partitions.values() for p in pt.parts]
    jparts = [p for pt in jax_st.partitions.values()
              for p in pt.ddb.snapshot_parts()]
    assert len(pparts) == len(jparts) == len(PART_ROWS)
    for pp, jp in zip(pparts, jparts):
        bis = list(range(0, pp.num_blocks, stride))
        root = P.tracing.make_root("probe")
        with P.tracing.activate(root):
            keep = PFB.bloom_keep_mask(pp, "_msg", hash_tokens([token]),
                                       bis)
        jroot = JT.make_root("probe")
        with JT.activate(jroot):
            jkeep = JFB.bloom_keep_mask(jp, "_msg", jax_hash([token]), bis)
        assert keep.tolist() == jkeep.tolist()
        got.append({k: root.attrs.get(k, 0) for k in keys})
        want.append({k: jroot.attrs.get(k, 0) for k in keys})
    assert got == want
    assert sum(g["blocks_probed_bloom"] for g in got) == \
        sum(len(range(0, p.num_blocks, stride)) for p in pparts)


@pytest.mark.parametrize("q", ["quota | stats by (app) count() c",
                               "error | fields dur",
                               "quota | sort by (dur desc) limit 3"])
def test_staged_counters(stores, q, monkeypatch):
    port, _jax_st = stores
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    runner = P.Runner()
    try:
        _rows, tree = _port_traced(port, q, runner)
        taken = len(runner.cache._lru)
        assert taken > 0
        assert _sum(tree, "staged_entries") == taken
        assert _sum(tree, "staged_bytes") == runner.cache.bytes()
        _rows, tree = _port_traced(port, q, runner)
        assert _sum(tree, "staged_entries") == 0
        assert _sum(tree, "staged_bytes") == 0
    finally:
        runner.close()


@pytest.mark.parametrize("runner_on", [True, False])
def test_untraced_query_makes_no_span(stores, runner_on, monkeypatch):
    port, _jax_st = stores
    monkeypatch.setenv("VL_RESULT_CACHE", "1")
    P.standing.reset_for_tests()
    runner = P.Runner() if runner_on else None
    try:
        for q in ("quota | stats count() c", "quota | fields dur"):
            P.run(port, P.T, q, runner=runner)
            before = P.tracing.spans_created()
            P.run(port, P.T, q, runner=runner)
            assert P.tracing.spans_created() == before
        assert P.standing.cache_stats()["hits"] > 0
    finally:
        if runner is not None:
            runner.close()
        P.standing.reset_for_tests()


# ---------------- TwoGenCache ----------------

def _twogen_sequence(mod, monkeypatch) -> list:
    clock = [1000.0]
    monkeypatch.setattr(mod, "time", SimpleNamespace(
        monotonic=lambda: clock[0]))
    monkeypatch.setattr(mod, "random", random.Random(5))
    c = mod.TwoGenCache(rotate_seconds=10)
    out = []

    def step(*ops):
        for op in ops:
            if op[0] == "put":
                c.put(op[1], op[2])
            elif op[0] == "get":
                out.append(c.get(op[1]))
            else:
                clock[0] += op[1]
        out.append((c.hits, c.misses, len(c), sorted(c._curr),
                    sorted(c._prev)))

    step(("put", "a", 1), ("put", "b", 2), ("get", "a"), ("get", "z"))
    step(("tick", 9.5), ("get", "b"))              # jittered: maybe rotated
    step(("tick", 2.0), ("get", "a"), ("put", "c", 3))  # promote a
    step(("tick", 11.5), ("get", "b"), ("get", "c"))
    step(("tick", 11.5), ("get", "a"))
    step(("tick", 35.0), ("get", "a"), ("get", "c"))  # idle: cleared
    step(("put", "d", 4), ("get", "d"))
    c.clear()
    step(("get", "d"))
    return out


def test_twogen_cache_matches_jax(monkeypatch):
    got = _twogen_sequence(P.cache, monkeypatch)
    want = _twogen_sequence(JC, monkeypatch)
    assert got == want
    hits, misses = got[-1][0], got[-1][1]
    assert hits >= 4 and misses >= 4


# ---------------- the index's filter cache ----------------

def _mk(i):
    tags = f'{{app="app{i % 7}",host="h{i}"}}'
    hi, lo = stream_id_hash(f"0:0:{tags}".encode())
    return P.LR.StreamID(P.LR.TenantID(0, 0), hi, lo), tags


def test_index_filter_cache(tmp_path):
    db = P.IDX.IndexDB(str(tmp_path / "idx"))
    try:
        sf = P.SF(((P.TF("app", "=", "app3"),),))
        rx = P.SF(((P.TF("host", "=~", "h1.*"),),))
        tenants = P.T
        fc = db._filter_cache

        def search(f):
            return db.search_stream_ids(tenants, f)

        def uncached(f):
            fc.clear()
            got = search(f)
            fc.clear()
            return got

        db.must_register_streams([_mk(i) for i in range(40)])
        want = uncached(sf)
        assert len(want) == 6
        h0 = fc.hits
        assert search(sf) == want and search(sf) == want
        assert fc.hits == h0 + 1 and len(fc) == 1
        # a known stream again: nothing written, the entry stays
        db.must_register_streams([_mk(3)])
        assert len(fc) == 1 and search(sf) == want
        # a new stream clears, and the answer sees it
        db.must_register_streams([_mk(45)])
        assert len(fc) == 0
        want = search(sf)
        assert len(want) == 7 and want == uncached(sf)
        search(sf)
        search(rx)
        # the tail becomes a level: cleared
        db.force_merge()
        assert len(fc) == 0 and len(db._snaps) == 1
        assert search(sf) == want and search(rx) == uncached(rx)
        db.must_register_streams([_mk(i) for i in range(46, 60)])
        search(sf)
        # a second level, then the merge of both: cleared
        db._flush_tail()
        assert len(fc) == 0
        search(sf)
        db.force_merge()
        assert len(fc) == 0 and len(db._snaps) == 1
        assert search(sf) == uncached(sf) and len(search(sf)) == 9
    finally:
        db.close()
