"""Query spans of the port (obs/tracing.py, `?trace=1`) against the JAX
package.

- The span API: the same calls on both packages build the same tree
  (names, attributes, counters, `flatten`, the children cap and its
  `children_dropped` count); the no-op path is one shared singleton.
- The span tree of a query over many small parts of one day (the JAX
  package's tests/test_obs.py store): the port's span names and their
  counts under each parent equal the JAX package's for the same query
  at VL_INFLIGHT=4, VL_PACK_PARTS=8 (query -> partition, pipeline ->
  prune, stage, submit, harvest -> device_sync, emit); submits and
  harvests pair up by unit; packed submits name their members.
- An untraced query, through the runner and through each handler,
  makes no span (`spans_created()` does not move).
- No span stays open after a satisfied limit stops the window, nor
  after an error in a submit (which the span records).
- `?trace=1`: handle_query's row lines are byte-identical to the
  untraced answer, then one `{"_trace": {...}}` line; the other
  handlers add a "trace" key and are otherwise unchanged.
"""

import json

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.obs import tracing as JT
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu.batch import BatchRunner

T0 = 1_753_660_800_000_000_000  # 2025-07-28T00:00:00Z
N_PARTS = 12
ROWS_PER_PART = 600
VOCAB = ("query", "partition", "pipeline", "prune", "stage", "submit",
         "harvest", "device_sync", "emit")

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = PT = sel = run_query_collect = TLR = TorchBatchRunner = None


def _load_port():
    global torch, PT, sel, run_query_collect, TLR, TorchBatchRunner
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.obs import tracing as PT
    from victorialogs_tpu_torch.server import vlselect as sel
    from victorialogs_tpu_torch.storage import log_rows as TLR


@pytest.fixture(autouse=True)
def _torch_threads(monkeypatch):
    _load_port()
    monkeypatch.setenv("VL_INFLIGHT", "4")
    monkeypatch.setenv("VL_PACK_PARTS", "8")
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """N_PARTS small flushed parts in one partition, in both packages
    (tests/test_obs.py's rows)."""
    _load_port()
    from victorialogs_tpu_torch.storage.storage import Storage
    port = Storage(retention_days=100000, device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("obsstore")),
                        retention_days=100000, flush_interval=3600)
    n = 0
    for _p in range(N_PARTS):
        lr = TLR.LogRows(stream_fields=["app"])
        jl = JLR.LogRows(stream_fields=["app"])
        for _i in range(ROWS_PER_PART):
            g = n
            n += 1
            fields = [("app", f"app{g % 4}"),
                      ("_msg", f"GET /api/x{g % 7} "
                               f"{'error' if g % 3 == 0 else 'ok'} "
                               f"d={g % 97}"),
                      ("lvl", ["info", "warn", "error"][g % 3]),
                      ("dur", str(g % 251))]
            lr.add(TLR.TenantID(0, 0), T0 + g * 50_000_000, fields)
            jl.add(JLR.TenantID(0, 0), T0 + g * 50_000_000, fields)
        port.must_add_rows(lr)
        port.debug_flush()
        jax_st.must_add_rows(jl)
        jax_st.debug_flush()
    yield port, jax_st
    jax_st.close()
    port.close()


def _tenants():
    return [TLR.TenantID(0, 0)]


def _traced(port, q, runner):
    root = PT.make_root("query", query=q)
    with PT.activate(root):
        rows = run_query_collect(port, _tenants(), q, runner=runner)
    return rows, root


def _edges(tree: dict, vocab=VOCAB) -> dict:
    """{(parent name, child name): count} over the tree's spans named in
    `vocab`."""
    out: dict = {}

    def walk(node):
        for c in node.get("children", ()):
            if c["name"] in vocab:
                key = (node["name"], c["name"])
                out[key] = out.get(key, 0) + 1
            walk(c)

    walk(tree)
    return out


def _find(tree: dict, name: str) -> list:
    out = []

    def walk(n):
        if n.get("name") == name:
            out.append(n)
        for c in n.get("children", ()):
            walk(c)

    walk(tree)
    return out


# ---------------- the span API ----------------

def _build(mod):
    root = mod.make_root("q", query="x")
    with mod.activate(root):
        sp = mod.current_span()
        assert sp is root
        with sp.span("child", unit=1) as c:
            c.add("n")
            c.add("n", 2)
            c.set("k", "v")
            with c.span("grandchild"):
                assert mod.current_span().name == "grandchild"
            assert mod.current_span() is c
        for _ in range(mod.MAX_CHILDREN + 2):
            with sp.span("many"):
                pass
    return root


def _shape(tree: dict) -> dict:
    out = {"name": tree["name"], "attrs": tree.get("attrs")}
    kids = [_shape(c) for c in tree.get("children", ())]
    if kids:
        out["children"] = kids
    return out


def test_span_api_matches_jax():
    got, want = _build(PT), _build(JT)
    assert _shape(got.to_dict()) == _shape(want.to_dict())
    assert got.attrs["children_dropped"] == 3
    assert {k: v["count"] for k, v in got.flatten().items()} == \
        {k: v["count"] for k, v in want.flatten().items()}
    assert got.open_spans() == want.open_spans() == 0
    assert PT.current_span() is PT._NOOP


def test_error_is_recorded_on_the_span():
    root = PT.make_root("q")
    with pytest.raises(KeyError):
        with PT.activate(root):
            with PT.current_span().span("inner"):
                raise KeyError("x")
    assert root.attrs["error"] == "KeyError"
    assert root.children[0].attrs["error"] == "KeyError"
    assert root.open_spans() == 0


def test_noop_path_is_shared_and_makes_no_span():
    before = PT.spans_created()
    sp = PT.current_span()
    assert sp is PT.current_span() and not sp.enabled
    ctx = sp.span("x", unit=1)
    assert ctx is sp.span("y")
    with ctx as inner:
        assert inner is sp
        inner.add("n")
        inner.set("k", 1)
    with PT.activate(None) as r:
        assert r is None and PT.current_span() is sp
    assert sp.to_dict() == {} and sp.flatten() == {}
    assert PT.spans_created() == before


# ---------------- the query's tree ----------------

@pytest.mark.parametrize("q", ["error | fields _time",
                               "* | stats by (lvl) count() hits"])
def test_span_tree_matches_jax(stores, q):
    port, jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    jr = BatchRunner()
    try:
        rows, root = _traced(port, q, runner)
        jroot = JT.make_root("query", query=q)
        with JT.activate(jroot):
            jrows = jax_run(jax_st, [JLR.TenantID(0, 0)], q, runner=jr)
    finally:
        jr.close()
        runner.close()
    assert sorted(map(str, rows)) == sorted(map(str, jrows))
    tree, jtree = root.to_dict(), jroot.to_dict()
    assert tree["attrs"]["query"] == q
    assert _edges(tree) == _edges(jtree)
    assert root.open_spans() == jroot.open_spans() == 0
    assert _find(tree, "pipeline")[0]["attrs"]["inflight_depth"] == 4
    subs, harvs = _find(tree, "submit"), _find(tree, "harvest")
    assert [s["attrs"]["unit"] for s in subs] == \
        [h["attrs"]["unit"] for h in harvs] == list(range(len(subs)))
    members = [m for s in subs for m in s["attrs"].get("pack_members", ())]
    assert all(s["attrs"]["pack_size"] == len(s["attrs"]["pack_members"])
               > 1 for s in subs if "pack_size" in s["attrs"])
    assert len(members) == len(set(members)) == N_PARTS
    # every span inside its parent's window
    def check(n, lo, hi):
        t0, t1 = n["start_ms"], n["start_ms"] + n["duration_ms"]
        assert t0 >= lo - 0.5 and t1 <= hi + 0.5, n["name"]
        for c in n.get("children", ()):
            check(c, t0, t1)
    check(tree, 0.0, tree["duration_ms"])


@pytest.mark.parametrize("q", ["error | fields _time",
                               "* | stats by (lvl) count() hits",
                               "error | sort by (dur desc) limit 5"])
def test_untraced_query_makes_no_span(stores, q):
    port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    try:
        run_query_collect(port, _tenants(), q, runner=runner)
        before = PT.spans_created()
        run_query_collect(port, _tenants(), q, runner=runner)
        run_query_collect(port, _tenants(), q)
        args = {"query": q.split(" | ")[0] if "sort" in q else q}
        if "stats" in q:
            sel.handle_stats_query(port, args, {}, runner=runner)
            sel.handle_stats_query_range(port, args, {}, runner=runner)
        else:
            sel.handle_query(port, args, {}, runner=runner)
            sel.handle_hits(port, dict(args, step="1h"), {}, runner=runner)
        assert PT.spans_created() == before
    finally:
        runner.close()


def test_no_span_open_after_a_limit(stores):
    port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    try:
        rows, root = _traced(port, "ok | limit 3", runner)
    finally:
        runner.close()
    assert len(rows) == 3
    assert root.open_spans() == 0
    assert runner.cache.check_balanced()
    assert len(_find(root.to_dict(), "submit")) <= 4


def test_no_span_open_after_a_failed_submit(stores, monkeypatch):
    port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    inner = runner.run_part_submit
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("submit failed")
        return inner(*a)
    runner.run_part_submit = failing
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    root = PT.make_root("query")
    try:
        with pytest.raises(RuntimeError, match="submit failed"):
            with PT.activate(root):
                run_query_collect(port, _tenants(), "error", runner=runner)
    finally:
        runner.close()
    assert root.open_spans() == 0
    assert root.attrs["error"] == "RuntimeError"
    assert _find(root.to_dict(), "submit")[1]["attrs"]["error"] == \
        "RuntimeError"
    assert runner.cache.check_balanced()


# ---------------- ?trace=1 ----------------

def test_trace_lines_byte_identical(stores):
    port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    try:
        for q in ("error", "ok | fields _time, dur"):
            plain = sel.handle_query(port, {"query": q}, {}, runner=runner)
            traced = sel.handle_query(port, {"query": q, "trace": "1"}, {},
                                      runner=runner)
            assert plain and traced[:-1] == plain
            last = json.loads(traced[-1])
            assert list(last) == ["_trace"]
            tree = last["_trace"]
            assert tree["name"] == "query"
            assert tree["attrs"]["query"] == q + " | limit 1000" or \
                tree["attrs"]["query"].endswith("limit 1000")
            assert _find(tree, "pipeline") and _find(tree, "partition")
    finally:
        runner.close()


@pytest.mark.parametrize("handler,args", [
    ("handle_stats_query", {"query": "error | stats by (app) count() c",
                            "time": "2025-07-29T00:00:00Z"}),
    ("handle_hits", {"query": "error", "step": "1h", "field": "app"}),
    ("handle_stats_query_range", {"query": "error | stats count() c",
                                  "step": "1m"}),
])
@pytest.mark.parametrize("flag", ["1", "true", "yes"])
def test_trace_key_of_the_json_answers(stores, handler, args, flag):
    port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    fn = getattr(sel, handler)
    try:
        plain = fn(port, dict(args), {}, runner=runner)
        traced = fn(port, dict(args, trace=flag), {}, runner=runner)
        assert "trace" not in plain
        tree = traced.pop("trace")
        assert traced == plain
        assert tree["name"] == "query"
        assert _find(tree, "submit") and _find(tree, "emit")
        off = fn(port, dict(args, trace="0"), {}, runner=runner)
        assert off == plain
    finally:
        runner.close()
