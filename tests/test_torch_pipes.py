"""The port's row pipes, `stats` after another pipe, the sort top-k
prefilter and the hits / stats_query_range handlers against the JAX
package.

The same seeded rows (one UTC day, strictly increasing timestamps) go
into both packages' storage.  Every comparison is exact:

- parsing: `parse_query(q).to_string()` of every ported pipe and alias,
  and the ParseError messages, equal the JAX package's;
- rows: each query returns the JAX host executor's rows through the
  port's host executor and through TorchBatchRunner(device="cpu");
- the top-k prefilter (`run_part_topk`): ascending and descending
  sorts, `offset`, ties at the k-th key, fewer matches than k, maybe
  rows above the threshold (values truncated past a 32-byte staging)
  and every decline (a sort field that is not int-typed in a candidate
  block, a part's range over 2**31 - 2, a tree the planner declines,
  k > MAX_TOPK, `partition by`, `_time`, two sort fields), each pinned
  by the runner's `topk_parts` / `topk_declines`;
- `handle_hits` and `handle_stats_query_range` equal the JAX handlers
  (less their `trace` and `partial` keys), 400 on a bad step, answer
  through the storage's runner by default and raise without CUDA.
"""

import weakref

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.server import vlselect as jsel
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)
from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID

T = [TenantID(0, 0)]
JT = [JLR.TenantID(0, 0)]

# torch and the torch-importing modules of the port load on first use,
# in the worker that runs these tests, not in every collecting worker
torch = Storage = TorchBatchRunner = run_query_collect = None
parse_query = sel = None


def _load_port():
    global torch, Storage, TorchBatchRunner, run_query_collect
    global parse_query, sel
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.logsql.parser import parse_query
    from victorialogs_tpu_torch.server import vlselect as sel
    from victorialogs_tpu_torch.storage.storage import Storage


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _ingest(rows, stream_fields, flushes, jax_path):
    port = Storage(device="cpu")
    jax_st = JS.Storage(jax_path)
    per = -(-len(rows) // flushes)
    for k in range(flushes):
        lr = LogRows(stream_fields=stream_fields)
        jl = JLR.LogRows(stream_fields=stream_fields)
        for ts, fields in rows[k * per:(k + 1) * per]:
            lr.add(TenantID(0, 0), ts, fields)
            jl.add(JLR.TenantID(0, 0), ts, fields)
        port.must_add_rows(lr)
        port.debug_flush()
        jax_st.must_add_rows(jl)
        jax_st.debug_flush()
    return port, jax_st


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The generator's rows (chip_smoke.py's store, cut to 20k rows)."""
    _load_port()
    start = today_start_ns()
    rows = generate(20000, 5, start, NS_PER_DAY // 2, streams=16)
    port, jax_st = _ingest(rows, ["app", "host"], 4,
                           str(tmp_path_factory.mktemp("jaxpipes")))
    yield start, port, jax_st
    jax_st.close()
    port.close()


EDGE_ROWS = 1800
EDGE_PARTS = 3


def _edge_rows(start: int) -> list:
    """Rows for the prefilter's edges, in two streams: `dur` takes 40
    values, each in 45 rows (ties at every k; too many values for a
    dict column), `v` ~1,000, `big` spans 0-2.4e9 in every
    part (over the score range), `mixed` is an int in stream a0 and a
    string in a1, `lat` a float; every 7th `_msg` is 48 bytes of padding
    then `needle`, a maybe row under a 32-byte staging."""
    out = []
    for i in range(EDGE_ROWS):
        if i % 7 == 0:
            msg = "pad " * 12 + f"needle n{i}"
        elif i % 3 == 0:
            msg = f"needle short n{i}"
        else:
            msg = f"hay n{i}"
        app = f"a{i % 2}"
        out.append((start + 1000 * i, [
            ("_msg", msg), ("app", app), ("dur", str(i % 40 * 3)),
            ("v", str(i * 7919 % 1000)), ("big", str(i % 600 * 4_000_000)),
            ("mixed", str(i) if app == "a0" else "n/a"),
            ("lat", f"{i % 97}.5")]))
    return out


@pytest.fixture(scope="module")
def edge_stores(tmp_path_factory):
    _load_port()
    start = today_start_ns()
    port, jax_st = _ingest(_edge_rows(start), ["app"], EDGE_PARTS,
                           str(tmp_path_factory.mktemp("jaxtopk")))
    yield port, jax_st
    jax_st.close()
    port.close()


# ---------------- parsing ----------------

PARSE_CASES = [
    "x | sort by (a)", "x | sort by (a desc, b asc) desc",
    "x | order by (a) limit 5 offset 2", "x | sort by (a) rank as r",
    "x | sort by (a) rank r", "x | sort by (a) partition by (b, c) limit 1",
    "x | sort partition (b) limit 1", "x | sort desc", "x | sort",
    "x | first", "x | first 5", "x | last 2 by (a, b desc)",
    "x | first by (a)", "x | last", "x | uniq", "x | uniq by (a, b)",
    "x | uniq by (a) with hits limit 3", "x | uniq limit 2",
    "x | uniq by (_time:1h)", "x | where a:1", "x | filter a:>5 or b:c",
    "x | where *", "x | where _time:>2026-01-01Z and app:=a",
    "x | delete a", "x | del a, b", "x | rm a*", "x | drop a",
    "x | copy a as b, c d", "x | cp a b", "x | rename a as b",
    "x | mv a b, c as d", "x | limit 2 | stats count()",
    "x | count() as n | sort by (n)", "x | where y | count()",
    "x | fields a | uniq by (a) | stats count()",
    "x | head 3 | skip 1 | keep a | stats by (_time:1h offset 5m, a) "
    "count() c",
    "x | first 3 | last 2 | sort by (a) desc limit 1 rank as n",
]


@pytest.mark.parametrize("q", PARSE_CASES)
def test_parse_matches_jax(q):
    assert parse_query(q).to_string() == jax_parse(q).to_string()


@pytest.mark.parametrize("q", [
    "x | sort by a", "x | sort partition by a", "x | first x",
    "x | first 2 by a", "x | uniq by a", "x | sort limit -1",
    "x | sort offset y", "x | uniq limit z", "x | where",
    "x | copy", "x | rename a", "x | delete", "x | sort by (a",
    "x | first 1.5", "x | where (a", "x | sort rank", "x | last -2",
    "x | cp a as", "x | stats count() | sort by", "x | limit 1 | stats",
])
def test_parse_errors_match_jax(q):
    from victorialogs_tpu_torch.logsql.pipes import ParseError
    # the JAX package has a ParseError in its parser and one in its pipes
    with pytest.raises(ValueError) as je:
        jax_parse(q)
    assert type(je.value).__name__ == "ParseError"
    with pytest.raises(ParseError) as e:
        parse_query(q)
    assert str(e.value) == str(je.value)


# ---------------- rows ----------------

def _row_queries() -> list:
    return [
        # chip_smoke.py's slice queries
        "error | sort by (dur) desc limit 10",
        "error | first 5 by (dur)",
        "quota | last 3 by (dur)",
        "quota | uniq by (app, lvl) with hits",
        "quota | where dur:>1000 | stats by (app) count()",
        "quota | copy app as app2 | rename lvl as level | delete user "
        "| limit 1000",
        # sorts the prefilter takes or declines
        "* | sort by (dur) limit 7",
        "error | sort by (dur) offset 3 limit 4 rank as r",
        "error | sort by (lat) limit 3",
        "quota | sort by (app, dur desc) partition by (lvl) limit 2",
        "quota | first 3", "quota | last 2",
        "error | sort by (dur) | limit 3",
        "error | stats by (app) count() as n | sort by (n) desc",
        # uniq
        "quota | uniq by (app) limit 3 with hits",
        "quota | uniq by (app) limit 30 with hits",
        "quota | fields app, lvl | uniq",
        "quota | where lvl:in(error,warn) | uniq by (lvl) with hits",
        # where, copy/rename/delete, stats after another pipe
        'error | where app:~"app-[12]" | limit 5',
        "quota | where _time:>2026-01-01T00:00:00Z | stats count()",
        "quota | rename _msg as m | where m:timeout | stats by (lvl) "
        "count()",
        "error | copy app as _time | stats by (_time:1h) count()",
        "error | uniq by (app) | stats count()",
        "error | limit 10 | stats by (_time:1h) count()",
        "error | sort by (app) limit 2 | stats by (_time:1h) count()",
        "quota | delete _stream, _stream_id, user | cp dur d "
        "| where d:>60000 | fields d, app",
        'quota | where _stream:{app="app-1"} | stats count() c',
        "warn | where eq_field(lvl) | limit 2",
    ]


@pytest.mark.parametrize("qi", range(len(_row_queries())))
def test_rows_match_jax(stores, qi):
    _start, port, jax_st = stores
    q = _row_queries()[qi]
    want = jax_run(jax_st, JT, q)
    assert run_query_collect(port, T, q) == want, q
    runner = TorchBatchRunner(device="cpu")
    assert run_query_collect(port, T, q, runner=runner) == want, q
    c = runner.stats_counters
    assert c["device_parts"] > 0 and c["host_parts"] == 0
    runner.close()


@pytest.mark.parametrize("q", [
    "re(foo) | sort by (dur) desc limit 5", "x:>5 | uniq by (app)",
    "foo | sort by (_time)", "seq(a, b) | where x:=1",
    "in(a, b) | copy app as app2", "foo | limit 5 | uniq by (x)",
])
def test_pipes_once_outside_the_port_match_jax(stores, q):
    """The queries that pinned these pipes as unsupported before the port
    had them: the same rows and the same canonical form as JAX."""
    _start, port, jax_st = stores
    assert parse_query(q).to_string() == jax_parse(q).to_string()
    want = jax_run(jax_st, JT, q)
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    assert run_query_collect(port, T, q, runner=runner) == want
    runner.close()


def test_row_queries_cover_the_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mine = set(_row_queries())
    names = [name for name, _q, _k, _topk in smoke.slice_queries()]
    assert len(names) == 6
    assert all(q in mine for _n, q, _k, _t in smoke.slice_queries())


def test_stats_after_a_pipe_reduces_on_the_host(stores):
    """`stats` after another pipe filters on the card and reduces on the
    host: the device stats shape declines, no count launches."""
    from victorialogs_tpu_torch.gpu.stats_device import device_stats_spec
    from victorialogs_tpu_torch.logsql.pipes import compute_needed_fields
    q = parse_query("quota | where dur:>1000 | stats by (app) count()")
    assert device_stats_spec(q) is None
    assert compute_needed_fields(q.pipes) == {"app", "dur"}
    assert compute_needed_fields(parse_query(
        "x | rename a as b | fields b").pipes) == {"a"}
    assert compute_needed_fields(parse_query(
        "x | copy a as b | fields b, c").pipes) == {"a", "c"}
    assert compute_needed_fields(parse_query(
        "x | delete a | uniq by (a, b)").pipes) == {"b"}


def test_full_sort_is_held_to_its_memory_budget(stores, monkeypatch):
    """A full sort fails past its budget; a `limit` sort keeps only its
    k rows and stays under the same budget."""
    from victorialogs_tpu_torch.utils import memory
    _start, port, jax_st = stores
    monkeypatch.setattr(memory, "allowed", lambda: 100000)
    with pytest.raises(memory.QueryMemoryError):
        run_query_collect(port, T, "* | sort by (dur)")
    q = "* | sort by (dur) limit 3"
    assert run_query_collect(port, T, q) == jax_run(jax_st, JT, q)


# ---------------- the top-k prefilter ----------------

def _topk_run(port, jax_st, q, runner=None):
    """The port's rows through a cpu runner, held to the JAX host
    executor's and the port's own host executor's; the runner."""
    runner = runner or TorchBatchRunner(device="cpu")
    want = jax_run(jax_st, JT, q)
    assert run_query_collect(port, T, q) == want, q
    assert run_query_collect(port, T, q, runner=runner) == want, q
    assert runner.stats_counters["host_parts"] == 0
    return want, runner


@pytest.mark.parametrize("q", [
    "needle | sort by (v) limit 5",
    "needle | sort by (v) desc limit 5",
    "needle | sort by (v) offset 4 limit 3",
    "needle | sort by (v desc) desc limit 6 rank as r",
    # every dur value repeats: ties at the k-th key
    "* | sort by (dur) limit 7",
    "* | sort by (dur) desc limit 9 rank as r",
    "needle | sort by (dur desc) limit 4",
    "hay | first 3 by (v)",
    "hay | last 3 by (dur)",
    # fewer matches than k, and k past a part's rows
    "n7 | sort by (v) limit 50",
    "* | sort by (v) limit 4096",
    # the int stream's blocks alone are candidates
    '_stream:{app="a0"} | sort by (mixed) desc limit 3',
])
def test_topk_prefilter_matches_jax(edge_stores, q):
    port, jax_st = edge_stores
    want, runner = _topk_run(port, jax_st, q)
    assert want
    c = runner.stats_counters
    assert c["topk_parts"] == c["device_parts"] > 0
    assert c["topk_declines"] == 0
    runner.close()


def test_topk_keeps_maybe_rows_above_the_threshold(edge_stores,
                                                   monkeypatch):
    """Under a 32-byte staging the padded `needle` rows are maybe rows:
    those at or above a part's threshold reach the host, which settles
    them, and they are in the answer."""
    from victorialogs_tpu_torch.gpu import layout
    monkeypatch.setattr(layout, "MAX_ROW_WIDTH", 32)
    port, jax_st = edge_stores
    want, runner = _topk_run(port, jax_st,
                             "needle | sort by (v) desc limit 12")
    c = runner.stats_counters
    assert c["topk_parts"] == EDGE_PARTS and c["maybe_rows"] > 0
    # fewer than every padded row: the threshold cut the maybe rows too
    assert c["maybe_rows"] < EDGE_ROWS // 7
    assert any(r["_msg"].startswith("pad ") for r in want)
    runner.close()


@pytest.mark.parametrize("q,reason", [
    ("* | sort by (big) limit 3", "range"),
    ("* | sort by (mixed) limit 3", "type"),
    ("* | sort by (lat) desc limit 3", "type"),
    ("needle lat:>50 | sort by (v) limit 3", "planner"),
    ("* | sort by (v) limit 4097", "spec"),
    ("* | sort by (v) partition by (app) limit 2", "spec"),
    ("* | sort by (_time) desc limit 2", "spec"),
    ("hay | first 2", "spec"),
    ("* | sort by (v, dur) limit 2", "spec"),
])
def test_topk_declines(edge_stores, q, reason):
    """Each shape the prefilter declines still equals JAX: a part's
    decline (`topk_declines`, then `run_part`), or no device sort shape
    at all (neither counter moves)."""
    from victorialogs_tpu_torch.gpu.sort_device import device_sort_spec
    port, jax_st = edge_stores
    assert (device_sort_spec(parse_query(q)) is None) == (reason == "spec")
    _want, runner = _topk_run(port, jax_st, q)
    c = runner.stats_counters
    assert c["topk_parts"] == 0
    assert c["topk_declines"] == (0 if reason == "spec" else EDGE_PARTS)
    assert c["device_parts"] == EDGE_PARTS
    assert (c["cpu_fallbacks"] > 0) == (reason == "planner")
    runner.close()


def test_topk_rows_threshold():
    """topk_rows keeps the rows at or above the k-th best definite score;
    padding and non-matching rows never set the threshold."""
    from victorialogs_tpu_torch.gpu.fused import TOPK_SCORE_MAX, topk_rows
    v = torch.tensor([5, 9, 9, 1, 0, 7, TOPK_SCORE_MAX, 3],
                     dtype=torch.int32)
    d = torch.tensor([1, 1, 1, 1, 1, 0, 0, 1], dtype=torch.bool)
    m = torch.tensor([0, 0, 0, 0, 0, 1, 1, 0], dtype=torch.bool)
    od, om = topk_rows(d, m, v, 2, True)
    assert od.tolist() == [0, 1, 1, 0, 0, 0, 0, 0]
    assert om.tolist() == [0, 0, 0, 0, 0, 0, 1, 0]
    od, om = topk_rows(d, None, v, 3, False)
    assert od.tolist() == [0, 0, 0, 1, 1, 0, 0, 1] and om is None
    od, om = topk_rows(d & False, m, v, 3, False)
    assert not od.any() and om.tolist() == m.tolist()


# ---------------- hits and stats_query_range ----------------

def _strip(ans: dict) -> dict:
    return {k: v for k, v in ans.items() if k not in ("trace", "partial")}


def _hits_args(start: int) -> list:
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    hour = 3600 * 10**9
    return [
        {"query": "error", "step": "1h", "field": "app"},
        {"query": "quota", "step": "30m", "offset": "10m",
         "fields": "app,lvl"},
        {"query": "error | where dur:>1000", "step": "2h"},
        {"query": "*"},
        {"query": "warn", "step": "1h", "start": format_rfc3339(start + hour),
         "end": format_rfc3339(start + 5 * hour), "field": "lvl"},
    ]


def _range_args(start: int) -> list:
    return [
        {"query": "error | stats by (app) count()", "step": "1h"},
        {"query": "quota | stats count(), sum(dur), max(dur)", "step": "3h"},
        {"query": "error | stats by (_time:2h) count()", "step": "1h"},
        {"query": "warn | stats by (lvl) quantile(0.5, status)",
         "step": "4h"},
        {"query": "error | uniq by (app, lvl) | stats by (app) count()",
         "step": "1h"},
    ]


@pytest.mark.parametrize("with_runner", [False, True])
@pytest.mark.parametrize("ai", range(5))
def test_handle_hits_matches_jax(stores, ai, with_runner):
    start, port, jax_st = stores
    args = _hits_args(start)[ai]
    want = _strip(jsel.handle_hits(jax_st, dict(args), {}))
    assert want["hits"]
    runner = TorchBatchRunner(device="cpu") if with_runner else None
    assert sel.handle_hits(port, dict(args), {}, runner=runner) == want
    if runner is not None:
        c = runner.stats_counters
        assert c["device_parts"] > 0 and c["host_parts"] == 0
        runner.close()


@pytest.mark.parametrize("with_runner", [False, True])
@pytest.mark.parametrize("ai", range(5))
def test_handle_stats_query_range_matches_jax(stores, ai, with_runner):
    start, port, jax_st = stores
    args = _range_args(start)[ai]
    want = _strip(jsel.handle_stats_query_range(jax_st, dict(args), {}))
    assert want["data"]["result"]
    runner = TorchBatchRunner(device="cpu") if with_runner else None
    assert sel.handle_stats_query_range(port, dict(args), {},
                                        runner=runner) == want
    if runner is not None:
        c = runner.stats_counters
        assert c["device_parts"] > 0 and c["host_parts"] == 0
        runner.close()


@pytest.mark.parametrize("handler,args", [
    ("handle_hits", {"query": "error", "step": "soon"}),
    ("handle_stats_query_range", {"query": "error | stats count()",
                                  "step": "1month"}),
    ("handle_stats_query_range", {"query": "error", "step": "1h"}),
    ("handle_hits", {"query": "error | sort by dur"}),
])
def test_handlers_refuse_like_jax(stores, handler, args):
    _start, port, jax_st = stores
    with pytest.raises(jsel.HTTPError) as je:
        getattr(jsel, handler)(jax_st, dict(args), {})
    with pytest.raises(sel.HTTPError) as e:
        getattr(sel, handler)(port, dict(args), {}, runner=None)
    assert e.value.status == je.value.status
    if je.value.status == 400:
        assert e.value.message == je.value.message


@pytest.mark.parametrize("handler,args", [
    ("handle_hits", {"query": "error", "step": "1h", "field": "app"}),
    ("handle_stats_query_range", {"query": "error | stats by (app) count()",
                                  "step": "1h"}),
])
def test_handlers_default_to_the_card_runner(stores, monkeypatch, handler,
                                             args):
    _start, port, _jax_st = stores
    made = []

    def make(*a, **kw):
        made.append((a, kw))
        return TorchBatchRunner(device="cpu")

    monkeypatch.setattr(sel, "_card_runners", weakref.WeakKeyDictionary())
    monkeypatch.setattr(sel, "TorchBatchRunner", make)
    fn = getattr(sel, handler)
    got = fn(port, dict(args), {})
    assert made == [((), {})]
    runner = sel.card_runner(port)
    assert runner.stats_counters["device_parts"] > 0
    assert runner.stats_counters["host_parts"] == 0
    assert fn(port, dict(args), {}) == got == fn(port, dict(args), {},
                                                  runner=None)
    assert len(made) == 1
    runner.close()


@pytest.mark.parametrize("handler", ["handle_hits",
                                     "handle_stats_query_range"])
def test_handlers_without_cuda_raise(stores, monkeypatch, handler):
    _start, port, _jax_st = stores
    monkeypatch.setattr(sel, "_card_runners", weakref.WeakKeyDictionary())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(sel, handler)(port, {"query": "error | stats count()"}, {})
