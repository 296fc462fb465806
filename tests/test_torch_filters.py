"""LogsQL's filters beyond the phrase family, in both packages.

~20k generated rows (tests/test_torch_query.py's, one UTC day, four
flushes) with a few more columns (an IPv4 column with a string block,
non-ASCII and empty names, a uint32 column whose range passes 2**31,
an int64 column, a copy of `user` for eq_field) go into the port's
Storage and the JAX package's.  Every comparison is exact:

- each filter of `_queries` (numeric ranges and comparisons, in,
  len_range, seq, contains_*, string_range, ipv4_range, value_type,
  eq/le/lt_field, exact, re, _stream_id, day/week ranges, numeric
  _time bounds, options) and its AND/OR/NOT forms with a scan return
  the same rows from the port's host executor, its
  TorchBatchRunner(device="cpu"), and the JAX package's
  run_query_collect with no runner and with BatchRunner();
- `parse_query(q).to_string()` equals the JAX package's, and malformed
  queries raise ParseError in both;
- the planner's node kinds equal the JAX planner's on the same part for
  numrange, lenrange, in and maskleaf leaves;
- a numrange over a column whose staged offsets pass 2**31, len_range
  over multibyte and truncated values, `in(<subquery>)` and its three
  errors, `extra_filters` in both forms and its 400, and the host's
  arena paths of string_range and len_range against Python's str order
  and len;
- a tree the planner declines walks leaf by leaf: `cpu_fallbacks` moves,
  `host_parts` stays 0, and its stats reduce on the card above
  `stats_host_threshold` matched rows a part and go to the host pipe
  below it.

Tolerance: none; results are bit-identical.
"""

import importlib.util
from pathlib import Path

import pytest

from victorialogs_tpu.engine.block_search import BlockSearch as JBlockSearch
from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.logsql.parser import ParseError as JParseError
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.server import vlselect as jsel
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu import fused as jfused
from victorialogs_tpu.tpu.batch import BatchRunner

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)
from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID

REPO = Path(__file__).resolve().parent.parent
ROWS = 20000
T = [TenantID(0, 0)]
JT = [JLR.TenantID(0, 0)]
NAMES = ["bob", "zoë", "日本語", "", "alice-long-name", "naïve café", "x"]

# torch and the torch-importing modules of the port load on first use,
# in the worker that runs these tests, not in every collecting worker
torch = run_query_collect = TorchBatchRunner = parse_query = None
ParseError = Storage = sel = batch = fused = BlockSearch = None


def _load_port():
    global torch, run_query_collect, TorchBatchRunner, parse_query
    global ParseError, Storage, sel, batch, fused, BlockSearch
    import torch
    from victorialogs_tpu_torch.engine.block_search import BlockSearch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu import batch, fused
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.logsql.parser import ParseError, parse_query
    from victorialogs_tpu_torch.server import vlselect as sel
    from victorialogs_tpu_torch.storage.storage import Storage


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _with_extra_fields(rows: list) -> list:
    out = []
    for i, (ts, fields) in enumerate(rows):
        stream = i % 16
        user = fields[6][1]
        ip = f"10.0.{(i // 7) % 4}.{i % 256}"
        if stream == 5 and i % 50 == 5:
            ip = "n/a"              # this stream's blocks store strings
        extra = [("ip", ip), ("name", NAMES[i % len(NAMES)]),
                 ("big", str(i * 2654435761 % 3_500_000_000)),
                 ("neg", str(i % 2001 - 1000)),
                 ("user2", user if i % 3 == 0 else "other"),
                 # a field whose name depends on the stream
                 ("kx1" if stream < 8 else "kx2", "v")]
        out.append((ts, fields + extra))
    return out


def _ingest(rows, flushes: int, jax_path: str):
    port = Storage(device="cpu")
    jax_st = JS.Storage(jax_path)
    per = len(rows) // flushes
    for k in range(flushes):
        lr = LogRows(stream_fields=["app", "host"])
        jl = JLR.LogRows(stream_fields=["app", "host"])
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
    """(start, port storage, JAX storage, two stream ids of the store)."""
    _load_port()
    start = today_start_ns()
    rows = _with_extra_fields(generate(ROWS, 5, start, NS_PER_DAY // 2,
                                       streams=16))
    port, jax_st = _ingest(rows, 4, str(tmp_path_factory.mktemp("jaxf")))
    part = next(iter(port.partitions.values())).parts[0]
    sids = (part.block_stream_id(3).as_string(),
            part.block_stream_id(9).as_string())
    yield start, port, jax_st, sids
    jax_st.close()
    port.close()


def _queries(start: int, sids: tuple) -> list:
    """(LogsQL, where the runner runs it): "card" every leaf on the
    card, "leaf" some leaf on the host with every part on the card,
    "host" every leaf on the host, "pruned" no candidate block."""
    a, b = sids
    s0 = start // 10**9
    return [
        ("status:>=500", "card"),
        ("status:>=500 error", "card"),
        ("status:>=500 or quota", "card"),
        ("-status:>=500 error", "card"),
        ("dur:range[1000, 2000)", "card"),
        ("error dur:range[1000, 2000)", "card"),
        ("dur:<100 or timeout", "card"),
        ("not dur:>100", "card"),
        ("status:range(200, 300] flush", "card"),
        ("dur:>=65535 or dur:<=0", "card"),
        ("big:>3000000000", "card"),
        ("big:range[2147483648, 2600000000] or error", "card"),
        ("neg:<0 error", "card"),
        ("neg:>=-5 neg:<=5", "card"),
        ("x:>5", "host"),
        ("lat:>99.9 error", "leaf"),
        ("lat:<1 or quota", "leaf"),
        ("ip:>5", "host"),
        ("lvl:in(error, warn)", "card"),
        ("lvl:in(error, warn) timeout", "card"),
        ("app:in(app-1, app-2) error", "card"),
        ("-lvl:in(debug) quota", "card"),
        ("in(a, b)", "card"),
        ('user:in(user-1, "user-2") or quota', "card"),
        ('name:in(zoë, bob) error', "leaf"),
        ('name:in(bob, "") error', "card"),
        ("user:len_range(6, 8)", "card"),
        ("user:len_range(6, 8) or quota", "card"),
        ("name:len_range(2, 3)", "card"),
        ("-name:len_range(0, 3) error", "card"),
        ("seq(error, timeout)", "card"),
        # `a` and `b` lie in no block: each part's bloom folds kill it
        # before any block is read (storage/filterbank.py), as in JAX
        ("seq(a, b)", "pruned"),
        ("_msg:seq(timeout, error) quota", "card"),
        ("-seq(error, timeout) flush", "card"),
        ("seq(error)", "card"),
        ("contains_all(error, timeout)", "card"),
        ("contains_any(quota, flush) error", "card"),
        ("-contains_all(error, GET) POST", "card"),
        ('name:contains_any(bob, "")', "card"),
        ('user:string_range("user-1", "user-2") error', "leaf"),
        ("name:string_range(a, zz)", "host"),
        ("ip:ipv4_range(10.0.1.0/24)", "host"),
        ("ip:ipv4_range(10.0.0.0, 10.0.2.255) error", "leaf"),
        ("dur:value_type(uint16) error", "card"),
        ("ip:value_type(ipv4) or quota", "card"),
        ("app:value_type(const)", "card"),
        ("user:eq_field(user2)", "host"),
        ("dur:le_field(status) error", "leaf"),
        ("dur:lt_field(status)", "host"),
        ("exact(error)", "card"),
        ("lvl:exact(err*)", "card"),
        ("re(foo)", "card"),
        ('re("error.*timeout")', "card"),
        (f"_stream_id:{a} error", "card"),
        (f"_stream_id:in({a}, {b})", "card"),
        (f"(_stream_id:{a} or status:>=500) | stats by (app) count()",
         "card"),
        (f"-_stream_id:{a} quota", "card"),
        ("_stream_id:abc", "pruned"),
        ("_time:day_range[02:00, 11:00) error", "leaf"),
        ("_time:week_range[Sun, Sat] quota", "leaf"),
        (f"_time:[{s0}, {s0 + 3600}) error", "card"),
        ("options(concurrency=2) error", "card"),
        ("options(ignore_global_time_filter=true) status:>=500", "card"),
        ("status:>=500 | stats by (app) count()", "card"),
        ("lvl:in(error, warn) | stats by (app, lvl) count()", "card"),
        ("user:len_range(6, 8) | stats count()", "card"),
        ("error lat:>99.9", "leaf"),
        ('error user:string_range("user-1", "user-2") | stats by (app) '
         'count()', "leaf"),
    ]


N_QUERIES = 68


def test_query_list_covers_every_smoke_filter_query():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sids = ("0" * 48, "1" * 48)
    mine = {q for q, _w in _queries(0, sids)}
    smoke_qs = smoke.filter_queries(sids[0])
    assert len(smoke_qs) == 8
    assert all(q in mine for _n, q, _k, _f in smoke_qs)
    assert len(_queries(0, sids)) == N_QUERIES


@pytest.mark.parametrize("qi", range(N_QUERIES))
def test_filter_query_matches_jax(stores, qi):
    start, port, jax_st, sids = stores
    q, where = _queries(start, sids)[qi]
    want = jax_run(jax_st, JT, q)
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == want
        c = runner.stats_counters
        if where == "pruned":
            assert c["device_parts"] == c["host_parts"] == 0, c
        elif where == "host":
            assert c["device_parts"] == 0 and c["host_parts"] > 0, c
        else:
            assert c["device_parts"] > 0 and c["host_parts"] == 0, c
            assert (c["cpu_fallbacks"] > 0) == (where == "leaf"), c
    finally:
        runner.close()
    br = BatchRunner()
    try:
        assert jax_run(jax_st, JT, q, runner=br) == want
    finally:
        br.close()


# ---------------- the parser ----------------

PARSE_QUERIES = [
    "x:>5", "x:>=5", "x:<5", "x:<=5.5", "status:>=500", "x:>10KB", "x:<-3",
    "x:>=1e3", "lat:>99.9", "dur:range[1000, 2000)", "dur:range(1, 2]",
    "x:range[-inf, 5]", "in(a, b)", "lvl:in(error, warn)",
    'lvl:in("a b", c)', "x:in(*)", "x:in()", "app:in(* | fields app)",
    "user:in(error | fields user)", "x:in(foo | stats count() c | fields c)",
    "seq(a, b)", 'seq("a b", c)', "_msg:seq(error, timeout)",
    "contains_all(a, b)", "contains_any(a, b)",
    "contains_all(error | fields lvl)", 'foo:contains_any(a, "b c")',
    "len_range(6, 8)", "user:len_range(6, inf)", "x:len_range(0, 5KB)",
    "ipv4_range(10.0.0.0/8)", "ip:ipv4_range(1.2.3.4, 1.2.3.255)",
    "ip:ipv4_range(1.2.3.4)", 'user:string_range("user-1", "user-2")',
    "string_range(a, b)", "x:value_type(uint16)", "value_type(const)",
    "x:eq_field(y)", "x:le_field(y)", "x:lt_field(y)", "exact(foo)",
    "exact(foo*)", 'x:exact("a b")', "re(foo)", 'x:re("a.*b")',
    "_stream_id:abc", "_stream_id:in(abc, def)",
    "_stream_id:0000000000000000abcd error",
    "_time:day_range[08:00, 18:00)", "_time:day_range(08:00, 18:00] offset 2h",
    "_time:week_range[Mon, Fri]", "_time:week_range(sun, sat) offset 1h",
    "_time:[1700000000, 1700003600)", "_time:>1700000000000",
    "_time:<=1700000000000000000", "options(concurrency=4) error",
    "options(ignore_global_time_filter=true) error | stats count()",
    "options(concurrency=2, ignore_global_time_filter=false) x:>5",
    "error x:>5 or not y:in(a, b)", "-x:range[1, 2] error",
    "!seq(a, b) (x:>1 or _stream_id:abc)",
    "lvl:in(error, warn) | stats by (app, lvl) count()",
    'error user:string_range("user-1", "user-2") | stats by (app) count()',
    "(_stream_id:abc or status:>=500) | stats by (app) count()",
]

BAD_QUERIES = [
    "x:>abc", "x:range[1, b]", "len_range(1)", "ipv4_range(1.2.3)",
    "ipv4_range(1.2.3.4/33)", "string_range(a)", "value_type(a, b)",
    "exact(a, b)", "re(a, b)", "_time:day_range[8, 9]",
    "_time:week_range[mon, funday]", "options(foo=1) x", "options concurrency",
    '_stream:{app in("a")}', "x:eq_field(a, b)",
    "_time:day_range[08:00 18:00]", "_time:[abc, def]", "in(a",
    "_time:week_range[mon, fri] offset zz",
]


@pytest.mark.parametrize("q", PARSE_QUERIES)
def test_to_string_matches_jax(q):
    t = 10**18
    assert len(PARSE_QUERIES) >= 60
    assert parse_query(q, t).to_string() == jax_parse(q, t).to_string()


@pytest.mark.parametrize("q", BAD_QUERIES)
def test_malformed_query_raises_in_both(q):
    with pytest.raises(JParseError):
        jax_parse(q, 10**18)
    with pytest.raises(ParseError):
        parse_query(q, 10**18)


@pytest.mark.parametrize("q", ["x:le_field()", "x:lt_field(a, b)"])
def test_field_compare_needs_one_field(q):
    """A ParseError (the JAX package reads past its arguments here)."""
    with pytest.raises(ParseError):
        parse_query(q)


# ---------------- the planner ----------------

def _kinds(node, out: set) -> set:
    out.add(node[0])
    if node[0] in ("and", "or"):
        for kid in node[1]:
            _kinds(kid, out)
    elif node[0] in ("not", "verify"):
        _kinds(node[1], out)
    return out


@pytest.mark.parametrize("q,kinds", [
    ("status:>=500", {"numrange"}),
    ("dur:range[1000, 2000) neg:<0", {"and", "numrange"}),
    ("user:len_range(6, 8)", {"lenrange"}),
    ("name:len_range(1, 3)", {"lenrange"}),
    ("lvl:in(error, warn)", {"or", "scan"}),
    ('name:in(bob, "")', {"or", "scan", "empty"}),
    ("_stream_id:{a} or status:>=500", {"or", "maskleaf", "numrange"}),
    ("ip:value_type(ipv4) or dur:<100", {"or", "maskleaf", "numrange"}),
])
def test_plan_kinds_match_jax(stores, q, kinds):
    """On every part, the port's program has the node kinds of the JAX
    planner's for the same filter and candidate blocks."""
    start, port, jax_st, sids = stores
    q = q.replace("{a}", sids[0])
    tf, jf = parse_query(q).filter, jax_parse(q).filter
    runner, br = TorchBatchRunner(device="cpu"), BatchRunner()
    try:
        (tpt,) = port.partitions.values()
        (jpt,) = jax_st.partitions.values()
        for tp, jp in zip(tpt.parts, jpt.ddb.snapshot_parts()):
            bss = {bi: BlockSearch(tp, bi)
                   for bi in range(tp.num_blocks)}
            jbss = {bi: JBlockSearch(jp, bi) for bi in range(jp.num_blocks)}
            got = fused._Planner(runner, tp, bss, runner.layout(tp)).plan(tf)
            want = jfused._Planner(br, jp, jbss,
                                   br._stats_layout(jp)).plan(jf)
            assert _kinds(got, set()) == _kinds(want, set()) == kinds, q
    finally:
        runner.close()
        br.close()


def test_numrange_compares_offsets_past_2_31(stores):
    """`big` spans 0 to 3.5e9: its staged offsets (int32 bits) pass
    2**31, where a signed compare would be wrong."""
    start, port, jax_st, sids = stores
    runner = TorchBatchRunner(device="cpu")
    try:
        (tpt,) = port.partitions.values()
        part = tpt.parts[0]
        sn = runner.stage_numeric(part, "big", runner.layout(part))
        assert sn.vmax - sn.vmin >= 1 << 31
        assert int((sn.values < 0).sum()) > 0
        for q in ("big:>3000000000", "big:<=2147483648",
                  "big:range[2147483647, 2147483649]",
                  "big:range(1000000000, 3400000000)", "big:>=0",
                  "big:<0", "big:>3500000000"):
            want = jax_run(jax_st, JT, q)
            assert run_query_collect(port, T, q, runner=runner) == want, q
            assert run_query_collect(port, T, q) == want, q
        assert runner.stats_counters["host_parts"] == 0
        assert runner.stats_counters["cpu_fallbacks"] == 0
    finally:
        runner.close()


LEN_VALUES = ["ab", "abc", "zoë", "ñandú", "日本語です", "x" * 40,
              "é" * 20, "日" * 15, "", "a" * 31, "b" * 32, "ü" + "c" * 30]


@pytest.mark.parametrize("q", [
    "name:len_range(2, 5)", "name:len_range(3, 8)", "name:len_range(1, 7)",
    "name:len_range(15, 40)", "name:len_range(20, 20)",
    "name:len_range(0, 0)", "-name:len_range(3, 5) name:*",
    "name:len_range(31, 32) or name:len_range(3, 3)",
])
def test_len_range_over_multibyte_and_truncated_values(monkeypatch,
                                                       tmp_path, q):
    """The widest staging cut to 32 bytes: values past 31 bytes are
    truncated (maybe rows unless 31 bytes already exceed 4*hi), and
    multibyte values whose byte length leaves the count open are maybe
    rows; every answer equals the JAX package's."""
    from victorialogs_tpu_torch.gpu import layout
    monkeypatch.setattr(layout, "MAX_ROW_WIDTH", 32)
    t0 = today_start_ns()
    rows = [(t0 + i, [("_msg", f"row {i}"), ("app", f"a{i % 2}"),
                      ("name", LEN_VALUES[i % len(LEN_VALUES)])])
            for i in range(240)]
    port, jst = _ingest(rows, 1, str(tmp_path))
    runner = TorchBatchRunner(device="cpu")
    try:
        want = jax_run(jst, JT, q)
        assert run_query_collect(port, T, q, runner=runner) == want
        assert run_query_collect(port, T, q) == want
        c = runner.stats_counters
        assert c["host_parts"] == 0 and c["cpu_fallbacks"] == 0, c
        if q in ("name:len_range(2, 5)", "name:len_range(3, 8)"):
            assert c["maybe_rows"] > 0, c
    finally:
        runner.close()
        port.close()
        jst.close()


# ---------------- subqueries ----------------

@pytest.mark.parametrize("q", [
    "app:in(quota lvl:=debug status:>=500 | fields app) error",
    "lvl:in(_stream:{app=\"app-3\"} status:>=503 | fields lvl) | "
    "stats by (lvl) count()",
    "contains_any(status:>=504 | fields lvl) quota",
    "contains_all(dur:<10 | fields lvl)",
    "-user:in(quota dur:<1000 | fields user) quota",
])
def test_in_subquery_matches_jax(stores, q):
    start, port, jax_st, sids = stores
    want = jax_run(jax_st, JT, q)
    assert want
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == want
    finally:
        runner.close()


@pytest.mark.parametrize("q", [
    "app:in(error | limit 3) quota",              # no `| fields x`
    "app:in(error | fields app, lvl) quota",      # two columns
    "app:in(* | fields kx*) quota",               # kx1 here, kx2 there
])
def test_in_subquery_errors_match_jax(stores, q):
    start, port, jax_st, sids = stores
    with pytest.raises(ValueError) as je:
        jax_run(jax_st, JT, q)
    with pytest.raises(ValueError) as e:
        run_query_collect(port, T, q)
    assert str(e.value) == str(je.value)


# ---------------- extra_filters ----------------

@pytest.mark.parametrize("arg,ef", [
    ("extra_filters", '{"app": ["app-1", "app-2"]}'),
    ("extra_filters", '{"lvl": "warn", "app": ["app-3"]}'),
    ("extra_filters", "lvl:in(warn) or quota"),
    ("extra_stream_filters", '{app="app-1"}'),
])
def test_extra_filters_match_jax(stores, arg, ef):
    start, port, jax_st, sids = stores
    args = {"query": "error", "limit": "300", arg: ef}
    want = list(jsel.handle_query(jax_st, dict(args), {}))
    assert want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert sel.handle_query(port, dict(args), {}, runner=runner) == want
        assert sel.handle_query(port, dict(args), {}, runner=None) == want
        assert runner.stats_counters["host_parts"] == 0
    finally:
        runner.close()
    sargs = {"query": "* | stats by (app) count()", arg: ef,
             "time": "2030-01-01T00:00:00Z"}
    runner = TorchBatchRunner(device="cpu")
    try:
        assert sel.handle_stats_query(port, dict(sargs), {},
                                      runner=runner) == \
            jsel.handle_stats_query(jax_st, dict(sargs), {})
    finally:
        runner.close()


@pytest.mark.parametrize("ef", ['{"app": ', "lvl:in(warn", "a)"])
def test_unparsable_extra_filters_answer_400(stores, ef):
    start, port, jax_st, sids = stores
    args = {"query": "error", "extra_filters": ef}
    with pytest.raises(jsel.HTTPError) as je:
        jsel.handle_query(jax_st, dict(args), {})
    with pytest.raises(sel.HTTPError) as e:
        sel.handle_query(port, dict(args), {}, runner=None)
    assert e.value.status == je.value.status == 400


def test_extra_filters_object_edge_cases(stores):
    """An empty object adds no filter; a value that is neither a string
    nor a list answers 400 (the JAX package raises TypeError there)."""
    start, port, jax_st, sids = stores
    plain = sel.handle_query(port, {"query": "error", "limit": "50"}, {},
                             runner=None)
    assert sel.handle_query(port, {"query": "error", "limit": "50",
                                   "extra_filters": "{}"}, {},
                            runner=None) == plain
    with pytest.raises(sel.HTTPError) as e:
        sel.handle_query(port, {"query": "error",
                                "extra_filters": '{"app": 5}'}, {},
                         runner=None)
    assert e.value.status == 400


# ---------------- the per-leaf path ----------------

def test_stats_host_threshold_is_the_jax_runners():
    assert TorchBatchRunner.stats_host_threshold == \
        BatchRunner.stats_host_threshold == 1024


@pytest.mark.parametrize("q", ["error lat:>99.9", "lat:>99.5 or quota",
                               "not (lat:<50 error)"])
def test_declined_row_tree_walks_leaf_by_leaf(stores, q):
    start, port, jax_st, sids = stores
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == \
            jax_run(jax_st, JT, q)
        c = runner.stats_counters
        assert c["cpu_fallbacks"] > 0 and c["host_parts"] == 0, c
        assert c["device_parts"] == 4, c
    finally:
        runner.close()


@pytest.mark.parametrize("q,reduced", [
    # ~190 matched rows a part: the host pipe takes them
    ('error user:string_range("user-1", "user-2") | stats by (app) '
     'count()', False),
    # ~1,550 a part: one count launch a part over the uploaded mask
    ('error user:string_range("user-0", "user-9") | stats by (app) '
     'count()', True),
    ('error user:string_range("user-0", "user-9") | stats by (lvl) '
     'count(), sum(dur), max(dur)', True),
    ("lat:>99.9 | stats count()", False),
])
def test_declined_stats_tree_reduces_above_the_threshold(stores, monkeypatch,
                                                         q, reduced):
    start, port, jax_st, sids = stores
    calls = []

    def counting(fn):
        def wrapper(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(batch, "stats_count_seg",
                        counting(batch.stats_count_seg))
    monkeypatch.setattr(batch, "stats_values", counting(batch.stats_values))
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == \
            jax_run(jax_st, JT, q)
        c = runner.stats_counters
        assert c["cpu_fallbacks"] > 0, c
        assert len(calls) == (4 if reduced else 0), calls
        if "error" in q:
            assert c["host_parts"] == 0 and c["device_parts"] == 4, c
        else:
            # no leaf on the card and too few rows to reduce there
            assert c["host_parts"] == 4 and c["device_parts"] == 0, c
    finally:
        runner.close()


@pytest.mark.parametrize("seed", range(4))
def test_arena_paths_match_the_predicates(seed):
    """The host's arena paths of string_range (a byte-matrix compare)
    and len_range (code points from the bytes that are not UTF-8
    continuation bytes) against Python's str order and len, on rows of
    mixed ASCII, multibyte and empty values."""
    import numpy as np
    from victorialogs_tpu_torch.logsql import filters as F
    from victorialogs_tpu_torch.storage.values_encoder import (VT_STRING,
                                                               encode_values)
    rng = np.random.default_rng(seed)
    alpha = ["a", "b", "z", "é", "日", "A", "\x00", "ÿ", "-", "1"]
    vals = ["".join(rng.choice(alpha, size=rng.integers(0, 7)))
            for _ in range(300)] + [f"v{i}" for i in range(60)]
    col = encode_values("x", vals)
    assert col.vtype == VT_STRING
    rows = np.nonzero(rng.random(len(vals)) < 0.7)[0]
    for ref in ["", "a", "b", "é", "ab", "zz", "日a", "ÿÿÿ", "v3"]:
        got = F._arena_compare(col, rows, ref.encode())
        want = [(vals[i] > ref) - (vals[i] < ref) for i in rows]
        assert got.tolist() == want, ref

    class Block:
        nrows = len(vals)

        def consts(self):
            return {}

        def column(self, name):
            return col

        def bloom(self, name):
            return None

    for lo, hi in [(0, 0), (1, 3), (2, 2), (3, 6), (0, 100)]:
        bm = np.ones(len(vals), dtype=bool)
        F.FilterLenRange("x", lo, hi).apply_to_block(Block(), bm)
        assert bm.tolist() == [lo <= len(v) <= hi for v in vals]
        bm = np.ones(len(vals), dtype=bool)
        F.FilterStringRange("x", "a", "é").apply_to_block(Block(), bm)
        assert bm.tolist() == ["a" <= v < "é" for v in vals]
