"""The transform and auxiliary pipes, the host-only stats functions,
per-function `if` guards and calendar `_time` buckets: the port against
the JAX package.

Every query parses to the JAX package's `to_string()` and answers the
JAX host executor's rows exactly through the port's host executor and
through `TorchBatchRunner(device="cpu")`, whose counters show the
filter ran on the card (`device_parts`, `host_parts` 0) and the stats
where they did.  The queries run over

- the generator's rows (`cli/vlogsgenerator.py`, one UTC day, strictly
  increasing timestamps, two flushes): every registered pipe name,
  each new stats function, `if` and the calendar buckets, and
- small tables drawn from the JAX package's own tests
  (tests/test_pipes_transform.py, tests/test_pipes_aux.py), one store
  a table.

Also here: the value-level helpers (pattern, logfmt, JSON arrays,
format options, collapse_nums, syslog) against the JAX package's, the
parse errors, `block_stats`/`blocks_count` on the same parts, the
device stats spec's declines, and `sample`/`rand()` held to properties
over a seeded generator, since they cannot match row for row.
"""

import math
import random

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.logsql import pipes_aux as JPA
from victorialogs_tpu.logsql import pipes_transform as JPT
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.server.syslog import parse_syslog_message as jax_syslog
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu import stats_device as JSD

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)

NS = 1_000_000_000
T0 = 1_753_660_800_000_000_000      # the JAX package's table tests' day
GEN_ROWS = 6000

# torch and the port load on first use, in the worker that runs these
# tests, not in every collecting worker
torch = Storage = TorchBatchRunner = run_query_collect = None
parse_query = LogRows = TenantID = PT = PA = TSD = None


def _load_port():
    global torch, Storage, TorchBatchRunner, run_query_collect
    global parse_query, LogRows, TenantID, PT, PA, TSD
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu import stats_device as TSD
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.logsql import pipes_aux as PA
    from victorialogs_tpu_torch.logsql import pipes_transform as PT
    from victorialogs_tpu_torch.logsql.parser import parse_query
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _pair(path, batches, stream_fields, **port_kw):
    """The same batches into both packages, each flushed."""
    port = Storage(device="cpu", **port_kw)
    jax_st = JS.Storage(path, flush_interval=3600, **port_kw)
    try:
        for rows in batches:
            lr = LogRows(stream_fields=stream_fields)
            jl = JLR.LogRows(stream_fields=stream_fields)
            for ts, fields in rows:
                lr.add(TenantID(0, 0), ts, fields)
                jl.add(JLR.TenantID(0, 0), ts, fields)
            port.must_add_rows(lr)
            port.debug_flush()
            jax_st.must_add_rows(jl)
            jax_st.debug_flush()
    except BaseException:
        jax_st.close()
        raise
    return port, jax_st


def _answers(port, jax_st, q, ts):
    """(JAX host rows, port host rows, port runner rows, runner
    counters, stats launches: run_part_stats_submit calls)."""
    want = jax_run(jax_st, [JLR.TenantID(0, 0)], q, timestamp=ts)
    t = [TenantID(0, 0)]
    host = run_query_collect(port, t, q, timestamp=ts)
    runner = TorchBatchRunner(device="cpu")
    calls = []
    inner = runner.run_part_stats_submit

    def counted(*a):
        calls.append(1)
        return inner(*a)
    runner.run_part_stats_submit = counted
    try:
        dev = run_query_collect(port, t, q, timestamp=ts, runner=runner)
    finally:
        runner.close()
    return want, host, dev, runner.stats_counters, len(calls)


def _check(port, jax_st, q, ts):
    assert parse_query(q, ts).to_string() == jax_parse(q, ts).to_string()
    want, host, dev, counters, _ = _answers(port, jax_st, q, ts)
    assert host == want, q
    assert dev == want, q
    # the filter ran on the card; only the pipes ran on the host
    assert counters["device_parts"] >= 1, q
    assert counters["host_parts"] == 0, q
    return want


# ---------------- the generator's rows ----------------

@pytest.fixture(scope="module")
def gen_stores(tmp_path_factory):
    _load_port()
    start = today_start_ns()
    rows = generate(GEN_ROWS, 16, start, NS_PER_DAY // 2, streams=16)
    half = GEN_ROWS // 2
    port, jax_st = _pair(str(tmp_path_factory.mktemp("jaxgen")),
                         [rows[:half], rows[half:]], ["app", "host"])
    yield start, port, jax_st
    jax_st.close()
    port.close()


# every pipe name the JAX package registers, each stats function the
# slice adds, `if` and the calendar buckets; filters the planner takes
GEN_QUERIES = [
    'error | extract "error <w> " | stats by (w) count() c',
    'error | extract if (lvl:warn) "error <w> " keep_original_fields '
    '| fields _msg, w, lvl | limit 40',
    'timeout | extract "<a> timeout <b> " from _msg skip_empty_results '
    '| stats by (a, b) count() c | sort by (c desc, a, b) limit 12',
    r'timeout | extract_regexp `timeout (?P<nxt>\w+)` '
    '| stats by (nxt) count() c',
    'quota | format "<lvl>:<uc:app> <dur>" as line | fields line '
    '| limit 50',
    'quota | fmt if (lvl:error) "<q:user>" as user skip_empty_results '
    '| fields user, lvl | limit 50',
    'error | math dur * 2 + 1 as d2, dur / 7 as q7, round(lat) as rl, '
    'max(dur, status) as mx | fields d2, q7, rl, mx | limit 100',
    'retry | eval (dur % 13) default 0 as m | stats by (m) count() c',
    'error | pack_json fields (lvl, dur, app) as j '
    '| unpack_json from j result_prefix u_ '
    '| stats by (u_lvl, u_app) count() c',
    'error | pack_logfmt fields (lvl, dur) as lf '
    '| unpack_logfmt from lf fields (lvl) result_prefix l_ '
    '| fields l_lvl, lf | limit 40',
    'login | unpack_words from _msg as w drop_duplicates | fields w '
    '| limit 20',
    'login | format "<34>1 2024-06-01T12:00:00Z <host> <app> 7 - - <lvl>" '
    'as sl | unpack_syslog from sl | fields hostname, app_name, severity, '
    '_msg | limit 20',
    'timeout | replace ("timeout", "TO") '
    '| replace_regexp (`e(r+)`, "E") at lvl limit 1 '
    '| fields _msg, lvl | limit 60',
    'error | top 5 by (app)',
    'warn | top 3 by (lvl, app) hits as n rank as r',
    'quota | facets 3',
    'quota | facets 5 max_values_per_field 20 keep_const_fields',
    'error | stats by (app) count() if (lvl:error) e, count() total, '
    'sum(dur) if (status:200) s',
    'error | stats by (_time:month) count() c',
    'error | stats by (_time:week, lvl) count() c',
    'error | stats by (_time:year offset 1h) count() c',
    'quota | stats by (app) histogram(status) h',
    'quota | stats by (lvl) values(status) limit 5 v',
    'quota | stats by (app) row_max(dur) rm, row_min(dur, user) rn',
    'quota | stats by (app) uniq_values(lvl) u, count_uniq_hash(user) ch, '
    'row_any(lvl, dur) ra',
    'flush | stats by (lvl) json_values(dur, app) limit 3 jv',
    'flush | stats row_any() r, json_values() limit 2 j',
    'merge | len(_msg) as l | stats by (l) count() c',
    'closed | fields _msg, lvl, nothere | drop_empty_fields | limit 10',
    'alloc | field_names',
    'alloc | field_values lvl',
    'alloc | field_values user limit 5',
    'free | blocks_count',
    'free | blocks_count as bc',
    'compact | collapse_nums at user | stats by (user) count() c',
    'compact | format "<dur>.<status> at <lat>" as v '
    '| collapse_nums at v prettify | stats by (v) count() c',
    'POST | decolorize | hash(user) as h | fields h | limit 20',
    'PUT | json_array_len(user) as n | stats by (n) count() c',
    'PUT | format "[\\"<lvl>\\",\\"<app>\\"]" as tags | unroll by (tags) '
    '| stats by (tags) count() c',
    'PUT | format "[\\"<lvl>\\"]" as tags | unroll if (lvl:info) by (tags) '
    '| fields tags, lvl | limit 30',
    'error | join by (app) (quota | stats by (app) count() quota_hits) '
    '| stats by (app, quota_hits) count() c',
    'error lvl:error | fields _msg, app '
    '| union (quota lvl:debug | fields _msg, app) '
    '| stats by (app) count() c',
    'quota lvl:error dur:<2000 | stream_context before 2 after 1 '
    '| fields _time, _msg, app',
    'error | sample 1 | stats count() c',
]


# the pipes of earlier slices
_SLICE_12_PIPES = ("fields", "keep", "delete", "del", "rm", "drop", "copy",
                   "cp", "rename", "mv", "limit", "head", "offset", "skip",
                   "where", "filter", "sort", "order", "uniq", "stats",
                   "count", "first", "last")


def test_gen_queries_cover_every_pipe_name():
    names = {
        "extract", "extract_regexp", "format", "fmt", "math", "eval",
        "unpack_json", "unpack_logfmt", "unpack_syslog", "unpack_words",
        "replace", "replace_regexp", "top", "len", "pack_json",
        "pack_logfmt", "sample", "unroll", "facets", "field_names",
        "field_values", "blocks_count", "drop_empty_fields", "join",
        "union", "stream_context", "collapse_nums", "decolorize", "hash",
        "json_array_len", "block_stats"}
    from victorialogs_tpu.logsql.pipes import _PIPE_PARSERS as JP
    from victorialogs_tpu_torch.logsql.pipes import _PIPE_PARSERS as TP
    assert set(JP) == set(TP)
    assert names == set(TP) - set(_SLICE_12_PIPES)
    used = " ".join(GEN_QUERIES) + " | block_stats "
    for n in names:
        assert f"| {n} " in used or f"| {n}(" in used, n


@pytest.mark.parametrize("q", GEN_QUERIES)
def test_gen_query_matches_jax(gen_stores, q):
    start, port, jax_st = gen_stores
    want = _check(port, jax_st, q, start)
    assert want, q


@pytest.mark.parametrize("q", [
    'error | stats by (app) count() if (lvl:error) e',
    'error | stats by (_time:month) count() c',
    'error | stats by (_time:Week) count() c',
    'quota | stats histogram(status) h',
    'quota | stats count_uniq_hash(user) u',
    'quota | stats uniq_values(lvl) u',
    'quota | stats values(lvl) v',
    'quota | stats row_max(dur) r',
    'quota | stats row_min(dur) r',
    'quota | stats row_any(lvl) r',
    'quota | stats json_values(lvl) j',
    'quota | stats by (lvl) median(dur) if (app:app-0) m',
])
def test_stats_outside_the_device_shape_go_to_the_host(gen_stores, q):
    """The device spec declines an `if`, a calendar bucket and every new
    function, as the JAX package's does: no stats reduction on the
    card, the filter still on it, the answer the JAX package's."""
    start, port, jax_st = gen_stores
    assert TSD.device_stats_spec(parse_query(q, start)) is None
    assert JSD.device_stats_spec(jax_parse(q, start)) is None
    want, host, dev, counters, stats_calls = _answers(port, jax_st, q,
                                                      start)
    assert host == dev == want
    assert stats_calls == 0
    assert counters["device_parts"] >= 1 and counters["host_parts"] == 0


@pytest.mark.parametrize("q", [
    'error | stats by (app) count() e',
    'error | stats by (_time:1h) count() c',
    'quota | stats count_uniq(lvl) u',
    'quota | stats by (lvl) median(status) m',
    'error | stats by (app, lvl) count() c, sum(dur) s, min(dur) mn',
])
def test_stats_of_the_device_shape_still_reduce_on_the_card(gen_stores, q):
    start, port, jax_st = gen_stores
    assert TSD.device_stats_spec(parse_query(q, start)) is not None
    want, host, dev, counters, stats_calls = _answers(port, jax_st, q,
                                                      start)
    assert host == dev == want
    # one reduction a dispatch unit (a part, or a pack of small parts)
    assert stats_calls == counters["units"] >= 1


def test_block_stats_on_the_same_parts(gen_stores):
    """block_stats describes each stored block that reaches it: field,
    type and rows equal the JAX package's on the same parts; a flushed
    JAX part reports its directory, every port part `inmemory`."""
    start, port, jax_st = gen_stores
    q = "free | block_stats"
    want, host, dev, counters, _ = _answers(port, jax_st, q, start)
    assert host == dev
    assert len(host) == len(want) > 0
    for got, w in zip(host, want):
        assert got["part_path"] == "inmemory" and w["part_path"] != ""
        assert {k: v for k, v in got.items() if k != "part_path"} == \
            {k: v for k, v in w.items() if k != "part_path"}
    assert counters["host_parts"] == 0


# ---------------- tables from the JAX package's tests ----------------

TABLES = {
    "extract": [{"_msg": "ip=1.2.3.4 port=80 ok"},
                {"_msg": "ip=5.6.7.8 port=443 ok"}, {"_msg": "garbage"}],
    "extract_if": [{"_msg": "x=new", "x": "old"},
                   {"_msg": "x=other", "x": ""}],
    "took": [{"_msg": "took 25ms"}, {"_msg": "took 1300ms"},
             {"_msg": "no-match"}],
    "ab": [{"a": "1", "b": "x"}, {"a": "2", "b": "y"}],
    "fmt_opts": [{"v": "abC", "n": "3000000000", "ip": "16909060"}],
    "math": [{"a": "10", "b": "3"}, {"a": "7", "b": "0"}],
    "math2": [{"a": "2", "b": "8"}],
    "bits": [{"a": "12", "b": "10"}],
    "dur": [{"d": "2m30s"}],
    "json": [{"_msg": '{"level":"info","nested":{"x":"1"},"num":42}'},
             {"_msg": "not json"}],
    "json2": [{"_msg": '{"a":"1","b":"2"}'}],
    "logfmt": [{"_msg": 'level=warn msg="disk full" free=5GB'}],
    "syslog": [{"_msg": "<165>1 2024-06-01T12:00:00Z host app 123 - "
                        "- boom happened"},
               {"_msg": "<13>Oct 11 22:14:15 mymachine su[77]: su failed"},
               {"_msg": '<14>1 2024-06-01T12:00:00Z h a 1 ID7 [ex@1 k="v" '
                        'q="a\\"b"] msg'}],
    "words": [{"_msg": "foo bar foo"}],
    "dashes": [{"_msg": "a-b-c-d"}],
    "ids": [{"_msg": "id=12345 user=9"}],
    "secret": [{"u": "secret", "keep": "y"}, {"u": "secret"}],
    "top": [{"k": "a"}] * 5 + [{"k": "b"}] * 3 + [{"k": "c"}],
    "len": [{"_msg": "hello"}, {"_msg": "日本"}],
    "pack": [{"a": "1", "b": "x y"}],
    "unroll": [{"_msg": "r1", "tags": '["a","b"]'},
               {"_msg": "r2", "tags": "notarray"}],
    "empty": [{"a": "1", "b": ""}, {"a": "", "b": ""}],
    "values": [{"x": "v1"}, {"x": "v2"}, {"x": "v1"}],
    "facets": [{"k": "a", "lvl": "info"}] * 6
    + [{"k": "b", "lvl": "warn"}] * 3 + [{"k": "c", "lvl": "warn"}],
    "chain": [{"a": "v1", "b": "2", "c": "3"}],
    "default": [{"a": "v1", "b": "2", "c": "3"},
                {"a": "0", "b": "0", "c": "3"}, {"a": "3", "b": "2"},
                {"a": "3", "b": "foo"}],
    "one": [{"x": "1"}],
    "div": [{"a": "6", "b": "2"}],
    "hex": [{"n": "123456789", "h": "75BCD15", "s": "AB", "hx": "41"}],
    "wild": [{"req_path": "/x", "req_method": "GET", "resp_code": "200"},
             {"j": '{"aa":"1","ab":"2","zz":"3"}'}],
    "ext_vals": [{"_msg": 'foo=bar baz="x y=z" ', "aa": "foobar",
                  "abc": "ippl"}],
    "ext_quoted": [{"_msg": 'foo=bar baz="x y=z" a=b', "aa": "foobar",
                    "abc": ""}],
    "fmt_time": [{"foo": "1717328141123456789", "bar": "210123456789",
                  "baz": "1234567890", "d": "1h5m35s"}],
    "fmt_unix": [{"foo": "1717328141.123456789",
                  "bar": "1717328141.123456", "neg": "-1717328141"}],
    "json_opts": [{"_msg": '{"foo":"bar","z":"q","a":""}', "foo": "x",
                   "a": "foobar"}],
    "collapse": [{"_msg": "req 123 took 45ms"}],
    "color": [{"_msg": "\x1b[31mred error\x1b[0m done"}],
    "hash": [{"v": "abc"}, {"v": "abc"}, {"v": "xyz"}],
    "arr": [{"v": "[1,2,3]"}, {"v": "nope"}],
    "block": [{"_msg": f"m{i}", "code": str(i % 3)} for i in range(50)],
    "join": [{"_msg": "m", "user": "u1"}, {"_msg": "m", "user": "u2"},
             {"_msg": "names", "user": "u1", "full_name": "Alice"},
             {"_msg": "names", "user": "u2", "full_name": "Bob"},
             {"_msg": "m", "user": "u3"}],
    "union": [{"_msg": "alpha one"}, {"_msg": "beta two"}],
    "ctx": [{"_msg": f"line {i}" + (" panic" if i == 5 else "")}
            for i in range(10)],
    "ctx2": [{"app": f"app{i % 2}",
              "_msg": f"s{i % 2} line {i}" + (" boom" if i in (6, 7)
                                                else "")}
             for i in range(12)],
    "top_ref": [{"a": "2", "b": "3"}, {"a": "2", "b": "3"},
                {"a": "2", "b": "54", "c": "d"}],
    "stats": [{"_msg": f"e{i}" + (" error" if i % 3 == 0 else ""),
               "d": str(i * 37 % 1000), "g": f"g{i % 4}", "s": str(i % 7)}
              for i in range(80)],
}

TABLE_QUERIES = [
    ("extract", '* | extract "ip=<ip> port=<port> " | fields ip, port'),
    ("extract_if", '* | extract if (x:"") "x=<x>" | fields x'),
    ("extract_if", '* | extract "x=<x>" keep_original_fields | fields x'),
    ("took", r'* | extract_regexp `took (?P<ms>\d+)ms` | fields ms'),
    ("ab", '* | format "a=<a>, b=<b>" as out | fields out'),
    ("fmt_opts", '* | format "<uc:v>|<lc:v>|<q:v>" as out | fields out'),
    ("fmt_opts", '* | format "<duration:n>" as out | fields out'),
    ("fmt_opts", '* | format "<ipv4:ip>" as out | fields out'),
    ("fmt_opts", '* | format "<base64encode:v>|<urlencode:v>|'
                 '<hexencode:v>" as out | fields out'),
    ("math", "* | math a + b as s, a % b as m, a / b as d, a ^ 2 as p "
             "| fields s, m, d, p"),
    ("math2", "* | math a + b * 2 as x, (a + b) * 2 as y, "
              "max(a, b, 5) as mx, min(a, b) as mn, round(7.6) as r, "
              "floor(7.6) as fl, ceil(7.2) as ce, abs(-3) as ab, "
              "b default 9 as df, unknown_field default 9 as df2 "
              "| fields x, y, mx, mn, r, fl, ce, ab, df, df2"),
    ("math2", "* | math exp(a) as e, ln(b) as l, round(a * 3.3, 0.5) as r "
              "| fields e, l, r"),
    ("bits", "* | math a & b as x, a or b as o, a xor b as xo "
             "| fields x, o, xo"),
    ("dur", "* | math d / 1e9 as secs | fields secs"),
    ("json", "* | unpack_json | fields level, nested.x, num"),
    ("json2", "* | unpack_json fields (a) result_prefix p_ "
              "| fields p_a, p_b"),
    ("logfmt", "* | unpack_logfmt | fields level, msg, free"),
    ("syslog", "* | unpack_syslog | fields hostname, app_name, severity, "
               "proc_id, msg_id, ex@1.k, ex@1.q, format, _msg"),
    ("syslog", "* | unpack_syslog offset 2h keep_original_fields"),
    ("words", "* | unpack_words as w | fields w"),
    ("words", "* | unpack_words as w drop_duplicates | fields w"),
    ("dashes", '* | replace ("-", "_") | fields _msg'),
    ("dashes", '* | replace ("-", "_") limit 2 | fields _msg'),
    ("ids", r'* | replace_regexp (`\d+`, "N") | fields _msg'),
    ("secret", '* | replace if (keep:"") ("secret", "xxx") at u '
               '| fields u'),
    ("top", "* | top 2 by (k)"),
    ("top", "* | top 2 by (k) rank as r"),
    ("top", "* | top"),
    ("len", "* | len(_msg) as l | fields l"),
    ("ab", "* | pack_json fields (a, b) as out | fields out"),
    ("pack", "* | pack_logfmt fields (a, b) as out | fields out"),
    ("pack", "* | pack_json | fields _msg"),
    ("unroll", "* | unroll by (tags) | fields _msg, tags"),
    ("empty", "* | fields a, b | drop_empty_fields"),
    ("values", "* | field_values x"),
    ("values", "* | field_names"),
    ("values", "* | blocks_count as bc"),
    ("facets", "* | facets 2"),
    ("facets", "* | facets 2 keep_const_fields"),
    ("chain", "* | eval b+1 as a, a*2 as b, b-10.5+c as c "
              "| fields a, b, c"),
    ("default", "* | math a / b default c as r | fields r"),
    ("one", "* | math '123.45.67.89' + 1000 as ip, 10m5s + 10e9 as dur, "
            "0xff & 0x0f as h, '2024-05-30T01:02:03Z' ^ 1 as t "
            "| fields ip, dur, h, t"),
    ("div", "* | math a / b"),
    ("hex", '* | format "<hexnumencode:n>|<hexnumdecode:h>|'
            '<hexencode:s>|<hexdecode:hx>" as out | fields out'),
    ("wild", "* | fields req_*"),
    ("wild", "* | fields req_*, resp_code"),
    ("wild", '_msg:"" j:* | unpack_json from j fields (a*) '
             '| fields aa, ab, zz'),
    ("ext_vals", '* | extract "baz=<abc> a=<aa>" skip_empty_results '
                 '| fields aa, abc'),
    ("ext_vals", '* | extract "baz=<abc> a=<aa>" | fields aa, abc'),
    ("ext_quoted", '* | extract "baz=<abc> a=<aa>" | fields abc, aa'),
    ("ext_quoted", '* | extract "baz=<abc> a=<aa>" keep_original_fields '
                   '| fields abc, aa'),
    ("fmt_time", "* | format 'time=<time:foo>, duration=<duration:bar>, "
                 "duration_secs=<duration_seconds:d> ip=<ipv4:baz>' as x "
                 "| fields x"),
    ("fmt_unix", "* | format 'a=<time:foo>, b=<time:bar>, c=<time:neg>' "
                 "as x | fields x"),
    ("json_opts", "* | unpack_json skip_empty_results | fields foo, z, a"),
    ("json_opts", "* | unpack_json | fields foo, z, a"),
    ("json_opts", "* | unpack_json keep_original_fields | fields foo, z, a"),
    ("collapse", "* | collapse_nums | fields _msg"),
    ("color", "* | decolorize | fields _msg"),
    ("hash", "* | hash(v) as h | fields h"),
    ("arr", "* | json_array_len(v) as n | fields n"),
    ("join", "_msg:=m | join by (user) (_msg:=names | fields user, "
             "full_name) | sort by (user) | fields user, full_name"),
    ("join", "_msg:=m | join by (user) (_msg:=names | fields user, "
             "full_name) inner | sort by (user) | fields user, full_name"),
    ("join", "_msg:=m | join by (user) (_msg:=names | fields user, "
             "full_name) prefix j_ | fields user, j_full_name"),
    ("union", "alpha | fields _msg | union (beta | fields _msg)"),
    ("ctx", "panic | stream_context before 2 after 1 | fields _msg"),
    ("ctx", "panic | stream_context after 3 time_window 3s "
            "| fields _msg"),
    ("ctx2", "boom | stream_context before 1 | fields _msg"),
    ("top_ref", "* | top by (a)"),
    ("top_ref", "* | top b hits abc"),
    ("top_ref", "* | top by (b) rank as x"),
    ("top_ref", "* | top by (b) rank"),
    ("stats", "* | stats by (g) count() if (error) e, sum(d) if (s:<3) s,"
              " count() n"),
    ("stats", "* | stats by (g) histogram(d) h, uniq_values(s) u, "
              "values(s) limit 4 v"),
    ("stats", "* | stats row_min(d) lo, row_max(d, g) hi, row_any() a"),
    ("stats", "* | stats by (s) json_values(g, d) limit 2 j, "
              "count_uniq_hash(g) ch, count_uniq_hash(g, s) limit 2 c2"),
    ("stats", "* | stats by (_time:week) count() w, count() if (g:g1) g1"),
    ("stats", "* | stats by (_time:month offset 30m, g) count() c"),
    ("stats", "* | stats by (_time:year) uniq_values(g) u"),
    ("stats", "* | math d * 1 as d | stats by (_time:month) "
              "median(d) if (g:g2) m"),
    ("stats", "* | stats by (_time:foo) count() c"),
]


@pytest.fixture(scope="module")
def table_stores(tmp_path_factory):
    _load_port()
    made: dict = {}

    def get(name):
        if name not in made:
            rows = []
            for i, fields in enumerate(TABLES[name]):
                fields = dict(fields)
                rows.append((T0 + i * NS, [("app", fields.pop("app", "a"))]
                             + list(fields.items())))
            made[name] = _pair(str(tmp_path_factory.mktemp("jt" + name)),
                               [rows], ["app"], retention_days=100000)
        return made[name]
    yield get
    for port, jax_st in made.values():
        jax_st.close()
        port.close()


@pytest.mark.parametrize("table,q", TABLE_QUERIES)
def test_table_query_matches_jax(table_stores, table, q):
    port, jax_st = table_stores(table)
    _check(port, jax_st, q, T0)


def test_block_stats_table_matches_jax_but_its_path(table_stores):
    port, jax_st = table_stores("block")
    want, host, dev, _c, _n = _answers(port, jax_st, "* | block_stats", T0)
    assert host == dev
    strip = [{k: v for k, v in r.items() if k != "part_path"}
             for r in want]
    assert [{k: v for k, v in r.items() if k != "part_path"}
            for r in host] == strip
    assert {r["field"] for r in host} >= {"_msg", "code"}
    assert all(r["rows"] == "50" for r in host)


# ---------------- parsing ----------------

ROUNDTRIP = [
    '* | extract "ip=<ip> port=<port>"',
    '* | extract if (x:y) "a=<a>" from f keep_original_fields',
    '* | format "a=<a>" as out',
    "* | math (a + b) * 2 as x",
    "* | unpack_json from f fields (a, b) result_prefix p_",
    "* | unpack_logfmt",
    "* | unpack_syslog",
    '* | replace ("a", "b") at f limit 3',
    '* | replace_regexp ("a.", "b") at f',
    "* | top 5 by (k) rank as r",
    "* | len(x) as l",
    "* | pack_json fields (a, b) as out",
    "* | sample 10",
    "* | unroll by (tags)",
    "* | field_names",
    "* | field_values x limit 5",
    "* | blocks_count",
    "* | drop_empty_fields",
    "* | unpack_words from f as w drop_duplicates",
    "* | collapse_nums at f prettify",
    "* | decolorize at f",
    "* | hash(x) as h",
    "* | json_array_len(x) as n",
    "* | block_stats",
    "* | stream_context before 2 after 3",
    "* | stream_context",
    "* | union (err | fields a)",
    "* | join by (u) (x | fields u, b) inner prefix p_",
    "* | facets 3 max_values_per_field 7 max_value_len 9",
    "* | math a / b default c, -x as nx, now() - _time as age",
    "* | stats count() if (a:b or c) x, sum(d) if (not e) s",
    "* | stats by (_time:week offset 1d) count()",
    "* | stats quantile(0.9, d) if (x) q, median(d) if (x) m",
    "* | stats row_min(a, b, c), row_max(a), json_values() limit 4",
    "* | stats count_uniq_hash(a) limit 3, uniq_values(a), values(a)",
    "* | unpack_syslog from m offset 3h",
    "* | top 3 x, y hits as h rank",
    "* | format if (a:b) '<q:x>' as y skip_empty_results",
]


@pytest.mark.parametrize("qs", ROUNDTRIP)
def test_to_string_matches_jax(qs):
    got = parse_query(qs).to_string()
    assert got == jax_parse(qs).to_string()
    assert parse_query(got).to_string() == got


BAD = [
    "* | nosuchpipe",
    "* | extract",
    '* | extract "no fields"',
    '* | extract "<a><b>"',
    "* | extract_regexp `no groups`",
    "* | math",
    "* | math a +",
    "* | math (a + b",
    "* | math max() as x",
    "* | math round(1, 2, 3) as x",
    "* | math abs(1, 2) as x",
    "* | math a as",
    '* | replace "a", "b"',
    '* | replace ("a" "b")',
    '* | replace ("a", "b"',
    "* | len x",
    "* | len(x",
    "* | sample 0",
    "* | sample x",
    "* | unroll",
    "* | unroll by ()",
    "* | unpack_syslog offset xyz",
    "* | join by (a) x",
    "* | join (a)",
    "* | union x",
    "* | union (a | fields x",
    "* | stream_context time_window 0s",
    "* | stream_context before x",
    "* | hash x",
    "* | json_array_len(x",
    "* | field_values x limit y",
    "* | facets x",
    "* | top 3 by (a",
    "* | stats count() if x",
    "* | stats count() if (a",
    "* | stats row_min() x",
    "* | stats nosuchfunc(x)",
    "* | unpack_json fields a",
]


@pytest.mark.parametrize("qs", BAD)
def test_parse_errors_match_jax(qs):
    with pytest.raises(ValueError) as want:
        jax_parse(qs)
    with pytest.raises(ValueError) as got:
        parse_query(qs)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------- value-level helpers ----------------

PATTERNS = [
    ("ip=<ip> port=<port>", ["ip=1.2.3.4 port=80", "nope",
                             "xx ip=9.9.9.9 port=1", "ip= port="]),
    ("user=<user>", ["user=alice bob", "user="]),
    ("msg=<msg> code=<code>", ['msg="hello world" code=3',
                               'msg="bad \\q" code=3',
                               "msg=`raw` code=4"]),
    ("msg=<plain:msg> code=<code>", ['msg="a b" code=3']),
    ("&lt;<tag>&gt;", ["<div>", "<>"]),
    ("<_> <x> <>", ["a b c", "a"]),
    ("<a>,<b>", ['"x,y",z', '"\\u0041\\x42",c']),
]


@pytest.mark.parametrize("ptn,vals", PATTERNS)
def test_pattern_matches_jax(ptn, vals):
    for v in vals:
        assert PT.Pattern(ptn).apply(v) == JPT.Pattern(ptn).apply(v), v


LOGFMT = ["", "foo=bar", 'foo="bar=baz x=y"', "foo=", "foo", "foo bar",
          "foo bar=baz", 'foo=bar baz="x y" a=b',
          "  foo=bar  baz=x =z qwe", 'a=`raw v` b="unterminated',
          'k="esc \\"q\\" \\n"']


@pytest.mark.parametrize("s", LOGFMT)
def test_logfmt_matches_jax(s):
    assert PT.parse_logfmt(s) == JPT.parse_logfmt(s)


@pytest.mark.parametrize("s", ['[1,"a",true,null]', '"scalar"', "notjson",
                               '[{"a":1},[2,3],1.5,1e20]', "[]"])
def test_json_array_matches_jax(s):
    assert PT.unpack_json_array(s) == JPT.unpack_json_array(s)


FORMAT_VALUES = ["", "abC", "3000000000", "16909060", "1.5", "-7",
                 "1717328141123456789", "1717328141.5", "1h5m35s", "41",
                 "YWJD", "a b/c?d=é", "zz", "%41%20", "-1717328141",
                 "18446744073709551616", "4294967296", "0x1f"]
FORMAT_OPTS = ["", "plain", "q", "uc", "lc", "hexencode", "hexdecode",
               "hexnumencode", "hexnumdecode", "base64encode",
               "base64decode", "urlencode", "urldecode", "duration",
               "duration_seconds", "ipv4", "time", "nosuchopt"]


@pytest.mark.parametrize("opt", FORMAT_OPTS)
def test_format_value_matches_jax(opt):
    for v in FORMAT_VALUES:
        assert PT._format_value(v, opt) == JPT._format_value(v, opt), v


@pytest.mark.parametrize("ns", [0, 1, 999, 1000, 1500, 10**6, 1_500_000,
                                10**9, 210123456789, 3600 * 10**9 + 1,
                                -90 * 10**9, math.nan])
def test_format_duration_matches_jax(ns):
    assert PT._format_duration(ns) == JPT._format_duration(ns)


COLLAPSE = ["", "foo", "ad", "abc", "deadbeef",
            "a b c d e f ad be:eac,dead beef ab", "ыва", "0", "1234567890",
            "1foo", "1 foo", "a1foo2bar34", "a.1Zfoo.2Tbar:34",
            "ЫВА123bar45.78", "ЫВА.123.bar.45.78", "1.23.45.67",
            "2024-12-25T10:20:30Z foo",
            "2024-12-25T10:20:30.123324+05:00 foo", "release v1.2.3",
            "2004-10-12T43:23:12Z abc:345", "123.43s",
            "123ms 2us 3h5m6s43ms43μs324ns", "0x1234 0XFEAD12",
            "35.191.193.225:51648 - 2edfed59-3e98-4073-bbb2-28d321ca71a7 - "
            "- [2024/12/08 15:21:02] 10.71.20.32 GET /foo 200",
            "E1208 15:21:02.748877 62 metric_reporter.go:182",
            "2024-12-08 15:22:32,123 error exporterhelper/q.go:101",
            "2024/12/08T15:22:32-10:30 error x.go:101"]


@pytest.mark.parametrize("s", COLLAPSE)
def test_collapse_nums_matches_jax(s):
    got = PA.collapse_nums(s)
    assert got == JPA.collapse_nums(s)
    assert PA.prettify_collapsed(got) == JPA.prettify_collapsed(got)


SYSLOG = ["<165>1 2024-06-01T12:00:00Z host app 123 - - boom happened",
          "<13>Oct 11 22:14:15 mymachine su[77]: su failed",
          "<13>Feb 30 22:14:15 host tag: bad date",
          '<14>1 2024-06-01T12:00:00Z h a 1 ID7 [ex@1 k="v" q="a\\"b"]'
          '[two@2 z="]"] msg',
          "<14>1 - - - - - -", "<14>1 - - - - - - body", "1 short",
          "plain text line", "<999>not a priority", "<7>Jan  5 01:02:03 "
          "h app: x"]


@pytest.mark.parametrize("line", SYSLOG)
def test_syslog_matches_jax(line):
    from victorialogs_tpu_torch.server.syslog import parse_syslog_message
    for off in (0, 3600 * NS):
        assert parse_syslog_message(line, 2024, off) == \
            jax_syslog(line, 2024, off)


# ---------------- sample and rand() ----------------

def test_sample_and_rand_properties(table_stores):
    """They cannot match the JAX package row for row: `sample 1` keeps
    every row, `sample N` a subset at a rate near 1/N, `rand()` lies in
    [0, 1); a seeded generator repeats its answer."""
    port, _jax = table_stores("block")
    t = [TenantID(0, 0)]
    everything = run_query_collect(port, t, "* | fields _msg", timestamp=T0)
    assert run_query_collect(port, t, "* | sample 1 | fields _msg",
                             timestamp=T0) == everything

    def run(qs, seed, runner=None):
        q = parse_query(qs, T0)
        for p in q.pipes:
            if hasattr(p, "rng"):
                p.rng = random.Random(seed)
        return run_query_collect(port, t, q, runner=runner)

    kept = run("* | sample 4 | fields _msg", 7)
    assert kept == run("* | sample 4 | fields _msg", 7)
    assert all(r in everything for r in kept)
    assert [everything.index(r) for r in kept] == \
        sorted(everything.index(r) for r in kept)
    # over 50 rows the gaps average 4 (uniform in [1, 7))
    assert 5 <= len(kept) <= 25
    total = sum(len(run("* | sample 4 | fields _msg", s))
                for s in range(40))
    assert abs(total / (40 * 50) - 0.25) < 0.05
    runner = TorchBatchRunner(device="cpu")
    try:
        vals = run("* | math rand() as r, rand() * 0 + 1 as one "
                   "| fields r, one", 3, runner)
    finally:
        runner.close()
    rs = [float(r["r"]) for r in vals]
    assert len(rs) == 50 and all(0 <= v < 1 for v in rs)
    assert len(set(rs)) == 50
    assert all(r["one"] == "1" for r in vals)
    assert vals == run("* | math rand() as r, rand() * 0 + 1 as one "
                       "| fields r, one", 3)
    unseeded = run_query_collect(port, t, "* | math rand() as r "
                                 "| fields r", timestamp=T0)
    assert all(0 <= float(r["r"]) < 1 for r in unseeded)


# ---------------- `_time` buckets ----------------

@pytest.mark.parametrize("bucket", ["month", "year", "week", "Month", "1h",
                                    "5m", "1d", "foo"])
def test_time_buckets_match_jax(bucket):
    """Each row's bucket start against the JAX package's per-row
    truncate_timestamp, across month, year and day edges: at them the
    JAX package's float seconds round a row within a microsecond of a
    day's end into the next day."""
    import numpy as np
    from victorialogs_tpu.logsql.pipes import ByField as JBF
    from victorialogs_tpu.logsql.pipes import truncate_timestamp
    from victorialogs_tpu_torch.logsql.pipes import (ByField,
                                                     truncate_timestamps)
    edges = np.array([0, 951_782_400, 1_700_000_000, 1_709_251_200,
                      1_735_689_600], dtype=np.int64) * NS
    ts = np.concatenate(
        [edges + d for d in (-1, 0, 1, -499, -500, -501, -999_999,
                             -1_000_000, -1_000_001, 123)]
        + [np.random.default_rng(1).integers(0, 2_000_000_000 * NS, 2000)])
    for off in ("", "1h", "-3h", "x", "1d"):
        got = truncate_timestamps(ts, ByField("_time", bucket, off))
        want = [truncate_timestamp(int(t), JBF("_time", bucket, off))
                for t in ts.tolist()]
        assert (got is None and want == [None] * len(want)) or \
            got.tolist() == want, off
