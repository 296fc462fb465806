"""The port's answers byte for byte against the JAX package's.

The same generated rows (tests/test_torch_query.py's, 20k rows with
four flushes) go into both packages' storage.  Every comparison is
exact, bytes for bytes or dict for dict:

- the NDJSON of every row query of `_queries`, with `| fields`,
  `| limit` and `| offset` variants: the port's `ndjson_block` over its
  walk (no runner and TorchBatchRunner(device="cpu")) against the JAX
  package's `ndjson_block`;
- the native serializer against its per-row oracle `ndjson_block_py`
  (and the JAX package's bytes) on ~1,000 randomized rows of every
  column kind and escape class, and on pipe-made string columns;
- a block holding invalid UTF-8: the JAX package's bytes, written by
  the per-row path and counted in EMIT_COUNTERS["py_blocks"];
- `handle_query` chunks and `handle_stats_query` dicts against the JAX
  handlers for the same args and headers, with and without a runner;
- a handler given no runner answers through the storage's runner on the
  card, and raises where CUDA is unavailable;
- a satisfied `limit` stops the part walk;
- a missing compiler or a corrupt library raises.
"""

import json
import weakref

import numpy as np
import pytest

from victorialogs_tpu.engine.block_result import BlockResult as JBR
from victorialogs_tpu.engine.emit import ndjson_block as jax_ndjson
from victorialogs_tpu.engine.searcher import run_query as jax_run_query
from victorialogs_tpu.server import vlselect as jsel
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.storage import values_encoder as JVE

from test_torch_query import _queries
from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)
from victorialogs_tpu_torch.logsql.duration import format_rfc3339
from victorialogs_tpu_torch.storage import values_encoder as PVE
from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID

ROWS = 20000
HOUR = 3600 * 10**9
T = [TenantID(0, 0)]
JT = [JLR.TenantID(0, 0)]

# torch and the torch-importing modules of the port load on first use,
# in the worker that runs these tests, not in every collecting worker
torch = Storage = TorchBatchRunner = run_query = None
emit = native = sel = BlockResult = None


def _load_port():
    global torch, Storage, TorchBatchRunner, run_query
    global emit, native, sel, BlockResult
    import torch
    from victorialogs_tpu_torch import native
    from victorialogs_tpu_torch.engine import emit
    from victorialogs_tpu_torch.engine.block_result import BlockResult
    from victorialogs_tpu_torch.engine.searcher import run_query
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
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
    _load_port()
    start = today_start_ns()
    rows = generate(ROWS, 5, start, NS_PER_DAY // 2, streams=16)
    port, jax_st = _ingest(rows, ["app", "host"], 4,
                           str(tmp_path_factory.mktemp("jaxemit")))
    yield start, port, jax_st
    jax_st.close()
    port.close()


def _row_queries(start):
    return [q for q in _queries(start) if "stats" not in q
            and "count()" not in q]


_VARIANTS = ["", " | fields _time, lvl, dur", " | limit 7",
             " | offset 3 | limit 5", " | keep _msg, app, user | offset 40",
             " | fields ap*, _stream | head 60 | skip 50"]


def _port_ndjson(port, q, runner=None) -> list:
    chunks = []
    run_query(port, T, q, lambda br: chunks.append(emit.ndjson_block(br)),
              runner=runner)
    return [c for c in chunks if c]


def _jax_ndjson(jax_st, q) -> list:
    chunks = []
    jax_run_query(jax_st, JT, q,
                  write_block=lambda br: chunks.append(jax_ndjson(br)))
    return [c for c in chunks if c]


def test_row_query_list():
    assert len(_row_queries(0)) == 8


@pytest.mark.parametrize("vi", range(len(_VARIANTS)))
@pytest.mark.parametrize("qi", range(8))
def test_ndjson_matches_jax(stores, qi, vi):
    start, port, jax_st = stores
    q = _row_queries(start)[qi] + _VARIANTS[vi]
    want = _jax_ndjson(jax_st, q)
    assert want, q
    py_blocks = emit.EMIT_COUNTERS["py_blocks"]
    assert _port_ndjson(port, q) == want
    runner = TorchBatchRunner(device="cpu")
    assert _port_ndjson(port, q, runner) == want
    assert runner.stats_counters["device_parts"] > 0
    assert runner.stats_counters["host_parts"] == 0
    runner.close()
    assert emit.EMIT_COUNTERS["py_blocks"] == py_blocks


def test_fields_keeps_the_stored_block(stores):
    start, port, _jax_st = stores
    blocks = []
    run_query(port, T, "error | fields _time, lvl, dur", blocks.append)
    assert blocks
    for br in blocks:
        assert br._bs is not None
        assert br.column_names() == ["_time", "lvl", "dur"]
        assert [c[0] for c in br.emit_columns()[1]] == [1, 0, 4]
        assert emit.ndjson_block(br) == emit.ndjson_block_py(br)


# ---- the serializer against its per-row oracle ----

_ALPHABET = ('ab"\\\n\r\t\x00\x01\x1f\x7f\x08\x0c'
             'é日\U0001f642 /{}[]:,')


def _hostile(rng, lo=0, hi=24) -> str:
    return "".join(_ALPHABET[i] for i in
                   rng.integers(0, len(_ALPHABET), rng.integers(lo, hi)))


def _random_rows(n: int, start: int) -> list:
    rng = np.random.default_rng(0xE417)
    rows = []
    for i in range(n):
        w = (0, 3, 6, 9)[i % 4]               # one stream per width
        sec = int(rng.integers(0, 86400))
        frac = f".{int(rng.integers(0, 10**w)):0{w}d}" if w else ""
        iso = (f"2026-03-{1 + i % 28:02d}T{sec // 3600:02d}:"
               f"{sec // 60 % 60:02d}:{sec % 60:02d}{frac}Z")
        neg = -(2**63) if i == 5 else -int(rng.integers(1, 2**62))
        fields = [
            ("app", f"app-{i % 4}"),
            ("_msg", _hostile(rng, 1)),
            ("s", _hostile(rng)),             # may be empty: omitted
            ("big", str(int(rng.integers(2**63, 2**64 - 1,
                                         dtype=np.uint64)))),
            ("neg", str(neg)),
            ("iso", iso),
            ("flt", repr(float(rng.normal() * 10.0 **
                               int(rng.integers(-8, 9))))),
            ("konst", "the same \"everywhere\""),
            ("lvl", ("info", "warn", "érr", "")[i % 4 if i % 3 else 0]),
            ("ip", f"10.{i % 7}.{i % 250}.{i % 13}"),
            ("small", str(int(rng.integers(0, 300)))),
        ]
        if i % 5 == 0:
            fields.append(("sparse", _hostile(rng, 1)))
        rows.append((start + i * 1_000_003, fields))
    return rows


@pytest.fixture(scope="module")
def random_stores(tmp_path_factory):
    _load_port()
    rows = _random_rows(1000, today_start_ns())
    port, jax_st = _ingest(rows, ["app"], 2,
                           str(tmp_path_factory.mktemp("jaxrandom")))
    yield rows, port, jax_st
    jax_st.close()
    port.close()


def test_randomized_rows_native_equals_per_row(random_stores):
    rows, port, jax_st = random_stores
    blocks = []
    run_query(port, T, "*", blocks.append)
    assert sum(br.nrows for br in blocks) == len(rows)
    kinds = set()
    vtypes = set()
    for br in blocks:
        names, cols = br.emit_columns()
        kinds |= {c[0] for c in cols}
        vtypes |= {br._bs.column(n).vtype for n in names
                   if br._bs.column(n) is not None}
        nat = emit.ndjson_block(br)
        assert nat == emit.ndjson_block_py(br)
        got = [json.loads(ln) for ln in nat.splitlines()]
        assert got == br.rows()
    # every emit kind and the float, dict, IPv4 and string encodings
    assert kinds == {0, 1, 2, 3, 4}
    assert {PVE.VT_STRING, PVE.VT_DICT, PVE.VT_FLOAT64, PVE.VT_IPV4,
            PVE.VT_UINT64, PVE.VT_INT64, PVE.VT_TIMESTAMP_ISO8601,
            PVE.VT_UINT16} <= vtypes
    assert b"".join(emit.ndjson_block(br) for br in blocks) == \
        b"".join(_jax_ndjson(jax_st, "*"))


def test_randomized_pipe_columns(random_stores):
    rng = np.random.default_rng(5)
    n = 1000
    cols = {f"f{k}": [_hostile(rng) for _ in range(n)] for k in range(5)}
    cols["fixed"] = ["x"] * n
    cols["blank"] = [""] * n
    br = BlockResult.from_columns(cols)
    nat = emit.ndjson_block(br)
    assert nat == emit.ndjson_block_py(br)
    assert nat == jax_ndjson(JBR.from_columns(cols))
    for i, ln in enumerate(nat.splitlines()):
        assert json.loads(ln) == {k: v[i] for k, v in cols.items() if v[i]}


class _OneColumnBlock:
    """A stored block of one string column `k`, enough of BlockSearch
    for either package's BlockResult."""

    def __init__(self, col, ts):
        self.col = col
        self.ts = ts
        self.nrows = len(ts)

    def timestamps(self):
        return self.ts

    def consts(self):
        return {}

    def column(self, name):
        return self.col if name == "k" else None

    def has_column(self, name):
        return name == "k"

    def column_names(self):
        return ["k"]

    def values(self, name):
        return self.col.to_strings(self.nrows) if name == "k" \
            else [""] * self.nrows


def test_invalid_utf8_block_takes_the_per_row_path():
    vals = [b"ok", b"bad\xff\xfe", "café".encode()[:-1], b"\xed\xa0\x80",
            "fine \U0001f642".encode()]
    arena = np.frombuffer(b"".join(vals), dtype=np.uint8)
    lengths = np.array([len(v) for v in vals], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    ts = np.arange(len(vals), dtype=np.int64) * 10**9
    bm = np.array([True, True, False, True, True])
    needed = {"k"}

    def block(ve):
        return _OneColumnBlock(ve.EncodedColumn(
            name="k", vtype=ve.VT_STRING, arena=arena, offsets=offsets,
            lengths=lengths), ts)

    want = jax_ndjson(JBR.from_block_search(block(JVE), bm, needed))
    assert "�".encode() in want
    before = emit.EMIT_COUNTERS["py_blocks"]
    br = BlockResult.from_block_search(block(PVE), bm, needed)
    assert emit.ndjson_block(br) == want
    assert emit.EMIT_COUNTERS["py_blocks"] == before + 1
    assert native.emit_ndjson_native(
        [b'"k":'], [br.emit_columns(["k"])[1][0]], br.nrows) is None
    # the rows without invalid bytes go the native way
    ok = BlockResult.from_block_search(block(PVE), np.array(
        [True, False, False, False, True]), needed)
    assert emit.ndjson_block(ok) == jax_ndjson(JBR.from_block_search(
        block(JVE), np.array([True, False, False, False, True]), needed))
    assert emit.EMIT_COUNTERS["py_blocks"] == before + 1


# ---- the handlers ----

def _handler_args(start):
    lo, hi = format_rfc3339(start + HOUR), format_rfc3339(start + 5 * HOUR)
    now = format_rfc3339(start + 13 * HOUR)
    secs = str((start + 2 * HOUR) // 10**9)
    millis = str((start + 9 * HOUR) // 10**6)
    return [
        ({"query": "error", "time": now}, {}),
        ({"query": "resp*", "limit": "0"}, {}),
        ({"query": "quota", "limit": "25", "offset": "40"}, {}),
        ({"query": '~"onnect"', "start": lo, "end": hi, "limit": "0"}, {}),
        ({"query": "error | fields _time, lvl, dur", "limit": "5",
          "offset": "2"}, {}),
        ({"query": "* | stats by (lvl) count()", "time": now}, {}),
        ({"query": "warn", "start": secs, "end": millis, "limit": "300"},
         {}),
        ({"query": "user:=user-12* -error", "offset": "3"},
         {"AccountID": "0", "ProjectID": "0"}),
        ({"query": "error", "AccountID": "0", "ProjectID": "0",
          "limit": "2000"}, {}),
        ({"query": "error"}, {"AccountID": "1"}),
        ({"query": "_time:5h error | limit 20", "time": now}, {}),
    ]


@pytest.mark.parametrize("with_runner", [False, True])
@pytest.mark.parametrize("ai", range(11))
def test_handle_query_matches_jax(stores, ai, with_runner):
    start, port, jax_st = stores
    args, headers = _handler_args(start)[ai]
    want = list(jsel.handle_query(jax_st, dict(args), dict(headers)))
    if ai != 9:
        assert want
    runner = TorchBatchRunner(device="cpu") if with_runner else None
    assert sel.handle_query(port, dict(args), dict(headers),
                            runner=runner) == want
    if runner is not None:
        assert runner.stats_counters["host_parts"] == 0
        runner.close()


def _stats_args(start):
    now = format_rfc3339(start + 13 * HOUR)
    lo = format_rfc3339(start + 2 * HOUR)
    out = [({"query": q, "time": now}, {}) for q in _queries(start)
           if "stats" in q or "count()" in q]
    out.append(({"query": "error | stats by (app) count(), sum(dur)",
                 "time": str((start + 3 * HOUR) // 10**9), "start": lo},
                {}))
    out.append(({"query": "* | stats by (lvl) count() | limit 2",
                 "time": now}, {"AccountID": "0"}))
    out.append(({"query": "* | stats count()", "time": now},
                {"AccountID": "7", "ProjectID": "1"}))
    return out


@pytest.mark.parametrize("with_runner", [False, True])
@pytest.mark.parametrize("si", range(15))
def test_handle_stats_query_matches_jax(stores, si, with_runner):
    start, port, jax_st = stores
    args, headers = _stats_args(start)[si]
    want = jsel.handle_stats_query(jax_st, dict(args), dict(headers))
    assert want["data"]["result"]
    runner = TorchBatchRunner(device="cpu") if with_runner else None
    assert sel.handle_stats_query(port, dict(args), dict(headers),
                                  runner=runner) == want
    if runner is not None:
        assert runner.stats_counters["host_parts"] == 0
        # the last case asks for a tenant without rows
        assert (runner.stats_counters["device_parts"] > 0) == (si != 14)
        runner.close()


def test_stats_args_cover_every_stats_query():
    assert len(_stats_args(0)) == 15


@pytest.mark.parametrize("args,status", [
    ({}, 400),
    ({"query": "error", "limit": "x"}, 400),
    ({"query": "error", "start": "yesterday-ish"}, 400),
    ({"query": "error", "end": "nan"}, 400),
    ({"query": "error", "time": "1e400"}, 400),
    ({"query": "error | nosuchpipe"}, 400),
    ({"query": "error", "extra_filters": '{"app":"app-1"'}, 400),
    ({"query": "error", "extra_stream_filters": '{app="app-1"'}, 400),
])
def test_handle_query_refuses(stores, args, status):
    _start, port, _jax_st = stores
    with pytest.raises(sel.HTTPError) as e:
        sel.handle_query(port, args, {})
    assert e.value.status == status


def test_stats_query_needs_stats(stores):
    _start, port, jax_st = stores
    with pytest.raises(jsel.HTTPError) as je:
        jsel.handle_stats_query(jax_st, {"query": "error"}, {})
    with pytest.raises(sel.HTTPError) as e:
        sel.handle_stats_query(port, {"query": "error"}, {})
    assert (e.value.status, e.value.message) == \
        (je.value.status, je.value.message)


@pytest.mark.parametrize("q", ["error | limit 10", "quota | head 3",
                               "* | offset 5 | limit 5"])
def test_satisfied_limit_stops_the_walk(stores, monkeypatch, q):
    # the serial walk; the dispatch window stops there too, with up to
    # VL_INFLIGHT units in flight (tests/test_torch_pipeline.py)
    monkeypatch.setenv("VL_INFLIGHT", "1")
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    _start, port, _jax_st = stores
    parts = {}
    for text in (q, q.split(" | ")[0]):
        runner = TorchBatchRunner(device="cpu")
        run_query(port, T, text, lambda br: None, runner=runner)
        parts[text] = runner.stats_counters["device_parts"]
        runner.close()
    assert parts[q] == 1
    assert parts[q.split(" | ")[0]] == 4


def test_handle_query_default_limit_runs_one_part(stores, monkeypatch):
    monkeypatch.setenv("VL_INFLIGHT", "1")      # the serial walk
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    _start, port, _jax_st = stores
    runner = TorchBatchRunner(device="cpu")
    chunks = sel.handle_query(port, {"query": "error"}, {}, runner=runner)
    assert b"".join(chunks).count(b"\n") == 1000
    assert runner.stats_counters["device_parts"] == 1
    runner.close()


@pytest.mark.parametrize("handler,args", [
    ("handle_query", {"query": "error"}),
    ("handle_stats_query", {"query": "error | stats by (app) count()",
                            "time": "2024-01-01T00:00:00Z"}),
])
def test_handlers_default_to_the_card(stores, monkeypatch, handler, args):
    """A handler given no runner makes the storage's runner with the
    default device (the card) and answers through it."""
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
    assert len(made) == 1                # kept warm for the storage
    runner.close()


@pytest.mark.parametrize("handler", ["handle_query", "handle_stats_query"])
def test_handlers_without_cuda_raise(stores, monkeypatch, handler):
    """Where CUDA is unavailable a handler given no runner raises: it
    never answers on the host unless asked to."""
    _start, port, _jax_st = stores
    monkeypatch.setattr(sel, "_card_runners", weakref.WeakKeyDictionary())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(sel, handler)(port, {"query": "error | stats count()"}, {})


@pytest.mark.cuda
def test_handle_query_default_runs_on_the_card(stores, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setenv("VL_INFLIGHT", "1")      # the serial walk
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    _start, port, _jax_st = stores
    got = sel.handle_query(port, {"query": "error"}, {})
    runner = sel.card_runner(port)
    assert runner.device.type == "cuda"
    assert runner.stats_counters["device_parts"] == 1
    assert got == sel.handle_query(port, {"query": "error"}, {},
                                   runner=None)


def test_host_walk_stops_within_a_part(stores, monkeypatch):
    """Without a runner the filter runs block by block and stops with
    the limit."""
    from victorialogs_tpu_torch.engine import searcher
    _start, port, _jax_st = stores
    calls = []
    orig = searcher.host_bitmap
    monkeypatch.setattr(searcher, "host_bitmap",
                        lambda f, bs: calls.append(bs) or orig(f, bs))
    run_query(port, T, "* | limit 3", lambda br: None)
    assert len(calls) == 1


# ---- the serializer's build ----

def _one_block(port):
    blocks = []
    run_query(port, T, "error | limit 3", blocks.append)
    return blocks[0]


def test_missing_compiler_raises(stores, tmp_path, monkeypatch):
    _start, port, _jax_st = stores
    br = _one_block(port)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "vl-no-such-compiler")
    before = emit.EMIT_COUNTERS["py_blocks"]
    with pytest.raises(RuntimeError, match="cannot be built"):
        emit.ndjson_block(br)
    assert emit.EMIT_COUNTERS["py_blocks"] == before


def test_corrupt_library_raises(stores, tmp_path, monkeypatch):
    _start, port, _jax_st = stores
    br = _one_block(port)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    native.library_path().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load"):
        emit.ndjson_block(br)


def test_failed_build_raises(stores, tmp_path, monkeypatch):
    _start, port, _jax_st = stores
    br = _one_block(port)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-include", "no/such/header.h"))
    with pytest.raises(RuntimeError, match="failed on native/emit.cpp"):
        emit.ndjson_block(br)
    assert not list(tmp_path.glob("*.so"))


def test_build_is_cached_by_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    assert native.build() > 0
    assert native.build() == 0.0
    assert native.library_path().name.startswith("libvlemit_")
    assert native.load() is native.load()


@pytest.mark.parametrize("keys,cols,nrows", [
    ([b'"k":'], [(0, np.zeros(4, np.uint8), np.array([2]), np.array([3]))],
     1),
    ([b'"k":'], [(0, np.zeros(4, np.uint8), np.array([0, 1]),
                  np.array([1, 1]))], 1),
    ([b'"k":'], [(0, np.zeros(4, np.uint8), np.array([-1]),
                  np.array([1]))], 1),
    ([b'"k":'], [(3, np.zeros(2, np.int64))], 1),
    ([b'"k":'], [(2, np.zeros(1, np.int64), 10)], 1),
    ([b'"k":'], [(7, np.zeros(1, np.int64))], 1),
    ([], [(3, np.zeros(1, np.int64))], 1),
])
def test_serializer_rejects_malformed_columns(keys, cols, nrows):
    with pytest.raises(ValueError):
        native.emit_ndjson_native(keys, cols, nrows)
