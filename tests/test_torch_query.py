"""The slice end to end: LogsQL over the same rows in both packages.

~20k generated rows (one UTC day, strictly increasing timestamps, so no
ties) go into the port's Storage and the JAX package's Storage with
four flushes.  Each query of the list must return exactly the same rows
from

- the port's host executor and the port's TorchBatchRunner(device="cpu")
  (the plain PyTorch versions of the kernels), and
- the JAX package's run_query_collect with no runner and with
  BatchRunner().

The list is chip_smoke.py's plus and/or/not, field and exact filters;
the smoke's regexp and any-case queries have a list of their own.
Also here: queries over parts rebuilt from exported JAX arrays, values
longer than the staging width (settled on the host), the planner's
bloom gate (a bloom leaf ANDed with a scan is one `gscan` node whose
masks equal the unfused `and(bloom, scan)` program's; a leaf that is
not a scan goes ungated and still returns the JAX package's rows),
pipes, stats functions and buckets that were outside earlier slices
parsing as in the JAX package (tests/test_torch_pipes.py and
tests/test_torch_transform.py hold the pipes' rows to it), and a check
that no module of the port and no line of chip_smoke.py imports jax or
victorialogs_tpu.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu.batch import BatchRunner

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)
from victorialogs_tpu_torch.logsql.duration import format_rfc3339
from victorialogs_tpu_torch.storage.convert import part_from_arrays
from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID

REPO = Path(__file__).resolve().parent.parent
ROWS = 20000
HOUR = 3600 * 10**9
T = [TenantID(0, 0)]
JT = [JLR.TenantID(0, 0)]

# torch and the torch-importing modules of the port load on first use,
# in the worker that runs these tests, not in every collecting worker
torch = run_query_collect = TorchBatchRunner = parse_query = None
Partition = Storage = None


def _load_port():
    global torch, run_query_collect, TorchBatchRunner, parse_query
    global Partition, Storage
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.logsql.parser import parse_query
    from victorialogs_tpu_torch.storage.storage import Partition, Storage


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    _load_port()
    start = today_start_ns()
    rows = generate(ROWS, 5, start, NS_PER_DAY // 2, streams=16)
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("jaxstorage")))
    per = ROWS // 4
    for k in range(4):
        lr = LogRows(stream_fields=["app", "host"])
        jl = JLR.LogRows(stream_fields=["app", "host"])
        for ts, fields in rows[k * per:(k + 1) * per]:
            lr.add(TenantID(0, 0), ts, fields)
            jl.add(JLR.TenantID(0, 0), ts, fields)
        port.must_add_rows(lr)
        port.debug_flush()
        jax_st.must_add_rows(jl)
        jax_st.debug_flush()
    yield start, port, jax_st
    jax_st.close()
    port.close()


def _queries(start: int) -> list:
    lo, hi = format_rfc3339(start + HOUR), format_rfc3339(start + 5 * HOUR)
    return [
        "error",
        "resp*",
        '~"onnect"',
        f"_time:[{lo}, {hi}) warn | stats by (_time:1h) count()",
        '_stream:{app="app-3"} timeout | stats count()',
        "quota",
        "* | stats count()",
        "quota | stats by (_time:1h, lvl) count() as n",
        '"GET request" or (lvl:=debug and not merge)',
        "user:=user-12* -error",
        '_stream:{app=~"app-[01]"} quota free',
        f"_time:>{hi} flush | stats by (app) count()",
        "app:app-5 | count()",
        '_stream:{app="app-1"} or error | stats by (lvl) count()',
        '(quota or "GET request") -_stream:{host="host-3"}',
        "* | stats count(), count_uniq(_stream_id)",
        "error | stats by (lvl) count(), sum(dur), avg(dur), min(dur), "
        "max(dur), count(dur)",
        f"_time:[{lo}, {hi}) | stats by (_time:1h, app) count(), "
        f"count_uniq(host)",
        "* | stats by (app) quantile(0.99, status) p99, median(status) p50",
        "warn | stats by (dur:1000) count(), sum_len(_msg), "
        "count_empty(user)",
    ]


def _regex_queries() -> list:
    """The smoke's regexp and any-case queries (BASELINE config 3)."""
    return [
        '~"error.*timeout"',
        '~"quota (GET|POST)"',
        "i(ERROR)",
        "i(RESP*)",
        '~"error.*timeout" | stats by (app) count()',
    ]


def test_query_list_covers_every_smoke_query():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mine = set(_queries(0) + _regex_queries())
    assert all(q in mine for _name, q, _kernels in smoke.queries(0))


@pytest.mark.parametrize("qi", range(20))
def test_query_matches_jax(stores, qi):
    start, port, jax_st = stores
    q = _queries(start)[qi]
    want = jax_run(jax_st, JT, q)
    assert want, q
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    assert run_query_collect(port, T, q, runner=runner) == want
    assert runner.stats_counters["device_parts"] > 0
    runner.close()
    br = BatchRunner()
    try:
        assert jax_run(jax_st, JT, q, runner=br) == want
    finally:
        br.close()


@pytest.mark.parametrize("qi", range(5))
def test_regex_query_matches_jax(stores, qi):
    """The smoke's regexp and any-case queries: the JAX package's rows on
    every part of the device path; `i(ERROR)` returns `error`'s rows
    (the generated text is lower case ASCII)."""
    start, port, jax_st = stores
    q = _regex_queries()[qi]
    want = jax_run(jax_st, JT, q)
    assert want, q
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    assert run_query_collect(port, T, q, runner=runner) == want
    assert runner.stats_counters["device_parts"] == 4
    assert runner.stats_counters["host_parts"] == 0
    # only the verify query leaves rows to the host
    assert (runner.stats_counters["maybe_rows"] > 0) == ("GET" in q)
    runner.close()
    if q == "i(ERROR)":
        assert want == jax_run(jax_st, JT, "error")


def _recording_runner():
    """A cpu TorchBatchRunner that keeps every part's program:
    (tree, args, part, layout)."""
    class Recording(TorchBatchRunner):
        def __init__(self):
            super().__init__(device="cpu")
            self.programs = []

        def _program(self, f, part, bss):
            prog = super()._program(f, part, bss)
            if prog is not None:
                self.programs.append((prog[0], prog[1], part, prog[2]))
            return prog
    return Recording()


def _node_kinds(node, out: set) -> set:
    out.add(node[0])
    if node[0] in ("and", "or"):
        for kid in node[1]:
            _node_kinds(kid, out)
    elif node[0] == "not":
        _node_kinds(node[1], out)
    return out


def _block_ids(part, layout):
    """int32 layout-coordinate block id per row (0 for padding rows)."""
    import numpy as np
    bid = np.zeros(layout.nrows_padded, dtype=np.int32)
    for bi in range(part.num_blocks):
        s = layout.starts[bi]
        bid[s:s + part.block_rows(bi)] = bi
    return torch.from_numpy(bid)


def _unfuse(node, args: list, bid):
    """The program as planned before the gate was fused: each gscan node
    back to and(bloom, scan), the bloom being the standalone probe's
    keep-mask gathered to rows through the block ids (a row-mask leaf
    appended to args)."""
    from victorialogs_tpu_torch.gpu.bloom_device import plane_keep
    kind = node[0]
    if kind == "gscan":
        scan, (pi, nwi, ii, si) = node[1:10], node[10:14]
        keep = plane_keep(args[pi], args[ii], args[si], args[nwi])
        args.append(keep.index_select(0, bid))
        return ("and", (("maskleaf", len(args) - 1), ("scan", *scan)))
    if kind in ("and", "or"):
        return (kind, tuple(_unfuse(k, args, bid) for k in node[1]))
    if kind in ("not", "verify"):
        return (kind, _unfuse(node[1], args, bid))
    return node


@pytest.mark.parametrize("qi", range(20))
def test_fused_program_matches_unfused(stores, qi):
    """On every part, the (definite, maybe) masks of the program with
    gscan nodes equal those of the unfused and(bloom, scan) program."""
    from victorialogs_tpu_torch.gpu.fused import eval_node
    start, port, _jax_st = stores
    runner = _recording_runner()
    run_query_collect(port, T, _queries(start)[qi], runner=runner)
    assert runner.programs
    for tree, args, part, layout in runner.programs:
        if tree in (("true",), ("false",)):
            continue
        args = list(args)
        unfused = _unfuse(tree, args, _block_ids(part, layout))
        rlp = layout.nrows_padded
        d, m = eval_node(tree, args, rlp, runner.device)
        ud, um = eval_node(unfused, args, rlp, runner.device)
        assert torch.equal(d, ud)
        assert (m is None) == (um is None)
        assert m is None or torch.equal(m, um)
    runner.close()


@pytest.mark.parametrize("q,gated", [
    ("quota", True),
    ('(quota or "GET request") -_stream:{host="host-3"}', True),
    # the stream filter leaves only app-0/1 blocks, all of which hold
    # quota: the host bloom keeps every candidate, so nothing is gated
    ('_stream:{app=~"app-[01]"} quota free', False),
])
def test_bloom_leaves_plan_gated_scans(stores, q, gated):
    """A bloom leaf ANDed with a scan plans a gscan node and no bloom
    node; the block-id column is never staged, the block starts are."""
    start, port, jax_st = stores
    runner = _recording_runner()
    assert run_query_collect(port, T, q, runner=runner) ==         jax_run(jax_st, JT, q)
    kinds = set()
    for tree, *_ in runner.programs:
        _node_kinds(tree, kinds)
    assert "bloom" not in kinds and ("gscan" in kinds) == gated
    staged = runner.cache.bytes_by_kind()
    assert "bid" not in staged and ("starts" in staged) == gated
    runner.close()


def test_bloom_beside_ovfmaybe_plans_a_bloom_node(monkeypatch, tmp_path):
    """A phrase at least as long as the staged width only matches
    truncated rows (ovfmaybe), which the host settles; the planner gates
    no such leaf, and the rows equal the JAX package's.  The widest
    staging is cut to 32 bytes so a phrase of the device path's length
    (<= 64 bytes) reaches that branch."""
    from victorialogs_tpu_torch.gpu import layout
    monkeypatch.setattr(layout, "MAX_ROW_WIDTH", 32)
    t0 = today_start_ns()
    msgs = {"a0": "the quota exceeded for the tenant account limit {}",
            "a1": "connection closed by peer after {} retries",
            "a2": "quota ok {}"}
    st = Storage(device="cpu")
    jst = JS.Storage(str(tmp_path))
    lr, jl = LogRows(stream_fields=["app"]), JLR.LogRows(stream_fields=["app"])
    for i in range(300):
        app = f"a{i % 3}"
        fields = [("_msg", msgs[app].format(i)), ("app", app)]
        lr.add(TenantID(0, 0), t0 + i, fields)
        jl.add(JLR.TenantID(0, 0), t0 + i, fields)
    st.must_add_rows(lr)
    st.debug_flush()
    jst.must_add_rows(jl)
    jst.debug_flush()
    q = '"quota exceeded for the tenant account"'
    runner = _recording_runner()
    try:
        want = jax_run(jst, JT, q)
        assert len(want) == 100
        assert run_query_collect(st, T, q, runner=runner) == want
        assert run_query_collect(st, T, q) == want
        kinds = set()
        for tree, *_ in runner.programs:
            _node_kinds(tree, kinds)
        assert "ovfmaybe" in kinds and "gscan" not in kinds
        assert runner.stats_counters["maybe_rows"] > 0
    finally:
        runner.close()
        st.close()
        jst.close()


def test_queries_over_parts_from_exported_arrays(stores):
    from test_torch_storage import export_part
    start, port, jax_st = stores
    (jpt,) = jax_st.partitions.values()
    (tpt,) = port.partitions.values()
    conv = Storage(device="cpu")
    pt = conv.partitions[tpt.day] = Partition(tpt.day)
    pt.streams = dict(tpt.streams)
    pt.parts = [part_from_arrays(export_part(jp))
                for jp in jpt.ddb.snapshot_parts()]
    runner = TorchBatchRunner(device="cpu")
    for q in _queries(start)[:7]:
        want = jax_run(jax_st, JT, q)
        assert run_query_collect(conv, T, q, runner=runner) == want, q
    runner.close()


def test_long_values_settle_on_host():
    """Values longer than the widest staging (2047 bytes) are truncated
    on the device; their rows ride the maybe channel to the host."""
    st = Storage(device="cpu")
    lr = LogRows(stream_fields=["app"])
    t0 = today_start_ns()
    tail = ["needle", "hay", "needle hay", "x"]
    for i in range(40):
        msg = ("pad " * (600 if i % 3 == 0 else 5)) + tail[i % 4]
        lr.add(TenantID(0, 0), t0 + i, [("_msg", msg), ("app", "a")])
    st.must_add_rows(lr)
    st.debug_flush()
    runner = TorchBatchRunner(device="cpu")
    for q in ("needle", "hay", "needle | stats count()", "pad*",
              '~"dle h"'):
        assert run_query_collect(st, T, q, runner=runner) == \
            run_query_collect(st, T, q), q
    assert runner.stats_counters["maybe_rows"] > 0
    runner.close()
    st.close()


@pytest.mark.parametrize("q", [
    "foo | stats uniq_values(x)", "foo | stats by (_time:month) count()",
    "_stream_id:abc | math dur * 2 as d", "foo | stats count() if (x)",
    'foo | extract "<ip> " from _msg', "foo | unpack_json",
    "foo | join by (x) (bar)", "x:>5 | stats values(x)",
    "foo | where y | stats histogram(dur)",
    "foo | sort by (dur) | top 5 by (app)",
    "foo | stats by (_time:week) count()",
])
def test_outside_the_slice_raises(q):
    """These were outside earlier slices (NotImplementedError); each now
    parses to the JAX package's query."""
    from victorialogs_tpu.logsql.parser import parse_query as jax_parse
    assert parse_query(q).to_string() == jax_parse(q).to_string()


def test_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TorchBatchRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchBatchRunner()


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|victorialogs_tpu)\b",
                        re.M)


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "victorialogs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    pkg = REPO / "victorialogs_tpu_torch"
    for mod in ("native/__init__.py", "engine/emit.py",
                "server/insertutil.py", "server/vlselect.py",
                "obs/__init__.py", "obs/tracing.py", "config.py",
                "gpu/pipeline.py"):
        assert pkg / mod in files, mod
    bad = [str(f) for f in files if _IMPORT_RE.search(f.read_text())]
    assert not bad, bad
    code = (
        "import pkgutil, importlib, sys\n"
        "import victorialogs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'victorialogs_tpu' or m.startswith("
        "'victorialogs_tpu.')]\n"
        "assert not bad, bad\n"
        "from victorialogs_tpu_torch.native import emit_ndjson_native\n"
        "import numpy as np\n"
        "z = np.zeros(1, dtype=np.int64)\n"
        "assert emit_ndjson_native([b'\"t\":'], [(3, z)], 1) == "
        "b'{\"t\":\"0\"}\\n'\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libvlemit_' in maps and 'libvlnative' not in maps\n"
        "print('PORT_IMPORTS_CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert "PORT_IMPORTS_CLEAN" in res.stdout, res.stdout + res.stderr
