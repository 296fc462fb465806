"""Value stats of the port against the JAX package, exactly.

- Device function: `stats_values_plain` (the value kernel's plain
  version) of one, two and three columns against
  kernels.stats_values_local of each column, the JAX byte-plane sums
  put together by stats_device.combine_plane_sums: 1, 7, 66, 1000 and
  8192 cells, ragged row counts, every row masked off, empty cells,
  every masked row in one cell, ids outside [0, nb).
- Staging: the port's stage_numeric, stage_len_column,
  stage_empty_column and stage_num_buckets against the JAX ones on a
  part built from the same rows through both packages (uint, int64,
  float, string, dict, const and missing blocks; multibyte text).
- Planning: device_stats_spec of both packages on every stats query
  the port parses; where one declines, both decline.
- End to end: run_query_collect of the port's host executor and of
  TorchBatchRunner(device="cpu") against the JAX host executor and
  BatchRunner() on tests/test_device_stats.py's queries that the port
  parses, and a rate(); every part the JAX runner reduces on its
  device the port reduces on the card too.  Also: count_uniq of a
  string column and a cell product above 8192, which leave the stats
  to the host pipe, and maybe rows (values wider than the staging)
  whose value, uniq and quantile contributions come from
  residue_partials.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

import jax.numpy as jnp
from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu import batch as JBatch
from victorialogs_tpu.tpu import kernels as JK
from victorialogs_tpu.tpu import stats_device as JSD

from test_device_stats import STATS_QUERIES

NS = 1_000_000_000

# torch and the port load on first use, in the worker that runs these
# tests, not in every worker that merely collects this module
torch = TSS = TSD = TST = None


@pytest.fixture(autouse=True)
def _port():
    """Import the port; cap torch's intra-op pool next to other
    workers and restore it after."""
    global torch, TSS, TSD, TST
    import torch
    from victorialogs_tpu_torch.gpu import stats_device as TSD
    from victorialogs_tpu_torch.gpu import stats_seg as TSS
    from victorialogs_tpu_torch.gpu import stats_stage as TST
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


# ---------------- the device function ----------------

def _values_case(seed: int, r: int, nb: int, kept: float):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 32, size=r, dtype=np.uint64).astype(np.uint32)
    v[::5] = 0
    v[1::7] = 0xFFFFFFFF
    # ids over half the cells only (the rest stay empty) plus some out
    # of range
    ids = rng.integers(-1, max(nb // 2, 1) + 1, size=r).astype(np.int32)
    ids[ids == max(nb // 2, 1)] = nb
    m = rng.random(r) < kept
    return v, ids, m


def _jax_values(v, ids, m, nb):
    """JAX's (count, sum, min, max) as numpy, rows padded with masked-off
    rows to a STATS_CHUNK multiple."""
    r = v.shape[0]
    pad = (-r) % JK.STATS_CHUNK
    cnt, sums, lo, hi = JK.stats_values_local(
        jnp.asarray(np.pad(v, (0, pad))), jnp.asarray(np.pad(ids, (0, pad))),
        jnp.asarray(np.pad(m, (0, pad))), nb)
    sums = np.asarray(sums)
    total = [JSD.combine_plane_sums(sums[:, b]) for b in range(nb)]
    return (np.asarray(cnt).astype(np.int64), np.array(total, np.int64),
            np.asarray(lo).astype(np.int64), np.asarray(hi).astype(np.int64))


def _port_matches_jax(cols, ids, m, nb):
    """The port's stats_values of the columns against the JAX
    stats_values_local of each column, bit for bit; returns JAX's
    counts."""
    packed = TSS.stats_values([torch.from_numpy(v.view(np.int32))
                               for v in cols],
                              torch.from_numpy(ids), torch.from_numpy(m), nb)
    assert packed.dtype == torch.int32 and packed.shape == (len(cols), 5 * nb)
    for v, row in zip(cols, packed):
        want = _jax_values(v, ids, m, nb)
        cnt, sums, mn, mx = TSS.split_values(row, nb)
        assert np.array_equal(cnt.numpy(), want[0])
        assert np.array_equal(sums.numpy(), want[1])
        assert np.array_equal(mn.numpy().view(np.uint32), want[2])
        assert np.array_equal(mx.numpy().view(np.uint32), want[3])
    return want[0]


@pytest.mark.parametrize("nb,r,kept", [
    (1, 8192, 0.6), (7, 12289, 0.6), (1000, 20000, 0.6), (8192, 8192, 0.6),
    (7, 5000, 0.0), (1000, 3, 1.0)])
def test_stats_values_plain_matches_stats_values_local(nb, r, kept):
    """One, two and three value columns over the same ids and mask, each
    column against the JAX reduction (a row of a two- or three-column
    result starts at an odd word where nb is odd)."""
    for ncol in (1, 2, 3):
        cols = [_values_case(nb + r + 101 * c, r, nb, kept)[0]
                for c in range(ncol)]
        _v, ids, m = _values_case(nb + r, r, nb, kept)
        cnt = _port_matches_jax(cols, ids, m, nb)
        if kept == 0.0:
            assert not cnt.any()
        else:
            assert cnt.any() and (nb == 1 or not cnt.all())


@pytest.mark.parametrize("case", ["one-cell", "outside"])
def test_stats_values_edges_match_stats_values_local(case):
    """Every masked row in one cell; ids only outside [0, nb) or masked
    off (no row counts anywhere); two columns each."""
    rng = np.random.default_rng(23)
    r, nb = 9000, 66
    cols = [_values_case(c, r, nb, 1.0)[0] for c in (5, 6)]
    m = rng.random(r) < 0.6
    if case == "one-cell":
        ids = np.where(m, 17, rng.integers(0, nb, size=r)).astype(np.int32)
    else:
        ids = np.where(m, rng.choice([-5, -1, nb, nb + 3, 1 << 30], size=r),
                       rng.integers(0, nb, size=r)).astype(np.int32)
    cnt = _port_matches_jax(cols, ids, m, nb)
    if case == "one-cell":
        assert cnt[17] == m.sum() and cnt.sum() == m.sum()
    else:
        assert not cnt.any()


def test_stats_values_rejects_no_cells():
    with pytest.raises(ValueError):
        TSS.stats_values([torch.zeros(4, dtype=torch.int32)],
                         torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), 0)
    with pytest.raises(ValueError):
        TSS.stats_values([], torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), 4)


# ---------------- staging ----------------

def _mixed_rows(t0: int) -> list:
    """~800 rows over streams whose `v` is uint, string, missing, dict,
    int64, float and const; `big` passes the exactness guard, `huge`
    does not; `_msg` holds multibyte text; `user` is sometimes empty."""
    rng = np.random.default_rng(17)
    rows = []
    kinds = ["uint", "str", "missing", "dict", "int", "float", "const"]
    for k, kind in enumerate(kinds):
        for i in range(115):
            v = {"uint": str(rng.integers(0, 1000)),
                 "str": f"x{i % 13}",
                 "missing": "",
                 "dict": ("5", "17", "300")[i % 3],
                 "int": str(rng.integers(-150, 151)),
                 "float": f"{rng.integers(0, 80) / 8}",
                 "const": "42"}[kind]
            msg = "é" * (i % 4) + f" req {kind} " + "日本" * (i % 3)
            fields = [("app", kind), ("_msg", msg),
                      ("user", "" if i % 5 == 0 else f"u{i % 9}"),
                      ("big", str(3_000_000_000 + i * 977)),
                      ("huge", str((1 << 62) + i))]
            if v:
                fields.append(("v", v))
            rows.append((t0 + (k * 115 + i) * NS, fields))
    return rows


@pytest.fixture(scope="module")
def mixed_parts():
    """(port part, JAX part) built from the same rows."""
    from victorialogs_tpu_torch.cli.vlogsgenerator import today_start_ns
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    port = Storage(device="cpu")
    jst = JS.Storage(tempfile.mkdtemp(prefix="vl_stats_stage_"))
    lr = LogRows(stream_fields=["app"])
    jl = JLR.LogRows(stream_fields=["app"])
    for ts, fields in _mixed_rows(today_start_ns()):
        lr.add(TenantID(0, 0), ts, fields)
        jl.add(JLR.TenantID(0, 0), ts, fields)
    port.must_add_rows(lr)
    port.debug_flush()
    jst.must_add_rows(jl)
    jst.debug_flush()
    (tpt,) = port.partitions.values()
    (jpt,) = jst.partitions.values()
    (tp,) = tpt.parts
    (jp,) = jpt.ddb.snapshot_parts()
    yield tp, jp
    jst.close()
    port.close()


def _layouts(tp, jp):
    from victorialogs_tpu_torch.gpu.fused import part_layout
    tl, jl = part_layout(tp), JBatch.part_stats_layout(jp)
    assert tl.starts == jl.starts and tl.nrows == jl.nrows
    return tl, jl


def _put(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_numeric(got, want, nrows: int):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert (got.vmin, got.vmax, got.eligible) == \
        (want.vmin, want.vmax, want.eligible)
    assert np.array_equal(got.values.numpy().view(np.uint32)[:nrows],
                          np.asarray(want.values)[:nrows])
    assert not got.values[nrows:].any()


@pytest.mark.parametrize("field", ["v", "big", "huge", "user", "nosuch"])
def test_stage_numeric_matches_jax(mixed_parts, field):
    tp, jp = mixed_parts
    tl, jl = _layouts(tp, jp)
    got = TST.stage_numeric(tp, field, tl, TSD.MAX_ABS_TIMES_ROWS, _put)
    want = JBatch.stage_numeric(jp, field, jl, JSD.MAX_ABS_TIMES_ROWS,
                                put=np.asarray)
    _same_numeric(got, want, tl.nrows)
    assert (got is not None) == (field in ("v", "big"))


@pytest.mark.parametrize("field", ["v", "_msg", "user", "app", "_stream",
                                   "_stream_id", "nosuch"])
def test_stage_len_and_empty_columns_match_jax(mixed_parts, field):
    tp, jp = mixed_parts
    tl, jl = _layouts(tp, jp)
    _same_numeric(
        TST.stage_len_column(tp, field, tl, TSD.MAX_ABS_TIMES_ROWS, _put),
        JBatch.stage_len_column(jp, field, jl, JSD.MAX_ABS_TIMES_ROWS,
                                put=np.asarray), tl.nrows)
    _same_numeric(TST.stage_empty_column(tp, field, tl, _put),
                  JBatch.stage_empty_column(jp, field, jl, put=np.asarray),
                  tl.nrows)


@pytest.mark.parametrize("field,step,off", [
    ("v", 10.0, 0.0), ("v", 100.0, 7.0), ("v", 0.25, 0.0),
    ("big", 1e6, 3.0), ("user", 10.0, 0.0)])
def test_stage_num_buckets_matches_jax(mixed_parts, field, step, off):
    tp, jp = mixed_parts
    tl, jl = _layouts(tp, jp)
    got = TST.stage_num_buckets(tp, field, tl, step, off, _put)
    want = JBatch.stage_num_buckets(jp, field, jl, step, off,
                                    put=np.asarray)
    assert (got is None) == (want is None) == (field == "user")
    if got is not None:
        assert got.values == want.values and got.eligible == want.eligible
        assert np.array_equal(got.ids.numpy()[:tl.nrows],
                              np.asarray(want.ids)[:tl.nrows])


# ---------------- planning ----------------

def _extra_queries(lo: str, hi: str) -> list:
    return [
        "* | stats count(), count_uniq(_stream_id)",
        "error | stats by (lvl) count(), sum(dur), avg(dur), min(dur), "
        "max(dur), count(dur)",
        f"_time:[{lo}, {hi}) | stats by (_time:1h, app) count(), "
        f"count_uniq(host)",
        "* | stats by (app) quantile(0.99, status) p99, median(status) p50",
        "warn | stats by (dur:1000) count(), sum_len(_msg), "
        "count_empty(user)",
        "* | stats count_uniq(user)",
        "* | stats sum_len(_time), count_empty(_time), count(_time)",
        "* | stats by (_time:1s, app) count(), count_uniq(_stream_id)",
        "* | stats count_uniq(app, dur) limit 3, sum(dur, delta)",
        "* | stats rate_sum(dur), rate(), min(*)",
        "* | stats by (lvl:abc offset x) count()",
    ]


def _planned_queries(t0: int) -> list:
    """The JAX package's device-stats queries and the extra ones; the
    port parses all of them."""
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    return STATS_QUERIES + _extra_queries(format_rfc3339(t0),
                                          format_rfc3339(t0 + 600 * NS))


def _spec_dict(spec):
    return None if spec is None else dataclasses.asdict(spec)


def test_device_stats_spec_matches_jax():
    from victorialogs_tpu_torch.cli.vlogsgenerator import today_start_ns
    from victorialogs_tpu_torch.logsql.parser import parse_query
    t0 = today_start_ns()
    qs = _planned_queries(t0)
    assert len(qs) >= 45
    declined = 0
    for q in qs:
        got = _spec_dict(TSD.device_stats_spec(parse_query(q, t0)))
        want = _spec_dict(JSD.device_stats_spec(jax_parse(q, t0)))
        assert got == want, q
        declined += got is None
    assert 3 <= declined < len(qs) // 2


# ---------------- end to end ----------------

T0_OFFSET_ROWS = 6000


@pytest.fixture(scope="module")
def stats_stores():
    """tests/test_device_stats.py's rows (uint, int64, float columns; a
    second part whose `dur` is a string) under today's date, in both
    packages: (t0, port storage, JAX storage)."""
    from victorialogs_tpu_torch.cli.vlogsgenerator import today_start_ns
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    t0 = today_start_ns()
    port = Storage(device="cpu")
    jst = JS.Storage(tempfile.mkdtemp(prefix="vl_stats_e2e_"))

    def add(rows):
        lr = LogRows(stream_fields=["app"])
        jl = JLR.LogRows(stream_fields=["app"])
        for ts, fields in rows:
            lr.add(TenantID(0, 0), ts, fields)
            jl.add(JLR.TenantID(0, 0), ts, fields)
        port.must_add_rows(lr)
        port.debug_flush()
        jst.must_add_rows(jl)
        jst.debug_flush()

    add([(t0 + i * 250_000_000, [
        ("app", f"app{i % 3}"),
        ("_msg", f"req {'deadline' if i % 7 == 0 else 'ok'} item{i % 50}"),
        ("dur", str(i % 907)), ("delta", str((i % 301) - 150)),
        ("ratio", f"{(i % 13) / 8}")]) for i in range(T0_OFFSET_ROWS)])
    add([(t0 + (T0_OFFSET_ROWS + i) * 250_000_000, [
        ("app", "app9"), ("_msg", f"req deadline tail{i % 10}"),
        ("dur", f"x{i % 11}"), ("delta", str(i % 17))])
        for i in range(1500)])
    yield t0, port, jst
    jst.close()
    port.close()


def _port_runner():
    """A cpu TorchBatchRunner that records, per part (min_ts, rows),
    whether it reduced the part's stats on the card."""
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner

    from victorialogs_tpu_torch.gpu.batch import _Then

    class Recording(TorchBatchRunner):
        def __init__(self):
            super().__init__(device="cpu")
            self.reduced = {}

        def run_part_stats_submit(self, f, part, bss, spec):
            def record(out):
                self.reduced[(part.min_ts, part.num_rows)] = \
                    out[1] == set(bss)
                return out
            return _Then(super().run_part_stats_submit(f, part, bss, spec),
                         record)
    return Recording()


def _jax_runner():
    """A BatchRunner that records the same for its device."""
    class Handle:
        def __init__(self, h, record):
            self.h, self.record = h, record

        def harvest(self, *args):
            out = self.h.harvest(*args)
            self.record(out)
            return out

        def __getattr__(self, name):
            return getattr(self.h, name)

    class Recording(JBatch.BatchRunner):
        def run_part_stats_submit(self, f, part, bss, spec):
            def record(out):
                self.reduced[(part.min_ts, part.num_rows)] = \
                    out[1] == set(bss)
            return Handle(super().run_part_stats_submit(f, part, bss, spec),
                          record)
    r = Recording()
    r.reduced = {}
    return r


def _e2e_queries(t0: int) -> list:
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    lo, hi = format_rfc3339(t0), format_rfc3339(t0 + 600 * NS)
    qs = [q for q in _planned_queries(t0) if "_time:[2025" not in q]
    return qs + [f"_time:[{lo}, {hi}] | stats by (_time:1m) rate() r, "
                 f"rate_sum(dur) rs"]


def test_e2e_query_list():
    from victorialogs_tpu_torch.cli.vlogsgenerator import today_start_ns
    assert len(_e2e_queries(today_start_ns())) == 55


@pytest.mark.parametrize("qi", range(55))
def test_stats_query_matches_jax(stats_stores, monkeypatch, qi):
    t0, port, jst = stats_stores
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.storage.log_rows import TenantID
    # one JAX dispatch per part, so its parts are the port's
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    q = _e2e_queries(t0)[qi]
    jt, tt = [JLR.TenantID(0, 0)], [TenantID(0, 0)]
    want = jax_run(jst, jt, q, timestamp=t0)
    assert run_query_collect(port, tt, q, timestamp=t0) == want, q
    runner, jr = _port_runner(), _jax_runner()
    try:
        assert run_query_collect(port, tt, q, timestamp=t0,
                                 runner=runner) == want, q
        assert jax_run(jst, jt, q, timestamp=t0, runner=jr) == want, q
    finally:
        jr.close()
        runner.close()
    assert runner.stats_counters["host_parts"] == 0
    # a part whose bloom folds lack a required token is killed before
    # it is read, as in JAX (storage/filterbank.py part_aggregate_prunes)
    assert runner.stats_counters["device_parts"] >= 1 or \
        runner.stats_counters["agg_pruned_parts"] >= 1
    assert runner.stats_counters["agg_pruned_parts"] == \
        jr.stats()["agg_pruned_parts"]
    for key, on_device in jr.reduced.items():
        if on_device:
            assert runner.reduced.get(key), (q, key)


@pytest.mark.parametrize("q", [
    "* | stats count_uniq(ratio)",
    "* | stats by (_time:1s, app) count(), count_uniq(_stream_id)"])
def test_stats_the_card_cannot_reduce_go_to_the_host_pipe(stats_stores, q):
    """A float column has no dict codes; 1,500 one-second buckets x 3
    apps x 3 streams exceed MAX_BUCKETS cells: the first part's filter
    still runs on the card and the stats pipe aggregates its rows."""
    t0, port, jst = stats_stores
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.storage.log_rows import TenantID
    runner = _port_runner()
    want = jax_run(jst, [JLR.TenantID(0, 0)], q, timestamp=t0)
    assert run_query_collect(port, [TenantID(0, 0)], q, timestamp=t0,
                             runner=runner) == want
    assert runner.reduced[(t0, T0_OFFSET_ROWS)] is False
    assert runner.stats_counters["device_parts"] == 2
    assert runner.stats_counters["host_parts"] == 0
    runner.close()


def test_count_uniq_of_generated_users_goes_to_the_host_pipe():
    """The generator's `user` (~1M distinct values, a string column)
    declines to the host pipe, as in the JAX package."""
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           generate,
                                                           today_start_ns)
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    st = Storage(device="cpu")
    jst = JS.Storage(tempfile.mkdtemp(prefix="vl_stats_users_"))
    lr = LogRows(stream_fields=["app", "host"])
    jl = JLR.LogRows(stream_fields=["app", "host"])
    for ts, fields in generate(3000, 3, today_start_ns(), NS_PER_DAY // 2,
                               streams=8):
        lr.add(TenantID(0, 0), ts, fields)
        jl.add(JLR.TenantID(0, 0), ts, fields)
    st.must_add_rows(lr)
    st.debug_flush()
    jst.must_add_rows(jl)
    jst.debug_flush()
    runner = _port_runner()
    q = "* | stats count_uniq(user)"
    try:
        want = jax_run(jst, [JLR.TenantID(0, 0)], q)
        assert run_query_collect(st, [TenantID(0, 0)], q,
                                 runner=runner) == want
        assert int(want[0]["count_uniq(user)"]) > 2900
        assert list(runner.reduced.values()) == [False]
    finally:
        runner.close()
        jst.close()
        st.close()


def test_maybe_rows_carry_value_uniq_and_quantile_contributions():
    """Rows whose `_msg` is wider than the staging are maybe rows of a
    `_msg` filter: residue_partials settles them on the host and keys
    their count, value, uniq and quantile contributions like the
    device cells."""
    from victorialogs_tpu_torch.cli.vlogsgenerator import today_start_ns
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    st = Storage(device="cpu")
    jst = JS.Storage(tempfile.mkdtemp(prefix="vl_stats_maybe_"))
    lr = LogRows(stream_fields=["app"])
    jl = JLR.LogRows(stream_fields=["app"])
    t0 = today_start_ns()
    tail = ["needle", "hay", "needle hay", "x"]
    for i in range(60):
        msg = ("pad " * (600 if i % 3 == 0 else 5)) + tail[i % 4]
        fields = [("_msg", msg), ("app", f"a{i % 2}"),
                  ("lvl", ("info", "warn", "")[i % 3]),
                  ("dur", str(i * 37 % 101)),
                  ("status", str(200 + i * 13 % 97)),
                  ("user", "" if i % 4 == 0 else f"u{i}")]
        lr.add(TenantID(0, 0), t0 + i * NS, fields)
        jl.add(JLR.TenantID(0, 0), t0 + i * NS, fields)
    st.must_add_rows(lr)
    st.debug_flush()
    jst.must_add_rows(jl)
    jst.debug_flush()
    runner = _port_runner()
    try:
        for q in ("needle | stats by (app) count(), sum(dur), min(dur), "
                  "max(dur), avg(dur), count_uniq(lvl), median(status), "
                  "sum_len(_msg), count_empty(user)",
                  "hay | stats by (dur:10, _time:20s) count() c, "
                  "quantile(0.9, status) q, count_uniq(app) u"):
            want = jax_run(jst, [JLR.TenantID(0, 0)], q, timestamp=t0)
            assert want
            assert run_query_collect(st, [TenantID(0, 0)], q,
                                     timestamp=t0) == want, q
            assert run_query_collect(st, [TenantID(0, 0)], q, timestamp=t0,
                                     runner=runner) == want, q
        assert runner.stats_counters["maybe_rows"] > 0
        assert all(runner.reduced.values())
    finally:
        runner.close()
        jst.close()
        st.close()
