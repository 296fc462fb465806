"""Durable storage of the port against the JAX package: part files, the
datadb, partitions and the storage root.

The same rows, made from a numpy seed in one UTC day with strictly
increasing timestamps, go through both packages:

- the zstd helpers give the JAX package's frames, with `zstandard` and
  with the zlib `VLZ1` frame it falls back to;
- `write_part` of the same blocks gives the JAX package's five part
  files byte for byte, with either codec; each package's reader reads
  the other's part with every accessor equal; a part opens by its
  metaindex alone and `close()` closes its files;
- the datadb flushes, reopens, merges a tier of 15 parts inline and
  force-merges (the merged part byte-identical to the JAX package's),
  keeps rows visible through a flush, removes what the manifest does
  not list, and releases what a merge replaced;
- the storage root splits days, reopens, drops expired partitions and
  the oldest over a disk limit; a runner stages every kind from a file
  part without writing to its read-only arrays;
- the slice: `/insert/jsonline` into a durable store, closed and
  reopened, answers the main queries through `TorchBatchRunner(device=
  "cpu")` as the JAX package's `run_query` does, and as it did before
  the close and after a force merge.

JAX stores use flush_interval=3600 and are compared only after an
explicit flush or force merge; every store is closed by a finalizer.
No port call starts a thread.  The stream index has its own module,
tests/test_torch_durable_index.py.
"""

import gc
import json
import os
import threading
import time
import warnings
import weakref

import numpy as np
import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.server import insertutil as JI
from victorialogs_tpu.server import vlinsert as JV
from victorialogs_tpu.storage import block_build as JBB
from victorialogs_tpu.storage import datadb as JDD
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import part as JP
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.utils import zstd as JZ

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       jsonline_body,
                                                       today_start_ns)
from test_torch_storage import assert_column_equal

HOUR = 3600 * 10**9
STREAMS = ["app", "host"]
PART_FILES = ("metadata.json", "index.bin", "timestamps.bin",
              "columns.bin", "blooms.bin")

# torch and the port load on first use, in the worker that runs these
# tests, not in every worker that only collects this module
torch = TZ = TP = TDD = TS = TBB = TLR = TI = TV = None
Storage = TorchBatchRunner = run_query_collect = None


@pytest.fixture(autouse=True)
def _port():
    """Import the port; cap torch's intra-op pool next to the other
    workers and restore it after."""
    global torch, TZ, TP, TDD, TS, TBB, TLR, TI, TV
    global Storage, TorchBatchRunner, run_query_collect
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.server import insertutil as TI
    from victorialogs_tpu_torch.server import vlinsert as TV
    from victorialogs_tpu_torch.storage import block_build as TBB
    from victorialogs_tpu_torch.storage import datadb as TDD
    from victorialogs_tpu_torch.storage import log_rows as TLR
    from victorialogs_tpu_torch.storage import part as TP
    from victorialogs_tpu_torch.storage import storage as TS
    from victorialogs_tpu_torch.storage.storage import Storage
    from victorialogs_tpu_torch.utils import zstd as TZ
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _close_what_opens(_port, monkeypatch):
    """Every port store, partition, datadb and file part a test opens is
    closed when it ends, also when it fails (close() is idempotent); held weakly, so a part a
    merge released can still go."""
    from victorialogs_tpu_torch.storage.indexdb import IndexDB
    from victorialogs_tpu_torch.storage.partition import Partition
    opened = []
    for cls in (Storage, Partition, TDD.DataDB, IndexDB, TP.FilePart):
        def init(self, *a, _real=cls.__init__, **kw):
            _real(self, *a, **kw)
            opened.append(weakref.ref(self))
        monkeypatch.setattr(cls, "__init__", init)
    yield
    monkeypatch.undo()
    for ref in reversed(opened):
        o = ref()
        if o is not None:
            o.close()


@pytest.fixture
def closing():
    """closing(store) -> store, closed when the test ends."""
    opened = []
    yield lambda st: opened.append(st) or st
    for st in reversed(opened):
        st.close()


@pytest.fixture
def vlz1(monkeypatch):
    """Both packages without `zstandard`: the VLZ1 zlib frame."""
    monkeypatch.setattr(JZ, "zstandard", None)
    monkeypatch.setattr(TZ, "zstandard", None)


@pytest.fixture(params=["zstd", "vlz1"])
def codec(request, monkeypatch):
    if request.param == "vlz1":
        monkeypatch.setattr(JZ, "zstandard", None)
        monkeypatch.setattr(TZ, "zstandard", None)
    return request.param


@pytest.fixture(autouse=True)
def _no_jax_sidecar(monkeypatch):
    """The JAX writer's filter-index sidecar is out of this port's
    scope; its five part files are what is compared."""
    monkeypatch.setenv("VL_FILTER_INDEX", "v1")


def _rows(n, seed, streams=8, start=None, span=NS_PER_DAY // 4):
    return generate(n, seed, (start or today_start_ns()) + HOUR, span,
                    streams=streams)


def _log_rows(rows, port=True):
    mod = TLR if port else JLR
    lr = mod.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(mod.TenantID(0, 0), ts, fields)
    return lr


def _typed_rows(n, seed):
    """Rows whose fields take every value type: uints of each width,
    negative ints, floats, IPv4, ISO 8601 times, dict, const and
    strings."""
    rng = np.random.default_rng(seed)
    t0 = today_start_ns() + HOUR
    out = []
    for i in range(n):
        ms = int(rng.integers(0, 1000))
        out.append((t0 + i * 1_000_000, [
            ("_msg", f"req {i} took {int(rng.integers(0, 99))} ms "
                     f"{'error' if i % 7 == 0 else 'ok'}"),
            ("app", f"app-{i % 3}"), ("host", "h"),
            ("u8", str(int(rng.integers(0, 200)))),
            ("u16", str(int(rng.integers(300, 60000)))),
            ("u32", str(int(rng.integers(70000, 1 << 31)))),
            ("u64", str(int(rng.integers(1 << 40, 1 << 62)))),
            ("i64", str(int(rng.integers(-10**12, 10**12)))),
            ("f", repr(float(rng.normal()))),
            ("ip", "10.%d.%d.%d" % tuple(rng.integers(0, 256, 3))),
            ("ts", f"2024-01-02T03:04:{i % 60:02d}.{ms:03d}Z"),
            ("lvl", ("info", "warn", "error")[i % 3]),
            ("c", "const"),
        ]))
    return out


def _blocks(rows):
    """The same rows as both packages' blocks."""
    return (TBB.build_log_rows_blocks(_log_rows(rows)),
            JBB.build_log_rows_blocks(_log_rows(rows, port=False)))


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in PART_FILES}


def _threads_during(fn):
    before = threading.active_count()
    out = fn()
    assert threading.active_count() == before
    return out


# ---------------- the zstd helpers ----------------

@pytest.mark.parametrize("level", [1, 3])
def test_frames_equal_jax(codec, level):
    data = os.urandom(1000) + b"abc" * 5000
    z = TZ.compress(data, level)
    assert z == JZ.compress(data, level)
    assert z.startswith(b"VLZ1") == (codec == "vlz1")
    assert TZ.decompress(z) == JZ.decompress(z) == data


def test_vlz1_frames_read_with_zstandard(vlz1, monkeypatch):
    zstandard = pytest.importorskip("zstandard")
    data = b"hello " * 999
    z = TZ.compress(data, 1)
    assert z.startswith(b"VLZ1")
    monkeypatch.setattr(TZ, "zstandard", zstandard)
    assert TZ.decompress(z) == data


@pytest.mark.parametrize("limit", [100, 9_999])
def test_vlz1_decompress_enforces_the_bound(vlz1, limit):
    z = TZ.compress(b"x" * 10_000, 1)
    assert TZ.decompress(z, max_output_size=10_000) == b"x" * 10_000
    with pytest.raises(ValueError, match="exceeds"):
        TZ.decompress(z, max_output_size=limit)


def test_zstd_frame_without_zstandard_raises(monkeypatch):
    z = TZ.compress(b"payload" * 100, 1)
    if z.startswith(b"VLZ1"):
        pytest.skip("zstandard is not installed here")
    monkeypatch.setattr(TZ, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        TZ.decompress(z)


# ---------------- part files: byte parity and cross-reads ----------------

@pytest.mark.parametrize("case", ["generator", "typed", "groups"])
@pytest.mark.parametrize("big", [False, True])
def test_write_part_bytes_equal_jax(tmp_path, codec, case, big,
                                    monkeypatch):
    if case == "groups":
        # several header groups from a few dozen blocks
        monkeypatch.setattr(TP, "HEADER_GROUP_SIZE", 5)
        monkeypatch.setattr(JP, "HEADER_GROUP_SIZE", 5)
        rows = _rows(2000, 21, streams=37)
    elif case == "typed":
        rows = _typed_rows(600, 22)
    else:
        rows = _rows(3000, 23)
    tb, jb = _blocks(rows)
    meta = _threads_during(
        lambda: TP.write_part(str(tmp_path / "t"), tb, big=big))
    JP.write_part(str(tmp_path / "j"), jb, big=big)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    for name in PART_FILES:
        assert got[name] == want[name], name
    assert meta == json.loads(want["metadata.json"])
    assert not os.path.exists(tmp_path / "t.tmp")


def _assert_parts_read_equal(a, b, tenant_of):
    assert (a.num_blocks, a.num_rows, a.min_ts, a.max_ts) == \
        (b.num_blocks, b.num_rows, b.min_ts, b.max_ts)
    mid = (a.min_ts + a.max_ts) // 2
    for lo, hi in ((a.min_ts, a.max_ts), (mid, mid + HOUR),
                   (a.max_ts + 1, a.max_ts + 2)):
        assert list(a.candidate_blocks(lo, hi)) == \
            list(b.candidate_blocks(lo, hi))
    for i in range(b.num_blocks):
        sa, sb = a.block_stream_id(i), b.block_stream_id(i)
        assert sa.as_string() == sb.as_string()
        assert tenant_of(sa) == (sb.tenant.account_id, sb.tenant.project_id)
        assert a.block_tags(i) == b.block_tags(i)
        assert a.block_rows(i) == b.block_rows(i)
        assert (a.block_min_ts(i), a.block_max_ts(i)) == \
            (b.block_min_ts(i), b.block_max_ts(i))
        assert [tuple(c) for c in a.block_consts(i)] == \
            [tuple(c) for c in b.block_consts(i)]
        assert a.block_col_names(i) == b.block_col_names(i)
        assert np.array_equal(a.block_timestamps(i), b.block_timestamps(i))
        for name in a.block_col_names(i) + ["absent"]:
            assert a.block_column_meta(i, name) == \
                b.block_column_meta(i, name)
            ba, bb = a.block_column_bloom(i, name), \
                b.block_column_bloom(i, name)
            assert (ba is None) == (bb is None)
            if ba is not None:
                assert np.array_equal(ba, bb)
            ca, cb = a.block_column(i, name), b.block_column(i, name)
            assert (ca is None) == (cb is None)
            if ca is not None:
                assert_column_equal(ca, cb)
                assert ca.to_strings(a.block_rows(i)) == \
                    cb.to_strings(b.block_rows(i))


@pytest.mark.parametrize("case", ["generator", "typed"])
def test_port_reads_a_jax_part(tmp_path, codec, case):
    rows = _rows(2500, 24) if case == "generator" else _typed_rows(500, 25)
    _tb, jb = _blocks(rows)
    JP.write_part(str(tmp_path / "j"), jb)
    tp, jp = TP.FilePart(str(tmp_path / "j")), JP.Part(str(tmp_path / "j"))
    try:
        _assert_parts_read_equal(
            tp, jp, lambda s: (s.tenant.account_id, s.tenant.project_id))
    finally:
        tp.close()
        jp.close()


@pytest.mark.parametrize("case", ["generator", "typed"])
def test_jax_reads_a_port_part(tmp_path, codec, case):
    rows = _rows(2500, 26) if case == "generator" else _typed_rows(500, 27)
    tb, _jb = _blocks(rows)
    TP.write_part(str(tmp_path / "t"), tb)
    tp, jp = TP.FilePart(str(tmp_path / "t")), JP.Part(str(tmp_path / "t"))
    try:
        _assert_parts_read_equal(
            jp, tp, lambda s: (s.tenant.account_id, s.tenant.project_id))
    finally:
        tp.close()
        jp.close()


def test_file_part_equals_the_blocks_it_was_written_from(tmp_path):
    tb, _jb = _blocks(_typed_rows(700, 28))
    mem = TP.Part(tb)
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    try:
        for i in range(mem.num_blocks):
            got, want = fp.read_block(i), mem.read_block(i)
            assert got.stream_id == want.stream_id
            assert np.array_equal(got.timestamps, want.timestamps)
            assert got.const_columns == want.const_columns
            for gc_, wc in zip(got.columns, want.columns):
                assert_column_equal(gc_, wc)
        assert [b.num_rows for b in fp.iter_blocks()] == \
            [b.num_rows for b in tb]
    finally:
        fp.close()


def test_open_reads_only_the_metaindex(tmp_path, monkeypatch):
    monkeypatch.setattr(TP, "HEADER_GROUP_SIZE", 4)
    rows = _rows(2000, 29, streams=16)
    tb, _jb = _blocks(rows)
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    try:
        assert fp.headers.groups_loaded == 0
        assert fp.num_blocks == len(tb) and fp.num_rows == 2000
        # a range that only the last block of the first group can meet
        assert fp.block_rows(0) == tb[0].num_rows
        assert fp.headers.groups_loaded == 1
        far = fp.max_ts + HOUR
        assert list(fp.candidate_blocks(far, far + 1)) == []
        assert fp.headers.groups_loaded == 1
    finally:
        fp.close()


def test_close_closes_files_and_drops_the_map(tmp_path):
    tb, _jb = _blocks(_rows(1500, 30))
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    files = (fp._idx_f, fp._ts_f, fp._col_f)
    bloom = fp.block_column_bloom(0, "_msg")
    assert not fp.closed
    fp.close()
    assert fp.closed and all(f.closed for f in files)
    assert fp._blooms is None
    assert bloom is not None and bloom.size      # a view it handed out
    with pytest.raises((ValueError, OSError)):
        fp.block_timestamps(0)


def test_file_arrays_are_read_only_views(tmp_path):
    tb, _jb = _blocks(_typed_rows(200, 31))
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    try:
        c = fp.block_column(0, "u16")
        assert not c.nums.flags.writeable
        assert not fp.block_column_bloom(0, "_msg").flags.writeable
    finally:
        fp.close()


def test_v1_parts_are_refused(tmp_path):
    tb, _jb = _blocks(_rows(300, 32))
    TP.write_part(str(tmp_path / "t"), tb)
    meta = json.loads((tmp_path / "t" / "metadata.json").read_text())
    meta["format_version"] = 1
    (tmp_path / "t" / "metadata.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="v1"):
        TP.FilePart(str(tmp_path / "t"))


def test_write_part_replaces_a_stale_tmp(tmp_path):
    tb, _jb = _blocks(_rows(300, 33))
    os.makedirs(tmp_path / "t.tmp")
    (tmp_path / "t.tmp" / "junk").write_bytes(b"x")
    TP.write_part(str(tmp_path / "t"), tb)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(PART_FILES)
    assert not os.path.exists(tmp_path / "t.tmp")


_TYPED_FIELDS = ("_msg", "u8", "u16", "u32", "u64", "i64", "f", "ip", "ts",
                 "lvl", "c", "absent")


@pytest.mark.parametrize("field", _TYPED_FIELDS)
def test_selected_rows_decode_like_the_whole_column(tmp_path, field):
    """Rows built from a file part decode only the selected rows of a
    stored column (`block_search.values_at`), as the whole column's
    strings at those rows, and leave the column undecoded."""
    from victorialogs_tpu_torch.engine.block_search import (BlockSearch,
                                                            values_at)
    tb, _jb = _blocks(_typed_rows(300, 34))
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    try:
        for bi in range(fp.num_blocks):
            bs = BlockSearch(fp, bi)
            rows = np.arange(0, bs.nrows, 3)
            got = values_at(bs, field, rows)
            col = bs.column(field)
            assert col is None or col._strings_cache is None
            want = BlockSearch(fp, bi).values(field)
            assert got == [want[i] for i in rows.tolist()]
            assert values_at(bs, field, rows[:0]) == []
    finally:
        fp.close()


# ---------------- the datadb ----------------

def _ddb_rows(k, n=20, seed=40):
    return _rows(n, seed + k, streams=4,
                 start=today_start_ns() + k * HOUR, span=HOUR // 2)


def _add(ddb, rows, port=True):
    ddb.must_add_blocks((TBB if port else JBB).build_log_rows_blocks(
        _log_rows(rows, port)))


def _total(ddb):
    return sum(p.num_rows for p in ddb.snapshot_parts())


def test_datadb_add_flush_reopen(tmp_path):
    path = str(tmp_path / "ddb")
    ddb = TDD.DataDB(path, flush_interval=3600)
    _threads_during(lambda: _add(ddb, _ddb_rows(0, 100)))
    assert _total(ddb) == 100 and len(ddb.inmemory_parts) == 1
    ddb.flush_inmemory_parts()
    assert len(ddb.small_parts) == 1 and not ddb.inmemory_parts
    assert _total(ddb) == 100
    ddb.close()
    ddb2 = TDD.DataDB(path, flush_interval=3600)
    try:
        assert _total(ddb2) == 100
        assert json.loads((tmp_path / "ddb" / "parts.json").read_text()) \
            == {"parts": [p.name for p in ddb2.small_parts]}
    finally:
        ddb2.close()


def test_datadb_close_flushes(tmp_path):
    path = str(tmp_path / "ddb")
    ddb = TDD.DataDB(path, flush_interval=3600)
    _add(ddb, _ddb_rows(0, 30))
    _add(ddb, _ddb_rows(1, 30))
    ddb.close()
    ddb2 = TDD.DataDB(path, flush_interval=3600)
    try:
        assert _total(ddb2) == 60 and len(ddb2.small_parts) == 1
    finally:
        ddb2.close()


@pytest.mark.parametrize("parts", [14, 15, 16])
def test_datadb_merges_fifteen_small_parts_inline(tmp_path, parts):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(parts):
            _add(ddb, _ddb_rows(k, 10))
            _threads_during(ddb.flush_inmemory_parts)
        merged = parts >= TDD.DEFAULT_PARTS_TO_MERGE
        assert ddb.merges_done == int(merged)
        assert len(ddb.small_parts) == (1 + parts - 15 if merged else parts)
        assert _total(ddb) == 10 * parts
        for p in ddb.snapshot_parts():
            for i in range(p.num_blocks):
                assert (np.diff(p.block_timestamps(i)) > 0).all()
        names = {p.name for p in ddb.small_parts + ddb.big_parts}
        assert set(os.listdir(tmp_path / "ddb")) == names | {"parts.json"}
    finally:
        ddb.close()


def test_datadb_big_tier_merges(tmp_path, monkeypatch):
    """Merged parts go to the big tier (every part is big here), which
    merges too once it holds DEFAULT_PARTS_TO_MERGE parts."""
    monkeypatch.setattr(TDD, "BIG_PART_SIZE", 1)
    monkeypatch.setattr(TDD, "DEFAULT_PARTS_TO_MERGE", 3)
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(9):
            _add(ddb, _ddb_rows(k, 10))
            ddb.flush_inmemory_parts()
            assert len(ddb.small_parts) < 3 and len(ddb.big_parts) < 3
        assert ddb.merges_done == 4        # three small tiers, one big
        assert not ddb.small_parts and len(ddb.big_parts) == 1
        ddb.close()
        ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
        assert not ddb.small_parts and len(ddb.big_parts) == 1
        assert _total(ddb) == 90
    finally:
        ddb.close()


def test_datadb_force_merge(tmp_path):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(3):
            _add(ddb, _ddb_rows(k, 20))
            ddb.flush_inmemory_parts()
        _add(ddb, _ddb_rows(3, 20))             # still waiting
        assert len(ddb.small_parts) == 3
        _threads_during(ddb.force_merge)
        assert not ddb.small_parts and len(ddb.big_parts) == 1
        assert _total(ddb) == 80 and ddb.merges_done == 1
    finally:
        ddb.close()


def test_force_merged_part_bytes_equal_jax(tmp_path, codec):
    """Three flushed parts, force-merged in each package: the merged
    parts are byte-identical."""
    tddb = TDD.DataDB(str(tmp_path / "t"), flush_interval=3600)
    jddb = JDD.DataDB(str(tmp_path / "j"), flush_interval=3600)
    try:
        for k in range(3):
            rows = _rows(400, 50 + k, streams=6,
                         start=today_start_ns() + k * HOUR, span=HOUR)
            _add(tddb, rows)
            tddb.flush_inmemory_parts()
            _add(jddb, rows, port=False)
            jddb.flush_inmemory_parts()
        tddb.force_merge()
        jddb.force_merge()
        (tp,), (jp,) = tddb.big_parts, jddb.big_parts
        assert tp.name == jp.name
        got, want = _files(tp.path), _files(jp.path)
        for name in PART_FILES:
            assert got[name] == want[name], name
    finally:
        jddb.close()
        tddb.close()


def test_datadb_removes_what_the_manifest_does_not_list(tmp_path):
    path = tmp_path / "ddb"
    ddb = TDD.DataDB(str(path), flush_interval=3600)
    _add(ddb, _ddb_rows(0, 10))
    ddb.flush_inmemory_parts()
    ddb.close()
    os.makedirs(path / "part_00000000deadbeef")
    os.makedirs(path / "part_0000000000000009.tmp")
    (path / "parts.json.tmp").write_text("{")
    ddb2 = TDD.DataDB(str(path), flush_interval=3600)
    try:
        assert sorted(os.listdir(path)) == \
            sorted([ddb2.small_parts[0].name, "parts.json"])
        assert _total(ddb2) == 10
        _add(ddb2, _ddb_rows(1, 10))
        ddb2.flush_inmemory_parts()
        assert ddb2.small_parts[-1].name == "part_0000000000000001"
    finally:
        ddb2.close()


def test_rows_stay_visible_while_flushing(tmp_path, monkeypatch):
    """During the part write the waiting batches are still listed, and
    afterwards the file part alone: every row is visible once."""
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    seen = []
    real = TDD.write_part

    def spy(path, blocks, big=False):
        seen.append(_total(ddb))
        return real(path, blocks, big)

    monkeypatch.setattr(TDD, "write_part", spy)
    try:
        _add(ddb, _ddb_rows(0, 10))
        _add(ddb, _ddb_rows(1, 10))
        ddb.flush_inmemory_parts()
        assert seen == [20] and _total(ddb) == 20
    finally:
        ddb.close()


def test_a_failed_flush_keeps_the_batches(tmp_path, monkeypatch):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)

    def broken(path, blocks, big=False):
        os.makedirs(path + ".tmp")
        raise OSError("disk full")

    try:
        _add(ddb, _ddb_rows(0, 10))
        monkeypatch.setattr(TDD, "write_part", broken)
        with pytest.raises(OSError):
            ddb.flush_inmemory_parts()
        assert len(ddb.inmemory_parts) == 1 and _total(ddb) == 10
        assert os.listdir(tmp_path / "ddb") == []
        monkeypatch.undo()
        ddb.flush_inmemory_parts()
        assert len(ddb.small_parts) == 1
    finally:
        ddb.close()


def test_add_flushes_past_max_inmemory_parts(tmp_path):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(TDD.MAX_INMEMORY_PARTS + 1):
            assert len(ddb.inmemory_parts) == k
            _add(ddb, _ddb_rows(k, 5))
        assert not ddb.inmemory_parts and len(ddb.small_parts) == 1
        assert _total(ddb) == 5 * (TDD.MAX_INMEMORY_PARTS + 1)
    finally:
        ddb.close()


def test_add_flushes_an_old_batch(tmp_path, monkeypatch):
    """The add checks the oldest waiting batch's age in place of a
    flusher thread."""
    clock = [1000.0]
    monkeypatch.setattr(TDD.time, "monotonic", lambda: clock[0])
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=5.0)
    try:
        _add(ddb, _ddb_rows(0, 5))
        clock[0] += 4.0
        _add(ddb, _ddb_rows(1, 5))
        assert len(ddb.inmemory_parts) == 2
        assert ddb.stats()["flush_age_seconds"] == 4.0
        clock[0] += 1.0
        _add(ddb, _ddb_rows(2, 5))
        assert not ddb.inmemory_parts and len(ddb.small_parts) == 1
        clock[0] += 100.0
        _add(ddb, _ddb_rows(3, 5))          # the first of a new wait
        assert len(ddb.inmemory_parts) == 1
    finally:
        ddb.close()


def test_memory_datadb_has_no_age_flush_or_tier_merge(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(TDD.time, "monotonic", lambda: clock[0])
    ddb = TDD.DataDB(None, flush_interval=0.0)
    for k in range(20):
        _add(ddb, _ddb_rows(k, 5))
        clock[0] += 10.0
        ddb.flush_inmemory_parts()
    assert len(ddb.small_parts) == 20 and ddb.merges_done == 0
    assert all(isinstance(p, TP.Part) for p in ddb.small_parts)
    ddb.force_merge()
    (p,) = ddb.small_parts
    assert isinstance(p, TP.Part) and p.num_rows == 100


def test_merge_skipped_without_disk_room(tmp_path, monkeypatch):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(2):
            _add(ddb, _ddb_rows(k, 10))
            ddb.flush_inmemory_parts()
        usage = TDD.shutil.disk_usage(str(tmp_path))
        monkeypatch.setattr(TDD.shutil, "disk_usage",
                            lambda p: usage._replace(free=1 << 20))
        ddb.force_merge()
        assert len(ddb.small_parts) == 2 and ddb.merges_done == 0
        monkeypatch.undo()
        ddb.force_merge()
        assert len(ddb.big_parts) == 1 and ddb.merges_done == 1
    finally:
        ddb.close()


def test_merge_closes_and_removes_the_parts_it_replaced(tmp_path):
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    try:
        for k in range(3):
            _add(ddb, _ddb_rows(k, 10))
            ddb.flush_inmemory_parts()
        old = list(ddb.small_parts)
        seen = {p.uid for p in old}
        ddb.force_merge()
        assert all(p.closed for p in old)
        assert not any(os.path.exists(p.path) for p in old)
        (newp,) = ddb.big_parts
        assert newp.uid not in seen and not newp.closed
    finally:
        ddb.close()


def test_runner_releases_what_a_merge_replaced(tmp_path):
    """The runner's staged entries of merged-away parts go with them
    (weakref.finalize on each part)."""
    ddb = TDD.DataDB(str(tmp_path / "ddb"), flush_interval=3600)
    runner = TorchBatchRunner(device="cpu")
    try:
        for k in range(3):
            _add(ddb, _ddb_rows(k, 30))
            ddb.flush_inmemory_parts()
        for part in ddb.small_parts:
            runner.stage_fused_field(part, "_msg", runner.layout(part))
        del part
        old = {p.uid for p in ddb.small_parts}
        assert runner.cache.part_uids() == old
        ddb.force_merge()
        gc.collect()
        assert runner.cache.part_uids() == set()
    finally:
        runner.close()
        ddb.close()


def test_datadb_stats_keys_equal_jax(tmp_path):
    tddb = TDD.DataDB(str(tmp_path / "t"), flush_interval=3600)
    jddb = JDD.DataDB(str(tmp_path / "j"), flush_interval=3600)
    try:
        for ddb, port in ((tddb, True), (jddb, False)):
            _add(ddb, _ddb_rows(0, 10), port)
            ddb.flush_inmemory_parts()
            _add(ddb, _ddb_rows(1, 10), port)
        got, want = tddb.stats(), jddb.stats()
        assert set(got) == set(want)
        for k in ("inmemory_parts", "small_parts", "big_parts",
                  "inmemory_rows", "file_rows", "small_rows", "big_rows",
                  "compressed_size", "uncompressed_size", "pending_merges",
                  "merges_done"):
            assert got[k] == want[k], k
    finally:
        jddb.close()
        tddb.close()


# ---------------- partitions and the storage root ----------------

def _store_rows(st, rows, port=True):
    st.must_add_rows(_log_rows(rows, port))


def test_storage_day_split_and_reopen(tmp_path):
    path = str(tmp_path / "st")
    st = Storage(path, retention_days=10000, flush_interval=3600,
                 device="cpu")
    day0 = today_start_ns()
    rows = [(day0 - NS_PER_DAY + i, [("app", "a"), ("_msg", f"m{i}")])
            for i in range(5)] + \
        [(day0 + i, [("app", "a"), ("_msg", f"m{i}")]) for i in range(5)]
    _threads_during(lambda: _store_rows(st, rows))
    assert len(st.partitions) == 2
    _threads_during(st.debug_flush)
    st.close()
    assert sorted(os.listdir(tmp_path / "st" / "partitions")) == sorted(
        TS.day_dir_name(d // NS_PER_DAY) for d in (day0 - NS_PER_DAY, day0))
    st2 = Storage(path, retention_days=10000, device="cpu")
    try:
        assert sorted(st2.partitions) == [day0 // NS_PER_DAY - 1,
                                          day0 // NS_PER_DAY]
        assert [sum(p.num_rows for p in pt.snapshot_parts())
                for _d, pt in sorted(st2.partitions.items())] == [5, 5]
    finally:
        st2.close()


def test_storage_reopen_keeps_unflushed_rows_through_close(tmp_path):
    path = str(tmp_path / "st")
    st = Storage(path, flush_interval=3600, device="cpu")
    _store_rows(st, _rows(500, 60))
    st.close()
    st2 = Storage(path, device="cpu")
    try:
        assert st2.update_stats()["file_rows"] == 500
    finally:
        st2.close()


def test_storage_retention_drop(tmp_path, closing):
    st = closing(Storage(str(tmp_path / "st"), retention_days=7,
                         flush_interval=3600, device="cpu"))
    now = time.time_ns()
    _store_rows(st, [(now, [("_msg", "fresh")])])
    old_day = (now - 30 * NS_PER_DAY) // NS_PER_DAY
    st._partition(old_day)
    old_dir = tmp_path / "st" / "partitions" / TS.day_dir_name(old_day)
    assert len(st.partitions) == 2 and old_dir.is_dir()
    assert st.drop_expired_partitions() == [old_day]
    assert len(st.partitions) == 1 and not old_dir.exists()
    assert st.drop_expired_partitions(now + 30 * NS_PER_DAY) == \
        [now // NS_PER_DAY]
    assert not st.partitions


def test_storage_counts_out_of_retention_rows(tmp_path, closing):
    st = closing(Storage(str(tmp_path / "st"), retention_days=7,
                         flush_interval=3600, device="cpu"))
    now = time.time_ns()
    _store_rows(st, [(now - 30 * NS_PER_DAY, [("_msg", "ancient")]),
                     (now + 30 * NS_PER_DAY, [("_msg", "future")]),
                     (now, [("_msg", "ok")])])
    s = st.update_stats()
    assert (s["rows_dropped_too_old"], s["rows_dropped_too_new"],
            s["inmemory_rows"]) == (1, 1, 1)


def test_storage_max_disk_usage_drops_oldest(tmp_path, closing):
    st = closing(Storage(str(tmp_path / "st"), retention_days=10000,
                         flush_interval=3600, max_disk_usage_bytes=1,
                         device="cpu"))
    now = time.time_ns()
    for k in range(3):
        _store_rows(st, _rows(50, 61 + k, streams=2,
                              start=(now - k * NS_PER_DAY) // NS_PER_DAY
                              * NS_PER_DAY, span=HOUR))
    st.debug_flush()
    assert len(st.partitions) == 3
    dropped = _threads_during(st.enforce_max_disk_usage)
    assert len(dropped) == 2 and len(st.partitions) == 1
    assert max(dropped) < min(st.partitions)
    assert os.listdir(tmp_path / "st" / "partitions") == \
        [TS.day_dir_name(min(st.partitions))]


def test_storage_sweeps_tmp_entries_and_ignores_others(tmp_path):
    path = tmp_path / "st"
    st = Storage(str(path), flush_interval=3600, device="cpu")
    _store_rows(st, _rows(100, 64))
    st.close()
    os.makedirs(path / "partitions" / "20200101.tmp")
    os.makedirs(path / "partitions" / "notaday")
    st2 = Storage(str(path), device="cpu")
    try:
        assert len(st2.partitions) == 1
        assert not (path / "partitions" / "20200101.tmp").exists()
    finally:
        st2.close()


def test_must_force_merge_by_prefix(tmp_path, closing):
    st = closing(Storage(str(tmp_path / "st"), retention_days=10000,
                         flush_interval=3600, device="cpu"))
    day0 = today_start_ns()
    for k in range(2):
        for d in (day0 - NS_PER_DAY, day0):
            _store_rows(st, _rows(40, 70 + k, streams=2, start=d,
                                  span=HOUR))
        st.debug_flush()
    (older, newer) = [pt for _d, pt in sorted(st.partitions.items())]
    st.must_force_merge(TS.day_dir_name(newer.day))
    assert (len(older.parts), len(newer.parts)) == (2, 1)
    st.must_force_merge()
    assert (len(older.parts), len(newer.parts)) == (1, 1)
    assert st.update_stats()["file_rows"] == 160


def test_update_stats_keys_equal_jax(tmp_path, closing):
    st = closing(Storage(str(tmp_path / "t"), flush_interval=3600,
                         device="cpu"))
    jst = closing(JS.Storage(str(tmp_path / "j"), flush_interval=3600))
    rows = _rows(300, 71)
    _store_rows(st, rows)
    _store_rows(jst, rows, port=False)
    st.debug_flush()
    jst.debug_flush()
    got, want = st.update_stats(), jst.update_stats()
    assert set(got) == set(want) - {"is_read_only"}
    for k in ("partitions", "streams", "file_rows", "small_parts",
              "compressed_size", "uncompressed_size"):
        assert got[k] == want[k], k


def test_partition_registers_streams_before_rows(tmp_path, monkeypatch):
    """The stream log holds a batch's new streams, fsynced, before its
    blocks reach the datadb."""
    from victorialogs_tpu_torch.storage.partition import Partition
    pt = Partition(0, str(tmp_path / "p"), flush_interval=3600)
    log = tmp_path / "p" / "indexdb" / "streams.jsonl"
    seen = []
    real = pt.ddb.must_add_blocks

    def spy(blocks):
        seen.append(len(log.read_text().splitlines()))
        return real(blocks)

    monkeypatch.setattr(pt.ddb, "must_add_blocks", spy)
    try:
        pt.must_add_rows(_log_rows(_rows(60, 72, streams=3)))
        assert seen == [3] and pt.idb.num_streams() == 3
        pt.must_add_rows(_log_rows(_rows(60, 73, streams=3)))
        assert seen == [3, 3]
    finally:
        pt.close()


def test_partition_stream_search_equals_jax(tmp_path):
    from victorialogs_tpu.storage.partition import Partition as JPart
    from victorialogs_tpu.storage.stream_filter import (StreamFilter as JSF,
                                                        TagFilter as JTF)
    from victorialogs_tpu_torch.storage.partition import Partition
    from victorialogs_tpu_torch.storage.stream_filter import (StreamFilter,
                                                              TagFilter)
    rows = _rows(300, 74, streams=12)
    tpt = Partition(0, str(tmp_path / "t"), flush_interval=3600)
    jpt = JPart(str(tmp_path / "j"), day=0, flush_interval=3600)
    try:
        tpt.must_add_rows(_log_rows(rows))
        jpt.must_add_rows(_log_rows(rows, port=False))
        for label, op, v in (("app", "=", "app-1"), ("app", "!=", "app-1"),
                             ("host", "=~", "host-[13]"),
                             ("host", "!~", "host-1.*"), ("nope", "=", ""),
                             ("nope", "!=", "")):
            got = tpt.search_stream_ids([TLR.TenantID(0, 0)], StreamFilter(
                ((TagFilter(label, op, v),),)))
            want = jpt.idb.search_stream_ids([JLR.TenantID(0, 0)], JSF(
                ((JTF(label, op, v),),)))
            assert sorted(s.as_string() for s in got) == \
                [s.as_string() for s in want], (label, op, v)
    finally:
        jpt.close()
        tpt.close()


def test_durable_storage_defaults_to_cuda(tmp_path):
    path = tmp_path / "st"
    if torch.cuda.is_available():
        Storage(str(path)).close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Storage(str(path))
        assert not path.exists()


def test_memory_store_writes_nothing_and_keeps_its_flushes(tmp_path,
                                                           monkeypatch):
    """path=None: the earlier slices' store, part for part."""
    monkeypatch.chdir(tmp_path)
    st = Storage(device="cpu")
    for k in range(TS.MAX_INMEMORY_PARTS + 1):
        _store_rows(st, _rows(20, 75 + k, streams=2))
    (pt,) = st.partitions.values()
    assert len(pt.parts) == 1 and not pt._pending
    assert isinstance(pt.parts[0], TP.Part) and pt.parts[0].path is None
    _store_rows(st, _rows(20, 90, streams=2))
    st.debug_flush()
    assert [p.num_rows for p in pt.parts] == [20 * 9, 20]
    assert st.update_stats()["compressed_size"] == 0
    st.close()
    assert os.listdir(tmp_path) == []


# ---------------- staging from a file part ----------------

def test_runner_stages_every_kind_from_a_file_part(tmp_path):
    """Fused fields, timestamps, the bloom plane, block starts,
    multibyte rows, numeric and derived columns, dict codes, time and
    numeric buckets: staged from a FilePart without a warning (its
    arrays are read-only), equal to the same staging from the in-memory
    part it was written from."""
    from victorialogs_tpu_torch.gpu.stats_device import (SYNTH_EMPTY,
                                                         SYNTH_LEN)
    from victorialogs_tpu_torch.gpu.stats_stage import (stage_num_buckets,
                                                        stage_time_buckets)
    from victorialogs_tpu_torch.storage.filterbank import bloom_plane
    rows = _rows(3000, 76, streams=6)
    ts5, fields5 = rows[5]
    rows[5] = (ts5, [(k, "héllo " + v if k == "_msg" else v)
                     for k, v in fields5])
    tb, _jb = _blocks(rows)
    mem = TP.Part(tb)
    TP.write_part(str(tmp_path / "t"), tb)
    fp = TP.FilePart(str(tmp_path / "t"))
    runner = TorchBatchRunner(device="cpu")

    def stage(part):
        lay = runner.layout(part)
        out = [runner.stage_fused_field(part, f, lay).lanes
               for f in ("_msg", "user", "lvl", "app")]
        out.append(runner.stage_timestamps(part, lay))
        out.append(runner.stage_bloom_plane(part, "_msg",
                                            bloom_plane(part, "_msg")).plane)
        out.append(runner.stage_block_starts(part, lay))
        out.append(runner.stage_multibyte(part, "_msg", lay))
        for f in ("dur", "status", SYNTH_LEN + "_msg", SYNTH_EMPTY + "user"):
            out.append(runner.stage_numeric(part, f, lay).values)
        for f in ("lvl", "app", "_stream"):
            out.append(runner.stage_dict(part, f, lay).ids)
        out.append(stage_time_buckets(part, lay, HOUR, 0, 1 << 20,
                                      runner.put).ids)
        out.append(stage_num_buckets(part, "dur", lay, 1000.0, 0.0,
                                     runner.put).ids)
        return out

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = stage(fp)
        want = stage(mem)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)
    finally:
        runner.close()
        fp.close()


# ---------------- the slice: insert, close, reopen, query ----------------

SLICE_ROWS = 4000


def _slice_queries(start):
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    lo, hi = format_rfc3339(start + 2 * HOUR), format_rfc3339(start + 5 * HOUR)
    return [
        "error",
        "resp*",
        '~"onnect"',
        "quota",
        "i(ERROR)",
        '~"error.*timeout"',
        f"_time:[{lo}, {hi}) warn | stats by (_time:1h) count()",
        '_stream:{app="app-3"} timeout | stats count()',
        "* | stats count()",
        "quota | stats by (_time:1h, lvl) count() as n",
        "error | stats by (lvl) count(), sum(dur), avg(dur), min(dur), "
        "max(dur)",
        "* | stats by (app) quantile(0.99, status) p99",
        "status:>=500 | stats by (app) count()",
        "dur:range[1000, 2000) | stats count()",
        "lvl:in(error, warn) | stats count()",
        '_stream:{app=~"app-[01]"} quota free',
        "error | sort by (dur) desc limit 10",
        "quota | uniq by (app, lvl) with hits",
    ]


@pytest.fixture(scope="module")
def slice_stores(tmp_path_factory):
    """(start, store dir, port answers before the close, JAX store):
    the same /insert/jsonline body in two flushes into a durable port
    store (closed) and a JAX store (open)."""
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.server import insertutil as TI
    from victorialogs_tpu_torch.server import vlinsert as TV
    from victorialogs_tpu_torch.storage.log_rows import TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    start = today_start_ns()
    rows = generate(SLICE_ROWS, 77, start + HOUR, NS_PER_DAY // 4,
                    streams=16)
    bodies = [jsonline_body(rows[:SLICE_ROWS // 2]),
              jsonline_body(rows[SLICE_ROWS // 2:])]
    path = str(tmp_path_factory.mktemp("durable") / "st")
    port = Storage(path, flush_interval=3600, device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("jaxdurable")),
                        flush_interval=3600)
    try:
        for st, I, V, T in ((port, TI, TV, TenantID),
                            (jax_st, JI, JV, JLR.TenantID)):
            cp = I.CommonParams(tenant=T(0, 0), stream_fields=STREAMS)
            for body in bodies:
                lmp = I.LogMessageProcessor(cp, I.LocalLogRowsStorage(st))
                assert V.handle_jsonline(cp, body, lmp) == SLICE_ROWS // 2
                lmp.flush()
                st.debug_flush()
        runner = TorchBatchRunner(device="cpu")
        before = {q: run_query_collect(port, [TenantID(0, 0)], q,
                                       runner=runner)
                  for q in _slice_queries(start)}
        runner.close()
        port.close()
        yield start, path, before, jax_st
    finally:
        port.close()
        jax_st.close()


@pytest.fixture(scope="module")
def reopened(slice_stores):
    from victorialogs_tpu_torch.storage.storage import Storage
    start, path, before, jax_st = slice_stores
    st = Storage(path, device="cpu")
    yield st
    st.close()


def test_reopened_store_holds_every_row(slice_stores, reopened):
    s = reopened.update_stats()
    assert (s["file_rows"], s["inmemory_rows"], s["small_parts"]) == \
        (SLICE_ROWS, 0, 2)
    assert s["streams"] == 16
    (pt,) = reopened.partitions.values()
    assert all(isinstance(p, TP.FilePart) for p in pt.parts)


@pytest.mark.parametrize("qi", range(18))
def test_reopened_store_answers_like_jax(slice_stores, reopened, qi):
    start, _path, before, jax_st = slice_stores
    q = _slice_queries(start)[qi]
    runner = TorchBatchRunner(device="cpu")
    try:
        got = run_query_collect(reopened, [TLR.TenantID(0, 0)], q,
                                runner=runner)
        assert runner.stats_counters["host_parts"] == 0
    finally:
        runner.close()
    assert got == jax_run(jax_st, [JLR.TenantID(0, 0)], q), q
    assert got == before[q], q
    assert got == run_query_collect(reopened, [TLR.TenantID(0, 0)], q)


def test_reopened_stream_id_filter(slice_stores, reopened):
    _start, _path, _before, jax_st = slice_stores
    (pt,) = reopened.partitions.values()
    sid = pt.parts[1].block_stream_id(2).as_string()
    for q in (f"_stream_id:{sid} | stats count()",
              f"_stream_id:in({sid}, {'0' * 48}) error",
              f"_stream_id:{'f' * 48} | stats count()"):
        runner = TorchBatchRunner(device="cpu")
        try:
            got = run_query_collect(reopened, [TLR.TenantID(0, 0)], q,
                                    runner=runner)
        finally:
            runner.close()
        assert got == jax_run(jax_st, [JLR.TenantID(0, 0)], q), q


def test_force_merged_store_answers_the_same(slice_stores, tmp_path):
    """A copy of the store, force-merged into one part, gives the same
    rows (in another order: the walk reads one part) and the same
    stats."""
    import shutil
    start, path, before, _jax_st = slice_stores
    shutil.copytree(path, tmp_path / "st")
    st = Storage(str(tmp_path / "st"), device="cpu")
    runner = TorchBatchRunner(device="cpu")
    try:
        _threads_during(st.must_force_merge)
        (pt,) = st.partitions.values()
        (p,) = pt.parts
        assert p.num_rows == SLICE_ROWS and p in pt.ddb.big_parts
        for q in _slice_queries(start):
            got = run_query_collect(st, [TLR.TenantID(0, 0)], q,
                                    runner=runner)
            if "stats" in q:
                assert got == before[q], q
            else:
                key = lambda r: json.dumps(r, sort_keys=True)  # noqa: E731
                assert sorted(got, key=key) == \
                    sorted(before[q], key=key), q
    finally:
        runner.close()
        st.close()
    st = Storage(str(tmp_path / "st"), device="cpu")
    try:
        assert [len(pt.parts) for pt in st.partitions.values()] == [1]
    finally:
        st.close()


def test_select_handler_answers_like_jax_after_reopen(slice_stores,
                                                      reopened):
    from victorialogs_tpu.server import vlselect as JSel
    from victorialogs_tpu_torch.server import vlselect as TSel
    _start, _path, _before, jax_st = slice_stores
    args = {"query": "error", "limit": "50"}
    runner = TorchBatchRunner(device="cpu")
    try:
        got = b"".join(TSel.handle_query(reopened, args, {}, runner=runner))
    finally:
        runner.close()
    want = b"".join(JSel.handle_query(jax_st, dict(args), {}))
    assert got == want and got.count(b"\n") == 50
