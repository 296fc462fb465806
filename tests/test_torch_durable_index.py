"""The port's stream index (storage/indexdb.py, stream_snapshot.py)
against the JAX package.

The JAX package's level and snapshot cases, with small constants
monkeypatched: the tail flushes to a new level past
COMPACT_TAIL_STREAMS, levels merge past MAX_SNAPSHOTS, reopen loads the
levels and replays the log tail, torn files and crashed merges are
recovered, registrations dedupe across levels.  The port runs all of
it inline, on no thread.  Snapshot files are byte-identical to the JAX
package's, searches equal its answers over the same registrations, and
each package opens the other's index directory.

Three faults of the JAX package's index are not carried over; each has
a test of the port's behaviour that does not pin the JAX one:
- a stream of a torn middle level survives the reopen after the one
  that found the tear (`test_torn_level_streams_survive_a_second_reopen`);
- the directory is fsynced after the manifest's rename
  (`test_manifest_rename_is_followed_by_a_directory_fsync`);
- `force_merge` leaves one level holding every stream, with no
  compaction thread to race (`test_force_merge_leaves_one_level`).
"""

import json
import os
import threading
import weakref

import pytest

from victorialogs_tpu.storage import indexdb as JIDX
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import stream_snapshot as JSNAP
from victorialogs_tpu.storage.stream_filter import (StreamFilter as JSF,
                                                    TagFilter as JTF)
from victorialogs_tpu.utils import zstd as JZ
from victorialogs_tpu.utils.hashing import stream_id_hash

IDX = SNAP = TLR = TZ = StreamFilter = TagFilter = None


@pytest.fixture(autouse=True)
def _port():
    global IDX, SNAP, TLR, TZ, StreamFilter, TagFilter
    from victorialogs_tpu_torch.storage import indexdb as IDX
    from victorialogs_tpu_torch.storage import log_rows as TLR
    from victorialogs_tpu_torch.storage import stream_snapshot as SNAP
    from victorialogs_tpu_torch.storage.stream_filter import (StreamFilter,
                                                              TagFilter)
    from victorialogs_tpu_torch.utils import zstd as TZ
    yield


@pytest.fixture(autouse=True)
def _close_what_opens(_port, monkeypatch):
    """Every index and snapshot a test opens is closed when it ends,
    also when it fails (close() is idempotent); held weakly, so a part a
    merge released can still go."""
    opened = []
    for cls in (IDX.IndexDB, SNAP.StreamSnapshot):
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


@pytest.fixture(params=["zstd", "vlz1"])
def codec(request, monkeypatch):
    if request.param == "vlz1":
        monkeypatch.setattr(JZ, "zstandard", None)
        monkeypatch.setattr(TZ, "zstandard", None)
    return request.param


def _ten(a=0, port=True):
    return (TLR if port else JLR).TenantID(a, 0)


def _mk(i, a=0, port=True):
    tags = f'{{app="app{i % 7}",dc="dc{i % 3}",host="h{i}"}}'
    t = _ten(a, port)
    hi, lo = stream_id_hash(f"{a}:0:{tags}".encode())
    return (TLR if port else JLR).StreamID(t, hi, lo), tags


def _sf(label, op, value, port=True):
    if port:
        return StreamFilter(((TagFilter(label, op, value),),))
    return JSF(((JTF(label, op, value),),))


def _manifest(d):
    with open(os.path.join(d, IDX.MANIFEST_FILENAME)) as f:
        return json.load(f)["files"]


def _small(monkeypatch, flush=100, max_snaps=4, batch=3, min_tail=None):
    monkeypatch.setattr(IDX, "COMPACT_TAIL_STREAMS", flush)
    monkeypatch.setattr(IDX, "MAX_SNAPSHOTS", max_snaps)
    monkeypatch.setattr(IDX, "MERGE_BATCH", batch)
    if min_tail is not None:
        monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", min_tail)


def _leveled(tmp_path, monkeypatch, n=1200, **kw):
    """n streams registered 50 at a time, so levels pile up and merge."""
    _small(monkeypatch, **kw)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    before = threading.active_count()
    for start in range(0, n, 50):
        db.must_register_streams([_mk(i) for i in
                                  range(start, min(start + 50, n))])
    assert threading.active_count() == before
    return d, db


def _count(n, pred):
    return len([i for i in range(n) if pred(i)])


# ---------------- levels ----------------

def test_levels_accumulate_and_merge_inline(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch)
    assert db.merge_count > 0
    assert len(db._snaps) <= IDX.MAX_SNAPSHOTS
    assert db.num_streams() == 1200
    ids = db.search_stream_ids([_ten()], _sf("app", "=", "app3"))
    assert len(ids) == _count(1200, lambda i: i % 7 == 3)
    assert len(db.search_stream_ids([_ten()], _sf("host", "=", "h777"))) == 1
    total = sum(os.path.getsize(os.path.join(d, f)) for f in _manifest(d))
    assert db.snap_bytes_written < 3 * total
    db.close()
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 1200
        assert db2.search_stream_ids([_ten()], _sf("app", "=", "app3")) == ids
    finally:
        db2.close()


def test_force_merge_leaves_one_level(tmp_path, monkeypatch):
    """The JAX force_merge races its compaction thread; the port has
    none, and the merge leaves one level holding every stream."""
    d, db = _leveled(tmp_path, monkeypatch, n=1230)
    assert db._streams                       # a tail of 30 streams
    db.force_merge()
    assert len(db._snaps) == 1 and not db._streams
    assert db._snaps[0].n == db.num_streams() == 1230
    db.close()
    assert len(_manifest(d)) == 1
    files = sorted(f for f in os.listdir(d)
                   if f.startswith(IDX.SNAPSHOT_FILENAME))
    assert files == _manifest(d)
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 1230 and len(db2._snaps) == 1
        for i in (0, 617, 1229):
            sid, tags = _mk(i)
            assert db2.get_stream_tags(sid) == tags
    finally:
        db2.close()


def test_torn_middle_level_recovers_from_log(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=600, max_snaps=100)
    db.close()
    files = _manifest(d)
    assert len(files) >= 4
    victim = os.path.join(d, files[len(files) // 2])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 3)
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 600
        ids = db2.search_stream_ids([_ten()], _sf("app", "=", "app2"))
        assert len(ids) == len(set(ids)) == _count(600, lambda i: i % 7 == 2)
    finally:
        db2.close()


def test_torn_level_streams_survive_a_second_reopen(tmp_path, monkeypatch):
    """With fewer replayed streams than SNAPSHOT_MIN_TAIL, the JAX
    index keeps the torn level's streams only in its tail and drops the
    torn level from its manifest, so the reopen after that replays from
    a later level's offset and loses them.  The port writes them to a
    level before the manifest drops the torn one."""
    d, db = _leveled(tmp_path, monkeypatch, n=600, max_snaps=100)
    db.close()
    files = _manifest(d)
    victim = os.path.join(d, files[1])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    IDX.IndexDB(d).close()
    assert files[1] not in _manifest(d)
    for _ in range(2):
        db3 = IDX.IndexDB(d)
        try:
            assert db3.num_streams() == 600
            for i in range(600):
                assert db3.has_stream_id(_mk(i)[0]), i
        finally:
            db3.close()


def test_torn_manifest_replays_the_whole_log(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=400, max_snaps=100)
    db.close()
    with open(os.path.join(d, IDX.MANIFEST_FILENAME), "w") as f:
        f.write('{"files": [')
    for _ in range(2):
        db2 = IDX.IndexDB(d)
        try:
            assert db2.num_streams() == 400
            assert len(_manifest(d)) == 1
        finally:
            db2.close()


def test_crashed_merge_leftover_swept(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=300, max_snaps=100)
    db.close()
    stray = os.path.join(d, "streams.snap.999999")
    with open(stray, "wb") as f:
        f.write(b"not a snapshot")
    with open(os.path.join(d, "streams.snap.000123.tmp"), "wb") as f:
        f.write(b"half")
    db2 = IDX.IndexDB(d)
    try:
        assert not os.path.exists(stray)
        assert not any(f.endswith(".tmp") for f in os.listdir(d))
        assert db2.num_streams() == 300
    finally:
        db2.close()


def test_re_registration_across_levels_is_deduped(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=400, max_snaps=100)
    before = db.num_streams()
    log = os.path.join(d, IDX.STREAMS_FILENAME)
    size = os.path.getsize(log)
    db.must_register_streams([_mk(i) for i in range(0, 400, 3)])
    assert os.path.getsize(log) == size      # nothing new logged
    db.must_register_streams([_mk(i) for i in range(0, 400, 3)] +
                             [_mk(10_000 + i) for i in range(5)] * 2)
    assert db.num_streams() == before + 5
    db.close()
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == before + 5
    finally:
        db2.close()


def test_snapshot_accounting_is_exact(tmp_path, monkeypatch):
    counts = {"n": 0}
    real_write, real_merge = IDX.write_snapshot, IDX.merge_snapshots

    def counting_write(path, streams, log_offset):
        counts["n"] += 1
        return real_write(path, streams, log_offset)

    def counting_merge(path, srcs, log_offset):
        counts["n"] += 1
        return real_merge(path, srcs, log_offset)

    monkeypatch.setattr(IDX, "write_snapshot", counting_write)
    monkeypatch.setattr(IDX, "merge_snapshots", counting_merge)
    d, db = _leveled(tmp_path, monkeypatch, n=1000)
    db.force_merge()
    db.close()
    assert db.snap_files_written == counts["n"] > 10
    assert db.snap_bytes_written > 0


def test_snapshot_written_at_close_and_reopened(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 200)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(250)])
    db.close()
    assert len(_manifest(d)) == 1
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 250 and not db2._streams
        sid, tags = _mk(123)
        assert db2.get_stream_tags(sid) == tags and db2.has_stream_id(sid)
        assert len(db2.search_stream_ids([_ten()], _sf("app", "=", "app5"))) \
            == _count(250, lambda i: i % 7 == 5)
    finally:
        db2.close()


def test_small_tail_stays_in_the_log(tmp_path):
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(20)])
    db.close()
    assert not os.path.exists(os.path.join(d, IDX.MANIFEST_FILENAME))
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 20 and len(db2._streams) == 20
    finally:
        db2.close()


def test_snapshot_plus_tail_queries_merge(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 300)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(300)])
    db.close()
    db2 = IDX.IndexDB(d)
    try:
        db2.must_register_streams([_mk(10_000 + i) for i in range(50)])
        every = list(range(300)) + [10_000 + i for i in range(50)]
        got = db2.search_stream_ids([_ten()], _sf("app", "=", "app0"))
        assert len(got) == len([i for i in every if i % 7 == 0])
        neg = db2.search_stream_ids([_ten()], _sf("app", "!=", "app0"))
        assert len(neg) == len(every) - len(got)
        rx = db2.search_stream_ids([_ten()], _sf("dc", "=~", "dc[01]"))
        assert len(rx) == len([i for i in every if i % 3 != 2])
        assert len(db2.all_stream_ids([_ten()])) == len(every)
        assert got == sorted(got)
    finally:
        db2.close()


def test_torn_snapshot_falls_back_to_log_replay(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 300)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(300)])
    db.close()
    snap = os.path.join(d, _manifest(d)[0])
    with open(snap, "r+b") as f:
        f.truncate(os.path.getsize(snap) // 2)
    db2 = IDX.IndexDB(d)
    try:
        assert db2.num_streams() == 300
        assert len(db2.search_stream_ids([_ten()], _sf("app", "=", "app3"))) \
            == _count(300, lambda i: i % 7 == 3)
    finally:
        db2.close()


def test_multi_tenant_levels(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 100)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i, a=0) for i in range(150)])
    db.must_register_streams([_mk(i, a=1) for i in range(160)])
    db.close()
    db2 = IDX.IndexDB(d)
    try:
        assert len(db2.all_stream_ids([_ten(0)])) == 150
        assert len(db2.all_stream_ids([_ten(1)])) == 160
        assert len(db2.all_stream_ids([_ten(0), _ten(1)])) == 310
        a = db2.search_stream_ids([_ten(0)], _sf("app", "=", "app1"))
        b = db2.search_stream_ids([_ten(1)], _sf("app", "=", "app1"))
        assert a and b and set(a).isdisjoint(b)
        assert db2.all_stream_ids([_ten(7)]) == []
    finally:
        db2.close()


def test_reopen_writes_a_large_replayed_tail(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 100)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(150)])
    db._file.close()                 # a crash: no close(), no level
    assert not os.path.exists(os.path.join(d, IDX.MANIFEST_FILENAME))
    db2 = IDX.IndexDB(d)
    try:
        assert _manifest(d) and not db2._streams
        assert db2.num_streams() == 150
    finally:
        db2.close()


def test_torn_log_tail_does_not_eat_next_registration(tmp_path):
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i) for i in range(20)])
    db.close()
    with open(os.path.join(d, IDX.STREAMS_FILENAME), "ab") as f:
        f.write(b'{"a":0,"p":0,"h":1,"l":2,"t":"{ap')
    db2 = IDX.IndexDB(d)
    sid, tags = _mk(555_555)
    try:
        assert db2.num_streams() == 20
        db2.must_register_streams([(sid, tags)])
    finally:
        db2.close()
    db3 = IDX.IndexDB(d)
    try:
        assert db3.has_stream_id(sid) and db3.num_streams() == 21
    finally:
        db3.close()


def test_merge_adds_tenant_between_existing(tmp_path, monkeypatch):
    monkeypatch.setattr(IDX, "SNAPSHOT_MIN_TAIL", 100)
    d = str(tmp_path / "idb")
    db = IDX.IndexDB(d)
    db.must_register_streams([_mk(i, a=1) for i in range(100)])
    db.must_register_streams([_mk(i, a=9) for i in range(107)])
    db.close()
    db2 = IDX.IndexDB(d)
    extra = [_mk(30_000 + i, a=5) for i in range(40)]
    db2.must_register_streams(extra)
    db2._flush_tail()
    db2.force_merge()
    db2.close()
    db3 = IDX.IndexDB(d)
    try:
        assert not db3._streams and len(db3._snaps) == 1
        assert [len(db3.all_stream_ids([_ten(a)])) for a in (1, 5, 9)] == \
            [100, 40, 107]
        for sid, tags in extra[:5]:
            assert db3.get_stream_tags(sid) == tags
        got = db3.search_stream_ids([_ten(9)], _sf("app", "=", "app1"))
        assert len(got) == _count(107, lambda i: i % 7 == 1)
    finally:
        db3.close()


def test_manifest_rename_is_followed_by_a_directory_fsync(tmp_path,
                                                          monkeypatch):
    """The JAX index renames its manifest without an fsync of the
    directory; in the port each rename of the manifest is followed by
    one."""
    events = []
    real_replace, real_fsync = os.replace, os.fsync

    def replace(src, dst, *a, **kw):
        events.append(("replace", os.path.basename(dst)))
        return real_replace(src, dst, *a, **kw)

    def fsync(fd):
        target = os.readlink(f"/proc/self/fd/{fd}")
        events.append(("fsync", target))
        return real_fsync(fd)

    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr(os, "fsync", fsync)
    d, db = _leveled(tmp_path, monkeypatch, n=500)
    db.force_merge()
    db.close()
    monkeypatch.undo()
    renames = [k for k, e in enumerate(events)
               if e == ("replace", IDX.MANIFEST_FILENAME)]
    assert len(renames) > 5
    for k in renames:
        assert events[k + 1] == ("fsync", os.path.realpath(d)), events[k:k + 2]


def test_index_starts_no_thread(tmp_path, monkeypatch):
    before = threading.active_count()
    d, db = _leveled(tmp_path, monkeypatch, n=700)
    db.force_merge()
    db.close()
    IDX.IndexDB(d).close()
    assert threading.active_count() == before


def test_close_drops_the_level_maps(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=300, max_snaps=100)
    snaps = list(db._snaps)
    assert snaps
    db.close()
    assert all(s._mm is None for s in snaps)
    assert db._file.closed


# ---------------- against the JAX package ----------------

_FILTERS = [
    (("app", "=", "app3"),), (("app", "!=", "app3"),),
    (("host", "=~", "h1.*"),), (("host", "!~", "h1.*"),),
    (("app", "=", "app1"), ("dc", "=", "dc2")),
    (("nope", "=", ""),), (("nope", "!=", ""),), (("app", "=", ""),),
    (("dc", "=~", ""),), (("dc", "=~", "dc[01]|x"),),
]


def _or_filter(groups, port):
    T = TagFilter if port else JTF
    S = StreamFilter if port else JSF
    return S(tuple(tuple(T(*tf) for tf in g) for g in groups))


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("fi", range(len(_FILTERS)))
def test_search_equals_jax(tmp_path, monkeypatch, levels, fi):
    """The same registrations (a tail, or levels plus a tail) in both
    packages: every search gives the same ids.  The last case ORs two
    groups."""
    groups = [_FILTERS[fi]] + ([_FILTERS[(fi + 3) % len(_FILTERS)]]
                               if fi == len(_FILTERS) - 1 else [])
    if levels:
        _small(monkeypatch, flush=60, max_snaps=3, batch=2)
        monkeypatch.setattr(JIDX, "COMPACT_TAIL_STREAMS", 1 << 30)
    tdb = IDX.IndexDB(str(tmp_path / "t"))
    jdb = JIDX.IndexDB(str(tmp_path / "j"))
    try:
        for a in (0, 1):
            for s in range(0, 200, 40):
                tdb.must_register_streams(
                    [_mk(i, a) for i in range(s, s + 40)])
                jdb.must_register_streams(
                    [_mk(i, a, port=False) for i in range(s, s + 40)])
        assert bool(tdb._snaps) == levels
        for tenants in ([0], [1], [0, 1]):
            got = tdb.search_stream_ids([_ten(a) for a in tenants],
                                        _or_filter(groups, True))
            want = jdb.search_stream_ids(
                [_ten(a, False) for a in tenants], _or_filter(groups, False))
            assert [s.as_string() for s in got] == \
                [s.as_string() for s in want]
    finally:
        jdb.close()
        tdb.close()


def test_snapshot_files_equal_jax(tmp_path, codec):
    streams = dict(_mk(i, a=i % 3) for i in range(300))
    jstreams = dict(_mk(i, a=i % 3, port=False) for i in range(300))
    SNAP.write_snapshot(str(tmp_path / "t1"), streams, 1234)
    JSNAP.write_snapshot(str(tmp_path / "j1"), jstreams, 1234)
    assert (tmp_path / "t1").read_bytes() == (tmp_path / "j1").read_bytes()
    half = dict(list(streams.items())[:120])
    jhalf = dict(list(jstreams.items())[:120])
    SNAP.write_snapshot(str(tmp_path / "t2"), half, 99)
    JSNAP.write_snapshot(str(tmp_path / "j2"), jhalf, 99)
    tsrc = [SNAP.StreamSnapshot(str(tmp_path / n)) for n in ("t1", "t2")]
    jsrc = [JSNAP.StreamSnapshot(str(tmp_path / n)) for n in ("j1", "j2")]
    SNAP.merge_snapshots(str(tmp_path / "tm"), tsrc, 1234)
    JSNAP.merge_snapshots(str(tmp_path / "jm"), jsrc, 1234)
    for s in tsrc:
        s.close()
    assert (tmp_path / "tm").read_bytes() == (tmp_path / "jm").read_bytes()
    merged = SNAP.StreamSnapshot(str(tmp_path / "tm"))
    try:
        assert merged.n == 300
    finally:
        merged.close()


def test_port_opens_a_jax_index(tmp_path, monkeypatch):
    """A JAX index with levels, a merge and a log tail, opened by the
    port: the same streams, tags and searches."""
    monkeypatch.setattr(JIDX, "COMPACT_TAIL_STREAMS", 50)
    monkeypatch.setattr(JIDX, "MAX_SNAPSHOTS", 3)
    monkeypatch.setattr(JIDX, "MERGE_BATCH", 2)
    d = str(tmp_path / "idb")
    jdb = JIDX.IndexDB(d)
    try:
        for s in range(0, 330, 30):
            jdb.must_register_streams([_mk(i, port=False)
                                       for i in range(s, s + 30)])
            t = jdb._compact_thread
            if t is not None:
                t.join()
        want = {f: jdb.search_stream_ids([_ten(0, False)],
                                         _sf(*f, port=False))
                for f in (("app", "=", "app4"), ("host", "=~", "h2.*"))}
    finally:
        jdb.close()
    assert len(_manifest(d)) > 1
    tdb = IDX.IndexDB(d)
    try:
        assert tdb.num_streams() == 330
        for i in (0, 100, 329):
            sid, tags = _mk(i)
            assert tdb.get_stream_tags(sid) == tags
        for f, w in want.items():
            got = tdb.search_stream_ids([_ten()], _sf(*f))
            assert [s.as_string() for s in got] == \
                [s.as_string() for s in w]
    finally:
        tdb.close()


def test_jax_opens_a_port_index(tmp_path, monkeypatch):
    d, db = _leveled(tmp_path, monkeypatch, n=420)
    db.close()
    jdb = JIDX.IndexDB(d)
    try:
        assert jdb.num_streams() == 420
        got = jdb.search_stream_ids([_ten(0, False)],
                                    _sf("app", "=", "app6", port=False))
        assert len(got) == _count(420, lambda i: i % 7 == 6)
    finally:
        jdb.close()


def test_memory_index_equals_the_durable_one(tmp_path, monkeypatch):
    _small(monkeypatch, flush=40)
    mem = IDX.MemoryIndex()
    db = IDX.IndexDB(str(tmp_path / "idb"))
    try:
        for s in range(0, 150, 25):
            batch = [_mk(i, a=i % 2) for i in range(s, s + 25)]
            mem.must_register_streams(batch)
            db.must_register_streams(batch)
        assert mem.num_streams() == db.num_streams() == 150
        for groups in _FILTERS:
            sf = _or_filter([groups], True)
            for tenants in ([_ten(0)], [_ten(0), _ten(1)]):
                assert mem.search_stream_ids(tenants, sf) == \
                    db.search_stream_ids(tenants, sf)
        assert mem.all_stream_ids([_ten(1)]) == db.all_stream_ids([_ten(1)])
        sid, tags = _mk(77, a=1)
        assert mem.get_stream_tags(sid) == db.get_stream_tags(sid) == tags
    finally:
        db.close()
