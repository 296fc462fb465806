"""Parity of the port's insert path with the JAX package.

The same body, made from a numpy seed (the generator's rows, or lines
written here for the JSON edge cases), goes through both packages'
`/insert/jsonline` or Elasticsearch `_bulk` handler into a Storage, then
one flush; every flushed part must match block for block
(`assert_part_equal`).  The serial block build is held against the JAX
package's on row and column batches, and the flush merge of several
batches against its `debug_flush`; the native JSON-lines scan against
its plain Python scan; queries on a jsonline-built store against the
same on a row-built one.  The handlers start no thread, and a failed
build of the ingest library raises.
"""

import json
import threading
import time

import numpy as np
import pytest

from victorialogs_tpu.server import insertutil as JI
from victorialogs_tpu.server import vlinsert as JV
from victorialogs_tpu.storage import block_build as JBB
from victorialogs_tpu.storage import datadb as JDD
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                       bulk_body, generate,
                                                       jsonline_body,
                                                       today_start_ns)
from test_torch_storage import assert_column_equal, assert_part_equal

NS = 1_000_000_000
STREAMS = ["app", "host"]

# the port loads (torch, through Storage's device check) in the worker
# that runs these tests, not in every worker that collects them
TI = TV = TBB = TLR = TVE = Storage = Part = native = ingest = None


@pytest.fixture(autouse=True)
def _port():
    global TI, TV, TBB, TLR, TVE, Storage, Part, native, ingest
    from victorialogs_tpu_torch import native
    from victorialogs_tpu_torch.native import ingest
    from victorialogs_tpu_torch.server import insertutil as TI
    from victorialogs_tpu_torch.server import vlinsert as TV
    from victorialogs_tpu_torch.storage import block_build as TBB
    from victorialogs_tpu_torch.storage import log_rows as TLR
    from victorialogs_tpu_torch.storage import values_encoder as TVE
    from victorialogs_tpu_torch.storage.part import Part
    from victorialogs_tpu_torch.storage.storage import Storage
    yield


@pytest.fixture(autouse=True)
def _jax_flushes_only_when_asked(monkeypatch):
    """The JAX package's flusher thread flushes on its own once more
    than MAX_INMEMORY_PARTS batches are buffered, at a moment of its
    choosing, and the port's add flushes past its own
    MAX_INMEMORY_PARTS; raised in both here, every part comes from
    debug_flush (tests/test_torch_unflushed.py holds the in-call
    flush)."""
    from victorialogs_tpu_torch.storage import storage as TS
    monkeypatch.setattr(JDD, "MAX_INMEMORY_PARTS", 1 << 30)
    monkeypatch.setattr(TS, "MAX_INMEMORY_PARTS", 1 << 30)


@pytest.fixture(scope="module")
def now_ns():
    """A time inside every retention window, an hour before now."""
    return time.time_ns() - 3600 * NS


# ---------------- both packages through one handler ----------------

def _port_store(body, route="jsonline", **cp_kw):
    st = Storage(device="cpu")
    cp = TI.CommonParams(**cp_kw)
    lmp = TI.LogMessageProcessor(cp, TI.LocalLogRowsStorage(st))
    if route == "jsonline":
        n, resp = TV.handle_jsonline(cp, body, lmp), None
    else:
        n, resp = TV.handle_elasticsearch_bulk(cp, body, lmp)
    lmp.flush()
    st.debug_flush()
    return st, n, resp


def _jax_store(path, body, route="jsonline", **cp_kw):
    st = JS.Storage(str(path), flush_interval=3600)
    cp = JI.CommonParams(**cp_kw)
    lmp = JI.LogMessageProcessor(cp, JI.LocalLogRowsStorage(st))
    try:
        if route == "jsonline":
            n, resp = JV.handle_jsonline(cp, body, lmp), None
        else:
            n, resp = JV.handle_elasticsearch_bulk(cp, body, lmp)
        lmp.flush()
        st.debug_flush()
    except BaseException:
        st.close()
        raise
    return st, n, resp


def _assert_stores_equal(port, jax_st, timestamps=True):
    assert sorted(port.partitions) == sorted(jax_st.partitions)
    assert (port.rows_dropped_too_old, port.rows_dropped_too_new) == \
        (jax_st.rows_dropped_too_old, jax_st.rows_dropped_too_new)
    for day, pt in port.partitions.items():
        jparts = jax_st.partitions[day].ddb.snapshot_parts()
        assert len(pt.parts) == len(jparts)
        for tp, jp in zip(pt.parts, jparts):
            if timestamps:
                assert_part_equal(tp, jp)
            else:
                _assert_part_equal_but_time(tp, jp)


def _assert_part_equal_but_time(tp, jp):
    assert (tp.num_blocks, tp.num_rows) == (jp.num_blocks, jp.num_rows)
    for i in range(jp.num_blocks):
        jb, tb = jp.read_block(i), tp.blocks[i]
        assert tb.stream_id.as_string() == jb.stream_id.as_string()
        assert tb.stream_tags_str == jb.stream_tags_str
        assert tb.const_columns == [tuple(c) for c in jb.const_columns]
        assert [c.name for c in tb.columns] == [c.name for c in jb.columns]
        for tc, jc in zip(tb.columns, jb.columns):
            assert_column_equal(tc, jc)


def _both(tmp_path, body, route="jsonline", timestamps=True, **cp_kw):
    """Ingest `body` into both packages; their parts must be equal.
    Returns the rows each handler counted and the port's response."""
    t0 = time.time_ns()
    port, n, resp = _port_store(body, route, **cp_kw)
    t1 = time.time_ns()
    jax_st, jn, jresp = _jax_store(tmp_path / "jax", body, route, **cp_kw)
    try:
        assert n == jn
        assert resp == jresp
        _assert_stores_equal(port, jax_st, timestamps)
        if not timestamps:
            for pt in port.partitions.values():
                for p in pt.parts:
                    assert t0 <= p.min_ts <= p.max_ts <= t1
    finally:
        jax_st.close()
        port.close()
    return n, resp


def _lines(objs, **dumps_kw) -> bytes:
    return "".join(json.dumps(o, **dumps_kw) + "\n"
                   for o in objs).encode("utf-8")


def _escapes(now):
    rng = np.random.default_rng(5)
    vals = ['say "hi"', "back\\slash", "two\nlines", "tab\there", "é",
            "\U0001F600 grin", "ctl\x01", "/slash", "plain"]
    out = []
    for i in range(300):
        v = vals[int(rng.integers(0, len(vals)))]
        out.append({"_time": now + i, "_msg": f"{v} {i}", "app": v[:3],
                    "k": vals[i % len(vals)]})
    return out


def _scalars(now):
    rng = np.random.default_rng(6)
    out = []
    for i in range(400):
        o = {"_time": now + i, "_msg": f"m {i}", "app": f"a{i % 3}",
             "n": int(rng.integers(-5, 5)), "f": float(rng.random()),
             "big": 10 ** 20 + i, "e": 1e5 + i, "t": bool(i % 2),
             "neg0": -0.0 if i % 5 else 0}
        if i % 7 == 0:
            o["nested"] = {"a": {"b": i}, "c": [1, "x", None]}
        if i % 11 == 0:
            o["none"] = None
        if i % 13 == 0:
            o["arr"] = [i, {"k": "v"}]
        out.append(o)
    return out


def _times(now):
    out = []
    for i in range(200):
        kind = i % 6
        sec = now // NS - i
        t = [time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(sec))
             + f".{i:03d}Z", sec, sec * 1000 + i, sec * 10**6 + i,
             now - i, 0][kind]
        out.append({"_msg": f"t{kind} {i}", "app": f"k{kind}", "_time": t})
    return out


def _gen_rows(n=2000, seed=1):
    return generate(n, seed, today_start_ns(), NS_PER_DAY // 4, streams=16)


def _case(name, now):
    """(body, CommonParams kwargs, timestamps comparable)."""
    sf = {"stream_fields": STREAMS}
    if name == "generator":
        return jsonline_body(_gen_rows()), sf, True
    if name == "escapes_ascii":
        return _lines(_escapes(now)), {"stream_fields": ["app"]}, True
    if name == "escapes_utf8":
        return _lines(_escapes(now), ensure_ascii=False), \
            {"stream_fields": ["app"]}, True
    if name == "scalars_nested":
        return _lines(_scalars(now)), {"stream_fields": ["app"]}, True
    if name == "time_forms":
        return _lines(_times(now)), {"stream_fields": ["app"]}, True
    if name == "time_missing":
        objs = [{"_msg": f"m {i}", "app": f"a{i % 2}", "v": str(i)}
                for i in range(300)]
        return _lines(objs), {"stream_fields": ["app"]}, False
    if name == "msg_field_crlf_blank":
        objs = [{"_time": now + i, "message": f"hello {i}", "_msg": "x",
                 "app": f"a{i % 4}", "lvl": ["info", "warn"][i % 2]}
                for i in range(300)]
        body = "".join(json.dumps(o) + ("\r\n" if i % 2 else "\n")
                       + ("\n  \n" if i % 17 == 0 else "")
                       for i, o in enumerate(objs))
        return body.encode(), {"stream_fields": ["app", "lvl"],
                               "msg_fields": ["message"]}, True
    if name == "flagged_lines":
        lines = []
        for i in range(300):
            t = now + i
            lines.append([
                f'{{"_time": {t}, "_msg": "dup {i}", "_msg": "second"}}',
                f'\x0c{{"_time": {t}, "_msg": "formfeed {i}"}}',
                f'{{"_time": {t}, "_msg": "nul", "x": null}}',
                f'{{"_time": {t}, "_msg": "exp {i}", "n": 1E+2}}',
                f'{{ "_time" : {t} , "_msg" : "spaced {i}" }}',
                f'{{"_time": {t}, "_msg": "plain {i}", "app": "p"}}',
            ][i % 6])
        return ("\n".join(lines) + "\n").encode(), \
            {"stream_fields": ["app"]}, True
    if name == "default_msg":
        objs = [{"_time": now + i, "app": f"a{i % 3}", "v": str(i)}
                for i in range(200)]
        return _lines(objs), {"stream_fields": ["app"],
                              "default_msg_value": "none"}, True
    if name == "ignore_extra_fields":
        return jsonline_body(_gen_rows(600, 2)), {
            "stream_fields": STREAMS, "ignore_fields": ["user", "la*"],
            "extra_fields": [("env", "prod"), ("app", "shadowed")]}, True
    raise KeyError(name)


JSONLINE_CASES = ("generator", "escapes_ascii", "escapes_utf8",
                  "scalars_nested", "time_forms", "time_missing",
                  "msg_field_crlf_blank", "flagged_lines", "default_msg",
                  "ignore_extra_fields")


@pytest.mark.parametrize("case", JSONLINE_CASES)
def test_jsonline_parts_match_jax(tmp_path, now_ns, case):
    body, cp_kw, timestamps = _case(case, now_ns)
    n, _ = _both(tmp_path, body, timestamps=timestamps, **cp_kw)
    assert n > 0


def test_jsonline_over_chunk_and_batch_bounds(tmp_path, monkeypatch):
    """A body over the scan's chunk and over the batch's rows, at small
    bounds set alike in both packages: several chunks, several column
    batches and a flush merge."""
    for mod in (TV, JV):
        monkeypatch.setattr(mod, "_NATIVE_CHUNK", 64 << 10)
        monkeypatch.setattr(mod, "_FAST_CHUNK_ROWS", 700)
    body = jsonline_body(_gen_rows(3000, 4))
    assert len(body) > 3 * (64 << 10)
    before = dict(TV.INGEST_COUNTERS)
    n, _ = _both(tmp_path, body, stream_fields=STREAMS)
    assert n == 3000
    assert TV.INGEST_COUNTERS == before


@pytest.mark.parametrize("body,match", [
    (b'{"_msg": "ok"}\n{"_msg": "\xff\xfe"}\n', "UTF-8"),
    (b'{"_msg": "ok"}\n[1, 2]\n', "object"),
    (b'{"_msg": "ok"}\n{"_msg": \n', "JSON"),
    (b'{"_msg": "ok"}\n"text"\n', "object"),
])
def test_jsonline_errors_match_jax(tmp_path, body, match):
    port = Storage(device="cpu")
    cp = TI.CommonParams()
    lmp = TI.LogMessageProcessor(cp, TI.LocalLogRowsStorage(port))
    with pytest.raises(TV.IngestError, match=match):
        TV.handle_jsonline(cp, body, lmp)
    jax_st = JS.Storage(str(tmp_path / "jax"), flush_interval=3600)
    try:
        jcp = JI.CommonParams()
        jl = JI.LogMessageProcessor(jcp, JI.LocalLogRowsStorage(jax_st))
        with pytest.raises(JV.IngestError, match=match):
            JV.handle_jsonline(jcp, body, jl)
    finally:
        jax_st.close()


# ---------------- Elasticsearch _bulk ----------------

def test_bulk_parts_match_jax(tmp_path):
    body = bulk_body(_gen_rows(1500, 3))
    n, resp = _both(tmp_path, body, route="bulk", stream_fields=STREAMS)
    assert n == 1500
    assert resp == {"took": 0, "errors": False,
                    "items": [{"create": {"status": 201}}] * 1500}


def test_bulk_actions_and_fields_match_jax(tmp_path, now_ns):
    lines = []
    for i in range(120):
        op = ["create", "index", "delete", "update"][i % 4]
        lines.append(json.dumps({op: {"_index": "logs", "_id": str(i)}}))
        if op == "delete":
            continue
        doc = {"@timestamp": now_ns + i, "message": f"msg {i}",
               "host": {"name": f"h{i % 3}"}, "n": i}
        if i % 8 == 1:
            doc = {"timestamp": now_ns + i, "msg": f"short {i}",
                   "_msg": "own", "host": {"name": "h9"}}
        if op == "update":
            doc = {"doc": {"message": "ignored"}}
        lines.append(json.dumps(doc))
        if i % 10 == 0:
            lines.append("")
    body = ("\n".join(lines) + "\n").encode()
    n, resp = _both(tmp_path, body, route="bulk",
                    stream_fields=["host.name"])
    assert n == 60
    assert len(resp["items"]) == 60


def test_bulk_equals_jsonline_and_rows():
    """The generator's rows give the same part by rows, by jsonline and
    by _bulk."""
    rows = _gen_rows(1200, 7)
    by_rows = Storage(device="cpu")
    lr = TLR.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(TLR.TenantID(0, 0), ts, fields)
    by_rows.must_add_rows(lr)
    by_rows.debug_flush()
    (want,) = next(iter(by_rows.partitions.values())).parts
    for route, body in (("jsonline", jsonline_body(rows)),
                        ("bulk", bulk_body(rows))):
        st, n, _ = _port_store(body, route, stream_fields=STREAMS)
        (got,) = next(iter(st.partitions.values())).parts
        assert n == len(rows)
        _assert_port_parts_equal(got, want)


def _assert_port_parts_equal(a, b):
    assert (a.num_blocks, a.num_rows, a.min_ts, a.max_ts) == \
        (b.num_blocks, b.num_rows, b.min_ts, b.max_ts)
    for x, y in zip(a.blocks, b.blocks):
        assert x.stream_id == y.stream_id
        assert x.stream_tags_str == y.stream_tags_str
        assert np.array_equal(x.timestamps, y.timestamps)
        assert x.const_columns == y.const_columns
        assert [c.name for c in x.columns] == [c.name for c in y.columns]
        for cx, cy in zip(x.columns, y.columns):
            assert_column_equal(cx, cy)


# ---------------- the block build ----------------

# the realistic invalid-UTF-8 ingest outcome: replacement characters
BAD_UTF8 = b"\xff\xfe broken \x80".decode("utf-8", "replace")


def _mixed_rows(nrows=1500, nstreams=9, t0=None):
    """Rows of >= 8 streams in 3 schema groups with every value type
    the encoder detects, empty values, NULs and invalid UTF-8."""
    t0 = t0 or today_start_ns()
    out = []
    for i in range(nrows):
        s = i % nstreams
        fields = [("app", f"a{s}"), ("host", f"h{s % 3}"),
                  ("_msg", f"msg {i} tok{i % 37} {'x' * (i % 23)}"),
                  ("level", ["info", "warn", "error"][i % 3]),
                  ("count", str(i)), ("neg", str(-i)), ("f", f"{i}.25"),
                  ("ip", f"10.0.{i % 256}.{i % 200}"),
                  ("iso", "2025-07-28T12:00:%02d.%03dZ" % (i % 60,
                                                           i % 1000)),
                  ("const", "xyz")]
        if i % 3 == 0:
            fields.append(("sparse", f"s{i % 4}"))
        if i % 7 == 0:
            fields.append(("nasty", ["", "12\x00", BAD_UTF8,
                                     "snow\u2603"][i % 4]))
        out.append((t0 + (i % 500) * NS + i, fields))
    return out


def _row_batches(rows, stream_fields=("app", "host")):
    lr = TLR.LogRows(stream_fields=list(stream_fields))
    jl = JLR.LogRows(stream_fields=list(stream_fields))
    for ts, fields in rows:
        lr.add(TLR.TenantID(0, 0), ts, fields)
        jl.add(JLR.TenantID(0, 0), ts, fields)
    return lr, jl


def _column_batches(lr, jl, arena=False):
    """The rows of (lr, jl) as each package's LogColumns, grouped by
    schema; with `arena`, ASCII NUL-free columns as ArenaColumns."""
    out = []
    for LC, BB, src in ((TLR.LogColumns, TBB, lr),
                        (JLR.LogColumns, JBB, jl)):
        lc = LC()
        for ts, row, sid, tags in zip(src.timestamps, src.rows,
                                      src.stream_ids, src.stream_tags_str):
            names = tuple(k for k, _ in row)
            g = lc.group(names, ())
            lc.add(g, sid.tenant, ts, [v for _, v in row], sid, tags)
        if arena:
            for g in lc.groups.values():
                for ci, col in enumerate(g.cols):
                    text = "".join(col)
                    if not text.isascii() or "\x00" in text:
                        continue
                    lens = np.array([len(v) for v in col], dtype=np.int64)
                    offs = np.zeros(len(col), dtype=np.int64)
                    np.cumsum(lens[:-1], out=offs[1:])
                    g.cols[ci] = BB.ArenaColumn(text.encode(), offs, lens,
                                                text)
        out.append(lc)
    return out


def test_log_columns_bulk_adds_equal_row_adds():
    """add_bulk and add_bulk_refs give the batch add gives row by row."""
    lr, _jl = _row_batches(_gen_rows(300, 16))
    by_row, by_bulk, by_refs = (TLR.LogColumns() for _ in range(3))
    names = tuple(k for k, _ in lr.rows[0])
    for ts, row, sid, tags in zip(lr.timestamps, lr.rows, lr.stream_ids,
                                  lr.stream_tags_str):
        by_row.add(by_row.group(names, (1, 2)), sid.tenant, ts,
                   [v for _, v in row], sid, tags)
    cols = [list(c) for c in zip(*[[v for _, v in r] for r in lr.rows])]
    tenant = lr.stream_ids[0].tenant
    by_bulk.add_bulk(by_bulk.group(names, (1, 2)), tenant, lr.timestamps,
                     cols, lr.stream_ids, lr.stream_tags_str)
    g = by_refs.group(names, (1, 2))
    refs = [by_refs.intern_stream(g, tenant, sid, tags)
            for sid, tags in zip(lr.stream_ids, lr.stream_tags_str)]
    by_refs.add_bulk_refs(g, lr.timestamps, cols, refs)
    for lc in (by_bulk, by_refs):
        assert lc.nrows == by_row.nrows == 300
        assert lc.unique_streams() == by_row.unique_streams()
        (a,), (b,) = lc.groups.values(), by_row.groups.values()
        assert (a.ts, a.sref, a.cols, a.streams) == \
            (b.ts, b.sref, b.cols, b.streams)
        _assert_port_parts_equal(Part(lc.build_blocks()),
                                 Part(by_row.build_blocks()))


def _assert_blocks_equal(tblocks, jblocks):
    assert_part_equal(Part(tblocks), JDD.InmemoryPart(jblocks))


@pytest.mark.parametrize("rows", ["mixed", "generator"])
def test_build_log_rows_blocks_matches_jax(rows):
    rows = _mixed_rows() if rows == "mixed" else _gen_rows(3000, 8)
    lr, jl = _row_batches(rows)
    _assert_blocks_equal(TBB.build_log_rows_blocks(lr),
                         JBB.build_log_rows_blocks(jl))


@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("rows", ["mixed", "generator"])
def test_build_columns_blocks_matches_jax(rows, arena):
    rows = _mixed_rows() if rows == "mixed" else _gen_rows(3000, 8)
    lr, jl = _row_batches(rows)
    tlc, jlc = _column_batches(lr, jl, arena)
    assert any(type(c) is TBB.ArenaColumn for g in tlc.groups.values()
               for c in g.cols) == arena
    tblocks = TBB.build_columns_blocks(tlc)
    _assert_blocks_equal(tblocks, JBB.build_columns_blocks(jlc))
    # the columnar and the row build give equal blocks, also where a
    # stream's rows span several schema groups
    _assert_blocks_equal(tblocks, JBB.build_log_rows_blocks(jl))
    _assert_port_parts_equal(Part(tblocks),
                             Part(TBB.build_log_rows_blocks(lr)))


_ARENA_VALUES = {
    "const": ["x"] * 5,
    "empty": [""] * 4,
    "dict": ["red", "green", "blue", "red", ""],
    "dict_overflow": [f"v{i}" for i in range(9)],
    "uint": ["1", "200", "0", "255", "65536"],
    "int": ["-1", "5", "-9223372036854775808", "0", "12"],
    "float": ["1.5", "2.25", "-3.0", "1e10", "0.1"],
    "float_noncanon": ["1.50", "2.0"],
    "ipv4": ["10.0.0.1", "192.168.1.255", "1.2.3.4", "0.0.0.0"],
    "ipv4_leading_zero": ["10.0.0.01", "1.2.3.4"],
    "iso": ["2024-01-02T03:04:05.123Z", "2024-01-02T03:04:06.000Z"],
    "iso_widths": ["2024-01-02T03:04:05.1Z", "2024-01-02T03:04:06.00Z"],
    "strings": ["alpha beta", "gamma", "", "x y z", "1 2"],
    "nul": ["12\x00", "12", "3"],
    "long_dict": ["a" * 300, "b"],
    "many_rows": [f"k{i % 5}" for i in range(600)],
    "many_rows_wide": [f"k{i % 9}" for i in range(600)],
}


@pytest.mark.parametrize("case", sorted(_ARENA_VALUES))
def test_encode_arena_column_matches_jax(case):
    vals = _ARENA_VALUES[case]
    raw = "".join(vals).encode()
    lens = np.array([len(v) for v in vals], dtype=np.int64)
    offs = np.zeros(len(vals), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    sub = np.frombuffer(raw, dtype=np.uint8)
    tc = TBB.encode_arena_column("f", sub, offs, lens)
    jc = JBB.encode_arena_column("f", sub, offs, lens)
    assert_column_equal(tc, jc)
    assert_column_equal(tc, TVE.encode_values("f", vals))


# ---------------- the flush merge ----------------

def test_flush_of_mixed_batches_matches_jax(tmp_path):
    """Four batches into one partition, then one flush: rows, columns,
    rows with times overlapping the first batch's, columns; streams of
    a few rows a batch coalesce, overlapping ones merge by row."""
    start = today_start_ns()
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path / "jax"), flush_interval=3600)
    try:
        batches = [
            ("rows", generate(1600, 21, start, NS_PER_DAY // 8,
                              streams=16)),
            ("columns", generate(1600, 22, start + NS_PER_DAY // 8,
                                 NS_PER_DAY // 8, streams=16)),
            ("rows", generate(800, 23, start + NS, NS_PER_DAY // 8,
                              streams=4)),
            ("columns", _mixed_rows(900, 9, start + NS_PER_DAY // 4)),
        ]
        for kind, rows in batches:
            lr, jl = _row_batches(rows)
            if kind == "rows":
                port.must_add_rows(lr)
                jax_st.must_add_rows(jl)
            else:
                tlc, jlc = _column_batches(lr, jl)
                port.must_add_columns(tlc)
                jax_st.must_add_columns(jlc)
        (pt,) = port.partitions.values()
        assert len(pt._pending) == 4
        port.debug_flush()
        jax_st.debug_flush()
        _assert_stores_equal(port, jax_st)
        (tp,) = pt.parts
        from victorialogs_tpu_torch.storage import merge
        assert any(b.num_rows < merge.COALESCE_MIN_ROWS for b in tp.blocks)
        assert tp.num_rows == sum(len(r) for _k, r in batches)
    finally:
        jax_st.close()
        port.close()


def test_columns_retention_and_days_match_jax(tmp_path):
    """A column batch across two UTC days with rows outside the
    retention window on both sides."""
    now = time.time_ns()
    rows = generate(600, 9, today_start_ns() - NS_PER_DAY // 2, NS_PER_DAY,
                    streams=4)
    rows += [(now - 30 * NS_PER_DAY, [("_msg", "old"), ("app", "a")]),
             (now + 10 * NS_PER_DAY, [("_msg", "new"), ("app", "a")])]
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path / "jax"), flush_interval=3600)
    try:
        lr, jl = _row_batches(rows)
        tlc, jlc = _column_batches(lr, jl)
        port.must_add_columns(tlc)
        jax_st.must_add_columns(jlc)
        port.debug_flush()
        jax_st.debug_flush()
        assert (port.rows_dropped_too_old, port.rows_dropped_too_new) == \
            (1, 1)
        _assert_stores_equal(port, jax_st)
    finally:
        jax_st.close()
        port.close()


# ---------------- queries on the stores the routes built ----------------

QUERIES = ("error", "quota", "_stream:{app=\"app-3\"} timeout",
           "* | stats by (app) count()", "lvl:in(error, warn) | "
           "stats by (lvl) count(), sum(dur)", "error | sort by (dur) "
           "desc limit 5", "user:len_range(6, 8) | stats count()")


def test_queries_on_jsonline_store_equal_row_store():
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    rows = _gen_rows(4000, 12)
    by_rows = Storage(device="cpu")
    lr = TLR.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(TLR.TenantID(0, 0), ts, fields)
    by_rows.must_add_rows(lr)
    by_rows.debug_flush()
    by_json, _n, _ = _port_store(jsonline_body(rows),
                                 stream_fields=STREAMS)
    runner = TorchBatchRunner(device="cpu")
    t = [TLR.TenantID(0, 0)]
    try:
        for q in QUERIES:
            want = run_query_collect(by_rows, t, q)
            assert want, q
            assert run_query_collect(by_json, t, q) == want, q
            assert run_query_collect(by_json, t, q, runner=runner) == \
                want, q
    finally:
        runner.close()


# ---------------- the native scan against its plain version ----------------

def _scan_state(scan_fn, chunk, **cp_kw):
    got = []

    class Sink(TI.LocalLogRowsStorage):
        def must_add_rows(self, lr):
            got.append(("rows", list(lr.timestamps), list(lr.rows),
                        [s.as_string() for s in lr.stream_ids]))

        def must_add_columns(self, lc):
            got.append(("columns", [
                (g.names, g.stream_pos, list(g.ts), [list(c) for c in g.cols],
                 [(g.streams[r][0].as_string(), g.streams[r][2])
                  for r in g.sref])
                for g in lc.groups.values()]))

    cp = TI.CommonParams(**cp_kw)
    lmp = TI.LogMessageProcessor(cp, Sink(None))
    st = TV._FastState(cp, lmp)
    scan_fn(st, chunk)
    lmp.ingest_columns(st.lc)
    lmp.flush()
    return st.n, got


@pytest.mark.parametrize("case", ["generator", "escapes_ascii",
                                  "escapes_utf8", "scalars_nested",
                                  "time_forms", "msg_field_crlf_blank",
                                  "flagged_lines", "default_msg"])
def test_native_scan_equals_plain_scan(now_ns, case):
    body, cp_kw, _ = _case(case, now_ns)
    cp_kw.pop("ignore_fields", None)
    cp_kw.pop("extra_fields", None)
    scan = ingest.jsonline_scan(body)
    assert scan is not None
    native_out = _scan_state(
        lambda st, b: TV._scan_chunk_native(st, b, scan), body, **cp_kw)
    plain_out = _scan_state(
        lambda st, b: TV._scan_chunk_py(st, b.decode("utf-8")), body,
        **cp_kw)
    assert native_out == plain_out
    assert native_out[0] > 0


def test_scan_flags_what_json_loads_must_parse():
    body = (b'{"a": "x"}\n{"a": null}\n{"a": 1, "a": 2}\n{"a": [1]}\n'
            b'{"a": {"b": 1}}\n[1]\n{"a": "\\ud800"}\n{"a": 1} x\n'
            b'{"a": 01}\n{"a": tru}\n{}\n  \n{"b": -0, "c": 1.5e3}\n')
    _arena, fields, lines, _sigs, ascii_ = ingest.jsonline_scan(body)
    assert ascii_
    assert lines[:, 2].tolist() == [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
    assert lines[:, 1].tolist() == [1] + [0] * 9 + [0, 2]
    assert fields[:, 4].tolist() == [0, 1, 2]


def test_native_tokens_equal_numpy_tokens():
    from victorialogs_tpu_torch.utils.hashing import hash_tokens
    from victorialogs_tpu_torch.utils import tokenizer as TT
    vals = ["GET /a_b?x=1 héllo wörld", "", "a.b-c", "x" * 40, "é",
            "12 12 12", "__ _ "]
    raw = "".join(vals).encode()
    lens = np.array([len(v.encode()) for v in vals], dtype=np.int64)
    offs = np.zeros(len(vals), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    arena = np.frombuffer(raw, dtype=np.uint8)
    for a, b in zip(ingest.tokenize_arena(arena, offs, lens),
                    TT.tokenize_arena(arena, offs, lens)):
        assert np.array_equal(a, b)
    ts_, te_, _ = TT.tokenize_arena(arena, offs, lens)
    want = hash_tokens(TT.unique_tokens_bytes(arena, ts_, te_))
    got = ingest.unique_token_hashes(arena, offs, lens)
    assert sorted(got.tolist()) == sorted(want.tolist())
    assert len(got) == len(want)
    with pytest.raises(ValueError):
        ingest.unique_token_hashes(arena, offs + 1, lens)


# ---------------- request helpers ----------------

@pytest.mark.parametrize("args,headers", [
    ({}, {}),
    ({"_stream_fields": "app, host", "_msg_field": "message,log",
      "_time_field": "ts", "ignore_fields": "a,b*",
      "extra_fields": "env=prod,bad,k=v=w", "default_msg_value": "-",
      "debug": "true", "AccountID": "3"},
     {"ProjectID": "4"}),
    ({}, {"VL-Stream-Fields": "app", "VL-Msg-Field": "m",
          "VL-Decolorize-Fields": "_msg", "VL-Debug": "1",
          "AccountID": "x"}),
])
def test_common_params_match_jax(args, headers):
    t = TI.CommonParams.from_request(headers, args)
    j = JI.CommonParams.from_request(headers, args)
    assert (t.tenant.account_id, t.tenant.project_id) == \
        (j.tenant.account_id, j.tenant.project_id)
    for k in ("time_field", "msg_fields", "stream_fields", "ignore_fields",
              "decolorize_fields", "default_msg_value", "debug"):
        assert getattr(t, k) == getattr(j, k), k
    assert [tuple(x) for x in t.extra_fields] == \
        [tuple(x) for x in j.extra_fields]


@pytest.mark.parametrize("v", [
    "2024-01-02T03:04:05Z", "2024-01-02T03:04:05.123456789+02:00",
    "2024-01-02", "1700000000", "1700000000123", "1700000000123456",
    "1700000000123456789", "1700000000.5", "1.7e9", "-5", "abc", "12x",
    1700000000, 1700000000.25, 1700000000123])
def test_parse_timestamp_matches_jax(v):
    assert TI.parse_timestamp(v) == JI.parse_timestamp(v)


@pytest.mark.parametrize("s", ["plain", "\x1b[31mred\x1b[0m text",
                               "a\x1b[1;32mb", "tail\x1b[", "\x1b"])
def test_decolorize_matches_jax(s):
    assert TI.decolorize(s) == JI.decolorize(s)


def test_decolorize_fields_take_the_row_path(tmp_path, now_ns):
    objs = [{"_time": now_ns + i, "_msg": f"\x1b[3{i % 8}mm {i}\x1b[0m",
             "app": f"a{i % 2}"} for i in range(100)]
    n, _ = _both(tmp_path, _lines(objs), stream_fields=["app"],
                 decolorize_fields=["_msg"])
    assert n == 100


def test_row_batches_split_at_max_batch_rows(monkeypatch):
    sent = []

    class Sink(TI.LogRowsStorage):
        def must_add_rows(self, lr):
            sent.append(len(lr))

    monkeypatch.setattr(TI, "MAX_BATCH_ROWS", 40)
    lmp = TI.LogMessageProcessor(TI.CommonParams(), Sink())
    assert not lmp.supports_columns()
    body = _lines({"_msg": f"m {i}", "_time": 1} for i in range(100))
    assert TV.handle_jsonline(TI.CommonParams(), body, lmp) == 100
    lmp.stop()
    assert sent == [40, 40, 20] and lmp.rows_total == 100


def test_log_rows_field_rules_match_jax():
    rows = [[("_msg", "m"), ("user", "u"), ("lat", "1"), ("lvl", "x"),
             ("_time", "t"), ("lvl", "dup")],
            [("app", "a"), ("k", "v")]]
    kw = dict(stream_fields=["app", "env"], ignore_fields=["user", "la*"],
              extra_fields=[("env", "prod")], default_msg_value="none")
    lr, jl = TLR.LogRows(**kw), JLR.LogRows(**kw)
    for i, r in enumerate(rows):
        lr.add(TLR.TenantID(1, 2), i, r)
        jl.add(JLR.TenantID(1, 2), i, r)
    assert lr.rows == jl.rows
    assert lr.stream_tags_str == jl.stream_tags_str
    assert [s.as_string() for s in lr.stream_ids] == \
        [s.as_string() for s in jl.stream_ids]
    lr.reset()
    assert len(lr) == 0 and not lr.rows


# ---------------- no threads, and a failed build raises ----------------

def test_handlers_start_no_threads():
    before = threading.active_count()
    body = jsonline_body(_gen_rows(500, 13))
    st, n, _ = _port_store(body, stream_fields=STREAMS)
    st2, n2, _ = _port_store(bulk_body(_gen_rows(300, 14)), "bulk")
    st3, n3, _ = _port_store(body, ignore_fields=["user"])
    st.close()
    st2.close()
    st3.close()
    assert (n, n2, n3) == (500, 300, 500)
    assert threading.active_count() == before


def test_failed_ingest_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "vl-no-such-compiler")
    monkeypatch.setattr(ingest, "_lib", None)
    body = jsonline_body(_gen_rows(400, 15))
    st = Storage(device="cpu")
    cp = TI.CommonParams(stream_fields=STREAMS)
    lmp = TI.LogMessageProcessor(cp, TI.LocalLogRowsStorage(st))
    with pytest.raises(RuntimeError, match="ingest library.*cannot be built"):
        TV.handle_jsonline(cp, body, lmp)
    lr, _jl = _row_batches(_gen_rows(400, 15))
    with pytest.raises(RuntimeError, match="cannot be built"):
        st.must_add_rows(lr)
    assert not list(tmp_path.glob("*.so"))


def test_corrupt_ingest_library_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ingest, "_lib", None)
    ingest.library_path().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load the ingest"):
        ingest.jsonline_scan(b'{"a": 1}\n')


def test_ingest_build_is_cached_by_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ingest, "_lib", None)
    assert ingest.build() > 0
    assert ingest.build() == 0.0
    assert ingest.library_path().name.startswith("libvlingest_")
    assert ingest.library_path() != native.library_path()
    assert ingest.load() is ingest.load()
