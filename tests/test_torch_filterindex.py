"""The sealed part's filter index (v2) of the port against the JAX
package: storage/filterindex, the seal in `write_part`, the part and
maplet pruning of both walks, and the split-block gate's plain
versions.

- Artifacts: on numpy-seeded hash sets the split-block filters, token
  masks and block selection, the xor filter (seed, segment length,
  fingerprints; a peel that fails every seed) and the maplets equal the
  JAX package's bit for bit.
- The file: the same blocks written by both packages' `write_part` give
  byte-equal `filterindex.bin` files beside five equal part files, for
  a flushed part and a force-merged one (whose pass-through blocks
  tokenize their values again); each package loads the other's file.
- A truncated file, a flipped byte, a wrong block count and a wrong
  version load as none, and the answers stay those of the file;
  VL_FILTER_INDEX=v1 writes no file and reads none.
- Pruning: on a durable store of three sealed parts and one unflushed
  batch, every query answers the same under v2, under v1 and as the
  JAX package's v2 store does, on the host walk and on the device path
  (`device="cpu"`) at VL_INFLIGHT/VL_PACK_PARTS 1/1 and 4/8; the
  runner's `agg_pruned_parts`, `maplet_probes` and
  `maplet_pruned_blocks` and the spans' aggregate and maplet counters
  equal the JAX package's.  With the result cache on, the (part,
  blocks) pairs the cache probes are the pruned ones, as in JAX; a
  killed part is never probed nor stored.
- The gate: `plane_keep_sb_plain` equals JAX's `probe_np_sb` and
  `plane_keep_sb`; the split-block gated scan's and pair's plain
  versions equal the ungated result ANDed with the gate, row for row;
  the planner gates `or`/NOT leaves of a sealed part by the split-block
  probe and leaves AND-path leaves ungated.

One UTC day, strictly increasing timestamps, at most ~6,800 rows a
store; every store is closed by its fixture.  The CUDA kernels' own
tests are in tests/test_torch_sbgate.py (marked `cuda`).
"""

import json
import os
import struct

import numpy as np
import pytest

from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.engine.standing import resultcache as JRC
from victorialogs_tpu.obs import tracing as JT
from victorialogs_tpu.storage import block_build as JBB
from victorialogs_tpu.storage import datadb as JDD
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import part as JP
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.storage.filterindex import maplet as JM
from victorialogs_tpu.storage.filterindex import sbbloom as JSB
from victorialogs_tpu.storage.filterindex import sidecar as JSC
from victorialogs_tpu.storage.filterindex import xorfilter as JX
from victorialogs_tpu.tpu import bloom_device as JBD
from victorialogs_tpu.tpu.batch import BatchRunner

from victorialogs_tpu_torch.cli.vlogsgenerator import generate

T0 = 1_753_660_800_000_000_000  # 2025-07-28T00:00:00Z
HOUR = 3600 * 10**9
STREAMS = ["app", "host"]
PART_FILES = ("metadata.json", "index.bin", "timestamps.bin",
              "columns.bin", "blooms.bin", "filterindex.bin")
# rows of the store's three flushed parts and its unflushed batch; the
# word `needle` lies in the third part alone
PART_ROWS = (2000, 1500, 2500)
BATCH_ROWS = 800

# torch and the port load on first use, in the worker that runs these
# tests, not in every worker that only collects this module
torch = P = None


def _load_port():
    global torch, P
    if P is not None:
        return
    import torch
    from types import SimpleNamespace
    from victorialogs_tpu_torch.engine import standing
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu import batch, bloom_device, fused
    from victorialogs_tpu_torch.gpu import kernels
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.storage import block_build, datadb
    from victorialogs_tpu_torch.storage import filterbank, log_rows, part
    from victorialogs_tpu_torch.storage import filterindex
    from victorialogs_tpu_torch.storage.filterindex import (maplet,
                                                            sbbloom,
                                                            sidecar,
                                                            xorfilter)
    from victorialogs_tpu_torch.storage.storage import Storage
    from victorialogs_tpu_torch.utils.hashing import hash_tokens
    P = SimpleNamespace(
        run=run_query_collect, standing=standing, batch=batch,
        BD=bloom_device, fused=fused, K=kernels, tracing=tracing,
        BB=block_build, DD=datadb, FB=filterbank, LR=log_rows, PT=part,
        FI=filterindex, M=maplet, SB=sbbloom, SC=sidecar, X=xorfilter,
        Storage=Storage, hash=hash_tokens, T=[log_rows.TenantID(0, 0)],
        Runner=lambda: batch.TorchBatchRunner(device="cpu"))


@pytest.fixture(autouse=True)
def _port(monkeypatch):
    """Import the port, cap torch's intra-op pool beside the other
    workers, and pin the suite to v2 with the result cache off."""
    _load_port()
    monkeypatch.delenv("VL_FILTER_INDEX", raising=False)
    monkeypatch.setenv("VL_RESULT_CACHE", "0")
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rows(n, seed, start, needle=False):
    """Generator rows of 16 streams; every 7th row of apps 0 and 1
    starts with a request path (the regexp pairs' bloom tokens `api`
    and `v1`)."""
    rows = generate(n, seed, start, 4 * HOUR, streams=16)
    for i in range(3, n, 7):
        ts, fields = rows[i]
        if fields[1][1] in ("app-0", "app-1"):
            rows[i] = (ts, [("_msg", f"GET /api/v1/users/{i} "
                             + fields[0][1])] + fields[1:])
    if needle:
        # every 97th row of the part mentions `needle`
        for i in range(0, n, 97):
            ts, fields = rows[i]
            rows[i] = (ts, [("_msg", "needle " + fields[0][1])] +
                       fields[1:])
    return rows


def _log_rows(mod, rows):
    lr = mod.LogRows(stream_fields=STREAMS)
    for ts, fields in rows:
        lr.add(mod.TenantID(0, 0), ts, fields)
    return lr


def _part_rows():
    return [_rows(n, 60 + k, T0 + k * 4 * HOUR, needle=k == 2)
            for k, n in enumerate(PART_ROWS)]


def _batch_rows():
    return _rows(BATCH_ROWS, 70, T0 + 13 * HOUR)


def _sorted(rows):
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


# ---------------- artifacts ----------------

def _hash_sets(seed: int):
    """Seeded distinct-hash sets: empty, one, a few, many."""
    rng = np.random.default_rng(seed)
    return [np.zeros(0, np.uint64), rng.integers(0, 1 << 63, 1,
                                                 dtype=np.uint64)] + [
        np.unique(rng.integers(0, 1 << 63, n, dtype=np.uint64))
        for n in (7, 300, 5000)]


@pytest.mark.parametrize("seed", [1, 2])
def test_sb_artifacts_equal_jax(seed):
    for h in _hash_sets(seed):
        assert np.array_equal(P.SB.sb_build(h), JSB.sb_build(h))
        assert np.array_equal(P.SB.sb_token_masks(h), JSB.sb_token_masks(h))
        for m in (1, 3, 257):
            assert np.array_equal(P.SB.sb_block_select(h, m),
                                  JSB.sb_block_select(h, m))
        assert P.SB.sb_num_blocks(len(h)) == JSB.sb_num_blocks(len(h))
        lanes = P.SB.sb_build(h)
        for q in (h[:3], _hash_sets(seed + 10)[3][:4]):
            assert P.SB.sb_contains_all(lanes, q) == \
                JSB.sb_contains_all(lanes, q)


@pytest.mark.parametrize("seed", [3, 4])
def test_xor_filters_equal_jax(seed):
    for h in _hash_sets(seed):
        got, want = P.X.xor_build(h), JX.xor_build(h)
        assert (got.seed, got.seglen) == (want.seed, want.seglen)
        assert np.array_equal(got.fingerprints, want.fingerprints)
        assert got.contains(h).all()
        probe = _hash_sets(seed + 20)[4]
        assert np.array_equal(got.contains(probe), want.contains(probe))


def test_xor_peel_failure_equals_jax(monkeypatch):
    """Slots squeezed into two per segment make every seed's peel fail:
    both packages try the same seeds and give up with None."""
    tried = {"port": [], "jax": []}
    for key, mod in (("port", P.X), ("jax", JX)):
        real = mod._slots_and_fp

        def squeezed(hashes, seed, seglen, real=real, key=key):
            tried[key].append(seed)
            h0, h1, h2, fp = real(hashes, seed, seglen)
            return h0 % 2, seglen + h1 % 2, 2 * seglen + h2 % 2, fp
        monkeypatch.setattr(mod, "_slots_and_fp", squeezed)
    h = _hash_sets(5)[3]
    assert P.X.xor_build(h) is None and JX.xor_build(h) is None
    assert tried["port"] == tried["jax"]
    assert len(tried["port"]) == P.X._MAX_TRIES == JX._MAX_TRIES


@pytest.mark.parametrize("seed", [6, 7])
def test_maplets_equal_jax(seed):
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(0, 1 << 63, 400, dtype=np.uint64))
    nblocks = 37
    per_block = []
    for bi in range(nblocks):
        if rng.random() < 0.15:
            continue                      # an uncovered block
        n = int(rng.integers(0, 60))
        per_block.append((bi, rng.choice(universe, n, replace=False)))
    got, want = P.M.maplet_build(per_block, nblocks), \
        JM.maplet_build(per_block, nblocks)
    for f in ("uhashes", "offsets", "blocks", "covered"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.all_covered() == want.all_covered()
    bis = list(range(0, nblocks, 3))
    for t in (0, 1, 2, 3):
        q = rng.choice(universe, t, replace=False)
        if t == 3:
            q[-1] = np.uint64(12345)      # in no block
        assert np.array_equal(got.keep_mask(q), want.keep_mask(q))
        assert np.array_equal(got.keep_mask(q, bis), want.keep_mask(q, bis))


# ---------------- the file ----------------

def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in PART_FILES}


def _assert_cols_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        assert np.array_equal(x.nsb, y.nsb) and \
            np.array_equal(x.lanes, y.lanes)
        for f in ("uhashes", "offsets", "blocks", "covered"):
            assert np.array_equal(getattr(x.maplet, f),
                                  getattr(y.maplet, f))
        assert (x.xor is None) == (y.xor is None)
        if x.xor is not None:
            assert (x.xor.seed, x.xor.seglen) == (y.xor.seed, y.xor.seglen)
            assert np.array_equal(x.xor.fingerprints, y.xor.fingerprints)


def test_flushed_part_sidecar_bytes_equal_jax(tmp_path):
    rows = _part_rows()[2]
    tb = P.BB.build_log_rows_blocks(_log_rows(P.LR, rows))
    jb = JBB.build_log_rows_blocks(_log_rows(JLR, rows))
    meta = P.PT.write_part(str(tmp_path / "t"), tb)
    JP.write_part(str(tmp_path / "j"), jb)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    for name in PART_FILES:
        assert got[name] == want[name], name
    fi = meta["filter_index"]
    assert fi["file_bytes"] == len(got["filterindex.bin"]) and \
        fi["cols"] >= 4 and fi["hash_recompute_s"] == 0
    # each package loads the other's file
    nb = meta["blocks"]
    _assert_cols_equal(P.SC.load_sidecar(str(tmp_path / "j"), nb)[0],
                       JSC.load_sidecar(str(tmp_path / "t"), nb)[0])


@pytest.mark.parametrize("passthrough", [False, True])
def test_merged_part_sidecar_bytes_equal_jax(tmp_path, passthrough,
                                             monkeypatch):
    """Three flushed parts force-merged in each package: the merged
    parts' six files are equal.  The merge re-encodes a stream's small
    blocks together (fresh token hashes); with every block passed
    through as it was read (COALESCE_MIN_ROWS 1) it tokenizes the read
    values again."""
    if passthrough:
        from victorialogs_tpu_torch.storage import merge as PM
        monkeypatch.setattr(PM, "COALESCE_MIN_ROWS", 1)
        monkeypatch.setattr(JDD, "COALESCE_MIN_ROWS", 1)
    tddb = P.DD.DataDB(str(tmp_path / "t"), flush_interval=3600)
    jddb = JDD.DataDB(str(tmp_path / "j"), flush_interval=3600)
    try:
        for rows in _part_rows():
            tddb.must_add_blocks(P.BB.build_log_rows_blocks(
                _log_rows(P.LR, rows)))
            tddb.flush_inmemory_parts()
            jddb.must_add_blocks(JBB.build_log_rows_blocks(
                _log_rows(JLR, rows)))
            jddb.flush_inmemory_parts()
        tddb.force_merge()
        jddb.force_merge()
        (tp,), (jp,) = tddb.big_parts, jddb.big_parts
        got, want = _files(tp.path), _files(jp.path)
        for name in PART_FILES:
            assert got[name] == want[name], name
        seals = tddb.seals
        assert [s["merge"] for s in seals] == [False] * 3 + [True]
        assert (seals[-1]["filter_index"]["hash_recompute_s"] > 0) == \
            passthrough
        assert P.FI.part_index(tp) is not None
    finally:
        jddb.close()
        tddb.close()


def _one_part_dir(tmp_path, name="p"):
    rows = _part_rows()[2]
    path = str(tmp_path / name)
    P.PT.write_part(path, P.BB.build_log_rows_blocks(_log_rows(P.LR, rows)))
    return path


def _mutants(blob: bytes, nblocks: int):
    """(label, bytes) of a truncated file, a flipped header and payload
    byte, a wrong block count and a wrong version."""
    magic = len(JSC.MAGIC)
    flip_hdr = bytearray(blob)
    flip_hdr[magic + 16 + 3] ^= 0x41
    flip_payload = bytearray(blob)
    flip_payload[-5] ^= 0xFF
    return [
        ("truncated", blob[:len(blob) // 2]),
        ("truncated-header", blob[:magic + 10]),
        ("flipped-header", bytes(flip_hdr)),
        ("flipped-payload", bytes(flip_payload)),
        ("block-count", blob[:magic + 4] + struct.pack("<I", nblocks + 1)
         + blob[magic + 8:]),
        ("version", blob[:magic] + struct.pack("<I", 3) + blob[magic + 4:]),
    ]


@pytest.mark.parametrize("case", ["truncated", "truncated-header",
                                  "flipped-header", "flipped-payload",
                                  "block-count", "version"])
def test_corrupt_sidecar_loads_as_none(tmp_path, case):
    """Each package refuses the mutant, and the port's answers over the
    part equal those it gave with the file."""
    path = _one_part_dir(tmp_path)
    part = P.PT.FilePart(path)
    try:
        fi = P.FI.part_index(part)
        assert fi is not None
        qs = ["needle", "quota", "needle or quota",
              "error !quota | stats count() c"]
        want = {q: _walk(part, q) for q in qs}
        sc = os.path.join(path, P.SC.FILTERINDEX_FILENAME)
        blob = open(sc, "rb").read()
        mutant = dict(_mutants(blob, part.num_blocks))[case]
        open(sc, "wb").write(mutant)
        part2 = P.PT.FilePart(path)
        try:
            assert P.FI.part_index(part2) is None
            with pytest.raises(JSC.SidecarInvalid):
                JSC.load_sidecar(path, part2.num_blocks)
            for q in qs:
                assert _walk(part2, q) == want[q], q
        finally:
            part2.close()
    finally:
        part.close()


def _walk(part, q):
    """A query over one part through a throwaway store view: the host
    walk and the device path (cpu) must agree; the rows."""
    store = _OnePart(part)
    host = P.run(store, P.T, q)
    runner = P.Runner()
    try:
        assert P.run(store, P.T, q, runner=runner) == host
    finally:
        runner.close()
    return host


class _OnePartition:
    def __init__(self, part):
        self.part = part
        self.day = part.min_ts // (86400 * 10**9)

    def snapshot_parts(self):
        return [self.part]

    def search_stream_ids(self, tenants, sf):
        return set()

    def has_stream_id(self, sid):
        return True


class _OnePart:
    """The least of a Storage a query reads: one partition of one
    part."""

    def __init__(self, part):
        self.pt = _OnePartition(part)

    def select_partitions(self, min_ts, max_ts):
        return [self.pt]


def test_v1_writes_and_reads_no_sidecar(tmp_path, monkeypatch):
    path = _one_part_dir(tmp_path, "v2")
    monkeypatch.setenv("VL_FILTER_INDEX", "v1")
    part = P.PT.FilePart(path)
    try:
        assert P.FI.part_index(part) is None
        assert P.FB.maplet_prune_candidates(
            part, [("_msg", ["needle"], _Leaf())], [0, 1]) == [0, 1]
    finally:
        part.close()
    rows = _part_rows()[0]
    meta = P.PT.write_part(str(tmp_path / "v1"), P.BB.build_log_rows_blocks(
        _log_rows(P.LR, rows)))
    assert "filter_index" not in meta
    assert not os.path.exists(tmp_path / "v1" / P.SC.FILTERINDEX_FILENAME)


class _Leaf:
    """An owner for cached_token_hashes."""


# ---------------- pruning: the store ----------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Three flushed parts and one unflushed batch of generator rows in
    one UTC day, in a durable store of each package (`quota` only in
    apps 0 and 1, `needle` only in the third part)."""
    _load_port()
    base = tmp_path_factory.mktemp("fistore")
    saved = os.environ.pop("VL_FILTER_INDEX", None)
    port = P.Storage(str(base / "p"), retention_days=100000,
                     flush_interval=3600, device="cpu")
    jax_st = JS.Storage(str(base / "j"), retention_days=100000,
                        flush_interval=3600)
    try:
        for rows in _part_rows():
            port.must_add_rows(_log_rows(P.LR, rows))
            port.debug_flush()
            jax_st.must_add_rows(_log_rows(JLR, rows))
            jax_st.debug_flush()
        port.must_add_rows(_log_rows(P.LR, _batch_rows()))
        jax_st.must_add_rows(_log_rows(JLR, _batch_rows()))
        yield port, jax_st
    finally:
        if saved is not None:
            os.environ["VL_FILTER_INDEX"] = saved
        jax_st.close()
        port.close()


QUERIES = [
    "quota",                                    # AND: maplet pruning
    "needle",                                   # part kills
    "quota timeout | fields _time, app",
    "quota or needle",                          # or: no AND-path leaf
    "error !quota | stats count() c",           # NOT
    '"GET request"',                            # phrase
    "resp* | stats count() c",                  # prefix
    '~"quota.*GET"',                            # regexp
    '_stream:{app="app-1"} quota',              # stream and word
    "quota | stats by (app) count() c",         # stats
    "needle | stats by (lvl) count() c, sum(dur) s",
    "error | sort by (dur) desc limit 5",       # sort ... limit
    "nomatchtoken",                             # every part killed
    '~"/api/v1/users.*timeout"',                # a pair
    '~"/api/v1/users.*timeout" or ~"/api/v1/users.*GET"',  # pairs under or
]
COUNTERS = ("agg_pruned_parts", "maplet_probes", "maplet_pruned_blocks")
SPAN_KEYS = ("parts_pruned_aggregate", "blocks_probed_maplet",
             "blocks_killed_maplet", "blocks_candidate")


def _sum(tree: dict, key: str) -> int:
    n = tree.get("attrs", {}).get(key, 0)
    return n + sum(_sum(c, key) for c in tree.get("children", ()))


def _artifacts(tree: dict, out: set) -> set:
    v = tree.get("attrs", {}).get("last_aggregate_prune_artifact")
    if v is not None:
        out.add(v)
    for c in tree.get("children", ()):
        _artifacts(c, out)
    return out


def _port_traced(st, q, runner):
    root = P.tracing.make_root("query", query=q)
    with P.tracing.activate(root):
        rows = P.run(st, P.T, q, runner=runner)
    return rows, root.to_dict()


def _jax_traced(st, q, runner):
    root = JT.make_root("query", query=q)
    with JT.activate(root):
        rows = jax_run(st, [JLR.TenantID(0, 0)], q, runner=runner)
    return rows, root.to_dict()


def test_store_parts_carry_sidecars(stores):
    port, jax_st = stores
    (ppt,), (jpt,) = port.partitions.values(), jax_st.partitions.values()
    files = [p for p in ppt.snapshot_parts() if p.path is not None]
    jfiles = [p for p in jpt.ddb.snapshot_parts()
              if getattr(p, "path", None) is not None]
    assert len(files) == len(jfiles) == len(PART_ROWS)
    for p, j in zip(files, jfiles):
        assert _files(p.path) == _files(j.path)
        assert P.FI.part_index(p) is not None
    mem = [p for p in ppt.snapshot_parts() if p.path is None]
    assert len(mem) == 1 and P.FI.part_index(mem[0]) is None


@pytest.mark.parametrize("q", QUERIES)
def test_host_walk_prunes_as_jax(stores, q, monkeypatch):
    port, jax_st = stores
    rows, tree = _port_traced(port, q, None)
    jrows, jtree = _jax_traced(jax_st, "options(concurrency=1) " + q, None)
    assert _sorted(rows) == _sorted(jrows)
    got = {k: _sum(tree, k) for k in SPAN_KEYS}
    assert got == {k: _sum(jtree, k) for k in SPAN_KEYS}
    assert _artifacts(tree, set()) == _artifacts(jtree, set())
    monkeypatch.setenv("VL_FILTER_INDEX", "v1")
    v1, v1tree = _port_traced(port, q, None)
    assert v1 == rows
    assert _sum(v1tree, "blocks_probed_maplet") == 0


@pytest.mark.parametrize("inflight,pack", [("1", "1"), ("4", "8")])
@pytest.mark.parametrize("q", QUERIES)
def test_device_path_prunes_as_jax(stores, q, inflight, pack, monkeypatch):
    port, jax_st = stores
    monkeypatch.setenv("VL_INFLIGHT", inflight)
    monkeypatch.setenv("VL_PACK_PARTS", pack)
    runner, jr = P.Runner(), BatchRunner()
    try:
        rows, tree = _port_traced(port, q, runner)
        jrows, jtree = _jax_traced(jax_st, q, jr)
        jstats = jr.stats()
    finally:
        jr.close()
    try:
        assert _sorted(rows) == _sorted(jrows)
        assert rows == P.run(port, P.T, q)
        got = {k: runner.stats_counters[k] for k in COUNTERS}
        assert got == {k: jstats[k] for k in COUNTERS}
        keys = SPAN_KEYS[:3]
        assert {k: _sum(tree, k) for k in keys} == \
            {k: _sum(jtree, k) for k in keys}
        assert runner.stats_counters["host_parts"] == 0
        monkeypatch.setenv("VL_FILTER_INDEX", "v1")
        v1 = P.Runner()
        try:
            assert P.run(port, P.T, q, runner=v1) == rows
            assert not any(v1.stats_counters[k] for k in
                           ("maplet_probes", "maplet_pruned_blocks"))
        finally:
            v1.close()
    finally:
        runner.close()


def test_pruning_moves_where_expected(stores, monkeypatch):
    """The counters the parity tests compare do move: `needle` kills the
    two sealed parts without it by their xor aggregates and the batch
    by its bloom folds; `quota` drops the blocks of apps 2-7."""
    port, _j = stores
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    runner = P.Runner()
    try:
        rows, tree = _port_traced(port, "needle", runner)
        assert rows and runner.stats_counters["agg_pruned_parts"] == 3
        assert _artifacts(tree, set()) >= {"xor_aggregate"}
        staged = {u for u in runner.cache.part_uids()}
        (pt,) = port.partitions.values()
        with_needle = [p for p in pt.snapshot_parts()
                       if p.path is not None][2]
        assert staged == {with_needle.uid}
        P.run(port, P.T, "quota", runner=runner)
        assert runner.stats_counters["maplet_pruned_blocks"] > 0
    finally:
        runner.close()


# ---------------- pruning before the result cache ----------------

def _probes(monkeypatch, cls, log):
    real = cls.probe

    def probe(self, part, bis):
        log.append((part.num_rows, part.min_ts, tuple(bis)))
        return real(self, part, bis)
    monkeypatch.setattr(cls, "probe", probe)


@pytest.mark.parametrize("q", ["needle", "quota | stats by (app) count() c",
                               "quota timeout | fields _time, app"])
def test_pruning_runs_before_the_result_cache(stores, q, monkeypatch):
    """With the cache on: the cold run probes the pruned (part, blocks)
    pairs that JAX probes; a killed part is never probed nor stored;
    the warm run replays exactly the parts the cold run kept."""
    from victorialogs_tpu_torch.engine.standing import resultcache as PRC
    port, jax_st = stores
    monkeypatch.setenv("VL_RESULT_CACHE", "1")
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    P.standing.reset_for_tests()
    JRC.reset_for_tests()
    got, want = [], []
    _probes(monkeypatch, PRC.QueryCache, got)
    _probes(monkeypatch, JRC.QueryCache, want)
    runner, jr = P.Runner(), BatchRunner()
    try:
        cold = P.run(port, P.T, q, runner=runner)
        jax_run(jax_st, [JLR.TenantID(0, 0)], q, runner=jr)
        assert sorted(got) == sorted(want) and got
        kept = len(got)
        assert P.standing.cache_stats()["entries"] == kept
        killed = runner.stats_counters["agg_pruned_parts"]
        assert kept + killed == len(PART_ROWS) + 1
        units = runner.stats_counters["units"]
        warm = P.run(port, P.T, q, runner=runner)
        assert warm == cold
        assert runner.stats_counters["result_cache_units"] == kept
        assert runner.stats_counters["units"] == units
        assert got[kept:] == got[:kept]
    finally:
        jr.close()
        runner.close()
        P.standing.reset_for_tests()
        JRC.reset_for_tests()


# ---------------- the gate ----------------

def _sb_inputs(part, field, tokens):
    """A sealed part's split-block plane for `field` and its probe of
    `tokens`, padded as the runner stages them (numpy)."""
    fi = P.FI.part_index(part)
    h = P.hash(tokens)
    plane, nsb = fi.sb_plane(field)
    plane, nsb = P.BD.pad_sb_plane(plane, nsb)
    sbidx = P.BD.pad_sb_idx(fi.sb_probe_idx(field, h), plane.shape[0])
    return plane, sbidx, fi.sb_masks(h), nsb


@pytest.mark.parametrize("tokens", [["quota"], ["needle"], ["GET", "quota"],
                                    ["error", "timeout", "free", "login",
                                     "retry"]])
def test_plain_sb_probe_equals_jax(tmp_path, tokens):
    path = _one_part_dir(tmp_path)
    part = P.PT.FilePart(path)
    try:
        plane, sbidx, mask, nsb = _sb_inputs(part, "_msg", tokens)
        want = JBD.probe_np_sb(plane, sbidx, mask, nsb)
        jnp_keep = np.asarray(JBD.plane_keep_sb(plane, sbidx, mask, nsb))
        got = P.BD.plane_keep_sb(
            *(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                               else a) for a in (plane, sbidx, mask, nsb)))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(jnp_keep, want)
        assert np.array_equal(P.BD.probe_np_sb(plane, sbidx, mask, nsb),
                              want)
        # the sidecar's maplet is exact, the split-block probe keeps a
        # superset of its blocks
        fi = P.FI.part_index(part)
        exact = fi.keep_mask("_msg", P.hash(tokens))
        assert not (exact & ~want[:part.num_blocks]).any()
    finally:
        part.close()


def test_sb_gated_plain_versions_are_gated_ungated(tmp_path):
    """The split-block gated scan's and pair's plain versions equal the
    ungated result ANDed with the gate (JAX's plane_keep_sb gathered to
    rows through the block ids), row for row."""
    path = _one_part_dir(tmp_path)
    part = P.PT.FilePart(path)
    runner = P.Runner()
    try:
        layout = runner.layout(part)
        ff = runner.stage_fused_field(part, "_msg", layout)
        plane, sbidx, mask, nsb = _sb_inputs(part, "_msg", ["needle"])
        starts = P.BD.block_starts(part, layout)
        gate = P.BD.SbGate(*(torch.from_numpy(a) for a in (
            plane.view(np.int32), nsb, sbidx, mask.view(np.int32), starts)))
        keep = np.asarray(JBD.plane_keep_sb(plane, sbidx, mask, nsb))
        r = ff.lanes.shape[1]
        bid = np.searchsorted(starts, np.arange(r), side="right") - 1
        rows = torch.from_numpy(keep[np.clip(bid, 0, part.num_blocks - 1)]
                                & (bid >= 0) & (bid < part.num_blocks))
        assert 0 < int(rows.sum()) < r
        ovf = torch.from_numpy(np.arange(r) % 11 == 0)
        for pat, mode in ((b"needle", P.K.MODE_PHRASE),
                          (b"quo", P.K.MODE_PREFIX),
                          (b"eed", P.K.MODE_SUBSTRING)):
            for ov in (None, ovf):
                d, m = P.K.match_scan_gated_sb(ff.lanes, ff.lengths, pat,
                                               mode, True, True, False,
                                               gate, ov)
                hit = P.K.match_scan_plain(ff.lanes, ff.lengths, pat, mode,
                                           True, True, False)
                if ov is None:
                    assert m is None and torch.equal(d, hit & rows)
                else:
                    assert torch.equal(d, hit & ~ov & rows)
                    assert torch.equal(m, ov & rows)
        for ov in (None, ovf):
            d, m = P.K.match_pair_gated_sb(ff.lanes, ff.lengths, b"needle",
                                           b"GET", gate, ov)
            pd, pm = P.K.match_pair_plain(ff.lanes, ff.lengths, b"needle",
                                          b"GET", ov)
            assert torch.equal(d, pd & rows) and torch.equal(m, pm & rows)
    finally:
        runner.close()
        part.close()


@pytest.mark.parametrize("q,sb,classic", [
    ("error !quota", 1, 0),
    ('quota or _stream:{app="app-7"}', 1, 0),
    ('~"/api/v1/users.*timeout" or ~"/api/v1/users.*GET"', 2, 0),
    ("quota", 0, 0),             # the walk's maplet leaves nothing to gate
    ('~"/api/v1/users.*timeout"', 0, 0),
])
def test_planner_gates_by_split_blocks(stores, q, sb, classic, monkeypatch):
    """On each sealed part an `or`/NOT leaf that keeps some blocks runs
    behind the split-block gate, an AND-path leaf runs ungated; the
    unflushed batch (no filter index) keeps the classic gate."""
    port, jax_st = stores
    monkeypatch.setenv("VL_PACK_PARTS", "1")
    calls = {"sb": 0, "classic": 0}
    for name, key in (("match_scan_gated_sb", "sb"),
                      ("match_pair_gated_sb", "sb"),
                      ("match_scan_gated", "classic"),
                      ("match_pair_gated", "classic")):
        real = getattr(P.K, name)

        def spy(*a, real=real, key=key, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(P.K, name, spy)
    runner = P.Runner()
    try:
        rows = P.run(port, P.T, q, runner=runner)
        assert _sorted(rows) == _sorted(jax_run(
            jax_st, [JLR.TenantID(0, 0)], "options(concurrency=1) " + q))
        sealed = len(PART_ROWS)
        assert calls["sb"] == sb * sealed
        assert calls["classic"] >= classic
        if sb:
            staged = runner.cache.bytes_by_kind()
            assert staged.get("sb", 0) > 0
    finally:
        runner.close()
