#!/usr/bin/env python3
"""Smoke test of victorialogs_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--skip-main]

Phases, each fatal on failure:
1. build: compile the CUDA kernels of csrc/ with nvcc (in parallel) and
   print ptxas's registers, spills and shared memory per kernel; build
   the NDJSON serializer (native/emit.cpp) and the ingest library
   (native/ingest.cpp) with g++ and print their times.
2. kernels: hold each kernel against its plain PyTorch version on the
   card, bit for bit, at edge shapes (ragged row counts; widths 32, 128
   and 256; every mode x fold x word-boundary combination; 1 and 8
   segments with 1, 7, 1000 and 8192 buckets; 1 and 128 probes, blocks
   without a bloom), then at the edges of the scan's and the count's
   designs (`scan_edge_cases`, `count_edge_cases`), and the bloom-gated
   scan at the edges of its gate (`gate_edge_cases`: blocks of 0-33 and
   15,625 rows, warps across block boundaries, all or no blocks kept,
   blocks without a bloom, 6-192 probes, lane indices outside the plane,
   more block starts than it keeps in shared memory) and on every scan
   edge case behind a gate, every mode x fold x word boundary, with and
   without a maybe column; the value reduction at 1-11,623 cells
   (`VALUE_CELLS`, both sides of its register path and of its shared
   tables) x 1, 2 and 9 value columns (one more than a launch takes) on
   1 and 100,003 rows, and at its edges (`value_edge_cases`, at each of
   its three paths: no row masked in, every row in one cell, 80% of the
   rows in one cell, values 0 and 0xFFFFFFFF, one row, unaligned views,
   nine columns); the ordered pair (`A.*B`) at its edges
   (`pair_edge_cases`: A and B of 1-64 bytes with la + lb on both sides
   of each boundary of its state words, A == B, overlapping patterns, B
   only before A, several occurrences, rows shorter than both, of 0
   bytes and at the staged width, newlines at the first and last byte
   and inside A, widths 32-256, ragged row counts, bytes >= 0x80), with
   and without an ovf column, and the gated pair behind every gate edge
   case and behind a gate on every pair edge case (`pair_gated_runs`),
   both outputs, the counts of definite, maybe and gated-out rows
   printed; and the fold scan of an `i()` leaf with and without its
   multibyte mask (`check_fold`); the split-block probe alone
   (`plane_keep_sb`) against its plain version and the host probe at
   1-3,001 blocks x 1, 4 and 8 tokens and at the split-block gate's
   edges (`sb_gate_edge_cases`: blocks of 0-33 and 15,625 rows, nsb 0,
   1, 4, 5 and 8 tokens, lane bases outside the plane, more block
   starts than the gated kernels keep in shared memory), and the scan
   and the pair behind every such gate (`check_gated_sb`).
3. main path: ingest 2M generated rows as a user sends them, through
   /insert/jsonline (`handle_jsonline`, the generator's JSON-lines
   bodies, made in spawned processes while phases 1 and 2 run) into a durable Storage in a temporary directory (removed at
   exit, also on failure) with 2 flushes, which must give 2 parts of 1M
   rows in 64 blocks each on disk with no chunk of the bodies parsed in
   Python (`INGEST_COUNTERS["py_chunks"]` 0), a line a flush with its
   write seconds and its compressed and uncompressed bytes; take
   DURABLE_QUERIES' answers and the `error` rows' digest, close the
   store and reopen it from its directory (`durable_reopen`): `count()`
   must equal the rows the handler acknowledged and every answer must
   be the same, and the cold first query (a fresh runner: files read,
   decompressed, staged) is timed beside the next, traced: its staged
   entries and bytes, bloom probes and kills and span totals are
   printed (`cold_counters`); every query below
   runs over the reopened store; ingest ROUTE_ROWS generator rows
   by rows, by /insert/jsonline and by Elasticsearch _bulk
   (`handle_elasticsearch_bulk`) into one flush each, whose three parts
   must be equal; one line a route gives rows/s, us a row, the body's
   bytes, the handler's and the flush's seconds and the counters.  Then
   run the query list through
   run_query_collect(..., runner=TorchBatchRunner(device="cuda")) and
   require each result to equal the host executor's.  Every query must
   run each of its parts on the card (none on the host), launch each of
   its kernels the listed number of times per part (`queries`: e.g. the
   value query `num_bucket` the scan once and the value reduction once,
   for both of its value columns; the pair query `regex_pair` the pair
   kernel once; `regex_verify` the scan once for its literal run
   "quota ", its candidate rows settled by re.search on the host)
   and launch no other kernel (the bloom query `quota`: one scan, no
   gate and no standalone probe: its parts are sealed, and the walk's
   maplet already dropped the blocks without `quota`).  Every kernel's
   launch counter is zeroed right before this phase, and each kernel of
   the main path (scan, count, value reduction, pair) must move; the
   planner launches no standalone probe.  `anycase` (`i(ERROR)`) and
   `anycase_prefix` (`i(RESP*)`) must return the host executor's rows of
   `phrase` and `prefix`, run just before them (ANYCASE_TWINS; no host
   run of their own).  The runner's staged bytes are logged.  Each
   row query (`phrase`, `prefix`, `substring`, `bloom`, `regex_pair`,
   `regex_verify`, `anycase`, `anycase_prefix`) also answers as a user
   pulls it: its full NDJSON export (`run_query` with
   an `ndjson_block` sink, no limit), whose bytes must equal the host
   executor's rows serialized by json.dumps, and /select/logsql/query
   (`handle_query`) at its default limit of 1000, whose chunks must
   equal the same handler's with no runner (the host executor), which
   must run only the parts the dispatch window submits before its first
   harvest (VL_INFLIGHT of them at most: the walk stops) and which, given
   no runner at all, must answer the same through the storage's own
   runner on the card (as must each stats query's handler); `phrase`
   also answers with `| fields _time, lvl, dur | limit 5 | offset 2`.  Each stats query
   answers /select/logsql/stats_query (`handle_stats_query` at a fixed
   `time`), equal to the handler with no runner and with the query's
   launches a part.  No result block may take the per-row emit
   (`EMIT_COUNTERS["py_blocks"]` stays 0).  Then the gated pair's path:
   a second store of PATH_ROWS rows in one flush whose `_msg` holds
   request paths in the streams of apps 0 and 1 only (`path_rows`), on
   which `~"/api/v1/users.*timeout"` and its `stats by (app) count()`
   (`path_queries`) equal the host executor with every part on the
   card, one gated pair launch a part (its counts zeroed right before
   this path) and maybe rows (newlines, truncated values) settled on
   the host.  Then the filters' path on the main store, its counts
   zeroed right before it (`filter_queries`): `status:>=500` and
   `dur:range[1000, 2000)` (a `numrange` node, unsigned compares of the
   staged offsets), `lvl:in(error, warn)` (two exact scans),
   `user:len_range(6, 8)` (`lenrange`), `_stream_id:` of one stream of
   the store (candidate blocks pruned to the stream; ORed with a range,
   a mixed-truth `maskleaf`), and two trees the planner declines,
   `error lat:>99.9` and `error user:string_range(...) | stats by (app)
   count()`, which walk leaf by leaf: the scan on the card, the float
   range and the string range on the host (`cpu_fallbacks` must move on
   them and only them), the stats of the matched rows reduced on the
   card.  Each equals the host executor with every part on the card and
   its listed launches a part, and answers like the main queries; then
   `handle_query` on `error` with `extra_filters` {"app": ["app-1",
   "app-2"]} equals the same handler with no runner (three scans, one
   device part).  The scan and the count must move on this path.  Then
   the slice path of the pipes on the main store, its counts zeroed
   right before it (`slice_queries`): `error | sort by (dur) desc limit
   10`, `error | first 5 by (dur)` and `quota | last 3 by (dur)` (the
   top-k prefilter: `topk_parts` equal to the device parts, no decline,
   one scan a part: the store's parts are sealed, so the walk's maplet
   leaves `quota` only its blocks and nothing to gate; the rows the
   card returned are
   printed against the filter's matches, and the device operations of a
   warm run with the most device time; their /select/logsql/query
   answers are held against the host executor's rows serialized, not
   against a second host sort), `quota | uniq by (app, lvl) with hits`,
   `quota | where dur:>1000 | stats by (app) count()` (`stats` after
   another pipe: the filter on the card, the stats on the host) and
   `quota | copy app as app2 | rename lvl as level | delete user | limit
   1000`, each driven like the main queries; then /select/logsql/hits
   (`handle_hits`, `error` by `_time:1h` and `app`) and
   /select/logsql/stats_query_range (`error | stats by (app) count()`,
   step 1h), each equal to the same handler with no runner and through
   the default runner, one scan and one count launch a part.  The scan
   and the count must move on this path.  Then the filter index path
   (`filter_index_path`, its counts zeroed before each query): each
   part directory of the main store holds a filterindex.bin the
   port's loader accepts (its bytes and each flush's seal seconds
   printed); a sealed copy of the gated pair's store (PATH_ROWS rows
   of `path_rows`, one flush into a temporary directory) too; then
   `filter_index_queries`, each equal to the host executor and to its
   VL_FILTER_INDEX=v1 answer with every part on the card and its
   listed launches a part: on the main store `quota | stats by (app)
   count()` (the maplet drops the blocks without `quota`:
   `maplet_pruned_blocks` moves, one plain scan), `error !quota |
   stats count()` and `(quota or _stream:{app="app-7"}) | stats by
   (app) count()` (the split-block gated scan under NOT and `or`); on
   the path store the pair `~"/api/v1/users.*timeout"` as an AND leaf
   (pruned, one plain pair) and two pairs under `or` (two split-block
   gated pairs a part).  The split-block gated scan and pair must move
   on this path.  Then the
   transform path on the routes' jsonline store (ROUTE_ROWS rows), its
   counts zeroed right before it (`transform_queries`): an `extract`
   feeding `stats by`, `unpack_json`, `math`, `format`, `top`,
   `facets`, `stats` with `if`, a `_time:month` bucket and `histogram`,
   `values` and `row_max`, `collapse_nums`, `join`, `union` and
   `stream_context`, each through the store's default runner
   (`vlselect.card_runner`): a cold run, whose listed launches a part
   are checked (join, union and stream_context run queries of their
   own: every part of theirs on the card), one warm answer equal to the
   host executor's, and five profiled warm runs in one window for the
   device-busy time a run; then
   `* | stats count()` on a store whose one batch of UNFLUSHED_ROWS was
   never flushed, which must count every row added.  The scan, the
   gated scan and the count must move on this path.  Then the packed
   path, its counts zeroed right before it (`packed_path`): a store of
   PACK_DAYS UTC days, each of PACK_FLUSHED flushed parts and up to 8
   batches never flushed, every one PACK_PART_ROWS generator rows sent
   as a /insert/jsonline body, and on it `packed_queries` (the bloom row
   query, time-bucket, value, sort, count and quantile stats over
   `_time:4d`) through the store's default runner at VL_INFLIGHT/
   VL_PACK_PARTS 1/1 (the serial walk) and 4/8: every answer equal to
   the host executor's with every part on the card, and at 4/8 to the
   1/1 answer row for row (the row query's NDJSON export byte for
   byte); at each setting its units, packed units, launches (each
   kernel its listed times a unit, the units those of
   gpu/pipeline.iter_pack_groups: P small parts of one pad bucket cost
   ceil(P/8)), warm p50, device-busy time and one traced run's span
   totals (submit, device_sync, emit, ...).  The scan, the gated scan,
   the count and the value reduction must move on this path; the count
   at 8 segments x 2,440 cells and the value reduction over the
   members' folded cells are held against their plain versions on one
   pack and timed beside their bounds (`at_pack` of their kernel rows).
4. report: per-query time of the cold run (no rows built), p50 over
   warm runs without the result rows built, the time of the one warm
   run with them built (dict rows, the run held against the host
   executor), p50 of the NDJSON export (`ndjson_p50_s`, with
   its bytes and rows per second) and of the answers
   (`api_query_p50_s`, `api_stats_p50_s`), rows scanned per second,
   the device-busy time of one more warm run under the profiler, each kernel held against its plain
   version again at the main-path shapes and timed beside its bound
   (the bytes and operations this input needs) and a PyTorch yardstick
   (the gated scan on `quota` beside the four launches it replaces; the
   value reduction beside bincount, index_add_ and two scatter_reduce a
   column over the rows masked in; none for the pair, timed on
   `error.*timeout`, and for the gated pair, the same pair behind the
   bloom query's gate), the count also at the cells of
   `uniq_all`, `time_uniq` and `quantile` and the value reduction at
   those of `value_stats` and `num_bucket` (`at_queries`), then the scan
   at row widths 128, 512 and 2048, the count at 4, 1000 and 8 x 1000
   cells and the value reduction at 32, 66 (two columns), 305 (80% of
   the rows in one cell), 1000 and 8192 cells on 1M generated rows
   (`sweep`), and
   the gated scan behind gates of 64, 1,000 and 1,100 blocks with 6 and
   30 probes a block (`gate_sweep`), each held against its plain version
   and timed beside its bound; then the result cache phase on the main
   store (`result_cache_path`, VL_RESULT_CACHE=1 for its runs): stats,
   value stats, rows and top-k queries over a `_time` window that
   covers both parts run with the cache off, cold and warm, all three
   answers equal, the warm run replaying each part (no unit submitted,
   no kernel launched) and the stats queries' warm p50 and device-busy
   time printed with the cache on beside off; a `_stream:` query and
   its stream lookup timed with the stream index's filter cache warm
   beside cleared (`filter_cache_timing`, the result cache off); a
   window that cuts the second part replays the first alone and stores
   nothing for the second; then `must_force_merge` of the main store (2 parts into one
   of 2M rows), after which `count()`, the hourly counts and the
   `error` rows must equal their answers before the close
   (`durable_force_merge`), the result cache must balance with no
   entry of the merged parts left, and the next run misses on the
   merged part alone; then a batch of RC_BATCH_ROWS rows is added and
   the next run recomputes its in-memory part alone; then the filter
   index's part kill (`filter_index_kill`): the merged part's
   filterindex.bin loads, a batch of NEEDLE_ROWS rows (every 50th
   holding the word `needle`) is flushed with the waiting batch into a
   new sealed part, and `needle | stats by (app) count()` through a
   fresh runner kills the merged part by its xor aggregate, stages
   nothing of it and equals the host executor; the card's name
   and power limit,
   then a JSON line of kernel figures, each query's answer figures
   (`answers`), each route's ingest figures (`ingest`), the durable
   store's (`durable`, each flush's filter index seal in `seals`), the
   result cache phase's (`result_cache`) and the filter index's
   (`filter_index`), and a last JSON line with the device.

VL_RESULT_CACHE is 0 for every phase but the result cache's, so every
other run recomputes every part and measures the kernels.

Every time says where it came from: the profiler's device time, or CUDA
events around back-to-back calls (which also count the host launch path)
where the profiler recorded nothing or a time below the work's bound.
--skip-main runs phases 1, 2 and the sweeps only.  Exits non-zero
without a result when CUDA is unavailable or the package is not beside
this script.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROWS = 2_000_000              # main-path rows, ingested with 2 flushes
FLUSHES = 2                   # parts of the main store, 1M rows each
MAIN_SEED = 11                # generator seed of the main store's rows
WARM_RUNS = 5                 # timed warm runs per query, no rows built
FIELDS_CASE = " | fields _time, lvl, dur | limit 5 | offset 2"
# per-query figures of the last-but-one line beside the kernels
ANSWER_KEYS = ("query", "rows_out", "host_s", "device_p50_s",
               "device_collect_p50_s", "ndjson_p50_s", "ndjson_bytes",
               "ndjson_rows_per_s", "api_query_p50_s", "api_fields_p50_s",
               "api_stats_p50_s", "device_busy_s", "cpu_fallbacks",
               "topk_rows", "matched_rows", "api_hits_p50_s",
               "api_range_p50_s")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT32_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit peak


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Per-call time between CUDA events around `iters` calls (includes
    any host launch overhead the device waits on)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int, kernel: str | None = None):
    """Per-call device time from the profiler's CUDA activity: the
    median duration of the named kernel's recorded launches (each call
    launches it once; the profiler has been seen to drop or garble a few
    records of a burst), or all device work of the call when kernel is
    None.  None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    if kernel is not None:
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if str(e.device_type).endswith("CUDA") and kernel in e.name]
        if len(durs) != iters:
            log(f"profiler: {len(durs)} of {iters} launches of {kernel} "
                f"recorded")
        return statistics.median(durs) / 1e3 if durs else None
    total = sum(getattr(e, "self_device_time_total", 0.0) or
                getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages())
    return total / 1e3 / iters if total else None


def timed_ms(fn, iters: int, kernel: str | None = None,
             floor_ms: float = 0.0):
    """(ms, source): `device_ms`, or CUDA events around the calls where
    the profiler records no device time or a time below `floor_ms` (the
    work's bound, which no run can beat: the profiler garbled its
    records); source says which, and the fall-back is logged."""
    ms = device_ms(fn, iters, kernel)
    if ms is not None and ms >= floor_ms:
        return ms, "profiler"
    what = kernel or "the call"
    log(f"profiler: no device time for {what}; timed by CUDA events"
        if ms is None else
        f"profiler: {what} {ms} ms lies below its bound {floor_ms} ms; "
        f"timed by CUDA events")
    return cuda_ms(fn, iters), "cuda events"


def busy_share(fn):
    """(wall s, device-busy s) of one call under the profiler: wall from
    the host clock up to a synchronize, busy as the sum of the device
    time of every kernel and copy (one stream, so they never overlap).
    Busy is None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0.0) or
               getattr(e, "self_cuda_time_total", 0.0)
               for e in prof.key_averages())
    return wall, (busy / 1e6 if busy else None)


def device_ops(fn, n: int = 6) -> list:
    """The `n` device operations (kernels and copies) of one call with
    the most device time under the profiler: [(name, ms, count)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.key, (getattr(e, "self_device_time_total", 0.0) or
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3, e.count)
           for e in prof.key_averages()]
    return sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])[:n]


# ---------------- phase 2: kernels against their plain versions ----------

def rand_rows(rng, r: int, w: int):
    """Random 0xFF-padded rows over a small alphabet (so patterns hit),
    with upper case, digits, punctuation and bytes >= 0x80."""
    import numpy as np
    alpha = np.frombuffer(b"abcAB_ 09.-\xc3\xa9\x80z", dtype=np.uint8)
    mat = np.full((r, w), 0xFF, dtype=np.uint8)
    lens = rng.integers(0, w, size=r).astype(np.int32)
    body = alpha[rng.integers(0, alpha.size, size=(r, w))]
    cols = np.arange(w)[None, :]
    mat = np.where(cols < lens[:, None], body, mat).astype(np.uint8)
    return mat, lens


def check_scan(rng, dev, stats: dict) -> None:
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    n = 0
    for r, w in ((1000, 32), (4097, 128), (777, 256)):
        mat, lens = rand_rows(rng, r, w)
        lanes = torch.from_numpy(to_lanes32(mat).view(np.int32)).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        plens = sorted({1, 2, 3, 4, 5, 7, 8, 13, 31, 32, 63, 64, 100, 127,
                        128, w - 1} & set(range(1, min(w - 1, 128) + 1)))
        for plen in plens:
            src = int(np.argmax(lens))
            off = int(rng.integers(0, max(1, lens[src] - plen + 1)))
            pat = bytes(mat[src, off:off + plen]) if lens[src] >= plen \
                else bytes(rng.choice(np.frombuffer(b"abAB_ 0", np.uint8),
                                      size=plen))
            if 0xFF in pat:
                pat = pat.replace(b"\xff", b"a")
            for mode in range(5):
                for fold in (False, True):
                    p = pat.lower() if fold else pat
                    for st, et in ((False, False), (True, False),
                                   (False, True), (True, True)):
                        got = K.match_scan(lanes, lt, p, mode, st, et, fold)
                        want = K.match_scan_plain(lanes, lt, p, mode, st,
                                                  et, fold)
                        n += 1
                        if not torch.equal(got, want):
                            fail(f"scan r={r} w={w} plen={plen} "
                                 f"mode={mode} fold={fold} st={st} et={et}")
    stats["scan"] = n


def check_count(rng, dev, stats: dict) -> None:
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_count_seg,
                                                      stats_count_seg_plain)
    n = 0
    for r in (1, 100003):
        for nseg in (1, 8):
            for nb in (1, 7, 1000, 8192):
                seg = torch.from_numpy(rng.integers(
                    -1, nseg + 1, size=r).astype(np.int32)).to(dev)
                b = torch.from_numpy(rng.integers(
                    -1, nb + 1, size=r).astype(np.int32)).to(dev)
                m = torch.from_numpy(rng.random(r) < 0.7).to(dev)
                for s in (seg, None) if nseg == 1 else (seg,):
                    got = stats_count_seg(s, b, m, nseg, nb)
                    want = stats_count_seg_plain(s, b, m, nseg, nb)
                    n += 1
                    if not torch.equal(got, want):
                        fail(f"count r={r} nseg={nseg} nb={nb}")
    stats["count"] = n


def check_probe(rng, dev, stats: dict) -> None:
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import (plane_keep,
                                                         plane_keep_plain)
    n = 0
    for b, wp in ((1, 128), (1000, 128), (3001, 256)):
        for p in (1, 6, 128):
            nw = rng.integers(0, wp // 2 + 1, size=b).astype(np.int32)
            nw[rng.random(b) < 0.1] = 0
            bits = rng.random((b, wp, 32)) < 0.97
            plane = np.packbits(bits, axis=2, bitorder="little") \
                .view(np.uint32).reshape(b, wp)
            hi = np.maximum(2 * nw, 1)[:, None]
            idx = (rng.integers(0, 1 << 30, size=(b, p)) % hi) \
                .astype(np.int32)
            shift = rng.integers(0, 32, size=(b, p)).astype(np.int32)
            args = [torch.from_numpy(a).to(dev) for a in
                    (plane.view(np.int32), idx, shift, nw)]
            got = plane_keep(*args)
            want = plane_keep_plain(*args)
            n += 1
            if not torch.equal(got, want):
                fail(f"probe b={b} wp={wp} p={p}")
            if b > 1 and p == 128 and not (want.any() and
                                           not want.all()):
                fail("probe edge data kept all or none of the blocks")
    stats["probe"] = n


# ---------------- phase 2: edges of the scan's and the count's designs ----

SCAN_CHUNK = 32     # row bytes the scan kernel loads at a time (kChunk words)


def planted_rows(rng, r: int, w: int, pat: bytes, lo: int, hi: int,
                 fenced: bool = False):
    """(mat, lens): r 0xFF-padded rows of width w over filler bytes that
    `pat` (drawn from PATTERN_BYTES) never uses, with `pat` planted at an
    offset drawn from [lo, hi), each letter in random case, and a near
    miss (the pattern with its last byte changed) just ahead of it where
    there is room.  Row lengths reach past the planted pattern.
    `fenced` plants it as is, between spaces, so that it matches in
    every mode but the exact ones."""
    import numpy as np
    filler = np.frombuffer(b"xyzXYZ -.\xc3\xa9", dtype=np.uint8)
    plen = len(pat)
    assert 0 <= lo < hi <= w - plen
    mat = filler[rng.integers(0, filler.size, size=(r, w))]
    off = rng.integers(lo, hi, size=r)
    lens = np.minimum(off + plen + rng.integers(0, w, size=r), w - 1) \
        .astype(np.int32)
    low = np.frombuffer(pat, dtype=np.uint8)
    up = np.frombuffer(pat.upper(), dtype=np.uint8)
    for i in range(r):
        o = int(off[i])
        mat[i, o:o + plen] = low if fenced else \
            np.where(rng.random(plen) < 0.5, low, up)
        if o >= plen + 1:
            mat[i, o - plen - 1:o - 1] = low
            mat[i, o - 2] = ord("x")
        if fenced:
            mat[i, max(o - 1, 0)] = mat[i, o + plen] = ord(" ")
            mat[i, o:o + plen] = low
        mat[i, lens[i]:] = 0xFF
    return mat, lens


PATTERN_BYTES = b"ab_09"


def scan_edge_cases(rng) -> list:
    """(label, mat, lens, pattern) cases at the scan's design edges: rows
    decided only past the first loaded chunk, rows all decided inside
    it, patterns of 1-128 bytes straddling the 32- and 64-byte chunk
    edges, width 2048, and row counts below a warp, off the block size
    and off a multiple of 4."""
    import numpy as np

    def pat(n):
        return bytes(rng.choice(np.frombuffer(PATTERN_BYTES, np.uint8),
                                size=n))

    p, q = pat(5), pat(5)
    cases = [("past-first-chunk", *planted_rows(rng, 4097, 256, p,
                                                SCAN_CHUNK + 1, 200), p),
             ("first-chunk", *planted_rows(rng, 1024, 128, q, 0,
                                           SCAN_CHUNK - 6, fenced=True), q)]
    for plen in (1, 4, 5, 31, 32, 33, 64, 128):
        p = pat(plen)
        for edge in (SCAN_CHUNK, 2 * SCAN_CHUNK):
            lo, hi = (edge - 1, edge + 1) if plen == 1 else \
                (max(0, edge + 1 - plen), edge)
            cases.append((f"straddle-{edge}-len{plen}",
                          *planted_rows(rng, 515, 256, p, lo, hi), p))
    p = pat(7)
    cases.append(("w2048", *planted_rows(rng, 777, 2048, p, 100, 1900), p))
    for r, w in ((5, 64), (31, 128), (257, 128), (4099, 64)):
        p = pat(3)
        cases.append((f"r{r}", *planted_rows(rng, r, w, p, 0, w // 2), p))
    return cases


def count_edge_cases(rng) -> list:
    """(label, seg or None, bucket, mask, nseg, nb, offset) numpy cases
    at the count's design edges: every masked row in one bin, nb on
    both sides of the register (32) and shared-memory (12288) limits,
    8 segments, 1 and 100003 rows, and inputs to be viewed at element
    `offset` of a longer buffer (offset > 0: not 16-byte aligned)."""
    import numpy as np

    def ids(n, hi):
        return rng.integers(-1, hi + 1, size=n).astype(np.int32)

    r = 100003
    out = [("one-bin", None, np.full(r, 2, np.int32), np.ones(r, bool),
            1, 4, 0),
           ("one-bin-nseg8", np.full(r, 5, np.int32),
            np.full(r, 3, np.int32), np.ones(r, bool), 8, 4, 0)]
    for nb in (1, 4, 32, 33, 12288, 12289):
        out.append((f"nb{nb}", None, ids(r, nb), rng.random(r) < 0.7, 1,
                    nb, 0))
    for nb in (4, 5, 1536, 1537):
        out.append((f"nseg8-nb{nb}", ids(r, 8), ids(r, nb),
                    rng.random(r) < 0.7, 8, nb, 0))
    out.append(("r1", None, np.array([2], np.int32), np.array([True]), 1,
                4, 0))
    out.append(("r1-nseg8", np.array([7], np.int32), np.array([32], np.int32),
                np.array([True]), 8, 33, 0))
    for off in (1, 3):
        out.append((f"unaligned{off}", ids(r, 8), ids(r, 33),
                    rng.random(r) < 0.7, 8, 33, off))
        out.append((f"unaligned{off}-nseg1", None, ids(r, 4),
                    rng.random(r) < 0.7, 1, 4, off))
    return out


def as_view(a, offset: int, dev):
    """`a` on `dev` as a view at element `offset` of a longer buffer."""
    import numpy as np
    import torch
    base = np.concatenate([np.zeros(offset, a.dtype), a])
    return torch.from_numpy(base).to(dev)[offset:]


GATE_ROWS = 47_000       # rows under the gate edge cases (3 x 15,625 fit)
GATE_STARTS_CAP = 1024   # block starts the gated scan keeps in shared memory


def gate_case(rng, sizes, p: int = 6, first: int = 0, kept=0.5,
              no_bloom: float = 0.0, outside: float = 0.0, wp: int = 128):
    """(starts, plane, nwords, idx, shift) numpy arrays of a bloom gate
    over blocks of the given row counts from row `first`, plane and
    probes padded as the runner stages them.  A block is kept with
    probability `kept` (or where the bool array `kept` says so): every
    probed bit set.  Otherwise one probe, drawn at random (from the
    second round of 32 for half the blocks when p > 32), fails: its bit
    is clear or, for a share `outside` of them, its lane index lies
    outside the plane (a zero lane).  A share `no_bloom` of the blocks
    has nwords == 0 and is kept whatever its probes."""
    import numpy as np
    from victorialogs_tpu_torch.gpu.bloom_device import (pad_plane,
                                                         pad_probe_args)
    b = len(sizes)
    starts = (first + np.concatenate([[0], np.cumsum(sizes)])) \
        .astype(np.int32)
    nwords = rng.integers(1, wp // 2 + 1, size=b).astype(np.int32)
    nwords[rng.random(b) < no_bloom] = 0
    idx = (rng.integers(0, 1 << 30, size=(b, p))
           % (2 * np.maximum(nwords, 1))[:, None]).astype(np.int32)
    shift = rng.integers(0, 32, size=(b, p)).astype(np.int32)
    plane = rng.integers(0, 1 << 32, size=(b, wp), dtype=np.uint64) \
        .astype(np.uint32)
    rows = np.repeat(np.arange(b), p)
    np.bitwise_or.at(plane, (rows, idx.ravel()),
                     (np.uint32(1) << shift.ravel().astype(np.uint32)))
    keep = rng.random(b) < kept if np.isscalar(kept) else np.asarray(kept)
    j = rng.integers(0, p, size=b)
    if p > 32:
        j[::2] = rng.integers(32, p, size=j[::2].size)
    for bi in np.nonzero(~keep)[0].tolist():
        if rng.random() < outside:
            idx[bi, j[bi]] = wp + bi if bi % 2 else -1 - bi
        else:
            plane[bi, idx[bi, j[bi]]] &= ~np.uint32(1 << int(shift[bi, j[bi]]))
    plane, nw = pad_plane(plane, nwords)
    idx, shift = pad_probe_args(idx, shift, plane.shape[0])
    return starts, plane.view(np.int32), nw, idx, shift


def block_sizes(rng, r: int, lo: int, hi: int):
    """Row counts drawn from [lo, hi] that sum to r (the last one cut)."""
    import numpy as np
    sizes = rng.integers(lo, hi + 1, size=r // max(lo, 1) + 1)
    n = int(np.searchsorted(np.cumsum(sizes), r)) + 1
    sizes = sizes[:n]
    sizes[-1] -= int(sizes.sum()) - r
    return sizes


def gate_edge_cases(rng) -> list:
    """(label, starts, plane, nwords, idx, shift) gates over GATE_ROWS
    rows at the edges of the gated scan's design: blocks of 0, 1, 31, 32
    and 33 rows (warps across block boundaries, rows before the first
    block and after the last), three blocks of 15,625 rows (the main
    path's), all and no blocks kept, blocks without a bloom, 32, 33 and
    192 probes a block (the warp tests 32 a round), lane indices outside
    the plane, and more block starts than GATE_STARTS_CAP."""
    import numpy as np
    cut = [1, 31, 32, 33, 0] * 300
    return [
        ("sizes-0-1-31-32-33", *gate_case(rng, cut, first=7)),
        ("blocks-15625", *gate_case(rng, [15625] * 3,
                                    kept=np.array([True, False, True]))),
        ("all-kept", *gate_case(rng, rng.integers(1, 151, size=300),
                                kept=1.0)),
        ("none-kept", *gate_case(rng, rng.integers(1, 151, size=300),
                                 kept=0.0)),
        ("nwords0", *gate_case(rng, rng.integers(1, 151, size=300),
                               kept=0.0, no_bloom=0.4)),
        ("p32", *gate_case(rng, rng.integers(40, 301, size=150), p=32)),
        ("p33", *gate_case(rng, rng.integers(40, 301, size=150), p=33)),
        ("p192", *gate_case(rng, rng.integers(40, 301, size=150), p=192)),
        ("outside-plane", *gate_case(rng, rng.integers(1, 151, size=300),
                                     kept=0.3, outside=0.7)),
        ("starts-over-cap", *gate_case(
            rng, rng.integers(1, 36, size=GATE_STARTS_CAP + 300))),
    ]


def gated_inputs(dev, starts, plane, nwords, idx, shift):
    """A gate_case's arrays as a BloomGate on `dev`."""
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import BloomGate
    return BloomGate(*(torch.from_numpy(a).to(dev)
                       for a in (plane, nwords, idx, shift, starts)))


GRID_STRIDE_ROWS = 600_000   # > 2 grid-stride turns of 8 CTAs x 132 SMs


def gated_runs(rng) -> list:
    """(label, mat, lens, pattern, gate arrays) runs of the gated scan:
    each gate edge case over random rows, each scan edge case behind a
    gate of blocks of 1-64 rows, and GRID_STRIDE_ROWS random rows behind
    blocks of 1-3,000 rows (every CTA loops over the rows more than
    twice)."""
    mat, lens = rand_rows(rng, GATE_ROWS, 32)
    runs = [(f"gate {label}", mat, lens, b"ab", g)
            for label, *g in gate_edge_cases(rng)]
    runs += [(f"scan edge {label}", m, ln, pat,
              gate_case(rng, block_sizes(rng, len(ln), 1, 64)))
             for label, m, ln, pat in scan_edge_cases(rng)]
    mat, lens = rand_rows(rng, GRID_STRIDE_ROWS, 32)
    runs.append(("grid-stride", mat, lens, b"ab", gate_case(
        rng, block_sizes(rng, GRID_STRIDE_ROWS, 1, 3000))))
    return runs


def check_gated(rng, dev, stats: dict) -> None:
    """The gated scan against its plain version on every `gated_runs`
    run, every mode x fold x word boundary, with and without a maybe
    column."""
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    n = 0
    for label, m, ln, pat, g in gated_runs(rng):
        lanes = torch.from_numpy(to_lanes32(m).view("<i4")).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        gate = gated_inputs(dev, *g)
        ovf = torch.from_numpy(rng.random(len(ln)) < 0.1).to(dev)
        for mode in range(5):
            for fold in (False, True):
                for st, et in ((False, False), (True, False), (False, True),
                               (True, True)):
                    for ov in (None, ovf):
                        a = (lanes, lt, pat, mode, st, et, fold, gate, ov)
                        got = K.match_scan_gated(*a)
                        want = K.match_scan_gated_plain(*a)
                        n += 1
                        if not (torch.equal(got[0], want[0]) and
                                (ov is None) == (got[1] is None) and
                                (ov is None or torch.equal(got[1], want[1]))):
                            fail(f"gated {label} mode={mode} fold={fold} "
                                 f"st={st} et={et} ovf={ov is not None}")
    stats["gated_edges"] = n


def check_edges(rng, dev, stats: dict) -> None:
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_count_seg,
                                                      stats_count_seg_plain)
    n = 0
    for label, mat, lens, pat in scan_edge_cases(rng):
        lanes = torch.from_numpy(to_lanes32(mat).view("<i4")).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        for mode in range(5):
            for fold in (False, True):
                for st, et in ((False, False), (True, False), (False, True),
                               (True, True)):
                    got = K.match_scan(lanes, lt, pat, mode, st, et, fold)
                    want = K.match_scan_plain(lanes, lt, pat, mode, st, et,
                                              fold)
                    n += 1
                    if not torch.equal(got, want):
                        fail(f"scan edge {label} mode={mode} fold={fold} "
                             f"st={st} et={et}")
    stats["scan_edges"] = n
    n = 0
    for label, seg, b, m, nseg, nb, off in count_edge_cases(rng):
        s = None if seg is None else as_view(seg, off, dev)
        bt, mt = as_view(b, off, dev), as_view(m, off, dev)
        got = stats_count_seg(s, bt, mt, nseg, nb)
        want = stats_count_seg_plain(s, bt, mt, nseg, nb)
        n += 1
        if not torch.equal(got, want):
            fail(f"count edge {label}")
    stats["count_edges"] = n


def sb_gate_case(rng, sizes, t: int = 2, first: int = 0, kept=0.5,
                 no_filter: float = 0.0, outside: float = 0.0,
                 mmax: int = 4):
    """(starts, plane, nsb, sbidx, mask) numpy arrays of a split-block
    gate over blocks of the given row counts from row `first`, padded
    as the runner stages them: each block holds 1..mmax split blocks of
    random lanes, t tokens of 6 random mask bits each select one.  A
    block is kept with probability `kept` (or where the bool array says
    so): every token's mask bits set in its 8 lanes.  Otherwise one
    token (drawn from the second round of four for half the blocks when
    t > 4) misses: one of its bits is clear or, for a share `outside` of
    them, its lane base lies outside the plane (zero lanes).  A share
    `no_filter` of the blocks has nsb == 0 and is kept whatever its
    lanes."""
    import numpy as np
    from victorialogs_tpu_torch.gpu.bloom_device import (pad_sb_idx,
                                                         pad_sb_plane)
    b = len(sizes)
    starts = (first + np.concatenate([[0], np.cumsum(sizes)])) \
        .astype(np.int32)
    nsb = rng.integers(1, mmax + 1, size=b).astype(np.int32)
    nsb[rng.random(b) < no_filter] = 0
    lp = 8 * mmax
    plane = rng.integers(0, 1 << 32, size=(b, lp), dtype=np.uint64) \
        .astype(np.uint32)
    pos = rng.integers(0, 256, size=(t, 6))
    mask = np.zeros((t, 8), dtype=np.uint32)
    np.bitwise_or.at(mask, (np.repeat(np.arange(t), 6), (pos >> 5).ravel()),
                     np.uint32(1) << (pos & 31).ravel().astype(np.uint32))
    sbidx = (8 * (rng.integers(0, 1 << 30, size=(b, t))
                  % np.maximum(nsb, 1)[:, None])).astype(np.int32)
    rows = np.repeat(np.arange(b), t)
    for k in range(8):
        np.bitwise_or.at(plane, (rows, sbidx.ravel() + k),
                         np.tile(mask[:, k], b))
    keep = rng.random(b) < kept if np.isscalar(kept) else np.asarray(kept)
    j = rng.integers(0, t, size=b)
    if t > 4:
        j[::2] = rng.integers(4, t, size=j[::2].size)
    for bi in np.nonzero(~keep)[0].tolist():
        tj = int(j[bi])
        if rng.random() < outside:
            sbidx[bi, tj] = lp + 8 * bi if bi % 2 else -8 - bi
            continue
        k = int(rng.choice(np.nonzero(mask[tj])[0]))
        bits = np.nonzero([(int(mask[tj, k]) >> q) & 1
                           for q in range(32)])[0]
        plane[bi, sbidx[bi, tj] + k] &= \
            ~np.uint32(1 << int(rng.choice(bits)))
    plane, ns = pad_sb_plane(plane, nsb)
    sbidx = pad_sb_idx(sbidx, plane.shape[0])
    return starts, plane.view(np.int32), ns, sbidx, mask.view(np.int32)


def sb_gate_edge_cases(rng) -> list:
    """(label, starts, plane, nsb, sbidx, mask) split-block gates over
    GATE_ROWS rows at the edges of the gate: blocks of 0-33 rows, three
    of 15,625 (the main path's), all and no blocks kept, blocks without
    a filter (nsb 0), 1, 4, 5 and 8 tokens (the warp tests four a
    round), lane bases outside the plane, and more block starts than
    GATE_STARTS_CAP."""
    import numpy as np
    cut = [1, 31, 32, 33, 0] * 300

    def sizes(n=300, lo=1, hi=150):
        return rng.integers(lo, hi + 1, size=n)

    return [
        ("sizes-0-1-31-32-33", *sb_gate_case(rng, cut, t=1, first=7)),
        ("blocks-15625", *sb_gate_case(rng, [15625] * 3, t=1,
                                       kept=np.array([True, False, True]))),
        ("all-kept", *sb_gate_case(rng, sizes(), kept=1.0)),
        ("none-kept", *sb_gate_case(rng, sizes(), kept=0.0)),
        ("nsb0", *sb_gate_case(rng, sizes(), kept=0.0, no_filter=0.4)),
        ("t1", *sb_gate_case(rng, sizes(150, 40, 300), t=1)),
        ("t4", *sb_gate_case(rng, sizes(150, 40, 300), t=4)),
        ("t5", *sb_gate_case(rng, sizes(150, 40, 300), t=5)),
        ("t8", *sb_gate_case(rng, sizes(150, 40, 300), t=8, mmax=16)),
        ("outside-plane", *sb_gate_case(rng, sizes(), kept=0.3,
                                        outside=0.7)),
        ("starts-over-cap", *sb_gate_case(
            rng, rng.integers(1, 36, size=GATE_STARTS_CAP + 300))),
    ]


def sb_inputs(dev, starts, plane, nsb, sbidx, mask):
    """An sb_gate_case's arrays as an SbGate on `dev`."""
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import SbGate
    return SbGate(*(torch.from_numpy(a).to(dev)
                    for a in (plane, nsb, sbidx, mask, starts)))


def check_probe_sb(rng, dev, stats: dict) -> None:
    """The split-block probe alone (vl_plane_keep_sb) against its plain
    version and the host probe (the JAX package's probe_np_sb) at sweep
    shapes (1, 1,000 and 3,001 blocks x 1, 4 and 8 tokens, a tenth of
    the blocks without a filter) and on every sb_gate_edge_cases gate
    (nsb 0, T 1 and 8, the padded blocks)."""
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import (plane_keep_sb,
                                                         plane_keep_sb_plain,
                                                         probe_np_sb)
    cases = [(f"b={b} t={t}", *sb_gate_case(rng, [1] * b, t=t, mmax=mmax,
                                            no_filter=0.1))
             for b, mmax in ((1, 4), (1000, 4), (3001, 16))
             for t in (1, 4, 8)]
    n = 0
    for label, _st, plane, nsb, sbidx, mask in \
            cases + sb_gate_edge_cases(rng):
        args = [torch.from_numpy(a).to(dev) for a in (plane, sbidx, mask,
                                                      nsb)]
        got = plane_keep_sb(*args)
        want = plane_keep_sb_plain(*args)
        host = probe_np_sb(plane.view(np.uint32), sbidx,
                           mask.view(np.uint32), nsb) \
            if (sbidx >= 0).all() and \
            (sbidx.max(initial=0) + 8 <= plane.shape[1]) else None
        n += 1
        if not torch.equal(got, want) or (
                host is not None and
                not np.array_equal(want.cpu().numpy(), host)):
            fail(f"probe_sb {label}")
    stats["probe_sb"] = n


def check_gated_sb(rng, dev, stats: dict) -> None:
    """The scan and the pair behind split-block gates against their
    plain versions: the scan on every sb_gate_edge_cases gate over
    random rows and on GRID_STRIDE_ROWS rows behind blocks of 1-3,000
    rows, every mode x fold x word boundary, with and without a maybe
    column; the pair (both outputs) behind every gate over pair rows,
    with and without an ovf column."""
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.bloom_device import keep_rows_plain
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    mat, lens = rand_rows(rng, GATE_ROWS, 32)
    runs = [(f"sb gate {label}", mat, lens, g)
            for label, *g in sb_gate_edge_cases(rng)]
    gmat, glens = rand_rows(rng, GRID_STRIDE_ROWS, 32)
    runs.append(("sb grid-stride", gmat, glens, sb_gate_case(
        rng, block_sizes(rng, GRID_STRIDE_ROWS, 1, 3000))))
    n = out = 0
    for label, m, ln, g in runs:
        lanes = torch.from_numpy(to_lanes32(m).view("<i4")).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        gate = sb_inputs(dev, *g)
        out += int((~keep_rows_plain(gate, len(ln))).sum())
        ovf = torch.from_numpy(rng.random(len(ln)) < 0.1).to(dev)
        for mode in range(5):
            for fold in (False, True):
                for st, et in ((False, False), (True, True)):
                    for ov in (None, ovf):
                        a = (lanes, lt, b"ab", mode, st, et, fold, gate, ov)
                        got = K.match_scan_gated_sb(*a)
                        want = K.match_scan_gated_plain(*a)
                        n += 1
                        if not (torch.equal(got[0], want[0]) and
                                (ov is None) == (got[1] is None) and
                                (ov is None or torch.equal(got[1], want[1]))):
                            fail(f"gated_sb {label} mode={mode} fold={fold} "
                                 f"st={st} et={et} ovf={ov is not None}")
    if not out:
        fail("gated_sb edge cases: no row ruled out")
    stats["gated_sb_edges"] = n
    a, b = b"ab", b"\xe2\x82\xacb"
    pmat, plens = pair_rows(rng, GATE_ROWS, 32, a, b)
    lanes = torch.from_numpy(to_lanes32(pmat).view("<i4")).to(dev)
    lt = torch.from_numpy(plens).to(dev)
    ovf = torch.from_numpy(rng.random(len(plens)) < 0.1).to(dev)
    n = definite = maybe = 0
    for label, *g in sb_gate_edge_cases(rng):
        gate = sb_inputs(dev, *g)
        for ov in (None, ovf):
            got = K.match_pair_gated_sb(lanes, lt, a, b, gate, ov)
            want = K.match_pair_gated_plain(lanes, lt, a, b, gate, ov)
            if not (torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1])):
                fail(f"pair_gated_sb {label} ovf={ov is not None}")
            n += 1
            definite += int(want[0].sum())
            maybe += int(want[1].sum())
    if not (definite and maybe):
        fail(f"pair_gated_sb edge cases: {definite} definite, {maybe} "
             f"maybe rows")
    stats.update(pair_gated_sb_edges=n, pair_gated_sb_definite=definite,
                 pair_gated_sb_maybe=maybe)


# cells on both sides of count.cu's register path (kRegCells = 6) and of
# its shared tables (one column's table fits the H100's 227 KB up to
# 11,622 cells)
VALUE_CELLS = (1, 6, 7, 33, 1000, 4097, 8192, 11622, 11623)
VALUE_COLS = (1, 2, 9)       # one, two and one more than a launch takes


def value_inputs(rng, r: int, nb: int, kept: float = 0.7, ncol: int = 1):
    """(columns, ids, mask) numpy: ncol uint32 value columns (as int32
    bits) with 0 and 0xFFFFFFFF among them, ids over [-1, nb] (both
    ends outside)."""
    import numpy as np
    cols = []
    for _ in range(ncol):
        v = rng.integers(0, 1 << 32, size=r, dtype=np.uint64) \
            .astype(np.uint32)
        v[rng.random(r) < 0.1] = 0
        v[rng.random(r) < 0.1] = 0xFFFFFFFF
        cols.append(v.view(np.int32))
    ids = rng.integers(-1, nb + 1, size=r).astype(np.int32)
    return cols, ids, rng.random(r) < kept


def skewed(rng, ids, nb: int, share: float = 0.8):
    """ids with a `share` of the rows moved to one cell, as the `status`
    column's 80% of `200`."""
    import numpy as np
    return np.where(rng.random(ids.size) < share, nb // 3, ids) \
        .astype(np.int32)


def check_values(rng, dev, stats: dict) -> None:
    """The value reduction against its plain version at VALUE_CELLS
    cells x VALUE_COLS columns, on 1 and 100,003 rows."""
    import torch
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_values,
                                                      stats_values_plain)
    n = 0
    for r in (1, 100003):
        for nb in VALUE_CELLS:
            for f in VALUE_COLS:
                cols, ids, m = value_inputs(rng, r, nb, ncol=f)
                args = ([torch.from_numpy(c).to(dev) for c in cols],
                        torch.from_numpy(ids).to(dev),
                        torch.from_numpy(m).to(dev), nb)
                n += 1
                if not torch.equal(stats_values(*args),
                                   stats_values_plain(*args)):
                    fail(f"values r={r} nb={nb} columns={f}")
    stats["values"] = n


def value_edge_cases(rng) -> list:
    """(label, columns, ids, mask, nb, offset) numpy cases at the value
    reduction's design edges, in the register path, the shared tables
    and global atomics: no row masked in, every row in one cell, 80% of
    the rows in one cell, values only 0 and 0xFFFFFFFF, one row, inputs
    viewed at element `offset` of a longer buffer (offset > 0: not
    16-byte aligned), and two and nine columns."""
    import numpy as np
    r = 100003
    out = []
    for nb in (6, 7, 1000, 11623):
        cols, ids, _m = value_inputs(rng, r, nb)
        out.append((f"none-masked-nb{nb}", cols, ids, np.zeros(r, bool), nb,
                    0))
        out.append((f"one-cell-nb{nb}", cols, np.full(r, nb // 2, np.int32),
                    np.ones(r, bool), nb, 0))
        cols, ids, m = value_inputs(rng, r, nb, ncol=2)
        out.append((f"skew80-nb{nb}", cols, skewed(rng, ids, nb), m, nb, 0))
        ext = np.where(rng.random(r) < 0.5, 0, 0xFFFFFFFF).astype(np.uint32)
        out.append((f"extremes-nb{nb}", [ext.view(np.int32)], ids,
                    rng.random(r) < 0.7, nb, 0))
    for nb in (4, 33, 11623):
        cols, ids, m = value_inputs(rng, 1, nb, kept=1.0, ncol=2)
        out.append((f"r1-nb{nb}", cols, np.array([nb - 1], np.int32), m, nb,
                    0))
    for off in (1, 3):
        for nb in (4, 1000, 11623):
            out.append((f"unaligned{off}-nb{nb}",
                        *value_inputs(rng, r, nb, ncol=2), nb, off))
    for nb in (4, 66, 1000):
        out.append((f"cols9-nb{nb}", *value_inputs(rng, r, nb, ncol=9), nb,
                    0))
    return out


def check_value_edges(rng, dev, stats: dict) -> None:
    import torch
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_values,
                                                      stats_values_plain)
    n = 0
    for label, cols, ids, m, nb, off in value_edge_cases(rng):
        args = ([as_view(c, off, dev) for c in cols], as_view(ids, off, dev),
                as_view(m, off, dev), nb)
        n += 1
        if not torch.equal(stats_values(*args), stats_values_plain(*args)):
            fail(f"values edge {label}")
    stats["value_edges"] = n


# ---------------- phase 2: the ordered pair and the fold scan ----------

PAIR_FILLER = b"xyz -.\xc3\xa9"   # filler bytes; pair patterns use others


def pair_pattern(rng, n: int) -> bytes:
    """n bytes over "ab" and the two-byte character U+20AC (bytes >=
    0x80 that the filler never holds), whole characters only."""
    import numpy as np
    out = b""
    while len(out) < n:
        c = [b"a", b"b", b"\xe2\x82\xac"][int(rng.integers(0, 3))]
        out += c if len(out) + len(c) <= n else b"a"
    return out


def pair_rows(rng, r: int, w: int, a: bytes, b: bytes):
    """(mat, lens): r rows of width w over PAIR_FILLER, each with one of:
    A then B, B only before A, several of each, A and B overlapping, A
    alone, nothing; and a newline at the first byte, the last byte or
    inside A's first occurrence, or none.  Lengths span 0..w (w: no
    padding, w - 1: the widest staged row), among them rows shorter
    than len(A) + len(B); 0xFF padding past each length."""
    import numpy as np
    filler = np.frombuffer(PAIR_FILLER, dtype=np.uint8)
    mat = filler[rng.integers(0, filler.size, size=(r, w))]
    lens = rng.integers(0, w + 1, size=r).astype(np.int32)
    head = [0, w, w - 1, min(len(a) + len(b) - 1, w), len(a) + len(b)]
    lens[:min(r, len(head))] = head[:min(r, len(head))]
    pa = np.frombuffer(a, dtype=np.uint8)
    pb = np.frombuffer(b, dtype=np.uint8)
    for i in range(r):
        n = int(lens[i])
        row = mat[i]

        def put(p, lo):
            hi = n - p.size
            if hi < lo:
                return -1
            o = int(rng.integers(lo, hi + 1))
            row[o:o + p.size] = p
            return o

        kind = int(rng.integers(0, 6))
        oa = -1
        if kind == 0:
            oa = put(pa, 0)
            if oa >= 0:
                put(pb, oa + pa.size)
        elif kind == 1:
            ob = put(pb, 0)
            if ob >= 0:
                oa = put(pa, ob + pb.size)
        elif kind == 2:
            for _ in range(3):
                oa = put(pa, 0)
                put(pb, 0)
        elif kind == 3:
            oa = put(pa, 0)
            if oa >= 0 and oa + 1 + pb.size <= n:
                row[oa + 1:oa + 1 + pb.size] = pb
        elif kind == 4:
            oa = put(pa, 0)
        nl = int(rng.integers(0, 5))
        if n and nl == 0:
            row[0] = 0x0A
        elif n and nl == 1:
            row[n - 1] = 0x0A
        elif nl == 2 and oa >= 0:
            row[oa + pa.size // 2] = 0x0A
        row[n:] = 0xFF
    return mat, lens


def pair_edge_cases(rng) -> list:
    """(label, mat, lens, A, B) cases at the pair kernel's edges: A and B
    of 1-64 bytes with la + lb on both sides of each boundary of its
    state words (29 and 61 pattern bits: one, two and five words) and at
    2, 31-33, 63-65, 127 and 128, A == B, overlapping patterns (`aa.*aa`,
    `aba.*bab`), widths 32, 128 and 256, ragged row counts (1, 31, 257,
    4099) and rows over the grid-stride loop."""
    cases = []
    for la, lb, w in ((1, 1, 32), (3, 4, 32), (4, 5, 128), (5, 3, 128),
                      (14, 15, 128), (15, 15, 128), (15, 16, 128),
                      (16, 16, 128), (16, 17, 128), (30, 31, 128),
                      (31, 31, 128), (31, 32, 128),
                      (32, 32, 128), (63, 64, 256), (64, 63, 256),
                      (64, 64, 256), (1, 64, 128), (32, 33, 128),
                      (33, 1, 128)):
        a, b = pair_pattern(rng, la), pair_pattern(rng, lb)
        cases.append((f"len{la}-{lb}-w{w}", *pair_rows(rng, 1031, w, a, b),
                      a, b))
    for a, b in ((b"ab", b"ab"), (b"aa", b"aa"), (b"aba", b"bab"),
                 (b"\xe2\x82\xac", b"\xe2\x82\xac")):
        for w in (32, 128):
            cases.append((f"{a!r}-{b!r}-w{w}", *pair_rows(rng, 2049, w, a, b),
                          a, b))
    for r, w in ((1, 32), (31, 128), (257, 256), (4099, 32)):
        a, b = pair_pattern(rng, 3), pair_pattern(rng, 2)
        cases.append((f"r{r}-w{w}", *pair_rows(rng, r, w, a, b), a, b))
    a, b = pair_pattern(rng, 5), pair_pattern(rng, 4)
    cases.append(("grid-stride", *pair_rows(rng, GRID_STRIDE_ROWS // 8, 32,
                                            a, b), a, b))
    return cases


def pair_gated_runs(rng) -> list:
    """(label, mat, lens, A, B, gate arrays) runs of the gated pair: each
    gate edge case over GATE_ROWS pair rows, and each pair edge case
    behind a gate of blocks of 1-64 rows."""
    a, b = b"ab", b"\xe2\x82\xacb"
    mat, lens = pair_rows(rng, GATE_ROWS, 32, a, b)
    runs = [(f"gate {label}", mat, lens, a, b, g)
            for label, *g in gate_edge_cases(rng)]
    runs += [(f"pair edge {label}", m, ln, pa, pb,
              gate_case(rng, block_sizes(rng, len(ln), 1, 64)))
             for label, m, ln, pa, pb in pair_edge_cases(rng)]
    return runs


def check_pair(rng, dev, stats: dict) -> None:
    """Both forms of the pair kernel against their plain versions, both
    outputs bit for bit: the pair on every `pair_edge_cases` case and the
    gated pair on every `pair_gated_runs` run, each with and without an
    ovf column (a tenth of the rows truncated); the cases hold definite
    and maybe rows, and the gates rule rows out."""
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.bloom_device import keep_rows_plain
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    counts = dict.fromkeys(("pair_edges", "pair_definite", "pair_maybe",
                            "pair_gated_edges", "pair_gated_definite",
                            "pair_gated_maybe", "pair_gated_out"), 0)

    def held(kind: str, label: str, got, want, gated_out=0) -> None:
        if not (torch.equal(got[0], want[0]) and
                torch.equal(got[1], want[1])):
            fail(f"{kind} edge {label}")
        counts[f"{kind}_edges"] += 1
        counts[f"{kind}_definite"] += int(want[0].sum())
        counts[f"{kind}_maybe"] += int(want[1].sum())
        if kind == "pair_gated":
            counts["pair_gated_out"] += gated_out

    for label, mat, lens, a, b in pair_edge_cases(rng):
        lanes = torch.from_numpy(to_lanes32(mat).view("<i4")).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        ovf = torch.from_numpy(rng.random(len(lens)) < 0.1).to(dev)
        for ov in (None, ovf):
            held("pair", f"{label} ovf={ov is not None}",
                 K.match_pair(lanes, lt, a, b, ov),
                 K.match_pair_plain(lanes, lt, a, b, ov))
    for label, mat, lens, a, b, g in pair_gated_runs(rng):
        lanes = torch.from_numpy(to_lanes32(mat).view("<i4")).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        gate = gated_inputs(dev, *g)
        ovf = torch.from_numpy(rng.random(len(lens)) < 0.1).to(dev)
        out = int((~keep_rows_plain(gate, len(lens))).sum())
        for ov in (None, ovf):
            held("pair_gated", f"{label} ovf={ov is not None}",
                 K.match_pair_gated(lanes, lt, a, b, gate, ov),
                 K.match_pair_gated_plain(lanes, lt, a, b, gate, ov), out)
    for kind in ("pair", "pair_gated"):
        if not (counts[f"{kind}_definite"] and counts[f"{kind}_maybe"]):
            fail(f"{kind} edge cases: no definite or no maybe rows "
                 f"({counts})")
    if not counts["pair_gated_out"]:
        fail("pair_gated edge cases: no row ruled out")
    stats.update(counts)


def check_fold(rng, dev, stats: dict) -> None:
    """The fold scan of an `i()` leaf, a `scan` node evaluated as the
    main path does, with and without the multibyte mask, against the
    plain scan and the mask: definite = hit & ~multibyte, maybe =
    multibyte."""
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.fused import eval_node
    from victorialogs_tpu_torch.gpu.layout import to_lanes32
    n = 0
    for r, w in ((1000, 32), (4097, 128), (777, 256)):
        mat, lens = rand_rows(rng, r, w)
        mb = np.array([(mat[i, :lens[i]] >= 0x80).any() for i in range(r)])
        lanes = torch.from_numpy(to_lanes32(mat).view("<i4")).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        mbt = torch.from_numpy(mb).to(dev)
        for pat in (b"ab", b"a b", b"b_0", b"ab\xc3\xa9"):
            for mode, st, et in ((0, True, True), (0, False, True),
                                 (1, True, False), (2, False, False)):
                hit = K.match_scan_plain(lanes, lt, pat, mode, st, et, True)
                for with_mb in (False, True):
                    args = [lanes, lt] + ([mbt] if with_mb else [])
                    d, m = eval_node(("scan", 0, 1, -1, 2 if with_mb else -1,
                                      pat, mode, st, et, True), args, r, dev)
                    n += 1
                    if with_mb:
                        ok = torch.equal(d, hit & ~mbt) and \
                            torch.equal(m, mbt)
                    else:
                        ok = torch.equal(d, hit) and m is None
                    if not ok:
                        fail(f"fold scan r={r} w={w} {pat!r} mode={mode} "
                             f"multibyte={with_mb}")
    stats["fold"] = n


# ---------------- bounds: the work this run's data needs ----------------

def decide_ends(lanes, lengths, pattern: bytes, mode: int,
                starts_tok: bool, ends_tok: bool, fold: bool = False):
    """int64[R]: the bytes of each row the scan needs, phrase, prefix and
    substring modes: up to its first match's last byte (or the byte
    after it under an end word boundary), its whole length when it has
    no match, none when it is shorter than the pattern."""
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    if mode not in (K.MODE_PHRASE, K.MODE_PREFIX, K.MODE_SUBSTRING):
        raise ValueError(f"scan bound: unsupported mode {mode}")
    plen = len(pattern)
    lens = lengths.to(torch.int64)
    acc = K.match_windows_plain(lanes, pattern, mode, starts_tok, ends_tok,
                                fold)
    s = torch.arange(acc.shape[1], device=acc.device)
    acc &= s[None, :] <= (lens - plen)[:, None]
    end = acc.to(torch.uint8).argmax(dim=1) + plen
    if ends_tok and mode == K.MODE_PHRASE:
        end = torch.where(end < lens, end + 1, end)
    end = torch.where(acc.any(dim=1), end, lens)
    return torch.where(lens >= plen, end, torch.zeros_like(end))


def sector_bytes(end) -> int:
    """Bytes of the 32-byte sectors (one lane word of 8 rows) that hold
    the first `end[row]` bytes of every row."""
    import torch
    r = end.numel()
    words = torch.nn.functional.pad((end + 3) // 4, (0, (-r) % 8))
    return 32 * int(words.view(-1, 8).amax(dim=1).sum())


def scan_work(lanes, lengths, pattern: bytes, mode: int, starts_tok: bool,
              ends_tok: bool, fold: bool = False) -> tuple[int, int]:
    """(bytes, byte tests) the scan needs on this input: each row's
    bytes up to the one that decides it (`decide_ends`), fetched in
    32-byte sectors holding one word of 8 rows, so a sector counts when
    any of its rows needs it.  Each row also reads its 4-byte length and
    writes its 1-byte result."""
    end = decide_ends(lanes, lengths, pattern, mode, starts_tok, ends_tok,
                      fold)
    return sector_bytes(end) + 5 * end.numel(), int(end.sum())


def pair_work(lanes, lengths) -> tuple[int, int]:
    """(bytes, byte steps) the pair kernel needs on this input: every
    byte of every row (B's last occurrence and a newline may come at
    its end), fetched in 32-byte sectors holding one word of 8 rows, its
    4-byte length and two 1-byte results; one automaton step a byte."""
    import torch
    end = lengths.to(torch.int64).clamp(max=4 * lanes.shape[0])
    return sector_bytes(end) + 6 * end.numel(), int(end.sum())


def gated_pair_work(lanes, lengths, gate, ovf=None) -> tuple[int, int]:
    """(bytes, byte steps + probes) the gated pair needs on this input.
    Rows of kept blocks that are not maybe rows need what `pair_work`
    counts for them (every byte in sectors, the 4-byte length); every
    row writes its two 1-byte results (and, with a maybe column, reads
    its 1-byte flag where its block is kept).  The B blocks of the gate
    need what `gate_work` counts, and the 4(B+1) bytes of block
    starts."""
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import keep_rows_plain
    r = lanes.shape[1]
    kept = keep_rows_plain(gate, r)
    need = kept if ovf is None else kept & ~ovf
    end = lengths.to(torch.int64).clamp(max=4 * lanes.shape[0])
    end = torch.where(need, end, torch.zeros_like(end))
    nb = gate.starts.numel() - 1
    gbytes, gops = gate_work(gate, nb)
    nbytes = sector_bytes(end) + 4 * int(need.sum()) + 2 * r + gbytes \
        + 4 * (nb + 1)
    if ovf is not None:
        nbytes += int(kept.sum())
    return nbytes, int(end.sum()) + gops


def sb_token_counts(plane, sbidx, mask, nsb):
    """int64[B]: the tokens each block tests with a split-block probe,
    up to and including the first that misses; none without a
    filter."""
    import torch
    b, t = sbidx.shape
    lp = plane.shape[1]
    lane = sbidx.to(torch.int64)[:, :, None] + torch.arange(
        8, device=plane.device)
    inside = (lane >= 0) & (lane < lp)
    words = torch.gather(plane, 1, lane.reshape(b, 8 * t).clamp(0, lp - 1)) \
        .reshape(b, t, 8)
    words = torch.where(inside, words, torch.zeros_like(words))
    miss = ~((words & mask[None]) == mask[None]).all(dim=2)
    n = torch.where(miss.any(dim=1), miss.to(torch.uint8).argmax(dim=1) + 1,
                    torch.full_like(nsb, t, dtype=torch.int64))
    return torch.where(nsb != 0, n, torch.zeros_like(n))


def sb_probe_work(plane, sbidx, mask, nsb) -> tuple[int, int]:
    """(bytes, lane tests) the split-block probe needs on this input:
    each token a block tests (`sb_token_counts`) is one 32-byte sector
    of the plane and its 4-byte lane base (8 lane tests); each block
    reads its 4-byte filter count and writes its 1-byte keep; the
    token masks (32 bytes a token) are read once."""
    tokens = int(sb_token_counts(plane, sbidx, mask, nsb).sum())
    return 36 * tokens + 5 * nsb.numel() + 32 * sbidx.shape[1], 8 * tokens


def gate_work(gate, nb: int) -> tuple[int, int]:
    """(bytes, tests) of the first nb blocks' probes behind a gate: a
    BloomGate's `probe_work` less the 1-byte results (40 bytes a probe,
    4 a word count), an SbGate's `sb_probe_work` likewise."""
    from victorialogs_tpu_torch.gpu.bloom_device import SbGate
    if isinstance(gate, SbGate):
        tokens = int(sb_token_counts(gate.plane[:nb], gate.sbidx[:nb],
                                     gate.mask, gate.nsb[:nb]).sum())
        return 36 * tokens + 4 * nb + 32 * gate.mask.shape[0], 8 * tokens
    probes = int(probe_counts(gate.plane[:nb], gate.idx[:nb],
                              gate.shift[:nb], gate.nwords[:nb]).sum())
    return 40 * probes + 4 * nb, probes


def probe_counts(plane, idx, shift, nwords):
    """int64[B]: the probes each block tests, up to and including the
    first clear bit; none without a bloom."""
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import probe_bits_plain
    clear = ~probe_bits_plain(plane, idx, shift)
    n = torch.where(clear.any(dim=1),
                    clear.to(torch.uint8).argmax(dim=1) + 1,
                    torch.full_like(nwords, idx.shape[1], dtype=torch.int64))
    return torch.where(nwords != 0, n, torch.zeros_like(n))


def probe_work(plane, idx, shift, nwords) -> tuple[int, int]:
    """(bytes, probes) the bloom probe needs on this input.  Each probe
    a block tests (`probe_counts`) is a gathered 32-byte sector of the
    plane plus its 4-byte lane index and 4-byte shift.  Each block also
    reads its 4-byte word count and writes its 1-byte keep."""
    probes = int(probe_counts(plane, idx, shift, nwords).sum())
    return 40 * probes + 5 * nwords.numel(), probes


def gated_work(lanes, lengths, pattern: bytes, mode: int, starts_tok: bool,
               ends_tok: bool, fold: bool, gate,
               ovf=None) -> tuple[int, int]:
    """(bytes, byte tests + probes) the gated scan needs on this input.
    Rows of kept blocks that are not maybe rows need what `scan_work`
    counts for them (their sectors, their 4-byte length); every row
    writes its 1-byte result (and, with a maybe column, reads its 1-byte
    flag where its block is kept and writes its 1-byte maybe).  The B
    blocks of the gate need what `gate_work` counts (a BloomGate's
    probes at 40 bytes each and 4-byte word counts; an SbGate's tokens
    at a 32-byte sector and a 4-byte lane base each, its 4-byte filter
    counts and the token masks), and the 4(B+1) bytes of block
    starts."""
    import torch
    from victorialogs_tpu_torch.gpu.bloom_device import keep_rows_plain
    r = lanes.shape[1]
    kept = keep_rows_plain(gate, r)
    need = kept if ovf is None else kept & ~ovf
    end = decide_ends(lanes, lengths, pattern, mode, starts_tok, ends_tok,
                      fold)
    end = torch.where(need, end, torch.zeros_like(end))
    nb = gate.starts.numel() - 1
    gbytes, gops = gate_work(gate, nb)
    nbytes = sector_bytes(end) + 4 * int(need.sum()) + r + gbytes \
        + 4 * (nb + 1)
    if ovf is not None:
        nbytes += int(kept.sum()) + r
    return nbytes, int(end.sum()) + gops


def values_work(mask, nb: int, ncol: int = 1) -> tuple[int, int]:
    """(bytes, operations) the value reduction of ncol columns needs:
    each row's 4-byte id and 1-byte mask read once and its 4-byte value
    of each column, each cell's 20 bytes of results a column written
    once; a count, and a sum, a min and a max a column, for each row
    masked in."""
    return (5 + 4 * ncol) * mask.numel() + 20 * ncol * nb, \
        (1 + 3 * ncol) * int(mask.sum())


def values_library(columns, ids, mask, nb: int):
    """The PyTorch yardstick of the value reduction: the rows masked in
    with an id in [0, nb) selected once, then bincount, and index_add_
    and two scatter_reduce calls a column over the selected rows.
    Returns the call."""
    import torch
    dev = ids.device

    def call():
        sel = mask & (ids >= 0) & (ids < nb)
        idx = ids[sel].to(torch.int64)
        cnt = torch.bincount(idx, minlength=nb)
        out = []
        for c in columns:
            v = c[sel].to(torch.int64) & 0xFFFFFFFF
            sums = torch.zeros(nb, dtype=torch.int64, device=dev) \
                .index_add_(0, idx, v)
            mn = torch.full((nb,), 0xFFFFFFFF, dtype=torch.int64,
                            device=dev).scatter_reduce_(0, idx, v, "amin")
            mx = torch.zeros(nb, dtype=torch.int64, device=dev) \
                .scatter_reduce_(0, idx, v, "amax")
            out.append((cnt, sums, mn, mx))
        return out
    return call


def values_agree(packed, lib_out, nb: int) -> bool:
    """The kernel's packed [F, 5*nb] result equals the yardstick's four
    tensors of each column."""
    import torch
    from victorialogs_tpu_torch.gpu.stats_seg import split_values
    if packed.shape[0] != len(lib_out):
        return False
    for row, lib in zip(packed, lib_out):
        cnt, sums, mn, mx = split_values(row, nb)
        mine = (cnt.to(torch.int64), sums, mn.to(torch.int64) & 0xFFFFFFFF,
                mx.to(torch.int64) & 0xFFFFFFFF)
        if not all(torch.equal(a, b) for a, b in zip(mine, lib)):
            return False
    return True


def part_stats_inputs(runner, part, q: str):
    """(cell ids, mask, axes, value columns) of query q's stats launch on
    `part` over all its blocks, built as the main path builds them."""
    from victorialogs_tpu_torch.engine.block_search import BlockSearch
    from victorialogs_tpu_torch.gpu.fused import eval_node
    from victorialogs_tpu_torch.gpu.kernels import combine_ids
    from victorialogs_tpu_torch.logsql.parser import parse_query
    pq = parse_query(q)
    spec = runner.stats_spec(pq)
    asm = runner._assemble_axes(part, spec)
    bss = {bi: BlockSearch(part, bi) for bi in range(part.num_blocks)}
    tree, args, layout, _maybe, cand = runner._program(pq.filter, part, bss)
    d, _m = eval_node(tree, args, layout.nrows_padded, runner.device)
    cols = [asm.numerics[f].values for f in spec.value_fields]
    return combine_ids([a[1] for a in asm.axes], asm.strides), d & cand, \
        asm, cols


# ---------------- phase 4: width and bin sweeps ----------------

SWEEP_ROWS = 1 << 20
SWEEP_WIDTHS = (128, 512, 2048)
SLICE_ROWS = 8192             # rows per slice of the plain checks and bounds


def sweep_lanes(rng, r: int, w: int, dev):
    """(int32[w/4, r] lanes, int32[r] lengths) on `dev`: each row the
    generator's words joined by spaces, starting at a word of one long
    text and cut to a length drawn from [w/4, w-1], then 0xFF-padded.
    Built on the card, a slice of rows at a time."""
    import numpy as np
    import torch
    from victorialogs_tpu_torch.cli.vlogsgenerator import RARE, WORDS
    vocab = WORDS + [RARE]
    pick = rng.integers(0, len(vocab), size=(1 << 24) // 6)
    text = " ".join(np.array(vocab, dtype=object)[pick].tolist()).encode()
    starts = np.concatenate([[0], np.cumsum(
        np.array([len(v) + 1 for v in vocab])[pick])[:-1]])
    starts = starts[starts < len(text) - w]
    off = torch.from_numpy(starts[rng.integers(0, starts.size, size=r)]) \
        .to(dev)
    lens = torch.from_numpy(rng.integers(w // 4, w, size=r)
                            .astype(np.int32)).to(dev)
    t = torch.from_numpy(np.frombuffer(text, dtype=np.uint8).copy()).to(dev)
    cols = torch.arange(w, device=dev)
    lanes = torch.empty((w // 4, r), dtype=torch.int32, device=dev)
    step = max(8, (1 << 26) // w)
    for a in range(0, r, step):
        b = min(r, a + step)
        mat = t[off[a:b, None] + cols[None, :]]
        mat[cols[None, :] >= lens[a:b, None]] = 0xFF
        lanes[:, a:b] = mat.view(torch.int32).T
    return lanes, lens


def sliced(fn, lanes, lengths, *args):
    """fn over slices of SLICE_ROWS rows (a multiple of 8): the results
    concatenated, or summed when fn returns a tuple of ints."""
    import torch
    parts = [fn(lanes[:, a:a + SLICE_ROWS].contiguous(),
                lengths[a:a + SLICE_ROWS], *args)
             for a in range(0, lanes.shape[1], SLICE_ROWS)]
    if isinstance(parts[0], tuple):
        return tuple(sum(p[i] for p in parts) for i in range(len(parts[0])))
    return torch.cat(parts)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the card's memory
    rate and operations over its 32-bit integer rate."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def sweep(rng, dev) -> list:
    """The scan at each SWEEP_WIDTHS width, the count at 4 time
    buckets, 1000 buckets and 8 segments x 1000 buckets and the value
    reduction at each VALUE_SWEEP case, all on SWEEP_ROWS rows under the
    scan's `error` mask: each held against its plain version bit for bit
    and timed beside its bound (the bytes and operations this input
    needs) and, for the value reduction, its yardstick."""
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_count_seg,
                                                      stats_count_seg_plain)
    rows, mask = [], None
    r = SWEEP_ROWS
    for w in SWEEP_WIDTHS:
        lanes, lens = sweep_lanes(rng, r, w, dev)
        args = (b"error", K.MODE_PHRASE, True, True)
        got = K.match_scan(lanes, lens, *args)
        if not torch.equal(got, sliced(K.match_scan_plain, lanes, lens,
                                       *args)):
            fail(f"scan sweep W={w}: kernel differs from its plain version")
        if mask is None:
            mask = got
        nbytes, ops = sliced(scan_work, lanes, lens, *args)
        rows.append({"kernel": "match_scan", "case": f"W={w}",
                     "rows": r, "hits": int(got.sum()),
                     "mean_len": float(lens.float().mean()),
                     "bound_bytes": nbytes, "bound_operations": ops,
                     "fn": lambda a=(lanes, lens, *args): K.match_scan(*a),
                     "filter": "match_scan_kernel"})
    seg8 = torch.from_numpy(rng.integers(0, 8, size=r).astype(np.int32)) \
        .to(dev)
    for label, seg, ids, nseg, nb in (
            ("nb=4 time buckets",
             None, (torch.arange(r, device=dev) * 4 // r).to(torch.int32),
             1, 4),
            ("nb=1000", None, torch.from_numpy(rng.integers(
                0, 1000, size=r).astype(np.int32)).to(dev), 1, 1000),
            ("nseg=8 x nb=1000", seg8, torch.from_numpy(rng.integers(
                0, 1000, size=r).astype(np.int32)).to(dev), 8, 1000)):
        a = (seg, ids, mask, nseg, nb)
        if not torch.equal(stats_count_seg(*a), stats_count_seg_plain(*a)):
            fail(f"count sweep {label}: kernel differs from its plain "
                 f"version")
        rows.append({"kernel": "stats_count_seg", "case": label, "rows": r,
                     "bound_bytes": r * (9 if seg is not None else 5)
                     + nseg * nb * 4,
                     "bound_operations": int(mask.sum()),
                     "fn": lambda a=a: stats_count_seg(*a),
                     "filter": "count_"})
    for label, nb, f, skew in VALUE_SWEEP:
        cols, ids, _m = value_inputs(rng, r, nb, ncol=f)
        ids = ids % nb
        if skew:
            ids = skewed(rng, ids, nb)
        a = ([torch.from_numpy(c).to(dev) for c in cols],
             torch.from_numpy(ids).to(dev), mask, nb)
        rows.append(values_row(a, f"nb={nb}, {label}", "sweep"))
    return time_sweep(rows)


# (label, cells, value columns, 80% of the rows in one cell)
VALUE_SWEEP = (("F=1", 32, 1, False), ("F=2", 66, 2, False),
               ("F=1, 80% in one cell", 305, 1, True),
               ("F=1", 1000, 1, False), ("F=1", 8192, 1, False))


def values_row(a, case: str, where: str) -> dict:
    """A sweep row of the value reduction on a = (columns, ids, mask, nb),
    held against its plain version and its yardstick first."""
    import torch
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_values,
                                                      stats_values_plain)
    cols, ids, mask, nb = a
    got = stats_values(*a)
    if not torch.equal(got, stats_values_plain(*a)):
        fail(f"values {where} {case}: kernel differs from its plain version")
    lib = values_library(*a)
    if not values_agree(got, lib(), nb):
        fail(f"values {where} {case}: the PyTorch composition disagrees")
    nbytes, ops = values_work(mask, nb, len(cols))
    return {"kernel": "stats_values", "case": case, "rows": ids.numel(),
            "cells": nb, "columns": len(cols),
            "masked_rows": int(mask.sum()),
            "bound_bytes": nbytes, "bound_operations": ops,
            "fn": lambda: stats_values(*a), "filter": "values_", "lib": lib}


def time_sweep(rows: list) -> list:
    """Time each sweep row's "fn" (its kernel named by "filter") beside
    the bound of its "bound_bytes" and "bound_operations", and its
    PyTorch yardstick "lib" where it has one."""
    for s in rows:
        fn, flt, lib = s.pop("fn"), s.pop("filter"), s.pop("lib", None)
        s["bound_ms"], s["bound_by"] = bound(s["bound_bytes"],
                                             s["bound_operations"])
        s["ms"], s["timing"] = timed_ms(fn, 20, flt, s["bound_ms"])
        s["launch_to_launch_ms"] = cuda_ms(fn, 20)
        if lib is not None:
            s["library_ms"], s["library_timing"] = timed_ms(
                lib, 20, floor_ms=s["bound_ms"])
        log(f"sweep {s['kernel']} {s.get('case', s.get('query'))}: "
            f"{s['ms']} ms by {s['timing']}, bound {s['bound_ms']} ms by "
            f"{s['bound_by']} ({s['bound_ms'] / s['ms']:.1%} of it), "
            f"launch-to-launch {s['launch_to_launch_ms']} ms"
            + (f", library {s['library_ms']} ms" if lib else ""))
    return rows


GATE_SWEEP = (       # (blocks, probes a block, blocks kept) on SWEEP_ROWS
    (64, 6, 16),     # the main path's part: 15,625-row blocks
    (64, 6, 0),
    (1000, 6, 250),  # block starts in shared memory, ~1,000 blocks
    (1000, 30, 250),
    (1100, 6, 275),  # block starts above GATE_STARTS_CAP
    (1100, 30, 275),
)


def gate_sweep(rng, dev) -> list:
    """The gated scan of `quota` (phrase, word boundaries) on SWEEP_ROWS
    rows of W = 128 behind each GATE_SWEEP gate (equal blocks, the kept
    ones drawn at random): each held against its plain version bit for
    bit and timed beside its bound (`gated_work`)."""
    import numpy as np
    import torch
    from victorialogs_tpu_torch.gpu import kernels as K
    r = SWEEP_ROWS
    lanes, lens = sweep_lanes(rng, r, 128, dev)
    rows = []
    for nb, p, nkept in GATE_SWEEP:
        sizes = np.full(nb, r // nb)
        sizes[-1] += r - int(sizes.sum())
        kept = np.zeros(nb, bool)
        kept[rng.choice(nb, nkept, replace=False)] = True
        gate = gated_inputs(dev, *gate_case(rng, sizes, p=p, kept=kept))
        args = (lanes, lens, b"quota", K.MODE_PHRASE, True, True, False,
                gate)
        case = f"{nb} blocks, P={p}, {nkept} kept"
        if not torch.equal(K.match_scan_gated(*args)[0],
                           K.match_scan_gated_plain(*args)[0]):
            fail(f"gate sweep {case}: kernel differs from its plain "
                 f"version")
        nbytes, ops = gated_work(*args)
        rows.append({"kernel": "match_scan_gated", "case": case, "rows": r,
                     "bound_bytes": nbytes, "bound_operations": ops,
                     "fn": lambda a=args: K.match_scan_gated(*a),
                     "filter": "gated_scan_kernel"})
    return time_sweep(rows)


# ---------------- phase 3: the main path ----------------

INGEST_STREAM_FIELDS = ["app", "host"]
ROUTE_ROWS = 65_536           # rows of the store ingested by every route


def flush_body(route: str, n: int, seed: int, start: int, span: int):
    """One flush's generator rows as the body of `route` (bytes), or
    the rows themselves for route `rows`."""
    from victorialogs_tpu_torch.cli import vlogsgenerator as gen
    rows = gen.generate(n, seed, start, span)
    if route == "rows":
        return rows
    return (gen.jsonline_body if route == "jsonline" else gen.bulk_body)(rows)


def store_by_route(route: str, batches: list, path: str | None = None):
    """A Storage on the card fed one flush a batch, each sent as a user
    sends it: `rows` (a list of generator rows: LogRows ->
    must_add_rows), `jsonline` (handle_jsonline) or `bulk`
    (handle_elasticsearch_bulk) with a body.  With `path` the store is
    durable (its flush_interval an hour: each batch is one flush, one
    part on disk).  (storage, figures: rows, body bytes, the seconds in
    the handler and in the flush; with `path`, per flush its seconds and
    the compressed and uncompressed bytes it wrote)."""
    from victorialogs_tpu_torch.server import insertutil, vlinsert
    from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID
    from victorialogs_tpu_torch.storage.storage import Storage
    storage = Storage(path, flush_interval=3600, device="cuda")
    cp = insertutil.CommonParams(tenant=TenantID(0, 0),
                                 stream_fields=INGEST_STREAM_FIELDS)
    fig = {"route": route, "rows": 0, "body_bytes": 0, "handler_s": 0.0,
           "flush_s": 0.0}
    if path is not None:
        fig["flushes"] = []
    for batch in batches:
        t0 = time.perf_counter()
        if route == "rows":
            lr = LogRows(stream_fields=INGEST_STREAM_FIELDS)
            for ts, fields in batch:
                lr.add(cp.tenant, ts, fields)
            storage.must_add_rows(lr)
            n, want = len(lr), len(batch)
        else:
            lmp = insertutil.LogMessageProcessor(
                cp, insertutil.LocalLogRowsStorage(storage))
            if route == "jsonline":
                n = vlinsert.handle_jsonline(cp, batch, lmp)
                want = batch.count(b"\n")
            else:
                n, resp = vlinsert.handle_elasticsearch_bulk(cp, batch, lmp)
                want = batch.count(b"\n") // 2
                if len(resp["items"]) != n or resp["errors"]:
                    fail(f"_bulk answered {n} rows with errors "
                         f"{resp['errors']} and {len(resp['items'])} items")
            lmp.flush()
            fig["body_bytes"] += len(batch)
        t1 = time.perf_counter()
        before = storage.update_stats()
        storage.debug_flush()
        t2 = time.perf_counter()
        if n != want:
            fail(f"ingest by {route}: {n} rows of {want}")
        fig["rows"] += n
        fig["handler_s"] += t1 - t0
        fig["flush_s"] += t2 - t1
        if path is not None:
            after = storage.update_stats()
            fig["flushes"].append({
                "write_s": t2 - t1, "rows": n,
                "compressed_bytes":
                    after["compressed_size"] - before["compressed_size"],
                "uncompressed_bytes":
                    after["uncompressed_size"] - before["uncompressed_size"],
                "seals": seals(storage)[len(fig["flushes"]):]})
    secs = fig["handler_s"] + fig["flush_s"]
    fig["rows_per_s"] = fig["rows"] / secs
    fig["us_per_row"] = secs / fig["rows"] * 1e6
    return storage, fig


def seals(storage) -> list:
    """The filter index figures of every part the durable store sealed
    since it was opened, in order (storage/datadb.py `seals`)."""
    return [s for pt in storage.partitions.values() for s in pt.ddb.seals]


def start_bodies(route: str, total: int, flushes: int, seed: int):
    """Start making ingest_route's bodies (the same generator rows for
    the same seed), one spawned process a flush, and return without
    waiting: the main store's bodies are made while the kernels build
    and are checked.  A call of the returned function waits for them:
    (start, batches, seconds from the start until they were made,
    seconds it waited).  The pool is shut down there (or, on a failure
    before, at exit, after its workers end)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           today_start_ns)
    start = today_start_ns()
    span = NS_PER_DAY // 2
    per = total // flushes
    args = [(route, per, seed + k, start + k * span // flushes,
             span // flushes) for k in range(flushes)]
    t0 = time.perf_counter()
    ex = ProcessPoolExecutor(max_workers=flushes,
                             mp_context=multiprocessing.get_context("spawn"))
    futs = [ex.submit(flush_body, *a) for a in args]
    made = [0.0]

    def note(_f) -> None:
        made[0] = max(made[0], time.perf_counter() - t0)

    for f in futs:
        f.add_done_callback(note)

    def wait() -> tuple:
        t1 = time.perf_counter()
        batches = [f.result() for f in futs]
        waited = time.perf_counter() - t1
        ex.shutdown()
        return start, batches, made[0], waited
    return wait


def ingest_route(route: str, total: int, flushes: int, seed: int,
                 path: str | None = None, bodies=None):
    """ingest()'s store, each flush's rows sent by `route`
    (store_by_route; durable under `path`).  The bodies come from
    `bodies` (start_bodies' waiting function, started earlier), else
    are made now (set-up, timed apart as `setup_s`, the wait for them
    as `setup_wait_s`).  (storage, start, rows, figures)."""
    if bodies is None:
        bodies = start_bodies(route, total, flushes, seed)
    start, batches, setup_s, waited = bodies()
    storage, fig = store_by_route(route, batches, path)
    fig["setup_s"] = setup_s
    fig["setup_wait_s"] = waited
    return storage, start, (total // flushes) * flushes, fig


def log_ingest(fig: dict, counters: dict) -> None:
    setup = (f"rows and body made in {fig['setup_s']:.2f} s (waited "
             f"{fig['setup_wait_s']:.2f} s for them); "
             if "setup_wait_s" in fig else "")
    log(f"ingest by {fig['route']}: {fig['rows']} rows, body "
        f"{fig['body_bytes']} B; {setup}handler {fig['handler_s']:.2f} s, "
        f"flush {fig['flush_s']:.2f} s: {fig['rows_per_s']:.0f} rows/s "
        f"({fig['us_per_row']:.2f} us a row); counters {counters}")


def parts_equal(a, b) -> str | None:
    """None when two parts hold the same blocks (stream, tags,
    timestamps, consts, columns with their payload and bloom), else
    what differs."""
    import numpy as np
    if (a.num_blocks, a.num_rows, a.min_ts, a.max_ts) != \
            (b.num_blocks, b.num_rows, b.min_ts, b.max_ts):
        return (f"{a.num_blocks} blocks, {a.num_rows} rows vs "
                f"{b.num_blocks} blocks, {b.num_rows} rows")
    for i, (x, y) in enumerate(zip(a.blocks, b.blocks)):
        if (x.stream_id, x.stream_tags_str, x.const_columns) != \
                (y.stream_id, y.stream_tags_str, y.const_columns) or \
                not np.array_equal(x.timestamps, y.timestamps) or \
                [c.name for c in x.columns] != [c.name for c in y.columns]:
            return f"block {i}: stream, timestamps, consts or column names"
        for cx, cy in zip(x.columns, y.columns):
            for attr in ("vtype", "dict_values", "min_val", "max_val",
                         "iso_frac_w", "const_value"):
                if getattr(cx, attr) != getattr(cy, attr):
                    return f"block {i} column {cx.name}: {attr}"
            for attr in ("ids", "nums", "arena", "offsets", "lengths",
                         "bloom"):
                u, v = getattr(cx, attr), getattr(cy, attr)
                if (u is None) != (v is None) or (
                        u is not None and (u.dtype != v.dtype or
                                           not np.array_equal(u, v))):
                    return f"block {i} column {cx.name}: {attr}"
    return None


def route_parity(seed: int):
    """ROUTE_ROWS generator rows ingested by rows, jsonline and bulk in
    one flush each: the three parts must be equal.  (The figures of the
    three routes, the jsonline route's store, left open for the
    transform path.)"""
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           bulk_body,
                                                           generate,
                                                           jsonline_body,
                                                           today_start_ns)
    from victorialogs_tpu_torch.server import vlinsert
    rows = generate(ROUTE_ROWS, seed, today_start_ns(), NS_PER_DAY // 2)
    figs, parts = [], {}
    for route, batch in (("rows", rows), ("jsonline", jsonline_body(rows)),
                         ("bulk", bulk_body(rows))):
        for k in vlinsert.INGEST_COUNTERS:
            vlinsert.INGEST_COUNTERS[k] = 0
        storage, fig = store_by_route(route, [batch])
        counters = dict(vlinsert.INGEST_COUNTERS)
        log_ingest(fig, counters)
        if counters["py_chunks"]:
            fail(f"ingest by {route}: {counters['py_chunks']} chunks were "
                 f"parsed in Python")
        fig.update(counters, store="routes")
        figs.append(fig)
        (parts[route],) = [p for pt in storage.partitions.values()
                           for p in pt.parts]
        if route == "jsonline":
            kept = storage
        else:
            storage.close()
    for route in ("jsonline", "bulk"):
        why = parts_equal(parts[route], parts["rows"])
        if why is not None:
            fail(f"the part ingested by {route} differs from the one by "
                 f"rows: {why}")
    log(f"ingest routes: rows, jsonline and bulk gave equal parts of "
        f"{parts['rows'].num_rows} rows in {parts['rows'].num_blocks} "
        f"blocks")
    return figs, kept


# answers of the main store taken before it is closed, held equal after
# the reopen; the first two (and the phrase rows' digest) also after the
# final force merge
DURABLE_QUERIES = ("* | stats count()", "* | stats by (_time:1h) count()",
                   "error | stats by (app) count()",
                   "quota | stats by (lvl) count(), sum(dur)",
                   "error | sort by (dur) desc limit 10",
                   "error | limit 100")
PHRASE = "error"


def export_digest(storage, tenants, q: str, runner) -> tuple:
    """(rows, sha256 of the NDJSON export's lines sorted): a result's
    rows as a multiset, whatever order a walk gives them (the export,
    not dict rows: a file part decodes its columns at every read, and
    the export emits the stored bytes)."""
    import hashlib
    from victorialogs_tpu_torch.engine.emit import ndjson_block
    from victorialogs_tpu_torch.engine.searcher import run_query
    chunks = []
    run_query(storage, tenants, q, lambda br: chunks.append(ndjson_block(br)),
              runner=runner)
    lines = b"".join(chunks).splitlines()
    lines.sort()
    return len(lines), hashlib.sha256(b"\n".join(lines)).hexdigest()


def durable_answers(storage, tenants, runner) -> dict:
    """DURABLE_QUERIES' answers and the phrase rows' digest."""
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    out = {q: run_query_collect(storage, tenants, q, runner=runner)
           for q in DURABLE_QUERIES}
    out[PHRASE] = export_digest(storage, tenants, PHRASE, runner)
    return out


def durable_reopen(storage, path: str, tenants, rows_sent: int):
    """Take the answers of the durable main store, close it, reopen it
    from `path`, and hold the reopened store to every acknowledged row
    (`count()` against the rows sent) and to the same answers; then time
    the cold first query (its files read and decompressed, its columns
    staged by a fresh runner; the file pages are warm: nothing drops
    them).  (the reopened store, its answers, figures, the runner that
    answered on it, kept for the main path)."""
    import torch
    from victorialogs_tpu_torch.engine.searcher import run_query
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.storage.storage import Storage
    runner = TorchBatchRunner(device="cuda")
    t0 = time.perf_counter()
    before = durable_answers(storage, tenants, runner)
    answers_s = time.perf_counter() - t0
    runner.close()
    stats = storage.update_stats()
    t0 = time.perf_counter()
    storage.close()
    close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    storage = Storage(path, device="cuda")
    reopen_s = time.perf_counter() - t0
    reopened = storage.update_stats()
    runner = TorchBatchRunner(device="cuda")
    root = tracing.make_root("query", query=PHRASE)
    t0 = time.perf_counter()
    with tracing.activate(root):
        run_query(storage, tenants, PHRASE, lambda br: None, runner=runner)
        torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_trace = cold_counters(root)
    t0 = time.perf_counter()
    run_query(storage, tenants, PHRASE, lambda br: None, runner=runner)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = durable_answers(storage, tenants, runner)
    counted = int(after[DURABLE_QUERIES[0]][0]["count(*)"])
    if counted != rows_sent:
        fail(f"the reopened store counts {counted} rows of the "
             f"{rows_sent} acknowledged")
    for q in before:
        if after[q] != before[q]:
            fail(f"durable: {q!r} answers differently after the reopen")
    if runner.stats_counters["host_parts"]:
        fail(f"durable: {runner.stats_counters['host_parts']} parts ran "
             f"on the host")
    if (reopened["file_rows"], reopened["small_parts"]) != \
            (rows_sent, FLUSHES):
        fail(f"durable: the reopened store holds {reopened}")
    fig = {"rows_sent": rows_sent, "rows_counted": counted,
           "parts": reopened["small_parts"],
           "compressed_bytes": stats["compressed_size"],
           "uncompressed_bytes": stats["uncompressed_size"],
           "answers_s": answers_s, "close_s": close_s,
           "reopen_s": reopen_s, "cold_first_query_s": cold_s,
           "cold_first_query_trace": cold_trace,
           "second_query_s": warm_s, "answers_held": len(before)}
    log(f"durable: closed in {close_s:.3f} s, reopened in {reopen_s:.3f} s "
        f"({reopened['small_parts']} parts, {reopened['file_rows']} rows, "
        f"{stats['compressed_size']} B compressed of "
        f"{stats['uncompressed_size']} B); count() {counted} of {rows_sent} "
        f"rows sent; {len(before)} answers equal after the reopen "
        f"(taken in {answers_s:.2f} s); cold first query {PHRASE!r} "
        f"{cold_s:.4f} s (files read, decompressed, staged; pages warm), "
        f"the second {warm_s:.4f} s")
    log(f"durable: the cold first query's trace (traced run): "
        f"{json.dumps(cold_trace)}")
    return storage, before, fig, runner


COLD_COUNTERS = ("staged_entries", "staged_bytes", "blocks_probed_bloom",
                 "blocks_killed_bloom", "blocks_probed_maplet",
                 "blocks_killed_maplet", "parts_pruned_aggregate",
                 "blocks_out", "rows_downloaded", "host_sync_wait_s")


def cold_counters(root) -> dict:
    """A traced query's counters summed over its spans, and each span
    name's count and total milliseconds (`flatten`)."""
    out = {k: 0 for k in COLD_COUNTERS}

    def walk(sp):
        for k in COLD_COUNTERS:
            out[k] += sp.attrs.get(k, 0)
        for c in sp.children:
            walk(c)

    walk(root)
    out["spans"] = root.flatten()
    return out


def durable_force_merge(storage, tenants, runner, before: dict) -> dict:
    """must_force_merge the main store (its parts into one), then hold
    count(), the hourly counts and the phrase rows to their answers
    before the close."""
    t0 = time.perf_counter()
    storage.must_force_merge()
    merge_s = time.perf_counter() - t0
    parts = [p for pt in storage.partitions.values() for p in pt.parts]
    if len(parts) != 1 or parts[0].num_rows != ROWS:
        fail(f"force merge: parts of {[p.num_rows for p in parts]} rows")
    after = durable_answers(storage, tenants, runner)
    for q in (DURABLE_QUERIES[0], DURABLE_QUERIES[1], PHRASE):
        if after[q] != before[q]:
            fail(f"force merge: {q!r} answers differently")
    stats = storage.update_stats()
    fig = {"merge_s": merge_s, "parts": 1, "rows": parts[0].num_rows,
           "blocks": parts[0].num_blocks,
           "compressed_bytes": stats["compressed_size"],
           "uncompressed_bytes": stats["uncompressed_size"]}
    log(f"durable: force merge of {FLUSHES} parts into one of "
        f"{parts[0].num_rows} rows in {parts[0].num_blocks} blocks, "
        f"{merge_s:.2f} s, {stats['compressed_size']} B compressed; "
        f"count(), hourly counts and {after[PHRASE][0]} phrase rows equal")
    return fig


RC_BATCH_ROWS = 10_000        # rows of the batch the result cache phase adds
RC_TIMED_RUNS = 3             # timed runs a query, the cache on and off


def rc_queries(start: int) -> tuple:
    """The result cache phase's queries over `_time` windows of the main
    store (2 parts: [start, start + 6h) and [start + 6h, start + 12h)):
    ({name: LogsQL} over the whole day, which covers both parts; the
    hourly counts over [start, start + 9h), which covers the first part
    and cuts the second; a `_stream:` count over the whole day, which
    times the stream index's filter cache)."""
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    hour = 3600 * 10**9
    day = (f"_time:[{format_rfc3339(start)}, "
           f"{format_rfc3339(start + 24 * hour)})")
    cut = (f"_time:[{format_rfc3339(start)}, "
           f"{format_rfc3339(start + 9 * hour)})")
    return ({"stats": f"{day} error | stats by (_time:1h) count()",
             "value_stats": f"{day} error | stats by (lvl) count(), "
                            f"sum(dur), avg(dur), min(dur), max(dur)",
             "rows": f"{day} quota timeout | fields _time, dur",
             "topk": f"{day} error | sort by (dur) desc limit 10"},
            f"{cut} error | stats by (_time:1h) count()",
            f'{day} _stream:{{app="app-3"}} timeout | stats count()')


def result_cache_path(storage, tenants, runner, wrappers, timed, start,
                      durable_before) -> dict:
    """The per-part result cache on the reopened main store, with
    VL_RESULT_CACHE=1 for its runs and 0 again after it:

    - each of `rc_queries` runs with the cache off, cold and warm: the
      three answers equal; the cold run launches kernels and replays no
      part, the warm one replays each sealed part (one result-cache unit
      a part), submits no unit and launches nothing; the stats query's
      warm p50 and device-busy time with the cache on beside off;
    - the stream index's filter cache (the result cache off): a
      `_stream:` query's p50 and its stream lookup with the filter cache
      warm beside cleared before each call, the answers equal;
    - a `_time` window that cuts the second part: the first part
      replays, the second is recomputed and nothing is stored for it;
    - `must_force_merge` (durable_force_merge, the cache off) and a
      collection: the store balances and holds no entry of the merged
      parts; the next run misses on the merged part alone and equals
      the answer with the cache off;
    - one batch of RC_BATCH_ROWS rows added (an in-memory part): the
      next run replays the merged part, recomputes the new one alone
      (one unit, its launches half of the cold run's over the two parts)
      and equals the answer with the cache off.
    Figures for the last-but-one line."""
    import gc
    import weakref
    import torch
    from victorialogs_tpu_torch.cli.vlogsgenerator import generate
    from victorialogs_tpu_torch.engine import standing
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.storage.log_rows import LogRows
    t_phase = time.perf_counter()
    counters = runner.stats_counters
    qs, cut_q, stream_q = rc_queries(start)

    def run(q: str, cache: bool):
        """(answer, launches by kernel, runner counter moves) of one run
        with the cache on or off."""
        os.environ["VL_RESULT_CACHE"] = "1" if cache else "0"
        c0 = dict(counters)
        l0 = {w.__name__: w.launches for w in wrappers}
        s0 = standing.cache_stats()
        got = run_query_collect(storage, tenants, q, runner=runner)
        torch.cuda.synchronize()
        s1 = standing.cache_stats()
        return got, {w.__name__: w.launches - l0[w.__name__]
                     for w in wrappers}, dict(
            {k: counters[k] - c0[k] for k in counters},
            **{f"cache_{k}": s1[k] - s0[k]
               for k in ("hits", "misses", "stores")})

    def held(what: str, got, want) -> None:
        if got != want:
            fail(f"result cache: {what}: the answer differs from the "
                 f"answer with the cache off ({len(got)} vs {len(want)} "
                 f"rows)")

    standing.reset_for_tests()
    sealed = [weakref.ref(p) for pt in storage.partitions.values()
              for p in pt.snapshot_parts()]
    nsealed = len(sealed)
    fig = {"sealed_parts": nsealed, "queries": {}, "steps_s": {}}
    cold_launches = None
    t_step = time.perf_counter()

    def step(name: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        fig["steps_s"][name] = now - t_step
        t_step = now

    for name, q in qs.items():
        off, _l, _m = run(q, False)
        cold, lc, mc = run(q, True)
        warm, lw, mw = run(q, True)
        held(f"{name} cold", cold, off)
        held(f"{name} warm", warm, off)
        if mc["result_cache_units"] or not sum(lc.values()) or \
                mc["cache_stores"] != nsealed:
            fail(f"result cache: {name} cold run: {mc}, launches {lc}")
        if sum(lw.values()) or mw["units"] or mw["device_parts"] or \
                mw["result_cache_units"] != nsealed or \
                mw["cache_hits"] != nsealed:
            fail(f"result cache: {name} warm run: {mw}, launches {lw}")
        if name == "stats":
            cold_launches = lc
        row = {"rows_out": len(off), "cold_launches": lc,
               "warm_launches": lw, "cold": mc, "warm": mw}
        if name in ("stats", "value_stats"):
            for tag, on in (("on", True), ("off", False)):
                os.environ["VL_RESULT_CACHE"] = "1" if on else "0"

                def fn(q=q):
                    run_query(storage, tenants, q, lambda br: None,
                              runner=runner)

                row[f"warm_p50_s_cache_{tag}"] = timed(fn, RC_TIMED_RUNS)
                wall, busy = busy_share(fn)
                ops = device_ops(fn)
                if busy is None and ops:
                    # the profiler has recorded no device time in a
                    # profile whose next one saw kernels: profile again
                    log(f"result cache {name}: the busy profile of the "
                        f"cache {tag} run recorded no device time, the "
                        f"next one {len(ops)} ops; profiled again")
                    wall, busy = busy_share(fn)
                    row[f"busy_reprofiled_cache_{tag}"] = True
                row[f"profiled_wall_s_cache_{tag}"] = wall
                row[f"device_busy_s_cache_{tag}"] = busy
                row[f"device_ops_cache_{tag}"] = ops
        fig["queries"][name] = row
        timing = "" if "warm_p50_s_cache_on" not in row else (
            f"; warm p50 {row['warm_p50_s_cache_on']:.6f} s with the cache "
            f"on, {row['warm_p50_s_cache_off']:.6f} s off; device busy "
            f"{row['device_busy_s_cache_on']} s on, "
            f"{row['device_busy_s_cache_off']} s off (profiled runs; None: "
            f"no device time recorded); device ops on "
            f"{row['device_ops_cache_on']}, off {row['device_ops_cache_off']}")
        log(f"result cache {name}: {len(off)} rows, equal off, cold and "
            f"warm; cold launches {lc}, warm {lw} with "
            f"{mw['result_cache_units']} result-cache units of {nsealed} "
            f"parts{timing}")

    step("queries")
    fig["filter_cache"] = filter_cache_timing(storage, tenants, runner,
                                              stream_q)
    step("filter_cache")
    # a window that cuts the second part
    off, _l, _m = run(cut_q, False)
    got, lcut, mcut = run(cut_q, True)
    held("cut window", got, off)
    if (mcut["cache_hits"], mcut["cache_misses"], mcut["cache_stores"],
            mcut["result_cache_units"], mcut["units"]) != (1, 1, 0, 1, 1):
        fail(f"result cache: the cut window: {mcut}, launches {lcut}")
    fig["cut_window"] = {"rows_out": len(off), "launches": lcut,
                         "moves": mcut}
    log(f"result cache: the window cutting the second part replays the "
        f"first and recomputes the second ({mcut}), nothing stored")

    step("cut_window")
    # the merge, with the cache off; the merged-away parts must go
    entries = standing.cache_stats()["entries"]
    os.environ["VL_RESULT_CACHE"] = "0"
    fig["force_merge"] = durable_force_merge(storage, tenants, runner,
                                             durable_before)
    step("force_merge_and_checks")
    gc.collect()
    ok, detail = standing.cache_check_balanced()
    alive = sum(r() is not None for r in sealed)
    after = standing.cache_stats()["entries"]
    if not ok or alive or after:
        held_by = [type(r).__name__ for ref in sealed if ref() is not None
                   for r in gc.get_referrers(ref())]
        fail(f"result cache after the merge: balanced {ok} ({detail}), "
             f"{alive} merged-away parts alive (held by {held_by}), "
             f"{after} entries")
    q = qs["stats"]
    off, _l, _m = run(q, False)
    got, lm, mm = run(q, True)
    held("after the merge", got, off)
    if (mm["cache_misses"], mm["cache_hits"], mm["result_cache_units"],
            mm["cache_stores"]) != (1, 0, 0, 1):
        fail(f"result cache: the run after the merge: {mm}")
    fig["after_merge"] = {"entries_before": entries, "entries_after": after,
                          "balanced": detail, "moves": mm}
    log(f"result cache: {entries} entries before the merge, {after} after "
        f"it and a collection ({detail}); the next run misses on the "
        f"merged part ({mm}) and equals the answer with the cache off")

    step("after_merge")
    # a new batch: an in-memory part, recomputed alone
    lr = LogRows(stream_fields=INGEST_STREAM_FIELDS)
    for ts, fields in generate(RC_BATCH_ROWS, 17, start + 13 * 3600 * 10**9,
                               3600 * 10**9):
        lr.add(tenants[0], ts, fields)
    storage.must_add_rows(lr)
    nparts = sum(len(pt.snapshot_parts())
                 for pt in storage.partitions.values())
    off, _l, _m = run(q, False)
    got, lh, mh = run(q, True)
    held("the new batch", got, off)
    if nparts != 2 or (mh["result_cache_units"], mh["units"],
                       mh["cache_hits"], mh["cache_misses"]) != \
            (1, 1, 1, 1) or \
            {k: 2 * v for k, v in lh.items()} != cold_launches:
        fail(f"result cache: the new batch ({nparts} parts): {mh}, "
             f"launches {lh} against {cold_launches} for {nsealed} parts")
    fig["new_batch"] = {"rows": RC_BATCH_ROWS, "launches": lh, "moves": mh}
    log(f"result cache: a batch of {RC_BATCH_ROWS} rows added; the next "
        f"run replays the merged part and recomputes the new one alone "
        f"(launches {lh}, {mh})")
    step("new_batch")
    os.environ["VL_RESULT_CACHE"] = "0"
    ok, detail = standing.cache_check_balanced()
    if not ok:
        fail(f"result cache: unbalanced at the end ({detail})")
    fig["store"] = standing.cache_stats()
    fig["phase_s"] = time.perf_counter() - t_phase
    log(f"result cache phase: {fig['steps_s']} s by step; store "
        f"{fig['store']}")
    return fig


RC_LOOKUPS = 200              # timed stream lookups, the filter cache warm
                              # and cleared


def filter_cache_timing(storage, tenants, runner, q: str) -> dict:
    """The stream index's two-generation filter cache, with the result
    cache off: the p50 of the `_stream:` query `q` and the mean time of
    its stream lookup (Partition.search_stream_ids), each with the
    filter cache warm beside cleared before every call (the runs of the
    two alternate); the answers and the lookups' stream ids equal."""
    import torch
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.logsql.filters import FilterStream
    from victorialogs_tpu_torch.logsql.parser import parse_query
    os.environ["VL_RESULT_CACHE"] = "0"
    pts = list(storage.partitions.values())
    sf = [f for f in parse_query(q).filter.filters
          if isinstance(f, FilterStream)][0].stream_filter

    def clear() -> None:
        for pt in pts:
            pt.idb._filter_cache.clear()

    def query() -> None:
        run_query(storage, tenants, q, lambda br: None, runner=runner)

    def cleared_query() -> None:
        clear()
        query()

    def lookups(cleared: bool) -> tuple:
        ids, t = None, 0.0
        for _ in range(RC_LOOKUPS):
            if cleared:
                clear()
            t0 = time.perf_counter()
            ids = [pt.search_stream_ids(tenants, sf) for pt in pts]
            t += time.perf_counter() - t0
        return ids, t / RC_LOOKUPS

    want = run_query_collect(storage, tenants, q, runner=runner)
    clear()
    got = run_query_collect(storage, tenants, q, runner=runner)
    torch.cuda.synchronize()
    if got != want or not want:
        fail(f"filter cache: {q!r}: the answer with the filter cache "
             f"cleared differs ({got} vs {want})")
    ids_warm, lookup_warm = lookups(False)
    ids_cleared, lookup_cleared = lookups(True)
    if ids_warm != ids_cleared or not any(ids_warm):
        fail(f"filter cache: the lookup's stream ids differ warm and "
             f"cleared")
    walls = {"warm": [], "cleared": []}
    for _ in range(RC_TIMED_RUNS + 2):
        for tag, fn in (("cleared", cleared_query), ("warm", query)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[tag].append(time.perf_counter() - t0)
    fig = {"query": q, "streams": sum(len(i) for i in ids_warm),
           "query_p50_s_warm": statistics.median(walls["warm"]),
           "query_p50_s_cleared": statistics.median(walls["cleared"]),
           "lookup_s_warm": lookup_warm,
           "lookup_s_cleared": lookup_cleared}
    log(f"filter cache: {q!r} p50 {fig['query_p50_s_warm']:.6f} s with "
        f"the stream filter cache warm, {fig['query_p50_s_cleared']:.6f} s "
        f"cleared before each run; the lookup of {fig['streams']} streams "
        f"{lookup_warm * 1e3:.6f} ms warm, {lookup_cleared * 1e3:.6f} ms "
        f"cleared (mean of {RC_LOOKUPS}); answers equal")
    return fig


# query -> the any-case query that must return its rows (queries())
ANYCASE_TWINS = {"phrase": "anycase", "prefix": "anycase_prefix"}


def queries(start: int) -> list:
    """(name, LogsQL, {kernel: launches per device part of the query});
    the query launches no other kernel."""
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    hour = 3600 * 10**9
    lo, hi = format_rfc3339(start + hour), format_rfc3339(start + 5 * hour)
    scan, count = "match_scan", "stats_count_seg"
    values, pair = "stats_values", "match_pair"
    return [
        ("phrase", "error", {scan: 1}),
        # next to `phrase` (and `anycase_prefix` next to `prefix`), whose
        # rows it must return, so they are freed before the other
        # queries run (ANYCASE_TWINS)
        ("anycase", "i(ERROR)", {scan: 1}),
        ("prefix", "resp*", {scan: 1}),
        ("anycase_prefix", "i(RESP*)", {scan: 1}),
        ("substring", '~"onnect"', {scan: 1}),
        ("time_stats", f"_time:[{lo}, {hi}) warn | stats by (_time:1h) "
                       f"count()", {scan: 1, count: 1}),
        ("stream_stats", '_stream:{app="app-3"} timeout | stats count()',
         {scan: 1, count: 1}),
        # sealed parts: the walk's maplet keeps quota's blocks alone, so
        # the leaf keeps every candidate and runs ungated
        ("bloom", "quota", {scan: 1}),
        ("count_all", "* | stats count()", {count: 1}),
        # BASELINE config 4 on one chip
        ("uniq_all", "* | stats count(), count_uniq(_stream_id)",
         {count: 1}),
        ("value_stats", "error | stats by (lvl) count(), sum(dur), "
                        "avg(dur), min(dur), max(dur), count(dur)",
         {scan: 1, values: 1}),
        ("time_uniq", f"_time:[{lo}, {hi}) | stats by (_time:1h, app) "
                      f"count(), count_uniq(host)", {count: 1}),
        ("quantile", "* | stats by (app) quantile(0.99, status) p99, "
                     "median(status) p50", {count: 1}),
        ("num_bucket", "warn | stats by (dur:1000) count(), sum_len(_msg), "
                       "count_empty(user)", {scan: 1, values: 1}),
        # BASELINE config 3 on one chip
        ("regex_pair", '~"error.*timeout"', {pair: 1}),
        # the literal run "quota " scanned, re.search on its rows
        ("regex_verify", '~"quota (GET|POST)"', {scan: 1}),
        ("regex_stats", '~"error.*timeout" | stats by (app) count()',
         {pair: 1, count: 1}),
    ]


def filter_queries(stream_id: str) -> list:
    """The filters' path on the main store: (name, LogsQL, {kernel:
    launches per device part}, whether a leaf falls back to the host).
    `stream_id` names one stream of the store."""
    scan, count = "match_scan", "stats_count_seg"
    return [
        ("range_stats", "status:>=500 | stats by (app) count()",
         {count: 1}, False),
        ("range_rows", "error dur:range[1000, 2000)", {scan: 1}, False),
        ("in_stats", "lvl:in(error, warn) | stats by (app, lvl) count()",
         {scan: 2, count: 1}, False),
        ("len_stats", "user:len_range(6, 8) | stats count()", {count: 1},
         False),
        # the stream's blocks alone are candidates
        ("stream_id_rows", f"_stream_id:{stream_id} error", {scan: 1},
         False),
        ("stream_id_stats", f"(_stream_id:{stream_id} or status:>=500) "
                            f"| stats by (app) count()", {count: 1}, False),
        # the float range runs on the host, the scan on the card
        ("fallback_rows", "error lat:>99.9", {scan: 1}, True),
        # and string_range; the matched rows reduced on the card
        ("fallback_stats", 'error user:string_range("user-1", "user-2") '
                           '| stats by (app) count()', {scan: 1, count: 1},
         True),
    ]


def slice_queries() -> list:
    """The pipes' path on the main store: (name, LogsQL, {kernel:
    launches per device part}, whether the top-k prefilter runs).  The
    store's parts are sealed: `quota`'s maplet leaves the walk quota's
    blocks alone, which its scan runs over ungated."""
    scan = "match_scan"
    return [
        ("topk_desc", "error | sort by (dur) desc limit 10", {scan: 1},
         True),
        ("topk_first", "error | first 5 by (dur)", {scan: 1}, True),
        ("topk_gated", "quota | last 3 by (dur)", {scan: 1}, True),
        # host pipes behind the narrow `quota`
        ("uniq_rows", "quota | uniq by (app, lvl) with hits", {scan: 1},
         False),
        ("where_stats", "quota | where dur:>1000 | stats by (app) count()",
         {scan: 1}, False),
        ("copy_rows", "quota | copy app as app2 | rename lvl as level "
                      "| delete user | limit 1000", {scan: 1}, False),
    ]


def filter_index_queries() -> tuple:
    """The filter index phase's queries, (name, LogsQL, {kernel:
    launches per device part}, the runner counter that must move):
    on the main store, an AND leaf the maplets prune and an `or` and a
    NOT leaf behind the split-block gate; on the sealed path store, the
    pair's AND leaf (pruned, ungated) and two pairs under `or` (the
    split-block gated pair)."""
    scan, count = "match_scan", "stats_count_seg"
    sbscan, sbpair = "match_scan_gated_sb", "match_pair_gated_sb"
    main = [
        ("fi_maplet", "quota | stats by (app) count()",
         {scan: 1, count: 1}, "maplet_pruned_blocks"),
        ("fi_sb_not", "error !quota | stats count()",
         {scan: 1, sbscan: 1, count: 1}, "maplet_probes"),
        ("fi_sb_or", '(quota or _stream:{app="app-7"}) | stats by (app) '
                     'count()', {sbscan: 1, count: 1}, "maplet_probes"),
    ]
    path = [
        ("fi_pair_and", PATH_QUERY + " | stats by (app) count()",
         {"match_pair": 1, count: 1}, "maplet_pruned_blocks"),
        ("fi_sb_pair_or", f'({PATH_QUERY} or ~"/api/v1/users.*ok") '
                          f'| stats by (app) count()',
         {sbpair: 2, count: 1}, "maplet_probes"),
    ]
    return main, path


def filter_index_sidecars(storage) -> list:
    """Each file part's filterindex.bin: its bytes, and that the port's
    loader accepts it (a split-block plane and an xor aggregate for
    `_msg`)."""
    from victorialogs_tpu_torch.storage.filterindex import (
        FILTERINDEX_FILENAME, part_index)
    out = []
    for pt in storage.partitions.values():
        for p in pt.parts:
            fi = part_index(p)
            if fi is None or not (fi.has_sb("_msg") and fi.covers("_msg")):
                fail(f"filter index: part {p.path} has no valid "
                     f"{FILTERINDEX_FILENAME} with a `_msg` column")
            out.append({"part": os.path.basename(p.path),
                        "rows": p.num_rows, "blocks": p.num_blocks,
                        "bytes": os.path.getsize(os.path.join(
                            p.path, FILTERINDEX_FILENAME)),
                        "columns": sorted(fi.cols)})
    return out


def filter_index_path(storage, tenants, runner, wrappers, flushes) -> dict:
    """The filter index on the reopened main store and on a sealed copy
    of the gated pair's path store: every part directory holds a
    filterindex.bin that loads (`filter_index_sidecars`; the seconds
    each flush sealed it from `flushes`), and each `filter_index_queries`
    query, its launch counts zeroed first, equals the host executor and
    the VL_FILTER_INDEX=v1 answer with each part on the card, launches
    its listed kernels a part and no other, and moves its counter."""
    import torch
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           today_start_ns)
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    t_phase = time.perf_counter()
    fig = {"sidecars": filter_index_sidecars(storage),
           "seals": [sl for f in flushes for sl in f["seals"]]}
    log(f"filter index: sidecars {fig['sidecars']}; sealed at the flushes "
        f"in {[round(sl['filter_index']['build_s'], 3) for sl in fig['seals']]}"
        f" s")
    pdir = tempfile.mkdtemp(prefix="vl_smoke_paths_")
    atexit.register(shutil.rmtree, pdir, True)
    pstore, pfig = store_by_route("rows", [path_rows(
        PATH_ROWS, 12, today_start_ns(), NS_PER_DAY // 2)], path=pdir)
    fig["path_store_seals"] = pfig["flushes"][0]["seals"]
    fig["sidecars"] += filter_index_sidecars(pstore)
    prunner = TorchBatchRunner(device="cuda")
    main_qs, path_qs = filter_index_queries()
    fig["queries"] = []
    for st, r, qs in ((storage, runner, main_qs), (pstore, prunner, path_qs)):
        parts = r.stats_counters
        for name, q, kernels, moves in qs:
            want = run_query_collect(st, tenants, q)
            for w in wrappers:
                w.launches = 0
            before = launch_counts(wrappers, parts)
            t0 = time.perf_counter()
            got = run_query_collect(st, tenants, q, runner=r)
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t0
            dev_parts = check_launches(f"filter index {name}", wrappers,
                                       parts, before, kernels)
            moved = parts[moves] - before[moves]
            launched = {w.__name__: w.launches - before[w.__name__]
                        for w in wrappers}
            os.environ["VL_FILTER_INDEX"] = "v1"
            try:
                v1 = run_query_collect(st, tenants, q, runner=r)
            finally:
                del os.environ["VL_FILTER_INDEX"]
            if got != want or v1 != want or not want or not moved:
                fail(f"filter index {name}: {len(got)} rows on the card, "
                     f"{len(v1)} with v1, {len(want)} from the host "
                     f"executor; {moves} moved {moved}")
            fig["queries"].append({
                "name": name, "query": q, "rows_out": len(got),
                "device_parts": dev_parts, "device_s": t_dev, moves: moved,
                "launches": launched})
            log(f"filter index {name}: {len(got)} rows from {dev_parts} "
                f"device parts, equal to the host executor and to v1; "
                f"{moves} {moved}; launches {fig['queries'][-1]['launches']}"
                f"; {t_dev:.3f} s on the card (cold)")
    prunner.close()
    pstore.close()
    fig["phase_s"] = time.perf_counter() - t_phase
    return fig


NEEDLE_ROWS = 2_000           # rows of the batch the part kill adds
NEEDLE = "needle"             # a word no other part of the store holds


def filter_index_kill(storage, tenants, start) -> dict:
    """After the force merge: the merged part's filterindex.bin loads
    (its seal's seconds from the datadb); a batch of NEEDLE_ROWS rows,
    every 50th mentioning NEEDLE, is added and flushed with the batch
    the result cache phase left (one new sealed part); a query for
    NEEDLE through a fresh runner then kills the merged part by its xor
    aggregate (`agg_pruned_parts` 1, the span's artifact
    `xor_aggregate`), stages nothing of it, and equals the host
    executor; then the same query, cold through a fresh runner with
    VL_FILTER_INDEX=v1 (the merged part's bloom folds the only part
    aggregate left), is timed beside it and equals it."""
    import torch
    from victorialogs_tpu_torch.cli.vlogsgenerator import generate
    from victorialogs_tpu_torch.engine.searcher import run_query_collect
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.storage.log_rows import LogRows
    t_phase = time.perf_counter()
    (merged,) = [p for pt in storage.partitions.values() for p in pt.parts]
    fig = {"merged": filter_index_sidecars(storage),
           "merge_seal": [sl for sl in seals(storage) if sl["merge"]]}
    lr = LogRows(stream_fields=INGEST_STREAM_FIELDS)
    for k, (ts, fields) in enumerate(generate(
            NEEDLE_ROWS, 19, start + 15 * 3600 * 10**9, 3600 * 10**9)):
        if k % 50 == 0:
            fields = [("_msg", f"{NEEDLE} {fields[0][1]}")] + fields[1:]
        lr.add(tenants[0], ts, fields)
    storage.must_add_rows(lr)
    t0 = time.perf_counter()
    storage.debug_flush()
    fig["flush_s"] = time.perf_counter() - t0
    fig["flush_seal"] = seals(storage)[-1]
    fig["sidecars"] = filter_index_sidecars(storage)
    q = f"{NEEDLE} | stats by (app) count()"
    want = run_query_collect(storage, tenants, q)
    runner = TorchBatchRunner(device="cuda")
    root = tracing.make_root("query", query=q)
    t0 = time.perf_counter()
    with tracing.activate(root):
        got = run_query_collect(storage, tenants, q, runner=runner)
        torch.cuda.synchronize()
    fig["device_s"] = time.perf_counter() - t0
    c = runner.stats_counters
    staged = runner.cache.part_uids()
    trace = cold_counters(root)
    tree = root.to_dict()
    artifacts = set()

    def walk(sp):
        a = sp.get("attrs", {}).get("last_aggregate_prune_artifact")
        if a:
            artifacts.add(a)
        for ch in sp.get("children", ()):
            walk(ch)

    walk(tree)
    runner.close()
    nrows = sum(int(r["count(*)"]) for r in want)
    if got != want or nrows != NEEDLE_ROWS // 50 or \
            c["agg_pruned_parts"] != 1 or merged.uid in staged or \
            artifacts != {"xor_aggregate"} or c["device_parts"] != 1:
        fail(f"filter index: the part kill: {got} against {want}, "
             f"counters {c}, staged {staged} (merged part {merged.uid}), "
             f"artifacts {artifacts}")
    # the same cold query without the filter index: the part aggregate
    # left is the merged part's bloom folds
    os.environ["VL_FILTER_INDEX"] = "v1"
    try:
        runner = TorchBatchRunner(device="cuda")
        root = tracing.make_root("query", query=q)
        t0 = time.perf_counter()
        with tracing.activate(root):
            v1 = run_query_collect(storage, tenants, q, runner=runner)
            torch.cuda.synchronize()
        fig["v1_device_s"] = time.perf_counter() - t0
        c1 = runner.stats_counters
        fig["v1_counters"] = {k: c1[k] for k in ("agg_pruned_parts",
                                                 "device_parts")}
        fig["v1_trace"] = cold_counters(root)
        runner.close()
    finally:
        del os.environ["VL_FILTER_INDEX"]
    if v1 != want:
        fail(f"filter index: the part kill: the v1 answer {v1} differs")
    fig.update(rows=nrows, counters={k: c[k] for k in (
        "agg_pruned_parts", "device_parts", "maplet_probes",
        "maplet_pruned_blocks")}, trace=trace,
        phase_s=time.perf_counter() - t_phase)
    log(f"filter index: the part kill: {q!r} killed the merged part of "
        f"{merged.num_rows} rows by its xor aggregate (staged only "
        f"{len(staged)} part), {nrows} rows counted, equal to the host "
        f"executor; the flush of the new batch took {fig['flush_s']:.3f} s "
        f"(sealed in {fig['flush_seal']['filter_index']['build_s']:.3f} s); "
        f"cold on the card {fig['device_s']:.4f} s, trace {json.dumps(trace)}"
        f"; the same cold query with VL_FILTER_INDEX=v1 "
        f"{fig['v1_device_s']:.4f} s, {fig['v1_counters']}, trace "
        f"{json.dumps(fig['v1_trace'])}")
    return fig


HITS_ARGS = {"query": "error", "step": "1h", "field": "app"}
RANGE_ARGS = {"query": "error | stats by (app) count()", "step": "1h"}


def handler_answers(storage, runner, wrappers, timed) -> list:
    """/select/logsql/hits and /select/logsql/stats_query_range, each
    held against the same handler with no runner and answered through
    the default runner: one scan and one count launch a part."""
    from victorialogs_tpu_torch.server.vlselect import (
        handle_hits, handle_stats_query_range)
    out = []
    for label, fn, args, size in (
            ("api_hits", handle_hits, HITS_ARGS,
             lambda a: sum(len(g["values"]) for g in a["hits"])),
            ("api_range", handle_stats_query_range, RANGE_ARGS,
             lambda a: sum(len(s["values"])
                           for s in a["data"]["result"]))):
        t0 = time.perf_counter()
        want = fn(storage, dict(args), {}, runner=None)
        t_host = time.perf_counter() - t0
        check_default_runner(label, storage, want,
                             lambda: fn(storage, dict(args), {}))
        before = launch_counts(wrappers, runner.stats_counters)
        got = fn(storage, dict(args), {}, runner=runner)
        check_launches(label, wrappers, runner.stats_counters, before,
                       {"match_scan": 1, "stats_count_seg": 1})
        if got != want or not size(got):
            fail(f"{label}: the answer differs from the handler's with no "
                 f"runner")
        p50 = timed(lambda: fn(storage, dict(args), {}, runner=runner),
                    WARM_RUNS)
        log(f"answer {label}: {size(got)} samples, p50 {p50:.4f} s, host "
            f"executor {t_host:.3f} s")
        out.append({"query": f"{label} {json.dumps(args)}",
                    "rows_out": size(got), "host_s": t_host,
                    f"{label}_p50_s": p50})
    return out


PATH_ROWS = 65_536            # rows of the gated pair's store, one flush
PATH_QUERY = '~"/api/v1/users.*timeout"'   # bloom tokens `api`, `v1`
# request-path messages of apps 0 and 1: A then B, A alone, B before A,
# a newline inside and at the end, no gap between A and B, A twice
PATH_MSGS = ("GET /api/v1/users/{n} timeout", "GET /api/v1/users/{n} ok",
             "timeout GET /api/v1/users/{n}",
             "POST /api/v1/users/{n}\ntimeout",
             "GET /api/v1/users/{n} timeout\n",
             "PUT /api/v1/users/{n}timeout",
             "/api/v1/users/{n} timeout /api/v1/users/{n}")
LONG_PAD = "pad " * 520       # past the widest staged row: a truncated value


def path_rows(n: int, seed: int, start: int, span: int, streams: int = 64,
              long_every: int = 199) -> list:
    """n generated rows (cli/vlogsgenerator.generate) whose `_msg`, in
    the streams of apps 0 and 1 only, is one of PATH_MSGS (every
    long_every-th of them behind LONG_PAD), so that the bloom tokens of
    PATH_QUERY rule the other streams' blocks out."""
    from victorialogs_tpu_torch.cli.vlogsgenerator import generate
    out = []
    k = 0
    for ts, fields in generate(n, seed, start, span, streams=streams):
        if fields[1][1] in ("app-0", "app-1"):
            msg = PATH_MSGS[k % len(PATH_MSGS)].format(n=k)
            if k % long_every == long_every - 1:
                msg = LONG_PAD + msg
            fields = [("_msg", msg)] + fields[1:]
            k += 1
        out.append((ts, fields))
    return out


def path_queries() -> list:
    """The gated pair's path on the `path_rows` store, as `queries`."""
    gpair = "match_pair_gated"
    return [("regex_gated_pair", PATH_QUERY, {gpair: 1}),
            ("regex_gated_stats", PATH_QUERY + " | stats by (app) count()",
             {gpair: 1, "stats_count_seg": 1})]


def transform_queries() -> list:
    """The transform path on the routes' jsonline store: (name, LogsQL,
    {kernel: launches per device part}); None where a pipe's own queries
    (join, union, stream_context) add device parts of other shapes.
    Every query's pipes run on the host, its filter on the card."""
    scan, gscan = "match_scan", "match_scan_gated"
    return [
        ("extract_stats", 'error | extract "error <w> " '
                          '| stats by (w) count() c', {scan: 1}),
        ("unpack_json", "error | pack_json fields (lvl, dur, app) as j "
                        "| unpack_json from j result_prefix u_ "
                        "| stats by (u_lvl, u_app) count() c", {scan: 1}),
        ("math", "error | math dur * 2 + 1 as d2, round(lat) as rl "
                 "| stats by (rl) count() c, sum(d2) s", {scan: 1}),
        ("format", 'quota | format "<lvl>:<uc:app> <dur>" as line '
                   '| fields line', {gscan: 1}),
        ("top", "error | top 5 by (app)", {scan: 1}),
        ("facets", "quota | facets 3", {gscan: 1}),
        ("stats_if", "error | stats by (app) count() if (lvl:error) e, "
                     "count() total, sum(dur) if (status:200) s",
         {scan: 1}),
        ("stats_month", "error | stats by (_time:month, lvl) count() c",
         {scan: 1}),
        ("stats_host_funcs", "quota | stats by (app) histogram(status) h, "
                             "values(lvl) limit 5 v, row_max(dur) rm",
         {gscan: 1}),
        ("collapse_nums", 'timeout | format "<dur>.<status> took <lat>s" '
                          'as v | collapse_nums at v prettify '
                          '| stats by (v) count() c', {scan: 1}),
        ("join", "error | join by (app) (quota | stats by (app) count() "
                 "quota_hits) | stats by (app, quota_hits) count() c",
         None),
        ("union", "error lvl:error | fields _msg, app | union (quota "
                  "lvl:debug | fields _msg, app) | stats by (app) count() c",
         None),
        ("stream_context", "quota lvl:error dur:<100 | stream_context "
                           "before 2 after 1 | fields _time, _msg, app",
         None),
    ]


UNFLUSHED_ROWS = 20_000       # rows of the transform path's unflushed batch
TRANSFORM_BUSY_RUNS = 5       # warm runs in a transform query's profiled window


def transform_path(rstore, tenants, wrappers, kernel_names) -> tuple:
    """The transform path: each of `transform_queries` on the routes'
    jsonline store through the store's default runner on the card
    (vlselect.card_runner), a cold run and one warm answer held against
    the host executor, every part on the card; then `* | stats count()`
    on a store whose one batch was never flushed, which must count every
    row added.  (report rows, launches by kernel)."""
    import torch
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           generate,
                                                           today_start_ns)
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.server.vlselect import card_runner
    from victorialogs_tpu_torch.storage.log_rows import LogRows
    from victorialogs_tpu_torch.storage.storage import Storage
    for w in wrappers:
        w.launches = 0
    report = []

    def one(name, storage, q, kernels, want_rows=None):
        runner = card_runner(storage)
        parts = runner.stats_counters
        t0 = time.perf_counter()
        want = run_query_collect(storage, tenants, q, runner=None)
        t_host = time.perf_counter() - t0

        def warm_run():
            run_query(storage, tenants, q, lambda br: None, runner=runner)

        before = launch_counts(wrappers, parts)
        t0 = time.perf_counter()
        warm_run()
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        if kernels is not None:
            dev_parts = check_launches(f"transform {name}", wrappers, parts,
                                       before, kernels)
        else:
            dev_parts = parts["device_parts"] - before["device_parts"]
            if parts["host_parts"] != before["host_parts"] or \
                    dev_parts < 1 or not any(
                        w.launches > before[w.__name__] for w in wrappers):
                fail(f"transform {name}: {dev_parts} parts on the card, "
                     f"{parts['host_parts'] - before['host_parts']} on "
                     f"the host, no launch")
        t0 = time.perf_counter()
        got = run_query_collect(storage, tenants, q, runner=runner)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        if got != want or not want or (want_rows is not None and
                                       got != want_rows):
            fail(f"transform {name}: {len(got)} rows on the card, "
                 f"{len(want)} from the host executor")
        # a one-part run's few launches can come back empty from the
        # profiler: one window over TRANSFORM_BUSY_RUNS runs, per run
        wall, busy = busy_share(lambda: [warm_run() for _ in
                                         range(TRANSFORM_BUSY_RUNS)])
        wall /= TRANSFORM_BUSY_RUNS
        busy = None if busy is None else busy / TRANSFORM_BUSY_RUNS
        row = {"query": q, "rows_out": len(got), "device_parts": dev_parts,
               "host_s": t_host, "device_cold_s": t_cold,
               "device_collect_p50_s": t_warm, "profiled_wall_s": wall,
               "device_busy_s": busy, "phase": "transform"}
        log(f"transform {name}: {len(got)} rows from {dev_parts} device "
            f"parts, equal to the host executor ({t_host:.3f} s); device "
            f"cold {t_cold:.3f} s (no rows built), warm {t_warm:.3f} s "
            f"with rows built; profiled warm runs {wall * 1e3:.2f} ms "
            f"wall a run, device busy a run "
            f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}")
        report.append(row)

    for name, q, kernels in transform_queries():
        one(name, rstore, q, kernels)
    # a batch added and never flushed: an in-memory part on the card
    ustore = Storage(device="cuda")
    lr = LogRows(stream_fields=INGEST_STREAM_FIELDS)
    for ts, fields in generate(UNFLUSHED_ROWS, 17, today_start_ns(),
                               NS_PER_DAY // 2):
        lr.add(tenants[0], ts, fields)
    ustore.must_add_rows(lr)
    (upt,) = ustore.partitions.values()
    if len(upt._pending) != 1 or upt.parts:
        fail("the unflushed store's batch was flushed")
    one("unflushed_count", ustore, "* | stats count() c",
        {"stats_count_seg": 1}, [{"c": str(UNFLUSHED_ROWS)}])
    card_runner(ustore).close()
    ustore.close()
    card_runner(rstore).close()
    return report, {n: w.launches for n, w in zip(kernel_names, wrappers)}


PACK_DAYS = 4                 # UTC days of the packed path's store
PACK_PART_ROWS = 8192         # rows of each of its bodies and parts
PACK_FLUSHED = 32             # flushed parts a day
PACK_UNFLUSHED = (8, 5, 3, 1)  # batches a day never flushed
PACK_SETTINGS = (("1", "1"), ("4", "8"))   # (VL_INFLIGHT, VL_PACK_PARTS)
PACK_WARM_RUNS = 3            # timed warm runs a query and setting


def packed_queries() -> list:
    """(name, LogsQL, {kernel: launches per dispatch unit}) of the packed
    path, each over the store's four days: the main row, stats,
    value-stats, sort and count families, and the quantile shape whose
    2,440 cells a member put a pack's count past the shared bins."""
    scan, count, values = "match_scan", "stats_count_seg", "stats_values"
    return [
        ("pk_bloom", "_time:4d quota", {"match_scan_gated": 1}),
        ("pk_time_stats", "_time:4d error | stats by (_time:1h) count()",
         {scan: 1, count: 1}),
        ("pk_value_stats", "_time:4d error | stats by (lvl) count(), "
                           "sum(dur), avg(dur), min(dur), max(dur)",
         {scan: 1, values: 1}),
        ("pk_sort", "_time:4d error | sort by (dur) desc limit 10",
         {scan: 1}),
        ("pk_count", "_time:4d | stats count()", {count: 1}),
        ("pk_quantile", "_time:4d | stats by (app) quantile(0.99, status) "
                        "p99, median(status) p50", {count: 1}),
    ]


def packed_store(tenants):
    """PACK_DAYS UTC days before today, each of PACK_FLUSHED flushed
    parts and then PACK_UNFLUSHED[d] batches never flushed, every one
    PACK_PART_ROWS generator rows sent as a /insert/jsonline body (a
    flush after each flushed one; the days' unflushed bodies after every
    flush).  The bodies are made in 4 processes.  (storage, the end of
    the last day, figures)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           today_start_ns)
    from victorialogs_tpu_torch.server import insertutil, vlinsert
    from victorialogs_tpu_torch.storage.storage import Storage
    end = today_start_ns()
    slot = NS_PER_DAY // (PACK_FLUSHED + max(PACK_UNFLUSHED))
    plan = []                 # (flush after it, start ns)
    for d in range(PACK_DAYS):
        day = end - (PACK_DAYS - d) * NS_PER_DAY
        plan += [(True, day + j * slot) for j in range(PACK_FLUSHED)]
    for d in range(PACK_DAYS):
        day = end - (PACK_DAYS - d) * NS_PER_DAY
        plan += [(False, day + (PACK_FLUSHED + j) * slot)
                 for j in range(PACK_UNFLUSHED[d])]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=4,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        bodies = list(ex.map(
            flush_body, ["jsonline"] * len(plan),
            [PACK_PART_ROWS] * len(plan), range(100, 100 + len(plan)),
            [st for _f, st in plan], [slot] * len(plan), chunksize=8))
    setup_s = time.perf_counter() - t0
    storage = Storage(device="cuda")
    cp = insertutil.CommonParams(tenant=tenants[0],
                                 stream_fields=INGEST_STREAM_FIELDS)
    t0 = time.perf_counter()
    for (flush, _st), body in zip(plan, bodies):
        lmp = insertutil.LogMessageProcessor(
            cp, insertutil.LocalLogRowsStorage(storage))
        if vlinsert.handle_jsonline(cp, body, lmp) != PACK_PART_ROWS:
            fail("the packed store's body lost rows")
        lmp.flush()
        if flush:
            storage.debug_flush()
    fig = {"route": "jsonline", "store": "packed",
           "rows": PACK_PART_ROWS * len(plan),
           "body_bytes": sum(map(len, bodies)), "setup_s": setup_s,
           "ingest_s": time.perf_counter() - t0}
    for d, pt in enumerate(sorted(storage.partitions.values(),
                                  key=lambda p: p.day)):
        if [p.num_rows for p in pt.parts] != [PACK_PART_ROWS] * \
                PACK_FLUSHED or [p.num_rows for p in pt._pending] != \
                [PACK_PART_ROWS] * PACK_UNFLUSHED[d]:
            fail(f"the packed store's day {d} is not {PACK_FLUSHED} "
                 f"flushed parts and {PACK_UNFLUSHED[d]} batches")
    return storage, end, fig


def packed_path(tenants, wrappers, kernel_names) -> tuple:
    """The packed path: each of `packed_queries` on the packed store
    through its default runner (vlselect.card_runner) at each of
    PACK_SETTINGS, VL_INFLIGHT/VL_PACK_PARTS 1/1 being the serial walk.
    At each setting a first run, its units, packed units and launches
    (each kernel its listed times a unit: P packable parts in a run of
    one pad bucket cost ceil(P/8) units), its rows held against the host
    executor (`host_parts` 0) and, at 4/8, against the 1/1 rows in
    order (the row query's NDJSON export byte for byte); then the warm
    p50 without rows, one profiled run's device-busy time and one traced
    run's span totals.  Then the kernels at the pack shapes.  (report
    rows, launches by kernel, pack-shape kernel rows, figures)."""
    import os
    import torch
    from victorialogs_tpu_torch.engine.emit import ndjson_block
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.gpu.pipeline import iter_pack_groups
    from victorialogs_tpu_torch.obs import tracing
    from victorialogs_tpu_torch.server.vlselect import card_runner
    t0 = time.perf_counter()
    storage, end, fig = packed_store(tenants)
    log(f"packed store: {fig['rows']} rows in {fig['body_bytes']} B of "
        f"JSON lines over {PACK_DAYS} days: bodies made in "
        f"{fig['setup_s']:.2f} s, ingested in {fig['ingest_s']:.2f} s")
    runner = card_runner(storage)
    parts = [p for _d, pt in sorted(storage.partitions.items())
             for p in pt.snapshot_parts()]
    groups = [len(g) for g in iter_pack_groups(
        ((p,) for p in parts), True, 8, 1 << 14)]
    log(f"packed store: {len(parts)} parts of {PACK_PART_ROWS} rows in "
        f"walk order ({sum(PACK_UNFLUSHED)} never flushed); packs at 4/8: "
        f"{groups} ({len(groups)} units; ceil(P/8) = "
        f"{-(-len(parts) // 8)})")
    counters = runner.stats_counters
    for w in wrappers:
        w.launches = 0
    report = []
    for name, q, kernels in packed_queries():
        t1 = time.perf_counter()
        want = run_query_collect(storage, tenants, q, timestamp=end)
        t_host = time.perf_counter() - t1
        if not want:
            fail(f"packed {name}: no rows")
        row = {"query": q, "rows_out": len(want), "host_s": t_host,
               "phase": "packed", "parts": len(parts)}
        serial = None
        for inflight, pack in PACK_SETTINGS:
            os.environ["VL_INFLIGHT"] = inflight
            os.environ["VL_PACK_PARTS"] = pack
            tag = f"{inflight}/{pack}"
            before = launch_counts(wrappers, counters)
            t1 = time.perf_counter()
            got = run_query_collect(storage, tenants, q, timestamp=end,
                                    runner=runner)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t1
            ran = {k: counters[k] - before[k] for k in
                   ("units", "packed_units", "packed_parts",
                    "device_parts", "host_parts")}
            launched = {w.__name__: w.launches - before[w.__name__]
                        for w in wrappers}
            want_units = len(parts) if pack == "1" else len(groups)
            if ran["host_parts"] or ran["device_parts"] != len(parts) or \
                    ran["units"] != want_units or any(
                        n != kernels.get(k, 0) * want_units
                        for k, n in launched.items()):
                fail(f"packed {name} at {tag}: {ran}, launches {launched}, "
                     f"want {want_units} units of {kernels}")
            if got != want:
                fail(f"packed {name} at {tag}: {len(got)} rows differ from "
                     f"the host executor's {len(want)}")
            if serial is not None and got != serial:
                fail(f"packed {name} at {tag}: rows differ from the serial "
                     f"walk's")
            serial = got

            def warm_run(q=q):
                run_query(storage, tenants, q, lambda br: None,
                          timestamp=end, runner=runner)

            if "stats" not in q and "sort" not in q:
                chunks = []
                run_query(storage, tenants, q,
                          lambda br: chunks.append(ndjson_block(br)),
                          timestamp=end, runner=runner)
                if b"".join(chunks) != ndjson_lines(want):
                    fail(f"packed {name} at {tag}: the NDJSON export "
                         f"differs from the host executor's rows")
            p50 = statistics.median(
                [_wall(warm_run) for _ in range(PACK_WARM_RUNS)])
            wall, busy = busy_share(warm_run)
            root = tracing.make_root("query", query=q)
            with tracing.activate(root):
                warm_run()
                torch.cuda.synchronize()
            spans = root.flatten()
            sync_s = sum(h.get("attrs", {}).get("host_sync_wait_s", 0.0)
                         for h in _spans(root.to_dict(), "device_sync"))
            row[tag] = {
                "first_run_s": t_first, "units": ran["units"],
                "packed_units": ran["packed_units"],
                "packed_parts": ran["packed_parts"], "launches": launched,
                "device_p50_s": p50, "profiled_wall_s": wall,
                "device_busy_s": busy,
                "span_ms": {k: spans.get(k, {}).get("total_ms", 0.0)
                            for k in ("query", "partition", "prune", "stage",
                                      "submit", "harvest", "device_sync",
                                      "emit")},
                "host_sync_wait_ms": sync_s * 1e3}
            log(f"packed {name} at {tag}: {len(got)} rows, {ran['units']} "
                f"units ({ran['packed_units']} packed, of "
                f"{ran['packed_parts']} parts) for {ran['device_parts']} "
                f"parts, launches {launched}; first run {t_first:.4f} s, "
                f"warm p50 {p50:.4f} s without rows, device busy "
                f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}"
                f" of {wall * 1e3:.2f} ms; traced run's spans (ms) "
                f"{row[tag]['span_ms']}, waits on events "
                f"{sync_s * 1e3:.3f} ms")
        log(f"packed {name}: answers equal at both settings and to the "
            f"host executor ({t_host:.3f} s)")
        report.append(row)
    launches = {n: w.launches for n, w in zip(kernel_names, wrappers)}
    os.environ.pop("VL_INFLIGHT")
    os.environ.pop("VL_PACK_PARTS")
    first_day = storage.partitions[min(storage.partitions)]
    kern = pack_kernel_rows(runner, first_day.parts[:8], end, launches)
    runner.close()
    storage.close()
    fig["phase_s"] = time.perf_counter() - t0
    return report, launches, kern, fig


def _wall(fn) -> float:
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _spans(tree: dict, name: str) -> list:
    out = [tree] if tree.get("name") == name else []
    for c in tree.get("children", ()):
        out += _spans(c, name)
    return out


def pack_kernel_rows(runner, members, end, launches) -> dict:
    """The count and the value reduction at the pack shapes, on one pack
    of 8 flushed parts as the packed path stages it: the count at
    `pk_quantile`'s 8 x 2,440 cells (past the count's shared bins) with
    its segment axis, the value reduction at `pk_value_stats`'s member-
    folded cells; each held against its plain version, timed beside its
    bound and a PyTorch yardstick.  {kernel name: row}."""
    import torch
    from victorialogs_tpu_torch.engine.block_search import BlockSearch
    from victorialogs_tpu_torch.gpu.fused import eval_node
    from victorialogs_tpu_torch.gpu.kernels import combine_ids
    from victorialogs_tpu_torch.gpu.stats_device import with_segment_axis
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_count_seg,
                                                      stats_count_seg_plain,
                                                      stats_values,
                                                      stats_values_plain)
    from victorialogs_tpu_torch.logsql.parser import parse_query
    pack = runner.get_pack(members)
    qtext = {n: q for n, q, _k in packed_queries()}
    out = {}

    def inputs(qname):
        pq = parse_query(qtext[qname], end)
        spec = with_segment_axis(runner.stats_spec(pq))
        asm = runner._assemble_axes(pack, spec)
        bss = {bi: BlockSearch(pack, bi) for bi in range(pack.num_blocks)}
        tree, args, layout, _m, cand = runner._program(pq.filter, pack, bss)
        d, _m = eval_node(tree, args, layout.nrows_padded, runner.device)
        return spec, asm, d & cand

    def row(name, src, replaces, got, want, fn, plain, lib, nbytes, ops,
            **extra):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            fail(f"{name} at the pack shape differs from its plain version "
                 f"(max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        ms, timing = timed_ms(fn, 50, {"stats_count_seg": "count_",
                                       "stats_values": "values_"}[name],
                              b_ms)
        pms, _pt = timed_ms(plain, 5, floor_ms=b_ms)
        lms, _lt = timed_ms(lib, 50, floor_ms=b_ms)
        out[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lms, timing=timing,
            bound_bytes=nbytes, bound_operations=ops, **extra)
        log(f"kernel {name} at the pack shape {extra}: {ms} ms by {timing} "
            f"(plain {pms} ms, bound {b_ms} ms by {b_by}, library {lms} "
            f"ms), {launches[name]} launches on the packed path")

    _spec, asm, mask = inputs("pk_quantile")
    r = mask.numel()
    nseg, nb = asm.nseg, asm.nb // asm.nseg
    seg = asm.axes[0][1]
    base = combine_ids([a[1] for a in asm.axes[1:]], asm.strides[1:])
    a = (seg, base, mask, nseg, nb)
    folded = combine_ids([x[1] for x in asm.axes], asm.strides)
    maskf = mask.float()
    row("stats_count_seg", "victorialogs_tpu_torch/csrc/count.cu",
        "victorialogs_tpu/tpu/stats_seg.py:303", stats_count_seg(*a),
        stats_count_seg_plain(*a), lambda: stats_count_seg(*a),
        lambda: stats_count_seg_plain(*a),
        lambda: torch.bincount(folded, weights=maskf, minlength=nseg * nb),
        r * 9 + nseg * nb * 4, int(mask.sum()), query="pk_quantile",
        nseg=nseg, cells=nb, rows=r, masked_rows=int(mask.sum()))
    spec, asm, mask = inputs("pk_value_stats")
    cols = [asm.numerics[f].values for f in spec.value_fields]
    ids = combine_ids([x[1] for x in asm.axes], asm.strides)
    va = (cols, ids, mask, asm.nb)
    got = stats_values(*va)
    if not values_agree(got, values_library(*va)(), asm.nb):
        fail("stats_values at the pack shape: the PyTorch composition "
             "disagrees")
    row("stats_values", "victorialogs_tpu_torch/csrc/count.cu",
        "victorialogs_tpu/tpu/kernels.py:285", got, stats_values_plain(*va),
        lambda: stats_values(*va), lambda: stats_values_plain(*va),
        values_library(*va), *values_work(mask, asm.nb, len(cols)),
        query="pk_value_stats", nseg=asm.nseg, cells=asm.nb,
        columns=len(cols), rows=mask.numel(), masked_rows=int(mask.sum()))
    return out


def launch_counts(wrappers, parts) -> dict:
    """Every wrapper's launch count and the runner's part counters."""
    out = {w.__name__: w.launches for w in wrappers}
    out.update(parts)
    return out


def check_launches(what: str, wrappers, parts, before: dict,
                   kernels: dict, want_parts: int | None = None) -> int:
    """Fail unless the run since `before` ran its parts on the card
    (exactly `want_parts` when given) and launched each kernel its
    listed times a part and no other; returns the device parts."""
    dev_parts = parts["device_parts"] - before["device_parts"]
    host = parts["host_parts"] - before["host_parts"]
    if host or dev_parts < 1 or want_parts not in (None, dev_parts):
        fail(f"{what}: {dev_parts} parts on the card, {host} on the host"
             + ("" if want_parts is None else f", want {want_parts}"))
    for w in wrappers:
        n = w.launches - before[w.__name__]
        if n != kernels.get(w.__name__, 0) * dev_parts:
            fail(f"{what}: {w.__name__} launched {n} times for "
                 f"{dev_parts} device parts")
    return dev_parts


def ndjson_lines(rows: list) -> bytes:
    """The NDJSON of dict rows: a json.dumps line a row."""
    return "".join(json.dumps(r, ensure_ascii=False, separators=(",", ":"))
                   + "\n" for r in rows).encode("utf-8")


def row_answers(storage, tenants, name: str, q: str, want: list, runner,
                kernels: dict, wrappers, timed,
                limit_parts: int | None = 1,
                host_handler: bool = True) -> dict:
    """A row query's answers: the full NDJSON export (held against the
    host executor's rows serialized) and /select/logsql/query at its
    default limit (held against the same handler with no runner, on
    `limit_parts` device parts, any number when None, or where not
    `host_handler` against `want` serialized: the one block a sort
    writes); `phrase` also answers FIELDS_CASE, on as many parts."""
    from victorialogs_tpu_torch.engine.emit import ndjson_block
    from victorialogs_tpu_torch.engine.searcher import run_query
    from victorialogs_tpu_torch.server.vlselect import handle_query
    parts = runner.stats_counters

    def export() -> list:
        chunks = []
        run_query(storage, tenants, q,
                  lambda br: chunks.append(ndjson_block(br)), runner=runner)
        return chunks

    # one warm export, timed and held against the host executor
    exports = []
    p50 = timed(lambda: exports.append(b"".join(export())), 1)
    got = exports[0]
    if got != ndjson_lines(want):
        fail(f"query {name}: the NDJSON export differs from the host "
             f"executor's rows serialized")
    out = {"ndjson_p50_s": p50, "ndjson_bytes": len(got),
           "ndjson_rows_per_s": len(want) / p50}
    cases = [("api_query", q)]
    if name == "phrase":
        cases.append(("api_fields", q + FIELDS_CASE))
    for label, text in cases:
        args = {"query": text}
        want_chunks = handle_query(storage, args, {}, runner=None) \
            if host_handler else [ndjson_lines(want[:1000])]
        if label == "api_query":
            check_default_runner(f"{label} {name}", storage, want_chunks,
                                 lambda: handle_query(storage, args, {}))
        before = launch_counts(wrappers, parts)
        chunks = handle_query(storage, args, {}, runner=runner)
        out[f"{label}_parts"] = check_launches(
            f"{label} {name}", wrappers, parts, before, kernels,
            want_parts=limit_parts)
        if chunks != want_chunks:
            fail(f"{label} {name}: the answer differs from the handler's "
                 f"with no runner")
        out[f"{label}_p50_s"] = timed(
            lambda: handle_query(storage, args, {}, runner=runner),
            WARM_RUNS)
        out[f"{label}_bytes"] = sum(map(len, chunks))
    return out


EXTRA_FILTERS = '{"app": ["app-1", "app-2"]}'


def extra_filters_answer(storage, runner, wrappers, timed,
                         want_parts: int) -> dict:
    """/select/logsql/query on `error` with EXTRA_FILTERS (an `in` over
    the stream field `app`), held against the same handler with no
    runner: `want_parts` device parts (the window's first units), the
    two exact scans of the `in` and the phrase scan a part."""
    from victorialogs_tpu_torch.server.vlselect import handle_query
    args = {"query": "error", "extra_filters": EXTRA_FILTERS}
    want = handle_query(storage, dict(args), {}, runner=None)
    before = launch_counts(wrappers, runner.stats_counters)
    got = handle_query(storage, dict(args), {}, runner=runner)
    check_launches("api_query extra_filters", wrappers,
                   runner.stats_counters, before, {"match_scan": 3},
                   want_parts=want_parts)
    if got != want or not got:
        fail("api_query extra_filters: the answer differs from the "
             "handler's with no runner")
    return {"query": f"error, extra_filters={EXTRA_FILTERS}",
            "rows_out": sum(c.count(b"\n") for c in got),
            "api_query_bytes": sum(map(len, got)),
            "api_query_p50_s": timed(
                lambda: handle_query(storage, dict(args), {},
                                     runner=runner), WARM_RUNS)}


def check_default_runner(what: str, storage, want, answer) -> None:
    """A handler given no runner answers `want` through the storage's own
    runner on the card, all of its parts there."""
    from victorialogs_tpu_torch.server.vlselect import card_runner
    counters = card_runner(storage).stats_counters
    before = counters["device_parts"]
    if answer() != want:
        fail(f"{what}: the answer with the default runner differs from "
             f"the handler's with no runner")
    if card_runner(storage).device.type != "cuda" or \
            counters["device_parts"] == before or counters["host_parts"]:
        fail(f"{what}: the default runner did not answer on the card "
             f"({counters})")


def stats_answers(storage, name: str, q: str, now: str, runner,
                  kernels: dict, wrappers, timed) -> dict:
    """/select/logsql/stats_query of a stats query at `now`, held against
    the same handler with no runner, with the query's launches a part."""
    from victorialogs_tpu_torch.server.vlselect import handle_stats_query
    parts = runner.stats_counters
    args = {"query": q, "time": now}
    want = handle_stats_query(storage, args, {}, runner=None)
    check_default_runner(f"api_stats {name}", storage, want,
                         lambda: handle_stats_query(storage, args, {}))
    before = launch_counts(wrappers, parts)
    got = handle_stats_query(storage, args, {}, runner=runner)
    check_launches(f"api_stats {name}", wrappers, parts, before, kernels)
    if got != want or not got["data"]["result"]:
        fail(f"api_stats {name}: the answer differs from the handler's "
             f"with no runner")
    return {"api_stats_p50_s": timed(
        lambda: handle_stats_query(storage, args, {}, runner=runner),
        WARM_RUNS), "api_stats_samples": len(got["data"]["result"])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel checks and the sweeps "
                         "(bring-up runs)")
    args = ap.parse_args()
    # every phase but the result cache's measures the kernels: each run
    # recomputes every part
    os.environ["VL_RESULT_CACHE"] = "0"

    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "victorialogs_tpu_torch" / "csrc").is_dir():
        print("victorialogs_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from victorialogs_tpu_torch import native
    from victorialogs_tpu_torch.engine import emit
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.gpu import build
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.gpu.pipeline import inflight_depth
    from victorialogs_tpu_torch.gpu.bloom_device import (
        BloomGate, SbGate, keep_rows_plain, pad_probe_args, pad_sb_idx,
        plane_keep, plane_keep_plain, plane_keep_sb, plane_keep_sb_plain)
    from victorialogs_tpu_torch.gpu.stats_seg import (stats_count_seg,
                                                      stats_count_seg_plain,
                                                      stats_values,
                                                      stats_values_plain)
    from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY,
                                                           today_start_ns)
    from victorialogs_tpu_torch.logsql.duration import format_rfc3339
    from victorialogs_tpu_torch.native import ingest as native_ingest
    from victorialogs_tpu_torch.server import vlinsert
    from victorialogs_tpu_torch.storage.filterbank import bloom_plane
    from victorialogs_tpu_torch.storage.filterindex import part_index
    from victorialogs_tpu_torch.storage.log_rows import TenantID
    from victorialogs_tpu_torch.utils.hashing import hash_tokens
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    # the main store's bodies are made while the kernels build and are
    # checked (set-up, on the host's other cores)
    bodies = None if args.skip_main else start_bodies(
        "jsonline", ROWS, FLUSHES, seed=MAIN_SEED)

    # phase 1
    secs = build.build_all()
    log(f"build: {secs:.1f} s for {', '.join(build.SOURCES)} "
        f"({' '.join(build.NVCC_FLAGS)})")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {name}.cu {line.strip()}")
    secs = native.build()
    log(f"build: {secs:.1f} s for the NDJSON serializer native/emit.cpp "
        f"({native.CXX} {' '.join(native.CXX_FLAGS)})")
    secs = native_ingest.build()
    native_ingest.load()
    log(f"build: {secs:.1f} s for the ingest library native/ingest.cpp")

    # phase 2
    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    stats: dict = {}
    check_scan(rng, dev, stats)
    check_count(rng, dev, stats)
    check_probe(rng, dev, stats)
    check_edges(rng, dev, stats)
    check_gated(rng, dev, stats)
    check_values(rng, dev, stats)
    check_value_edges(rng, dev, stats)
    check_pair(rng, dev, stats)
    check_fold(rng, dev, stats)
    check_probe_sb(rng, dev, stats)
    check_gated_sb(rng, dev, stats)
    torch.cuda.synchronize()
    log(f"kernels vs plain (bit-identical): {stats} in "
        f"{time.perf_counter() - t_phase:.1f} s")
    if args.skip_main:
        log(json.dumps({"sweep": sweep(rng, dev) + gate_sweep(rng, dev)}))
        return 0

    # phase 3: the main store on disk, removed at exit (also on failure)
    store_dir = tempfile.mkdtemp(prefix="vl_smoke_store_")
    atexit.register(shutil.rmtree, store_dir, True)
    t0 = time.perf_counter()
    for k in vlinsert.INGEST_COUNTERS:
        vlinsert.INGEST_COUNTERS[k] = 0
    storage, start, nrows, fig = ingest_route("jsonline", ROWS, FLUSHES,
                                              seed=MAIN_SEED, path=store_dir,
                                              bodies=bodies)
    t_ingest = time.perf_counter() - t0
    counters = dict(vlinsert.INGEST_COUNTERS)
    log_ingest(fig, counters)
    for k, f in enumerate(fig["flushes"]):
        log(f"durable flush {k}: {f['rows']} rows written in "
            f"{f['write_s']:.2f} s, {f['compressed_bytes']} B compressed "
            f"of {f['uncompressed_bytes']} B")
    fig.update(counters, store="main")
    ingest_figs = [fig]
    main_parts = [p for pt in storage.partitions.values() for p in pt.parts]
    log(f"ingest: {nrows} rows, parts of "
        f"{[p.num_rows for p in main_parts]} rows in "
        f"{[p.num_blocks for p in main_parts]} blocks, {t_ingest:.1f} s")
    if [p.num_rows for p in main_parts] != [ROWS // FLUSHES] * FLUSHES or \
            [p.num_blocks for p in main_parts] != [64] * FLUSHES:
        fail(f"the main store is not {FLUSHES} parts of 1M rows in 64 "
             f"blocks each")
    if counters["py_chunks"]:
        fail(f"{counters['py_chunks']} chunks of the generator's bodies "
             f"were parsed in Python")
    tenants = [TenantID(0, 0)]
    t0 = time.perf_counter()
    storage, durable_before, durable, runner = durable_reopen(
        storage, store_dir, tenants, fig["rows"])
    durable["flushes"] = fig["flushes"]
    log(f"durable close, reopen and checks: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    route_figs, rstore = route_parity(seed=13)
    ingest_figs += route_figs
    log(f"ingest routes: {time.perf_counter() - t0:.1f} s")
    # units the dispatch window submits before its first harvest
    window = inflight_depth()
    # the kernels of the main path (its parts are sealed: the walk's
    # maplets leave AND-path leaves nothing to gate), then the gated
    # kernels, which run on paths of their own (below): the classic gates
    # on the memory stores, the split-block gates in the filter index
    # phase; and the standalone probes, which the planner never launches
    main_path = (K.match_scan, stats_count_seg, stats_values, K.match_pair)
    wrappers = main_path + (K.match_scan_gated, K.match_pair_gated,
                            K.match_scan_gated_sb, K.match_pair_gated_sb,
                            plane_keep, plane_keep_sb)
    parts = runner.stats_counters

    def timed(fn, runs: int) -> float:
        """Median wall seconds of `runs` calls, each ended by a sync."""
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    for w in wrappers:
        w.launches = 0
    emit.EMIT_COUNTERS["py_blocks"] = 0
    now = format_rfc3339(start + 13 * 3600 * 10**9)
    report = []
    twin_rows = None
    t0_queries = time.perf_counter()
    def drive(name: str, q: str, kernels: dict, host_handler: bool = True,
              want: list | None = None):
        """One query through every check and timing of phase 3: the host
        executor (unless `want` gives its rows already), a cold run (its
        launches checked) and a warm one held against it, warm p50s, a
        profiled run and its answers; (report row, result rows)."""
        t_host = None
        if want is None:
            t0 = time.perf_counter()
            want = run_query_collect(storage, tenants, q)
            t_host = time.perf_counter() - t0
        host_text = "shared" if t_host is None else f"{t_host:.3f} s"

        def warm_run(q=q):
            run_query(storage, tenants, q, lambda br: None, runner=runner)

        # the cold run stages what the query reads; then one warm run
        # builds the rows held against the host executor
        before = launch_counts(wrappers, parts)
        t0 = time.perf_counter()
        warm_run()
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        dev_parts = check_launches(f"query {name}", wrappers, parts, before,
                                   kernels)
        scanned = parts["device_rows"] - before["device_rows"]
        t0 = time.perf_counter()
        got = run_query_collect(storage, tenants, q, runner=runner)
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        if got != want:
            fail(f"query {q!r}: device result differs from the host "
                 f"executor ({len(got)} vs {len(want)} rows)")
        p50 = timed(warm_run, WARM_RUNS)
        wall, busy = busy_share(warm_run)
        idle = None if busy is None else 1 - busy / wall
        row = {"query": q, "rows_out": len(got),
               "device_parts": dev_parts, "host_s": t_host,
               "device_cold_s": t_cold, "device_p50_s": p50,
               "device_collect_p50_s": collect_s,
               "rows_scanned": scanned,
               "rows_scanned_per_s": scanned / p50,
               "profiled_wall_s": wall, "device_busy_s": busy,
               "device_idle_share": idle}
        log(f"query {name}: {len(got)} rows from {dev_parts} device parts, "
            f"host executor {host_text} (rows built), device cold "
            f"{t_cold:.3f} s (no rows built), warm p50 {p50:.4f} s without "
            f"rows built ({scanned / p50:,.0f} rows scanned/s), warm "
            f"{collect_s:.4f} s with rows built; profiled warm run "
            f"{wall * 1e3:.2f} ms wall, device busy "
            f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}")
        if "stats" in q:
            ans = stats_answers(storage, name, q, now, runner, kernels,
                                wrappers, timed)
            log(f"answer {name}: stats_query p50 "
                f"{ans['api_stats_p50_s']:.4f} s, "
                f"{ans['api_stats_samples']} samples")
        else:
            # the window has submitted its first units when the first
            # part's rows satisfy the limit; with fewer than 1000 rows a
            # part the limit-1000 answer walks on
            limit_parts = min(window, dev_parts) \
                if len(want) >= 1000 * dev_parts else None
            ans = row_answers(storage, tenants, name, q, want, runner,
                              kernels, wrappers, timed, limit_parts,
                              host_handler)
            log(f"answer {name}: NDJSON export p50 "
                f"{ans['ndjson_p50_s']:.4f} s for {ans['ndjson_bytes']} B, "
                f"{ans['ndjson_rows_per_s']:,.0f} rows/s (dict rows p50 "
                f"{collect_s:.4f} s, host executor {host_text}); query "
                f"at limit 1000 p50 {ans['api_query_p50_s']:.4f} s, "
                f"{ans['api_query_parts']} device parts" + (
                    f"; with{FIELDS_CASE} p50 {ans['api_fields_p50_s']:.4f} "
                    f"s" if "api_fields_p50_s" in ans else ""))
        row.update(ans)
        return row, got

    for name, q, kernels in queries(start):
        # the generated text is lower case ASCII: i(ERROR) is `error` and
        # i(RESP*) is `resp*`, so each any-case query is held against
        # the host executor's rows of its twin, run just before it (a
        # file part decodes its columns at every read: a second host
        # run would cost ~10 s and check nothing more)
        row, got = drive(name, q, kernels, want=twin_rows
                         if name in ANYCASE_TWINS.values() else None)
        twin_rows = got if name in ANYCASE_TWINS else None
        if name == "count_all" and got != [{"count(*)": str(nrows)}]:
            fail(f"count_all returned {got}, want {nrows}")
        report.append(row)
        # a row query's ~1.4M result dicts, alive into the next query,
        # would make the collector's full passes land in its timings
        del got
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"queries: {time.perf_counter() - t0_queries:.1f} s")
    log(f"main-path launches: {launches}")
    for w in main_path:
        if w.launches == 0:
            fail(f"{w.__name__} was not launched on the main path")
    log(f"runner parts: {parts}")
    if parts["host_parts"]:
        fail(f"{parts['host_parts']} parts ran on the host")
    log(f"emit: {emit.EMIT_COUNTERS}")
    if emit.EMIT_COUNTERS["py_blocks"]:
        fail(f"{emit.EMIT_COUNTERS['py_blocks']} result blocks took the "
             f"per-row emit")
    log(f"runner staged bytes: {runner.cache.bytes()} "
        f"{runner.cache.bytes_by_kind()}")

    # phase 3, the filters' path on the same store: numeric ranges, in,
    # len_range, _stream_id and the per-leaf path, its counts zeroed
    # first
    t_phase = time.perf_counter()
    for w in wrappers:
        w.launches = 0
    sid = next(iter(storage.partitions.values())).parts[0] \
        .block_stream_id(0).as_string()
    for name, q, kernels, fallback in filter_queries(sid):
        f0 = parts["cpu_fallbacks"]
        row, got = drive(name, q, kernels)
        row["cpu_fallbacks"] = parts["cpu_fallbacks"] - f0
        if (row["cpu_fallbacks"] > 0) != fallback:
            fail(f"query {name}: {row['cpu_fallbacks']} leaves fell back "
                 f"to the host")
        report.append(row)
        del got
    row = extra_filters_answer(storage, runner, wrappers, timed,
                               min(window, FLUSHES))
    log(f"answer extra_filters: {row['api_query_bytes']} B, query at "
        f"limit 1000 p50 {row['api_query_p50_s']:.4f} s")
    report.append(row)
    flaunches = {w.__name__: w.launches for w in wrappers}
    log(f"filters' path launches: {flaunches}; runner parts: {parts}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for w in (K.match_scan, stats_count_seg):
        if flaunches[w.__name__] == 0:
            fail(f"{w.__name__} was not launched on the filters' path")
        launches[w.__name__] += flaunches[w.__name__]
    if parts["host_parts"]:
        fail(f"{parts['host_parts']} parts ran on the host")

    # phase 3, the pipes' path on the same store: the sort top-k
    # prefilter, host row pipes, stats after a pipe, hits and
    # stats_query_range, its counts zeroed first
    t_phase = time.perf_counter()
    for w in wrappers:
        w.launches = 0
    for name, q, kernels, topk in slice_queries():
        before = dict(parts)
        row, got = drive(name, q, kernels, host_handler=not topk)
        ran = {k: parts[k] - before[k] for k in
               ("device_parts", "topk_parts", "topk_declines", "topk_rows")}
        if topk != (ran["topk_parts"] > 0) or ran["topk_declines"] or \
                (topk and ran["topk_parts"] != ran["device_parts"]):
            fail(f"query {name}: the top-k prefilter ran on "
                 f"{ran['topk_parts']} of {ran['device_parts']} device "
                 f"parts, {ran['topk_declines']} declined")
        if topk:
            flt = q.split(" | ")[0]
            matched = int(run_query_collect(
                storage, tenants, f"{flt} | stats count() n",
                runner=runner)[0]["n"])
            runs = ran["device_parts"] // row["device_parts"]
            row["topk_rows"] = ran["topk_rows"] // runs
            row["matched_rows"] = matched
            log(f"query {name}: the card returned {row['topk_rows']} of "
                f"{matched} matched rows a run ({runs} runs); device ops "
                f"of a warm run (name, ms, count): " + str(device_ops(
                    lambda q=q: run_query(storage, tenants, q,
                                          lambda br: None,
                                          runner=runner))))
        report.append(row)
        del got
    for row in handler_answers(storage, runner, wrappers, timed):
        report.append(row)
    slaunches = {w.__name__: w.launches for w in wrappers}
    log(f"pipes' path launches: {slaunches}; runner parts: {parts}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for w in (K.match_scan, stats_count_seg):
        if slaunches[w.__name__] == 0:
            fail(f"{w.__name__} was not launched on the pipes' path")
        launches[w.__name__] += slaunches[w.__name__]
    if parts["host_parts"]:
        fail(f"{parts['host_parts']} parts ran on the host")

    # phase 3, the filter index on the sealed main store and a sealed
    # path store: sidecars, maplet pruning, the split-block gates; its
    # counts zeroed before each query
    t_phase = time.perf_counter()
    fi_fig = filter_index_path(storage, tenants, runner, wrappers,
                               ingest_figs[0]["flushes"])
    for qrow in fi_fig["queries"]:
        for n, c in qrow["launches"].items():
            launches[n] += c
    for w in (K.match_scan_gated_sb, K.match_pair_gated_sb):
        if launches[w.__name__] == 0:
            fail(f"{w.__name__} was not launched on the filter index path")
    log(f"filter index path: {time.perf_counter() - t_phase:.1f} s")

    # phase 3, the gated pair's path: a store whose request paths lie in
    # a quarter of the streams, so the pair's bloom tokens rule out the
    # other blocks of its part
    t_phase = time.perf_counter()
    pstore, _fig = store_by_route("rows", [path_rows(
        PATH_ROWS, 12, today_start_ns(), NS_PER_DAY // 2)])
    prows = PATH_ROWS
    prunner = TorchBatchRunner(device="cuda")
    pparts = prunner.stats_counters
    for w in wrappers:
        w.launches = 0
    for name, q, kernels in path_queries():
        t0 = time.perf_counter()
        want = run_query_collect(pstore, tenants, q)
        t_host = time.perf_counter() - t0
        before = launch_counts(wrappers, pparts)
        t0 = time.perf_counter()
        got = run_query_collect(pstore, tenants, q, runner=prunner)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        dev_parts = check_launches(f"query {name}", wrappers, pparts,
                                   before, kernels)
        if got != want or not want:
            fail(f"query {q!r}: device result differs from the host "
                 f"executor ({len(got)} vs {len(want)} rows)")
        log(f"query {name}: {len(got)} rows from {dev_parts} device parts "
            f"of {prows} rows, equal to the host executor ({t_host:.3f} s); "
            f"cold device run {t_dev:.3f} s with rows built")
    if K.match_pair_gated.launches == 0 or not pparts["maybe_rows"]:
        fail(f"the gated pair's path: {K.match_pair_gated.launches} "
             f"launches, {pparts['maybe_rows']} maybe rows")
    launches["match_pair_gated"] += K.match_pair_gated.launches
    log(f"gated pair path launches: "
        f"{ {w.__name__: w.launches for w in wrappers} }; runner parts: "
        f"{pparts}; {time.perf_counter() - t_phase:.1f} s")
    prunner.close()
    pstore.close()

    # phase 3, the transform path on the routes' jsonline store: the
    # transform and auxiliary pipes, the host-only stats functions, `if`
    # and calendar buckets behind filters on the card, then an unflushed
    # batch; its counts zeroed first
    t_phase = time.perf_counter()
    trows, tlaunches = transform_path(rstore, tenants, wrappers,
                                      [w.__name__ for w in wrappers])
    rstore.close()
    report += trows
    log(f"transform path launches: {tlaunches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for w in (K.match_scan, K.match_scan_gated, stats_count_seg):
        if tlaunches[w.__name__] == 0:
            fail(f"{w.__name__} was not launched on the transform path")
    for n, c in tlaunches.items():
        if n in launches:
            launches[n] += c

    # phase 3, the packed path: a store of many small parts over four
    # days, at VL_INFLIGHT/VL_PACK_PARTS 1/1 and 4/8; its counts zeroed
    # first
    t_phase = time.perf_counter()
    packed, plaunches, pack_kern, pfig = packed_path(
        tenants, wrappers, [w.__name__ for w in wrappers])
    ingest_figs.append(pfig)
    log(f"packed path launches: {plaunches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for w in (K.match_scan, K.match_scan_gated, stats_count_seg,
              stats_values):
        if plaunches[w.__name__] == 0:
            fail(f"{w.__name__} was not launched on the packed path")
    for n, c in plaunches.items():
        if n in launches:
            launches[n] += c

    # phase 4: kernels at the main-path shapes
    t_phase = time.perf_counter()
    part = next(iter(storage.partitions.values())).parts[0]
    layout = runner.layout(part)
    ff = runner.stage_fused_field(part, "_msg", layout)
    kern = []

    def add(name, cuname, src, replaces, got, want, fn, plain, lib,
            nbytes, ops):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            fail(f"{name}: kernel differs from its plain version at the "
                 f"main-path shape (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        ms, timing = timed_ms(fn, 50, cuname, b_ms)
        pms, plain_timing = timed_ms(plain, 5, floor_ms=b_ms)
        lms, lib_timing = (None, None) if lib is None else \
            timed_ms(lib, 50, floor_ms=b_ms)
        l2l = cuda_ms(fn, 50)
        log(f"kernel {name}: launch-to-launch {l2l:.5f} ms by CUDA events")
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lms, "launch_to_launch_ms": l2l,
                     "timing": {"ms": timing, "plain_ms": plain_timing,
                                "library_ms": lib_timing},
                     "bound_bytes": nbytes,
                     "bound_operations": ops})

    r = ff.lanes.shape[1]
    scan_args = (ff.lanes, ff.lengths, b"error", K.MODE_PHRASE, True, True)
    got = K.match_scan(*scan_args)
    want = K.match_scan_plain(*scan_args)
    add("match_scan", "match_scan_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/kernels_pallas.py:124", got, want,
        lambda: K.match_scan(*scan_args),
        lambda: K.match_scan_plain(*scan_args), None,
        *scan_work(*scan_args))

    qtext = {name: q for name, q, _k in queries(start)}
    ids, mask, asm, _cols = part_stats_inputs(
        runner, part, "error | stats by (_time:1h) count()")
    nb = asm.nb
    maskf = mask.float()
    add("stats_count_seg", "count_", "victorialogs_tpu_torch/csrc/count.cu",
        "victorialogs_tpu/tpu/stats_seg.py:303",
        stats_count_seg(None, ids, mask, 1, nb),
        stats_count_seg_plain(None, ids, mask, 1, nb),
        lambda: stats_count_seg(None, ids, mask, 1, nb),
        lambda: stats_count_seg_plain(None, ids, mask, 1, nb),
        lambda: torch.bincount(ids, weights=maskf, minlength=nb),
        r * 5 + nb * 4, int(mask.sum()))
    at = []
    for qname in ("uniq_all", "time_uniq", "quantile"):
        ids, mask, asm, _cols = part_stats_inputs(runner, part, qtext[qname])
        a = (None, ids, mask, 1, asm.nb)
        if not torch.equal(stats_count_seg(*a), stats_count_seg_plain(*a)):
            fail(f"stats_count_seg at {qname}'s cells differs from its "
                 f"plain version")
        row = {"kernel": "stats_count_seg", "query": qname,
               "cells": asm.nb, "rows": r,
               "masked_rows": int(mask.sum()),
               "bound_bytes": r * 5 + asm.nb * 4,
               "bound_operations": int(mask.sum()),
               "fn": lambda a=a: stats_count_seg(*a), "filter": "count_",
               "lib": lambda ids=ids, w=mask.float(), nb=asm.nb:
               torch.bincount(ids, weights=w, minlength=nb)}
        at.extend(time_sweep([row]))
    kern[-1]["at_queries"] = at

    ids, mask, asm, cols = part_stats_inputs(runner, part,
                                             qtext["value_stats"])
    va = (cols, ids, mask, asm.nb)
    got_v = stats_values(*va)
    lib_v = values_library(*va)
    if not values_agree(got_v, lib_v(), asm.nb):
        fail("stats_values: the PyTorch composition disagrees")
    add("stats_values", "values_", "victorialogs_tpu_torch/csrc/count.cu",
        "victorialogs_tpu/tpu/kernels.py:285", got_v,
        stats_values_plain(*va), lambda: stats_values(*va),
        lambda: stats_values_plain(*va), lib_v,
        *values_work(mask, asm.nb, len(cols)))
    kern[-1]["cells"] = asm.nb
    kern[-1]["columns"] = len(cols)
    kern[-1]["masked_rows"] = int(mask.sum())
    kern[-1]["at_queries"] = [
        time_sweep([values_row((c, i, m, a.nb), qname, "at")])[0]
        for qname in ("value_stats", "num_bucket")
        for i, m, a, c in [part_stats_inputs(runner, part, qtext[qname])]]

    plb = bloom_plane(part, "_msg")
    sp = runner.stage_bloom_plane(part, "_msg", plb)
    idx, shift = plb.block_probe_args(hash_tokens(["quota"]))
    idx, shift = pad_probe_args(idx, shift, sp.bp)
    ti, ts_ = runner.put(idx), runner.put(shift)
    probe_args = (sp.plane, ti, ts_, sp.nwords)
    pk = plane_keep(*probe_args)
    ti64 = ti.to(torch.int64)

    def gather_test():
        """The yardstick: a gather plus a bit test on the int32 lanes
        (every lane index of this input lies inside the plane)."""
        bits = (torch.gather(sp.plane, 1, ti64) >> ts_) & 1
        return bits.bool().all(dim=1) | (sp.nwords == 0)

    if not torch.equal(gather_test(), pk):
        fail("plane_keep: the gather yardstick disagrees with the kernel")
    add("plane_keep", "plane_keep_kernel",
        "victorialogs_tpu_torch/csrc/probe.cu",
        "victorialogs_tpu/tpu/bloom_device.py:108", pk,
        plane_keep_plain(*probe_args), lambda: plane_keep(*probe_args),
        lambda: plane_keep_plain(*probe_args), gather_test,
        *probe_work(*probe_args))

    # the bloom query's leaf as the main path runs it, and the four
    # launches it replaces: the probe, the gather of its keep-mask to
    # rows through the int32 block ids, the ungated scan and the AND
    gate = BloomGate(sp.plane, sp.nwords, ti, ts_,
                     runner.stage_block_starts(part, layout))
    quota = (ff.lanes, ff.lengths, b"quota", K.MODE_PHRASE, True, True)
    gated_args = (*quota, False, gate)
    gated = K.match_scan_gated(*gated_args)[0]
    nb_part = gate.starts.numel() - 1
    bid = (torch.searchsorted(gate.starts.to(torch.int64),
                              torch.arange(r, device=dev), right=True) - 1) \
        .clamp(0, nb_part - 1).to(torch.int32)

    def replaced():
        return plane_keep(*probe_args).index_select(0, bid) & \
            K.match_scan(*quota)

    if not torch.equal(replaced(), gated):
        fail("match_scan_gated: the four launches it replaces disagree")
    add("match_scan_gated", "gated_scan_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/bloom_device.py:108", gated,
        K.match_scan_gated_plain(*gated_args)[0],
        lambda: K.match_scan_gated(*gated_args),
        lambda: K.match_scan_gated_plain(*gated_args), None,
        *gated_work(*gated_args))
    kern[-1]["replaced_ms"], kern[-1]["timing"]["replaced_ms"] = \
        timed_ms(replaced, 50, floor_ms=kern[-1]["bound_ms"])
    kern[-1]["replaces_also"] = ("the gather of plane_keep's mask to rows "
                                 "and its AND with match_scan_pallas")
    kern[-1]["rows"] = r
    kern[-1]["kept_rows"] = int(keep_rows_plain(gate, r).sum())

    # the regexp `error.*timeout` as regex_pair runs it
    pair_args = (ff.lanes, ff.lengths, b"error", b"timeout")
    got_p = K.match_pair(*pair_args)
    want_p = K.match_pair_plain(*pair_args)
    add("match_pair", "match_pair_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/kernels32.py:243", torch.stack(got_p),
        torch.stack(want_p), lambda: K.match_pair(*pair_args),
        lambda: K.match_pair_plain(*pair_args), None,
        *pair_work(ff.lanes, ff.lengths))
    kern[-1]["rows"] = r
    kern[-1]["definite_rows"] = int(got_p[0].sum())
    kern[-1]["maybe_rows"] = int(got_p[1].sum())

    # the same pair behind the bloom query's gate (`quota`: the blocks of
    # apps 0 and 1)
    gpair_args = (*pair_args, gate)
    got_gp = K.match_pair_gated(*gpair_args)
    add("match_pair_gated", "gated_pair_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/kernels32.py:243", torch.stack(got_gp),
        torch.stack(K.match_pair_gated_plain(*gpair_args)),
        lambda: K.match_pair_gated(*gpair_args),
        lambda: K.match_pair_gated_plain(*gpair_args), None,
        *gated_pair_work(ff.lanes, ff.lengths, gate))
    kern[-1]["replaces_also"] = (
        "plane_keep_pallas (victorialogs_tpu/tpu/bloom_device.py:108) "
        "gathered to rows and ANDed with the pair, the JAX planner's "
        "_with_bloom (victorialogs_tpu/tpu/fused.py:518)")
    kern[-1]["rows"] = r
    kern[-1]["kept_rows"] = int(keep_rows_plain(gate, r).sum())
    kern[-1]["definite_rows"] = int(got_gp[0].sum())

    # the split-block gate of the sealed part: `quota`'s probe of its
    # `_msg` filters alone, behind the scan of `quota` and behind the
    # pair `error.*timeout`
    fi = part_index(part)
    sbp = runner.stage_sb_plane(part, "_msg")
    qh = hash_tokens(["quota"])
    sbidx = runner.put(pad_sb_idx(fi.sb_probe_idx("_msg", qh), sbp.bp))
    smask = runner.put(fi.sb_masks(qh).view(np.int32))
    sb_args = (sbp.plane, sbidx, smask, sbp.nsb)
    pks = plane_keep_sb(*sb_args)
    lane8 = (sbidx.to(torch.int64)[:, :, None]
             + torch.arange(8, device=dev)).reshape(sbidx.shape[0], -1)

    def sb_gather_test():
        """The yardstick: a gather of each token's 8 lanes and the
        masked compare (every lane base of this input lies inside the
        plane)."""
        w = torch.gather(sbp.plane, 1, lane8).reshape(
            sbidx.shape[0], -1, 8)
        return ((w & smask) == smask).all(dim=2).all(dim=1) | (sbp.nsb == 0)

    if not torch.equal(sb_gather_test(), pks):
        fail("plane_keep_sb: the gather yardstick disagrees with the kernel")
    add("plane_keep_sb", "plane_keep_sb_kernel",
        "victorialogs_tpu_torch/csrc/probe.cu",
        "victorialogs_tpu/tpu/bloom_device.py:255", pks,
        plane_keep_sb_plain(*sb_args), lambda: plane_keep_sb(*sb_args),
        lambda: plane_keep_sb_plain(*sb_args), sb_gather_test,
        *sb_probe_work(*sb_args))
    kern[-1]["kept_blocks"] = int(pks[:part.num_blocks].sum())
    sbgate = SbGate(sbp.plane, sbp.nsb, sbidx, smask, gate.starts)
    gated_sb_args = (*quota, False, sbgate)
    gated_sb = K.match_scan_gated_sb(*gated_sb_args)[0]

    def replaced_sb():
        return plane_keep_sb(*sb_args).index_select(0, bid) & \
            K.match_scan(*quota)

    if not torch.equal(replaced_sb(), gated_sb):
        fail("match_scan_gated_sb: the four launches it replaces disagree")
    add("match_scan_gated_sb", "gated_scan_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/bloom_device.py:255", gated_sb,
        K.match_scan_gated_plain(*gated_sb_args)[0],
        lambda: K.match_scan_gated_sb(*gated_sb_args),
        lambda: K.match_scan_gated_plain(*gated_sb_args), None,
        *gated_work(*gated_sb_args))
    kern[-1]["replaced_ms"], kern[-1]["timing"]["replaced_ms"] = \
        timed_ms(replaced_sb, 50, floor_ms=kern[-1]["bound_ms"])
    kern[-1]["replaces_also"] = (
        "the JAX planner's bloom_sb node (victorialogs_tpu/tpu/fused.py:"
        "709-714): plane_keep_sb gathered to rows and ANDed with "
        "match_scan_pallas (victorialogs_tpu/tpu/kernels_pallas.py:124)")
    kern[-1]["rows"] = r
    kern[-1]["kept_rows"] = int(keep_rows_plain(sbgate, r).sum())
    gpair_sb_args = (*pair_args, sbgate)
    got_gps = K.match_pair_gated_sb(*gpair_sb_args)
    add("match_pair_gated_sb", "gated_pair_kernel",
        "victorialogs_tpu_torch/csrc/scan.cu",
        "victorialogs_tpu/tpu/bloom_device.py:255", torch.stack(got_gps),
        torch.stack(K.match_pair_gated_plain(*gpair_sb_args)),
        lambda: K.match_pair_gated_sb(*gpair_sb_args),
        lambda: K.match_pair_gated_plain(*gpair_sb_args), None,
        *gated_pair_work(ff.lanes, ff.lengths, sbgate))
    kern[-1]["replaces_also"] = (
        "match_ordered_pair_t (victorialogs_tpu/tpu/kernels32.py:243) "
        "ANDed with the bloom_sb node (victorialogs_tpu/tpu/fused.py:"
        "709-714)")
    kern[-1]["rows"] = r
    kern[-1]["kept_rows"] = int(keep_rows_plain(sbgate, r).sum())
    kern[-1]["definite_rows"] = int(got_gps[0].sum())
    for k in kern:
        if k["name"] in pack_kern:
            k["at_pack"] = pack_kern[k["name"]]
        log(f"kernel {k['name']}: {k['ms']} ms (plain {k['plain_ms']} ms, "
            f"bound {k['bound_ms']} ms by {k['bound_by']} from "
            f"{k['bound_bytes']} B and {k['bound_operations']} operations, "
            f"library {k['library_ms']} ms), {k['launches']} main-path "
            f"launches" + (f"; the launches it replaces {k['replaced_ms']} ms"
                           if "replaced_ms" in k else ""))
    log(json.dumps({"queries": report}))
    log(f"kernels at the main-path shapes: "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sw = sweep(rng, dev)
    next(k for k in kern if k["name"] == "stats_values")["at_cells"] = [
        row for row in sw if row["kernel"] == "stats_values"]
    log(json.dumps({"sweep": sw + gate_sweep(rng, dev)}))
    log(f"sweeps: {time.perf_counter() - t_phase:.1f} s")
    # the result cache phase ends with the main store's force merge;
    # phase 4's part must not outlive it
    del part
    t_phase = time.perf_counter()
    for w in wrappers:
        w.launches = 0
    rcache = result_cache_path(storage, tenants, runner, wrappers, timed,
                               start, durable_before)
    durable["force_merge"] = rcache.pop("force_merge")
    log(f"result cache phase (durable force merge included): "
        f"{time.perf_counter() - t_phase:.1f} s")
    fi_fig["kill"] = filter_index_kill(storage, tenants, start)
    log(f"filter index part kill: {fi_fig['kill']['phase_s']:.1f} s")
    runner.close()
    storage.close()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")
    print(json.dumps({"kernels": kern, "answers": [
        {k: r[k] for k in ANSWER_KEYS if k in r} for r in report],
        "packed": packed, "ingest": ingest_figs, "durable": durable,
        "result_cache": rcache, "filter_index": fi_fig}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
