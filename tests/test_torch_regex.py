"""Regexps and `i()` in the port against the JAX package.

Every comparison is exact:

- parse and `to_string` of regexp and `i()` queries;
- `regex_literal_runs` and `regex_literal_tokens` on a fixed list of
  patterns (anchors, groups, `(?i)`, escapes, classes, alternations)
  and on seeded random ones;
- `match_pair_plain` (the plain version of the `A.*B` kernel) against
  kernels32.match_ordered_pair_t on the same lanes: seeded rows with
  newlines and 0xFF padding, overlapping patterns, widths 32 and 128;
- the any-case scan with its multibyte mask: the port's `scan` node
  against the JAX package's (`match_scan_t(fold=True)` and
  `stage_multibyte_mask`) on one part;
- whole queries (pair, verify, pure literal, no literal run, any case,
  `NOT ~...`, regexps under `stats`, values wider than the staged width,
  U+212A and `İ` under `i()`) through the port's host executor and
  TorchBatchRunner(device="cpu") against the JAX package's host
  executor and BatchRunner: rows, NDJSON bytes and stats answers.

The `cuda`-marked test holds `vl_match_pair` against its plain version
and skips without a GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from victorialogs_tpu.engine.emit import ndjson_block as jax_ndjson
from victorialogs_tpu.engine.searcher import run_query as jax_run_query
from victorialogs_tpu.engine.searcher import run_query_collect as jax_run
from victorialogs_tpu.logsql import filters as JF
from victorialogs_tpu.logsql.parser import parse_query as jax_parse
from victorialogs_tpu.server import vlselect as jsel
from victorialogs_tpu.storage import log_rows as JLR
from victorialogs_tpu.storage import storage as JS
from victorialogs_tpu.tpu import kernels32 as JK32
from victorialogs_tpu.tpu.batch import BatchRunner

from victorialogs_tpu_torch.cli.vlogsgenerator import (NS_PER_DAY, generate,
                                                       today_start_ns)
from victorialogs_tpu_torch.logsql import filters as PF
from victorialogs_tpu_torch.logsql.duration import format_rfc3339
from victorialogs_tpu_torch.storage.log_rows import LogRows, TenantID

T = [TenantID(0, 0)]
JT = [JLR.TenantID(0, 0)]

# torch and the torch-importing modules of the port load on first use,
# in the worker that runs these tests, not in every collecting worker
torch = K = TL = run_query = run_query_collect = None
TorchBatchRunner = Storage = parse_query = emit = sel = None


def _load_port():
    global torch, K, TL, run_query, run_query_collect, TorchBatchRunner
    global Storage, parse_query, emit, sel
    import torch
    from victorialogs_tpu_torch.engine import emit
    from victorialogs_tpu_torch.engine.searcher import (run_query,
                                                        run_query_collect)
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu import layout as TL
    from victorialogs_tpu_torch.gpu.batch import TorchBatchRunner
    from victorialogs_tpu_torch.logsql.parser import parse_query
    from victorialogs_tpu_torch.server import vlselect as sel
    from victorialogs_tpu_torch.storage.storage import Storage


@pytest.fixture(autouse=True)
def _torch_threads():
    _load_port()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


# ---------------- parsing and literal extraction ----------------

PATTERNS = [
    "error", "error.*timeout", "quota (GET|POST)", "^error", "timeout$",
    "err\\w+", "(?i)error", "GET|POST", "a|b", "x(y|z)w", "[abc]+d",
    "foo{2,3}bar", "foo?bar", "fo+bar", "a.b.c", "\\.log$",
    "\\x41BC\\u00e9d", "\\n+\\tx", "\\0", "\\012x", "(a)\\1", "\\d+ms",
    "a\\*b", "id=\\d+ user=", "a{0,1}b", "(?:ab)+cd", "[^x]yz",
    "dead.*line.*exceeded", "", "a", "\\bword\\b", "ab\\Acd\\Z",
    "\\x4", "é.*ü", "quota ", "a-b.*c&d", " quota ",
]


@pytest.mark.parametrize("pat", PATTERNS)
def test_literal_runs_and_tokens_match_jax(pat):
    assert PF.regex_literal_runs(pat) == JF.regex_literal_runs(pat)
    assert PF.regex_literal_tokens(pat) == JF.regex_literal_tokens(pat)


def test_literal_runs_match_jax_on_random_patterns():
    rng = np.random.default_rng(8)
    alphabet = list("ab_ .*+?|()[]{}^$\\dwx0-,12") + ["\\x41", "é"]
    n = 0
    for _ in range(3000):
        pat = "".join(rng.choice(alphabet, size=rng.integers(1, 12)))
        assert PF.regex_literal_runs(pat) == JF.regex_literal_runs(pat), pat
        assert PF.regex_literal_tokens(pat) == \
            JF.regex_literal_tokens(pat), pat
        n += bool(PF.regex_literal_runs(pat))
    assert n > 300


@pytest.mark.parametrize("q", [
    '~"error.*timeout"', "i(ERROR)", "i(RESP*)", '_msg:i("Foo Bar")',
    'x:i(a*) -~"a|b"', '~"quota (GET|POST)"', "~`\\d+ms`",
    'not i(K) or ~"(?i)abc"', 'i("")', 'lvl:~"err.*or" i(x*)',
    '!~"a.*b" | stats by (app) count()',
])
def test_parse_and_to_string_match_jax(q):
    assert parse_query(q).to_string() == jax_parse(q).to_string()


@pytest.mark.parametrize("q", ["i(a, b)", "i(*)", "i()", "i(a"])
def test_malformed_any_case_filters_raise_like_jax(q):
    from victorialogs_tpu.logsql.parser import ParseError as JaxParseError
    from victorialogs_tpu_torch.logsql.pipes import ParseError
    with pytest.raises(ParseError):
        parse_query(q)
    with pytest.raises(JaxParseError):
        jax_parse(q)


def test_pair_and_pure_classification_matches_jax():
    import re
    for pat in PATTERNS:
        try:
            j = JF.FilterRegexp("", pat)
        except re.error:
            with pytest.raises(re.error):
                PF.FilterRegexp("", pat)
            continue
        p = PF.FilterRegexp("", pat)
        assert p._pair == j._pair, pat
        assert p._tokens() == j._tokens(), pat


# ---------------- the pair kernel's plain version ----------------

def _lanes(seed: int, r: int, w: int, alpha: bytes, plant=()):
    """0xFF-padded rows over `alpha`, lengths 0..w-1 (w-1 and 0 among
    them), each byte string of `plant` written at a random offset into
    a third of the rows, then a newline into a third of the rows, each
    row cut at its length."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alpha, dtype=np.uint8)
    lens = rng.integers(0, w, size=r).astype(np.int32)
    lens[:3] = w - 1
    lens[3:5] = 0
    mat = a[rng.integers(0, a.size, size=(r, w))]
    for p in plant:
        if len(p) > w:
            continue
        for i in np.nonzero(rng.random(r) < 1 / 3)[0]:
            o = int(rng.integers(0, w - len(p) + 1))
            mat[i, o:o + len(p)] = np.frombuffer(p, dtype=np.uint8)
    nl = np.nonzero(rng.random(r) < 1 / 3)[0]
    mat[nl, rng.integers(0, w, size=nl.size)] = 0x0A
    mat = np.where(np.arange(w)[None, :] < lens[:, None], mat,
                   np.uint8(0xFF)).astype(np.uint8)
    return TL.to_lanes32(mat), lens


PAIRS = [(b"a", b"b"), (b"aa", b"aa"), (b"aba", b"bab"), (b"ab", b"a"),
         (b"b", b"a b"), (b"a" * 5, b"b"), (b"\xc3\xa9", b"a"),
         (b"ab" * 16, b"b" * 33)]


@pytest.mark.parametrize("w", [32, 128])
@pytest.mark.parametrize("pi", range(len(PAIRS)))
def test_match_pair_plain_matches_match_ordered_pair_t(w, pi):
    a, b = PAIRS[pi]
    lanes, lens = _lanes(w + pi, 400, w, b"ab a\xc3\xa9",
                         (a, b, a + b" " + b))
    d, m = JK32.match_ordered_pair_t(
        jnp.asarray(lanes), jnp.asarray(lens),
        jnp.asarray(np.frombuffer(a, np.uint8)), len(a),
        jnp.asarray(np.frombuffer(b, np.uint8)), len(b))
    got = K.match_pair(torch.from_numpy(lanes.view(np.int32)),
                       torch.from_numpy(lens), a, b)
    assert np.array_equal(got[0].numpy(), np.asarray(d))
    assert np.array_equal(got[1].numpy(), np.asarray(m))
    if len(a) + len(b) < w:
        assert got[0].any() and got[1].any()


def test_match_pair_rejects_bad_patterns():
    lanes = torch.zeros((8, 4), dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    for a, b in ((b"", b"x"), (b"x", b""), (b"x" * 65, b"x"),
                 (b"x\xff", b"x")):
        with pytest.raises(ValueError):
            K.match_pair(lanes, lens, a, b)


@pytest.mark.cuda
def test_cuda_match_pair_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for w in (32, 128, 256):
        for a, b in PAIRS + [(b"a" * 64, b"b"), (b"b", b"ab" * 32)]:
            lanes, lens = _lanes(w, 4099, w, b"ab a\xc3\xa9",
                                 (a, b, a + b" " + b))
            lt = torch.from_numpy(lanes.view(np.int32)).to(dev)
            ln = torch.from_numpy(lens).to(dev)
            got = K.match_pair(lt, ln, a, b)
            want = K.match_pair_plain(lt, ln, a, b)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (w, a, b)


# ---------------- stores of the same rows in both packages ----------------

LONG = "pad " * 520
CRAFTED = [
    "error then timeout", "timeout then error", "errortimeout",
    "error\ntimeout", "line one\nerror x timeout", "ERROR: request TIMEOUT",
    "Error Timeout", "kelvin \u212a here", "\u212a", "İstanbul",
    "istanbul", "quota GET /a", "quota POST /b", "quota PUT /c",
    "xquota GET", "id:quota:x GET", "élan error timeout",
    "résumé ERROR", LONG + "error timeout",
    "error " + LONG + "timeout", LONG + "\u212a", "retry flush retry",
    "aa aa", "aba bab", "RESPonse ok", "a quota b",
]
LEVELS = ["error", "ERROR", "Error", "eRRor", "warn", "\u212aelvin"]


def _rows(start: int) -> list:
    rows = generate(3000, 9, start, NS_PER_DAY // 4, streams=8)
    out = []
    step = (NS_PER_DAY // 4) // len(rows)
    for k, (ts, fields) in enumerate(rows):
        out.append((ts, fields))
        if k % 23 == 0:
            i = k // 23
            msg = CRAFTED[i % len(CRAFTED)]
            out.append((ts + step // 2, [
                ("_msg", msg), ("app", f"app-{i % 3}"), ("host", "host-x"),
                ("lvl", LEVELS[i % len(LEVELS)]),
                ("kind", "Über" if i % 2 else "plain")]))
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    _load_port()
    start = today_start_ns()
    rows = _rows(start)
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("jaxregex")))
    per = -(-len(rows) // 2)
    for k in range(2):
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


# (query, where the runner takes it: "card" = every part on the device,
# "host" = every part on the host, "maybe" = on the device with maybe
# rows settled on the host beside the truncated values every `_msg`
# leaf has here)
ROW_QUERIES = [
    ('~"error.*timeout"', "maybe"),            # pair; newline rows
    ('~"ERROR.*TIMEOUT"', "card"),
    ('~"aa.*aa"', "card"),                     # overlapping pair
    ('~"aba.*bab"', "card"),
    ('lvl:~"rr.*r"', "card"),                  # pair on a dict column
    ('~"pad.*timeout"', "maybe"),              # values past the width
    ('~"quota (GET|POST)"', "maybe"),          # verify
    ('~"^error"', "maybe"),
    ('~"err\\\\w+"', "maybe"),
    ('~" quota "', "maybe"),                   # verify behind a bloom gate
    ('~":nothere:x.*GET"', "card"),            # bloom rules out every block
    ('~"onnect"', "card"),                     # pure literal
    ('~"quota"', "card"),
    ('~"GET|POST"', "host"),                   # no literal run
    ('~"(?i)error"', "host"),
    ("i(ERROR)", "maybe"),                     # fold; multibyte rows
    ("i(RESP*)", "maybe"),
    ("i(k)", "maybe"),                         # U+212A
    ("i(i*)", "maybe"),                        # İ
    ("lvl:i(error)", "maybe"),
    ("kind:i(ü*)", "host"),               # a non-ASCII pattern
    ('not ~"error.*timeout"', "maybe"),
    ('-~"quota (GET|POST)"', "maybe"),
    ("!i(error)", "maybe"),
    ('i(error) or ~"quota (GET|POST)"', "maybe"),
    ('~"error.*timeout" quota', "maybe"),
    ('_stream:{app="app-1"} ~"retry.*flush"', "card"),
]

STATS_QUERIES = [
    '~"error.*timeout" | stats by (app) count()',
    '~"quota (GET|POST)" | stats count()',
    "i(error) | stats by (lvl) count()",
    '~"GET|POST" | stats count()',
    'not ~"error.*timeout" | stats by (app) count(), sum(dur)',
    '~"onnect" | stats by (lvl) count()',
]


def _check_runner(runner, where: str) -> None:
    c = runner.stats_counters
    if where == "host":
        assert c["host_parts"] > 0 and c["device_parts"] == 0, c
    else:
        assert c["device_parts"] > 0 and c["host_parts"] == 0, c
        assert c["maybe_rows"] > 0 or where == "card", c


@pytest.mark.parametrize("qi", range(len(ROW_QUERIES)))
def test_row_query_matches_jax(stores, qi):
    start, port, jax_st = stores
    q, where = ROW_QUERIES[qi]
    want = jax_run(jax_st, JT, q)
    if "nothere" not in q:
        assert want, q
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == want
        _check_runner(runner, where)
    finally:
        runner.close()
    br = BatchRunner()
    try:
        assert jax_run(jax_st, JT, q, runner=br) == want
    finally:
        br.close()


def _ndjson(run, st, tenants, q, block, **kw) -> list:
    chunks = []
    run(st, tenants, q, lambda br: chunks.append(block(br)), **kw)
    return [c for c in chunks if c]


@pytest.mark.parametrize("qi", [0, 6, 11, 15, 18, 21])
def test_row_query_ndjson_matches_jax(stores, qi):
    start, port, jax_st = stores
    q = ROW_QUERIES[qi][0] + " | fields _time, _msg, lvl, kind"
    want = _ndjson(jax_run_query, jax_st, JT, q, jax_ndjson)
    assert want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert _ndjson(run_query, port, T, q, emit.ndjson_block,
                       runner=runner) == want
    finally:
        runner.close()
    args = {"query": ROW_QUERIES[qi][0], "limit": "50"}
    runner = TorchBatchRunner(device="cpu")
    try:
        assert sel.handle_query(port, dict(args), {}, runner=runner) == \
            list(jsel.handle_query(jax_st, dict(args), {}))
    finally:
        runner.close()


@pytest.mark.parametrize("qi", range(len(STATS_QUERIES)))
def test_stats_query_matches_jax(stores, qi):
    start, port, jax_st = stores
    q = STATS_QUERIES[qi]
    want = jax_run(jax_st, JT, q)
    assert want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == want
        c = runner.stats_counters
        assert (c["host_parts"] > 0) == q.startswith('~"GET|POST"'), c
    finally:
        runner.close()
    args = {"query": q, "time": format_rfc3339(start + NS_PER_DAY // 2)}
    runner = TorchBatchRunner(device="cpu")
    try:
        assert sel.handle_stats_query(port, dict(args), {},
                                      runner=runner) == \
            jsel.handle_stats_query(jax_st, dict(args), {})
    finally:
        runner.close()


# ---------------- planning ----------------

def _kinds(node, out: set) -> set:
    out.add(node[0])
    if node[0] in ("and", "or"):
        for kid in node[1]:
            _kinds(kid, out)
    elif node[0] in ("not", "verify"):
        _kinds(node[1], out)
    return out


def _programs(port, q):
    """The part programs the runner plans for q: (tree, args, part,
    layout)."""
    progs = []

    class Recording(TorchBatchRunner):
        def _program(self, f, part, bss):
            prog = super()._program(f, part, bss)
            if prog is not None:
                progs.append((prog[0], prog[1], part, prog[2]))
            return prog

    runner = Recording(device="cpu")
    try:
        run_query_collect(port, T, q, runner=runner)
    finally:
        runner.close()
    return progs


@pytest.mark.parametrize("q,kinds", [
    ('~"error.*timeout"', {"pair"}),
    ('~"quota (GET|POST)"', {"verify", "scan"}),
    ('~" quota "', {"verify", "gscan"}),
    ('~"onnect"', {"scan"}),
    ("i(ERROR)", {"scan"}),
    ('~":nothere:x.*GET"', {"false"}),
    ('~"dead.*line.*exceeded"', {"verify", "and", "scan"}),
])
def test_regexp_leaves_plan_their_nodes(stores, q, kinds):
    _start, port, _jax = stores
    got = set()
    for tree, *_ in _programs(port, q):
        _kinds(tree, got)
    assert got == kinds


def test_any_case_scan_matches_jax_with_multibyte_mask(stores):
    """The `scan` node of `i(...)` (fold, multibyte maybe rows) on one
    part against the JAX package's: kernels32.match_scan_t(fold=True)
    and stage_multibyte_mask, through its own node evaluator."""
    from victorialogs_tpu.tpu import fused as JFU
    from victorialogs_tpu.tpu.batch import part_stats_layout
    from victorialogs_tpu_torch.gpu.fused import eval_node
    from victorialogs_tpu_torch.logsql.matchers import is_word_char
    from victorialogs_tpu_torch.storage.convert import part_from_arrays
    from test_torch_storage import export_part
    _start, _port, jax_st = stores
    (jpt,) = jax_st.partitions.values()
    jpart = jpt.ddb.snapshot_parts()[0]
    part = part_from_arrays(export_part(jpart))
    runner = TorchBatchRunner(device="cpu")
    try:
        layout = runner.layout(part)
        rlp = layout.nrows_padded
        for field in ("_msg", "lvl", "kind", "app"):
            jl = part_stats_layout(jpart)
            jmb = JFU.stage_multibyte_mask(jpart, field, jl, put=jnp.asarray)
            mb = runner.stage_multibyte(part, field, layout)
            want_mb = np.zeros(rlp, bool) if not jmb.any else \
                np.unpackbits(np.asarray(jmb.packed))[:rlp].astype(bool)
            got_mb = np.zeros(rlp, bool) if mb is None else mb.numpy()
            assert np.array_equal(got_mb[:layout.nrows],
                                  want_mb[:layout.nrows]), field
            assert (mb is None) == (field == "app")
            ff = runner.stage_fused_field(part, field, layout)
            lanes = ff.lanes.numpy().view(np.uint32)
            for low, mode in (("error", 0), ("k", 0), ("i", 1), ("re", 1)):
                st = is_word_char(low[0])
                et = mode == 0 and is_word_char(low[-1])
                pat = low.encode()
                jargs = [jnp.asarray(lanes), jnp.asarray(ff.lengths.numpy()),
                         jnp.asarray(np.packbits(got_mb)),
                         jnp.asarray(np.frombuffer(pat, np.uint8))]
                wd, wm = JFU._eval_node(
                    ("scan", 0, 1, -1, 2 if mb is not None else -1, 3,
                     len(pat), mode, st, et, True), jargs, rlp)
                args = [ff.lanes, ff.lengths] + ([mb] if mb is not None
                                                 else [])
                d, m = eval_node(("scan", 0, 1, -1,
                                  2 if mb is not None else -1, pat, mode,
                                  st, et, True), args, rlp, runner.device)
                assert np.array_equal(d.numpy(), np.asarray(wd)), \
                    (field, low)
                assert (m is None) == (wm is None)
                if m is not None:
                    assert np.array_equal(m.numpy(), np.asarray(wm))
    finally:
        runner.close()
    assert runner.cache.check_balanced()


def test_any_case_maybe_rows_settle_unicode_lowering(stores):
    """U+212A lowers to 'k' and İ to 'i' + U+0307: rows the byte fold
    cannot decide ride the maybe channel and settle like the JAX
    package's."""
    _start, port, jax_st = stores
    for q, must in (("i(k)", "\u212a"), ("i(i*)", "İstanbul")):
        runner = TorchBatchRunner(device="cpu")
        try:
            got = run_query_collect(port, T, q, runner=runner)
            assert runner.stats_counters["maybe_rows"] > 0
        finally:
            runner.close()
        assert got == jax_run(jax_st, JT, q)
        assert any(must in r["_msg"] for r in got), q
