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

- the kernel's one-automaton state step for `A.*B`, modelled in numpy
  bit for bit, against match_ordered_pair_t and match_pair_plain at
  every boundary of its state words;
- the bloom-gated pair (`gpair`) on a store whose request paths lie in
  some streams only: its plan, rows, NDJSON and stats answers against
  the JAX package's host executor and BatchRunner.

The `cuda`-marked test holds `vl_match_pair` against its plain version
and skips without a GPU.
"""

import os

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


# ---------------- the pair kernel's state step, modelled ----------------

PAIR_ONE, PAIR_NEWLINE = 1 << 30, 1 << 31


def _pair_words(n: int) -> int:
    return 1 if n <= 29 else 2 if n <= 61 else 5


def _pair_model(mat: np.ndarray, lens: np.ndarray, a: bytes, b: bytes):
    """csrc/scan.cu's A.*B automaton in numpy, bit for bit: NW uint32
    words a row (1 for la + lb <= 29, 2 for <= 61, else 5); bit 0 always
    set, bits [1, la + 1) A's prefixes, bit la also the `.*` state, bits
    [la + 1, la + lb + 1) B's; G keeps bit 0, A's and B's accepting bits
    and the top word's bit 30 (set from the start) and bit 31 (entered on
    0x0A).  Each row steps its words up to its length (bytes past it are
    the layout's 0xFF padding), then 0xFFFFFFFF words up to its warp's
    longest row, as the kernel does.  (definite, maybe)."""
    la, lb = len(a), len(b)
    nw = _pair_words(la + lb)
    r, w = mat.shape
    tab = np.zeros((256, nw), np.uint32)
    for j, c in enumerate(a):
        tab[c, (1 + j) >> 5] |= np.uint32(1 << ((1 + j) & 31))
    for j, c in enumerate(b):
        tab[c, (1 + la + j) >> 5] |= np.uint32(1 << ((1 + la + j) & 31))
    tab[0x0A, nw - 1] |= np.uint32(PAIR_NEWLINE)

    def bit(k):
        v = np.zeros(nw, np.uint32)
        v[k >> 5] = 1 << (k & 31)
        return v

    fin = bit(la + lb)
    g = bit(0) | bit(la) | fin
    g[nw - 1] |= np.uint32(PAIR_ONE | PAIR_NEWLINE)
    d = np.zeros((r, nw), np.uint32)
    d[:, 0] = 1
    d[:, nw - 1] |= np.uint32(PAIR_ONE)
    words = (np.clip(lens, 0, w) + 3) >> 2
    warp = np.repeat(np.maximum.reduceat(words, np.arange(0, r, 32)),
                     32)[:r]
    padded = np.full((r, 4 * int(warp.max(initial=0))), 0xFF, np.uint8)
    for i in range(r):
        padded[i, :4 * words[i]] = mat[i, :4 * words[i]]
    for i in range(padded.shape[1]):
        on = i < 4 * warp
        t = tab[padded[:, i]]
        x = d << np.uint32(1)
        x[:, 1:] |= d[:, :-1] >> np.uint32(31)
        d = np.where(on[:, None], (x & t) | (d & g), d)
    hit = (d & fin).any(axis=1)
    newline = (d[:, nw - 1] & np.uint32(PAIR_NEWLINE)) != 0
    return hit & ~newline, hit & newline


def _pair_case_rows(seed: int, r: int, w: int, a: bytes, b: bytes):
    """(mat, lens): rows over the patterns' bytes, a space and a byte in
    neither pattern, each with one of A, B, AB (no gap), BA, A then B,
    A and B overlapping, or nothing planted; a newline at the first or
    last byte or inside the row in some; lengths 0..w, some past w (the
    kernel reads only w = 4 * nl bytes); 0xFF past each length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(bytes(sorted(set(a + b + b" z"))), np.uint8)
    mat = alpha[rng.integers(0, alpha.size, size=(r, w))]
    lens = rng.integers(0, w + 1, size=r).astype(np.int32)
    lens[:4] = [0, w, w + 5, 1 << 20]
    lens[4:8] = [min(w, len(a) + len(b)), len(a) + len(b) - 1, 1, w - 1]
    plants = [a, b, a + b, b + a, a + b"z" + b, a[:-1] + b, b""]
    for i in range(r):
        n = min(int(lens[i]), w)
        p = np.frombuffer(plants[int(rng.integers(0, len(plants)))], np.uint8)
        if p.size and p.size <= n:
            o = int(rng.integers(0, n - p.size + 1))
            mat[i, o:o + p.size] = p
        k = int(rng.integers(0, 6))
        if n and k == 0:
            mat[i, 0] = 0x0A
        elif n and k == 1:
            mat[i, n - 1] = 0x0A
        elif n and k == 2:
            mat[i, int(rng.integers(0, n))] = 0x0A
    mat = np.where(np.arange(w)[None, :] < lens[:, None], mat,
                   np.uint8(0xFF)).astype(np.uint8)
    return mat, lens


def _pat(seed: int, n: int, alpha: bytes = b"ab") -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(np.frombuffer(alpha, np.uint8), size=n).tolist())


# (label, A, B): la + lb on both sides of each state-word boundary of the
# kernel (29, 61) and at 2, 31-33, 63-65 and 128; A == B; A a prefix,
# suffix or substring of B and the reverse; la = 1, lb = 1
PAIR_MODEL_CASES = [
    (f"n{la + lb}-{la}-{lb}", _pat(la, la), _pat(100 + lb, lb, b"abc"))
    for la, lb in ((1, 1), (14, 15), (15, 15), (15, 16), (16, 16),
                   (16, 17), (30, 31), (31, 31), (31, 32), (32, 32),
                   (32, 33), (33, 32), (64, 64), (1, 64), (64, 1), (60, 1),
                   (1, 28))
] + [
    ("a-eq-b", b"abc", b"abc"), ("a-prefix-of-b", b"ab", b"abb"),
    ("a-suffix-of-b", b"bb", b"abb"), ("a-inside-b", b"b", b"aba"),
    ("b-prefix-of-a", b"abb", b"ab"), ("b-suffix-of-a", b"abb", b"bb"),
    ("b-inside-a", b"aba", b"b"), ("la1", b"a", b"bab"), ("lb1", b"bab", b"a"),
    ("newline-in-a", b"a\nb", b"b"), ("multibyte", b"\xe2\x82\xac", b"a"),
]


@pytest.mark.parametrize("ci", range(len(PAIR_MODEL_CASES)))
def test_pair_state_model_matches_jax_and_plain(ci):
    """The kernel's one-automaton step, modelled in numpy, against
    kernels32.match_ordered_pair_t and match_pair_plain on the same rows,
    both outputs bit for bit."""
    label, a, b = PAIR_MODEL_CASES[ci]
    w = 256 if len(a) + len(b) > 64 else 128 if len(a) + len(b) > 24 else 32
    mat, lens = _pair_case_rows(ci, 600, w, a, b)
    lanes = TL.to_lanes32(mat)
    md, mm = _pair_model(mat, lens, a, b)
    jd, jm = JK32.match_ordered_pair_t(
        jnp.asarray(lanes), jnp.asarray(np.minimum(lens, w)),
        jnp.asarray(np.frombuffer(a, np.uint8)), len(a),
        jnp.asarray(np.frombuffer(b, np.uint8)), len(b))
    pd, pm = K.match_pair_plain(torch.from_numpy(lanes.view(np.int32)),
                                torch.from_numpy(lens), a, b)
    assert np.array_equal(md, np.asarray(jd)), label
    assert np.array_equal(mm, np.asarray(jm)), label
    assert np.array_equal(md, pd.numpy()) and np.array_equal(mm, pm.numpy())
    if b"\n" not in a:
        assert md.any() and mm.any(), label
    assert (~md & ~mm).any(), label


def test_pair_model_cases_reach_the_state_word_edges():
    """The modelled cases hold la + lb at every boundary of the kernel's
    state words (29/30, 61/62) and at 2, 31-33, 63-65 and 128, with one,
    two and five words."""
    sums = {len(a) + len(b) for _l, a, b in PAIR_MODEL_CASES}
    assert {2, 29, 30, 31, 32, 33, 61, 62, 63, 64, 65, 128} <= sums
    assert {_pair_words(n) for n in sums} == {1, 2, 5}
    with open(os.path.join(REPO, "victorialogs_tpu_torch", "csrc",
                           "scan.cu")) as f:
        src = f.read()
    assert "return n <= 29 ? 1 : n <= 61 ? 2 : 5;" in src


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
    # `nothere` lies in no block: each part's bloom folds kill it
    # before any block is read (storage/filterbank.py), as in JAX
    ('~":nothere:x.*GET"', "pruned"),
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
    elif where == "pruned":
        assert c["agg_pruned_parts"] > 0 and \
            c["host_parts"] == c["device_parts"] == 0, c
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
    # killed by each part's bloom folds before a program is planned
    ('~":nothere:x.*GET"', set()),
    ('~"dead.*line.*exceeded"', {"verify", "and", "scan"}),
    # on the path store: the tokens `api` and `v1` keep the blocks of
    # apps 0 and 1 only
    ('~"/api/v1/users.*timeout"', {"gpair"}),
])
def test_regexp_leaves_plan_their_nodes(request, q, kinds):
    if "/api/" in q:
        port, _jax = request.getfixturevalue("path_stores")
    else:
        _start, port, _jax = request.getfixturevalue("stores")
    got = set()
    for tree, *_ in _programs(port, q):
        _kinds(tree, got)
    assert got == kinds


# ---------------- the bloom-gated pair ----------------

def _smoke():
    """chip_smoke.py, loaded from the repo root (its row makers)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def path_stores(tmp_path_factory):
    """Both packages' stores of chip_smoke.path_rows over 8 streams in two
    flushes: request paths (`GET /api/v1/users/<n> timeout`, newlines,
    truncated values) in the streams of apps 0 and 1 only, the
    generator's words elsewhere."""
    _load_port()
    smoke = _smoke()
    start = today_start_ns()
    span = NS_PER_DAY // 8
    port = Storage(device="cpu")
    jax_st = JS.Storage(str(tmp_path_factory.mktemp("jaxpaths")))
    for k in range(2):
        lr = LogRows(stream_fields=["app", "host"])
        jl = JLR.LogRows(stream_fields=["app", "host"])
        for ts, fields in smoke.path_rows(1200, 20 + k, start + k * span,
                                          span, streams=8, long_every=37):
            lr.add(TenantID(0, 0), ts, fields)
            jl.add(JLR.TenantID(0, 0), ts, fields)
        port.must_add_rows(lr)
        port.debug_flush()
        jax_st.must_add_rows(jl)
        jax_st.debug_flush()
    yield port, jax_st
    jax_st.close()
    port.close()


PATH_ROW_QUERIES = [
    '~"/api/v1/users.*timeout"',
    '~"GET /api/v1/users.*timeout"',
    '~"/api/v1/users.*ok"',
    'not ~"/api/v1/users.*timeout"',
    '~"/api/v1/users.*timeout" _stream:{app="app-1"}',
]


@pytest.mark.parametrize("qi", range(len(PATH_ROW_QUERIES)))
def test_gated_pair_query_matches_jax(path_stores, qi):
    """Gated pair queries through the port's host executor and
    TorchBatchRunner(device="cpu") against the JAX package's host
    executor and BatchRunner; every part on the device, the newline and
    truncated rows settled on the host."""
    port, jax_st = path_stores
    q = PATH_ROW_QUERIES[qi]
    want = jax_run(jax_st, JT, q)
    assert want
    assert run_query_collect(port, T, q) == want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert run_query_collect(port, T, q, runner=runner) == want
        _check_runner(runner, "maybe" if "ok" not in q else "card")
    finally:
        runner.close()
    br = BatchRunner()
    try:
        assert jax_run(jax_st, JT, q, runner=br) == want
    finally:
        br.close()


def test_gated_pair_ndjson_and_stats_match_jax(path_stores):
    """The gated pair's NDJSON export, /select/logsql/query at limit 50
    and `stats by (app) count()` (run_query_collect and
    /select/logsql/stats_query) equal the JAX package's."""
    port, jax_st = path_stores
    q = PATH_ROW_QUERIES[0]
    fq = q + " | fields _time, _msg, app"
    want = _ndjson(jax_run_query, jax_st, JT, fq, jax_ndjson)
    assert want
    runner = TorchBatchRunner(device="cpu")
    try:
        assert _ndjson(run_query, port, T, fq, emit.ndjson_block,
                       runner=runner) == want
        args = {"query": q, "limit": "50"}
        assert sel.handle_query(port, dict(args), {}, runner=runner) == \
            list(jsel.handle_query(jax_st, dict(args), {}))
        sq = q + " | stats by (app) count()"
        want = jax_run(jax_st, JT, sq)
        assert len(want) == 2
        assert run_query_collect(port, T, sq, runner=runner) == want
        br = BatchRunner()
        try:
            assert jax_run(jax_st, JT, sq, runner=br) == want
        finally:
            br.close()
        args = {"query": sq, "time": format_rfc3339(
            today_start_ns() + NS_PER_DAY // 2)}
        assert sel.handle_stats_query(port, dict(args), {},
                                      runner=runner) == \
            jsel.handle_stats_query(jax_st, dict(args), {})
        c = runner.stats_counters
        assert c["host_parts"] == 0 and c["maybe_rows"] > 0, c
    finally:
        runner.close()


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
