"""The split-block gate's kernels against their plain versions.

- On the card (marked `cuda`, skipped here): the standalone probe
  `plane_keep_sb` (csrc/probe.cu `vl_plane_keep_sb`), the scan behind a
  split-block gate (`match_scan_gated_sb`, csrc/scan.cu) and the pair
  behind one (`match_pair_gated_sb`), at chip_smoke's sweep shapes and
  at the gate's edges (`sb_gate_edge_cases`: blocks of 0-33 rows,
  nsb 0, 1-8 tokens, lane bases outside the plane, more block starts
  than a CTA keeps), every output bit for bit.
- On the CPU: the plain probe equals the numpy host probe
  (`probe_np_sb`, the JAX package's) and the per-block truth the edge
  cases were built with, and chip_smoke's bound of the split-block
  probe counts the tokens a block tests up to its first miss.

This file imports no JAX: run the `cuda` tests on a machine with an
NVIDIA GPU with `python -m pytest tests/test_torch_sbgate.py -m cuda`.
"""

import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch and the port load on first use, in the worker that runs these
# tests, not in every worker that only collects this module
torch = BD = K = TL = None


@pytest.fixture(autouse=True)
def _port():
    global torch, BD, K, TL
    import torch
    from victorialogs_tpu_torch.gpu import bloom_device as BD
    from victorialogs_tpu_torch.gpu import kernels as K
    from victorialogs_tpu_torch.gpu import layout as TL
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py, loaded from the repo root."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _probe_args(case, dev):
    _starts, plane, nsb, sbidx, mask = case
    return [torch.from_numpy(a).to(dev) for a in (plane, sbidx, mask, nsb)]


# ---------------- on the CPU ----------------

@pytest.mark.parametrize("t", [1, 4, 5, 8])
@pytest.mark.parametrize("outside", [0.0, 1.0])
def test_plain_probe_keeps_the_built_blocks(smoke, t, outside):
    """sb_gate_case keeps exactly the blocks it was asked to, and the
    plain probe and the numpy host probe say so."""
    rng = np.random.default_rng(t)
    kept = rng.random(300) < 0.5
    case = smoke.sb_gate_case(rng, [10] * 300, t=t, kept=kept,
                              outside=outside, mmax=16 if t > 4 else 4)
    got = BD.plane_keep_sb(*_probe_args(case, "cpu")).numpy()
    assert np.array_equal(got[:300], kept)
    assert got[300:].all()              # pad blocks: nsb 0
    if outside == 0.0:
        _s, plane, nsb, sbidx, mask = case
        host = BD.probe_np_sb(plane.view(np.uint32), sbidx,
                              mask.view(np.uint32), nsb)
        assert np.array_equal(host, got)


def test_plain_probe_edge_cases_match_the_host_probe(smoke):
    rng = np.random.default_rng(3)
    for label, _s, plane, nsb, sbidx, mask in smoke.sb_gate_edge_cases(rng):
        got = BD.plane_keep_sb(*_probe_args(
            (_s, plane, nsb, sbidx, mask), "cpu")).numpy()
        inside = (sbidx >= 0).all() and sbidx.max() + 8 <= plane.shape[1]
        if inside:
            assert np.array_equal(got, BD.probe_np_sb(
                plane.view(np.uint32), sbidx, mask.view(np.uint32), nsb)), \
                label
        assert got[nsb == 0].all(), label


@pytest.mark.parametrize("t", [1, 5])
def test_smoke_sb_bound_counts_tokens_to_the_first_miss(smoke, t):
    """sb_token_counts: per block the tokens up to and including the
    first whose lanes miss its mask (all t when none does), none where
    nsb is 0; sb_probe_work prices them at a 32-byte sector and a lane
    base each."""
    rng = np.random.default_rng(10 + t)
    _s, plane, nsb, sbidx, mask = smoke.sb_gate_case(
        rng, [5] * 200, t=t, kept=0.5, no_filter=0.2, outside=0.3,
        mmax=8)
    p, i, m, n = (torch.from_numpy(a) for a in (plane, sbidx, mask, nsb))
    got = smoke.sb_token_counts(p, i, m, n).numpy()
    pl, mk = plane.view(np.uint32), mask.view(np.uint32)
    for b in range(plane.shape[0]):
        want = 0
        if nsb[b]:
            for tk in range(t):
                want += 1
                lanes = [int(pl[b, x]) if 0 <= x < pl.shape[1] else 0
                         for x in range(sbidx[b, tk], sbidx[b, tk] + 8)]
                if any(w & int(mv) != int(mv)
                       for w, mv in zip(lanes, mk[tk])):
                    break
        assert got[b] == want, b
    nbytes, ops = smoke.sb_probe_work(p, i, m, n)
    assert ops == 8 * int(got.sum())
    assert nbytes == 36 * int(got.sum()) + 5 * plane.shape[0] + 32 * t


# ---------------- on the card ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,t,mmax", [(1, 1, 4), (1000, 4, 4),
                                      (3001, 8, 16)])
def test_cuda_plane_keep_sb_matches_plain(smoke, cuda_device, b, t, mmax):
    rng = np.random.default_rng(b + t)
    case = smoke.sb_gate_case(rng, [1] * b, t=t, mmax=mmax, no_filter=0.1)
    args = _probe_args(case, cuda_device)
    assert torch.equal(BD.plane_keep_sb(*args),
                       BD.plane_keep_sb_plain(*args))


@pytest.mark.cuda
def test_cuda_plane_keep_sb_edge_cases(smoke, cuda_device):
    rng = np.random.default_rng(5)
    for label, *case in smoke.sb_gate_edge_cases(rng):
        args = _probe_args(case, cuda_device)
        assert torch.equal(BD.plane_keep_sb(*args),
                           BD.plane_keep_sb_plain(*args)), label


@pytest.mark.cuda
@pytest.mark.parametrize("mode", range(5))
def test_cuda_scan_gated_sb_matches_plain(smoke, cuda_device, mode):
    rng = np.random.default_rng(20 + mode)
    mat, lens = smoke.rand_rows(rng, smoke.GATE_ROWS, 32)
    lanes = torch.from_numpy(TL.to_lanes32(mat).view("<i4")).to(cuda_device)
    lt = torch.from_numpy(lens).to(cuda_device)
    ovf = torch.from_numpy(rng.random(len(lens)) < 0.1).to(cuda_device)
    for label, *g in smoke.sb_gate_edge_cases(rng):
        gate = smoke.sb_inputs(cuda_device, *g)
        for fold in (False, True):
            for st, et in ((False, False), (True, True)):
                for ov in (None, ovf):
                    a = (lanes, lt, b"ab", mode, st, et, fold, gate, ov)
                    got = K.match_scan_gated_sb(*a)
                    want = K.match_scan_gated_plain(*a)
                    assert torch.equal(got[0], want[0]), label
                    assert (got[1] is None) == (ov is None), label
                    assert ov is None or torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_pair_gated_sb_matches_plain(smoke, cuda_device):
    rng = np.random.default_rng(31)
    a, b = b"ab", b"\xe2\x82\xacb"
    mat, lens = smoke.pair_rows(rng, smoke.GATE_ROWS, 32, a, b)
    lanes = torch.from_numpy(TL.to_lanes32(mat).view("<i4")).to(cuda_device)
    lt = torch.from_numpy(lens).to(cuda_device)
    ovf = torch.from_numpy(rng.random(len(lens)) < 0.1).to(cuda_device)
    for label, *g in smoke.sb_gate_edge_cases(rng):
        gate = smoke.sb_inputs(cuda_device, *g)
        for ov in (None, ovf):
            got = K.match_pair_gated_sb(lanes, lt, a, b, gate, ov)
            want = K.match_pair_gated_plain(lanes, lt, a, b, gate, ov)
            assert torch.equal(got[0], want[0]), label
            assert torch.equal(got[1], want[1]), label
