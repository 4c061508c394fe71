"""The pair-grid kernel module (psulvsb_tpu_torch/ops/hist.py).

On the CPU the port's `pair_ratio_histogram`, `pair_beta_count` and
`exact_peak_bin` run their plain PyTorch versions. They are held against
the JAX front doors of psulvsb_tpu/ops/pallas_hist.py, which run the Pallas
kernels in interpret mode on the CPU (small blocks, t_block=8 and
c_block=32, keep that fast), and against the XLA direct sweep over all
pairs (the `_xla_reference` of tests/test_pallas_hist.py).

Tolerances: against the XLA direct sweep, equal counts (both take the
distances from direct differences in float32). Against the Pallas kernels,
whose distances come from |a|^2 + |b|^2 - 2ab, at most 2 pairs per call may
move to a neighbouring bin or across the beta edge, with equal totals for
clamped windows and the same argmax; exact_peak_bin's peak, count and
certificate equal. exact_peak_bin reads the two-pass rule off one
full-resolution histogram (2065 bins at its defaults); the plain two passes
and the Pallas front door hold it. The beta count is also held at the sizes
1, 2, 31, 32, 33, 129 and 257, the edges of the CUDA kernel's tiles, each
with all, about 80% and one of the points active, and on the edge-of-beta
fixture of chip_smoke.py (pairs whose difference is beta - 2 ... beta + 2
ulp exactly). The CUDA cases hold each kernel against its plain version on
the card (counts equal, one launch a call) and skip here; they need no JAX
(`python -m pytest tests/test_torch_hist.py -m cuda --noconftest`).
"""

import types

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.ops import hist
from psulvsb_tpu_torch.ops._build import LAUNCHES

FLIPS = 2
EDGE_SIZES = [1, 2, 31, 32, 33, 129, 257]
MASKS = ["all", "80%", "one"]
BETAS = [0.02, 0.1]
SMALL_BLOCKS = dict(t_block=8, c_block=32)
WINDOWS = {
    "coarse": dict(num_bins=128, stride=16, clamp_overflow=True),
    "fine": dict(num_bins=48, lo_bin=48, stride=1, clamp_overflow=False),
    "exact_hist": dict(num_bins=512, stride=1, clamp_overflow=True),
}


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jax.numpy and the Pallas front doors (interpret
    mode on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from psulvsb_tpu.ops import pallas_hist

    return types.SimpleNamespace(jnp=jnp, ph=pallas_hist)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(c, seed, test_scale=3.7, rate=0.85, inactive=0.2):
    """A mismatch-outlier pair of C points stretched by test_scale (ratio
    peak at fine bin ~74, inside every window above) and an active mask
    with a share of points off, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pair = make_synthetic_pair(
        rng, synthetic_cloud(c, seed=seed), 0.01, rate, outlier_mode="mismatch",
        test_scale=test_scale,
    )
    return pair.src, pair.dst, rng.uniform(size=c) >= inactive


def _masked(kind, act, seed):
    """The active mask of a case: None (all active), the input's own mask
    (about 80% on) or one point."""
    if kind == "all":
        return None
    return act if kind == "80%" else np.arange(act.shape[0]) == seed % act.shape[0]


def _xla_direct(jref, src, dst, act, bins_per_unit, lo, stride, num_bins, clamp):
    """Direct-difference sweep over all i < j pairs in jax.numpy."""
    jnp = jref.jnp
    ii, jj = np.triu_indices(src.shape[1], 1)
    s, d = jnp.asarray(src), jnp.asarray(dst)
    st = s[:, jj] - s[:, ii]
    dt = d[:, jj] - d[:, ii]
    v1 = jnp.sqrt(jnp.sum(st * st, axis=0))
    v2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
    fine = jnp.maximum(jnp.floor(v2 / jnp.where(v1 > 0, v1, 1.0) * bins_per_unit).astype(jnp.int32), 0)
    idx = (fine - lo) // stride
    pa = jnp.asarray(act[ii] & act[jj])
    if not clamp:
        pa = pa & (idx >= 0) & (idx < num_bins)
    idx = jnp.clip(idx, 0, num_bins - 1)
    return np.asarray(jnp.zeros((num_bins,), jnp.int32).at[idx].add(pa.astype(jnp.int32)))


def _assert_close_counts(got, want, clamp):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert np.abs(got - want).sum() <= FLIPS, (got, want)
    if clamp:
        assert got.sum() == want.sum()
    assert got.argmax() == want.argmax()


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("c,seed", [(197, 1), (120, 2)])
def test_histogram_matches_pallas_and_xla(jref, window, c, seed):
    src, dst, act = _inputs(c, seed)
    kw = WINDOWS[window]
    got = hist.pair_ratio_histogram(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(act), **kw
    ).numpy()
    pallas = jref.ph.pair_ratio_histogram(
        jref.jnp.asarray(src), jref.jnp.asarray(dst), jref.jnp.asarray(act), **kw, **SMALL_BLOCKS
    )
    _assert_close_counts(got, np.asarray(pallas), kw["clamp_overflow"])
    direct = _xla_direct(
        jref, src, dst, act, 20, kw.get("lo_bin", 0), kw["stride"], kw["num_bins"],
        kw["clamp_overflow"],
    )
    np.testing.assert_array_equal(got, direct)
    assert got.dtype == np.int64


@pytest.mark.parametrize(
    "c,mask,beta",
    [pytest.param(180, "80%", beta, id=str(beta)) for beta in BETAS]
    + [(c, m, beta) for c in EDGE_SIZES for m in MASKS for beta in BETAS],
)
def test_beta_count_matches_pallas_and_xla(jref, c, mask, beta):
    src, dst, act = _inputs(c, 3, test_scale=1.0)
    act = _masked(mask, act, 3)
    got = int(hist.pair_beta_count(
        torch.as_tensor(src), torch.as_tensor(dst), beta,
        None if act is None else torch.as_tensor(act),
    ))
    jnp = jref.jnp
    pallas = int(jref.ph.pair_beta_count(
        jnp.asarray(src), jnp.asarray(dst), beta, None if act is None else jnp.asarray(act),
        **SMALL_BLOCKS
    ))
    assert abs(got - pallas) <= FLIPS, (got, pallas)
    act = np.ones(c, bool) if act is None else act
    ii, jj = np.triu_indices(src.shape[1], 1)
    s, d = jnp.asarray(src), jnp.asarray(dst)
    st, dt = s[:, jj] - s[:, ii], d[:, jj] - d[:, ii]
    v1 = jnp.sqrt(jnp.sum(st * st, axis=0))
    v2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
    direct = int(jnp.sum((jnp.abs(v1 - v2) <= beta) & jnp.asarray(act[ii] & act[jj])))
    assert got == direct


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("turned", [False, True])
def test_beta_edge_fixture_sits_on_the_edge(beta, turned):
    """chip_smoke's edge-of-beta fixture: between its two clusters every
    difference is beta + m ulp, m in -2 ... 2, so 3 ulp of beta to either
    side move pairs across the edge; on an axis, where the differences are
    exact, the plain count is the one the construction gives."""
    from chip_smoke import beta_edge_inputs, beta_thresholds

    n = 64
    src, dst = beta_edge_inputs(beta, 17, torch.device("cpu"), turned, n=n)
    assert src.shape == dst.shape == (3, 2 * n) and src.dtype == torch.float32
    below, at, above = (int(hist.pair_beta_count(src, dst, b)) for b in beta_thresholds(beta))
    assert below < at < above
    if not turned:
        far = np.arange(2 * n) >= n
        m = np.rint(
            ((dst[0].double() - src[0].double()).numpy()[far] - float(np.float32(beta)))
            / float(np.spacing(np.float32(beta)))
        )
        assert set(m) <= {-2.0, -1.0, 0.0, 1.0, 2.0} and len(set(m)) == 5
        # Origin-origin pairs all pass; origin-far pairs pass when m <= 0.
        cross = lambda limit: n * int((m <= limit).sum())  # noqa: E731
        inside = int(hist.pair_beta_count(src, dst, beta, torch.as_tensor(far)))
        assert at == n * (n - 1) // 2 + cross(0) + inside
        assert below == n * (n - 1) // 2 + cross(-3) + int(
            hist.pair_beta_count(src, dst, beta_thresholds(beta)[0], torch.as_tensor(far)))


@pytest.mark.parametrize(
    "case", ["clustered", "mismatch_uncertified", "out_of_window_200x"]
)
def test_exact_peak_bin_matches_pallas(jref, case):
    rng = np.random.default_rng(7)
    if case == "clustered":  # the certified case of tests/test_pallas_hist.py
        src = rng.normal(size=(3, 160)).astype(np.float32)
        dst = (src * 1.05 + rng.normal(size=(3, 160)) * 0.01).astype(np.float32)
        act = np.ones(160, bool)
    elif case == "mismatch_uncertified":
        src, dst, act = _inputs(150, 4)
    else:
        src = rng.normal(size=(3, 120)).astype(np.float32)
        dst = (src * 200.0 + rng.normal(size=(3, 120)) * 0.01).astype(np.float32)
        act = np.ones(120, bool)
    got = [int(x) for x in hist.exact_peak_bin(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(act)
    )]
    jnp = jref.jnp
    want = [int(x) for x in jref.ph.exact_peak_bin(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(act)
    )]
    assert got == want
    assert bool(got[2]) == (case == "clustered")


def _peak_case(case):
    """Inputs of the one-launch peak rule's cases, as numpy arrays."""
    rng = np.random.default_rng(11)
    if case == "inside_3.7x":  # the peak (fine bin ~74) inside the coarse window
        return _inputs(150, 4)
    if case == "coarse_peak_at_0":  # ratio 0.3: fine bin 6, coarse bin 0, lo = 0
        src = rng.normal(size=(3, 120)).astype(np.float32)
        dst = (src * 0.3 + rng.normal(size=(3, 120)) * 0.002).astype(np.float32)
        return src, dst, np.ones(120, bool)
    if case == "clamp_bin_200x":  # every ratio past the last coarse bin
        src = rng.normal(size=(3, 100)).astype(np.float32)
        dst = (src * 200.0 + rng.normal(size=(3, 100)) * 0.01).astype(np.float32)
        return src, dst, np.ones(100, bool)
    if case == "fine_tie":  # 3 pairs, ratios 1.52, 1.57, 1.62: fine bins 30, 31, 32 once each
        src = np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32)
        dst = np.array([[0, 1.52, 0], [0, 0, 1.62], [0, 0, 0]], np.float32)
        return src, dst, np.ones(3, bool)
    if case == "all_inactive":
        src = rng.normal(size=(3, 50)).astype(np.float32)
        return src, src * 2.0, np.zeros(50, bool)
    assert case == "c2"
    return np.array([[0, 1], [0, 0], [0, 0]], np.float32), np.array(
        [[0, 2.5], [0, 0], [0, 0]], np.float32), np.ones(2, bool)


@pytest.mark.parametrize(
    "case",
    ["inside_3.7x", "coarse_peak_at_0", "clamp_bin_200x", "fine_tie", "all_inactive", "c2"],
)
def test_one_launch_peak_rule(jref, case):
    """(peak, count, certified) read off one 2065-bin full pass equal the
    two-pass rule's, plain and Pallas (interpret mode)."""
    src, dst, act = _peak_case(case)
    s, d, a = (torch.as_tensor(x) for x in (src, dst, act))
    full_bins = (128 + 1) * 16 + 1
    full = hist.pair_ratio_histogram_reference(s, d, a, num_bins=full_bins)
    assert full_bins == 2065 and int(full.sum()) == int(a.sum()) * (int(a.sum()) - 1) // 2
    got = [int(x) for x in hist.peak_from_full_histogram(full, 128, 16)]
    assert got == [int(x) for x in hist.exact_peak_bin(s, d, a)]
    assert got == [int(x) for x in hist.exact_peak_bin_reference(s, d, a)]
    jnp = jref.jnp
    want = [int(x) for x in jref.ph.exact_peak_bin(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(act)
    )]
    assert got == want
    coarse = hist.pair_ratio_histogram_reference(s, d, a, num_bins=128, stride=16)
    cpeak = int(coarse.argmax())
    if case == "coarse_peak_at_0":
        assert cpeak == 0 and got[0] < 16
    if case == "clamp_bin_200x":
        assert cpeak == 127 and not got[2]
    if case == "fine_tie":
        lo = max(cpeak - 1, 0) * 16
        window = full[lo:lo + 48]
        assert int((window == window.max()).sum()) == 3 and got[:2] == [30, 1]
    if case == "all_inactive":
        assert got == [0, 0, 1]  # an empty histogram certifies bin 0, as the two passes do
    if case == "c2":
        assert got[:2] == [50, 1]


@pytest.mark.parametrize(
    "kw",
    [dict(num_bins=1), dict(stride=0), dict(num_bins=255, stride=16), dict(num_bins=2049, stride=1)],
)
def test_bad_peak_windows_raise(kw):
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        hist.exact_peak_bin(x, x, **kw)


def test_reference_and_front_door_agree_on_cpu():
    src, dst, act = (torch.as_tensor(x) for x in _inputs(90, 5))
    for kw in WINDOWS.values():
        assert torch.equal(
            hist.pair_ratio_histogram(src, dst, act, **kw),
            hist.pair_ratio_histogram_reference(src, dst, act, **kw),
        )
    assert [int(x) for x in hist.exact_peak_bin(src, dst, act)] == [
        int(x) for x in hist.exact_peak_bin_reference(src, dst, act)
    ]
    # A 0-d tensor window start gives the same counts as an int.
    kw = dict(WINDOWS["fine"], lo_bin=torch.tensor(48))
    assert torch.equal(
        hist.pair_ratio_histogram(src, dst, act, **kw),
        hist.pair_ratio_histogram(src, dst, act, **WINDOWS["fine"]),
    )


def test_inactive_points_never_vote():
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(3, 100)).astype(np.float32))
    dst = torch.as_tensor(rng.normal(size=(3, 100)).astype(np.float32))
    act = torch.arange(100) < 60
    assert int(hist.pair_ratio_histogram(src, dst, act, num_bins=256).sum()) == 60 * 59 // 2
    assert int(hist.pair_beta_count(src, dst, 1e9, act)) == 60 * 59 // 2
    assert int(hist.pair_beta_count(src, dst, 1e9)) == 100 * 99 // 2


@pytest.mark.parametrize(
    "kw", [dict(num_bins=0), dict(num_bins=hist.MAX_BINS + 1), dict(stride=0)]
)
def test_bad_windows_raise(kw):
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        hist.pair_ratio_histogram(x, x, **kw)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        hist.pair_beta_count(torch.zeros(3, 8), torch.zeros(3, 9), 0.1)
    with pytest.raises(ValueError):
        hist.pair_ratio_histogram(torch.zeros(3, 8), torch.zeros(3, 8), torch.ones(7, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [197, 1889, 5000])
def test_cuda_kernels_match_plain_versions(cuda_device, c):
    src, dst, act = (torch.as_tensor(x, device=cuda_device) for x in _inputs(c, c))
    for kw in WINDOWS.values():
        before = LAUNCHES["pair_ratio_hist"]
        got = hist.pair_ratio_histogram(src, dst, act, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["pair_ratio_hist"] == before + 1
        want = hist.pair_ratio_histogram_reference(src, dst, act, **kw)
        _assert_close_counts(got.cpu().numpy(), want.cpu().numpy(), kw["clamp_overflow"])
    for beta in (0.02, 0.1):
        before = LAUNCHES["pair_beta_count"]
        got = int(hist.pair_beta_count(src, dst / 3.7, beta, act))
        assert LAUNCHES["pair_beta_count"] == before + 1
        assert got == int(hist.pair_beta_count_reference(src, dst / 3.7, beta, act))
    k = [int(x) for x in hist.exact_peak_bin(src, dst, act)]
    p = [int(x) for x in hist.exact_peak_bin_reference(src, dst, act)]
    assert k == p


@pytest.mark.cuda
@pytest.mark.parametrize("c", EDGE_SIZES)
@pytest.mark.parametrize("mask", MASKS)
def test_cuda_beta_count_equals_plain_at_tile_edges(cuda_device, c, mask):
    """The count equals the plain version's at the edges of the kernel's
    tiles, with one launch a call."""
    src, dst, act = _inputs(c, c, test_scale=1.0)
    act = _masked(mask, act, c)
    src, dst = torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device)
    act = None if act is None else torch.as_tensor(act, device=cuda_device)
    for beta in BETAS:
        before = LAUNCHES["pair_beta_count"]
        got = int(hist.pair_beta_count(src, dst, beta, act))
        assert LAUNCHES["pair_beta_count"] == before + 1
        assert got == int(hist.pair_beta_count_reference(src, dst, beta, act))


@pytest.mark.cuda
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("turned", [False, True])
def test_cuda_beta_count_on_the_edge_of_beta(cuda_device, beta, turned):
    """Pairs whose difference is beta to the last ulp on both sides: the
    kernel's fast test must hand each of them to the exact expression."""
    from chip_smoke import beta_edge_inputs, beta_thresholds

    src, dst = beta_edge_inputs(beta, 17, cuda_device, turned)
    for b in beta_thresholds(beta):
        assert int(hist.pair_beta_count(src, dst, b)) == int(
            hist.pair_beta_count_reference(src, dst, b))


@pytest.mark.cuda
def test_cuda_small_inputs(cuda_device):
    for c in (0, 1):
        x = torch.zeros(3, c, device=cuda_device)
        assert int(hist.pair_ratio_histogram(x, x, num_bins=8).sum()) == 0
        assert int(hist.pair_beta_count(x, x, 0.1)) == 0
        assert [int(v) for v in hist.exact_peak_bin(x, x)] == [
            int(v) for v in hist.exact_peak_bin_reference(x, x)
        ]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 63, 64, 65, 1250, 16384])
def test_cuda_histogram_equals_plain(cuda_device, c):
    """Counts equal the plain version's (difference 0) on every window,
    exact_peak_bin's full 2065-bin pass and the 4096-bin limit included, and
    exact_peak_bin launches the kernel once a call."""
    src, dst, act = (torch.as_tensor(x, device=cuda_device) for x in _inputs(c, c))
    windows = dict(
        WINDOWS,
        full=dict(num_bins=2065, stride=1, clamp_overflow=True),
        widest=dict(num_bins=hist.MAX_BINS, lo_bin=torch.tensor(7, device=cuda_device),
                    stride=1, clamp_overflow=False),
    )
    for name, kw in windows.items():
        got = hist.pair_ratio_histogram(src, dst, act, **kw)
        want = hist.pair_ratio_histogram_reference(src, dst, act, **kw)
        assert torch.equal(got.cpu(), want.cpu()), name
    for a in (act, None, torch.zeros_like(act)):
        before = LAUNCHES["pair_ratio_hist"]
        k = [int(x) for x in hist.exact_peak_bin(src, dst, a)]
        assert LAUNCHES["pair_ratio_hist"] == before + 1
        assert k == [int(x) for x in hist.exact_peak_bin_reference(src, dst, a)]



@pytest.mark.cuda
@pytest.mark.parametrize("p,c", [(8, 1889), (3, 5000)])
def test_cuda_exact_peak_bin_pair_axis(cuda_device, p, c):
    """One launch for P pairs: each pair's (peak, count, certified) that of
    its own call and of the plain version with the pair axis."""
    inputs = [tuple(torch.as_tensor(x, device=cuda_device) for x in _inputs(c, c + q))
              for q in range(p)]
    src, dst, act = (torch.stack(x) for x in zip(*inputs))
    before = LAUNCHES["pair_ratio_hist"]
    got = [x.tolist() for x in hist.exact_peak_bin(src, dst, act)]
    assert LAUNCHES["pair_ratio_hist"] == before + 1
    alone = [[hist.exact_peak_bin(*x)[k].item() for x in inputs] for k in range(3)]
    full = hist.pair_ratio_histogram_reference(src, dst, act, num_bins=(128 + 1) * 16 + 1)
    plain = [x.tolist() for x in hist.peak_from_full_histogram(full, 128, 16)]
    assert got == alone == plain


P_AXIS, C_AXIS = 3, 64  # the pair axes against jax.vmap of the Pallas front doors


def _pair_axis_inputs(c, p, seed, test_scale=3.7):
    src, dst, act = zip(*(_inputs(c, seed + q, test_scale) for q in range(p)))
    return [torch.as_tensor(np.stack(x)) for x in (src, dst, act)]


def test_beta_count_pair_axis_matches_jax_vmap(jref):
    """P = 3 pairs of C = 64: `torch.func.vmap` over the port's
    pair_beta_count, its (P, 3, C) front door and P single calls give equal
    counts, equal to `jax.vmap` of the Pallas front door in interpret mode."""
    import jax

    beta = 0.1
    t = _pair_axis_inputs(C_AXIS, P_AXIS, 600, test_scale=1.0)
    want = np.asarray(jax.vmap(lambda s, d, a: jref.ph.pair_beta_count(
        s, d, beta, a, **SMALL_BLOCKS))(*(jref.jnp.asarray(x.numpy()) for x in t)))
    via_vmap = torch.func.vmap(lambda s, d, a: hist.pair_beta_count(s, d, beta, a))(*t)
    axis = hist.pair_beta_count(t[0], t[1], beta, t[2])
    alone = torch.stack([hist.pair_beta_count(t[0][q], t[1][q], beta, t[2][q])
                         for q in range(P_AXIS)])
    assert axis.shape == (P_AXIS,) and axis.dtype == torch.int64
    assert torch.equal(via_vmap, axis) and torch.equal(axis, alone)
    np.testing.assert_array_equal(axis.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_histogram_pair_axis_matches_jax_vmap(jref, window):
    """The windowed histogram over P = 3 pairs of C = 64: `torch.func.vmap`
    over the port's front door, its (P, 3, C) front door and P single calls
    give equal counts, equal to `jax.vmap` of the Pallas front door in
    interpret mode; a vmapped `lo_bin` gives each pair its own window."""
    import jax

    kw = WINDOWS[window]
    t = _pair_axis_inputs(C_AXIS, P_AXIS, 700)
    want = np.asarray(jax.vmap(lambda s, d, a: jref.ph.pair_ratio_histogram(
        s, d, a, **kw, **SMALL_BLOCKS))(*(jref.jnp.asarray(x.numpy()) for x in t)))
    via_vmap = torch.func.vmap(lambda s, d, a: hist.pair_ratio_histogram(s, d, a, **kw))(*t)
    axis = hist.pair_ratio_histogram(*t, **kw)
    alone = torch.stack([hist.pair_ratio_histogram(t[0][q], t[1][q], t[2][q], **kw)
                         for q in range(P_AXIS)])
    assert axis.shape == (P_AXIS, kw["num_bins"]) and axis.dtype == torch.int64
    assert torch.equal(via_vmap, axis) and torch.equal(axis, alone)
    np.testing.assert_array_equal(axis.numpy(), want.astype(np.int64))
    if window == "fine":
        lo = torch.tensor([40, 48, 56])
        per_pair = torch.func.vmap(lambda s, d, a, lo_q: hist.pair_ratio_histogram(
            s, d, a, **{**kw, "lo_bin": lo_q}))(*t, lo)
        for q in range(P_AXIS):
            assert torch.equal(per_pair[q], hist.pair_ratio_histogram(
                t[0][q], t[1][q], t[2][q], **{**kw, "lo_bin": int(lo[q])}))
        assert torch.equal(hist.pair_ratio_histogram(*t, **{**kw, "lo_bin": lo}), per_pair)


@pytest.mark.cuda
def test_cuda_pair_axes_equal_single_launches_and_plain(cuda_device):
    """P = 8 pairs in one launch each: the beta count at C = 12000 and the
    windowed histogram at C = 1889 (a lo on the device for each pair) equal
    P single launches and the plain version; vmap comes to the same launch."""
    p = 8
    src, dst, act = (x.to(cuda_device) for x in _pair_axis_inputs(12000, p, 800, 1.0))
    before = LAUNCHES["pair_beta_count"]
    got = hist.pair_beta_count(src, dst, 0.1, act)
    torch.cuda.synchronize()
    assert LAUNCHES["pair_beta_count"] == before + 1
    assert torch.equal(got, hist.pair_beta_count_reference(src, dst, 0.1, act))
    assert torch.equal(got, torch.stack([hist.pair_beta_count(src[q], dst[q], 0.1, act[q])
                                         for q in range(p)]))
    src, dst, act = (x.to(cuda_device) for x in _pair_axis_inputs(1889, p, 900))
    lo = torch.arange(40, 40 + 2 * p, 2, device=cuda_device)
    kw = dict(num_bins=48, stride=1, clamp_overflow=False)
    before = LAUNCHES["pair_ratio_hist"]
    got = torch.func.vmap(lambda s, d, a, lo_q: hist.pair_ratio_histogram(
        s, d, a, lo_bin=lo_q, **kw))(src, dst, act, lo)
    torch.cuda.synchronize()
    assert LAUNCHES["pair_ratio_hist"] == before + 1
    assert torch.equal(got, hist.pair_ratio_histogram_reference(src, dst, act, lo_bin=lo, **kw))
    for q in range(p):
        assert torch.equal(got[q], hist.pair_ratio_histogram(src[q], dst[q], act[q],
                                                             lo_bin=lo[q], **kw))


@pytest.mark.parametrize("shape", [(1,), (2,), (4,), (3, 1)])
def test_lo_of_the_wrong_shape_raises(shape):
    """A lo on the device is 0-d or one a pair: a (1,) lo over three pairs,
    a lo shorter or longer than the pairs and a 2-D lo raise, as they do on
    a card, where the kernel would read one lo a pair."""
    src, dst, act = _pair_axis_inputs(C_AXIS, P_AXIS, 950)
    lo = torch.full(shape, 40, dtype=torch.int64)
    with pytest.raises(ValueError, match="lo_bin"):
        hist.pair_ratio_histogram(src, dst, act, num_bins=32, lo_bin=lo, clamp_overflow=False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (4,), (8, 1)])
def test_cuda_lo_of_the_wrong_shape_raises(cuda_device, shape):
    """On a card, a lo that is neither 0-d nor (P,) raises before the
    launch: the kernel reads one lo a pair and would read past it."""
    src, dst, act = (x.to(cuda_device) for x in _pair_axis_inputs(1889, 8, 960))
    lo = torch.full(shape, 40, dtype=torch.int64, device=cuda_device)
    before = LAUNCHES["pair_ratio_hist"]
    with pytest.raises(ValueError, match="lo_bin"):
        hist.pair_ratio_histogram(src, dst, act, num_bins=32, lo_bin=lo, clamp_overflow=False)
    assert LAUNCHES["pair_ratio_hist"] == before
