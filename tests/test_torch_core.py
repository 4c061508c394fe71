"""Core, robust-estimator and metric functions of the port against their
JAX counterparts on the same numpy-seeded inputs.

Tolerances: 1e-5 absolute on rotations, translations and estimates (both
sides run float32; only the summation order differs), 1e-6 relative on
RMSE and inlier probability, exact equality on masks."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psulvsb_tpu.core import linalg as jl
from psulvsb_tpu.core import metrics as jm
from psulvsb_tpu.robust import scalar_tls as js
from psulvsb_tpu.robust import scale as jsc
from psulvsb_tpu.robust import translation as jt
from psulvsb_tpu_torch.core import linalg as tl
from psulvsb_tpu_torch.core import metrics as tm
from psulvsb_tpu_torch.robust import scalar_tls as ts
from psulvsb_tpu_torch.robust import scale as tsc
from psulvsb_tpu_torch.robust import translation as tt

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(tl._quat_to_rot(torch.as_tensor(q)), np.float32)


def _rigid_problem(rng, n=200, outliers=0.2):
    r = _rotation(rng)
    t = rng.uniform(-1, 1, size=3).astype(np.float32)
    src = rng.normal(size=(3, n)).astype(np.float32)
    dst = (r @ src + t[:, None] + rng.uniform(-0.01, 0.01, (3, n))).astype(np.float32)
    k = int(n * outliers)
    dst[:, :k] += rng.normal(size=(3, k)).astype(np.float32) * 3
    return src, dst, r, t


@pytest.mark.parametrize("method", ["power", "eigh"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rot_from_correlation(method, seed):
    rng = np.random.default_rng(seed)
    src, dst, _, _ = _rigid_problem(rng, outliers=0.0)
    h = (src @ dst.T).astype(np.float32)
    rj = jl.rot_from_correlation(jnp.asarray(h), method=method)
    rt = tl.rot_from_correlation(_t(h), method=method)
    np.testing.assert_allclose(_np(rt), np.asarray(rj), atol=ATOL)
    # Batched input gives the per-matrix results.
    hb = np.stack([h, h.T, 2 * h]).astype(np.float32)
    rb = tl.rot_from_correlation(_t(hb), method=method)
    for k in range(3):
        ref = jl.rot_from_correlation(jnp.asarray(hb[k]), method=method)
        np.testing.assert_allclose(_np(rb[k]), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_svd_rot_weighted(rng, method):
    src, dst, _, _ = _rigid_problem(rng)
    w = rng.uniform(size=src.shape[1]).astype(np.float32)
    rj = jl.svd_rot(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), method=method)
    rt = tl.svd_rot(_t(src), _t(dst), _t(w), method=method)
    np.testing.assert_allclose(_np(rt), np.asarray(rj), atol=ATOL)


def test_weighted_procrustes_srt(rng):
    src, dst, r, t = _rigid_problem(rng, outliers=0.0)
    w = rng.uniform(size=src.shape[1]).astype(np.float32)
    rj, tj = jl.weighted_procrustes_srt(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    rt, tt_ = tl.weighted_procrustes_srt(_t(src), _t(dst), _t(w))
    np.testing.assert_allclose(_np(rt), np.asarray(rj), atol=ATOL)
    np.testing.assert_allclose(_np(tt_), np.asarray(tj), atol=ATOL)
    np.testing.assert_allclose(_np(rt), r, atol=1e-2)


def test_masked_rmse(rng):
    src, dst, r, t = _rigid_problem(rng)
    mask = rng.uniform(size=src.shape[1]) < 0.6
    for s in (1.0, 1.7):
        j = jm.masked_rmse(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                           jnp.asarray(r), jnp.asarray(t), scale=s)
        p = tm.masked_rmse(_t(src), _t(dst), _t(mask), _t(r), _t(t), scale=s)
        np.testing.assert_allclose(float(p), float(j), rtol=1e-6)
    empty = np.zeros(src.shape[1], bool)
    assert float(tm.masked_rmse(_t(src), _t(dst), _t(empty), _t(r), _t(t))) == np.inf


def test_inlier_probability(rng):
    res = np.concatenate([rng.uniform(0, 0.5, 500), [0.0, 1e-4, 2.0]]).astype(np.float32)
    j = np.asarray(jm.inlier_probability(jnp.asarray(res), 0.05))
    p = _np(tm.inlier_probability(_t(res), 0.05))
    np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-7)


def test_angular_error(rng):
    a, b = _rotation(rng), _rotation(rng)
    j = float(jm.angular_error_deg(jnp.asarray(a), jnp.asarray(b)))
    p = float(tm.angular_error_deg(_t(a), _t(b)))
    assert abs(p - j) < 1e-3
    assert abs(tm.angular_error_deg_np(a, b) - jm.angular_error_deg_np(a, b)) < 1e-9


@pytest.mark.parametrize("warm", [None, 0.31])
@pytest.mark.parametrize("masked", [False, True])
def test_max_stabbing(rng, warm, masked):
    x = np.concatenate([rng.normal(0.3, 0.02, 60), rng.uniform(-5, 5, 140)]).astype(np.float32)
    active = rng.uniform(size=x.size) < 0.7 if masked else np.ones(x.size, bool)
    wv = None if warm is None else np.float32(warm)
    ej, ij = js.max_stabbing(jnp.asarray(x), 0.05, jnp.asarray(active),
                             None if wv is None else jnp.asarray(wv), warm is not None)
    ep, ip = ts.max_stabbing(_t(x), 0.05, _t(active),
                             None if wv is None else _t(wv), warm is not None)
    assert abs(float(ep) - float(ej)) <= ATOL
    np.testing.assert_array_equal(_np(ip), np.asarray(ij))


def test_max_stabbing_batched_rows_match_single(rng):
    x = rng.uniform(-1, 1, size=(4, 50)).astype(np.float32)
    act = rng.uniform(size=(4, 50)) < 0.8
    eb, ib = ts.max_stabbing(_t(x), 0.1, _t(act))
    for k in range(4):
        e1, i1 = ts.max_stabbing(_t(x[k]), 0.1, _t(act[k]))
        assert float(eb[k]) == float(e1)
        np.testing.assert_array_equal(_np(ib[k]), _np(i1))


@pytest.mark.parametrize("warm", [False, True])
def test_solve_translation(rng, warm):
    src, dst, r, t = _rigid_problem(rng, outliers=0.5)
    moved = (r @ src).astype(np.float32)
    active = rng.uniform(size=src.shape[1]) < 0.8
    wt = (t + 0.01).astype(np.float32)
    ej, ij, bj = jt.solve_translation(jnp.asarray(moved), jnp.asarray(dst), 0.05, 1.0,
                                      jnp.asarray(active), jnp.asarray(wt), warm)
    ep, ip, bp = tt.solve_translation(_t(moved), _t(dst), 0.05, 1.0, _t(active), _t(wt), warm)
    np.testing.assert_allclose(_np(ep), np.asarray(ej), atol=ATOL)
    np.testing.assert_array_equal(_np(ip), np.asarray(ij))
    assert abs(float(bp) - float(bj)) < 1e-7


@pytest.mark.parametrize("warm", [False, True])
def test_solve_translation_endpoints(rng, warm):
    c, lcap = 300, 64
    src, dst, r, t = _rigid_problem(rng, n=c, outliers=0.5)
    b_i = rng.integers(0, c, lcap)
    b_j = rng.integers(0, c, lcap)
    tim = rng.uniform(size=lcap) < 0.7
    wt = t.astype(np.float32)
    out_j = jt.solve_translation_endpoints(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(r), jnp.asarray(1.0, jnp.float32),
        jnp.asarray(b_i, jnp.int32), jnp.asarray(b_j, jnp.int32), jnp.asarray(tim),
        0.05, 1.0, jnp.asarray(wt), warm,
    )
    out_p = tt.solve_translation_endpoints(
        _t(src), _t(dst), _t(r), torch.tensor(1.0), _t(b_i), _t(b_j), _t(tim),
        0.05, 1.0, _t(wt), warm,
    )
    np.testing.assert_allclose(_np(out_p[0]), np.asarray(out_j[0]), atol=ATOL)
    np.testing.assert_array_equal(_np(out_p[1]), np.asarray(out_j[1]))
    np.testing.assert_array_equal(_np(out_p[2]), np.asarray(out_j[2]))


def test_select_scale_inliers(rng):
    src, dst, _, _ = _rigid_problem(rng, outliers=0.4)
    st = (src[:, 1:] - src[:, :-1]).astype(np.float32)
    dt = (dst[:, 1:] - dst[:, :-1]).astype(np.float32)
    active = rng.uniform(size=st.shape[1]) < 0.9
    sj, ij, bj = jsc.select_scale_inliers(jnp.asarray(st), jnp.asarray(dt), 0.05, 1.0,
                                          jnp.asarray(active))
    sp, ip, bp = tsc.select_scale_inliers(_t(st), _t(dt), 0.05, 1.0, _t(active))
    assert float(sp) == float(sj) == 1.0
    np.testing.assert_array_equal(_np(ip), np.asarray(ij))
    np.testing.assert_allclose(
        _np(tsc.tim_norms(_t(st), _t(active))),
        np.asarray(jsc.tim_norms(jnp.asarray(st), jnp.asarray(active))), atol=ATOL,
    )
