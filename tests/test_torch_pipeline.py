"""The pre-filter pipeline of the port against the JAX package's:
utils/padding.py, frontend/knn.py, frontend/normals.py,
frontend/histogram_filter.py and eval/pipeline.py.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerances: kNN distances 1e-5 (float32 sums in another order), indices
equal as sets a row; normals up to sign before the viewpoint flip and equal
after it to 1e-4 except where normal . to_viewpoint is within 1e-6 of 0 (an
eigenvector's sign is free); the keep mask equal given JAX's normals, and
differing in at most 1% of the entries given the port's own normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.eval.pipeline import pad_bucket as jax_pad_bucket
from psulvsb_tpu.frontend.histogram_filter import normal_angle_histogram_filter as jax_filter
from psulvsb_tpu.frontend.knn import knn as jax_knn, pairwise_sq_dists as jax_sq_dists
from psulvsb_tpu.frontend.normals import estimate_normals as jax_normals
from psulvsb_tpu.utils import padding as jpad
from psulvsb_tpu_torch import SolverParams, solve_with_prefilter
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.pipeline import pad_bucket
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.frontend.histogram_filter import normal_angle_histogram_filter
from psulvsb_tpu_torch.frontend.knn import knn, pairwise_sq_dists
from psulvsb_tpu_torch.frontend.normals import estimate_normals, neighbourhood_normals
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.utils import padding as tpad

CAPS = dict(sampled_cap=256, basic_cap=64, hypothesis_batch=4)


@pytest.mark.parametrize("c", [1, 255, 256, 257, 8192, 8193, 20000])
def test_padding_equals_jax(c):
    assert tpad.DEFAULT_PAD_BUCKETS == jpad.DEFAULT_PAD_BUCKETS
    assert tpad.pad_to_bucket(c) == jpad.pad_to_bucket(c) == pad_bucket(c) == jax_pad_bucket(c)
    assert tpad.pad_to_bucket(c, (100, 300)) == jpad.pad_to_bucket(c, (100, 300))
    arr = np.arange(3 * min(c, 300), dtype=np.float32).reshape(3, -1)
    target = tpad.pad_to_bucket(arr.shape[1])
    np.testing.assert_array_equal(
        tpad.pad_columns(arr, target, fill=-1.0), jpad.pad_columns(arr, target, fill=-1.0))
    assert tpad.pad_columns(arr, arr.shape[1]) is arr
    with pytest.raises(ValueError):
        tpad.pad_columns(arr, arr.shape[1] - 1)


@pytest.mark.parametrize("d,n", [(3, 500), (33, 300)])
def test_knn_equals_jax(d, n):
    rng = np.random.default_rng(d + n)
    pts = rng.normal(size=(d, n)).astype(np.float32)
    query = rng.normal(size=(d, 77)).astype(np.float32)
    active = rng.uniform(size=n) < 0.8
    np.testing.assert_allclose(
        pairwise_sq_dists(torch.as_tensor(query), torch.as_tensor(pts)).numpy(),
        np.asarray(jax_sq_dists(jnp.asarray(query), jnp.asarray(pts))), atol=1e-4)
    for q in (query, pts):
        for block in (2048, 128):  # one tile, and several
            idx, dist = knn(torch.as_tensor(q), torch.as_tensor(pts), 12,
                            torch.as_tensor(active), block=block)
            jidx, jdist = jax_knn(jnp.asarray(q), jnp.asarray(pts), 12, jnp.asarray(active))
            assert idx.dtype == torch.int64 and idx.shape == (q.shape[1], 12)
            np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-5 * max(1, d))
            assert active[idx.numpy()].all()
            same = [set(a) == set(b) for a, b in zip(idx.numpy().tolist(), np.asarray(jidx).tolist())]
            # A row differs only where two candidates tie to within rounding.
            assert np.mean(same) >= 0.99
    idx, _ = knn(torch.as_tensor(pts), torch.as_tensor(pts[:, :5]), 9)
    assert idx.shape == (n, 5)  # k clamps to the number of points


def _surface(n, seed):
    """A noisy curved sheet well off the origin, so normals are defined and
    the viewpoint flip is decided."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, size=(2, n))
    z = 0.3 * np.sin(2 * xy[0]) + 0.2 * xy[1] ** 2 + 3.0 + 0.002 * rng.normal(size=n)
    return np.vstack([xy, z[None]]).astype(np.float32)


@pytest.mark.parametrize("radius", [None, 0.25])
def test_normals_equal_jax(radius):
    pts = _surface(400, 1)
    active = np.random.default_rng(2).uniform(size=400) < 0.9
    vp = np.array([0.1, -0.2, 0.0], np.float32)
    want = np.asarray(jax_normals(jnp.asarray(pts), 20, jnp.asarray(active), jnp.asarray(vp), radius))
    raw = neighbourhood_normals(torch.as_tensor(pts), 20, torch.as_tensor(active), radius).numpy()
    got = estimate_normals(torch.as_tensor(pts), 20, torch.as_tensor(active),
                           torch.as_tensor(vp), radius).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-5)
    # Up to sign before the flip.
    assert (np.abs((raw * want).sum(0)) > 1 - 1e-4).all()
    decided = np.abs((want * (vp[:, None] - pts)).sum(0)) > 1e-6
    assert decided.mean() > 0.99
    np.testing.assert_allclose(got[:, decided], want[:, decided], atol=1e-4)
    assert ((got * (vp[:, None] - pts)).sum(0) >= -1e-6).all()
    default = estimate_normals(torch.as_tensor(pts)).numpy()  # no mask, the origin as viewpoint
    np.testing.assert_allclose(
        default, np.asarray(jax_normals(jnp.asarray(pts))), atol=1e-4)


def _normal_pair(n, seed):
    rng = np.random.default_rng(seed)
    src = _surface(n, seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    dst = q @ src + np.array([[0.5], [0.2], [4.0]], np.float32)
    dst[:, : n // 3] = rng.uniform(-2, 2, size=(3, n // 3)).astype(np.float32) + 4.0
    return src, dst.astype(np.float32)


def test_histogram_filter_equals_jax():
    src, dst = _normal_pair(600, 3)
    active = np.arange(600) < 560
    sn = np.array(jax_normals(jnp.asarray(src), 20, jnp.asarray(active)))
    dn = np.array(jax_normals(jnp.asarray(dst), 20, jnp.asarray(active)))
    want, want_angles = jax_filter(jnp.asarray(sn), jnp.asarray(dn), jnp.asarray(active))
    got, angles = normal_angle_histogram_filter(
        torch.as_tensor(sn), torch.as_tensor(dn), torch.as_tensor(active))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(angles.numpy(), np.asarray(want_angles), atol=1e-2)
    assert set(np.unique(got.numpy())) == {-1, 0, 1} and (got.numpy()[560:] == -1).all()
    # Given the port's own normals: at most 1% of the entries differ.
    own, _ = normal_angle_histogram_filter(
        estimate_normals(torch.as_tensor(src), 20, torch.as_tensor(active)),
        estimate_normals(torch.as_tensor(dst), 20, torch.as_tensor(active)),
        torch.as_tensor(active))
    assert (own.numpy() != np.asarray(want)).mean() <= 0.01
    # Zero normals take no part and keep 0; no mask means all active; a
    # small max_bins saturates and widens the bins, as in JAX.
    sn0 = sn.copy()
    sn0[:, :10] = 0.0
    for kw in (dict(), dict(max_bins=8)):
        g0, _ = normal_angle_histogram_filter(torch.as_tensor(sn0), torch.as_tensor(dn), **kw)
        w0, _ = jax_filter(jnp.asarray(sn0), jnp.asarray(dn), **kw)
        np.testing.assert_array_equal(g0.numpy(), np.asarray(w0))
        assert (g0.numpy()[:10] == 0).all()
    none, _ = normal_angle_histogram_filter(
        torch.as_tensor(sn), torch.as_tensor(dn), torch.zeros(600, dtype=torch.bool))
    assert (none == -1).all()


@pytest.mark.parametrize("use_prefilter", [False, True])
@pytest.mark.parametrize("fused_solve", [True, False])
def test_solve_with_prefilter_meets_the_pose_gate(use_prefilter, fused_solve):
    """A surface pair of 300 correspondences with a third of them wrong,
    padded to the 512 bucket: RE < 5 deg, TE < 0.3, padding never in the
    solution."""
    src, dst = _normal_pair(300, 5)
    params = SolverParams.preset_artificial(noise_bound=0.02, **CAPS)
    res = solve_with_prefilter(src, dst, params, 4, fused=fused_solve,
                               use_prefilter=use_prefilter, device="cpu")
    keep = res.keep_mask.numpy()
    assert keep.shape == (512,) and (keep[300:] == -2).all() and (keep[:300] > -2).all()
    if use_prefilter:
        assert (keep[:300] == 1).sum() >= 30 and (keep[:300] == -1).any()
    else:
        assert (keep[:300] == 1).all()
    sol = res.solution
    assert bool(sol.valid) and res.elapsed_s > 0
    # Truth from the inlier columns: dst = q src + t.
    a, b = src[:, 100:], dst[:, 100:]
    ca, cb = a.mean(1, keepdims=True), b.mean(1, keepdims=True)
    u, _, vt = np.linalg.svd((b - cb) @ (a - ca).T)
    q = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
    t = (cb - q @ ca)[:, 0]
    assert angular_error_deg_np(q, sol.rotation.numpy().astype(np.float64)) < 5.0
    assert np.linalg.norm(sol.translation.numpy() - t) < 0.3
    assert int(sol.final_inlier_count) <= 300
    if fused_solve:
        assert fused.plan_for(params, 512, "cpu").stats["rounds"] >= 1
    # The same seed through the other solver gives the same pose.
    other = solve_with_prefilter(src, dst, params, 4, fused=not fused_solve,
                                 use_prefilter=use_prefilter, device="cpu")
    np.testing.assert_allclose(other.solution.rotation.numpy(), sol.rotation.numpy(), atol=1e-6)


def test_pipeline_wants_a_card_by_default():
    src, dst = _normal_pair(60, 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            solve_with_prefilter(src, dst, SolverParams.preset_artificial(**CAPS), 0)
