"""GROR initial alignment (psulvsb_tpu_torch/gror/gror.py) and the global
translation vote (robust/translation.py) against the JAX package.

Inputs are made with numpy from seeds and given to both packages. JAX's
consistency degrees come from the Pallas kernel in interpret mode on the
CPU, the port's from the plain version (tests/test_torch_pairs.py holds the
two within 2 flipped pairs).

Tolerances: the two-vector alignment and the axis-angle rotation within
1e-6; the interval stab exactly (angle and count); the batched edge
evaluation against JAX's vmap on the same K points with equal RCFS and TCFS
counts (torch's and XLA's arctan2/arccos may differ in the last ulp, which
would move a razor-edge interval end; none did on these inputs) and angles
within 1e-5; gror_align on the test_gror.py fixture sizes with R within
0.05 deg, t within 1e-3, inlier masks agreeing on >= 99% of points and
best_count within 1; the global vote's support counts equal and t within
1e-5 (float32 sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.gror import gror as jg
from psulvsb_tpu.robust.translation import global_translation_vote as jax_vote
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.gror import gror as tg
from psulvsb_tpu_torch.robust.translation import global_translation_vote

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "frontend_aliasing")


def _unit_vectors(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_two_vectors_align_and_axis_angle_match_jax():
    rng = np.random.default_rng(0)
    a, b = _unit_vectors(rng, 16), _unit_vectors(rng, 16)
    b[0] = -a[0]  # antiparallel: the flip branch
    b[1] = a[1]  # parallel
    got = tg._two_vectors_align(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.stack([np.asarray(jg._two_vectors_align(jnp.asarray(x), jnp.asarray(y)))
                     for x, y in zip(a, b)])
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", got, a), b, atol=1e-4)
    angles = rng.uniform(-np.pi, np.pi, size=16).astype(np.float32)
    got = tg._axis_angle_rotation(torch.as_tensor(a), torch.as_tensor(angles)).numpy()
    want = np.stack([np.asarray(jg._axis_angle_rotation(jnp.asarray(x), jnp.asarray(t)))
                     for x, t in zip(a, angles)])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_interval_stab_matches_jax():
    rng = np.random.default_rng(1)
    n = 40
    beg = rng.uniform(0, 6, size=(8, n)).astype(np.float32)
    end = (beg + rng.uniform(0, 1, size=(8, n))).astype(np.float32)
    beg[:, :5] = 1.5  # ties between starts, and with ends below
    end[:, 5:8] = 1.5
    valid = rng.uniform(size=(8, n)) < 0.8
    angle, count = tg._interval_stab_one_to_one(
        torch.as_tensor(beg), torch.as_tensor(end), torch.as_tensor(valid)
    )
    for k in range(8):
        ja, jc = jg._interval_stab_one_to_one(
            jnp.asarray(beg[k]), jnp.asarray(end[k]), jnp.asarray(valid[k])
        )
        assert float(angle[k]) == float(ja)
        assert int(count[k]) == int(jc)


def _fixture(c, seed, rate, noise=0.01):
    src = synthetic_cloud(c, seed=seed)
    return make_synthetic_pair(np.random.default_rng(seed), src, noise, rate)


def test_evaluate_edges_matches_jax_vmap():
    pair = _fixture(200, 0, 0.6)
    res = 0.05
    k = 60
    src_k, dst_k = pair.src[:, :k], pair.dst[:, :k]
    act = np.ones(k, bool)
    act[::7] = False
    rng = np.random.default_rng(2)
    e_i = np.arange(k)
    e_j = (e_i + rng.integers(1, k, size=k)) % k
    got = tg._evaluate_edges(
        torch.as_tensor(e_i), torch.as_tensor(e_j), torch.as_tensor(src_k),
        torch.as_tensor(dst_k), torch.as_tensor(act), res,
    )
    want = jax.vmap(
        lambda i, j: jg._evaluate_edge(i, j, jnp.asarray(src_k), jnp.asarray(dst_k),
                                       jnp.asarray(act), res)
    )(jnp.asarray(e_i), jnp.asarray(e_j))
    rcfs, tcfs, angle, r0, t0, axis, origin = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), rcfs)
    np.testing.assert_array_equal(got[1].numpy(), tcfs)
    np.testing.assert_allclose(got[2].numpy(), angle, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), r0, atol=1e-5)
    np.testing.assert_allclose(got[4].numpy(), t0, atol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), axis, atol=1e-6)
    np.testing.assert_allclose(got[6].numpy(), origin, atol=0)


@pytest.mark.parametrize(
    "c,seed,rate,k_opt",
    [(200, 0, 0.6, 150), (300, 1, 0.85, 200), (150, 2, 0.5, 100)],
)
def test_gror_align_matches_jax(c, seed, rate, k_opt):
    """The tests/test_gror.py fixture sizes (noise 0.01, resolution 0.05)."""
    pair = _fixture(c, seed, rate)
    act = np.ones(c, bool)
    act[np.random.default_rng(seed).permutation(c)[:5]] = False
    want = jg.gror_align(pair.src, pair.dst, 0.05, k_opt, corr_active=jnp.asarray(act))
    got = tg.gror_align(pair.src, pair.dst, 0.05, k_opt, corr_active=act, device="cpu")
    assert angular_error_deg_np(np.asarray(want.rotation), got.rotation.numpy()) <= 0.05
    np.testing.assert_allclose(got.translation.numpy(), want.translation, atol=1e-3)
    agree = (got.inliers.numpy() == np.asarray(want.inliers)).mean()
    assert agree >= 0.99, agree
    assert abs(int(got.best_count) - int(want.best_count)) <= 1
    assert angular_error_deg_np(pair.transform.rotation, got.rotation.numpy()) < 5.0


def test_gror_facade_and_device():
    pair = _fixture(150, 2, 0.5)
    gror = tg.GRORInitialAlignment(device="cpu")
    gror.setInputSource(pair.src)
    gror.setInputTarget(pair.dst)
    gror.setResolution(0.05)
    gror.setOptimalSelectionNumber(100)
    gror.setNumberOfThreads(32)
    gror.setInputCorrespondences(np.stack([np.arange(150), np.arange(150)], axis=1))
    res = gror.align()
    assert res.rotation.device.type == "cpu"
    assert angular_error_deg_np(pair.transform.rotation, res.rotation.numpy()) < 5.0
    if not torch.cuda.is_available():
        # The default device is the card: with none, the move raises.
        with pytest.raises((RuntimeError, AssertionError)):
            tg.gror_align(pair.src, pair.dst, 0.05, 100)


@pytest.mark.parametrize("tag", ["pair_seed1375", "pair_seed10300"])
def test_global_translation_vote_matches_jax(tag):
    corr = np.loadtxt(os.path.join(HERE, f"{tag}_corr.txt")).astype(np.float32)
    gt = np.loadtxt(os.path.join(HERE, f"{tag}_gt.txt")).astype(np.float32)
    src, dst = corr[:, :3].T.copy(), corr[:, 3:].T.copy()
    c = src.shape[1]
    real = np.ones(c, bool)
    real[-3:] = False
    aliased = gt[:3, 3] + np.array([2.0, 0.0, -2.0], np.float32)
    want = jax_vote(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(gt[:3, :3]),
                    jnp.float32(1.0), jnp.asarray(real), 0.3, 1.0, jnp.asarray(aliased))
    got = global_translation_vote(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(gt[:3, :3]),
        torch.tensor(1.0), torch.as_tensor(real), 0.3, 1.0, torch.as_tensor(aliased),
    )
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert int(got[1]) > int(got[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)
