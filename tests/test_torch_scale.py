"""The scale estimators of the port (robust/scalar_tls.py, robust/scale.py)
against the JAX package's, batched over hypotheses.

`scale_consensus_1pt` and the "ransac1pt" estimator of `solve_scale_tls`
get JAX's own uniforms, drawn from the key JAX's call consumes, so both
sides draw the same candidates. Tolerances: estimates within 1e-5 relative
(float32 sums in another order), inlier masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.robust import scalar_tls as jtls
from psulvsb_tpu.robust import scale as jscale
from psulvsb_tpu_torch.robust import scalar_tls as ttls
from psulvsb_tpu_torch.robust import scale as tscale

RTOL = 1e-5
F32 = jnp.float32


def _measurements(rng, b, n, masked=0.2):
    """B rows of scale-like measurements: a consensus near a true value per
    row, uniform outliers, per-measurement ranges, a share masked."""
    truth = rng.uniform(1.0, 5.0, size=(b, 1))
    x = truth + rng.normal(size=(b, n)) * 0.01
    out = rng.uniform(size=(b, n)) < 0.5
    x = np.where(out, rng.uniform(0.1, 8.0, size=(b, n)), x).astype(np.float32)
    ranges = rng.uniform(0.01, 0.05, size=(b, n)).astype(np.float32)
    active = rng.uniform(size=(b, n)) >= masked
    return x, ranges, active


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_tls_vote_matches_jax(rng, n):
    x, ranges, active = _measurements(rng, 3, n)
    est, inl = ttls.tls_vote(torch.as_tensor(x), torch.as_tensor(ranges), torch.as_tensor(active))
    for b in range(3):
        je, ji = jtls.tls_vote(jnp.asarray(x[b]), jnp.asarray(ranges[b]), jnp.asarray(active[b]))
        _close(est[b], je)
        np.testing.assert_array_equal(inl[b].numpy(), np.asarray(ji))


def _uniforms(keys, k):
    return np.stack([np.asarray(jax.random.uniform(kk, (k,), F32)) for kk in keys])


@pytest.mark.parametrize("use_warm", [False, True])
@pytest.mark.parametrize("max_draws", [16, 256])
def test_scale_consensus_1pt_matches_jax(rng, use_warm, max_draws):
    b, n = 4, 96
    x, ranges, active = _measurements(rng, b, n)
    active[2] = False  # all-inactive row: uniform draws, no inliers
    warm = np.float32(x[0, np.flatnonzero(active[0])[0]])
    keys = jax.random.split(jax.random.PRNGKey(int(use_warm) * 7 + max_draws), b)
    u = _uniforms(keys, max_draws)
    est, inl = ttls.scale_consensus_1pt(
        torch.as_tensor(x), torch.as_tensor(ranges), torch.as_tensor(active),
        warm_value=torch.tensor(warm), use_warm=use_warm, max_draws=max_draws,
        u=torch.as_tensor(u),
    )
    for r in range(b):
        je, ji = jtls.scale_consensus_1pt(
            jnp.asarray(x[r]), jnp.asarray(ranges[r]), keys[r], jnp.asarray(active[r]),
            warm_value=jnp.asarray(warm), use_warm=use_warm, max_draws=max_draws,
        )
        _close(est[r], je)
        np.testing.assert_array_equal(inl[r].numpy(), np.asarray(ji))
    assert not inl[2].any()


def test_scale_consensus_1pt_draws_from_generator(rng):
    x, ranges, active = _measurements(rng, 2, 50)
    args = (torch.as_tensor(x), torch.as_tensor(ranges), torch.as_tensor(active))
    a = ttls.scale_consensus_1pt(*args, generator=torch.Generator().manual_seed(3))
    b = ttls.scale_consensus_1pt(*args, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _tims(rng, b, n, scale=2.7):
    """Basic-set TIMs of B hypotheses: dst = scale * R src + noise with 40%
    gross outliers and a few zero-length source TIMs."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    src = rng.normal(size=(b, 3, n)).astype(np.float32)
    dst = scale * np.einsum("ij,bjn->bin", q, src) + rng.normal(size=(b, 3, n)) * 0.005
    out = rng.uniform(size=(b, n)) < 0.4
    dst = np.where(out[:, None, :], rng.normal(size=(b, 3, n)) * 3.0, dst).astype(np.float32)
    src[:, :, :2] = 0.0  # |src_tim| = 0 never votes
    active = rng.uniform(size=(b, n)) >= 0.1
    return src, dst, active


@pytest.mark.parametrize("estimator", ["ransac1pt", "vote"])
@pytest.mark.parametrize("use_warm", [False, True])
def test_solve_scale_tls_matches_jax(rng, estimator, use_warm):
    b, n, k = 4, 64, 256
    src, dst, active = _tims(rng, b, n)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    warm = np.float32(2.69)
    scale, inl, beta = tscale.solve_scale_tls(
        torch.as_tensor(src), torch.as_tensor(dst), 0.05, 1.0, torch.as_tensor(active),
        warm_scale=torch.tensor(warm), use_warm=use_warm, max_draws=k, estimator=estimator,
        u=torch.as_tensor(_uniforms(keys, k)),
    )
    for r in range(b):
        js, ji, jb = jscale.solve_scale_tls(
            jnp.asarray(src[r]), jnp.asarray(dst[r]), 0.05, 1.0, keys[r],
            active=jnp.asarray(active[r]), warm_scale=jnp.asarray(warm), use_warm=use_warm,
            max_draws=k, estimator=estimator,
        )
        _close(scale[r], js)
        np.testing.assert_array_equal(inl[r].numpy(), np.asarray(ji))
        _close(beta, jb)
        assert abs(float(scale[r]) - 2.7) < 0.05


def test_solve_scale_tls_rejects_unknown_estimator():
    x = torch.ones(1, 3, 4)
    with pytest.raises(ValueError):
        tscale.solve_scale_tls(x, x, 0.05, 1.0, estimator="median")
