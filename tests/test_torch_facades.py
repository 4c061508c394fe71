"""The five TEASER++ sub-solver facades of the port (ScalarTLSEstimator,
TLSScaleSolver, ScaleInliersSelector, TLSTranslationSolver,
GNCTLSRotationSolver) against the JAX package's, on tests/test_variants.py's
inputs made from a numpy seed.

Where a JAX facade draws (the scale mode), the port is given JAX's own
uniforms, drawn from the subkey the JAX facade consumes, so both sides draw
the same candidates. Tolerances: rotation max |dR| <= 1e-4, scale and
translation within 1e-5, inlier masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.robust.scalar_tls import ScalarTLSEstimator as JScalarTLSEstimator
from psulvsb_tpu.robust.scale import ScaleInliersSelector as JScaleInliersSelector
from psulvsb_tpu.robust.scale import TLSScaleSolver as JTLSScaleSolver
from psulvsb_tpu.robust.translation import TLSTranslationSolver as JTLSTranslationSolver
from psulvsb_tpu.rotation.gnc import GNCTLSRotationSolver as JGNCTLSRotationSolver
from psulvsb_tpu_torch.robust.scalar_tls import ScalarTLSEstimator
from psulvsb_tpu_torch.robust.scale import ScaleInliersSelector, TLSScaleSolver
from psulvsb_tpu_torch.robust.translation import TLSTranslationSolver
from psulvsb_tpu_torch.rotation.gnc import GNCTLSRotationSolver

ROT_TOL = 1e-4
TOL = 1e-5
DRAWS = 256  # scale_consensus_1pt's max_draws


def _jax_draws(seed: int, calls: int) -> list[np.ndarray]:
    """The uniforms of a JAX facade's first `calls` scale estimates: each
    splits its key and draws with the subkey."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (DRAWS,), jnp.float32)))
    return out


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _same(got, want, tol=TOL):
    (est_t, inl_t), (est_j, inl_j) = got, want
    np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), atol=tol, rtol=tol)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


X = np.array([0.5, 1.0, 0.6, 0.7, 1.2, 10.0], np.float32)
R = np.array([0.9, 0.9, 0.4, 0.5, 0.4, 0.5], np.float32)


def test_scalar_tls_estimator_matches_jax():
    est_j = JScalarTLSEstimator()
    est_t = ScalarTLSEstimator(device="cpu")
    _same(est_t.estimate_tiled(X, R), est_j.estimate_tiled(jnp.asarray(X), jnp.asarray(R)))
    u1, u2 = _jax_draws(0, 2)
    _same(est_t.estimate(X, R, mode="scale", u=torch.as_tensor(u1)),
          est_j.estimate(jnp.asarray(X), jnp.asarray(R), mode="scale"))
    _same(est_t.estimate(X, R, mode="scale", warm_value=1.05, u=torch.as_tensor(u2)),
          est_j.estimate(jnp.asarray(X), jnp.asarray(R), mode="scale", warm_value=1.05))
    xt = np.array([2.0, 2.1, 1.9, 7.0], np.float32)
    _same(est_t.estimate(xt, R[:4], mode="translation", noise=0.2),
          est_j.estimate(jnp.asarray(xt), jnp.asarray(R[:4]), mode="translation", noise=0.2))
    _same(est_t.estimate(xt, R[:4], mode="translation"),
          est_j.estimate(jnp.asarray(xt), jnp.asarray(R[:4]), mode="translation"))
    _same(est_t.estimate(xt, R[:4], mode="translation", noise=0.2, warm_value=7.05),
          est_j.estimate(jnp.asarray(xt), jnp.asarray(R[:4]), mode="translation", noise=0.2,
                         warm_value=7.05))
    with pytest.raises(ValueError):
        est_t.estimate(X, R, mode="rotation")


def test_scalar_tls_estimator_draws_from_its_generator():
    """Without `u` the scale mode draws from the facade's generator: two
    facades of one seed agree call for call."""
    a = ScalarTLSEstimator(generator=7, device="cpu")
    b = ScalarTLSEstimator(generator=torch.Generator().manual_seed(7), device="cpu")
    for _ in range(2):
        _same(a.estimate(X, R), b.estimate(X, R), tol=0.0)
    with pytest.raises(ValueError):  # a generator of the host for a facade on the card
        ScalarTLSEstimator(generator=torch.Generator(), device="cuda")


@pytest.mark.parametrize("outliers", [0, 12])
def test_scale_solvers_match_jax(rng, outliers):
    src = rng.normal(size=(3, 40)).astype(np.float32)
    dst = (1.5 * src).astype(np.float32)
    dst[:, :outliers] = rng.normal(size=(3, outliers)).astype(np.float32) * 3.0
    solver_j = JTLSScaleSolver(0.01, 1.0)
    solver_t = TLSScaleSolver(0.01, 1.0, device="cpu")
    for u in _jax_draws(0, 2):
        got = solver_t.solveForScale(src, dst, u=torch.as_tensor(u))
        want = solver_j.solveForScale(jnp.asarray(src), jnp.asarray(dst))
        _same(got, want)
        assert float(got[0]) == pytest.approx(1.5, abs=0.02)
    noisy = src + rng.uniform(-0.02, 0.02, size=src.shape).astype(np.float32)
    for d in (src, noisy, dst):
        _same(ScaleInliersSelector(0.01, 1.0, device="cpu").solveForScale(src, d),
              JScaleInliersSelector(0.01, 1.0).solveForScale(jnp.asarray(src), jnp.asarray(d)))


@pytest.mark.parametrize("outliers", [0, 15])
def test_translation_solver_matches_jax(rng, outliers):
    src = rng.normal(size=(3, 50)).astype(np.float32)
    t_true = np.array([0.3, -0.2, 0.7], np.float32)
    dst = src + t_true[:, None] + rng.uniform(-0.005, 0.005, size=src.shape).astype(np.float32)
    dst[:, :outliers] += rng.normal(size=(3, outliers)).astype(np.float32) * 2.0
    got = TLSTranslationSolver(0.01, 1.0, device="cpu").solveForTranslation(src, dst)
    want = JTLSTranslationSolver(0.01, 1.0).solveForTranslation(jnp.asarray(src), jnp.asarray(dst))
    _same(got, want)
    np.testing.assert_allclose(got[0].numpy(), t_true, atol=0.02)


@pytest.mark.parametrize("outliers,warm", [(0, False), (15, False), (15, True)])
def test_gnc_rotation_solver_matches_jax(rng, outliers, warm):
    r_true = _rotation(rng)
    src = rng.normal(size=(3, 50)).astype(np.float32)
    dst = (r_true @ src).astype(np.float32)
    dst += rng.uniform(-0.005, 0.005, size=dst.shape).astype(np.float32)
    dst[:, :outliers] = rng.normal(size=(3, outliers)).astype(np.float32) * 2.0
    warm_rot = _rotation(np.random.default_rng(3)).astype(np.float32) if warm else None
    rot_t, inl_t = GNCTLSRotationSolver(noise_bound=0.01, device="cpu").solveForRotation(
        src, dst, warm_rotation=warm_rot)
    rot_j, inl_j = JGNCTLSRotationSolver(noise_bound=0.01).solveForRotation(
        jnp.asarray(src), jnp.asarray(dst),
        warm_rotation=None if warm_rot is None else jnp.asarray(warm_rot))
    assert np.abs(rot_t.numpy() - np.asarray(rot_j)).max() <= ROT_TOL
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    if not warm:
        np.testing.assert_allclose(rot_t.numpy(), r_true, atol=1e-3)


def test_facades_run_on_the_card_unless_asked():
    """Every facade's device is the card by default; where there is none,
    using it raises instead of running on the CPU."""
    facades = [
        lambda: ScalarTLSEstimator().estimate_tiled(X, R),
        lambda: TLSScaleSolver(0.01, 1.0).solveForScale(np.ones((3, 4)), np.ones((3, 4))),
        lambda: ScaleInliersSelector(0.01, 1.0).solveForScale(np.ones((3, 4)), np.ones((3, 4))),
        lambda: TLSTranslationSolver(0.01, 1.0).solveForTranslation(np.ones((3, 4)),
                                                                     np.ones((3, 4))),
        lambda: GNCTLSRotationSolver().solveForRotation(np.ones((3, 4)), np.ones((3, 4))),
    ]
    assert ScaleInliersSelector(0.01, 1.0).device.type == "cuda"
    assert TLSTranslationSolver(0.01, 1.0).device.type == "cuda"
    assert GNCTLSRotationSolver().device.type == "cuda"
    if torch.cuda.is_available():
        for call in facades:
            assert all(out.device.type == "cuda" for out in call())
    else:
        for call in facades:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
