"""FGR, the "eigh" rotation and the rotation dispatch of the basic step
against the JAX package.

Inputs are numpy TIM sets from seeds: a random rotation, uniform noise, a
share of gross outliers, optionally a mask. Tolerances: `fgr_rotation`'s
rotation within 1e-5 of JAX's with equal inlier masks and equal iteration
counts (both solve the 4x4 eigenproblem with eigh in float32; the loop stops
on the same iteration; the line-process weights within 1e-3, since near
the noise bound a weight's slope multiplies a 1e-6 rotation difference);
`fgr_batched` equals its single-problem runs exactly,
with and without the early exit; `calculate_diameter` within 1e-6 relative;
`gnc_tls_rotation(rot_method="eigh")` within 1e-5 with equal inliers; the
Jacobi form that a captured segment takes within 1e-5 of eigh; `basic_step`
under FGR and under "eigh" within 1e-4 of JAX's basic_step (rotation and
translation), as the other stage tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.core.metrics import calculate_diameter as jax_diameter
from psulvsb_tpu.rotation import fgr as jfgr
from psulvsb_tpu.rotation.gnc import gnc_tls_rotation as jax_gnc
from psulvsb_tpu.solver import basic as jbasic
from psulvsb_tpu.solver.config import RotationEstimationAlgorithm, SolverParams as JParams
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.core.metrics import calculate_diameter
from psulvsb_tpu_torch.ops._build import LAUNCHES
from psulvsb_tpu_torch.rotation.fgr import (
    FastGlobalRegistrationSolver,
    fgr_batched,
    fgr_rotation,
)
from psulvsb_tpu_torch.rotation.gnc import gnc_tls_rotation
from psulvsb_tpu_torch.solver import basic as tbasic

ROT_TOL = 1e-5
CASES = [(40, 0.0, False), (200, 0.3, False), (200, 0.5, True), (64, 0.2, True)]


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _problem(seed, n, outliers, masked, noise=0.01):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(3, n))
    rot = _rotation(rng)
    dst = rot @ src + rng.uniform(-noise, noise, size=(3, n))
    bad = rng.uniform(size=n) < outliers
    dst = np.where(bad[None], rng.normal(size=(3, n)) * 2.0, dst)
    active = rng.uniform(size=n) >= 0.2 if masked else np.ones(n, bool)
    return src.astype(np.float32), dst.astype(np.float32), active, rot


@pytest.mark.parametrize("n,outliers,masked", CASES)
def test_fgr_rotation_matches_jax(n, outliers, masked):
    src, dst, active, rot = _problem(n, n, outliers, masked)
    want = jfgr.fgr_rotation(jnp.asarray(src), jnp.asarray(dst), 0.02, jnp.asarray(active))
    got = fgr_rotation(torch.as_tensor(src), torch.as_tensor(dst), 0.02, torch.as_tensor(active))
    assert int(got.iterations) == int(want.iterations) > 1
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=ROT_TOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3, atol=1e-6)
    if outliers <= 0.3:
        assert np.abs(got.rotation.numpy() - rot).max() < 0.05


def test_fgr_max_iterations_and_facade():
    src, dst, active, _ = _problem(7, 100, 0.2, False)
    want = jfgr.fgr_rotation(jnp.asarray(src), jnp.asarray(dst), 0.02, max_iterations=5)
    got = fgr_rotation(torch.as_tensor(src), torch.as_tensor(dst), 0.02, max_iterations=5)
    assert int(got.iterations) == int(want.iterations) == 5
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=ROT_TOL)
    rot_j, inl_j = jfgr.FastGlobalRegistrationSolver(noise_bound=0.02).solveForRotation(src, dst)
    rot_t, inl_t = FastGlobalRegistrationSolver(noise_bound=0.02, device="cpu").solveForRotation(
        src, dst)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=ROT_TOL)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


@pytest.mark.parametrize("rot_method", ["eigh", "jacobi"])
def test_fgr_batched_equals_its_single_problems(rot_method):
    """A stopped problem is frozen while the others go on; running every
    iteration masked (no early exit, as a captured segment does) changes
    nothing."""
    problems = [_problem(20 + k, 96, rate, True) for k, rate in enumerate((0.0, 0.3, 0.6))]
    src = torch.as_tensor(np.stack([p[0] for p in problems]))
    dst = torch.as_tensor(np.stack([p[1] for p in problems]))
    act = torch.as_tensor(np.stack([p[2] for p in problems]))
    nb = torch.tensor([0.02, 0.02, 0.05])
    rots, l_pq, cost, iters = fgr_batched(src, dst, act, nb, rot_method=rot_method)
    masked = fgr_batched(src, dst, act, nb, rot_method=rot_method, early_exit=False)
    assert len(set(iters.tolist())) > 1  # the problems stop at different iterations
    for got, again in zip((rots, l_pq, cost, iters), masked):
        assert torch.equal(got, again)
    for b in range(3):
        one = fgr_rotation(src[b], dst[b], nb[b], act[b], rot_method=rot_method)
        assert int(one.iterations) == int(iters[b])
        np.testing.assert_allclose(one.rotation.numpy(), rots[b].numpy(), atol=1e-6)
        want = jfgr.fgr_rotation(jnp.asarray(src[b].numpy()), jnp.asarray(dst[b].numpy()),
                                 float(nb[b]), jnp.asarray(act[b].numpy()))
        np.testing.assert_allclose(rots[b].numpy(), np.asarray(want.rotation), atol=ROT_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_calculate_diameter_matches_jax(masked):
    src, _, active, _ = _problem(3, 150, 0.0, True)
    mask_j, mask_t = (jnp.asarray(active), torch.as_tensor(active)) if masked else (None, None)
    want = float(jax_diameter(jnp.asarray(src), mask_j))
    got = calculate_diameter(torch.as_tensor(src), mask_t)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    both = calculate_diameter(torch.as_tensor(np.stack([src, 2 * src])))
    np.testing.assert_allclose(both.numpy(), [float(got) if not masked else both[0], 2 * both[0]],
                               rtol=1e-6)


@pytest.mark.parametrize("n,outliers,masked", CASES)
def test_gnc_tls_eigh_matches_jax(n, outliers, masked):
    src, dst, active, _ = _problem(50 + n, n, outliers, masked)
    want = jax_gnc(jnp.asarray(src), jnp.asarray(dst), 0.02, jnp.asarray(active),
                   cost_threshold=0.005, rot_method="eigh")
    got = gnc_tls_rotation(torch.as_tensor(src), torch.as_tensor(dst), 0.02,
                           torch.as_tensor(active), cost_threshold=0.005, rot_method="eigh")
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=ROT_TOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.iterations) == int(want.iterations)


def test_gnc_batch_eigh_takes_the_plain_route_and_counts_it():
    """`rotation_batch` owns the choice: "eigh" runs the plain loop and is
    counted there, "power" goes to the kernel's front door and is not."""
    problems = [_problem(70 + k, 128, 0.3, True) for k in range(4)]
    src = torch.as_tensor(np.stack([p[0] for p in problems]))
    dst = torch.as_tensor(np.stack([p[1] for p in problems]))
    act = torch.as_tensor(np.stack([p[2] for p in problems]))
    nb = torch.full((4,), 0.02)
    loop = dict(inner_rotation_max_iterations=100, inner_rotation_gnc_factor=1.4,
                inner_rotation_cost_threshold=0.005)
    eigh = params_from_jax(JParams.preset_artificial(gnc_rot_method="eigh", **loop))
    args = (src, dst, act, nb, torch.eye(3), False)
    calls, launches = tbasic.PLAIN_ROUTE_CALLS, LAUNCHES["gnc_batch"]
    rots, inl = tbasic.rotation_batch(*args, eigh)
    assert tbasic.PLAIN_ROUTE_CALLS == calls + 1 and LAUNCHES["gnc_batch"] == launches
    free, inl_f = tbasic.rotation_batch(*args, eigh, sync_free=True)
    assert tbasic.PLAIN_ROUTE_CALLS == calls + 2
    np.testing.assert_allclose(free.numpy(), rots.numpy(), atol=ROT_TOL)
    assert (inl_f == inl).float().mean() >= 0.995
    tbasic.rotation_batch(*args, eigh.replace(gnc_rot_method="power"))  # not counted
    assert tbasic.PLAIN_ROUTE_CALLS == calls + 2
    for b in range(4):
        want = jax_gnc(jnp.asarray(src[b].numpy()), jnp.asarray(dst[b].numpy()), 0.02,
                       jnp.asarray(act[b].numpy()), cost_threshold=0.005, rot_method="eigh")
        np.testing.assert_allclose(rots[b].numpy(), np.asarray(want.rotation), atol=ROT_TOL)
        np.testing.assert_array_equal(inl[b].numpy(), np.asarray(want.inliers))
    with pytest.raises(ValueError):
        tbasic.rotation_batch(*args, eigh.replace(gnc_rot_method="svd"))


@pytest.mark.parametrize("setting", ["fgr", "eigh"])
def test_basic_step_rotation_variants_match_jax(setting):
    """basic_step at known scale with FGR (which raised before) and with the
    "eigh" rotation, on chain TIMs over 120 points with 40% outliers."""
    rng = np.random.default_rng(9)
    n = 120
    src = rng.normal(size=(3, n)).astype(np.float32)
    rot, t = _rotation(rng), rng.normal(size=3)
    dst = rot @ src + t[:, None] + rng.uniform(-0.05, 0.05, size=(3, n))
    bad = rng.uniform(size=n) < 0.4
    dst = np.where(bad[None], dst + rng.normal(size=(3, n)) * 5, dst).astype(np.float32)
    idx_i = np.arange(n)
    idx_j = (idx_i + 1) % n
    active = np.ones(n, bool)
    kw = (dict(rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR)
          if setting == "fgr" else dict(gnc_rot_method="eigh"))
    jp = JParams.preset_artificial(**kw)
    want = jbasic.basic_step(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(idx_i), jnp.asarray(idx_j),
        jnp.asarray(active), jp, jax.random.PRNGKey(0), jbasic.WarmState.initial(jnp.float32),
    )
    for sync_free in (False, True):
        got = tbasic.basic_step(
            torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(idx_i),
            torch.as_tensor(idx_j), torch.as_tensor(active), params_from_jax(jp),
            tbasic.WarmState.initial(), sync_free=sync_free,
        )
        np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-4)
        np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                                   atol=1e-4)
        np.testing.assert_array_equal(got.rotation_inliers.numpy(),
                                      np.asarray(want.rotation_inliers))


def _host_repeat(flag, body):
    """`GraphControl.repeat` on the host: the body while its flag holds."""
    while bool(flag):
        flag = body()


@pytest.mark.parametrize("loop", ["fgr", "gnc"])
@pytest.mark.parametrize("max_iterations", [100, 13])
def test_device_loop_equals_the_masked_iterations(loop, max_iterations):
    """The loop form inside a CUDA graph (chunks of masked iterations while a
    problem is left, here with its body run on the host) gives the results
    of every iteration run masked and of the early exit, at a cap the chunk
    does not divide too."""
    from psulvsb_tpu_torch.rotation.gnc import gnc_tls_batched

    problems = [_problem(30 + k, 96, rate, True) for k, rate in enumerate((0.0, 0.3, 0.6))]
    src = torch.as_tensor(np.stack([p[0] for p in problems]))
    dst = torch.as_tensor(np.stack([p[1] for p in problems]))
    act = torch.as_tensor(np.stack([p[2] for p in problems]))
    nb = torch.tensor([0.02, 0.02, 0.05])
    if loop == "fgr":
        def run(**kw):
            return fgr_batched(src, dst, act, nb, max_iterations=max_iterations,
                               rot_method="jacobi", **kw)
    else:
        def run(**kw):
            return gnc_tls_batched(src, dst, act, nb**2, torch.eye(3), torch.tensor(False),
                                   max_iterations, 1.4, 0.005, "jacobi", **kw)
    early = run()
    masked = run(early_exit=False)
    looped = run(early_exit=False, repeat=_host_repeat)
    for a, b, c in zip(early, masked, looped):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert len(set(early[-1].tolist())) > 1 or max_iterations == 13
