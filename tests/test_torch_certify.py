"""The DRS certifier of the port (psulvsb_tpu_torch/certify/drs.py) against
the JAX package's (psulvsb_tpu/certify/drs.py).

Inputs are numpy arrays made from a seed; both packages run in float64 on
the CPU. Tolerances:
- every building block (hatmap, vector_kron, nearest_psd, the Q cost,
  Omega_1, the quaternion, A_inv, the dual projection, the lambda guess):
  1e-7 absolute (ACCEPTABLE_ERROR of tests/test_golden_reference.py), the
  P matrix exactly;
- certify_rotation: `is_optimal` equal, the same number of iterations, and
  every gap of the trajectory within 1e-7 absolute plus 1e-9 of its size
  (two LAPACK eigen-solves an iteration, in another order of operations);
- float32 against float64 on the same inputs: `is_optimal` equal and the
  best gap within 2e-2 absolute, the JAX package's own f32 tolerance
  (psulvsb_tpu/certify/drs.py:460-466);
- eval/batch_harness._certify_winner against JAX's on the same winning pose
  and TIM cap: `certified` equal, the gap within the trajectory tolerance.
The golden MATLAB fixtures of the reference tree hold the port too, with
the skip of tests/test_golden_reference.py where the tree is not mounted.
The card's float64 certificates are held to the host's by chip_smoke.py
(phase 20, and each winner of phase 21's sweep).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.certify import drs as jdrs
from psulvsb_tpu.core import linalg as jlinalg
from psulvsb_tpu.eval import batch_harness as jbh
from psulvsb_tpu.solver.config import SolverParams as JParams
from psulvsb_tpu_torch.certify import drs
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.core import linalg
from psulvsb_tpu_torch.eval import batch_harness as bh
from psulvsb_tpu_torch.eval import make_dataset as md
from psulvsb_tpu_torch.eval import realdata as rd

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_reference import (  # noqa: E402
    ACCEPTABLE_ERROR,
    LARGE_CASES,
    REF,
    SMALL_CASES,
    load_cert_case,
)

TRAJ_ABS, TRAJ_REL = 1e-7, 1e-9
F32_GAP = 2e-2
JPARAMS = JParams.preset_3dmatch(estimate_scaling=False, sampled_cap=1024, basic_cap=512,
                                 hypothesis_batch=8)
PARAMS = params_from_jax(JPARAMS)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _random_rotation(rng):
    q = rng.normal(size=4)
    return jdrs._quat_to_rot_xyzw(q / np.linalg.norm(q))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _problem(seed, n=10, outliers=2, noise=0.002):
    rng = np.random.default_rng(seed)
    r = _random_rotation(rng)
    src = rng.normal(size=(3, n))
    dst = r @ src + rng.normal(size=(3, n)) * noise
    dst[:, :outliers] += 5.0
    theta = np.ones(n)
    theta[:outliers] = -1.0
    return r, src, dst, theta


def _same(port, jax_out, atol=ACCEPTABLE_ERROR):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), rtol=0, atol=atol)


def test_p_matrix_equal():
    np.testing.assert_array_equal(drs._p_matrix(), jdrs._p_matrix())


@pytest.mark.parametrize("block", [
    "hatmap", "vector_kron", "nearest_psd", "get_q_cost", "get_omega1",
    "rotation_to_quat_xyzw", "apply_a_inv", "dual_projection", "get_lambda_guess",
    "blocks_round_trip",
])
def test_building_blocks_match_jax_float64(block):
    r, src, dst, theta = _problem(3, n=9)
    rng = np.random.default_rng(4)
    k = src.shape[1] + 1
    theta_p = np.concatenate([[1.0], theta])
    if block == "hatmap":
        v = rng.normal(size=(5, 3))
        _same(linalg.hatmap(_t(v)), jnp.stack([jlinalg.hatmap(jnp.asarray(x)) for x in v]))
    elif block == "vector_kron":
        a, b = rng.normal(size=(3, 7)), rng.normal(size=(4, 7))
        _same(linalg.vector_kron(_t(a), _t(b)), jlinalg.vector_kron(jnp.asarray(a),
                                                                     jnp.asarray(b)))
    elif block == "nearest_psd":
        a = rng.normal(size=(4 * k, 4 * k))
        _same(linalg.nearest_psd(_t(a)), jlinalg.nearest_psd(jnp.asarray(a)))
    elif block == "get_q_cost":
        _same(drs.get_q_cost(_t(src), _t(dst), 0.01, 1.0),
              jdrs.get_q_cost(jnp.asarray(src), jnp.asarray(dst), 0.01, 1.0))
    elif block == "get_omega1":
        q = rng.normal(size=4)
        _same(drs.get_omega1(_t(q)), jdrs.get_omega1(jnp.asarray(q)))
    elif block == "rotation_to_quat_xyzw":
        _same(drs.rotation_to_quat_xyzw(_t(r)), jdrs.rotation_to_quat_xyzw(jnp.asarray(r)))
    elif block == "apply_a_inv":
        b = rng.normal(size=(k, k, 3))
        _same(drs.apply_a_inv(_t(b), _t(theta_p)),
              jdrs.apply_a_inv(jnp.asarray(b), jnp.asarray(theta_p)))
    elif block == "dual_projection":
        w = rng.normal(size=(4 * k, 4 * k))
        _same(drs.dual_projection(_t(w), _t(theta_p)),
              jdrs.dual_projection(jnp.asarray(w), jnp.asarray(theta_p)))
    elif block == "get_lambda_guess":
        _same(drs.get_lambda_guess(_t(r), _t(theta), _t(src), _t(dst), 0.01, 1.0),
              jdrs.get_lambda_guess(jnp.asarray(r), jnp.asarray(theta), jnp.asarray(src),
                                    jnp.asarray(dst), 0.01, 1.0))
    else:
        m = rng.normal(size=(4 * k, 4 * k))
        blocks = drs.dense_to_blocks(_t(m))
        _same(blocks, jdrs.dense_to_blocks(jnp.asarray(m)), atol=0)
        _same(drs.blocks_to_dense(blocks), m, atol=0)


def _cases():
    """test_certify.py:151-228's cases, as (name, certifier kwargs, R, src,
    dst, theta, polish)."""
    rng = np.random.default_rng(12345)
    out = []
    r = _random_rotation(rng)
    src = rng.normal(size=(3, 10))
    dst = r @ src + rng.normal(size=(3, 10)) * 0.002
    r_est = np.asarray(jlinalg.svd_rot(jnp.asarray(src), jnp.asarray(dst)))
    out.append(("svd_optimum_polished", {}, r_est, src, dst, np.ones(10), True))
    r = _random_rotation(rng)
    src = rng.normal(size=(3, 10))
    angle = 0.2
    turn = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                     [0, 0, 1]])
    out.append(("rotation_0.2_off", {"max_iterations": 50}, r @ turn, src, r @ src,
                np.ones(10), False))
    r = _random_rotation(rng)
    src = rng.normal(size=(3, 12))
    dst = r @ src
    dst[:, :2] += 5.0
    theta = np.ones(12)
    theta[:2] = -1.0
    out.append(("two_outliers", {}, r, src, dst, theta, False))
    out.append(("two_outliers_bool", {"max_iterations": 50}, r, src, dst, theta > 0, False))
    r, src, dst, theta = _problem(7, n=16, outliers=3, noise=0.003)
    out.append(("noisy_16", {"noise_bound": 0.02}, r, src, dst, theta, True))
    return out


CASES = _cases()
EXPECTED_OPTIMAL = {"svd_optimum_polished": True, "rotation_0.2_off": False,
                    "two_outliers": True, "two_outliers_bool": True}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_certify_matches_jax_float64(case):
    name, kw, r, src, dst, theta, polish = case
    want = jdrs.DRSCertifier(**kw).certify(r, src, dst, theta, polish=polish, device="cpu")
    got = drs.DRSCertifier(**kw).certify(r, src, dst, theta, polish=polish, device="cpu")
    assert got.best_suboptimality.dtype == torch.float64
    assert got.best_suboptimality.device.type == "cpu"
    assert bool(got.is_optimal) == bool(want.is_optimal)
    if name in EXPECTED_OPTIMAL:
        assert bool(got.is_optimal) == EXPECTED_OPTIMAL[name], float(got.best_suboptimality)
    traj_w = np.asarray(want.suboptimality_traj)
    traj_g = got.suboptimality_traj.numpy()
    assert np.array_equal(np.isfinite(traj_g), np.isfinite(traj_w))  # same iterations
    fin = np.isfinite(traj_w)
    np.testing.assert_allclose(traj_g[fin], traj_w[fin], rtol=TRAJ_REL, atol=TRAJ_ABS)
    assert float(got.best_suboptimality) == pytest.approx(float(want.best_suboptimality),
                                                          rel=TRAJ_REL, abs=TRAJ_ABS)


# At noise 0.002 and a 0.01 bound mu ~ noise^2 is small enough that the
# float32 eigen-solves floor the gap near 0.8: the JAX package's float32 mode
# refuses this case too (psulvsb_tpu/certify/drs.py:466-469).
F32_BELOW_FLOOR = {"svd_optimum_polished"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_float32_mode_within_jax_tolerance_of_float64(case):
    name, kw, r, src, dst, theta, polish = case
    cert = drs.DRSCertifier(**kw)
    f32 = cert.certify(r, src, dst, theta, polish=polish, device="cpu", dtype=torch.float32)
    assert f32.best_suboptimality.dtype == torch.float32
    if name in F32_BELOW_FLOOR:
        jax_f32 = jdrs.DRSCertifier(**kw).certify(r, src, dst, theta, polish=polish,
                                                  device="device")
        assert jax_f32.best_suboptimality.dtype == jnp.float32
        assert bool(f32.is_optimal) == bool(jax_f32.is_optimal)
        return
    f64 = cert.certify(r, src, dst, theta, polish=polish, device="cpu")
    assert bool(f32.is_optimal) == bool(f64.is_optimal)
    assert float(f32.best_suboptimality) == pytest.approx(float(f64.best_suboptimality),
                                                          abs=F32_GAP)


def test_tensor_inputs_and_the_card_default():
    _name, kw, r, src, dst, theta, _ = CASES[2]
    cert = drs.DRSCertifier(**kw)
    from_numpy = cert.certify(r, src, dst, theta, device="cpu")
    from_tensors = cert.certify(_t(r), _t(src), _t(dst), torch.as_tensor(theta > 0),
                                device="cpu")
    assert float(from_numpy.best_suboptimality) == float(from_tensors.best_suboptimality)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cert.certify(r, src, dst, theta)


# ---- the harness's certification of a winning solve ----------------------------


@pytest.fixture(scope="module")
def winner_scene(tmp_path_factory):
    """One pair of 500 correspondences at 70% outliers (eval/make_dataset)."""
    root = str(tmp_path_factory.mktemp("winner_scene"))
    md.write_scene(root, n_pairs=1, n_corr=500, outlier_rates=(0.7,), seed=3)
    return root


def _winner_case(scene, case):
    """(src, scaled dst, s, R, t, TIM cap) of a winning solve: the GT pose of
    the scene's pair, at a test scale of 2.5, with a TIM cap that
    subsamples, a pose 2 degrees off, and a pose that leaves fewer than 4
    inliers."""
    corr, gt_path = rd.pair_files(scene, 0, 1)
    src, dst = rd.read_corr_file(corr)
    gt = rd.read_gt_mat(gt_path)
    r, t, s, cap = gt[:3, :3], gt[:3, 3], 1.0, 16  # ~150 inliers: the cap subsamples
    if case == "scaled":
        s = 2.5
    elif case == "cap_8":
        cap = 8
    elif case == "off_2deg":
        a = np.radians(2.0)
        r = r @ np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    elif case == "no_inliers":
        t = t + 50.0
    return np.asarray(src, np.float64), np.asarray(dst, np.float64) * s, s, r, t, cap


@pytest.mark.parametrize("case", ["gt", "scaled", "cap_8", "off_2deg", "no_inliers"])
def test_certify_winner_matches_jax(winner_scene, case):
    """The batched harness's _certify_winner (float64 on the host here)
    against the JAX package's on the same winner and TIM cap: `certified`
    equal, the gap within the trajectory tolerance."""
    src, dst_s, s, r, t, cap = _winner_case(winner_scene, case)
    want = jbh._certify_winner(src, dst_s, s, r, t, JPARAMS, cap)
    got = bh._certify_winner(src, dst_s, s, r, t, PARAMS, cap, torch.device("cpu"))
    assert got["certified"] == want["certified"]
    if np.isinf(want["gap"]):
        assert np.isinf(got["gap"]) and case == "no_inliers"
    else:
        assert got["gap"] == pytest.approx(want["gap"], rel=TRAJ_REL, abs=TRAJ_ABS)
    if case == "gt":
        assert got["certified"]


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference fixture tree not mounted")
@pytest.mark.parametrize("case_dir", SMALL_CASES + LARGE_CASES,
                         ids=lambda p: os.path.relpath(p, REF))
def test_golden_trajectory(case_dir):
    """certify_rotation against the MATLAB-exported trajectory
    (certification-test.cc:109-130), as tests/test_golden_reference.py
    holds the JAX package."""
    d = load_cert_case(case_dir)
    res = drs.certify_rotation(
        _t(d["R_est"]), _t(d["v1"]), _t(d["v2"]), _t(d["theta_est"]),
        noise_bound=d["params"]["noise_bound"], cbar2=d["params"]["cbar2"],
        max_iterations=int(d["params"].get("max_iterations", 200)),
    )
    expected = d["suboptimality_traj"].reshape(-1)
    traj = res.suboptimality_traj.numpy()
    traj = traj[np.isfinite(traj)]
    assert traj.shape == expected.shape
    np.testing.assert_allclose(traj, expected, atol=1e-6)
    _same(drs.get_q_cost(_t(d["v1"]), _t(d["v2"]), d["params"]["noise_bound"],
                         d["params"]["cbar2"]), d["Q_cost"])
