"""The port's whole slice against the JAX solver.

Known scale: six numpy-generated pairs (about 300 correspondences, 90%
displaced outliers, small caps) are solved by JAX `psulvsb_solve` and by
the port's `RobustRegistrationSolver.solve`. The random streams of the two
packages differ, so the comparison is distributional: the port's recall
(RE < 5° and TE < 0.3, the synthetic protocol's success criteria) must be
at least JAX's recall minus one pair in six.

Estimated scale: ten pairs of the unknownScale protocol (mismatch outliers,
the target stretched by a test scale drawn in [1, 5)) through the 3DMatch
preset with scale estimation; success also needs scale error <= 0.1. The
port's recall must be at least JAX's minus one pair in ten, and its median
and 90% quantiles of RE, TE and scale error at most twice JAX's plus a
floor (0.5°, 0.01, 0.01) that absorbs the spread of near-zero errors."""

import warnings

import jax
import numpy as np
import pytest
import torch

from psulvsb_tpu.solver.config import InlierSelectionMode, SolverParams as JParams
from psulvsb_tpu.solver.psulvsb import psulvsb_solve as jax_psulvsb_solve
from psulvsb_tpu_torch import RobustRegistrationSolver, psulvsb_solve, register_pair
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.synthetic import (
    make_synthetic_pair,
    registration_errors,
    synthetic_cloud,
)

C = 300
N_PAIRS = 6
JPARAMS = JParams.preset_artificial(
    sampled_cap=512, basic_cap=128, hypothesis_batch=4, clique_init="off",
    inlier_selection_mode=InlierSelectionMode.NONE,
)


def _pair(k):
    src = synthetic_cloud(C, seed=20 + k)
    return make_synthetic_pair(np.random.default_rng(40 + k), src, 0.05, 0.9)


def _success(pair, rotation, translation) -> bool:
    re = angular_error_deg_np(pair.transform.rotation, np.asarray(rotation))
    te = float(np.linalg.norm(np.asarray(translation) - pair.transform.translation))
    return re < 5.0 and te < 0.3


def test_recall_matches_jax():
    params = params_from_jax(JPARAMS)
    keep = jax.numpy.ones((C,), jax.numpy.int32)
    jax_ok, port_ok = [], []
    for k in range(N_PAIRS):
        pair = _pair(k)
        sol_j, _ = jax_psulvsb_solve(
            jax.numpy.asarray(pair.src), jax.numpy.asarray(pair.dst), keep, JPARAMS,
            jax.random.PRNGKey(k),
        )
        jax_ok.append(bool(sol_j.valid) and _success(pair, sol_j.rotation, sol_j.translation))
        sol_t = RobustRegistrationSolver(params, seed=k, device="cpu").solve(pair.src, pair.dst)
        assert sol_t.rotation.dtype == torch.float32
        assert torch.isfinite(sol_t.rotation).all() and torch.isfinite(sol_t.translation).all()
        port_ok.append(bool(sol_t.valid) and _success(pair, sol_t.rotation, sol_t.translation))
    assert sum(port_ok) / N_PAIRS >= sum(jax_ok) / N_PAIRS - 1 / N_PAIRS, (port_ok, jax_ok)
    assert sum(port_ok) >= N_PAIRS - 1


def test_solver_api_surface():
    params = params_from_jax(JPARAMS)
    pair = _pair(0)
    solver = RobustRegistrationSolver(params, seed=3, device="cpu")
    with pytest.raises(RuntimeError):
        solver.getSolution()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sol = solver.solve(pair.src.astype(np.float64), pair.dst.astype(np.float64))
    assert any("float64" in str(w.message) for w in caught)
    assert solver.getSolution() is sol
    assert _success(pair, sol.rotation, sol.translation)
    assert solver.getFinalInliers().shape == (C,)
    assert solver.getInlierCounter().shape == (C,)
    b_i, b_j = solver.getBasicTIMEndpoints()
    assert solver.getRotationInliersMask().shape == b_i.shape == b_j.shape
    assert solver.getTranslationInliersMask().shape == (C,)
    # The same seed replays bit for bit.
    again = RobustRegistrationSolver(params, seed=3, device="cpu").solve(pair.src, pair.dst)
    assert torch.equal(again.rotation, sol.rotation)
    with pytest.raises(NotImplementedError, match="item 11"):
        solver.solve_decoupled(pair.src, pair.dst)
    callback = params.replace(
        inlier_selection_mode=InlierSelectionMode.PMC_EXACT, exact_clique_callback=True
    )
    with pytest.raises(NotImplementedError, match="item 19"):
        RobustRegistrationSolver(callback, device="cpu").solve(pair.src, pair.dst)


def test_correspondence_overload_and_keep_mask():
    params = params_from_jax(JPARAMS)
    pair = _pair(1)
    perm = np.random.default_rng(0).permutation(C)
    dst_shuffled = pair.dst[:, perm]
    corr = np.stack([np.arange(C), np.argsort(perm)], axis=1)
    sol = RobustRegistrationSolver(params, seed=0, device="cpu").solve(pair.src, dst_shuffled, corr)
    assert _success(pair, sol.rotation, sol.translation)
    keep = np.ones(C, np.int64)
    keep[pair.outlier_mask.nonzero()[0][:50]] = -1
    keep[np.flatnonzero(~pair.outlier_mask)[:5]] = 0
    src_t, dst_t = torch.as_tensor(pair.src), torch.as_tensor(pair.dst)
    sol2, info = register_pair(
        src_t, dst_t, params, torch.Generator().manual_seed(1), keep_mask=torch.as_tensor(keep),
        device="cpu",
    )
    assert _success(pair, sol2.rotation, sol2.translation)
    assert info["host_syncs"] >= 1 + 2 * info["rounds"]
    sol3, info3 = psulvsb_solve(
        src_t, dst_t, torch.as_tensor(keep), params, torch.Generator().manual_seed(1),
        profile=True,
    )
    assert set(info3["stage_s"]) >= {"init", "sample", "local", "host"}
    assert torch.equal(sol3.rotation, sol2.rotation)


def test_register_pair_device():
    """register_pair moves numpy or tensor inputs to `device` and solves
    there, with the result it gives for tensors already there; the default
    device is the card, and with none the move raises."""
    params = params_from_jax(JPARAMS)
    pair = _pair(2)
    keep = np.ones(C, np.int64)
    keep[:7] = 0
    sol_t, _ = register_pair(
        torch.as_tensor(pair.src), torch.as_tensor(pair.dst), params,
        torch.Generator().manual_seed(5), keep_mask=torch.as_tensor(keep), device="cpu",
    )
    sol_n, _ = register_pair(
        pair.src, pair.dst, params, torch.Generator().manual_seed(5), keep_mask=keep, device="cpu"
    )
    assert sol_n.rotation.device.type == "cpu"
    assert torch.equal(sol_n.rotation, sol_t.rotation)
    assert torch.equal(sol_n.translation, sol_t.translation)
    direct, _ = psulvsb_solve(
        torch.as_tensor(pair.src), torch.as_tensor(pair.dst), torch.as_tensor(keep), params,
        torch.Generator().manual_seed(5),
    )
    assert torch.equal(direct.rotation, sol_t.rotation)
    assert _success(pair, sol_t.rotation, sol_t.translation)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            register_pair(pair.src, pair.dst, params)
        with pytest.raises((RuntimeError, AssertionError)):
            RobustRegistrationSolver(params).solve(pair.src, pair.dst)


N_SCALED = 10
JPARAMS_SCALED = JParams.preset_3dmatch(
    estimate_scaling=True, sampled_cap=512, basic_cap=128, hypothesis_batch=4,
    clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE,
)
FLOORS = (0.5, 0.01, 0.01)  # RE (deg), TE, scale error


def _scaled_pair(k):
    rng = np.random.default_rng(60 + k)
    test_scale = 1.0 + 4.0 * rng.uniform()
    return make_synthetic_pair(
        rng, synthetic_cloud(C, seed=70 + k), 0.01, 0.8, outlier_mode="mismatch",
        test_scale=test_scale,
    )


def test_estimated_scale_recall_and_quantiles_match_jax():
    params = params_from_jax(JPARAMS_SCALED)
    keep = jax.numpy.ones((C,), jax.numpy.int32)
    errs = {"jax": [], "port": []}
    for k in range(N_SCALED):
        pair = _scaled_pair(k)
        sol_j, _ = jax_psulvsb_solve(
            jax.numpy.asarray(pair.src), jax.numpy.asarray(pair.dst), keep, JPARAMS_SCALED,
            jax.random.PRNGKey(k),
        )
        errs["jax"].append(
            (bool(sol_j.valid),) + registration_errors(
                pair, np.asarray(sol_j.scale), np.asarray(sol_j.rotation),
                np.asarray(sol_j.translation),
            )
        )
        sol_t = RobustRegistrationSolver(params, seed=k, device="cpu").solve(pair.src, pair.dst)
        assert torch.isfinite(sol_t.scale) and torch.isfinite(sol_t.translation).all()
        errs["port"].append(
            (bool(sol_t.valid),) + registration_errors(
                pair, sol_t.scale, sol_t.rotation, sol_t.translation
            )
        )
    ok = {
        name: [v and re < 5.0 and te < 0.3 and se <= 0.1 for v, re, te, se in e]
        for name, e in errs.items()
    }
    assert sum(ok["port"]) >= sum(ok["jax"]) - 1, errs
    for col, floor in zip(range(1, 4), FLOORS):
        for q in (0.5, 0.9):
            port_q = np.quantile([e[col] for e in errs["port"]], q)
            jax_q = np.quantile([e[col] for e in errs["jax"]], q)
            assert port_q <= 2.0 * jax_q + floor, (col, q, port_q, jax_q)


N_GROR = 6
C_GROR = 350
JPARAMS_GROR = JParams.preset_artificial_gror(
    sampled_cap=512, basic_cap=128, hypothesis_batch=4, gror_k_optimal=200
)


def _gror_pair(k):
    src = synthetic_cloud(C_GROR, seed=80 + k)
    return make_synthetic_pair(np.random.default_rng(90 + k), src, 0.05, 0.9)


def test_gror_preset_recall_matches_jax():
    """The artificial GROR preset at its own clique settings (clique "auto",
    PMC_EXACT on the greedy): GROR seeds every solve, and the port's recall
    is at least JAX's minus one pair in six."""
    params = params_from_jax(JPARAMS_GROR)
    assert params.clique_init == "auto"
    assert params.inlier_selection_mode == InlierSelectionMode.PMC_EXACT
    keep = jax.numpy.ones((C_GROR,), jax.numpy.int32)
    jax_ok, port_ok = [], []
    for k in range(N_GROR):
        pair = _gror_pair(k)
        sol_j, info_j = jax_psulvsb_solve(
            jax.numpy.asarray(pair.src), jax.numpy.asarray(pair.dst), keep, JPARAMS_GROR,
            jax.random.PRNGKey(k),
        )
        jax_ok.append(bool(sol_j.valid) and _success(pair, sol_j.rotation, sol_j.translation))
        solver = RobustRegistrationSolver(params, seed=k, device="cpu")
        sol_t = solver.solve(pair.src, pair.dst)
        assert solver._info["gror_init"] == info_j["gror_init"] is True
        assert torch.isfinite(sol_t.rotation).all() and torch.isfinite(sol_t.translation).all()
        port_ok.append(bool(sol_t.valid) and _success(pair, sol_t.rotation, sol_t.translation))
    assert sum(port_ok) >= sum(jax_ok) - 1, (port_ok, jax_ok)
    assert sum(port_ok) >= N_GROR - 1


def test_frontend_preset_on_real_pair_matches_jax():
    """pair_seed1375 (real FPFH correspondences, C = 1250, 12 true inliers)
    through frontend_solver_params of both packages at the bench caps: both
    pass the KITTI gates (RE < 5 deg, TE < 0.6) and the port's RE is within
    0.5 deg of JAX's. Both run the same number of host rounds and local
    batches: at about 1% inliers no local round stops before its last batch
    in either package (4 rounds of 11 batches), so the port's 44 batches a
    solve are the reference's own."""
    import os

    from psulvsb_tpu.eval.frontend_protocol import frontend_solver_params as jax_frontend
    from psulvsb_tpu_torch.eval.frontend_protocol import frontend_solver_params

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "frontend_aliasing")
    corr = np.loadtxt(os.path.join(here, "pair_seed1375_corr.txt")).astype(np.float32)
    gt = np.loadtxt(os.path.join(here, "pair_seed1375_gt.txt"))
    src, dst = corr[:, :3].T.copy(), corr[:, 3:].T.copy()
    caps = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)
    jp = jax_frontend(**caps)
    params = frontend_solver_params(**caps)
    assert params_from_jax(jp) == params
    params.check_port_supported()
    sol_j, info_j = jax_psulvsb_solve(
        jax.numpy.asarray(src), jax.numpy.asarray(dst),
        jax.numpy.ones((src.shape[1],), jax.numpy.int32), jp, jax.random.PRNGKey(0),
    )
    solver = RobustRegistrationSolver(params, seed=0, device="cpu")
    sol_t = solver.solve(src, dst)
    counts_j = (int(info_j["rounds"]), int(info_j["total_local_batches"]))
    counts_t = (solver._info["rounds"], solver._info["total_local_batches"])
    assert counts_t == counts_j == (4, 44), (counts_t, counts_j)
    errs = []
    for rot, trans in ((sol_j.rotation, sol_j.translation), (sol_t.rotation, sol_t.translation)):
        re = angular_error_deg_np(gt[:3, :3], np.asarray(rot, np.float64))
        te = float(np.linalg.norm(np.asarray(trans, np.float64) - gt[:3, 3]))
        errs.append((re, te))
        assert re < 5.0 and te < 0.6, errs
    assert abs(errs[1][0] - errs[0][0]) <= 0.5, errs
    assert solver._info["gror_init"]
