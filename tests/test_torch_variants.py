"""The settings the port refused before (FGR, gnc_rot_method="eigh", the
exact clique callback) and the variant presets, at the level of a solve.

`psulvsb_register` against `psulvsb_solve` with the same seed under each of
the three settings: equal to the last bit on the CPU, as for every other
setting (tests/test_torch_fused.py). The exact clique round is reached by
constants that make every round stagnate, and the native search runs on one
thread there: with 12 threads, which of several largest cliques comes back
depends on their timing, in either package.

The variant presets `preset_cransac_wt`, `preset_psulvsb_2025_07` and
`preset_whu_tls` against JAX's `psulvsb_solve` on six numpy pairs each of
the unknown-scale protocol (300 correspondences, 80% mismatch outliers, the
target stretched by a factor in [1, 5); noise and scene scale of the preset's
dataset). The random streams differ, so the comparison is distributional, as
in tests/test_torch_slice.py: the port's recall (RE < 5 deg, TE < 0.3 scene
units, scale error <= 0.1) at least JAX's minus one pair in six, and its
median and 90% quantiles of RE, TE and scale error at most twice JAX's plus
a floor (0.5 deg, 0.01 scene units, 0.01).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from psulvsb_tpu.solver.config import (
    InlierSelectionMode,
    RotationEstimationAlgorithm,
    SolverParams as JParams,
)
from psulvsb_tpu.solver.psulvsb import psulvsb_solve as jax_psulvsb_solve
from psulvsb_tpu_torch import RobustRegistrationSolver, psulvsb_register, psulvsb_solve
from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.eval.synthetic import (
    make_synthetic_pair,
    registration_errors,
    synthetic_cloud,
)
from psulvsb_tpu_torch.solver import basic
from psulvsb_tpu_torch.solver.fused import plan_for

C = 300
CAPS = dict(sampled_cap=512, basic_cap=128, hypothesis_batch=4)
# Every local round stagnates, no confidence stop fires and no hypothesis
# counts as similar to the warm state: the ladder is
# climbed to its b_rate == 1.0 round in four host rounds.
CLIMB = dict(local_max_iter=1, stagnation_min_pro_local=1.0, local_confidence=1.0,
             host_confidence=1.0, rotation_similar=-1.0)
SETTINGS = {
    "fgr": dict(rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR,
                clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE),
    "eigh": dict(gnc_rot_method="eigh", clique_init="off",
                 inlier_selection_mode=InlierSelectionMode.NONE),
    "fgr_with_clique_seed": dict(rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR,
                                 clique_init="eager"),
    "exact_clique": dict(exact_clique_callback=True, **CLIMB),
    "exact_clique_estimated_scale": dict(exact_clique_callback=True, estimate_scaling=True,
                                         **CLIMB),
}


def _pair(k, scaled=False):
    rng = np.random.default_rng(40 + k)
    if scaled:
        return make_synthetic_pair(rng, synthetic_cloud(C, seed=20 + k), 0.05, 0.8,
                                   outlier_mode="mismatch", test_scale=1.0 + 4.0 * rng.uniform())
    return make_synthetic_pair(rng, synthetic_cloud(C, seed=20 + k), 0.05, 0.9)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_register_equals_solve_under_the_new_settings(name, monkeypatch):
    monkeypatch.setattr(pmc, "exact_max_clique",
                        functools.partial(pmc.exact_max_clique, n_threads=1))
    params = params_from_jax(JParams.preset_artificial(**CAPS, **SETTINGS[name]))
    params.check_port_supported()
    keep = torch.ones(C, dtype=torch.int64)
    for k in range(2):
        pair = _pair(k, params.estimate_scaling)
        plain_calls = basic.PLAIN_ROUTE_CALLS
        staged, info = psulvsb_solve(
            torch.as_tensor(pair.src.copy()), torch.as_tensor(pair.dst.copy()), keep, params,
            torch.Generator().manual_seed(k),
        )
        fused = psulvsb_register(pair.src, pair.dst, keep, k, params, device="cpu")
        for a, b in zip(staged, fused):
            assert torch.equal(a, b)
        stats = plan_for(params, C, "cpu").stats
        assert stats["rounds"] == info["rounds"]
        assert stats["exact_clique_searches"] == info["exact_clique_searches"]
        if name.startswith("exact_clique"):
            assert info["clique_rounds"] >= 1
            assert info["exact_clique_searches"] >= params.hypothesis_batch
        else:
            assert info["exact_clique_searches"] == 0
            re, te, _ = registration_errors(pair, staged.scale, staged.rotation,
                                            staged.translation)
            assert bool(staged.valid) and re < 5.0 and te < 0.3
        assert (basic.PLAIN_ROUTE_CALLS > plain_calls) == (name == "eigh")


def test_exact_clique_round_without_the_library_raises(monkeypatch):
    """The solver's exact round has no heuristic stand-in: where the library
    cannot be loaded the solve raises instead of running the greedy."""
    def broken():
        raise pmc.NativeUnavailable("no toolchain")

    monkeypatch.setattr(pmc, "_load", broken)
    assert not pmc.native_available()
    params = params_from_jax(JParams.preset_artificial(**CAPS, **SETTINGS["exact_clique"]))
    pair = _pair(0)
    with pytest.raises(RuntimeError, match="no toolchain"):
        RobustRegistrationSolver(params, device="cpu").solve(pair.src, pair.dst)


PRESETS = {
    # preset: (noise, scene scale, TE limit in scene units)
    "preset_cransac_wt": (0.05, 1.0, 0.3),
    "preset_psulvsb_2025_07": (0.01, 1.0, 0.3),
    "preset_whu_tls": (0.15, 30.0, 0.3 * 30.0),
}
N_PAIRS = 6
FLOORS = (0.5, 0.01, 0.01)  # RE (deg), TE (scene units), scale error


@pytest.mark.parametrize("preset", list(PRESETS))
def test_variant_preset_recall_and_quantiles_match_jax(preset):
    noise, scene, te_limit = PRESETS[preset]
    jp = getattr(JParams, preset)(clique_init="off",
                                  inlier_selection_mode=InlierSelectionMode.NONE, **CAPS)
    params = params_from_jax(jp)
    assert params == getattr(type(params), preset)(
        clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE, **CAPS)
    keep = jax.numpy.ones((C,), jax.numpy.int32)
    errs = {"jax": [], "port": []}
    for k in range(N_PAIRS):
        rng = np.random.default_rng(60 + k)
        test_scale = 1.0 + 4.0 * rng.uniform()
        pair = make_synthetic_pair(
            rng, synthetic_cloud(C, seed=70 + k) * np.float32(scene), noise, 0.8,
            max_translation=3.0 * scene, outlier_mode="mismatch", test_scale=test_scale,
        )
        sol_j, info_j = jax_psulvsb_solve(
            jax.numpy.asarray(pair.src), jax.numpy.asarray(pair.dst), keep, jp,
            jax.random.PRNGKey(k),
        )
        errs["jax"].append((bool(sol_j.valid),) + registration_errors(
            pair, np.asarray(sol_j.scale), np.asarray(sol_j.rotation),
            np.asarray(sol_j.translation)))
        solver = RobustRegistrationSolver(params, seed=k, device="cpu")
        sol_t = solver.solve(pair.src, pair.dst)
        assert torch.isfinite(sol_t.scale) and torch.isfinite(sol_t.translation).all()
        errs["port"].append((bool(sol_t.valid),) + registration_errors(
            pair, sol_t.scale, sol_t.rotation, sol_t.translation))
        if not params.enable_refinement:
            assert not bool(solver._info["refined"]) and not bool(info_j["refined"])
    ok = {
        name: [v and re < 5.0 and te < te_limit and se <= 0.1 for v, re, te, se in e]
        for name, e in errs.items()
    }
    assert sum(ok["port"]) >= sum(ok["jax"]) - 1, errs
    assert sum(ok["port"]) >= N_PAIRS - 2, errs
    for col, floor in zip(range(1, 4), FLOORS):
        floor = floor * scene if col == 2 else floor
        for q in (0.5, 0.9):
            port_q = np.quantile([e[col] for e in errs["port"]], q)
            jax_q = np.quantile([e[col] for e in errs["jax"]], q)
            assert port_q <= 2.0 * jax_q + floor, (col, q, port_q, jax_q)
