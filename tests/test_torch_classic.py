"""The classic decoupled solve (solver/classic.py, api.solve_decoupled)
against the JAX package.

Pairs of 120 correspondences from numpy seeds (60% outliers: displaced at
known scale, mismatched with the target stretched by 2.5 at estimated
scale). The one draw of the path, the 1-point scale consensus's uniforms, is
made by JAX from the key its solve consumes and fed to the port. Tolerances:
the clique equal as a set (PMC_EXACT through each package's own build of the
native library, searched on one thread in both: with its 12 threads the
search returns whichever of several largest cliques a thread finds first, so
two runs of one package may differ), the scale
within 1e-5 relative, the rotation within 1e-5, the translation within 1e-5
times the scene scale (the clouds span about 2 units, and 5 when stretched),
the inlier masks equal. Covered: known and estimated scale, CHAIN and
COMPLETE rotation TIMs, every InlierSelectionMode, FGR and the "eigh"
rotation, the clique abort, and the API's getters after each.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.solver import config as jc
from psulvsb_tpu.solver.classic import solve_decoupled as jax_solve_decoupled
from psulvsb_tpu_torch import RobustRegistrationSolver
from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.solver.classic import consistency_graph, solve_decoupled

C = 120
ROT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_search_thread(monkeypatch):
    from psulvsb_tpu.clique import pmc as jpmc

    for mod in (pmc, jpmc):
        monkeypatch.setattr(mod, "exact_max_clique",
                            functools.partial(mod.exact_max_clique, n_threads=1))


SETTINGS = {
    "known": {},
    "estimated": {"estimate_scaling": True},
    "complete": {"rotation_tim_graph": jc.InlierGraphFormulation.COMPLETE},
    # 7140 rotation TIMs, beyond what the batched GNC kernel serves: one route at every size.
    "complete_over_all_points": {"rotation_tim_graph": jc.InlierGraphFormulation.COMPLETE,
                                 "inlier_selection_mode": jc.InlierSelectionMode.NONE},
    "pmc_heu": {"inlier_selection_mode": jc.InlierSelectionMode.PMC_HEU},
    "kcore_heu": {"inlier_selection_mode": jc.InlierSelectionMode.KCORE_HEU},
    "none": {"inlier_selection_mode": jc.InlierSelectionMode.NONE},
    "no_max_clique": {"use_max_clique": False},
    "fgr": {"rotation_estimation_algorithm": jc.RotationEstimationAlgorithm.FGR},
    "eigh": {"gnc_rot_method": "eigh"},
}


def _pair(k, scaled):
    rng = np.random.default_rng(k)
    return make_synthetic_pair(
        rng, synthetic_cloud(C, seed=k), 0.05, 0.6,
        outlier_mode="mismatch" if scaled else "displace", test_scale=2.5 if scaled else 1.0,
    )


def _both(name, k=0):
    jp = jc.SolverParams.preset_artificial(**{"estimate_scaling": False, **SETTINGS[name]})
    pair = _pair(k, jp.estimate_scaling)
    key = jax.random.PRNGKey(k)
    u = np.asarray(jax.random.uniform(key, (jp.scale_max_draws,), jnp.float32))
    want = jax_solve_decoupled(jnp.asarray(pair.src), jnp.asarray(pair.dst), jp, key)
    got = solve_decoupled(
        torch.as_tensor(pair.src.copy()), torch.as_tensor(pair.dst.copy()), params_from_jax(jp),
        scale_u=torch.as_tensor(u.copy()),
    )
    return pair, jp, want, got


@pytest.mark.parametrize("name", list(SETTINGS))
def test_solve_decoupled_matches_jax(name):
    pair, jp, (sol_j, info_j), (sol_t, info_t) = _both(name)
    scene = float(np.abs(pair.dst).max())
    assert bool(sol_t.valid) and bool(sol_j.valid)
    assert info_t["max_clique"] == [int(v) for v in info_j["max_clique"]]
    np.testing.assert_allclose(float(sol_t.scale), float(sol_j.scale), rtol=1e-5)
    np.testing.assert_allclose(sol_t.rotation.numpy(), np.asarray(sol_j.rotation), atol=ROT_TOL)
    np.testing.assert_allclose(
        sol_t.translation.numpy(), np.asarray(sol_j.translation), atol=1e-5 * max(scene, 1.0)
    )
    assert int(sol_t.final_inlier_count) == int(sol_j.final_inlier_count)
    for mask in ("scale_inliers", "rotation_inliers", "translation_inliers",
                 "translation_points", "basic_tims_i", "basic_tims_j"):
        np.testing.assert_array_equal(info_t[mask].numpy(), np.asarray(info_j[mask]), mask)
    # The upstream convention: dst = s R src + t on the true inliers.
    inl = ~pair.outlier_mask
    moved = float(sol_t.scale) * sol_t.rotation.numpy() @ pair.src[:, inl]
    resid = np.linalg.norm(pair.dst[:, inl] - moved - sol_t.translation.numpy()[:, None], axis=0)
    assert np.median(resid) < 3 * 0.05 * float(pair.transform.scale)


def test_chain_wraps_around_and_complete_is_upper_triangular():
    _, _, _, (_, chain) = _both("known")
    m = len(chain["max_clique"])
    cq = np.asarray(chain["max_clique"])
    np.testing.assert_array_equal(chain["basic_tims_i"].numpy(), cq)
    np.testing.assert_array_equal(chain["basic_tims_j"].numpy(), np.roll(cq, -1))
    _, _, _, (_, full) = _both("complete")
    a, b = np.triu_indices(m, 1)
    np.testing.assert_array_equal(full["basic_tims_i"].numpy(), cq[a])
    np.testing.assert_array_equal(full["basic_tims_j"].numpy(), cq[b])


def test_exact_clique_is_the_native_search_of_the_graph():
    pair, jp, _, (_, info) = _both("known", k=1)
    before = pmc.EXACT_SEARCHES
    ii, jj = torch.triu_indices(C, C, 1)
    adj = consistency_graph(ii, jj, info["scale_inliers"], C)
    assert torch.equal(adj, adj.T) and not adj.diagonal().any()
    assert int(adj.sum()) == 2 * int(info["scale_inliers"].sum())
    assert pmc.exact_max_clique(adj.numpy()) == info["max_clique"]
    assert pmc.EXACT_SEARCHES == before + 1


def test_clique_abort_keeps_the_masks_computed_so_far():
    """No two TIMs agree in length (noise bound 1e-9 on unrelated clouds):
    the clique has one vertex and the solve aborts (registration.cc:1032)."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 20)).astype(np.float32)
    dst = (rng.normal(size=(3, 20)) * 7).astype(np.float32)
    jp = jc.SolverParams.preset_artificial(noise_bound=1e-9)
    sol_j, info_j = jax_solve_decoupled(jnp.asarray(src), jnp.asarray(dst), jp,
                                        jax.random.PRNGKey(0))
    solver = RobustRegistrationSolver(params_from_jax(jp), seed=0, device="cpu")
    sol_t = solver.solve_decoupled(src, dst)
    assert not bool(sol_t.valid) and not bool(sol_j.valid)
    assert solver._info["max_clique"] == [int(v) for v in info_j["max_clique"]]
    assert int(sol_t.final_inlier_count) == 0
    np.testing.assert_array_equal(sol_t.rotation.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(solver.getScaleInliersMask().numpy(),
                                  np.asarray(info_j["scale_inliers"]))
    for getter in (solver.getRotationInliersMask, solver.getTranslationInliersMask,
                   solver.getBasicTIMEndpoints):
        with pytest.raises(RuntimeError, match="not produced"):
            getter()


def test_api_solve_decoupled_getters_and_device():
    pair = _pair(2, False)
    params = params_from_jax(jc.SolverParams.preset_artificial())
    solver = RobustRegistrationSolver(params, seed=4, device="cpu")
    sol = solver.solve_decoupled(pair.src, pair.dst)
    assert solver.getSolution() is sol and bool(sol.valid)
    b_i, b_j = solver.getBasicTIMEndpoints()
    assert solver.getRotationInliersMask().shape == b_i.shape == b_j.shape
    assert solver.getTranslationInliersMask().shape == (C,)
    assert solver.getScaleInliersMask().shape == (C * (C - 1) // 2,)
    direct, _ = solve_decoupled(torch.as_tensor(pair.src.copy()), torch.as_tensor(pair.dst.copy()),
                                params)
    assert torch.equal(direct.rotation, sol.rotation)  # known scale draws nothing
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            RobustRegistrationSolver(params).solve_decoupled(pair.src, pair.dst)


def test_long_tim_lists_score_the_consensus_in_slices():
    """Beyond the grid limit the 1-point consensus counts its draws in
    slices; the result is the unsliced one."""
    from psulvsb_tpu_torch.robust import scalar_tls

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(0.5, 4.0, size=3000).astype(np.float32))
    x[:900] = 2.0 + torch.as_tensor(rng.uniform(-0.01, 0.01, size=900).astype(np.float32))
    ranges = torch.full_like(x, 0.02)
    u = torch.as_tensor(rng.uniform(size=64).astype(np.float32))
    whole = scalar_tls.scale_consensus_1pt(x, ranges, max_draws=64, u=u)
    limit = scalar_tls._GRID_LIMIT
    scalar_tls._GRID_LIMIT = 7 * 3000  # 7 draws a slice
    try:
        sliced = scalar_tls.scale_consensus_1pt(x, ranges, max_draws=64, u=u)
    finally:
        scalar_tls._GRID_LIMIT = limit
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])
    assert abs(float(whole[0]) - 2.0) < 0.01
