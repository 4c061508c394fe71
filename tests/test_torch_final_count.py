"""The count a solve returns (`final_inlier_count`) is the consensus of the
pose it returns, the real correspondences within the solver's threshold of
s (R p + t) (registration.cc:669, :1417-1444), on every path of the port:
the staged solve, the fused plan's plain version and `register_batch` in
order and vectorized, at known and at estimated scale and with the
translation rescue. Where the refinement does not run or is not kept it is
the host best's count bit for bit, and without the refinement the answers
are the ones the port gave before it counted the returned pose (pinned
from commit ae7ccebc84a9, where the count was the host best's on every
path). At an estimated scale the answer is held to the float64 similarity
fit over the true inliers (cardbench/reference/oracle.py, plain torch).

Pairs: 240 real correspondences padded to C = 256, every ninth kept column
marked 0 (a pre-filter's), wrong matches at 60, 80 and 90%; the estimated
scale's targets stretched by 1.5, 2.5 and 3.5."""

import functools
import json

import numpy as np
import pytest
import torch

from cardbench.reference import generator, judge, oracle
from psulvsb_tpu_torch import SolverParams, psulvsb_register, psulvsb_solve, register_batch
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.solver import fused

C, REAL = 256, 240
RATES = (0.6, 0.8, 0.9)
CASES = ("known", "unknown", "rescue")
PATHS = ("staged", "fused", "in_order", "vectorized")
# A column whose float64 residual lies within this share of the threshold may
# be counted either way by the solver's float32 residual.
BAND = 1e-5
# The answers of the commit before the count was the returned pose's, with the
# refinement off: (valid, count, scale, rotation row-major, translation).
PINNED_UNREFINED = {
    "known": [
        (True, 96, 1, (0.8871719, 0.4565202, 0.06719649, -0.3270495, 0.7248191, -0.6063628,
                       -0.3255222, 0.5159714, 0.7923439), (0.8431383, 1.101829, -0.0742898)),
        (True, 48, 1, (-0.815538, 0.5766329, 0.04890564, 0.3813256, 0.4718934, 0.794926,
                       0.4353023, 0.6669415, -0.6047318), (0.04894153, 0.02999075, -0.05446245)),
        (True, 24, 1, (0.03965813, -0.6425316, 0.7652323, 0.9956642, -0.03908026, -0.08441421,
                       0.08414423, 0.7652621, 0.6381957), (-0.9754148, -0.8011988, 0.6402426)),
    ],
    "unknown": [
        (True, 96, 1.508749, (0.8874112, 0.4562694, 0.06572418, -0.328205, 0.7254764, -0.6049508,
                              -0.3237019, 0.5152692, 0.7935457),
         (0.8382379, 1.095338, -0.07397725)),
        (True, 39, 2.4894, (-0.8133166, 0.5798924, 0.04733784, 0.3807681, 0.4689852, 0.7969118,
                            0.4399223, 0.6661664, -0.6022381),
         (0.05231331, 0.03139096, -0.05447701)),
        (True, 16, 3.492021, (0.0417428, -0.6413649, 0.7660995, 0.9957877, -0.03594351,
                              -0.08434913, 0.08163497, 0.7663934, 0.637163),
         (-0.974754, -0.806626, 0.6497144)),
    ],
}
# That commit's counts with the refinement on: the host best's, before it.
PINNED_BEST = {"known": [96, 48, 24], "unknown": [96, 39, 16], "rescue": [96, 48, 24]}


def _pair(k: int, scaled: bool):
    sigma = 1.0 + 4.0 * (k + 0.5) / 4 if scaled else 1.0
    p = make_synthetic_pair(np.random.default_rng(300 + k), synthetic_cloud(REAL, seed=k), 0.01,
                            RATES[k], max_translation=2.0, outlier_mode="mismatch",
                            test_scale=sigma)
    src, dst = torch.zeros(3, C), torch.zeros(3, C)
    src[:, :REAL] = torch.as_tensor(np.asarray(p.src), dtype=torch.float32)
    dst[:, :REAL] = torch.as_tensor(np.asarray(p.dst), dtype=torch.float32)
    keep = torch.full((C,), -2, dtype=torch.int64)
    keep[:REAL] = 1
    keep[3:REAL:9] = 0
    return src, dst, keep


def _params(case: str, refine: bool = True) -> SolverParams:
    return SolverParams.preset_3dmatch(
        sampled_cap=256, basic_cap=64, hypothesis_batch=4, enable_refinement=refine,
        estimate_scaling=case == "unknown", translation_rescue=case == "rescue")


def _seed(k: int) -> int:
    return 11 + k


def _batch(case: str):
    pairs = [_pair(k, case == "unknown") for k in range(len(RATES))]
    return tuple(torch.stack(x) for x in zip(*pairs))


@functools.lru_cache(maxsize=None)
def _solve(case: str, path: str, refine: bool = True):
    """(solutions with a leading pair axis, the host best's counts) of the
    three pairs along `path`."""
    params = _params(case, refine)
    src, dst, keep = _batch(case)
    seeds = [_seed(k) for k in range(len(RATES))]
    if path in ("in_order", "vectorized"):
        fused.clear_plan_cache()
        sols = register_batch(src, dst, keep, seeds, params, vectorized=path == "vectorized",
                              device="cpu")
        return sols, None
    rows, best = [], []
    for k in range(len(RATES)):
        if path == "staged":
            sol, info = psulvsb_solve(src[k], dst[k], keep[k], params,
                                      torch.Generator().manual_seed(seeds[k]))
            best.append(int(info["best_count"]))
        else:
            sol = psulvsb_register(src[k], dst[k], keep[k], seeds[k], params, device="cpu")
            best.append(int(fused.plan_for(params, C, "cpu").bufs["hs.best_count"]))
        rows.append(sol)
    return type(rows[0])(*(torch.stack(f) for f in zip(*rows))), best


def _consensus(params, src, dst, keep, scale, rotation, translation):
    """The pose's consensus over the real columns at the solver's threshold,
    pr_noise (1 + kept/real), in float64; and how many columns lie within
    BAND of the threshold."""
    real = keep > -2
    thr = params.pr_noise * (1.0 + int((keep == 1).sum()) / int(real.sum()))
    moved = float(scale) * (rotation.double() @ src.double() + translation.double()[:, None])
    res = torch.linalg.vector_norm(dst.double() - moved, dim=0)[real]
    return int((res <= thr).sum()), int(((res - thr).abs() <= BAND * thr).sum())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_the_count_is_the_returned_poses_consensus(case, path):
    params = _params(case)
    sols, _ = _solve(case, path)
    src, dst, keep = _batch(case)
    for k in range(len(RATES)):
        want, edge = _consensus(params, src[k], dst[k], keep[k], sols.scale[k],
                                sols.rotation[k], sols.translation[k])
        assert abs(int(sols.final_inlier_count[k]) - want) <= edge, (case, path, k)
    staged, _ = _solve(case, "staged")
    assert torch.equal(sols.final_inlier_count, staged.final_inlier_count)
    assert torch.equal(sols.valid, staged.valid)


def test_at_an_estimated_scale_the_count_moves_with_the_refinement():
    """The refined pose's consensus is not the host best's on these pairs:
    the count the solve returned before was not the pose's."""
    sols, best = _solve("unknown", "staged")
    assert [int(n) for n in sols.final_inlier_count] != best
    assert best == PINNED_BEST["unknown"]


@pytest.mark.parametrize("path", ("staged", "fused"))
@pytest.mark.parametrize("case", CASES)
def test_the_host_bests_count_stays_reachable(case, path):
    """The staged solve's info["best_count"] and the plan's hs.best_count
    buffer hold the count from before the refinement, the one returned
    before (and by the JAX package)."""
    _, best = _solve(case, path)
    assert best == PINNED_BEST[case]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", ("known", "unknown"))
def test_without_the_refinement_the_answers_are_the_old_ones(case, path):
    sols, best = _solve(case, path, refine=False)
    if best is not None:
        assert [int(n) for n in sols.final_inlier_count] == best
    for k, (valid, count, scale, rotation, translation) in enumerate(PINNED_UNREFINED[case]):
        assert bool(sols.valid[k]) == valid and int(sols.final_inlier_count[k]) == count
        np.testing.assert_allclose(float(sols.scale[k]), scale, rtol=1e-6)
        np.testing.assert_allclose(sols.rotation[k].flatten().numpy(), rotation, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(sols.translation[k].numpy(), translation, rtol=0, atol=1e-6)


def test_a_refinement_that_is_not_kept_returns_the_host_bests_count():
    """A refinement whose RMSE gate fails leaves the host best's pose, and
    its count bit for bit; one that is kept recounts."""
    from psulvsb_tpu_torch.solver import psulvsb as tps

    params = _params("unknown")
    src, dst, keep = _pair(1, True)
    hs = tps.HostState.initial(C, keep)
    best = tps.WarmState(torch.tensor(2.0), torch.eye(3), torch.zeros(3), torch.tensor(False))
    hs = hs._replace(best=best, best_count=torch.tensor(7))
    thr = torch.tensor(0.05)
    # No point kept: the gate compares two empty RMSEs, and nothing moves.
    rot, trans, count, refined, rescued = tps._finalize_counted(src, dst, hs, best, thr, params)
    assert not bool(refined) and not bool(rescued)
    assert torch.equal(rot, best.rotation) and torch.equal(trans, best.translation)
    assert count.dtype == torch.int64 and int(count) == 7


@pytest.fixture(scope="module")
def stretched_pool():
    """Six seeded pairs of 3dmatch_unknown's protocol at 300 correspondences,
    one for each wrong-match rate, each stretched by its own scale in [1, 5)."""
    cfg = json.loads(open("cardbench/configs/3dmatch_unknown.json").read())
    return cfg, generator.make_pool(cfg, 2**32 + 17, [300], 6)[300]


def test_an_estimated_scale_answer_is_near_the_similarity_fit(stretched_pool):
    """Each answer that the judge counts as recalled, to a pair whose true
    inliers all lie within the threshold, is held to the float64 Umeyama fit
    over those inliers:

    - scale within 2% of the fit's: the 1-point consensus takes it from TIM
      ratios whose ranges are 2 inner_noise_bound sqrt(cbar2) / |src TIM|,
      5-20% of it on these 0.5-2 m TIMs, and the refinement keeps that
      scale; read 0.003-0.9% on three pool seeds;
    - rotation within 0.5 deg: the refinement weights each point by the
      rounds it was an inlier in, the fit uniformly, so the two differ by the
      noise of a fit over 15-120 points, nb / (0.5 m sqrt(n)) ~ 0.1 deg;
      read up to 0.2 deg;
    - translation within 5 nb (0.05): t is the fitted offset over the scale,
      so a scale 1% off moves it by 1% of the offset (up to 3.5 m here), and
      the rotation's 0.5 deg over the 1 m scene adds 0.009; read up to 0.021;
    - the count not off the pose's consensus (the judge's count_off)."""
    cfg, pool = stretched_pool
    params = SolverParams.preset_3dmatch(sampled_cap=256, basic_cap=64, hypothesis_batch=4,
                                         estimate_scaling=True)
    src = torch.as_tensor(np.stack([p.src for p in pool]))
    dst = torch.as_tensor(np.stack([p.dst for p in pool]))
    keep = torch.ones(len(pool), 300, dtype=torch.int64)
    sols = register_batch(src, dst, keep, [5 + j for j in range(len(pool))], params, device="cpu")
    nb = cfg["noise_bound"]
    thr = judge.inlier_threshold(nb, np.ones(300))
    held = 0
    for j, pair in enumerate(pool):
        fit = oracle.oracle_answer(pair, thr, torch.float64, similarity=True)
        answer = {"valid": bool(sols.valid[j]), "scale": float(sols.scale[j]),
                  "rotation": sols.rotation[j].double().numpy(),
                  "translation": sols.translation[j].double().numpy(),
                  "count": int(sols.final_inlier_count[j])}
        res = judge.residuals(pair.src, pair.dst, pair.scale, pair.rotation, pair.translation)
        reading = judge.judge(pair, answer, thr, int((res <= thr).sum()), cfg["criteria"], fit)
        if not reading["recall"] or not (res[~pair.outlier_mask] <= thr).all():
            continue
        held += 1
        assert abs(answer["scale"] - fit["scale"]) <= 0.02 * fit["scale"], j
        cos = (np.trace(answer["rotation"].T @ fit["rotation"]) - 1.0) / 2.0
        assert np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) <= 0.5, j
        assert np.linalg.norm(answer["translation"] - fit["translation"]) <= 5 * nb, j
        assert not reading["count_off"], j
    assert held >= 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_cuda_the_graphs_count_is_the_returned_poses_consensus(cuda_device, case, vectorized):
    """The captured plan (one graph launch a solve, or a pair axis) returns
    the consensus of the pose it returns, as the plain version does."""
    params = _params(case)
    src, dst, keep = _batch(case)
    seeds = [_seed(k) for k in range(len(RATES))]
    fused.clear_plan_cache()
    sols = register_batch(src, dst, keep, seeds, params, vectorized=vectorized,
                          device=cuda_device)
    sols = type(sols)(*(f.cpu() for f in sols))
    fused.clear_plan_cache()
    for k in range(len(RATES)):
        want, edge = _consensus(params, src[k], dst[k], keep[k], sols.scale[k],
                                sols.rotation[k], sols.translation[k])
        assert abs(int(sols.final_inlier_count[k]) - want) <= edge, (case, k)
