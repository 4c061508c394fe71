"""The known-scale init past the dense kernel (`init_route` "exact_beta"),
held to the plain window test of `cardbench/reference/beta_window.py`.

At C = 480 with `dense_init_max_c` lowered, "auto" takes the route the
card takes past 8192 correspondences. On seeded pairs, the staged init and
the fused plan's (single and with a pair axis) give: `red_count` the plain
count in the solver's float32 arithmetic, clamped at `reduced_cap`, and
between the float64 counts a float32 band around beta apart; a pool count
of min(accepted draws, the pool's fill); and the pool itself, the accepted
draws in the order of their sort keys, each pair passing the plain test and
no draw taken twice. (The draws are made with replacement, as the JAX
package makes them, so a pair drawn twice and accepted twice fills two
slots.) A traced plan stamps the beta count and the fill inside the init.
The CUDA cases, the traced plan's captured graph and the beta count on a
WHU-TLS-like pair of the benchmark's generator at 14336 columns, skip here (`python -m pytest
tests/test_torch_exact_beta_route.py -m cuda --noconftest` on a card).
"""

import numpy as np
import pytest
import torch

from cardbench.reference import beta_window
from psulvsb_tpu_torch import SolverParams, psulvsb_register
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.ops.hist import pair_beta_count
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.solver.psulvsb import InitDraws, _init_stage, init_route
from psulvsb_tpu_torch.utils import timing

C = 480
BUDGET = 1 << 13  # rejection draws
RATES = (0.6, 0.9, 0.95)
# pool_cap, reduced_cap: a fill of 56 slots the draws fill, one of 1792 they
# leave short, and a reduced_cap under the reduced set's size.
CAPS = {"full": (64, 131072), "short": (2048, 131072), "clamped": (2048, 600)}
# The benchmark's WHU-TLS caps at known scale, the clique stages off.
WHU = dict(sampled_cap=256, basic_cap=64, hypothesis_batch=4, estimate_scaling=False,
           clique_init="off")


def _params(case: str) -> SolverParams:
    pool_cap, reduced_cap = CAPS[case]
    return SolverParams.preset_whu_tls(
        dense_init_max_c=256, init_reject_budget=BUDGET, pool_cap=pool_cap,
        reduced_cap=reduced_cap, enable_self_update=False, **WHU)  # the pool stays the init's


def _pair(seed: int, rate: float):
    """A WHU-TLS-like pair: the surface at 30 m, noise bound 0.15, wrong
    matches at `rate`, the last 40 columns padding."""
    rng = np.random.default_rng(seed)
    real = C - 40
    cloud = synthetic_cloud(real, seed=seed + 100) * np.float32(30.0)
    pair = make_synthetic_pair(rng, cloud, 0.15, rate, max_translation=15.0,
                               outlier_mode="mismatch")
    src = np.zeros((3, C), np.float32)
    dst = np.zeros_like(src)
    src[:, :real], dst[:, :real] = pair.src, pair.dst
    keep = np.full(C, -2, np.int64)
    keep[:real] = 1
    keep[rng.permutation(real)[:20]] = -1  # some columns thrown out by a pre-filter
    return src, dst, keep


def _draws(seed: int):
    """The fill's draws, as the plan's layout makes them: pairs (i < j) and
    sort keys."""
    rng = np.random.default_rng([seed, 7])
    a = rng.integers(0, C, BUDGET)
    b = rng.integers(0, C - 1, BUDGET)
    b = np.where(b >= a, b + 1, b)
    pairs = (torch.as_tensor(np.minimum(a, b)), torch.as_tensor(np.maximum(a, b)))
    return InitDraws(fill_pairs=pairs, fill_keys=torch.as_tensor(rng.integers(0, 1 << 30, BUDGET)))


def _expected(params, src, dst, keep, draws):
    """(red_count, the draws' pairs, the draws the pool takes) of the plain
    reference: the accepted draws in the order of their sort keys (stable),
    the first min(accepted, pool_fill) of them."""
    act = keep == 1
    nb, cbar2 = params.noise_bound, params.cbar2
    red = beta_window.count(src, dst, act, nb, cbar2, "float32")
    i, j = (t.numpy() for t in draws.fill_pairs)
    ok = act[i] & act[j] & beta_window.member(src, dst, i, j, nb, cbar2, "float32")
    keys = np.where(ok, draws.fill_keys.numpy(), 1 << 30)
    taken = np.argsort(keys, kind="stable")[:min(int(ok.sum()), params.pool_fill)]
    return min(red, params.reduced_cap), i, j, taken


def _check_init(params, src, dst, keep, red_i, red_j, red_count, pool, expected):
    """The init's outputs against the plain reference."""
    nb, cbar2 = params.noise_bound, params.cbar2
    red, draw_i, draw_j, taken = expected
    assert int(red_count) == red
    widen = beta_window.slack(src, dst)
    if red < params.reduced_cap:  # float64 and float32 apart by the band's pairs alone
        act = keep == 1
        assert beta_window.count(src, dst, act, nb, cbar2, widen=-widen) <= red
        assert red <= beta_window.count(src, dst, act, nb, cbar2, widen=widen)
    n_pool = len(taken)
    assert int(pool) == n_pool and len(set(taken.tolist())) == n_pool  # no draw twice
    i, j = np.asarray(red_i)[:n_pool], np.asarray(red_j)[:n_pool]
    assert np.array_equal(i, draw_i[taken]) and np.array_equal(j, draw_j[taken])
    assert (i < j).all() and (keep[i] == 1).all() and (keep[j] == 1).all()
    assert beta_window.member(src, dst, i, j, nb, cbar2, widen=widen).all()


@pytest.mark.parametrize("case", sorted(CAPS))
@pytest.mark.parametrize("k", range(len(RATES)))
def test_the_staged_init_is_the_plain_window_test(case, k):
    params = _params(case)
    assert init_route(params, C) == "exact_beta"
    src, dst, keep = _pair(11 + k, RATES[k])
    draws = _draws(k)
    expected = _expected(params, src, dst, keep, draws)
    got = _init_stage(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(keep), params,
                      draws=draws)
    _check_init(params, src, dst, keep, *got, expected)
    # The cases reach what they are named for.
    red, n_pool = expected[0], len(expected[3])
    assert {"full": n_pool == params.pool_fill, "short": n_pool < params.pool_fill,
            "clamped": red == params.reduced_cap}[case]


@pytest.mark.parametrize("pairs", [None, 2])
def test_the_plans_init_is_the_plain_window_test(pairs):
    """The plan's buffers after a solve: the init of the draws its layout
    took from the solve's generator, computed apart (beta count, then the
    fill) and handed to the rest of the init."""
    params = _params("short")
    seeds = [3, 4]
    cases = [_pair(21 + k, RATES[k + 1]) for k in range(2)]
    fused.clear_plan_cache()
    try:
        for k in range(2 if pairs is None else 1):
            batch = cases if pairs else [cases[k]]
            src, dst, keep = (np.stack(a) for a in zip(*batch))
            plan = fused.plan_for(params, C, "cpu", pairs=pairs)
            assert plan.beta_apart and not plan.peak_apart
            gens = [torch.Generator().manual_seed(s) for s in seeds[:len(batch)]]
            if pairs:
                plan.solve(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(keep), gens)
            else:
                plan.solve(torch.as_tensor(src[0]), torch.as_tensor(dst[0]),
                           torch.as_tensor(keep[0]), gens[0])
            b = plan.bufs
            for p in range(len(batch)):
                row = (lambda t: t[p]) if pairs else (lambda t: t)
                draws = plan.layout.init_draws(row(b["draws"]))
                fill = InitDraws(fill_pairs=draws.fill_pairs, fill_keys=draws.fill_keys)
                expected = _expected(params, src[p], dst[p], keep[p], fill)
                _check_init(params, src[p], dst[p], keep[p], row(b["red_i"]), row(b["red_j"]),
                            row(b["red_count"]), row(b["red_pool"]), expected)
    finally:
        fused.clear_plan_cache()


def _check_traced(device) -> None:
    """Inside each init, one `solve.init.beta` then one `solve.init.fill`. A
    plan on the dense route stamps neither. Each plan is built by a first
    solve before the window."""
    cases = [(_params(case), _pair(31 + k, RATES[k]), k)
             for k, case in enumerate(("short", "full", "short"))]
    dense = (SolverParams.preset_whu_tls(**WHU), _pair(41, 0.6), 5)
    fused.clear_plan_cache()
    timing.enable(True)
    try:
        for params, pair, seed in cases + [dense]:
            psulvsb_register(*pair, seed + 1, params, device=device)
        timing.start()
        for params, pair, seed in cases:
            psulvsb_register(*pair, seed, params, device=device)
        snap = timing.snapshot()
        timing.start()
        psulvsb_register(*dense[1], dense[2], dense[0], device=device)
        dense_ops = timing.snapshot()["device"]
    finally:
        timing.enable(False)
        fused.clear_plan_cache()
        timing.start()
    ops = snap["device"]
    assert ops["solve.init"]["count"] == ops["solve.init.beta"]["count"] == 3
    assert ops["solve.init.fill"]["count"] == 3
    spans = {name: [(s, e) for n, _, s, e in snap["timeline"] if n == name]
             for name in ("solve.init", "solve.init.beta", "solve.init.fill")}
    for (a, b), (bs, be), (fs, fe) in zip(*spans.values()):
        assert a <= bs <= be <= fs <= fe <= b
    assert "solve.init" in dense_ops
    assert "solve.init.beta" not in dense_ops and "solve.init.fill" not in dense_ops


def test_a_traced_plan_stamps_the_beta_count_and_the_fill():
    _check_traced("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_a_traced_plan_stamps_the_beta_count_and_the_fill(cuda_device):
    """The captured graph's stamps, as the plain version's."""
    _check_traced(cuda_device)


@pytest.mark.cuda
def test_cuda_beta_count_at_the_widest_bucket_is_the_plain_count(cuda_device):
    """pair_beta_count at 14336 columns, 14000 active, on a WHU-TLS-like
    pair of the benchmark's generator (the surface at 30 m, noise bound
    0.15, 60% wrong matches): the plain count in the solver's float32
    arithmetic to the pair, between the float64 counts a band apart."""
    from cardbench.reference.generator import make_pool

    config = {"scene_scale": 30.0, "max_translation": 15.0, "noise_bound": 0.15,
              "outlier_mode": "mismatch", "outlier_rates": [0.6]}
    pair = make_pool(config, 2**33 + 5, [14000], 1)[14000][0]
    src = np.zeros((3, 14336), np.float32)
    dst = np.zeros_like(src)
    src[:, :14000], dst[:, :14000] = pair.src, pair.dst
    act = np.zeros(14336, bool)
    act[:14000] = True
    params = SolverParams.preset_whu_tls(estimate_scaling=False)
    beta = 2.0 * params.noise_bound * np.sqrt(params.cbar2)
    got = int(pair_beta_count(torch.as_tensor(src, device=cuda_device),
                              torch.as_tensor(dst, device=cuda_device), beta,
                              torch.as_tensor(act, device=cuda_device)))
    nb = params.noise_bound
    assert got == beta_window.count(src, dst, act, nb, params.cbar2, "float32")
    widen = beta_window.slack(src, dst)
    assert beta_window.count(src, dst, act, nb, widen=-widen) <= got
    assert got <= beta_window.count(src, dst, act, nb, widen=widen)
