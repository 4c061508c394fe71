"""The batched form of the pair batch (`register_batch(..., vectorized=True)`,
`solver.fused.ReplayPlan(pairs=P)`) and the pair axis of its kernels' front
doors, on the CPU.

The batched plan is `jax.vmap` of the one-dispatch solve over P pairs, for
every setting: every stage runs once for all pairs under `torch.func.vmap`,
every IF and loop while any pair's flag holds (the FGR and "eigh" rotation
loops inside a stage too), and the pairs whose flag does not hold are
frozen. On the CPU it runs eagerly (its plain version) and each pair must
equal its `psulvsb_register` alone with the same seed: valid and inlier
counts equal, the same rounds, local batches and lazy seed, and scale,
rotation and translation within TOL = 1e-5 (the batched products and
reductions run over other shapes than one pair's, so float32 sums may take
another order). The settings: the dense init (known and estimated scale,
the lazy and eager clique seeds, padding), GROR, the `exact_beta`,
`exact_hist` and `sampled` inits (the large-C routes, asked for at a small
C with a cut fill budget), FGR, gnc_rot_method="eigh" and the exact clique
callback (its b_rate == 1.0 round reached by stagnating every round, the
native search on one thread). The kernels' front doors with a pair axis are
held against `jax.vmap` of the JAX front doors (the Pallas kernels in
interpret mode): `gnc_batch` within test_torch_gnc's ROT_TOL = 1e-4 and
MASK_AGREE = 0.99, `exact_peak_bin` equal. The whole batch is held against
JAX's `register_batch(vectorized=True)` as test_torch_fused holds
`psulvsb_register`: recall, and the RE/TE quantiles, on the dense init and on
GROR and `exact_beta`. The CUDA cases skip here (`python -m pytest
tests/test_torch_batched.py -m cuda --noconftest` on a card).
"""

import functools
import types

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch import SolverParams, psulvsb_register, register_batch
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.core.linalg import _quat_to_rot
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.ops import gnc, hist
from psulvsb_tpu_torch.ops._build import LAUNCHES
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.solver.config import InlierSelectionMode, RotationEstimationAlgorithm
from psulvsb_tpu_torch.solver.psulvsb import init_route

TOL = 1e-5
ROT_TOL = 1e-4
MASK_AGREE = 0.99
CAPS = dict(sampled_cap=256, basic_cap=64, hypothesis_batch=4)
LOOP = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)
# The large-C inits at C = 200: a cut fill budget and peak sample.
SMALL_FILL = dict(init_reject_budget=1 << 14, init_peak_sample=1 << 13)
# Every round stagnates, so round 4 of 5 is the b_rate == 1.0 clique round.
STAGNATE = dict(local_max_iter=1, stagnation_min_pro_local=1.0, local_confidence=1.0,
                host_confidence=1.0, rotation_similar=-1.0)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jax, its front doors (Pallas in interpret mode on
    the CPU) and its register_batch."""
    jax = pytest.importorskip("jax")
    from psulvsb_tpu.ops.pallas_gnc import gnc_batch
    from psulvsb_tpu.ops.pallas_hist import exact_peak_bin
    from psulvsb_tpu.parallel.pairs import register_batch as jregister_batch
    from psulvsb_tpu.solver import config

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, gnc_batch=gnc_batch,
                                 exact_peak_bin=exact_peak_bin, register_batch=jregister_batch,
                                 SolverParams=config.SolverParams,
                                 Mode=config.InlierSelectionMode)


def _pair(rate, c, data_seed, cloud_seed=None, **kw):
    return make_synthetic_pair(np.random.default_rng(data_seed),
                               synthetic_cloud(c, seed=data_seed if cloud_seed is None
                                               else cloud_seed), 0.05 if not kw else 0.01,
                               rate, **kw)


def _batch(name):
    """(params, pairs, solve seeds, keep) of a batch the plain version runs."""
    if name == "round1_and_lazy_seed":
        # A pair without outliers stops after round 1; at 97% outliers (data
        # seed 5, solve seed 3) the first escalation fires the lazy seed.
        pairs = [_pair(0.0, 300, 4), _pair(0.97, 300, 5), _pair(0.9, 300, 6)]
        return SolverParams.preset_artificial(clique_init="auto", **CAPS), pairs, [0, 3, 1], None
    if name == "estimated_scale":
        pairs = [_pair(0.7, 200, s, outlier_mode="mismatch", test_scale=1.0 + 1.5 * s)
                 for s in range(3)]
        return SolverParams.preset_3dmatch(estimate_scaling=True, **CAPS), pairs, [0, 1, 2], None
    if name == "eager_seed":
        pairs = [_pair(0.9, 200, s) for s in (1, 2, 3)]
        return SolverParams.preset_artificial(clique_init="eager", **CAPS), pairs, [0, 1, 2], None
    if name == "padding_pair":
        pairs = [_pair(0.5, 200, s) for s in (7, 8, 9)]
        keep = np.ones((3, 200), np.int64)
        keep[1] = -2
        return SolverParams.preset_artificial(**CAPS), pairs, [4, 5, 6], keep
    known = [_pair(0.9, 200, s) for s in (1, 2, 3)]
    if name == "gror":
        return (SolverParams.preset_artificial_gror(gror_k_optimal=150, **CAPS), known,
                [0, 1, 2], None)
    if name in ("exact_beta", "sampled"):
        return (SolverParams.preset_anchor(init_mode=name, **SMALL_FILL, **CAPS), known,
                [0, 1, 2], None)
    if name == "exact_hist":
        pairs = [_pair(0.7, 200, s, outlier_mode="mismatch", test_scale=1.0 + 1.5 * s)
                 for s in range(3)]
        return (SolverParams.preset_3dmatch(estimate_scaling=True, init_mode="exact_hist",
                                            **SMALL_FILL, **CAPS), pairs, [0, 1, 2], None)
    if name == "fgr":
        return (SolverParams.preset_anchor(
            rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR, **CAPS),
            [_pair(0.5, 200, s) for s in (1, 2, 3)], [0, 1, 2], None)
    if name == "eigh":
        return SolverParams.preset_anchor(gnc_rot_method="eigh", **CAPS), known, [0, 1, 2], None
    if name == "wide_known":  # the card's wide path: "auto" takes exact_beta past 8192
        pairs = [_pair(0.9, 12000, s) for s in (1, 2, 3)]
        return SolverParams.preset_anchor(), pairs, [0, 1, 2], None
    assert name == "exact_clique"
    return (SolverParams.preset_artificial(exact_clique_callback=True, **STAGNATE, **CAPS),
            known, [0, 1, 2], None)


def _stack(pairs, keep):
    src = torch.as_tensor(np.stack([np.asarray(p.src, np.float32) for p in pairs]))
    dst = torch.as_tensor(np.stack([np.asarray(p.dst, np.float32) for p in pairs]))
    if keep is None:
        keep = np.ones((len(pairs), src.shape[2]), np.int64)
    return src, dst, torch.as_tensor(keep)


DENSE_BATCHES = ["round1_and_lazy_seed", "estimated_scale", "eager_seed", "padding_pair"]
SETTING_BATCHES = ["gror", "exact_beta", "exact_hist", "sampled", "fgr", "eigh", "exact_clique"]


@pytest.mark.parametrize("name", DENSE_BATCHES + SETTING_BATCHES)
def test_batched_plan_equals_each_pair_alone(name, monkeypatch):
    params, pairs, seeds, keep = _batch(name)
    if name == "exact_clique":  # one answer of the native search: one thread
        monkeypatch.setattr(pmc, "exact_max_clique",
                            functools.partial(pmc.exact_max_clique, n_threads=1))
    src, dst, keep = _stack(pairs, keep)
    b, _, c = src.shape
    plan = fused.plan_for(params, c, "cpu", pairs=b)
    plan.solve(src, dst, keep, [torch.Generator().manual_seed(s) for s in seeds])
    sols, stats = plan.solution(), plan.stats
    assert stats["graph_launches"] == 0 and stats["host_reads"] > 0  # the plain version
    alone_stats = []
    for i in range(b):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params, device="cpu")
        alone_stats.append(fused.plan_for(params, c, "cpu").stats)
        assert bool(sols.valid[i]) == bool(alone.valid), i
        assert int(sols.final_inlier_count[i]) == int(alone.final_inlier_count), i
        for field in ("scale", "rotation", "translation"):
            got, want = getattr(sols, field)[i], getattr(alone, field)
            assert torch.allclose(got, want, rtol=0.0, atol=TOL), (i, field, got, want)
        for key in ("rounds", "local_batches", "seeded"):
            assert stats[key][i] == alone_stats[i][key], (i, key)
    if name == "round1_and_lazy_seed":
        assert alone_stats[0]["rounds"] == 1 and alone_stats[1]["rounds"] > 1
        assert alone_stats[1]["seeded"] and not alone_stats[0]["seeded"]
    if name == "padding_pair":
        assert not bool(sols.valid[1]) and int(sols.final_inlier_count[1]) == 0
        assert bool(sols.valid[0]) and bool(sols.valid[2])
    if name == "exact_clique":  # the round ran: 4 hypotheses a pair, 3 pairs, 2 rounds
        assert stats["exact_clique_searches"] == sum(s["exact_clique_searches"]
                                                     for s in alone_stats) > 0


def test_register_batch_pads_a_short_chunk_and_drops_the_padding(monkeypatch):
    """Five pairs in chunks of two: the last chunk's padding-only pair is
    solved and dropped; each row is its pair's solve alone."""
    from psulvsb_tpu_torch.parallel import pairs as pairs_mod

    params, pairs, seeds, _ = _batch("eager_seed")
    pairs, seeds = pairs + [_pair(0.8, 200, 11), _pair(0.8, 200, 12)], seeds + [7, 8]
    src, dst, keep = _stack(pairs, None)
    monkeypatch.setattr(pairs_mod, "pairs_per_chunk", lambda *args: 2)
    sols = register_batch(src, dst, keep, seeds, params, vectorized=True, device="cpu")
    plan = fused.plan_for(params, src.shape[2], "cpu", pairs=2)
    assert plan.solves >= 3
    for i in range(5):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params, device="cpu")
        assert int(sols.final_inlier_count[i]) == int(alone.final_inlier_count), i
        assert torch.allclose(sols.rotation[i], alone.rotation, rtol=0.0, atol=TOL), i


def _gnc_pairs(rng, p, h, n):
    """P pairs of H rotation problems (30% gross outliers, about a quarter of
    the columns masked), each pair with its own warm rotation and flag."""
    def rotation():
        q = rng.normal(size=4)
        return np.asarray(_quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))), np.float32)

    rots = np.stack([rotation() for _ in range(p)])
    src = rng.normal(size=(p, h, 3, n)).astype(np.float32)
    dst = np.einsum("pij,phjn->phin", rots, src).astype(np.float32)
    dst += rng.uniform(-0.01, 0.01, size=dst.shape).astype(np.float32)
    k = int(0.3 * n)
    dst[..., :k] += rng.normal(size=(p, h, 3, k)).astype(np.float32) * 2.0
    act = rng.uniform(size=(p, h, n)) >= 0.25
    nb = np.full((p, h), 0.1, np.float32)
    use_warm = np.arange(p) % 2 == 0
    warm = np.stack([rotation() if w else np.eye(3, dtype=np.float32) for w in use_warm])
    warm[use_warm] = rots[use_warm]
    return src, dst, act, nb, warm, use_warm


@pytest.mark.parametrize("p,h,n", [(3, 4, 128), (2, 3, 197)])
def test_gnc_pair_axis_matches_jax_vmap(jref, p, h, n):
    rng = np.random.default_rng(100 * p + n)
    src, dst, act, nb, warm, use_warm = _gnc_pairs(rng, p, h, n)
    jnp = jref.jnp
    rj, ij = jref.jax.vmap(lambda *a: jref.gnc_batch(*a, **LOOP))(
        *(jnp.asarray(x) for x in (src, dst, act, nb, warm, use_warm)))
    rj, ij = np.asarray(rj), np.asarray(ij)
    t = [torch.as_tensor(x) for x in (src, dst, act, nb, warm, use_warm)]
    flat = [x.flatten(0, 1) for x in t[:4]]
    rt, it = gnc.gnc_batch(*flat, t[4], t[5], **LOOP)  # the pair axis: one call
    rv, iv = torch.func.vmap(lambda *a: gnc.gnc_batch(*a, **LOOP))(*t)  # the operator's vmap rule
    assert torch.equal(rv.flatten(0, 1), rt) and torch.equal(iv.flatten(0, 1), it)
    rt, it = rt.unflatten(0, (p, h)).numpy(), it.unflatten(0, (p, h)).numpy()
    np.testing.assert_allclose(rt, rj, atol=ROT_TOL)
    assert ((it == ij) | ~act).sum() / act.size >= MASK_AGREE
    assert not (it & ~act).any()
    for q in range(p):  # each pair as its own call: its warm rotation and flag
        rq, iq = gnc.gnc_batch(*(x[q] for x in t[:4]), t[4][q], bool(use_warm[q]), **LOOP)
        assert torch.equal(rq, torch.as_tensor(rt[q])) and torch.equal(iq, torch.as_tensor(it[q]))


def _peak_pairs(p, c):
    pairs = [make_synthetic_pair(np.random.default_rng(30 + q), synthetic_cloud(c, seed=30 + q),
                                 0.01, 0.8, outlier_mode="mismatch", test_scale=1.0 + 0.7 * q)
             for q in range(p)]
    src = np.stack([np.asarray(x.src, np.float32) for x in pairs])
    dst = np.stack([np.asarray(x.dst, np.float32) for x in pairs])
    act = np.random.default_rng(c).uniform(size=(p, c)) >= 0.2
    return src, dst, act


@pytest.mark.parametrize("p,c", [(3, 300), (2, 97)])
def test_exact_peak_bin_pair_axis_matches_jax_vmap(jref, p, c):
    src, dst, act = _peak_pairs(p, c)
    jnp = jref.jnp
    want = jref.jax.vmap(jref.exact_peak_bin)(*(jnp.asarray(x) for x in (src, dst, act)))
    want = [np.asarray(x).astype(np.int64).tolist() for x in want]
    t = [torch.as_tensor(x) for x in (src, dst, act)]
    got = [x.to(torch.int64).tolist() for x in hist.exact_peak_bin(*t)]
    via_vmap = [x.to(torch.int64).tolist() for x in torch.func.vmap(hist.exact_peak_bin)(*t)]
    alone = [[int(hist.exact_peak_bin(t[0][q], t[1][q], t[2][q])[k]) for q in range(p)]
             for k in range(3)]
    assert got == want == via_vmap == alone
    # The plain histogram with the pair axis: each row its pair's own.
    full = hist.pair_ratio_histogram_reference(*t, num_bins=512)
    for q in range(p):
        assert torch.equal(full[q], hist.pair_ratio_histogram_reference(
            t[0][q], t[1][q], t[2][q], num_bins=512))


N_PAIRS = 8
C = 256


def test_batched_recall_and_quantiles_match_jax_vmap(jref):
    """Eight pairs (C = 256, 90% displaced outliers, the lazy seed on)
    through JAX's `register_batch(vectorized=True)` (jax.vmap of the fused
    solve) and the port's batched form: the port's recall at least JAX's
    minus one pair, and its median and 90% quantiles of RE and TE at most
    twice JAX's plus a floor (0.5 deg, 0.01)."""
    jax, jnp = jref.jax, jref.jnp
    jparams = jref.SolverParams.preset_artificial(sampled_cap=512, basic_cap=128,
                                                  hypothesis_batch=4)
    params = params_from_jax(jparams)
    pairs = [make_synthetic_pair(np.random.default_rng(60 + k), synthetic_cloud(C, seed=80 + k),
                                 0.05, 0.9) for k in range(N_PAIRS)]
    src = np.stack([np.asarray(p.src, np.float32) for p in pairs])
    dst = np.stack([np.asarray(p.dst, np.float32) for p in pairs])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(N_PAIRS))
    sol_j = jref.register_batch(jnp.asarray(src), jnp.asarray(dst),
                                jnp.ones((N_PAIRS, C), jnp.int32), keys, jparams, vectorized=True)
    sol_t = register_batch(src, dst, np.ones((N_PAIRS, C), np.int64), list(range(N_PAIRS)),
                           params, vectorized=True, device="cpu")
    errs = {"jax": [], "port": []}
    for name, sol in (("jax", sol_j), ("port", sol_t)):
        for k, pair in enumerate(pairs):
            rot = np.asarray(sol.rotation[k], np.float64)
            re = angular_error_deg_np(pair.transform.rotation, rot)
            te = float(np.linalg.norm(np.asarray(sol.translation[k], np.float64)
                                      - pair.transform.translation))
            errs[name].append((bool(sol.valid[k]), re, te))
    ok = {name: [v and re < 5.0 and te < 0.3 for v, re, te in e] for name, e in errs.items()}
    assert sum(ok["port"]) >= sum(ok["jax"]) - 1, errs
    assert sum(ok["port"]) >= N_PAIRS - 1, errs
    for col, floor in ((1, 0.5), (2, 0.01)):
        for q in (0.5, 0.9):
            port_q = np.quantile([e[col] for e in errs["port"]], q)
            jax_q = np.quantile([e[col] for e in errs["jax"]], q)
            assert port_q <= 2.0 * jax_q + floor, (col, q, port_q, jax_q)


JAX_SETTINGS = {
    # GROR at its preset (K capped by C) and the known-scale exact count of
    # the large-C init, asked for at C = 200 with a cut fill budget.
    "gror": lambda cfg: cfg.SolverParams.preset_artificial_gror(
        sampled_cap=512, basic_cap=128, hypothesis_batch=4),
    "exact_beta": lambda cfg: cfg.SolverParams.preset_artificial(
        init_mode="exact_beta", init_reject_budget=1 << 16, sampled_cap=512, basic_cap=128,
        hypothesis_batch=4, clique_init="off", inlier_selection_mode=cfg.InlierSelectionMode.NONE),
}
N_SETTING_PAIRS = 4
C_SETTING = 200


@pytest.mark.parametrize("name", list(JAX_SETTINGS))
def test_batched_settings_match_jax_vmap(jref, name):
    """Four pairs (C = 200, 90% displaced outliers) of GROR and of the
    `exact_beta` init through JAX's `register_batch(vectorized=True)` and
    the port's batched form, at the bounds of
    test_batched_recall_and_quantiles_match_jax_vmap: recall within one
    pair, the RE/TE quantiles at most twice JAX's plus the floor."""
    jax, jnp = jref.jax, jref.jnp
    from psulvsb_tpu.solver import config as jconfig

    jparams = JAX_SETTINGS[name](jconfig)
    params = params_from_jax(jparams)
    b, c = N_SETTING_PAIRS, C_SETTING
    pairs = [make_synthetic_pair(np.random.default_rng(90 + k), synthetic_cloud(c, seed=95 + k),
                                 0.05, 0.9) for k in range(b)]
    src = np.stack([np.asarray(p.src, np.float32) for p in pairs])
    dst = np.stack([np.asarray(p.dst, np.float32) for p in pairs])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    sol_j = jref.register_batch(jnp.asarray(src), jnp.asarray(dst), jnp.ones((b, c), jnp.int32),
                                keys, jparams, vectorized=True)
    sol_t = register_batch(src, dst, np.ones((b, c), np.int64), list(range(b)), params,
                           vectorized=True, device="cpu")
    errs = {"jax": [], "port": []}
    for label, sol in (("jax", sol_j), ("port", sol_t)):
        for k, pair in enumerate(pairs):
            rot = np.asarray(sol.rotation[k], np.float64)
            re = angular_error_deg_np(pair.transform.rotation, rot)
            te = float(np.linalg.norm(np.asarray(sol.translation[k], np.float64)
                                      - pair.transform.translation))
            errs[label].append((bool(sol.valid[k]), re, te))
    ok = {label: [v and re < 5.0 and te < 0.3 for v, re, te in e] for label, e in errs.items()}
    assert sum(ok["port"]) >= sum(ok["jax"]) - 1, errs
    for col, floor in ((1, 0.5), (2, 0.01)):
        for q in (0.5, 0.9):
            port_q = np.quantile([e[col] for e in errs["port"]], q)
            jax_q = np.quantile([e[col] for e in errs["jax"]], q)
            assert port_q <= 2.0 * jax_q + floor, (col, q, port_q, jax_q)


CAPS_3DMATCH = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)
ROUTES = {
    # Every setting builds its batched plan: bench.py's anchor and artificial
    # presets, the 3DMatch sweep's buckets with the lazy and eager seeds, at
    # known and estimated scale, the translation rescue, GROR, the large-C
    # inits, FGR, "eigh" and the exact clique callback. The third entry is
    # the init route, the fourth whether the plan holds a (C, C) body.
    "anchor": (SolverParams.preset_anchor(), 1889, "dense", True),
    "artificial_lazy": (SolverParams.preset_artificial(**CAPS_3DMATCH), 1889, "dense", True),
    "3dmatch_4096": (SolverParams.preset_3dmatch(**CAPS_3DMATCH), 4096, "dense", True),
    "3dmatch_6144_eager": (SolverParams.preset_3dmatch(clique_init="eager", **CAPS_3DMATCH),
                           6144, "dense", True),
    "3dmatch_8192_estimated": (SolverParams.preset_3dmatch(estimate_scaling=True,
                                                           **CAPS_3DMATCH), 8192, "dense", True),
    "unknown_5000": (SolverParams.preset_3dmatch(
        estimate_scaling=True, clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE,
        **CAPS_3DMATCH), 5000, "dense", True),
    "rescue": (SolverParams.preset_artificial(translation_rescue=True), 1889, "dense", True),
    "gror": (SolverParams.preset_artificial_gror(**CAPS_3DMATCH), 1889, "dense", True),
    "beyond_dense_known": (SolverParams.preset_anchor(), 12000, "exact_beta", False),
    "beyond_dense_estimated": (SolverParams.preset_3dmatch(estimate_scaling=True), 12000,
                               "exact_hist", True),
    "exact_hist": (SolverParams.preset_3dmatch(estimate_scaling=True, init_mode="exact_hist"),
                   1889, "exact_hist", True),
    "exact_beta": (SolverParams.preset_anchor(init_mode="exact_beta"), 1889, "exact_beta",
                   False),
    "sampled": (SolverParams.preset_anchor(init_mode="sampled"), 1889, "sampled", False),
    "fgr": (SolverParams.preset_anchor(
        rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR), 1889, "dense", True),
    "eigh": (SolverParams.preset_anchor(gnc_rot_method="eigh"), 1889, "dense", True),
    "exact_clique": (SolverParams.preset_artificial(exact_clique_callback=True), 1889, "dense",
                     True),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_of_each_setting(name):
    """Every setting builds its batched plan (`ReplayPlan(pairs=2)` on the
    CPU): every per-pair buffer has the pair axis, the draws' layout takes
    the setting's init route, and `plan_bytes` counts a (C, C) body where
    the route holds one, twice over for two pairs."""
    params, c, route, square = ROUTES[name]
    plan = fused.ReplayPlan(params, c, torch.device("cpu"), graphs=False, pairs=2)
    assert plan.pairs == 2 and not plan.graphs
    assert init_route(params, c) == plan.layout.route == route
    assert plan.bufs["src"].shape == (2, 3, c) and plan.bufs["keep"].shape == (2, c)
    assert plan.bufs["draws"].shape == (2, plan.layout.size)
    assert plan.exact_clique == (name == "exact_clique")
    one = fused.plan_bytes(params, c)
    assert fused.plan_bytes(params, c, 2) == 2 * one
    assert (one >= fused.PLAN_BYTES_PER_C2 * c * c) == square
    with pytest.raises(ValueError, match="pairs >= 1"):
        fused.ReplayPlan(params, c, torch.device("cpu"), graphs=False, pairs=0)


def test_in_flight_settings_keep_their_form_in_register_batch():
    """GROR, which the in-flight form once took under vectorized=True, runs
    the batched plan (each pair within TOL of its solve alone); the
    in-flight form, kept to compare with (`_register_in_flight`), gives each
    pair exactly its solve alone. `vectorized` is a bool."""
    from psulvsb_tpu_torch.parallel.pairs import _register_in_flight

    params = SolverParams.preset_artificial_gror(gror_k_optimal=150, **CAPS)
    pairs = [_pair(0.9, 200, s) for s in (1, 2)]
    src, dst, keep = _stack(pairs, None)
    sols = register_batch(src, dst, keep, [0, 1], params, vectorized=True, device="cpu")
    assert fused.plan_for(params, 200, "cpu", pairs=2).solves >= 1
    flight = _register_in_flight(src, dst, keep, [0, 1], params, device="cpu")
    for i in range(2):
        alone = psulvsb_register(src[i], dst[i], keep[i], i, params, device="cpu")
        assert all(torch.equal(got[i], want) for got, want in zip(flight, alone))
        assert int(sols.final_inlier_count[i]) == int(alone.final_inlier_count)
        assert torch.allclose(sols.rotation[i], alone.rotation, rtol=0.0, atol=TOL)
    for bad in ("vmap", "in_flight"):
        with pytest.raises(ValueError, match="vectorized"):
            register_batch(src, dst, keep, [0, 1], params, vectorized=bad, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSE_BATCHES + ["gror", "wide_known"])
def test_cuda_batched_graph_equals_each_pair_alone(name):
    """On the card: one graph launch for the batch, each pair within 1e-4
    of its solve alone, valid and counts equal, and one launch of the
    init's kernel for the pairs (the dense init's; GROR: the degree
    kernel's; the wide known-scale batch at C = 12000: the beta count's),
    counted on the device, which a graph does in traced plans, so tracing
    is on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from psulvsb_tpu_torch.utils import timing

    timing.enable(True)
    try:
        _batched_graph_equals_each_pair_alone(name)
    finally:
        timing.enable(False)
        fused.clear_plan_cache()


def _batched_graph_equals_each_pair_alone(name):
    params, pairs, seeds, keep = _batch(name)
    src, dst, keep = (x.cuda() for x in _stack(pairs, keep))
    plan = fused.plan_for(params, src.shape[2], "cuda", pairs=src.shape[0])
    plan.solve(src, dst, keep, [torch.Generator("cuda").manual_seed(s) for s in seeds])
    sols = plan.solution()
    assert plan.stats["graph_launches"] == 1 and plan.stats["host_reads"] == 0
    kernel = {"gror": "consistency_degree", "wide_known": "pair_beta_count"}.get(name, "dense_init")
    before = LAUNCHES[kernel]
    plan.solve(src, dst, keep, [torch.Generator("cuda").manual_seed(s) for s in seeds])
    assert plan.stats["graph_launches"] == 1
    assert LAUNCHES[kernel] == before + 1
    for i in range(src.shape[0]):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params)
        assert bool(sols.valid[i]) == bool(alone.valid)
        assert int(sols.final_inlier_count[i]) == int(alone.final_inlier_count)
        for field in ("scale", "rotation", "translation"):
            assert torch.allclose(getattr(sols, field)[i], getattr(alone, field), rtol=0.0,
                                  atol=1e-4), (i, field)


def test_plan_cache_makes_room_by_bytes(monkeypatch):
    """A new plan of the dense init first drops the cached plans of its
    card, least recently used first, until the card has the plan's estimated
    bytes free; the plans of another card stay. The card's calls are stood
    in for here: a dropped plan gives its bytes back."""
    from collections import OrderedDict

    here, there = torch.device("cuda", 0), torch.device("cuda", 1)
    free, released = [10], []

    class Cached:
        def __init__(self, name, nbytes):
            self.name, self.nbytes = name, nbytes

        def release(self):
            released.append(self.name)
            free[0] += self.nbytes

    plans = OrderedDict(((n, 0, d), Cached(n, b)) for n, d, b in
                        [("a", here, 20), ("b", there, 50), ("c", here, 10), ("d", here, 40)])
    monkeypatch.setattr(fused, "_PLANS", plans)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free[0], 100))
    fused._make_room(here, 35)
    assert released == ["a", "c"] and free[0] == 40
    assert [k[0] for k in plans] == ["b", "d"]
    fused._make_room(here, 40)  # fits already
    assert released == ["a", "c"]
    fused._make_room(here, 1000)  # more than the card has: every plan of it goes
    assert released == ["a", "c", "d"] and [k[0] for k in plans] == ["b"]


@pytest.mark.cuda
def test_cuda_sweep_buckets_in_one_process():
    """register_batch(vectorized=True) at B = 8 over the sweep's 4096, 6144
    and 8192 buckets (the 3DMatch protocol at known scale, clique "auto")
    one after another, every plan left in the cache: their batched plans
    measured 11.9, 26.6 and 23.6 GiB on an 80 GB card, so the later ones fit
    only where plan_for makes room. Two pairs a bucket against their solve
    alone (valid and counts equal, R and t within 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    params = SolverParams.preset_3dmatch(sampled_cap=2048, basic_cap=256, hypothesis_batch=4,
                                         estimate_scaling=False)
    for bucket, n in ((4096, 3500), (6144, 5000), (8192, 6500)):
        pairs = [_pair(0.85, n, 200 + i, outlier_mode="mismatch") for i in range(8)]
        src, dst, _ = _stack(pairs, None)
        pad = torch.zeros((8, 3, bucket - n))
        src, dst = torch.cat([src, pad], 2).cuda(), torch.cat([dst, pad], 2).cuda()
        keep = torch.ones((8, bucket), dtype=torch.int64, device="cuda")
        keep[:, n:] = -2
        sols = register_batch(src, dst, keep, list(range(8)), params, vectorized=True)
        for i in (0, 7):
            alone = psulvsb_register(src[i], dst[i], keep[i], i, params)
            assert bool(sols.valid[i]) == bool(alone.valid), (bucket, i)
            assert int(sols.final_inlier_count[i]) == int(alone.final_inlier_count), (bucket, i)
            for field in ("rotation", "translation"):
                assert torch.allclose(getattr(sols, field)[i], getattr(alone, field), rtol=0.0,
                                      atol=1e-4), (bucket, i, field)
