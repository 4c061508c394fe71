"""Each stage of the port's solver against the JAX stage, from the same input
state and with the JAX stage's own random draws.

A JAX chain (init -> sample -> local -> host -> self-update, three rounds,
then finalize) runs once per configuration on a small pair, at known scale
(the artificial preset, displaced outliers) or at estimated scale (the
3DMatch preset, mismatch outliers, the target stretched by 2.7); every
port stage then gets the JAX stage's inputs through `convert.py` and the
draws the JAX stage made from its key (hash constants, pair draws, Gumbel
keys, the scale consensus's uniforms, uniforms).

Tolerances: `red_count` within 0.1% and reduced pools as sets with Jaccard
>= 0.999 (the distance matrices come from float32 matmuls summed in another
order, so a pair at the window's edge may flip); the sample stage and the
self-update exactly; the local stage equal counts and flags with the
rotation within 1e-4 and the scale within 1e-5 relative; the host stage equal masks and counts with pro_host
within 1e-6; the finalize stage within 1e-4. The port's solve returns the
count of the pose it returns, where the JAX package returns the host best's
(its final_inlier_count is hs.best_count); the port keeps that one in
hs.best_count, held equal to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.solver import psulvsb as jps
from psulvsb_tpu.solver.config import InlierSelectionMode, SolverParams as JParams
from psulvsb_tpu_torch.convert import host_state_from_numpy, params_from_jax, warm_state_from_numpy
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.solver import psulvsb as tps

C = 300
F32 = jnp.float32


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _local_draws(key, max_batches, batch, cap, draws):
    """The draws JAX's _local_stage makes batch by batch: the Gumbel keys
    that pick each hypothesis' basic set and the uniforms of its 1-point
    scale consensus (jax.random.choice's, from the hypothesis' scale key)."""
    gumbels, uniforms = [], []
    for _ in range(max_batches):
        key, sub = jax.random.split(key)
        ks = [jax.random.split(hk) for hk in jax.random.split(sub, batch)]
        gumbels.append([jax.random.gumbel(k[0], (cap,), F32) for k in ks])
        uniforms.append([jax.random.uniform(k[1], (draws,), F32) for k in ks])
    return np.asarray(gumbels), np.asarray(uniforms)


def _params(basic_cap=64, pool_cap=16384, scaled=False):
    kw = dict(
        sampled_cap=512, basic_cap=basic_cap, hypothesis_batch=4, pool_cap=pool_cap,
        clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE,
    )
    if scaled:
        return JParams.preset_3dmatch(estimate_scaling=True, **kw)
    return JParams.preset_artificial(**kw)


@functools.lru_cache(maxsize=None)
def _jax_chain(basic_cap=64, pool_cap=16384, scaled=False):
    """Run the JAX stages for three host rounds and keep every input, output
    and draw."""
    params = _params(basic_cap, pool_cap, scaled)
    src = synthetic_cloud(C, seed=3)
    if scaled:
        pair = make_synthetic_pair(
            np.random.default_rng(5), src, 0.01, 0.7, outlier_mode="mismatch", test_scale=2.7
        )
    else:
        pair = make_synthetic_pair(np.random.default_rng(5), src, 0.05, 0.9)
    keep = np.ones(C, np.int32)
    keep[np.random.default_rng(6).permutation(C)[: C // 5]] = 0  # re-admittable
    sj, dj, kj = jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(keep)
    out = {"params": params, "src": pair.src, "dst": pair.dst, "keep": keep}

    k_init = jax.random.PRNGKey(11)
    k_peak, k_hash = jax.random.split(k_init)
    out["ab"] = np.asarray(jax.random.randint(k_hash, (2,), 1, jnp.iinfo(jnp.int32).max))
    out["peak_pairs"] = _np_tree(jps._draw_pairs(k_peak, params.init_peak_sample, C))
    red = jps._init_stage(sj, dj, kj, params, k_init)
    out["init"] = _np_tree(red)
    red_i, red_j, red_count, pool = red
    n_red = int(np.sum(keep == 1))
    thr = jnp.asarray(params.pr_noise * (1.0 + n_red / C), F32)
    out["thr"] = np.asarray(thr)

    hs = jps.HostState.initial(C, kj, F32)
    warm = jps.WarmState.initial(F32)
    factor = params.local_batch_ceiling_factor
    max_batches = max(2, -(-factor * params.local_max_iter // params.hypothesis_batch) + 1)
    rounds = []
    for r, (l_rate, b_rate) in enumerate([(0.1, 0.3), (0.2, 0.3), (1.0, 1.0)]):
        k_samp, k_local, k_host = jax.random.split(jax.random.PRNGKey(100 + r), 3)
        rec = {"l_rate": l_rate, "b_rate": b_rate, "hs_in": _np_tree(hs),
               "warm_in": _np_tree(warm)}
        rec["gumbel"] = np.asarray(jax.random.gumbel(k_samp, (red_i.shape[0],), F32))
        samp = jps._sample_stage(
            red_i, red_j, red_count, pool, jnp.asarray(l_rate, F32), params, k_samp,
            num_points=C,
        )
        rec["sample"] = _np_tree(samp)
        s_i, s_j, s_ok, s_count, s_pts = samp
        b_one = b_rate >= 1.0
        rec["gumbels"], rec["scale_us"] = _local_draws(
            k_local, max_batches, params.hypothesis_batch, s_i.shape[0], params.scale_max_draws
        )
        local = jps._local_stage(
            sj, dj, s_i, s_j, s_ok, s_count, s_pts, jnp.asarray(b_rate, F32),
            jnp.asarray(b_one), hs.host_r, warm, thr, params, k_local,
        )
        rec["local"] = _np_tree(local)
        rec["u"] = np.asarray(jax.random.uniform(k_host, (C,), F32))
        hs, new_corr, take = jps._host_stage(
            sj, dj, hs, local.best, local.local_r, jnp.asarray(b_one), thr, params, k_host
        )
        rec["host"] = _np_tree((hs, new_corr, take))
        rec["self_update"] = _np_tree(
            jps._self_update_pairs(red_i, red_j, red_count, pool, new_corr, hs.inl_kept, params)
        )
        warm = jps.WarmState(hs.best.scale, hs.best.rotation, hs.best.translation,
                             jnp.zeros((), bool))
        rounds.append(rec)
    out["rounds"] = rounds
    out["finalize"] = _np_tree(
        jps._finalize_stage(sj, dj, hs, rounds[-1]["local"].best, params)
    )
    out["hs_final"] = _np_tree(hs)
    return out


def _pairs(red_i, red_j, pool):
    n = int(pool)
    return set(zip(np.asarray(red_i)[:n].tolist(), np.asarray(red_j)[:n].tolist()))


@pytest.mark.parametrize("pool_cap", [16384, 512])
def test_init_stage_dense(pool_cap):
    ch = _jax_chain(pool_cap=pool_cap)
    red_i, red_j, red_count, pool = tps._init_stage_dense(
        _t(ch["src"]), _t(ch["dst"]), _t(ch["keep"]), params_from_jax(ch["params"]),
        ab=_t(ch["ab"]),
    )
    j_i, j_j, j_count, j_pool = ch["init"]
    assert abs(int(red_count) - int(j_count)) <= 1e-3 * int(j_count)
    assert abs(int(pool) - int(j_pool)) <= 1e-3 * int(j_pool)
    a, b = _pairs(red_i, red_j, pool), _pairs(j_i, j_j, j_pool)
    assert len(a & b) / len(a | b) >= 0.999
    assert all(i < j for i, j in a)
    assert red_i.shape[0] == j_i.shape[0]


@pytest.mark.parametrize("round_idx", [0, 1, 2])
def test_sample_stage(round_idx):
    ch = _jax_chain()
    rec = ch["rounds"][round_idx]
    j_i, j_j, j_count, j_pool = ch["init"]
    got = tps._sample_stage(
        _t(j_i, torch.int64), _t(j_j, torch.int64), _t(j_count, torch.int64),
        _t(j_pool, torch.int64), rec["l_rate"], params_from_jax(ch["params"]), C,
        gumbel=_t(rec["gumbel"]),
    )
    for g, w in zip(got, rec["sample"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_local_stage(ch, round_idx):
    rec = ch["rounds"][round_idx]
    s_i, s_j, s_ok, s_count, s_pts = rec["sample"]
    hs_in = host_state_from_numpy(rec["hs_in"], "cpu")
    got = tps._local_stage(
        _t(ch["src"]), _t(ch["dst"]), _t(s_i, torch.int64), _t(s_j, torch.int64),
        _t(s_ok), _t(s_count, torch.int64), _t(s_pts), rec["b_rate"],
        rec["b_rate"] >= 1.0, hs_in.host_r, warm_state_from_numpy(rec["warm_in"]),
        _t(ch["thr"]), params_from_jax(ch["params"]), gumbels=_t(rec["gumbels"]),
        scale_us=_t(rec["scale_us"]),
    )
    want = rec["local"]
    assert int(got.best_count) == int(want.best_count)
    assert int(got.local_r) == int(want.local_r)
    assert bool(got.escalate) == bool(want.escalate)
    assert got.iterations == int(want.iterations)
    assert int(got.hypotheses) == int(want.hypotheses)
    np.testing.assert_allclose(got.best.rotation.numpy(), want.best.rotation, atol=1e-4)
    np.testing.assert_allclose(got.best.translation.numpy(), want.best.translation, atol=1e-4)
    assert abs(float(got.pro_local) - float(want.pro_local)) <= 1e-6
    np.testing.assert_allclose(float(got.best.scale), float(want.best.scale), rtol=1e-5)
    if bool(want.extras_valid):
        np.testing.assert_array_equal(got.extras.b_i.numpy(), want.extras.b_i)
        np.testing.assert_array_equal(
            got.extras.scale_inliers.numpy(), want.extras.scale_inliers
        )
        np.testing.assert_array_equal(
            got.extras.translation_points.numpy(), want.extras.translation_points
        )


@pytest.mark.parametrize("basic_cap", [64, 256])  # endpoint and full-C translation
@pytest.mark.parametrize("round_idx", [0, 1, 2])  # cold; warm over 2 batches; b_rate = 1
def test_local_stage(basic_cap, round_idx):
    _check_local_stage(_jax_chain(basic_cap=basic_cap), round_idx)


@pytest.mark.parametrize("basic_cap", [64, 256])
@pytest.mark.parametrize("round_idx", [0, 1, 2])
def test_local_stage_estimated_scale(basic_cap, round_idx):
    """The scale branch: 1-point consensus per hypothesis with the warm
    scale after the first scoring, rotation on the scale inliers, the
    de-scaled TIMs and widened noise bound into the GNC kernel."""
    ch = _jax_chain(basic_cap=basic_cap, scaled=True)
    _check_local_stage(ch, round_idx)
    assert abs(float(ch["rounds"][round_idx]["local"].best.scale) - 2.7) < 0.05


def test_init_stage_dense_estimated_scale():
    """The dense init's scale branch: the peak from exact_peak_bin, or the
    subsample peak over JAX's pair draws (the JAX stage on the CPU takes
    the subsample peak)."""
    ch = _jax_chain(scaled=True)
    params = params_from_jax(ch["params"])
    assert tps.init_route(params, ch["src"].shape[1]) == "dense"
    red_i, red_j, red_count, pool = tps._init_stage(
        _t(ch["src"]), _t(ch["dst"]), _t(ch["keep"]), params,
        draws=tps.InitDraws(ab=_t(ch["ab"]),
                            peak_pairs=tuple(_t(x, torch.int64) for x in ch["peak_pairs"])),
    )
    j_i, j_j, j_count, j_pool = ch["init"]
    assert abs(int(red_count) - int(j_count)) <= 2
    a, b = _pairs(red_i, red_j, pool), _pairs(j_i, j_j, j_pool)
    assert len(a ^ b) <= 2
    assert all(i < j for i, j in a)


@pytest.mark.parametrize("round_idx", [0, 2])
def test_host_and_finalize_carry_the_scale(round_idx):
    """The host stage scores s (R p + t) with the sampled best's scale and
    the finalize stage refits in that model, as the JAX stages do."""
    ch = _jax_chain(scaled=True)
    rec = ch["rounds"][round_idx]
    best = warm_state_from_numpy(rec["local"].best)
    hs, new_corr, take = tps._host_stage(
        _t(ch["src"]), _t(ch["dst"]), host_state_from_numpy(rec["hs_in"], "cpu"), best,
        _t(rec["local"].local_r, torch.int64), rec["b_rate"] >= 1.0, _t(ch["thr"]),
        params_from_jax(ch["params"]), u=_t(rec["u"]),
    )
    w_hs, w_new, w_take = rec["host"]
    np.testing.assert_array_equal(new_corr.numpy(), w_new)
    assert bool(take) == bool(w_take)
    assert int(hs.best_count) == int(w_hs.best_count)
    np.testing.assert_allclose(float(hs.best.scale), float(w_hs.best.scale), rtol=1e-6)
    rot, trans, better, rescued = tps._finalize_stage(
        _t(ch["src"]), _t(ch["dst"]), host_state_from_numpy(ch["hs_final"], "cpu"),
        warm_state_from_numpy(ch["rounds"][-1]["local"].best), params_from_jax(ch["params"]),
    )
    w_rot, w_trans, w_better = ch["finalize"]
    assert bool(better) == bool(w_better)
    assert not bool(rescued)  # the rescue is off in these presets
    np.testing.assert_allclose(rot.numpy(), w_rot, atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), w_trans, atol=1e-4)


@pytest.mark.parametrize("round_idx", [0, 1, 2])
def test_host_stage(round_idx):
    ch = _jax_chain()
    rec = ch["rounds"][round_idx]
    best = warm_state_from_numpy(rec["local"].best)
    hs, new_corr, take = tps._host_stage(
        _t(ch["src"]), _t(ch["dst"]), host_state_from_numpy(rec["hs_in"], "cpu"), best,
        _t(rec["local"].local_r, torch.int64), rec["b_rate"] >= 1.0, _t(ch["thr"]),
        params_from_jax(ch["params"]), u=_t(rec["u"]),
    )
    w_hs, w_new, w_take = rec["host"]
    assert new_corr.any() or round_idx > 0
    np.testing.assert_array_equal(new_corr.numpy(), w_new)
    assert bool(take) == bool(w_take)
    for name in ("inlier_counter", "inlier_history", "final_inliers", "keep_mask",
                 "active", "inl_kept", "best_count", "host_r"):
        np.testing.assert_array_equal(getattr(hs, name).numpy(), getattr(w_hs, name), name)
    assert abs(float(hs.pro_host) - float(w_hs.pro_host)) <= 1e-6
    np.testing.assert_allclose(hs.residual_history.numpy(), w_hs.residual_history, atol=1e-5)
    np.testing.assert_allclose(hs.best.rotation.numpy(), w_hs.best.rotation, atol=1e-6)


@pytest.mark.parametrize("round_idx", [0, 1, 2])
def test_self_update_pairs(round_idx):
    ch = _jax_chain()
    rec = ch["rounds"][round_idx]
    j_i, j_j, j_count, j_pool = ch["init"]
    w_hs, w_new, _ = rec["host"]
    got = tps._self_update_pairs(
        _t(j_i, torch.int64), _t(j_j, torch.int64), _t(j_count, torch.int64),
        _t(j_pool, torch.int64), _t(w_new), _t(w_hs.inl_kept),
        params_from_jax(ch["params"]),
    )
    for g, w in zip(got, rec["self_update"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_finalize_stage():
    ch = _jax_chain()
    rot, trans, better, rescued = tps._finalize_stage(
        _t(ch["src"]), _t(ch["dst"]), host_state_from_numpy(ch["hs_final"], "cpu"),
        warm_state_from_numpy(ch["rounds"][-1]["local"].best), params_from_jax(ch["params"]),
    )
    w_rot, w_trans, w_better = ch["finalize"]
    assert bool(better) == bool(w_better)
    assert not bool(rescued)  # the rescue is off in these presets
    np.testing.assert_allclose(rot.numpy(), w_rot, atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), w_trans, atol=1e-4)


@pytest.mark.parametrize("scaled", [False, True])
def test_finalize_counts_the_pose_it_returns(scaled):
    """On the JAX chain's final state the port's finalize returns the JAX
    finalize's pose and, as the solve's count, that pose's consensus by the
    host stage's rule where the refinement was kept, else the host best's
    count. The host best's count, the JAX package's final_inlier_count, is
    held to JAX's by the host-stage parity (`test_host_stage`,
    `test_host_and_finalize_carry_the_scale`)."""
    ch = _jax_chain(scaled=scaled)
    src, dst, thr = _t(ch["src"]), _t(ch["dst"]), _t(ch["thr"])
    hs = host_state_from_numpy(ch["hs_final"], "cpu")
    rot, trans, count, refined, rescued = tps._finalize_counted(
        src, dst, hs, warm_state_from_numpy(ch["rounds"][-1]["local"].best), thr,
        params_from_jax(ch["params"]),
    )
    w_rot, w_trans, w_better = ch["finalize"]
    assert bool(refined) == bool(w_better) and not bool(rescued)
    np.testing.assert_allclose(rot.numpy(), w_rot, atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), w_trans, atol=1e-4)
    res = torch.linalg.vector_norm(dst - hs.best.scale * (rot @ src + trans[:, None]), dim=0)
    want = int(((res <= thr) & (hs.keep_mask > -2)).sum())
    assert int(count) == (want if bool(refined) else int(hs.best_count))
