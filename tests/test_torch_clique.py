"""The clique stages of the port (clique/kcore.py, the clique seed and the
b_rate == 1.0 clique round of solver/psulvsb.py) against the JAX package.

Inputs are numpy pairs from seeds (C = 300: the artificial preset with 90%
displaced outliers at known scale; the 3DMatch preset with 70% mismatch
outliers and the target stretched by 2.7 at estimated scale); every port
stage gets the JAX stage's inputs and the draws the JAX stage made from its
key.

Tolerances: `triangle_scores` and `greedy_clique` exactly (0/1 products
stay exact in float32 below 2^24; ties go to the lower index on both sides),
on planted cliques and on the JAX-built consistency graph. The dense
adjacency within 0.01% flipped entries of JAX's (both take ‖a‖² + ‖b‖² -
2ab, summed in another order by the CPU BLAS; none flipped on these
inputs). The clique seed from JAX's reduced pool, on the exact graph and
on the pool-edge scatter: the same ok flag, the warm state within 1e-4. The clique round of the local stage: equal
counts and flags, the winner's clique points equal, rotation and
translation within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.clique import kcore as jk
from psulvsb_tpu.solver import psulvsb as jps
from psulvsb_tpu.solver.config import InlierSelectionMode, SolverParams as JParams
from psulvsb_tpu_torch.clique import greedy_clique, triangle_scores
from psulvsb_tpu_torch.convert import params_from_jax, warm_state_from_numpy
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.solver import psulvsb as tps

C = 300
F32 = jnp.float32
FLIP_SHARE = 1e-4


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _planted(rng, n, k, p):
    a = rng.uniform(size=(n, n)) < p
    a = np.triu(a, 1)
    a = a | a.T
    members = rng.permutation(n)[:k]
    a[np.ix_(members, members)] = True
    np.fill_diagonal(a, False)
    return a


def test_greedy_on_planted_cliques_batched():
    rng = np.random.default_rng(0)
    adj = np.stack([_planted(rng, 120, k, 0.15) for k in (12, 20, 3)])
    act = rng.uniform(size=(3, 120)) >= 0.1
    act[2] = False  # no active vertex: an empty clique
    got_s = triangle_scores(torch.as_tensor(adj), torch.as_tensor(act))
    got, reads = greedy_clique(torch.as_tensor(adj), torch.as_tensor(act), got_s, chunk=4)
    assert reads >= 1
    for b in range(3):
        a, m = jnp.asarray(adj[b]), jnp.asarray(act[b])
        s = jk.triangle_scores(a, m)
        np.testing.assert_array_equal(got_s[b].numpy(), np.asarray(s))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(jk.greedy_clique(a, m, s)))
    assert not got[2].any()
    assert int(got[1].sum()) >= 15


def _pair(scaled):
    src = synthetic_cloud(C, seed=3)
    if scaled:
        return make_synthetic_pair(
            np.random.default_rng(5), src, 0.01, 0.7, outlier_mode="mismatch", test_scale=2.7
        )
    return make_synthetic_pair(np.random.default_rng(5), src, 0.05, 0.9)


def _jparams(scaled, **kw):
    kw = dict(sampled_cap=512, basic_cap=64, hypothesis_batch=4, **kw)
    if scaled:
        return JParams.preset_3dmatch(estimate_scaling=True, **kw)
    return JParams.preset_artificial(**kw)


@functools.lru_cache(maxsize=None)
def _jax_init(scaled):
    params = _jparams(scaled)
    pair = _pair(scaled)
    keep = np.ones(C, np.int32)
    keep[np.random.default_rng(6).permutation(C)[:20]] = 0
    red = jps._init_stage(jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(keep),
                          params, jax.random.PRNGKey(11))
    return params, pair, keep, jax.tree.map(np.asarray, red)


@pytest.mark.parametrize("scaled", [False, True])
def test_dense_adjacency_and_clique_match_jax(scaled):
    params, pair, keep, (red_i, red_j, _, pool) = _jax_init(scaled)
    act = keep == 1
    want = np.asarray(jps.dense_consistency_adjacency(
        jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(red_i), jnp.asarray(red_j),
        jnp.asarray(pool), params, jnp.asarray(act),
    ))
    got = tps.dense_consistency_adjacency(
        _t(pair.src), _t(pair.dst), _t(red_i, torch.int64), _t(red_j, torch.int64),
        _t(pool, torch.int64), params_from_jax(params), _t(act),
    ).numpy()
    assert (got != want).mean() <= FLIP_SHARE
    assert want.sum() > 0
    # The greedy on the JAX-built graph: scores and clique exactly.
    s = jk.triangle_scores(jnp.asarray(want))
    w_clique = np.asarray(jk.greedy_clique(jnp.asarray(want), order_scores=s))
    t_s = triangle_scores(torch.as_tensor(want.copy()))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(s))
    t_clique, _ = greedy_clique(torch.as_tensor(want.copy()), order_scores=t_s)
    np.testing.assert_array_equal(t_clique.numpy(), w_clique)
    assert w_clique.sum() >= 4


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dense", [True, False])  # exact graph / pool-edge scatter
def test_clique_seed_stage_matches_jax(scaled, dense):
    params, pair, keep, (red_i, red_j, _, pool) = _jax_init(scaled)
    act = keep == 1
    key = jax.random.PRNGKey(21)
    warm, ok = jps._clique_seed_stage(
        jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(red_i), jnp.asarray(red_j),
        jnp.asarray(pool), params, key, jnp.asarray(act) if dense else None,
    )
    u = _t(jax.random.uniform(key, (params.scale_max_draws,), F32))
    got, t_ok, reads = tps._clique_seed_stage(
        _t(pair.src), _t(pair.dst), _t(red_i, torch.int64), _t(red_j, torch.int64),
        _t(pool, torch.int64), params_from_jax(params), _t(act) if dense else None,
        scale_u=u,
    )
    assert bool(t_ok) == bool(ok) and reads >= 1
    assert bool(ok) or not dense
    np.testing.assert_allclose(float(got.scale), float(warm.scale), rtol=1e-5)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(warm.rotation), atol=1e-4)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(warm.translation), atol=1e-4)


def _local_draws(key, max_batches, batch, cap, draws):
    """The Gumbel keys and scale uniforms JAX's _local_stage draws."""
    gumbels, uniforms = [], []
    for _ in range(max_batches):
        key, sub = jax.random.split(key)
        ks = [jax.random.split(hk) for hk in jax.random.split(sub, batch)]
        gumbels.append([jax.random.gumbel(k[0], (cap,), F32) for k in ks])
        uniforms.append([jax.random.uniform(k[1], (draws,), F32) for k in ks])
    return np.asarray(gumbels), np.asarray(uniforms)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("warm_start", [False, True])
def test_local_stage_clique_round_matches_jax(scaled, warm_start):
    """The b_rate == 1.0 round with PMC_EXACT (the greedy, no callback): each
    hypothesis' clique over its basic set's scale-inlier graph feeds the
    translation."""
    base, pair, keep, (red_i, red_j, red_count, pool) = _jax_init(scaled)
    params = base.replace(inlier_selection_mode=InlierSelectionMode.PMC_EXACT)
    sj, dj = jnp.asarray(pair.src), jnp.asarray(pair.dst)
    thr = jnp.asarray(params.pr_noise * (1.0 + int((keep == 1).sum()) / C), F32)
    k_samp, k_local = jax.random.split(jax.random.PRNGKey(7))
    samp = jps._sample_stage(
        jnp.asarray(red_i), jnp.asarray(red_j), jnp.asarray(red_count), jnp.asarray(pool),
        jnp.asarray(1.0, F32), params, k_samp, num_points=C,
    )
    s_i, s_j, s_ok, s_count, s_pts = samp
    warm = jps.WarmState.initial(F32)
    if warm_start:
        warm = jps.WarmState(
            jnp.asarray(2.7 if scaled else 1.0, F32), jnp.asarray(pair.transform.rotation, F32),
            jnp.asarray(pair.transform.translation, F32), jnp.zeros((), bool),
        )
    want = jps._local_stage(
        sj, dj, s_i, s_j, s_ok, s_count, s_pts, jnp.asarray(1.0, F32), jnp.asarray(True),
        jnp.asarray(0, jnp.int32), warm, thr, params, k_local,
    )
    max_batches = max(2, -(-params.local_batch_ceiling_factor * params.local_max_iter
                          // params.hypothesis_batch) + 1)
    gumbels, scale_us = _local_draws(
        k_local, max_batches, params.hypothesis_batch, s_i.shape[0], params.scale_max_draws
    )
    got = tps._local_stage(
        _t(pair.src), _t(pair.dst), _t(s_i, torch.int64), _t(s_j, torch.int64), _t(s_ok),
        _t(s_count, torch.int64), _t(s_pts), 1.0, True, torch.tensor(0),
        warm_state_from_numpy(jax.tree.map(np.asarray, warm)), _t(thr),
        params_from_jax(params), gumbels=_t(gumbels), scale_us=_t(scale_us),
    )
    assert int(got.best_count) == int(want.best_count)
    assert int(got.local_r) == int(want.local_r)
    assert got.iterations == int(want.iterations)
    assert bool(got.escalate) == bool(want.escalate)
    assert got.host_syncs > got.iterations  # the greedy's reads
    np.testing.assert_allclose(got.best.rotation.numpy(), want.best.rotation, atol=1e-4)
    np.testing.assert_allclose(got.best.translation.numpy(), want.best.translation, atol=1e-4)
    assert bool(got.extras_valid) == bool(want.extras_valid)
    if bool(want.extras_valid):
        w_pts = np.asarray(want.extras.translation_points)
        np.testing.assert_array_equal(got.extras.translation_points.numpy(), w_pts)
        assert w_pts.sum() >= 1 and not (w_pts & ~np.asarray(s_pts)).any()
