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
translation within 1e-4; the same with `exact_clique_callback=True`, where
both packages search each hypothesis' graph with the native branch and bound
(its graphs have at most basic_cap edges and one largest clique each on these
inputs).

Core numbers are integers: `core_numbers`, `max_kcore_mask` and the greedy on
its default (core) ordering equal JAX's exactly, and `native_core_numbers`
too; `exact_max_clique` gives cliques of equal size (which of several largest
cliques comes back is the search's own affair); `MaxCliqueSolver` gives the
JAX facade's result in its three modes. The port builds the native library
from native/maxclique.cpp with g++ into build/psulvsb_tpu_torch/.
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
from psulvsb_tpu.clique import graph as jgraph, pmc as jpmc
from psulvsb_tpu_torch.clique import (
    CliqueSolverMode,
    Graph,
    MaxCliqueSolver,
    MaxCliqueSolverParams,
    core_numbers,
    greedy_clique,
    max_clique_mask,
    max_kcore_mask,
    pmc,
    triangle_scores,
)
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


def _check_clique_round(scaled, warm_start, exact):
    base, pair, keep, (red_i, red_j, red_count, pool) = _jax_init(scaled)
    params = base.replace(
        inlier_selection_mode=InlierSelectionMode.PMC_EXACT, exact_clique_callback=exact
    )
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
    if not exact:
        assert int(got.best_count) == int(want.best_count)
    assert int(got.local_r) == int(want.local_r)
    assert got.iterations == int(want.iterations)
    assert bool(got.escalate) == bool(want.escalate)
    assert got.host_syncs > got.iterations  # the greedy's reads, or the exact search's
    np.testing.assert_allclose(got.best.rotation.numpy(), want.best.rotation, atol=1e-4)
    assert bool(got.extras_valid) == bool(want.extras_valid)
    w_pts = np.asarray(want.extras.translation_points)
    g_pts = got.extras.translation_points.numpy()
    if exact:
        # A graph of at most basic_cap edges holds several largest cliques,
        # and which one the 12-thread search returns is not fixed (in either
        # package): the winner's clique has JAX's size and lies in the
        # sampled points; the translation follows the members it got.
        assert g_pts.sum() == w_pts.sum() >= 1
        # (An edgeless graph's "clique" is vertex 0 in both packages, sampled or not.)
        assert g_pts.sum() < 2 or not (g_pts & ~np.asarray(s_pts)).any()
        return
    np.testing.assert_allclose(got.best.translation.numpy(), want.best.translation, atol=1e-4)
    if bool(want.extras_valid):
        np.testing.assert_array_equal(g_pts, w_pts)
        assert w_pts.sum() >= 1 and not (w_pts & ~np.asarray(s_pts)).any()



@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("warm_start", [False, True])
def test_local_stage_clique_round_matches_jax(scaled, warm_start):
    """The b_rate == 1.0 round with PMC_EXACT (the greedy, no callback): each
    hypothesis' clique over its basic set's scale-inlier graph feeds the
    translation."""
    _check_clique_round(scaled, warm_start, exact=False)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("warm_start", [False, True])
def test_local_stage_exact_clique_round_matches_jax(scaled, warm_start):
    """The same round with exact_clique_callback=True: JAX calls the native
    search through pure_callback, the port copies the batch's graphs to the
    host; the searches are counted."""
    before = pmc.EXACT_SEARCHES
    _check_clique_round(scaled, warm_start, exact=True)
    assert pmc.EXACT_SEARCHES >= before + 4  # one a hypothesis of a batch


def test_exact_clique_points_on_planted_cliques():
    """One largest clique a graph: the members come back exactly, as the
    JAX callback's host function gives them, masked by the active points."""
    rng = np.random.default_rng(1)
    adj = np.stack([_planted(rng, 90, k, 0.05) for k in (12, 9, 15)])
    act = np.ones((3, 90), bool)
    act[1, rng.permutation(90)[:10]] = False
    got = tps.exact_clique_points(torch.as_tensor(adj), torch.as_tensor(act), 60.0).numpy()
    for b in range(3):
        want = jpmc.exact_max_clique_mask(adj[b], act[b])
        np.testing.assert_array_equal(got[b], want)
        assert not (got[b] & ~act[b]).any()
    assert got[0].sum() == 12 and got[2].sum() == 15


GRAPHS = [(1, 0.5), (2, 1.0), (30, 0.2), (60, 0.5), (120, 0.1), (150, 0.7)]


def _random_graph(n, p, seed=0):
    rng = np.random.default_rng(seed + n)
    a = np.triu(rng.uniform(size=(n, n)) < p, 1)
    return a | a.T, rng.uniform(size=n) < 0.8


@pytest.mark.parametrize("n,p", GRAPHS)
@pytest.mark.parametrize("masked", [False, True])
def test_core_numbers_match_jax_and_native(n, p, masked):
    adj, act = _random_graph(n, p)
    act_j, act_t = (jnp.asarray(act), torch.as_tensor(act)) if masked else (None, None)
    want = np.asarray(jk.core_numbers(jnp.asarray(adj), act_j))
    got, reads = core_numbers(torch.as_tensor(adj), act_t, chunk=8)
    assert got.dtype == torch.int64 and reads >= 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        max_kcore_mask(torch.as_tensor(adj), act_t).numpy(),
        np.asarray(jk.max_kcore_mask(jnp.asarray(adj), act_j)),
    )
    masked_adj = adj & act[None, :] & act[:, None] if masked else adj
    np.testing.assert_array_equal(pmc.native_core_numbers(masked_adj), want)
    # The greedy on its default ordering, the core numbers.
    g_want = np.asarray(jk.greedy_clique(jnp.asarray(adj), act_j))
    g_got, g_reads = greedy_clique(torch.as_tensor(adj), act_t)
    np.testing.assert_array_equal(g_got.numpy(), g_want)
    assert g_reads >= 2  # the peeling's and the greedy's


def test_core_numbers_batched():
    adj = np.stack([_random_graph(40, p, seed)[0] for seed, p in enumerate((0.1, 0.3, 0.8))])
    got, _ = core_numbers(torch.as_tensor(adj))
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jk.core_numbers(jnp.asarray(adj[b])))
        )


@pytest.mark.parametrize("n,p", GRAPHS)
def test_exact_max_clique_matches_jax(n, p):
    assert pmc.native_available() and jpmc.native_available()
    adj, act = _random_graph(n, p)
    before = pmc.EXACT_SEARCHES
    got = pmc.exact_max_clique(adj)
    assert pmc.EXACT_SEARCHES == before + 1
    assert len(got) == len(jpmc.exact_max_clique(adj)) and got == sorted(got)
    assert adj[np.ix_(got, got)].sum() == len(got) * (len(got) - 1)  # a clique
    mask = pmc.exact_max_clique_mask(adj, act)
    assert mask.sum() == jpmc.exact_max_clique_mask(adj, act).sum()
    assert len(got) < 2 or not (mask & ~act).any()  # an edgeless graph's clique is any vertex
    assert len(got) >= int(greedy_clique(torch.as_tensor(adj))[0].sum())
    for mode in ("kcore", "heu", "exact"):
        want = np.asarray(jk.max_clique_mask(jnp.asarray(adj), jnp.asarray(act), mode))
        got_m = max_clique_mask(torch.as_tensor(adj), torch.as_tensor(act), mode).numpy()
        if mode == "exact":
            assert got_m.sum() == want.sum()
        else:
            np.testing.assert_array_equal(got_m, want)
    with pytest.raises(ValueError):
        max_clique_mask(torch.as_tensor(adj), mode="best")


def test_native_library_is_the_ports_own_build():
    """Built from native/maxclique.cpp into build/psulvsb_tpu_torch/, never
    native/libpsulvsb_native.so; an empty graph has an empty clique."""
    from psulvsb_tpu_torch.ops._build import BUILD_DIR

    assert pmc.native_available()
    assert pmc.SOURCE.name == "maxclique.cpp" and pmc.SOURCE.parent.name == "native"
    assert list(BUILD_DIR.glob("libmaxclique-*.so"))
    assert pmc.exact_max_clique(np.zeros((0, 0), bool)) == []


def test_only_a_missing_toolchain_counts_as_unavailable(monkeypatch, tmp_path):
    """A missing compiler or source is "no toolchain": `native_available` is
    False, remembered without another search for the compiler, a PMC_EXACT
    caller on the CPU degrades to the greedy and one on the card raises. A
    build that fails is an error and raises from every entry point."""
    import shutil

    rng = np.random.default_rng(4)
    adj = _planted(rng, 40, 9, 0.2)
    graph = Graph({v: [int(u) for u in np.nonzero(adj[v])[0]] for v in range(40)})
    solver = MaxCliqueSolver(device="cpu")
    assert solver.params.solver_mode == CliqueSolverMode.PMC_EXACT
    exact = solver.findMaxClique(graph)

    searched, false = [], shutil.which("false")
    monkeypatch.setattr(pmc, "_lib", None)
    monkeypatch.setattr(pmc, "_missing", None)
    monkeypatch.setattr(pmc, "BUILD_DIR", tmp_path)  # nothing built there yet
    monkeypatch.setattr(shutil, "which", lambda name: searched.append(name))
    assert not pmc.native_available() and not pmc.native_available()
    assert len(searched) == 1 and "g++" in pmc._missing
    assert not pmc.exact_search_available("cpu")
    with pytest.raises(pmc.NativeUnavailable, match="cuda"):
        pmc.exact_search_available(torch.device("cuda", 0))
    with pytest.raises(pmc.NativeUnavailable):
        pmc.exact_max_clique(adj)
    greedy = solver.findMaxClique(graph)  # on the CPU: the greedy, by the JAX package's rule
    assert greedy == [int(v) for v in np.nonzero(greedy_clique(torch.as_tensor(adj))[0].numpy())[0]]
    assert len(greedy) <= len(exact) == 9

    monkeypatch.setattr(pmc, "_missing", None)
    monkeypatch.setattr(shutil, "which", lambda name: false)  # a build that fails
    for call in (pmc.native_available, lambda: pmc.exact_search_available("cpu"),
                 lambda: solver.findMaxClique(graph)):
        with pytest.raises(RuntimeError, match="failed to build"):
            call()
    assert not list(tmp_path.glob("*.so"))  # no half-written library is left


@pytest.mark.parametrize("mode", ["PMC_EXACT", "PMC_HEU", "KCORE_HEU"])
def test_max_clique_solver_modes_match_jax(mode):
    rng = np.random.default_rng(3)
    adj = _planted(rng, 60, 14, 0.2)
    edges = {v: [int(u) for u in np.nonzero(adj[v])[0]] for v in range(60)}
    jg, tg = jgraph.Graph(edges), Graph(edges)
    assert tg.numVertices() == jg.numVertices() and tg.numEdges() == jg.numEdges()
    assert tg.getEdges(5) == jg.getEdges(5) and tg.hasEdge(0, edges[0][0])
    np.testing.assert_array_equal(tg.getAdjMatrix(), jg.getAdjMatrix())
    for threshold in (1.0, 0.1):  # 0.1 takes the KCORE_HEU shortcut (graph.cc:66-82)
        want = jgraph.MaxCliqueSolver(jgraph.MaxCliqueSolverParams(
            solver_mode=jgraph.CliqueSolverMode[mode], kcore_heuristic_threshold=threshold,
        )).findMaxClique(jg)
        got = MaxCliqueSolver(MaxCliqueSolverParams(
            solver_mode=CliqueSolverMode[mode], kcore_heuristic_threshold=threshold,
        ), device="cpu").findMaxClique(tg)
        if mode == "PMC_EXACT":
            assert len(got) == len(want) == 14
        else:
            assert got == want
    assert MaxCliqueSolver(device="cpu").findMaxClique(Graph()) == []
    heu = MaxCliqueSolver(MaxCliqueSolverParams(solve_exactly=False), device="cpu")
    assert heu.params.solver_mode == CliqueSolverMode.PMC_HEU
