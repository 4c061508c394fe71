"""The port's pair helpers (pairs/tims.py) and init stages
(solver/psulvsb.py) against the JAX package's, with JAX's own draws.

Every init mode of the port gets the random inputs JAX's `_init_stage`
draws from its key: the pair draws of the subsample peak and of the
rejection fill, the compaction's sort keys, the dense mode's hash
constants. Tolerances: the helpers exactly; reduced pools as sets with at
most 2 pairs in the symmetric difference and red_count within the same 2
pairs (a pair at a window edge may flip where the two packages sum three
squares in another order or, in the dense mode, where the distance comes
from |a|^2 + |b|^2 - 2ab); the pool counts likewise.

"auto" differs on purpose: the JAX package routes it to "sampled" beyond
dense_init_max_c on the CPU and the port always takes the accelerator
route ("exact_hist" or "exact_beta"), so "auto" is held against JAX's
explicit mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.pairs import tims as jt
from psulvsb_tpu.solver import psulvsb as jps
from psulvsb_tpu.solver.config import SolverParams as JParams
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.ops.hist import pair_ratio_histogram
from psulvsb_tpu_torch.pairs import tims as tt
from psulvsb_tpu_torch.solver import psulvsb as tps

C = 200
FLIPS = 2
SMALL = dict(init_peak_sample=1 << 14, init_reject_budget=1 << 15)


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# pairs/tims.py
# ---------------------------------------------------------------------------


def test_triu_and_tims(rng):
    v = rng.normal(size=(3, 40)).astype(np.float32)
    act = rng.uniform(size=40) < 0.7
    ii, jj = tt.triu_pair_indices(40)
    ji, jj_ = jt.triu_pair_indices(40)
    np.testing.assert_array_equal(ii, ji)
    np.testing.assert_array_equal(jj, jj_)
    got = tt.compute_tims(torch.as_tensor(v), torch.as_tensor(act))
    want = jt.compute_tims(jnp.asarray(v), jnp.asarray(act))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(tt.compute_tims(torch.as_tensor(v))[3].all())
    sel = rng.integers(0, 40, size=(2, 30))
    np.testing.assert_array_equal(
        tt.gather_tims(torch.as_tensor(v), torch.as_tensor(sel[0]), torch.as_tensor(sel[1])).numpy(),
        np.asarray(jt.gather_tims(jnp.asarray(v), jnp.asarray(sel[0]), jnp.asarray(sel[1]))),
    )


def test_ratio_bins_and_histogram(rng):
    r = np.concatenate([
        rng.uniform(0.0, 12.0, size=500),
        [0.0, 0.05, 4.999999, 9999.99, 1e4, 3e38, np.inf, np.nan],
    ]).astype(np.float32)
    act = rng.uniform(size=r.shape[0]) < 0.8
    for kw in ({}, {"num_bins": 300, "max_scale": 15.0}):
        gi, gn = tt.ratio_bin_indices(torch.as_tensor(r), **kw)
        wi, wn = jt.ratio_bin_indices(jnp.asarray(r), **kw)
        assert gn == wn
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        gc, _ = tt.scale_ratio_histogram(torch.as_tensor(r), torch.as_tensor(act), **kw)
        wc, _ = jt.scale_ratio_histogram(jnp.asarray(r), jnp.asarray(act), **kw)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        gm, gp = tt.peak_bin_mask(gc, gi, torch.as_tensor(act))
        wm, wp = jt.peak_bin_mask(wc, wi, jnp.asarray(act))
        assert int(gp) == int(wp)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_sort_peak_bin(rng, frac):
    idx = rng.integers(0, 50, size=3000)
    act = rng.uniform(size=3000) < frac
    got = tt.sort_peak_bin(torch.as_tensor(idx), torch.as_tensor(act), 50)
    want = jt.sort_peak_bin(jnp.asarray(idx, jnp.int32), jnp.asarray(act), 50)
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("max_index,cap", [(3000, 8192), (3000, 256), (1 << 30, 256)])
def test_masked_random_compact(rng, max_index, cap):
    n = 4000
    mask = rng.uniform(size=n) < 0.3
    idx_i = rng.integers(0, 3000, size=n)
    idx_j = rng.integers(0, 3000, size=n)
    key = jax.random.PRNGKey(cap)
    keys = np.asarray(jax.random.randint(key, (n,), 0, jnp.int32(1 << 30)))
    got = tt.masked_random_compact(
        torch.as_tensor(mask), torch.as_tensor(idx_i), torch.as_tensor(idx_j), cap,
        max_index=max_index, keys=_t(keys),
    )
    want = jt.masked_random_compact(
        key, jnp.asarray(mask), jnp.asarray(idx_i, jnp.int32), jnp.asarray(idx_j, jnp.int32),
        cap, max_index=max_index,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_draw_pairs_maps_jax_draws():
    ka, kb = jax.random.split(jax.random.PRNGKey(9))
    a = np.asarray(jax.random.randint(ka, (5000,), 0, C))
    b = np.asarray(jax.random.randint(kb, (5000,), 0, C - 1))
    got = tps._draw_pairs(torch.as_tensor(a), torch.as_tensor(b))
    want = jps._draw_pairs(jax.random.PRNGKey(9), 5000, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[0] < got[1]).all())


# ---------------------------------------------------------------------------
# init stages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(test_scale: float, rate: float):
    rng = np.random.default_rng(int(test_scale * 10) + int(rate * 100))
    pair = make_synthetic_pair(
        rng, synthetic_cloud(C, seed=2), 0.01, rate, outlier_mode="mismatch",
        test_scale=test_scale,
    )
    keep = np.ones(C, np.int32)
    keep[rng.permutation(C)[: C // 10]] = 0
    return pair.src, pair.dst, keep


def _jax_draws(key, params, c):
    """The draws JAX's init stages make from their key, as port inputs."""
    k1, k2 = jax.random.split(key)
    k_draw, k_compact = jax.random.split(k2)
    k_peak, k_hash = k1, k2  # the dense mode's split of the same key

    def pairs(k, n):
        return tuple(_t(x, torch.int64) for x in jps._draw_pairs(k, n, c))

    return {
        "sampled": tps.InitDraws(
            peak_pairs=pairs(k1, params.init_peak_sample),
            fill_pairs=pairs(k_draw, params.init_reject_budget),
            fill_keys=_t(jax.random.randint(k_compact, (params.init_reject_budget,), 0, jnp.int32(1 << 30)), torch.int64),
        ),
        "dense": tps.InitDraws(
            ab=_t(jax.random.randint(k_hash, (2,), 1, jnp.iinfo(jnp.int32).max), torch.int64),
            peak_pairs=pairs(k_peak, params.init_peak_sample),
        ),
        "exact": tps.InitDraws(
            exact_keys=_t(jax.random.randint(key, (c * (c - 1) // 2,), 0, jnp.int32(1 << 30)), torch.int64),
        ),
    }


def _sets(red_i, red_j, pool):
    n = int(pool)
    return set(zip(np.asarray(red_i)[:n].tolist(), np.asarray(red_j)[:n].tolist()))


def _compare_init(port_mode, jax_mode, estimate_scaling, test_scale, rate, **kw):
    src, dst, keep = _pair(test_scale, rate)
    jp = JParams.preset_3dmatch(estimate_scaling=estimate_scaling, init_mode=jax_mode, **SMALL)
    key = jax.random.PRNGKey(4)
    want = jps._init_stage(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(keep), jp, key)
    tp = params_from_jax(jp).replace(init_mode=port_mode, **kw)
    route = tps.init_route(tp, C)
    draws = _jax_draws(key, jp, C)[{"dense": "dense", "exact": "exact"}.get(route, "sampled")]
    got = tps._init_stage(_t(src), _t(dst), _t(keep, torch.int64), tp, draws=draws)
    a, b = _sets(got[0], got[1], got[3]), _sets(*want[:2], want[3])
    assert all(i < j and keep[i] == 1 and keep[j] == 1 for i, j in a)
    assert len(a ^ b) <= FLIPS, (len(a), len(b), len(a ^ b))
    assert abs(int(got[3]) - int(want[3])) <= FLIPS
    # An estimated red_count moves by n_l / budget per flipped pair.
    per_flip = 1 if route in ("dense", "exact", "exact_beta") else -(-(C * (C - 1) // 2) // jp.init_reject_budget)
    assert abs(int(got[2]) - int(want[2])) <= FLIPS * per_flip, (int(got[2]), int(want[2]))
    assert got[0].shape == want[0].shape
    return route, got


@pytest.mark.parametrize("estimate_scaling", [False, True])
@pytest.mark.parametrize("mode", ["sampled", "exact", "dense"])
def test_init_modes_match_jax(mode, estimate_scaling):
    ts = 2.3 if estimate_scaling else 1.0
    route, _ = _compare_init(mode, mode, estimate_scaling, ts, 0.6)
    assert route == mode


@pytest.mark.parametrize(
    "test_scale,rate,certified", [(2.3, 0.3, True), (40.0, 0.3, False)]
)
def test_init_exact_hist_matches_jax(test_scale, rate, certified):
    """The exact histogram peak where it is certified; beyond the 512-bin
    window (ratio 25.6) the clamp bin holds the peak and the stage falls
    back to the subsample peak and the estimated count."""
    src, dst, keep = _pair(test_scale, rate)
    h = pair_ratio_histogram(_t(src), _t(dst), _t(keep) == 1, num_bins=512)
    peak = int(torch.argmax(h[:511]))
    assert (bool(h[511] < h[peak]) and peak < 510) == certified
    route, _ = _compare_init("exact_hist", "exact_hist", True, test_scale, rate)
    assert route == "exact_hist"


def test_init_exact_beta_matches_jax():
    route, _ = _compare_init("exact_beta", "exact_beta", False, 1.0, 0.6)
    assert route == "exact_beta"


@pytest.mark.parametrize("estimate_scaling", [False, True])
def test_auto_beyond_dense_window_takes_the_accelerator_route(estimate_scaling):
    jax_mode = "exact_hist" if estimate_scaling else "exact_beta"
    route, _ = _compare_init(
        "auto", jax_mode, estimate_scaling, 2.3 if estimate_scaling else 1.0, 0.3,
        dense_init_max_c=C - 1,
    )
    assert route == jax_mode


def test_init_route():
    p = params_from_jax(JParams.preset_3dmatch())
    assert tps.init_route(p, 8192) == "dense"
    assert tps.init_route(p, 8193) == "exact_hist"
    assert tps.init_route(p.replace(estimate_scaling=False), 8193) == "exact_beta"
    assert tps.init_route(p.replace(init_mode="exact_beta"), 10) == "sampled"
    assert tps.init_route(p.replace(estimate_scaling=False, init_mode="exact_hist"), 10) == "sampled"
    with pytest.raises(ValueError):
        tps.init_route(p.replace(init_mode="bogus"), 10)


def test_init_draws_from_generator_are_reproducible():
    src, dst, keep = _pair(2.3, 0.6)
    tp = params_from_jax(JParams.preset_3dmatch(init_mode="exact_hist", **SMALL))
    outs = [
        tps._init_stage(_t(src), _t(dst), _t(keep, torch.int64), tp, torch.Generator().manual_seed(1))
        for _ in range(2)
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
