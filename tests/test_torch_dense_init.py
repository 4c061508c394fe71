"""The dense init's pool (psulvsb_tpu_torch/ops/init.py).

On the CPU `dense_init` runs its plain version, the solver's dense init as it
was written over the (C, C) grid: it is held here to its contract (members
are active pairs i < j, the pool their top k by hash priority, padded with
zeros, the counts clamped) against a numpy count of the members, and its pair
axis, plain under `torch.func.vmap` and through the operator's vmap rule, to
single calls. The traced plans' `init_thinned` counter is held to the
solves whose reduced set outgrew the pool's fill.

The CUDA cases hold the kernel (csrc/dense_init.cu) to the plain version on
the card at the solve paths' sizes, at both tests, with members below k, far
above it and every pair a member, keep columns at 0, -1 and -2, at P = 1 and
P = 8 through vmap, and a captured launch to its eager one; they skip here
and need no JAX (`python -m pytest tests/test_torch_dense_init.py -m cuda
--noconftest`). The kernel orders its pool exactly by (priority descending,
position ascending); the plain version's top-k leaves the order inside a run
of equal priorities open, and a pair at the window's edge may fall the other
way where the card's matrix product sums in another order, so kernel and
plain are compared by their counts within 1e-4, their pools' overlap
(Jaccard at least 0.999) and the priorities slot by slot of the pairs both
hold.
"""

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch import SolverParams, psulvsb_register
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.ops import init
from psulvsb_tpu_torch.ops._build import LAUNCHES
from psulvsb_tpu_torch.ops.hist import exact_peak_bin
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.utils import timing
from psulvsb_tpu_torch.utils.scalars import as_generator

BINS_PER_UNIT = 20
NUM_BINS = 10000 * BINS_PER_UNIT
FILL, POOL_CAP, REDUCED_CAP = 14336, 16384, 131072  # the default caps' pool
BETA_3DMATCH = 2.0 * 0.01 * np.sqrt(5.54)  # 2 noise_bound sqrt(cbar2): 0.047
M32 = 0xFFFFFFFF


def _cloud_pair(c, seed, outliers=0.9, scale=1.0):
    """A 3DMatch-protocol pair of C points (noise 0.01), dst scaled by `scale`."""
    pair = make_synthetic_pair(np.random.default_rng(seed), synthetic_cloud(c, seed=seed + 1),
                               0.01, outliers, max_translation=2.0)
    src = torch.as_tensor(np.asarray(pair.src), dtype=torch.float32)
    dst = torch.as_tensor(np.asarray(pair.dst), dtype=torch.float32) * scale
    return src, dst


def _keep(c, rng, active=None, dropped=0.0):
    """keep: 1 for the first `active` points (all by default), a share
    `dropped` of those at 0 or -1 (a pre-filter's marks), -2 after."""
    keep = torch.full((c,), -2, dtype=torch.int64)
    n = c if active is None else active
    keep[:n] = 1
    off = rng.uniform(size=n) < dropped
    keep[:n][torch.as_tensor(off)] = torch.as_tensor(rng.choice([0, -1], size=int(off.sum())))
    return keep


def _ab(seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(1, 2**31 - 1, size=2))


def _priority(i, j, c, ab):
    """float32 of the uint32 hash of positions i C + j (numpy, exact)."""
    a = (int(ab[0]) | 1) & M32
    pos = (np.asarray(i, np.uint64) * np.uint64(c) + np.asarray(j, np.uint64)) & np.uint64(M32)
    h = (pos * np.uint64(a) + np.uint64(int(ab[1]) & M32)) & np.uint64(M32)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x45D9F3B)) & np.uint64(M32)
    h ^= h >> np.uint64(16)
    return h.astype(np.float32)


def _numpy_members(src, dst, keep, beta=None, peak=None):
    """The member mask over pairs i < j in float32 numpy, gram form."""
    def dist(p):
        m = p.numpy().T.astype(np.float32)
        n = (m * m).sum(1)
        return np.sqrt(np.maximum(n[:, None] + n[None, :] - np.float32(2) * (m @ m.T), 0))

    v1, v2 = dist(src), dist(dst)
    act = keep.numpy() == 1
    c = act.shape[0]
    valid = np.triu(np.ones((c, c), bool), 1) & act[:, None] & act[None, :]
    if peak is None:
        return (np.abs(v1 - v2) <= np.float32(beta)) & valid
    ratio = v2 / np.where(v1 > 0, v1, np.float32(1))
    bins = np.clip(np.floor(ratio * np.float32(BINS_PER_UNIT)), -1, NUM_BINS).astype(np.int64)
    return (np.abs(np.clip(bins, 0, NUM_BINS - 1) - peak) <= 1) & valid


def _run(src, dst, keep, ab, peak=None, beta=BETA_3DMATCH, fill=FILL, pool_cap=POOL_CAP,
         reduced_cap=REDUCED_CAP):
    return init.dense_init(src, dst, keep, ab, peak, beta, BINS_PER_UNIT, NUM_BINS, fill,
                           pool_cap, reduced_cap)


def _check_contract(out, members, c, ab, fill, pool_cap, reduced_cap):
    """The pool of one pair against its member mask: counts, members only,
    each once, priorities descending, the top k, zero padding."""
    red_i, red_j, red_count, pool_count = (t.numpy() for t in out)
    n_members = int(members.sum())
    k = min(fill, c * c)
    assert red_i.shape == red_j.shape == (pool_cap,)
    assert int(red_count) == min(n_members, reduced_cap)
    assert int(pool_count) == min(n_members, k)
    n = int(pool_count)
    i, j = red_i[:n], red_j[:n]
    assert (i < j).all() and members[i, j].all()
    assert len(set(zip(i.tolist(), j.tolist()))) == n
    pri = _priority(i, j, c, ab)
    assert (np.diff(pri) <= 0).all()
    mi, mj = np.nonzero(members)
    if n:
        assert (_priority(mi, mj, c, ab) > pri[-1]).sum() <= n
    assert not red_i[n:].any() and not red_j[n:].any()


def test_cpu_tensors_take_the_plain_version():
    src, dst = _cloud_pair(96, 1)
    keep, ab = _keep(96, np.random.default_rng(0)), _ab(1)
    before = LAUNCHES["dense_init"]
    got = _run(src, dst, keep, ab)
    want = init.dense_init_reference(src, dst, keep, ab, None, BETA_3DMATCH, BINS_PER_UNIT,
                                     NUM_BINS, FILL, POOL_CAP, REDUCED_CAP)
    assert LAUNCHES["dense_init"] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("c, fill, pool_cap, reduced_cap, beta, dropped", [
    (64, FILL, POOL_CAP, REDUCED_CAP, BETA_3DMATCH, 0.0),  # k = C² < pool_cap
    (150, 300, 512, REDUCED_CAP, BETA_3DMATCH, 0.2),  # members far above k
    (150, 300, 512, 1000, 1e9, 0.2),  # every active pair a member; red_count clamped
    (150, 300, 512, REDUCED_CAP, 1e-6, 0.0),  # members below k
])
def test_pool_contract(c, fill, pool_cap, reduced_cap, beta, dropped):
    rng = np.random.default_rng(c)
    src, dst = _cloud_pair(c, 2, outliers=0.5)
    keep, ab = _keep(c, rng, active=c - 10, dropped=dropped), _ab(c)
    out = _run(src, dst, keep, ab, beta=beta, fill=fill, pool_cap=pool_cap,
               reduced_cap=reduced_cap)
    members = _numpy_members(src, dst, keep, beta=beta)
    _check_contract(out, members, c, ab, fill, pool_cap, reduced_cap)


def test_pool_contract_estimated_scale():
    c = 120
    src, dst = _cloud_pair(c, 3, outliers=0.6, scale=2.5)
    keep, ab = _keep(c, np.random.default_rng(3), dropped=0.1), _ab(3)
    peak, _, _ = exact_peak_bin(src, dst, keep == 1, bins_per_unit=BINS_PER_UNIT)
    out = _run(src, dst, keep, ab, peak=peak, fill=200, pool_cap=256)
    members = _numpy_members(src, dst, keep, peak=int(peak))
    assert members.sum() > 200
    _check_contract(out, members, c, ab, 200, 256, REDUCED_CAP)


def _batch(p, c, seed):
    rng = np.random.default_rng(seed)
    clouds = [_cloud_pair(c, seed + q, outliers=0.7) for q in range(p)]
    src = torch.stack([s for s, _ in clouds])
    dst = torch.stack([d for _, d in clouds])
    keep = torch.stack([_keep(c, rng, active=c - q, dropped=0.1) for q in range(p)])
    ab = torch.stack([_ab(seed + q) for q in range(p)])
    return src, dst, keep, ab


@pytest.mark.parametrize("form", ["plain", "operator"])
def test_vmap_over_pairs_equals_single_calls(form):
    p, c = 4, 100
    src, dst, keep, ab = _batch(p, c, 7)
    args = (BETA_3DMATCH, BINS_PER_UNIT, NUM_BINS, 150, 256, REDUCED_CAP)
    fn = init.dense_init_reference if form == "plain" else init.dense_init
    got = torch.func.vmap(lambda s, d, k, a: fn(s, d, k, a, None, *args))(src, dst, keep, ab)
    axis = init.dense_init(src, dst, keep, ab, None, *args)
    for q in range(p):
        one = init.dense_init_reference(src[q], dst[q], keep[q], ab[q], None, *args)
        assert all(torch.equal(a[q], b) for a, b in zip(got, one))
        assert all(torch.equal(a[q], b) for a, b in zip(axis, one))


def test_vmap_rule_takes_unbatched_hash_constants_and_peaks():
    p, c = 3, 80
    src, dst, keep, _ = _batch(p, c, 11)
    ab, peak = _ab(5), torch.tensor(20)
    args = (BETA_3DMATCH, BINS_PER_UNIT, NUM_BINS, 100, 128, REDUCED_CAP)
    got = torch.func.vmap(lambda s, d, k: init.dense_init(s, d, k, ab, peak, *args))(
        src, dst, keep)
    for q in range(p):
        one = init.dense_init_reference(src[q], dst[q], keep[q], ab, peak, *args)
        assert all(torch.equal(a[q], b) for a, b in zip(got, one))


@pytest.mark.parametrize("bad", ["keep", "ab", "peak", "fill"])
def test_malformed_inputs_raise(bad):
    src, dst = _cloud_pair(32, 4)
    keep, ab, peak, fill = torch.ones(32, dtype=torch.int64), _ab(4), None, 10
    if bad == "keep":
        keep = keep[:31]
    elif bad == "ab":
        ab = ab[:1]
    elif bad == "peak":
        peak = torch.tensor([3, 4])
    else:
        fill = 0
    with pytest.raises(ValueError):
        _run(src, dst, keep, ab, peak=peak, fill=fill, pool_cap=16)


@pytest.mark.parametrize("pool_cap, pairs", [(32768, None), (64, None), (64, 2)])
def test_init_thinned_counts_the_solves_whose_members_outgrew_the_fill(pool_cap, pairs):
    """The traced plans' counter: at the default pool no solve of a small
    pair is thinned; at a pool of 64 every one is, each pair of a batched
    plan counted."""
    _check_init_thinned(pool_cap, pairs, "cpu")


def _check_init_thinned(pool_cap, pairs, device):
    params = SolverParams.preset_artificial(sampled_cap=256, basic_cap=64, hypothesis_batch=4,
                                            clique_init="off", pool_cap=pool_cap)
    src, dst = _cloud_pair(200, 9, outliers=0.6)
    keep = torch.ones(200, dtype=torch.int64)
    fused.clear_plan_cache()
    timing.enable(True)
    timing.start()
    try:
        if pairs is None:
            psulvsb_register(src, dst, keep, 3, params, device=device)
            psulvsb_register(src, dst, keep, 4, params, device=device)
            solves = 2
        else:
            plan = fused.plan_for(params, 200, device, pairs=pairs)
            plan.solve(*(t.to(device).expand(pairs, *t.shape) for t in (src, dst, keep)),
                       [as_generator(s, torch.device(device)) for s in range(pairs)])
            solves = pairs
        counters = timing.snapshot()["counters"]
    finally:
        timing.enable(False)
        fused.clear_plan_cache()
        timing.start()
    assert counters["pairs"] == solves
    assert counters["init_thinned"] == (solves if pool_cap == 64 else 0)


def test_hash_priority_equals_the_uint32_hash():
    """ops.init.hash_priority (the plain version's priority, and
    chip_smoke's order check) against the numpy uint32 hash."""
    rng = np.random.default_rng(21)
    for c in (64, 6144, 65536):
        i = rng.integers(0, c, size=4096)
        j = rng.integers(0, c, size=4096)
        ab = _ab(c)
        got = init.hash_priority(torch.as_tensor(i * c + j), ab).numpy()
        assert np.array_equal(got, _priority(i, j, c, ab))


@pytest.mark.parametrize("order", ["sound", "reversed", "by_position", "one_swap"])
def test_chip_smoke_agreement_fails_a_wrong_slot_order(order):
    """chip_smoke's kernel-against-plain check passes the plain pool against
    itself and fails the same members in another slot order."""
    from chip_smoke import dense_agreement

    c, fill, pool_cap = 256, 200, 256
    src, dst = _cloud_pair(c, 23)
    keep, ab = _keep(c, np.random.default_rng(23)), _ab(23)
    want = _run(src, dst, keep, ab, beta=1e9, fill=fill, pool_cap=pool_cap)
    n = int(want[3])
    assert n == fill
    slots = torch.arange(n)
    if order == "reversed":
        slots = slots.flip(0)
    elif order == "by_position":
        slots = torch.argsort(want[0][:n] * c + want[1][:n])
    elif order == "one_swap":
        slots[[10, 11]] = slots[[11, 10]]
    got = [want[0].clone(), want[1].clone(), want[2], want[3]]
    got[0][:n], got[1][:n] = want[0][:n][slots], want[1][:n][slots]
    if order == "sound":
        assert dense_agreement(got, want, c, ab) == 0.0
    else:
        with pytest.raises(AssertionError):
            dense_agreement(got, want, c, ab)


@pytest.mark.parametrize("kw, refused", [
    ({}, False),
    ({"pool_cap": 32768}, False),  # a fill of 30720
    ({"pool_cap": 40000}, True),  # 37952
    ({"pool_cap": 40000, "reduced_cap": 32768}, False),  # the pool is min(pool_cap, reduced_cap)
    ({"pool_cap": 40000, "init_mode": "exact_beta"}, False),  # no dense init
    ({"pool_cap": 40000, "init_mode": "dense"}, True),
    ({"dense_init_max_c": 1 << 16}, False),
    ({"dense_init_max_c": (1 << 16) + 1}, True),
    ({"dense_init_max_c": (1 << 16) + 1, "init_mode": "sampled"}, False),
])
def test_params_refuse_a_dense_init_the_kernel_cannot_take(kw, refused):
    """Made params refuse, on every device, a dense init route whose pool
    fill or C the card's kernel cannot take."""
    if refused:
        with pytest.raises(ValueError, match="at most"):
            SolverParams(**kw)
    else:
        params = SolverParams(**kw)
        assert params.init_mode not in ("auto", "dense") or params.pool_fill <= init.MAX_FILL


def test_init_route_refuses_a_forced_dense_init_beyond_the_kernels_c():
    from psulvsb_tpu_torch.solver.psulvsb import init_route

    params = SolverParams(init_mode="dense")
    assert init_route(params, init.MAX_C) == "dense"
    with pytest.raises(ValueError, match="at most 65536"):
        init_route(params, init.MAX_C + 1)


@pytest.mark.parametrize("pairs", [None, 2])
def test_thinned_counter_adds_no_buffer_to_a_plan(pairs):
    """The init span's closing stamp counts the thinned inits from the
    plan's own `red_count`: traced and untraced plans hold the same
    buffers, so the counter adds no operation to a solve (on the card,
    tests/test_torch_trace.py holds the graphs' nodes to the same)."""
    params = SolverParams.preset_artificial(sampled_cap=256, basic_cap=64, hypothesis_batch=4,
                                            clique_init="off")
    src, dst = _cloud_pair(200, 9, outliers=0.6)
    keep = torch.ones(200, dtype=torch.int64)
    lead = (pairs,) if pairs else ()
    held = {}
    fused.clear_plan_cache()
    try:
        for traced in (False, True):
            timing.enable(traced)
            plan = fused.plan_for(params, 200, "cpu", pairs=pairs)
            plan.solve(src.expand(lead + (3, 200)), dst.expand(lead + (3, 200)),
                       keep.expand(lead + (200,)),
                       [torch.Generator().manual_seed(s) for s in range(pairs)]
                       if pairs else torch.Generator().manual_seed(0))
            held[traced] = {name: tuple(t.shape) for name, t in plan.bufs.items()}
    finally:
        timing.enable(False)
        fused.clear_plan_cache()
        timing.start()
    assert held[False] == held[True]


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _on(dev, *tensors):
    return [None if t is None else t.to(dev) for t in tensors]


def _compare(got, want, c, ab):
    """Kernel against plain on one pair (module docstring)."""
    gi, gj, gc, gp = (t.cpu().numpy() for t in got)
    wi, wj, wc, wp = (t.cpu().numpy() for t in want)
    assert abs(int(gc) - int(wc)) <= max(1e-4 * int(wc), 0)
    n, m = int(gp), int(wp)
    assert abs(n - m) <= max(1e-4 * m, 0)
    g = list(zip(gi[:n].tolist(), gj[:n].tolist()))
    w = list(zip(wi[:m].tolist(), wj[:m].tolist()))
    both = set(g) & set(w)
    assert len(both) >= 0.999 * len(set(g) | set(w))
    pri = _priority(gi[:n], gj[:n], c, ab)
    pos = gi[:n].astype(np.int64) * c + gj[:n]
    assert (np.diff(pri) <= 0).all()
    ties = np.diff(pri) == 0
    assert (np.diff(pos)[ties] > 0).all()  # a run of equal priorities by position
    kept = np.array([e in both for e in g])
    plain_kept = np.array([e in both for e in w])
    assert np.array_equal(pri[kept], _priority(wi[:m], wj[:m], c, ab)[plain_kept])
    assert not gi[n:].any() and not gj[n:].any()


CUDA_SIZES = [(2048, None), (4096, None), (6144, 5000), (8192, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("c, active", CUDA_SIZES)
@pytest.mark.parametrize("scale", ["known", "estimated"])
def test_cuda_kernel_matches_plain(cuda_device, c, active, scale):
    rng = np.random.default_rng(c)
    src, dst = _cloud_pair(c, c, scale=1.0 if scale == "known" else 2.0)
    keep, ab = _keep(c, rng, active=active, dropped=0.05), _ab(c)
    src, dst, keep, ab = _on(cuda_device, src, dst, keep, ab)
    peak = None
    if scale == "estimated":
        peak, _, _ = exact_peak_bin(src, dst, keep == 1, bins_per_unit=BINS_PER_UNIT)
    before = LAUNCHES["dense_init"]
    got = _run(src, dst, keep, ab, peak=peak)
    assert LAUNCHES["dense_init"] == before + 1
    want = init.dense_init_reference(src, dst, keep, ab, peak, BETA_3DMATCH, BINS_PER_UNIT,
                                     NUM_BINS, FILL, POOL_CAP, REDUCED_CAP)
    if scale == "known":
        assert int(want[2]) > FILL  # 3DMatch's members are far above k
    _compare(got, want, c, ab.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("beta, fill", [(1e-4, FILL), (1e9, FILL), (BETA_3DMATCH, 300),
                                        (1e9, 32768 - 2048)])
def test_cuda_members_below_above_and_all(cuda_device, beta, fill):
    c = 2048
    src, dst = _cloud_pair(c, 5)
    keep, ab = _keep(c, np.random.default_rng(5), active=1900, dropped=0.1), _ab(5)
    src, dst, keep, ab = _on(cuda_device, src, dst, keep, ab)
    pool_cap = fill + 2048
    got = _run(src, dst, keep, ab, beta=beta, fill=fill, pool_cap=pool_cap)
    want = init.dense_init_reference(src, dst, keep, ab, None, beta, BINS_PER_UNIT, NUM_BINS,
                                     fill, pool_cap, REDUCED_CAP)
    _compare(got, want, c, ab.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 8])
def test_cuda_pair_axis_through_vmap_equals_single_launches(cuda_device, p):
    c = 4096
    src, dst, keep, ab = _on(cuda_device, *_batch(p, c, 13))
    args = (BETA_3DMATCH, BINS_PER_UNIT, NUM_BINS, FILL, POOL_CAP, REDUCED_CAP)
    before = LAUNCHES["dense_init"]
    got = torch.func.vmap(lambda s, d, k, a: init.dense_init(s, d, k, a, None, *args))(
        src, dst, keep, ab)
    assert LAUNCHES["dense_init"] == before + 1
    for q in range(p):
        one = init.dense_init(src[q], dst[q], keep[q], ab[q], None, *args)
        assert all(torch.equal(a[q], b) for a, b in zip(got, one))
        plain = init.dense_init_reference(src[q], dst[q], keep[q], ab[q], None, *args)
        _compare(one, plain, c, ab[q].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("pool_cap, pairs", [(32768, None), (64, None), (64, 8)])
def test_cuda_init_thinned_counts_the_solves_whose_members_outgrew_the_fill(cuda_device, pool_cap,
                                                                           pairs):
    """The counter as the captured init span's closing stamp adds it."""
    _check_init_thinned(pool_cap, pairs, cuda_device)


@pytest.mark.cuda
def test_cuda_captured_launch_equals_eager(cuda_device):
    c = 6144
    src, dst = _cloud_pair(c, 17)
    keep, ab = _keep(c, np.random.default_rng(17), active=5000), _ab(17)
    src, dst, keep, ab = _on(cuda_device, src, dst, keep, ab)
    eager = _run(src, dst, keep, ab)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        _run(src, dst, keep, ab)  # warm on the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = _run(src, dst, keep, ab)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))
