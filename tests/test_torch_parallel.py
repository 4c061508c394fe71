"""The pair batch of the port (psulvsb_tpu_torch/parallel/pairs.py) on the
cases of tests/test_parallel.py at its TINY caps.

On the CPU a batch runs each pair's solve eagerly, so each pair of
`register_batch` must equal its `psulvsb_register` alone with the same seed
exactly, in order and with pairs in flight (`_register_in_flight`).
`vectorized=True` takes every setting to the batched form, one program over
a pair axis, whose products and reductions run over other shapes and so sum
in another order: there valid and inlier counts are equal and scale,
rotation and translation within BATCHED_TOL (1e-5 here, 1e-4 on the card).
The split over the devices ["cpu", "cpu"] must equal the local batch and sum
its totals; all-padding pairs (keep_mask == -2 everywhere) come back invalid
and poison nothing; every real pair's rotation is within 10 degrees of the
truth.
"""

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch import (
    SolverParams,
    make_pair_mesh,
    psulvsb_register,
    register_batch,
    register_batch_sharded,
)
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.parallel.pairs import _register_in_flight
from psulvsb_tpu_torch.solver.solution import RegistrationSolution

TINY = dict(sampled_cap=128, basic_cap=64, hypothesis_batch=2, scale_max_draws=32)
N = 48
BATCHED_TOL = {"cpu": 1e-5, "cuda": 1e-4}


def _assert_same(got, want, vectorized, i):
    """Row i of a batch against the pair's solve alone: equal in order and
    in flight; in the batched form equal valid and counts, the rest within
    BATCHED_TOL."""
    for name, g, w in zip(got._fields, got, want):
        if vectorized is not True or g.dtype in (torch.bool, torch.int64):
            assert torch.equal(g[i], w), (i, name)
        else:
            tol = BATCHED_TOL[g.device.type]
            assert torch.allclose(g[i], w, rtol=0.0, atol=tol), (i, name, g[i], w)


def _batch(form, *args, **kwargs):
    """register_batch with vectorized=form, or for "in_flight" the in-flight
    form."""
    if form == "in_flight":
        return _register_in_flight(*args, **kwargs)
    return register_batch(*args, vectorized=form, **kwargs)


def _make_batch(b, n=N):
    src = synthetic_cloud(n, seed=0)
    pairs = [make_synthetic_pair(np.random.default_rng(50 + i), src, 0.05, 0.5) for i in range(b)]
    return (
        np.stack([np.asarray(p.src, np.float32) for p in pairs]),
        np.stack([np.asarray(p.dst, np.float32) for p in pairs]),
        np.ones((b, n), np.int64),
        [900 + i for i in range(b)],
        [p.transform for p in pairs],
    )


@pytest.fixture(scope="module")
def batch16():
    params = SolverParams.preset_artificial(**TINY)
    src, dst, keep, seeds, gts = _make_batch(16)
    keep[:3] = -2  # three all-padding pairs
    local = register_batch(src, dst, keep, seeds, params, device="cpu")
    return params, src, dst, keep, seeds, gts, local


@pytest.mark.parametrize("vectorized", [False, True, "in_flight"])
def test_each_pair_equals_its_solve_alone(batch16, vectorized):
    params, src, dst, keep, seeds, _, local = batch16
    sols = local if not vectorized else _batch(
        vectorized, src, dst, keep, seeds, params, device="cpu")
    assert sols.rotation.shape == (16, 3, 3) and sols.valid.shape == (16,)
    assert sols.final_inlier_count.dtype == torch.int64
    for i in range(16):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params, device="cpu")
        _assert_same(sols, alone, vectorized, i)


def test_generators_in_place_of_seeds(batch16):
    params, src, dst, keep, seeds, _, local = batch16
    gens = [torch.Generator().manual_seed(s) for s in seeds[:4]]
    sols = register_batch(src[:4], dst[:4], keep[:4], gens, params, device="cpu")
    for got, want in zip(sols, local):
        assert torch.equal(got, want[:4])


def test_padding_pairs_come_back_invalid_and_poison_nothing(batch16):
    _, _, _, _, _, gts, local = batch16
    valid = local.valid.numpy()
    assert not valid[:3].any() and valid[3:].all()
    assert (local.final_inlier_count[:3] == 0).all()
    for field in local:
        assert torch.isfinite(field.to(torch.float64)).all()
    for i in range(3, 16):
        re = angular_error_deg_np(gts[i].rotation, local.rotation[i].numpy().astype(np.float64))
        assert re < 10.0, (i, re)


@pytest.mark.parametrize("vectorized", [False, True])
def test_sharded_over_two_devices_equals_local(batch16, vectorized):
    params, src, dst, keep, seeds, _, local = batch16
    mesh = make_pair_mesh(["cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 2
    sols, totals = register_batch_sharded(
        mesh, src, dst, keep, seeds, params, vectorized=vectorized)
    for i in range(16):
        _assert_same(sols, RegistrationSolution(*(f[i] for f in local)), vectorized, i)
    assert int(totals["valid_pairs"]) == int(local.valid.sum()) == 13
    assert int(totals["inlier_sum"]) == int(local.final_inlier_count.sum())


def test_estimated_scale_batch_equals_solves_alone():
    """The scale draws go through the batch as through one solve."""
    params = SolverParams.preset_3dmatch(estimate_scaling=True, **TINY)
    src = synthetic_cloud(N, seed=1)
    pairs = [make_synthetic_pair(np.random.default_rng(70 + i), src, 0.01, 0.4,
                                 outlier_mode="mismatch", test_scale=1.5 + i) for i in range(3)]
    s = np.stack([np.asarray(p.src, np.float32) for p in pairs])
    d = np.stack([np.asarray(p.dst, np.float32) for p in pairs])
    keep = np.ones((3, N), np.int64)
    for vectorized in (False, True):
        sols = register_batch(s, d, keep, [5, 6, 7], params, vectorized=vectorized, device="cpu")
        for i in range(3):
            alone = psulvsb_register(s[i], d[i], keep[i], 5 + i, params, device="cpu")
            _assert_same(sols, alone, vectorized, i)
            assert abs(float(sols.scale[i]) - (1.5 + i)) < 0.1


def test_bad_batches_raise():
    params = SolverParams.preset_artificial(**TINY)
    src, dst, keep, seeds, _ = _make_batch(3)
    with pytest.raises(ValueError, match="seeds"):
        register_batch(src, dst, keep, seeds[:2], params, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 3, C\)"):
        register_batch(src[0], dst[0], keep[0], seeds[:1], params, device="cpu")
    with pytest.raises(ValueError, match="evenly"):
        register_batch_sharded(["cpu", "cpu"], src, dst, keep, seeds, params)
    with pytest.raises(ValueError):
        make_pair_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_pair_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            register_batch(src, dst, keep, seeds, params)


@pytest.mark.cuda
@pytest.mark.parametrize("vectorized", [False, True, "in_flight"])
def test_cuda_batch_equals_solves_alone(vectorized):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    params = SolverParams.preset_artificial(**TINY)
    src, dst, keep, seeds, _ = _make_batch(9)
    sols = _batch(vectorized, src, dst, keep, seeds, params)
    for i in range(9):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params)
        _assert_same(sols, alone, vectorized, i)


@pytest.mark.cuda
@pytest.mark.parametrize("vectorized", [False, True, "in_flight"])
def test_cuda_batch_syncs_nothing_before_the_readback(vectorized):
    """Once its plans hold their graphs, a batch of B = 32 pairs staged on the
    card runs with no host synchronization up to the readback (each pair: its
    draws, one graph launch, a copy of its solution), and each pair still
    gets its solve alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    params = SolverParams.preset_artificial(**TINY)
    src, dst, keep, seeds, _ = _make_batch(32)
    src, dst, keep = (torch.as_tensor(x, device="cuda") for x in (src, dst, keep))
    _batch(vectorized, src, dst, keep, seeds, params)  # graphs captured
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sols = _batch(vectorized, src, dst, keep, seeds, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i in (0, 17, 31):
        alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params)
        _assert_same(sols, alone, vectorized, i)
