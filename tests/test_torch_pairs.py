"""The consistency-degree module (psulvsb_tpu_torch/ops/pairs.py).

On the CPU the port's `consistency_degree` runs its plain PyTorch version.
It is held against a numpy direct-difference reference exactly (the same
float32 expression: squares summed x, y, z, then a square root; strict <,
the self pair excluded, inactive rows 0), and against the JAX front door of
psulvsb_tpu/ops/pallas_pairs.py, which runs the Pallas kernel in interpret
mode on the CPU. The Pallas kernel takes its distances from
|a|^2 + |b|^2 - 2ab, so a pair at the window's edge may flip: at most 2
flips per call are allowed against it, with no flip expected against the
direct form. The CUDA cases hold the kernel against its plain version on
the card (equal degrees) and skip here; they need no JAX (`python -m pytest
tests/test_torch_pairs.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch.ops import pairs

FLIPS = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(c, seed, tau=0.05, inactive=0.2):
    """C points of which half move rigidly (consistent pairs) and the rest
    at random, with an active mask with a share of points off."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(3, c)).astype(np.float32)
    dst = rng.normal(size=(3, c)).astype(np.float32)
    dst[:, : c // 2] = src[:, : c // 2] + 0.3
    dst[:, : c // 2] += rng.uniform(-tau / 4, tau / 4, size=(3, c // 2)).astype(np.float32)
    return src, dst, rng.uniform(size=c) >= inactive


def _numpy_degree(src, dst, tau, active):
    """Direct-difference degrees in float32 numpy, summed as the port does."""
    def dist(p):
        e = p[:, :, None] - p[:, None, :]
        return np.sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])

    ok = np.abs(dist(src) - dist(dst)) < np.float32(tau)
    np.fill_diagonal(ok, False)
    ok &= active[None, :]
    return np.where(active, ok.sum(1), 0).astype(np.int32)


@pytest.mark.parametrize("c", [1, 64, 300, 517])
@pytest.mark.parametrize("tau", [0.05, 0.1])
def test_plain_equals_numpy_direct_form(c, tau):
    src, dst, act = _inputs(c, c, tau)
    got = pairs.consistency_degree(torch.as_tensor(src), torch.as_tensor(dst), tau,
                                   torch.as_tensor(act))
    assert got.dtype == torch.int32 and got.shape == (c,)
    np.testing.assert_array_equal(got.numpy(), _numpy_degree(src, dst, tau, act))


def test_edges_of_the_front_door():
    src = torch.zeros(3, 4)
    src[0] = torch.arange(4.0)
    # dst = src: every pair has difference 0 < tau; tau = 0 counts nothing
    # (strict <), and no mask means every point is active.
    np.testing.assert_array_equal(pairs.consistency_degree(src, src, 0.1).numpy(), [3, 3, 3, 3])
    np.testing.assert_array_equal(pairs.consistency_degree(src, src, 0.0).numpy(), [0] * 4)
    off = torch.zeros(4, dtype=torch.bool)
    np.testing.assert_array_equal(pairs.consistency_degree(src, src, 0.1, off).numpy(), [0] * 4)
    with pytest.raises(ValueError, match="C = 0"):
        pairs.consistency_degree(torch.zeros(3, 0), torch.zeros(3, 0), 0.1)
    with pytest.raises(ValueError):
        pairs.consistency_degree(src, src[:, :3], 0.1)


@pytest.mark.parametrize("c", [64, 300, 517])
def test_plain_matches_jax_pallas_interpret(c):
    jnp = pytest.importorskip("jax.numpy")
    from psulvsb_tpu.ops.pallas_pairs import consistency_degree as jax_degree

    tau = 0.05
    src, dst, act = _inputs(c, 100 + c, tau)
    want = np.asarray(jax_degree(jnp.asarray(src), jnp.asarray(dst), tau,
                                 active=jnp.asarray(act)))
    got = pairs.consistency_degree(torch.as_tensor(src), torch.as_tensor(dst), tau,
                                   torch.as_tensor(act)).numpy()
    # A flipped pair moves two degrees by one each.
    assert np.abs(got.astype(np.int64) - want).sum() <= 2 * FLIPS
    assert (got[~act] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 197, 1250, 1889])
@pytest.mark.parametrize("tau", [0.1, 0.2])
def test_cuda_kernel_equals_plain(cuda_device, c, tau):
    src, dst, act = (torch.as_tensor(x, device=cuda_device) for x in _inputs(c, c, tau))
    before = pairs.KERNEL_LAUNCHES
    got = pairs.consistency_degree(src, dst, tau, act)
    torch.cuda.synchronize()
    assert pairs.KERNEL_LAUNCHES == before + 1
    want = pairs.consistency_degree_reference(src, dst, tau, act)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_edges(cuda_device):
    x = torch.zeros(3, 5, device=cuda_device)
    off = torch.zeros(5, dtype=torch.bool, device=cuda_device)
    assert pairs.consistency_degree(x, x, 0.1, off).tolist() == [0] * 5
    with pytest.raises(ValueError, match="C = 0"):
        pairs.consistency_degree(x[:, :0], x[:, :0], 0.1)
