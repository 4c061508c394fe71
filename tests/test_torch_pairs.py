"""The consistency-degree module (psulvsb_tpu_torch/ops/pairs.py).

On the CPU the port's `consistency_degree` runs its plain PyTorch version.
It is held against a numpy direct-difference reference exactly (the same
float32 expression: squares summed x, y, z, then a square root; strict <,
the self pair excluded, inactive rows 0), and against the JAX front door of
psulvsb_tpu/ops/pallas_pairs.py, which runs the Pallas kernel in interpret
mode on the CPU. The Pallas kernel takes its distances from
|a|^2 + |b|^2 - 2ab, so a pair at the window's edge may flip: at most 2
flips per call are allowed against it, with no flip expected against the
direct form. The sizes 1, 2, 31, 32, 33, 129 and 257 sit at the edges of the
CUDA kernel's tiles, each with all, about 80% and one of the points active:
there the plain version, the card's yardstick, is held against JAX. The
CUDA cases hold the kernel against its plain version on the card (equal
degrees, one launch a call) and skip here; they need no JAX (`python -m
pytest tests/test_torch_pairs.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch.ops import pairs
from psulvsb_tpu_torch.ops._build import LAUNCHES

FLIPS = 2
EDGE_SIZES = [1, 2, 31, 32, 33, 129, 257]
MASKS = ["all", "80%", "one"]


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


def _masked(kind, act, seed):
    """The active mask of a case: None (all active), the input's own mask
    (about 80% on) or one point."""
    if kind == "all":
        return None
    return act if kind == "80%" else np.arange(act.shape[0]) == seed % act.shape[0]


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


@pytest.mark.parametrize(
    "c,mask",
    [pytest.param(c, "80%", id=str(c)) for c in (64, 300, 517)]
    + [(c, m) for c in EDGE_SIZES for m in MASKS],
)
def test_plain_matches_jax_pallas_interpret(c, mask):
    jnp = pytest.importorskip("jax.numpy")
    from psulvsb_tpu.ops.pallas_pairs import consistency_degree as jax_degree

    tau = 0.05
    src, dst, act = _inputs(c, 100 + c, tau)
    act = _masked(mask, act, 100 + c)
    want = np.asarray(jax_degree(jnp.asarray(src), jnp.asarray(dst), tau,
                                 active=None if act is None else jnp.asarray(act)))
    got = pairs.consistency_degree(torch.as_tensor(src), torch.as_tensor(dst), tau,
                                   None if act is None else torch.as_tensor(act)).numpy()
    # A flipped pair moves two degrees by one each.
    assert np.abs(got.astype(np.int64) - want).sum() <= 2 * FLIPS
    if act is not None:
        assert (got[~act] == 0).all()
    np.testing.assert_array_equal(
        got, _numpy_degree(src, dst, tau, np.ones(c, bool) if act is None else act)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("c", EDGE_SIZES)
@pytest.mark.parametrize("mask", MASKS)
def test_cuda_kernel_equals_plain_at_tile_edges(cuda_device, c, mask):
    """Degrees equal the plain version's as integers at the edges of the
    kernel's tiles, with one launch a call."""
    tau = 0.1
    src, dst, act = _inputs(c, c, tau)
    act = _masked(mask, act, c)
    src, dst = torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device)
    act = None if act is None else torch.as_tensor(act, device=cuda_device)
    before = LAUNCHES["consistency_degree"]
    got = pairs.consistency_degree(src, dst, tau, act)
    torch.cuda.synchronize()
    assert LAUNCHES["consistency_degree"] == before + 1
    assert torch.equal(got, pairs.consistency_degree_reference(src, dst, tau, act))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 197, 1250, 1889])
@pytest.mark.parametrize("tau", [0.1, 0.2])
def test_cuda_kernel_equals_plain(cuda_device, c, tau):
    src, dst, act = (torch.as_tensor(x, device=cuda_device) for x in _inputs(c, c, tau))
    before = LAUNCHES["consistency_degree"]
    got = pairs.consistency_degree(src, dst, tau, act)
    torch.cuda.synchronize()
    assert LAUNCHES["consistency_degree"] == before + 1
    want = pairs.consistency_degree_reference(src, dst, tau, act)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_edges(cuda_device):
    x = torch.zeros(3, 5, device=cuda_device)
    off = torch.zeros(5, dtype=torch.bool, device=cuda_device)
    assert pairs.consistency_degree(x, x, 0.1, off).tolist() == [0] * 5
    with pytest.raises(ValueError, match="C = 0"):
        pairs.consistency_degree(x[:, :0], x[:, :0], 0.1)


P_AXIS, C_AXIS = 3, 64  # the pair axis against jax.vmap of the Pallas front door


def _pair_axis_inputs(c, p, seed, tau=0.05):
    src, dst, act = zip(*(_inputs(c, seed + q, tau) for q in range(p)))
    return np.stack(src), np.stack(dst), np.stack(act)


def test_pair_axis_matches_jax_vmap():
    """P = 3 pairs of C = 64: `torch.func.vmap` over the port's front door
    (its operator's vmap rule), the (P, 3, C) front door and P single calls
    give equal degrees, equal to `jax.vmap` of the Pallas front door in
    interpret mode."""
    jax = pytest.importorskip("jax")
    from psulvsb_tpu.ops.pallas_pairs import consistency_degree as jax_degree

    tau = 0.05
    src, dst, act = _pair_axis_inputs(C_AXIS, P_AXIS, 400, tau)
    jnp = jax.numpy
    want = np.asarray(jax.vmap(lambda s, d, a: jax_degree(s, d, tau, active=a))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(act)))
    t = [torch.as_tensor(x) for x in (src, dst, act)]
    via_vmap = torch.func.vmap(lambda s, d, a: pairs.consistency_degree(s, d, tau, a))(*t)
    axis = pairs.consistency_degree(t[0], t[1], tau, t[2])
    alone = torch.stack([pairs.consistency_degree(t[0][q], t[1][q], tau, t[2][q])
                         for q in range(P_AXIS)])
    assert axis.shape == (P_AXIS, C_AXIS) and axis.dtype == torch.int32
    assert torch.equal(via_vmap, axis) and torch.equal(axis, alone)
    np.testing.assert_array_equal(axis.numpy(), want)
    # No mask, and a mask shared by the vmapped calls.
    shared = torch.func.vmap(lambda s, d: pairs.consistency_degree(s, d, tau, t[2][0]))(*t[:2])
    for q in range(P_AXIS):
        assert torch.equal(shared[q], pairs.consistency_degree(t[0][q], t[1][q], tau, t[2][0]))
    assert torch.equal(pairs.consistency_degree(t[0], t[1], tau)[1],
                       pairs.consistency_degree(t[0][1], t[1][1], tau))


@pytest.mark.cuda
def test_cuda_pair_axis_equals_single_launches_and_plain(cuda_device):
    """P = 8 pairs in one launch: the degrees of P single launches and of
    the plain version, and `torch.func.vmap` comes to the same launch."""
    tau, p = 0.1, 8
    src, dst, act = (torch.as_tensor(x, device=cuda_device)
                     for x in _pair_axis_inputs(1889, p, 500, tau))
    before = LAUNCHES["consistency_degree"]
    got = pairs.consistency_degree(src, dst, tau, act)
    torch.cuda.synchronize()
    assert LAUNCHES["consistency_degree"] == before + 1
    assert torch.equal(got, pairs.consistency_degree_reference(src, dst, tau, act))
    alone = torch.stack([pairs.consistency_degree(src[q], dst[q], tau, act[q]) for q in range(p)])
    assert torch.equal(got, alone)
    before = LAUNCHES["consistency_degree"]
    via_vmap = torch.func.vmap(lambda s, d, a: pairs.consistency_degree(s, d, tau, a))(
        src, dst, act)
    assert LAUNCHES["consistency_degree"] == before + 1 and torch.equal(via_vmap, got)
