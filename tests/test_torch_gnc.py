"""The GNC-TLS kernel module (psulvsb_tpu_torch/ops/gnc.py).

On the CPU the port's `gnc_batch` runs its plain PyTorch version; it is
held against the JAX front door `psulvsb_tpu.ops.pallas_gnc.gnc_batch`,
which runs the Pallas kernel in interpret mode on the CPU, and against
`rotation/gnc.py::gnc_tls_rotation(rot_method="power")`. The CUDA cases
hold the kernel against the plain version on the card and skip here; JAX
is imported by a fixture, so on a machine with a card and without JAX they
run with `python -m pytest tests/test_torch_gnc.py -m cuda --noconftest`.

Tolerances: 1e-4 absolute on rotations (float32 sums in another order over
up to 100 reweighting iterations), >= 99% agreement of the inlier masks
over active columns (a weight within rounding of the 0.5 cut may flip).
"""

import types

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch.core.linalg import _quat_to_rot
from psulvsb_tpu_torch.ops import _build
from psulvsb_tpu_torch.ops import gnc as tops
from psulvsb_tpu_torch.rotation.gnc import gnc_tls_rotation

ROT_TOL = 1e-4
MASK_AGREE = 0.99
LOOP = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jax.numpy, the Pallas front door (interpret mode
    on the CPU) and the XLA GNC loop."""
    jnp = pytest.importorskip("jax.numpy")
    from psulvsb_tpu.ops.pallas_gnc import gnc_batch
    from psulvsb_tpu.rotation.gnc import gnc_tls_rotation

    return types.SimpleNamespace(jnp=jnp, gnc_batch=gnc_batch, gnc_tls_rotation=gnc_tls_rotation)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rotation(rng):
    q = rng.normal(size=4)
    return np.asarray(_quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))), np.float32)


def _problem(rng, b, n, outliers=0.3, masked=0.0):
    """B rotation problems: noisy rotated TIMs with a share of gross
    outliers and optionally a share of masked (inactive) columns."""
    rots = np.stack([_rotation(rng) for _ in range(b)])
    src = rng.normal(size=(b, 3, n)).astype(np.float32)
    dst = np.einsum("bij,bjn->bin", rots, src).astype(np.float32)
    dst += rng.uniform(-0.01, 0.01, size=dst.shape).astype(np.float32)
    k = int(n * outliers)
    dst[:, :, :k] += rng.normal(size=(b, 3, k)).astype(np.float32) * 2.0
    act = rng.uniform(size=(b, n)) >= masked
    return src, dst, act, rots


def _both(jref, src, dst, act, nb, warm, use_warm, loop=LOOP):
    jnp = jref.jnp
    rj, ij = jref.gnc_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(act), jnp.asarray(nb),
        jnp.asarray(warm), jnp.asarray(use_warm), **loop,
    )
    rt, it = tops.gnc_batch(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(act),
        torch.as_tensor(nb), torch.as_tensor(warm), use_warm, **loop,
    )
    return np.asarray(rj), np.asarray(ij), rt.numpy(), it.numpy()


def _assert_agree(rj, ij, rt, it, act):
    np.testing.assert_allclose(rt, rj, atol=ROT_TOL)
    agree = ((it == ij) | ~act).sum() / act.size
    assert agree >= MASK_AGREE, agree
    assert not (it & ~act).any()


@pytest.mark.parametrize("b,n", [(4, 128), (4, 256), (3, 197)])
def test_matches_pallas_gnc(jref, b, n):
    rng = np.random.default_rng(b * 1000 + n)
    src, dst, act, rots = _problem(rng, b, n)
    nb = np.full((b,), 0.1, np.float32)
    rj, ij, rt, it = _both(jref, src, dst, act, nb, np.eye(3, dtype=np.float32), False)
    _assert_agree(rj, ij, rt, it, act)
    for i in range(b):
        assert np.abs(rt[i] - rots[i]).max() < 5e-3


def test_matches_xla_gnc_power(jref, rng):
    b, n = 4, 128
    src, dst, act, rots = _problem(rng, b, n)
    rt, it = tops.gnc_batch(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(act),
        torch.full((b,), 0.1), torch.eye(3), False, **LOOP,
    )
    for i in range(b):
        ref = jref.gnc_tls_rotation(
            jref.jnp.asarray(src[i]), jref.jnp.asarray(dst[i]), 0.1, rot_method="power", **LOOP
        )
        np.testing.assert_allclose(rt[i].numpy(), np.asarray(ref.rotation), atol=ROT_TOL)
        agree = (it[i].numpy() == np.asarray(ref.inliers)).mean()
        assert agree >= MASK_AGREE


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_single_problem_gnc_tls_rotation(jref, rng, method):
    jnp = jref.jnp
    src, dst, act, _ = _problem(rng, 1, 150, masked=0.2)
    warm = _rotation(rng)
    for use_warm in (False, True):
        ref = jref.gnc_tls_rotation(
            jnp.asarray(src[0]), jnp.asarray(dst[0]), 0.1, jnp.asarray(act[0]),
            warm_rotation=jnp.asarray(warm), use_warm=use_warm, rot_method=method, **LOOP,
        )
        got = gnc_tls_rotation(
            torch.as_tensor(src[0]), torch.as_tensor(dst[0]), 0.1, torch.as_tensor(act[0]),
            warm_rotation=torch.as_tensor(warm), use_warm=use_warm, rot_method=method, **LOOP,
        )
        np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation), atol=ROT_TOL)
        assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= MASK_AGREE
        assert int(got.iterations) == int(ref.iterations)


def test_warm_start_and_masking(jref, rng):
    """The TestPallasGnc warm/mask problem: half the columns are garbage
    and masked out; the warm rotation is the truth."""
    b, n = 2, 64
    r = _rotation(rng)
    src = rng.normal(size=(3, n)).astype(np.float32)
    dst = (r @ src).astype(np.float32)
    dst[:, n // 2:] = 99.0
    act = np.zeros((b, n), bool)
    act[:, : n // 2] = True
    nb = np.full((b,), 0.1, np.float32)
    rj, ij, rt, it = _both(jref, np.stack([src] * b), np.stack([dst] * b), act, nb, r, True)
    _assert_agree(rj, ij, rt, it, act)
    for i in range(b):
        assert np.abs(rt[i] - r).max() < 5e-3
        assert not it[i, n // 2:].any()


@pytest.mark.parametrize("use_warm", [False, True])
def test_masked_problem_with_mixed_noise_bounds(jref, rng, use_warm):
    b, n = 5, 160
    src, dst, act, rots = _problem(rng, b, n, masked=0.5)
    nb = np.array([0.1, 0.05, 0.2, 0.0, 0.1], np.float32)  # 0.0 takes the 1e-2 floor
    rj, ij, rt, it = _both(jref, src, dst, act, nb, rots[0], use_warm)
    _assert_agree(rj, ij, rt, it, act)


def test_all_inactive_hypothesis_gives_identity_and_no_inliers(jref, rng):
    jnp = jref.jnp
    src, dst, act, _ = _problem(rng, 3, 40)
    act[1] = False
    rt, it = tops.gnc_batch(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(act),
        torch.full((3,), 0.1), torch.eye(3), False, **LOOP,
    )
    np.testing.assert_array_equal(rt[1].numpy(), np.eye(3, dtype=np.float32))
    assert not it[1].any()
    rj, ij = jref.gnc_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(act), jnp.full((3,), 0.1),
        jnp.eye(3), jnp.asarray(False), **LOOP,
    )
    np.testing.assert_array_equal(np.asarray(rj)[1], np.eye(3, dtype=np.float32))
    assert not np.asarray(ij)[1].any()


def _fail_safe_problem(rng, k, n=40):
    """One hypothesis of n active columns of which k fit the rotation and
    the rest are gross outliers; the true rotation as the warm start."""
    r = _rotation(rng)
    src = rng.normal(size=(1, 3, n)).astype(np.float32)
    dst = np.einsum("ij,bjn->bin", r, src).astype(np.float32)
    dst[:, :, k:] += rng.normal(size=(1, 3, n - k)).astype(np.float32) * 5.0 + 10.0
    return src, dst, np.ones((1, n), bool), r


@pytest.mark.parametrize("k", [10, 11])
def test_fail_safe_edge(jref, rng, k):
    """At most 10 columns with w >= 0.5 give every active column; 11 give
    those 11 (registration.cc:1685-1690)."""
    src, dst, act, r = _fail_safe_problem(rng, k)
    rj, ij, rt, it = _both(jref, src, dst, act, np.full((1,), 0.1, np.float32), r, True)
    _assert_agree(rj, ij, rt, it, act)
    expect = act[0] if k <= 10 else np.arange(act.shape[1]) < k
    np.testing.assert_array_equal(it[0], expect)
    np.testing.assert_array_equal(ij[0], expect)


def test_noise_floor(jref, rng):
    """A noise bound whose square is below 1e-16 takes the 1e-2 floor: the
    result of 5e-9 is that of 0.1; 2e-8 (square 4e-16) is not floored. A
    tight cost threshold runs the loop until the outliers drop out."""
    src, dst, act, _ = _problem(rng, 3, 64, masked=0.3)
    warm = np.eye(3, dtype=np.float32)
    loop = dict(LOOP, cost_threshold=1e-6)
    out = {nb: _both(jref, src, dst, act, np.full((3,), nb, np.float32), warm, False, loop)
           for nb in (5e-9, 0.1, 2e-8)}
    for rj, ij, rt, it in out.values():
        _assert_agree(rj, ij, rt, it, act)
    # 0.1 ** 2 is 1e-2 up to float32 rounding.
    np.testing.assert_allclose(out[5e-9][2], out[0.1][2], atol=ROT_TOL)
    np.testing.assert_array_equal(out[5e-9][3], out[0.1][3])
    assert out[0.1][3].sum() < act.sum() and np.array_equal(out[2e-8][3], act)


@pytest.mark.parametrize("b,n", [(2, 0), (0, 8), (1, tops.MAX_N + 1)])
def test_bad_sizes_raise(b, n):
    src = torch.zeros(b, 3, n)
    act = torch.ones(b, n, dtype=torch.bool)
    with pytest.raises(ValueError):
        tops.gnc_batch(src, src, act, torch.full((b,), 0.1), torch.eye(3), False, **LOOP)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(4, 256), (16, 1024), (4, 2048), (3, 197)])
@pytest.mark.parametrize("use_warm", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, use_warm):
    rng = np.random.default_rng(n + b)
    src, dst, act, rots = _problem(rng, b, n, masked=0.5)
    args = [
        torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device),
        torch.as_tensor(act, device=cuda_device), torch.full((b,), 0.1, device=cuda_device),
        torch.as_tensor(rots[0], device=cuda_device), use_warm,
    ]
    before = _build.LAUNCHES["gnc_batch"]
    rk, ik = tops.gnc_batch(*args, **LOOP)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gnc_batch"] == before + 1
    rr, ir = tops.gnc_batch_reference(*args, **LOOP)
    _assert_agree(rr.cpu().numpy(), ir.cpu().numpy(), rk.cpu().numpy(), ik.cpu().numpy(), act)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10, 11, 32, 255, 256, 257, 1024, 1025, 2048])
@pytest.mark.parametrize("b", [1, 16])
def test_cuda_kernel_boundary_shapes(cuda_device, b, n):
    """Both kernel variants (a warp a hypothesis up to N = 256, a block
    beyond) and every column count, against the plain version."""
    rng = np.random.default_rng(7 * n + b)
    src, dst, act, rots = _problem(rng, b, n, masked=0.3)
    args = [
        torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device),
        torch.as_tensor(act, device=cuda_device), torch.full((b,), 0.1, device=cuda_device),
        torch.as_tensor(rots[0], device=cuda_device),
    ]
    for use_warm in (False, True):
        rk, ik = tops.gnc_batch(*args, use_warm, **LOOP)
        rr, ir = tops.gnc_batch_reference(*args, use_warm, **LOOP)
        _assert_agree(rr.cpu().numpy(), ir.cpu().numpy(), rk.cpu().numpy(), ik.cpu().numpy(), act)


@pytest.mark.cuda
def test_cuda_front_door_rules(cuda_device):
    """The noise floor and the <= 10-inlier fail-safe, now in the kernel."""
    rng = np.random.default_rng(5)  # no conftest fixtures on the card
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    for k in (10, 11):
        src, dst, act, r = _fail_safe_problem(rng, k)
        rk, ik = tops.gnc_batch(t(src), t(dst), t(act), t(np.full((1,), 0.1, np.float32)), t(r),
                                True, **LOOP)
        rr, ir = tops.gnc_batch_reference(t(src), t(dst), t(act),
                                          t(np.full((1,), 0.1, np.float32)), t(r), True, **LOOP)
        assert torch.equal(ik, ir) and int(ik.sum()) == (40 if k == 10 else 11)
        np.testing.assert_allclose(rk.cpu().numpy(), rr.cpu().numpy(), atol=ROT_TOL)
    src, dst, act, _ = _problem(rng, 3, 64, masked=0.3)
    loop = dict(LOOP, cost_threshold=1e-6)
    for nb in (5e-9, 0.0, 2e-8, 0.1):
        args = [t(src), t(dst), t(act), t(np.full((3,), nb, np.float32)),
                t(np.eye(3, dtype=np.float32)), False]
        rk, ik = tops.gnc_batch(*args, **loop)
        rr, ir = tops.gnc_batch_reference(*args, **loop)
        _assert_agree(rr.cpu().numpy(), ir.cpu().numpy(), rk.cpu().numpy(), ik.cpu().numpy(), act)



@pytest.mark.parametrize("use_warm", [False, True])
def test_device_flag_matches_bool_in_plain_version(rng, use_warm):
    """`use_warm` as a 0-d bool tensor (selected on the device, so a captured
    launch can follow it) gives what the Python bool gives: rotations within
    1e-6 (the select keeps or drops one solve), masks equal."""
    src, dst, act, rots = _problem(rng, 3, 40, masked=0.3)
    args = [torch.as_tensor(x) for x in (src, dst, act)] + [torch.full((3,), 0.1),
                                                           torch.as_tensor(rots[0])]
    rb, ib = tops.gnc_batch_reference(*args, use_warm, **LOOP)
    rt, it = tops.gnc_batch_reference(*args, torch.tensor(use_warm), **LOOP)
    np.testing.assert_allclose(rt.numpy(), rb.numpy(), atol=1e-6)
    assert torch.equal(it, ib)
    # The front door on the CPU takes the flag too.
    rf, i_f = tops.gnc_batch(*args, torch.tensor(use_warm), **LOOP)
    assert torch.equal(rf, rt) and torch.equal(i_f, it)


def test_device_flag_helper():
    from psulvsb_tpu_torch.utils.scalars import as_scalar, device_flag

    flag = device_flag(True, "cpu")
    assert flag.dtype == torch.bool and flag.dim() == 0 and bool(flag)
    assert device_flag(True, "cpu") is flag  # one constant per device and value
    assert not bool(device_flag(False, "cpu"))
    given = torch.tensor(False)
    assert device_flag(given, "cpu") is given
    with pytest.raises(ValueError):
        device_flag(torch.zeros(2, dtype=torch.bool), "cpu")
    assert as_scalar(0.1, torch.float32, "cpu").item() == np.float32(0.1)
    assert as_scalar(given, torch.bool, "cpu") is given


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(4, 256), (16, 1024)])
def test_cuda_kernel_reads_the_flag_on_the_device(cuda_device, b, n):
    """One captured launch follows the flag's value at each replay."""
    rng = np.random.default_rng(n)
    src, dst, act, rots = _problem(rng, b, n, masked=0.5)
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    args = [t(src), t(dst), t(act), torch.full((b,), 0.1, device=cuda_device), t(rots[0])]
    flag = torch.zeros((), dtype=torch.bool, device=cuda_device)
    tops.gnc_batch(*args, flag, **LOOP)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk, ik = tops.gnc_batch(*args, flag, **LOOP)
    for value in (True, False, True):
        flag.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        rr, ir = tops.gnc_batch_reference(*args, value, **LOOP)
        _assert_agree(rr.cpu().numpy(), ir.cpu().numpy(), rk.cpu().numpy(), ik.cpu().numpy(), act)


@pytest.mark.cuda
@pytest.mark.parametrize("p,h,n", [(8, 4, 256), (3, 8, 1024)])
def test_cuda_pair_axis_equals_single_launches(cuda_device, p, h, n):
    """P pairs of H hypotheses, each pair with its own warm rotation and
    flag, in one launch: equal to P launches of one pair each and within
    ROT_TOL of the plain version."""
    rng = np.random.default_rng(p * 100 + n)
    src, dst, act, rots = _problem(rng, p * h, n, masked=0.3)
    t = [torch.as_tensor(x, device=cuda_device) for x in (src, dst, act)]
    nb = torch.full((p * h,), 0.1, device=cuda_device)
    warm = torch.as_tensor(rots[::h], device=cuda_device)
    flags = torch.as_tensor(np.arange(p) % 2 == 0, device=cuda_device)
    before = _build.LAUNCHES["gnc_batch"]
    rk, ik = tops.gnc_batch(*t, nb, warm, flags, **LOOP)
    assert _build.LAUNCHES["gnc_batch"] == before + 1
    for q in range(p):
        rows = slice(q * h, (q + 1) * h)
        rq, iq = tops.gnc_batch(*(x[rows] for x in t), nb[rows], warm[q], flags[q], **LOOP)
        assert torch.equal(rq, rk[rows]) and torch.equal(iq, ik[rows])
    rr, ir = tops.gnc_batch_reference(*t, nb, warm, flags, **LOOP)
    _assert_agree(rr.cpu().numpy(), ir.cpu().numpy(), rk.cpu().numpy(), ik.cpu().numpy(), act)
