"""Batched GNC-TLS rotation: the CUDA kernel `csrc/gnc_batch.cu` and its
plain PyTorch version.

`gnc_batch` keeps the signature and layout of the JAX package's front door
(psulvsb_tpu/ops/pallas_gnc.py::gnc_batch): TIMs as (B, 3, N), results as
(rotations (B, 3, 3), inliers (B, N) bool). Around the loop come the
noise-bound floor, the weight >= 0.5 rule and the <= 10-inlier fail-safe
(registration.cc:1676-1691): the kernel applies them itself, so a CUDA call
is two allocations and one launch, with no other device operation.

`use_warm` is a flag on the device: a 0-d bool tensor whose byte the kernel
reads, so a launch captured into a CUDA graph follows the flag's value at
each replay. A Python bool is accepted too and becomes such a tensor
(utils.scalars.device_flag: one cached per device and value).

A pair axis: with a (P, 3, 3) warm rotation and a (P,) `use_warm`, the B
hypotheses are P pairs' B / P each, in pair order, and each takes its own
pair's warm rotation and flag, in one launch (P = 1 is the shared warm
start). The front door calls a PyTorch custom operator whose vmap rule
moves the vmapped axis into that pair axis (ops/_axis.py), so
`torch.func.vmap` over a solve (solver/fused.py's batched plan) makes one
launch for all its pairs, as `jax.vmap` over the JAX package's `gnc_batch`
does.

Which version runs is decided by where the tensors lie: CPU tensors take
`gnc_batch_reference`; CUDA tensors launch the kernel (`ops._build.launch`)
or raise.

The kernel computes each rotation by shifted power iteration and nothing
else, as the Pallas kernel does. The exact eigenvector that
`SolverParams.gnc_rot_method="eigh"` asks for is not this function's to give:
`solver.basic.rotation_batch`, which owns the choice of the rotation
estimator, calls `gnc_batch_reference` itself for that setting and counts it
there.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p

import torch

from psulvsb_tpu_torch.ops._axis import check_input, register_pair_vmap
from psulvsb_tpu_torch.ops._build import launch
from psulvsb_tpu_torch.rotation.gnc import floor_noise_sq, gnc_tls_batched, tls_inliers
from psulvsb_tpu_torch.utils.scalars import device_flag

MAX_N = 2048  # the kernel keeps at most 8 columns per thread in registers
# gnc_batch_launch: src and its (batch, coordinate) strides, dst and its
# strides, mask and its batch stride, noise bounds and stride, warm
# rotations and their (pair, row, column) strides, the use_warm flags'
# bytes; hypotheses a pair, B, N, max_iterations; gnc_factor,
# cost_threshold; rotations, inliers, stream.
_ARGTYPES = (
    [c_void_p, c_longlong, c_longlong] * 2 + [c_void_p, c_longlong] * 2
    + [c_void_p, c_longlong, c_longlong, c_longlong] + [c_void_p] + [c_int] * 4
    + [c_float] * 2 + [c_void_p] * 3
)

def _check_shapes(src_tims_b: torch.Tensor, active_b: torch.Tensor) -> None:
    if src_tims_b.dim() != 3 or src_tims_b.shape[1] != 3:
        raise ValueError(f"TIMs must be (B, 3, N), got {tuple(src_tims_b.shape)}")
    b, _, n = src_tims_b.shape
    if b == 0 or n == 0:
        raise ValueError(f"gnc_batch needs B >= 1 and N >= 1, got B={b}, N={n}")
    if n > MAX_N:
        raise ValueError(f"gnc_batch serves N <= {MAX_N} TIMs, got N={n}")
    if tuple(active_b.shape) != (b, n):
        raise ValueError(f"active mask must be ({b}, {n}), got {tuple(active_b.shape)}")


def _pair_warm(warm_rotation: torch.Tensor, use_warm, b: int):
    """(P, 3, 3) warm rotations and (P,) bool flags on the warm rotation's
    device from a shared (3, 3) and a bool or 0-d flag (P = 1) or from P of
    each; B must split into P equal shares."""
    dev = warm_rotation.device
    if warm_rotation.dim() == 2:
        warm_rotation = warm_rotation[None]
    p = warm_rotation.shape[0]
    if warm_rotation.dim() != 3 or tuple(warm_rotation.shape[1:]) != (3, 3) or p == 0 or b % p:
        raise ValueError(f"warm_rotation must be (3, 3) or (P, 3, 3) with P dividing B = {b}, "
                         f"got {tuple(warm_rotation.shape)}")
    flag = use_warm if isinstance(use_warm, torch.Tensor) else device_flag(use_warm, dev)
    flag = flag.to(device=dev, dtype=torch.bool).reshape(-1)
    if flag.shape[0] == 1 and p > 1:
        flag = flag.expand(p)
    if flag.shape[0] != p:
        raise ValueError(f"use_warm must be one flag or {p}, got {tuple(flag.shape)}")
    return warm_rotation, flag


def gnc_batch_reference(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N)
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3) shared, or (P, 3, 3): one a pair
    use_warm,  # bool, or a 0-d bool tensor (then no host read), or (P,) bool
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
    rot_method: str = "power",
    early_exit: bool = True,
    repeat=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `gnc_batch` (rotation/gnc.py's loop, by default
    with the power-iteration rotation), with the same front-door rules. With
    `use_warm` a tensor, iteration 0 selects between the warm rotation and
    the solve on the device. With a pair axis (a (P, 3, 3) warm rotation)
    each hypothesis selects with its own pair's rotation and flag.
    `rot_method`, `early_exit`, `repeat`: as `rotation.gnc.gnc_tls_batched`
    takes them."""
    _check_shapes(src_tims_b, active_b)
    if warm_rotation.dim() == 3:
        warm, flag = _pair_warm(warm_rotation, use_warm, src_tims_b.shape[0])
        per = src_tims_b.shape[0] // warm.shape[0]
        warm_rotation = warm.repeat_interleave(per, 0)
        use_warm = flag.repeat_interleave(per, 0)[:, None, None]
    nb_sq = floor_noise_sq(noise_bound_b.to(torch.float32))
    rot, w, _, _ = gnc_tls_batched(
        src_tims_b.to(torch.float32), dst_tims_b.to(torch.float32), active_b,
        nb_sq, warm_rotation, use_warm,
        max_iterations, gnc_factor, cost_threshold, rot_method=rot_method,
        early_exit=early_exit, repeat=repeat,
    )
    return rot, tls_inliers(w, active_b)


def gnc_batch(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N)
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3) shared, or (P, 3, 3): one a pair
    use_warm,  # bool, or a 0-d bool tensor on the device, or (P,) bool
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch GNC-TLS front door. Returns (rotations (B, 3, 3), inliers
    (B, N) bool). CPU tensors run `gnc_batch_reference`; CUDA tensors run
    the kernel (no fallback): float32 TIMs, noise bounds and warm rotations,
    a bool mask, each with unit column stride, on one device; anything else
    raises. A (P, 3, 3) warm rotation and (P,) flags make the B hypotheses P
    pairs' B / P each (module docstring)."""
    _check_shapes(src_tims_b, active_b)
    warm, flag = _pair_warm(warm_rotation, use_warm, src_tims_b.shape[0])
    return torch.ops.psulvsb_tpu_torch.gnc_batch(
        src_tims_b, dst_tims_b, active_b, noise_bound_b, warm, flag, int(max_iterations),
        float(gnc_factor), float(cost_threshold),
    )


@torch.library.custom_op("psulvsb_tpu_torch::gnc_batch", mutates_args=())
def _gnc_batch_pairs(
    src_tims_b: torch.Tensor, dst_tims_b: torch.Tensor, active_b: torch.Tensor,
    noise_bound_b: torch.Tensor, warm_rotation: torch.Tensor, use_warm: torch.Tensor,
    max_iterations: int, gnc_factor: float, cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`gnc_batch` with (P, 3, 3) warm rotations and (P,) flags: the plain
    version on the CPU, one kernel launch on a card."""
    if not src_tims_b.is_cuda:
        return gnc_batch_reference(
            src_tims_b, dst_tims_b, active_b, noise_bound_b,
            warm_rotation if warm_rotation.shape[0] > 1 else warm_rotation[0],
            use_warm if use_warm.shape[0] > 1 else use_warm[0],
            max_iterations, gnc_factor, cost_threshold,
        )
    return _launch(src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation, use_warm,
                   max_iterations, gnc_factor, cost_threshold)


# n pairs of B hypotheses are n B hypotheses of n P warm starts; contiguous:
# the kernel reads columns at unit stride.
register_pair_vmap(_gnc_batch_pairs, 6, contiguous=True)


def _launch(src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation, use_warm,
            max_iterations, gnc_factor, cost_threshold):
    """One launch of csrc/gnc_batch.cu over (B, 3, N) TIMs, (P, 3, 3) warm
    rotations and (P,) flags."""
    b, _, n = src_tims_b.shape
    p = warm_rotation.shape[0]
    dev = src_tims_b.device
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("src_tims_b", src_tims_b, f32, (b, 3, n)), ("dst_tims_b", dst_tims_b, f32, (b, 3, n)),
        ("active_b", active_b, torch.bool, (b, n)), ("noise_bound_b", noise_bound_b, f32, (b,)),
        ("warm_rotation", warm_rotation, f32, (p, 3, 3)), ("use_warm", use_warm, torch.bool, (p,)),
    ):
        check_input(name, t, dtype, dev, shape)
    for name, t in (("src_tims_b", src_tims_b), ("dst_tims_b", dst_tims_b), ("active_b", active_b)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit column stride, got strides {t.stride()}")
    if use_warm.stride(0) != 1 and p > 1:
        use_warm = use_warm.contiguous()
    rot = torch.empty((b, 3, 3), dtype=f32, device=dev)
    inliers = torch.empty((b, n), dtype=torch.bool, device=dev)
    launch(
        "gnc_batch", _ARGTYPES, dev,
        src_tims_b.data_ptr(), src_tims_b.stride(0), src_tims_b.stride(1),
        dst_tims_b.data_ptr(), dst_tims_b.stride(0), dst_tims_b.stride(1),
        active_b.data_ptr(), active_b.stride(0),
        noise_bound_b.data_ptr(), noise_bound_b.stride(0),
        warm_rotation.data_ptr(), warm_rotation.stride(0), warm_rotation.stride(1),
        warm_rotation.stride(2), use_warm.data_ptr(), b // p, b, n, int(max_iterations),
        float(gnc_factor), float(cost_threshold), rot.data_ptr(), inliers.data_ptr(),
    )
    return rot, inliers
