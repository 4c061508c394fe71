"""Degree of every correspondence in the length-consistency graph, GROR's
node reliability: the CUDA kernel `csrc/consistency_degree.cu` and its plain
PyTorch version.

`consistency_degree` keeps the signature of the JAX package's front door
(psulvsb_tpu/ops/pallas_pairs.py::consistency_degree): points as (3, C), an
optional (C,) active mask, degrees as (C,) int32. Distances come from direct
differences, the squares summed x, y, z; the kernel computes them bit for
bit as the plain version does, so the degrees are equal (the Pallas kernel
takes |a|^2 + |b|^2 - 2ab, which can move a pair at the window's edge).

A pair axis, as `ops.hist.exact_peak_bin` has one: (P, 3, C) clouds and a
(P, C) mask give (P, C) degrees, each pair's what its call alone gives, from
one launch. The front door calls a PyTorch custom operator whose vmap rule
moves the vmapped axis into that pair axis (ops/_axis.py), so
`torch.func.vmap` over GROR (solver/fused.py's batched plan) makes one
launch for all its pairs, as `jax.vmap` over the JAX package's front door
does.

Which version runs is decided by where the tensors lie: CPU tensors take
the plain version; CUDA tensors launch the kernel (`ops._build.launch`) or
raise.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from psulvsb_tpu_torch.ops._axis import as_pairs, check_active, kernel_clouds, register_pair_vmap
from psulvsb_tpu_torch.ops._build import launch

# consistency_degree_launch: src, dst, mask (null: all active), C, pairs,
# tau, degrees, stream.
_ARGTYPES = [c_void_p] * 3 + [c_int, c_int, c_float, c_void_p, c_void_p]
_ROW_CHUNK = 512  # rows per step of the plain version's sweep


def _check_nonempty(src: torch.Tensor) -> None:
    if src.dim() in (2, 3) and src.shape[-1] == 0:
        raise ValueError("consistency_degree needs C >= 1 correspondences, got C = 0")


def consistency_degree_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    tau: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `consistency_degree`, (3, C) or (P, 3, C)."""
    _check_nonempty(src)
    active = check_active(src, dst, active, pairs=src.dim() == 3)
    c = src.shape[-1]
    s = src.to(torch.float32)
    d = dst.to(torch.float32)
    tau32 = torch.full((), tau, dtype=torch.float32, device=src.device)
    cols = torch.arange(c, device=src.device)

    def dist(p, r0, r1):
        e = p[..., r0:r1, None] - p[..., None, :]  # (..., 3, rows, C): p_i - p_j
        x, y, z = e.unbind(-3)
        return torch.sqrt((x * x + y * y) + z * z)

    out = []
    for r0 in range(0, c, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, c)
        ok = torch.abs(dist(s, r0, r1) - dist(d, r0, r1)) < tau32
        ok = ok & active[..., None, :] & (cols[r0:r1, None] != cols[None, :])
        out.append(torch.where(active[..., r0:r1], ok.sum(-1), 0))
    return torch.cat(out, dim=-1).to(torch.int32)


def consistency_degree(
    src: torch.Tensor,
    dst: torch.Tensor,
    tau: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """deg[i] = #{j != i, both active : | |s_i - s_j| - |t_i - t_j| | < tau}
    (strict), tau rounded to float32; inactive rows give 0. src/dst (3, C),
    1 <= C <= 2^20. Returns (C,) int32. CPU tensors run the plain version;
    CUDA tensors the kernel (no fallback): one allocation and one call,
    which zeroes the degrees on the stream and launches the kernel.

    A pair axis: (P, 3, C) clouds and an optional (P, C) mask give (P, C)
    degrees from one launch (`torch.func.vmap` over the (3, C) form comes
    here too, through the operator's vmap rule)."""
    _check_nonempty(src)
    src, dst, active, single = as_pairs(src, dst, active)
    deg = torch.ops.psulvsb_tpu_torch.consistency_degree(src, dst, active, float(tau))
    return deg[0] if single else deg


@torch.library.custom_op("psulvsb_tpu_torch::consistency_degree", mutates_args=())
def _consistency_degree_pairs(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None, tau: float,
) -> torch.Tensor:
    """`consistency_degree` over (P, 3, C) clouds: the plain version on the
    CPU, one launch of the kernel for the P pairs on a card."""
    if not src.is_cuda:
        return consistency_degree_reference(src, dst, tau, active)
    dev = src.device
    s, d, a = kernel_clouds(src, dst, active, pairs=True)
    p, _, c = s.shape
    deg = torch.empty((p, c), dtype=torch.int32, device=dev)
    launch("consistency_degree", _ARGTYPES, dev,
           s.data_ptr(), d.data_ptr(), None if a is None else a.data_ptr(), c, p, float(tau),
           deg.data_ptr())
    return deg


register_pair_vmap(_consistency_degree_pairs, 3)
