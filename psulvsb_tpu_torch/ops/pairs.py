"""Degree of every correspondence in the length-consistency graph, GROR's
node reliability: the CUDA kernel `csrc/consistency_degree.cu` and its plain
PyTorch version.

`consistency_degree` keeps the signature of the JAX package's front door
(psulvsb_tpu/ops/pallas_pairs.py::consistency_degree): points as (3, C), an
optional (C,) active mask, degrees as (C,) int32. Distances come from direct
differences, the squares summed x, y, z; the kernel computes them bit for
bit as the plain version does, so the degrees are equal (the Pallas kernel
takes |a|^2 + |b|^2 - 2ab, which can move a pair at the window's edge).

Which version runs is decided by where the tensors lie: CPU tensors take
the plain version; CUDA tensors launch the kernel or raise. Each launch
adds one to `KERNEL_LAUNCHES`.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from psulvsb_tpu_torch.ops._build import launcher
from psulvsb_tpu_torch.ops.hist import _check, _cuda_inputs

KERNEL_LAUNCHES = 0
# consistency_degree_launch: src, dst, mask (null: all active), C, tau,
# degrees, stream.
_ARGTYPES = [c_void_p] * 3 + [c_int, c_float, c_void_p, c_void_p]
_ROW_CHUNK = 512  # rows per step of the plain version's sweep


def _check_nonempty(src: torch.Tensor) -> None:
    if src.dim() == 2 and src.shape[1] == 0:
        raise ValueError("consistency_degree needs C >= 1 correspondences, got C = 0")


def consistency_degree_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    tau: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `consistency_degree`."""
    _check_nonempty(src)
    active = _check(src, dst, active)
    c = src.shape[1]
    s = src.to(torch.float32)
    d = dst.to(torch.float32)
    tau32 = torch.full((), tau, dtype=torch.float32, device=src.device)
    cols = torch.arange(c, device=src.device)

    def dist(p, r0, r1):
        e = p[:, r0:r1, None] - p[:, None, :]  # (3, rows, C): p_i - p_j
        return torch.sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])

    out = []
    for r0 in range(0, c, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, c)
        ok = torch.abs(dist(s, r0, r1) - dist(d, r0, r1)) < tau32
        ok = ok & active[None, :] & (cols[r0:r1, None] != cols[None, :])
        out.append(torch.where(active[r0:r1], ok.sum(1), 0))
    return torch.cat(out).to(torch.int32)


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
    which zeroes the degrees on the stream and launches the kernel."""
    global KERNEL_LAUNCHES
    if not src.is_cuda:
        return consistency_degree_reference(src, dst, tau, active)
    _check_nonempty(src)
    dev = src.device
    s, d, a = _cuda_inputs(src, dst, active)
    c = s.shape[1]
    deg = torch.empty(c, dtype=torch.int32, device=dev)
    fn = launcher("consistency_degree", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            s.data_ptr(), d.data_ptr(), None if a is None else a.data_ptr(), c, float(tau),
            deg.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"consistency_degree kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return deg
