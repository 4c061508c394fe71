"""The pair axis that every kernel's operator takes: P pairs in one launch.

Each front door of ops/ calls a PyTorch custom operator over a leading pair
axis, a (3, C) pair becoming an axis of one. The operator's vmap rule joins
the vmapped axis into that pair axis (n calls of P pairs are n P pairs) and
splits every output again, so `torch.func.vmap` over a solve
(solver/fused.py's batched plan) makes one launch for all its pairs, as
`jax.vmap` over the JAX package's `pallas_call`s does. Here are the checks
of the clouds and masks, that join, the rule built on it, and `over_pairs`,
which runs a plain version for one pair over P.
"""

from __future__ import annotations

import torch


def check_clouds(src: torch.Tensor, dst: torch.Tensor, pairs: bool = False) -> None:
    want = "(P, 3, C)" if pairs else "(3, C)"
    if (src.dim() != 2 + pairs or src.shape[-2] != 3 or tuple(dst.shape) != tuple(src.shape)
            or (pairs and src.shape[0] == 0)):
        raise ValueError(
            f"src and dst must both be {want}, got {tuple(src.shape)} and {tuple(dst.shape)}"
        )
    if dst.device != src.device:
        raise ValueError(f"dst is on {dst.device}, expected {src.device}")


def check_active(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None,
                 pairs: bool = False) -> torch.Tensor:
    """Validate (3, C) inputs, or (P, 3, C) with `pairs`; return the (C,)
    or (P, C) bool active mask."""
    check_clouds(src, dst, pairs)
    shape = src.shape[:-2] + src.shape[-1:]
    if active is None:
        return torch.ones(shape, dtype=torch.bool, device=src.device)
    if active.shape != shape:
        raise ValueError(f"active must be {tuple(shape)}, got {tuple(active.shape)}")
    if active.device != src.device:
        raise ValueError(f"active is on {active.device}, expected {src.device}")
    return active.to(torch.bool)


def kernel_clouds(src, dst, active, pairs: bool = False):
    """Validate (3, C) inputs for a kernel, or (P, 3, C) with `pairs`; return
    the contiguous float32 clouds and the contiguous bool mask, whose bytes
    the kernel reads, or None for it when every point is active (the kernel
    then gets a null mask). No device operation when the inputs already are
    so."""
    f32 = torch.float32
    if active is None:
        check_clouds(src, dst, pairs)
        a = None
    else:
        a = check_active(src, dst, active, pairs).contiguous()
    return src.to(f32).contiguous(), dst.to(f32).contiguous(), a


def check_input(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                shape: tuple | None = None) -> torch.Tensor:
    """`t`, when it is `dtype` (of `shape`, where given) on `device`; else
    raises."""
    if t.device != device or t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
        want, got = (str(dtype), str(t.dtype)) if shape is None else (
            f"{dtype} {shape}", f"{t.dtype} {tuple(t.shape)}")
        raise ValueError(f"{name} must be {want} on {device}, got {got} on {t.device}")
    return t


def as_pairs(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None):
    """Validated (3, C) or (P, 3, C) clouds and an optional mask as the
    pair-axis form the operators take: (src, dst, active, single), single
    when a (3, C) pair became a pair axis of one."""
    single = src.dim() == 2
    if active is None:
        check_clouds(src, dst, pairs=not single)
    else:
        check_active(src, dst, active, pairs=not single)
    if single:
        src, dst = src[None], dst[None]
        active = None if active is None else active[None]
    return src, dst, active, single


def join_pairs(t: torch.Tensor, dim: int | None, n: int) -> torch.Tensor:
    """A vmapped (n, P, ...) argument (its vmapped axis at `dim`, or None:
    the same for all n) as (n P, ...)."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.flatten(0, 1)


def join_args(args, in_dims, n: int) -> list:
    """`join_pairs` of each argument (None stays None)."""
    return [None if t is None else join_pairs(t, d, n) for t, d in zip(args, in_dims)]


def split_pairs(out, n: int):
    """An operator's (n P, ...) output, a tensor or a tuple of them, as the
    vmap rule returns it: (n, P, ...) and its out_dims."""
    if isinstance(out, torch.Tensor):
        return out.unflatten(0, (n, -1)), 0
    return tuple(t.unflatten(0, (n, -1)) for t in out), (0,) * len(out)


def register_pair_vmap(op, k: int, contiguous: bool = False) -> None:
    """Give the custom operator `op` the vmap rule of jax.vmap over a
    pallas_call: its first `k` arguments, tensors with a leading pair axis
    or None, have the vmapped axis joined into that axis (made contiguous
    with `contiguous`), the rest pass as they are, and one call serves
    every pair."""

    def rule(info, in_dims, *args):
        n = info.batch_size
        joined = join_args(args[:k], in_dims, n)
        if contiguous:
            joined = [None if t is None else t.contiguous() for t in joined]
        return split_pairs(op(*joined, *args[k:]), n)

    op.register_vmap(rule)


def over_pairs(fn, p: int, *args) -> tuple:
    """A plain version `fn` for one pair over P pairs' arguments (None: an
    argument the pairs share): one call at P = 1, else torch.func.vmap."""
    if p == 1:
        return tuple(t[None] for t in fn(*(None if a is None else a[0] for a in args)))
    dims = tuple(None if a is None else 0 for a in args)
    return tuple(torch.func.vmap(fn, in_dims=dims)(*args))
