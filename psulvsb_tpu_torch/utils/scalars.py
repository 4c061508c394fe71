"""Scalars and flags as 0-d tensors made on the device.

`torch.tensor(python_scalar, device="cuda")` copies from pageable host
memory, which a CUDA stream capture refuses. These helpers make the same
values with a fill, so a stage that uses them can be captured into a CUDA
graph; a tensor passes through, so a value that already lives on the device
costs nothing.
"""

from __future__ import annotations

import torch

_FLAGS: dict[tuple, torch.Tensor] = {}  # (device, value) -> 0-d bool tensor


def as_scalar(value, dtype, device) -> torch.Tensor:
    """`value` as a tensor of `dtype` on `device`; a Python number is rounded
    to `dtype` as torch.tensor rounds it."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def as_float32(x, device: torch.device) -> torch.Tensor:
    """A facade's input (tensor, numpy or a list) as float32 on `device`."""
    return torch.as_tensor(x).to(device, torch.float32)


def as_generator(generator_or_seed, device: torch.device) -> torch.Generator:
    """A generator on `device`: the caller's own, or a new one from a seed."""
    if isinstance(generator_or_seed, torch.Generator):
        if generator_or_seed.device.type != device.type:
            raise ValueError(
                f"the generator lies on {generator_or_seed.device}, the work runs on {device}"
            )
        return generator_or_seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(generator_or_seed))
    return gen


def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a 0-d index tensor, without the host read that
    x[i] makes (indexing by a 0-d tensor converts it to a Python int)."""
    return x.index_select(0, i.reshape(1))[0]


def device_flag(value, device) -> torch.Tensor:
    """`value` as a 0-d bool tensor on `device`: a tensor passes through
    (cast if need be), a Python bool takes a constant cached per device and
    value."""
    if isinstance(value, torch.Tensor):
        if value.dim() != 0:
            raise ValueError(f"a flag must be 0-d, got shape {tuple(value.shape)}")
        return value.to(device=device, dtype=torch.bool)
    device = torch.device(device)
    key = (device, bool(value))
    flag = _FLAGS.get(key)
    if flag is None:
        flag = torch.full((), bool(value), dtype=torch.bool, device=device)
        # A tensor made while a stream captures lives in that graph's pool:
        # it is not kept beyond the call.
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _FLAGS[key] = flag
    return flag
