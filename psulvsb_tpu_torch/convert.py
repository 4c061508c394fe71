"""Carry configurations and solver state across from the JAX package.

Nothing here imports JAX or psulvsb_tpu: a JAX `SolverParams` is read
through `dataclasses.fields`, and JAX state arrives as numpy arrays (for
example `jax.tree.map(np.asarray, state)`), so the tests can start both
packages from the same configuration and the same state.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from psulvsb_tpu_torch.gror.gror import GRORResult
from psulvsb_tpu_torch.solver.basic import WarmState
from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.psulvsb import HostState

_PORT_FIELDS = {f.name: f for f in dataclasses.fields(SolverParams)}


def params_from_jax(p) -> SolverParams:
    """The port's SolverParams with every field of the JAX SolverParams `p`;
    enum fields are mapped by their integer value."""
    kw = {}
    for f in dataclasses.fields(p):
        if f.name not in _PORT_FIELDS:
            raise ValueError(f"JAX SolverParams field {f.name!r} has no port counterpart")
        value = getattr(p, f.name)
        default = _PORT_FIELDS[f.name].default
        if isinstance(default, enum.IntEnum):
            value = type(default)(int(value))
        kw[f.name] = value
    return SolverParams(**kw)


def _fields(d) -> dict:
    """A mapping, or a NamedTuple (such as a JAX carry), as a dict."""
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def warm_state_from_numpy(d, device="cpu") -> WarmState:
    """WarmState from numpy arrays keyed by field name."""
    d = _fields(d)
    f32 = torch.float32
    return WarmState(
        scale=_tensor(d["scale"], device, f32),
        rotation=_tensor(d["rotation"], device, f32),
        translation=_tensor(d["translation"], device, f32),
        first_time=_tensor(d["first_time"], device, torch.bool),
    )


def gror_result_from_numpy(d, device="cpu") -> GRORResult:
    """GRORResult from numpy arrays keyed by field name."""
    d = _fields(d)
    f32 = torch.float32
    return GRORResult(
        rotation=_tensor(d["rotation"], device, f32),
        translation=_tensor(d["translation"], device, f32),
        best_count=_tensor(d["best_count"], device, torch.int64),
        inliers=_tensor(d["inliers"], device, torch.bool),
    )


def host_state_from_numpy(d, device) -> HostState:
    """HostState from numpy arrays keyed by field name; `best` is a nested
    WarmState mapping."""
    d = _fields(d)
    i64, f32 = torch.int64, torch.float32
    return HostState(
        inlier_counter=_tensor(d["inlier_counter"], device, i64),
        inlier_history=_tensor(d["inlier_history"], device, i64),
        residual_history=_tensor(d["residual_history"], device, f32),
        final_inliers=_tensor(d["final_inliers"], device, i64),
        keep_mask=_tensor(d["keep_mask"], device, i64),
        active=_tensor(d["active"], device, torch.bool),
        inl_kept=_tensor(d["inl_kept"], device, torch.bool),
        best=warm_state_from_numpy(d["best"], device),
        best_count=_tensor(d["best_count"], device, i64),
        host_r=_tensor(d["host_r"], device, i64),
        pro_host=_tensor(d["pro_host"], device, f32),
    )
