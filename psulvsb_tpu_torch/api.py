"""User-facing API mirroring teaser::RobustRegistrationSolver
(registration.h:326-832): construct with params, call solve(src, dst),
query getSolution() and the inlier getters. `register_pair` is the
functional entry point.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.psulvsb import psulvsb_solve
from psulvsb_tpu_torch.solver.solution import RegistrationSolution


def register_pair(
    src,
    dst,
    params: SolverParams,
    generator: torch.Generator | None = None,
    keep_mask=None,
    device="cuda",
) -> tuple[RegistrationSolution, dict]:
    """Functional PSULVSB registration of one correspondence set.

    src/dst: (3, C) points and keep_mask, an optional (C,) {1, 0, -1}
    pre-filter mask (default: all kept), as tensors or numpy arrays. All are
    moved to `device` and the solve runs there: the card unless the caller
    asks for the CPU (device="cpu"). With no CUDA device the move raises;
    nothing falls back to the CPU. `generator` must be a generator of that
    device; psulvsb_solve makes one there when none is given."""
    device = torch.device(device)
    src = _as_float32(src).to(device)
    dst = _as_float32(dst).to(device)
    if keep_mask is None:
        keep_mask = torch.ones(src.shape[1], dtype=torch.int64, device=device)
    else:
        keep_mask = torch.as_tensor(keep_mask).to(device)
    return psulvsb_solve(src, dst, keep_mask, params, generator)


def _as_float32(x) -> torch.Tensor:
    """Input points as a float32 tensor on their own device; float64 input
    is downcast with a warning (the port runs float32 throughout)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        warnings.warn(
            "float64 input downcast to float32: psulvsb_tpu_torch solves in float32",
            stacklevel=3,
        )
    return t.to(torch.float32)


class RobustRegistrationSolver:
    """Class-shaped facade over the functional solver (parity with
    registration.h:326-832).

    Every input, numpy or tensor, is moved to `device` and the solve runs
    there: the card unless the caller asks for the CPU (device="cpu"). With
    no CUDA device the move raises; nothing falls back to the CPU. Each
    solve draws from its own generator, seeded from a CPU generator seeded
    with `seed`."""

    Params = SolverParams

    def __init__(self, params: SolverParams | None = None, seed: int = 0, device="cuda"):
        self.params = params or SolverParams()
        self.device = torch.device(device)
        self._seeds = torch.Generator().manual_seed(seed)
        self._solution: RegistrationSolution | None = None
        self._info: dict = {}

    def _next_generator(self, device: torch.device) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (1,), generator=self._seeds))
        return torch.Generator(device=device).manual_seed(seed)

    def reset(self, params: SolverParams) -> None:
        """registration.h:747-783 — reinitialize with new params."""
        self.params = params
        self._solution = None
        self._info = {}

    def solve(self, src, dst, correspondences=None, keep_mask=None) -> RegistrationSolution:
        """solve(src_points, dst_points, correspondences) with (3, N) clouds
        and (i, j) index pairs (registration.cc:511-524), or solve(src_corr,
        dst_corr) with pre-matched (3, C) sets (registration.cc:622)."""
        device = self.device
        src = _as_float32(src).to(device)
        dst = _as_float32(dst).to(device)
        if correspondences is not None:
            corr = torch.as_tensor(np.asarray(correspondences, dtype=np.int64), device=device)
            src = src[:, corr[:, 0]]
            dst = dst[:, corr[:, 1]]
        keep = (
            None if keep_mask is None
            else torch.as_tensor(np.asarray(keep_mask), dtype=torch.int64, device=device)
        )
        sol, info = register_pair(
            src, dst, self.params, self._next_generator(device), keep_mask=keep, device=device
        )
        self._solution = sol
        self._info = info
        return sol

    def solve_decoupled(self, src, dst) -> RegistrationSolution:
        raise NotImplementedError(
            "solve_decoupled (solver/classic.py) is not ported yet: "
            "ROADMAP.md Queue 1 item 11"
        )

    # --- getters mirroring registration.h:600-746 --------------------------
    def getSolution(self) -> RegistrationSolution:
        if self._solution is None:
            raise RuntimeError("call solve() first")
        return self._solution

    def getInlierCounter(self):
        return self._info.get("inlier_counter")

    def getFinalInliers(self):
        return self._info.get("final_inliers")

    def _mask(self, name: str):
        if self._solution is None:
            raise RuntimeError("call solve() first")
        m = self._info.get(name)
        if m is None:
            raise RuntimeError(f"{name} not produced by the last solve")
        return m

    def getScaleInliersMask(self):
        """(L,) bool over the winning basic TIM set (registration.h:618)."""
        return self._mask("scale_inliers")

    def getRotationInliersMask(self):
        """(L,) bool over the winning basic TIM set (registration.h:661)."""
        return self._mask("rotation_inliers")

    def getTranslationInliersMask(self):
        """(C,) bool over points (registration.h:697)."""
        return self._mask("translation_inliers")

    def getBasicTIMEndpoints(self):
        """(i, j) point indices of the winning basic TIM set, the map the
        TIM-level masks index through."""
        return self._mask("basic_tims_i"), self._mask("basic_tims_j")
