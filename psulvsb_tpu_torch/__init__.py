"""psulvsb_tpu_torch — the PSULVSB point-cloud registration solver on
PyTorch, with its GNC-TLS loop, its pair-grid sweeps and GROR's
consistency degrees in CUDA kernels for NVIDIA Hopper.

A port of the JAX package `psulvsb_tpu`, which stays the reference: the
modules mirror its paths and names. This package imports torch and numpy
only. It runs the solve at known or estimated scale, at any C, with the
clique stages, GROR initial alignment and the translation rescue, staged
(`psulvsb_solve`) or as one dispatch of replayed CUDA graphs
(`psulvsb_register`), one pair or a batch of pairs (`register_batch`), with
or without the normal-angle pre-filter (`solve_with_prefilter`);
`SolverParams.check_port_supported` names the settings that still raise.
"""

from psulvsb_tpu_torch.api import RobustRegistrationSolver, register_pair
from psulvsb_tpu_torch.eval.pipeline import solve_with_prefilter
from psulvsb_tpu_torch.parallel.pairs import (
    make_pair_mesh,
    register_batch,
    register_batch_sharded,
)
from psulvsb_tpu_torch.solver.config import (
    InlierGraphFormulation,
    InlierSelectionMode,
    RotationEstimationAlgorithm,
    SolverParams,
)
from psulvsb_tpu_torch.solver.fused import psulvsb_register
from psulvsb_tpu_torch.solver.psulvsb import psulvsb_solve
from psulvsb_tpu_torch.solver.solution import RegistrationSolution

__all__ = [
    "InlierGraphFormulation",
    "InlierSelectionMode",
    "RegistrationSolution",
    "RobustRegistrationSolver",
    "RotationEstimationAlgorithm",
    "SolverParams",
    "make_pair_mesh",
    "psulvsb_register",
    "psulvsb_solve",
    "register_batch",
    "register_batch_sharded",
    "register_pair",
    "solve_with_prefilter",
]
