"""psulvsb_tpu_torch — the PSULVSB point-cloud registration solver on
PyTorch, with its GNC-TLS loop, its pair-grid sweeps and GROR's
consistency degrees in CUDA kernels for NVIDIA Hopper.

A port of the JAX package `psulvsb_tpu`, which stays the reference: the
modules mirror its paths and names. This package imports torch and numpy
only. It runs the solve at every setting of `SolverParams` (known or
estimated scale, any C, the clique stages with the greedy or the native exact
search, GROR initial alignment, the translation rescue, GNC-TLS or FGR
rotation), staged (`psulvsb_solve`) or as one dispatch of replayed CUDA
graphs (`psulvsb_register`), one pair or a batch of pairs
(`register_batch`), with or without the normal-angle pre-filter
(`solve_with_prefilter`); the classic decoupled solve
(`RobustRegistrationSolver.solve_decoupled`); the DRS optimality certifier
in float64 (`psulvsb_tpu_torch.certify`); the FPFH front end from raw
clouds to correspondences (`psulvsb_tpu_torch.frontend`, `io`); and the
evaluation harnesses over them (`psulvsb_tpu_torch.eval`: the synthetic
protocol, the dataset generator, the serial and the batched dataset sweep
with certification, the front-end protocol and the real-scan path).
"""

__version__ = "0.8.0"

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
    "__version__",
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
