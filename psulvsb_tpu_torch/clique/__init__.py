"""Inlier selection by graph cores and cliques (port of psulvsb_tpu.clique)."""

from psulvsb_tpu_torch.clique.graph import (
    CliqueSolverMode,
    Graph,
    MaxCliqueSolver,
    MaxCliqueSolverParams,
)
from psulvsb_tpu_torch.clique.kcore import (
    core_numbers,
    greedy_clique,
    max_clique_mask,
    max_kcore_mask,
    triangle_scores,
)

__all__ = [
    "CliqueSolverMode",
    "Graph",
    "MaxCliqueSolver",
    "MaxCliqueSolverParams",
    "core_numbers",
    "greedy_clique",
    "max_clique_mask",
    "max_kcore_mask",
    "triangle_scores",
]
