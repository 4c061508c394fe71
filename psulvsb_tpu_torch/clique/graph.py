"""Graph type and MaxCliqueSolver facade (port of
psulvsb_tpu/clique/graph.py).

Equivalents of teaser::Graph (graph.h:29-207: adjacency-list graph over
consecutive integer vertices) and teaser::MaxCliqueSolver
(graph.h:219-274, graph.cc:12-125). The searches go to the core peeling and
the greedy of clique/kcore.py, on `device`, or to the native exact branch
and bound on the host (clique/pmc.py).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Graph:
    """Undirected graph, adjacency-list semantics of graph.h:29-207."""

    def __init__(self, adj_list: dict | None = None):
        self._adj: list[set[int]] = []
        if adj_list:
            self.populateVertices(max(adj_list) + 1)
            for v, edges in adj_list.items():
                for u in edges:
                    self.addEdge(v, u)

    def populateVertices(self, num: int) -> None:
        while len(self._adj) < num:
            self._adj.append(set())

    def addVertex(self, v: int) -> None:
        self.populateVertices(v + 1)

    def numVertices(self) -> int:
        return len(self._adj)

    def numEdges(self) -> int:
        return sum(len(s) for s in self._adj) // 2

    def hasVertex(self, v: int) -> bool:
        return 0 <= v < len(self._adj)

    def hasEdge(self, a: int, b: int) -> bool:
        return self.hasVertex(a) and b in self._adj[a]

    def addEdge(self, a: int, b: int) -> None:
        self.populateVertices(max(a, b) + 1)
        self._adj[a].add(b)
        self._adj[b].add(a)

    def removeEdge(self, a: int, b: int) -> None:
        if self.hasVertex(a):
            self._adj[a].discard(b)
        if self.hasVertex(b):
            self._adj[b].discard(a)

    def getVertices(self) -> list[int]:
        return list(range(len(self._adj)))

    def getEdges(self, v: int) -> list[int]:
        return sorted(self._adj[v])

    def getAdjMatrix(self) -> np.ndarray:
        n = len(self._adj)
        m = np.zeros((n, n), bool)
        for v, edges in enumerate(self._adj):
            for u in edges:
                m[v, u] = True
        return m


class CliqueSolverMode(enum.IntEnum):
    """graph.h CLIQUE_SOLVER_MODE."""

    PMC_EXACT = 0
    PMC_HEU = 1
    KCORE_HEU = 2


@dataclasses.dataclass
class MaxCliqueSolverParams:
    """graph.h:219-248 Params."""

    solver_mode: CliqueSolverMode = CliqueSolverMode.PMC_EXACT
    kcore_heuristic_threshold: float = 1.0
    time_limit: float = 3600.0
    num_threads: int = 12  # the reference hard-codes in.threads = 12
    solve_exactly: bool = True  # deprecated upstream


class MaxCliqueSolver:
    """Facade with graph.cc:12-125 dispatch semantics."""

    Params = MaxCliqueSolverParams
    CLIQUE_SOLVER_MODE = CliqueSolverMode

    def __init__(self, params: MaxCliqueSolverParams | None = None, device="cuda"):
        self.params = params or MaxCliqueSolverParams()
        self.device = torch.device(device)
        if not self.params.solve_exactly:
            self.params.solver_mode = CliqueSolverMode.PMC_HEU

    def findMaxClique(self, graph: Graph) -> list[int]:
        from psulvsb_tpu_torch.clique.kcore import core_numbers, greedy_clique
        from psulvsb_tpu_torch.clique.pmc import (
            exact_max_clique,
            exact_search_available,
            native_core_numbers,
            native_available,
        )

        adj = graph.getAdjMatrix()
        n = adj.shape[0]
        if n == 0:
            return []

        if native_available():
            cores = native_core_numbers(adj)
        else:
            cores = core_numbers(torch.as_tensor(adj, device=self.device))[0].cpu().numpy()
        max_core = int(cores.max()) if n else 0

        # KCORE_HEU shortcut (graph.cc:66-82): when the max core is large
        # relative to the vertex count, return the max k-core directly.
        if (
            self.params.solver_mode == CliqueSolverMode.KCORE_HEU
            and self.params.kcore_heuristic_threshold != 1
            and max_core > self.params.kcore_heuristic_threshold * n
        ):
            return [int(v) for v in np.where(cores >= max_core)[0]]

        if self.params.solver_mode == CliqueSolverMode.PMC_EXACT:
            # Degrade to the greedy heuristic only for a solver on the CPU
            # without a toolchain; on the card that raises, and a failing
            # build or library raises anywhere.
            if exact_search_available(self.device):
                return exact_max_clique(
                    adj,
                    time_limit_s=self.params.time_limit,
                    n_threads=self.params.num_threads,
                )

        # Heuristic modes: greedy clique seeded by core order (the PMC
        # heuristic's strategy, `heu_strat = "kcore"`, graph.cc:50).
        mask = greedy_clique(torch.as_tensor(adj, device=self.device))[0].cpu().numpy()
        return [int(v) for v in np.where(mask)[0]]
