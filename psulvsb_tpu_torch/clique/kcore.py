"""Greedy clique search on dense consistency graphs, on PyTorch.

Port of the two functions of psulvsb_tpu/clique/kcore.py that the solver
calls: `triangle_scores` (the greedy's vertex ordering) and `greedy_clique`
(PMC's heuristic clique, graph.cc:12-125, grown max-score-first). Graphs are
dense (N, N) bool matrices, symmetric, with an optional leading batch
dimension: the escalated clique round holds one graph per hypothesis.
"""

from __future__ import annotations

import math

import torch

from psulvsb_tpu_torch.robust.translation import scatter_or
from psulvsb_tpu_torch.utils.precision import mm

CHUNK = 32  # guarded greedy steps between two host reads


def _mask_active(adj: torch.Tensor, active: torch.Tensor | None) -> torch.Tensor:
    if active is None:
        return adj
    return adj & active[..., None, :] & active[..., :, None]


def triangle_scores(adj: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """Per-vertex triangle count diag(A^3) over (..., N, N) graphs: two
    float32 products, exact while the counts stay below 2^24. Triangle
    ordering separates a dense noise region from the inlier clique where
    degree or core number cannot (docs/CLIQUE_AUDIT.md)."""
    a = _mask_active(adj, active).to(torch.float32)
    return (mm(a, a) * a).sum(-1)


def max_clique_size_for_edges(edges: int) -> int:
    """The largest k with k (k - 1) / 2 <= edges: no graph of that many
    edges holds a larger clique."""
    return int((1 + math.isqrt(1 + 8 * max(edges, 0))) // 2)


def greedy_clique(
    adj: torch.Tensor,
    active: torch.Tensor | None = None,
    order_scores: torch.Tensor | None = None,
    chunk: int = CHUNK,
    max_steps: int | None = None,
) -> tuple[torch.Tensor, int]:
    """Greedy clique: start from the best-scored active vertex, then add the
    candidate (adjacent to every member so far) with the highest score until
    no candidate is left; ties go to the lower index, as jnp.argmax's do.

    adj: (..., N, N) bool; active: (..., N) bool or None; order_scores:
    (..., N), for example `triangle_scores` (core-number ordering waits for
    the port of core_numbers, ROADMAP Queue 1 item 11). The steps run in
    chunks of `chunk`: a step whose candidate set is empty changes nothing,
    and the host reads whether any candidate is left once per chunk.
    With `max_steps` exactly that many steps run and the host reads nothing:
    the same clique whenever max_steps is at least the clique's size less
    one (N - 1 always is; a graph of E edges holds no clique beyond
    `max_clique_size_for_edges(E)` vertices).

    Returns ((..., N) bool clique mask, host reads)."""
    if order_scores is None:
        raise NotImplementedError(
            "greedy_clique needs order_scores: core-number ordering is not "
            "ported yet (ROADMAP.md Queue 1 item 11)"
        )
    n = adj.shape[-1]
    dev = adj.device
    if active is None:
        active = torch.ones(adj.shape[:-1], dtype=torch.bool, device=dev)
    active = active.expand(adj.shape[:-1])
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj = _mask_active(adj, active) & ~eye
    scores = torch.where(active, order_scores.to(torch.float32), -torch.inf)
    ar = torch.arange(n, device=dev)

    def row(v):  # adj[..., v, :] for a (...,) index tensor
        idx = v[..., None, None].expand(*v.shape, 1, n)
        return torch.gather(adj, -2, idx)[..., 0, :]

    seed = torch.argmax(scores, dim=-1)
    clique = (ar == seed[..., None]) & torch.gather(active, -1, seed[..., None])
    cand = row(seed) & active
    # A step is four device operations: the best candidate and its score in
    # one reduction (the first maximum, as argmax), its row, the new
    # candidates. Candidates are active, so their scores are finite and a
    # step with none left shows as a best score of -inf; the members are
    # scattered into the mask once, after the last step.
    best, picked = [], []

    def step(cand):
        top, v = torch.max(torch.where(cand, scores, -torch.inf), dim=-1)
        best.append(top)
        picked.append(v)
        return cand & row(v)

    reads = 0
    if max_steps is not None:
        for _ in range(max_steps):
            cand = step(cand)
    else:
        while True:
            for _ in range(chunk):
                cand = step(cand)
            reads += 1
            if not bool(cand.any()):
                break
    if picked:
        added = scatter_or(n, torch.stack(picked, -1), torch.stack(best, -1) > -torch.inf)
        clique = clique | added
    return clique, reads
