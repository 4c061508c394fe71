"""Inlier selection by graph cores and cliques on dense consistency graphs,
on PyTorch.

Port of psulvsb_tpu/clique/kcore.py, the equivalent of
MaxCliqueSolver::findMaxClique (graph.cc:12-125): `core_numbers` (iterative
peeling), `max_kcore_mask` (KCORE_HEU), `triangle_scores` and
`greedy_clique` (PMC's heuristic clique, grown max-score-first, ordered by
core number unless the caller gives scores) and the mode dispatch
`max_clique_mask`, whose "exact" mode is the native branch and bound of
`clique/pmc.py`. Graphs are dense (N, N) bool matrices, symmetric, with an
optional leading batch dimension: the escalated clique round holds one graph
per hypothesis.
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


def core_numbers(
    adj: torch.Tensor, active: torch.Tensor | None = None, chunk: int = CHUNK
) -> tuple[torch.Tensor, int]:
    """Core number of every vertex by iterative peeling. adj: (..., N, N)
    bool, symmetric; the diagonal is ignored. Returns ((..., N) int64 core
    numbers, 0 on inactive vertices; host reads).

    One step removes every live vertex of degree below the level k (those
    take core number k - 1) or, when none is, moves k up to the least live
    degree plus one, the next level at which a vertex can fall. A step is one
    (N, N) product and a few selects, decided on the device; a graph needs at
    most N steps that remove and one that moves for each distinct core
    number. The host reads whether a vertex is left once per `chunk` steps,
    so the cost is ceil(steps / chunk) reads: 1 to 3 on the graphs of the
    classic solve's tests, a few tens at C = 1889."""
    n = adj.shape[-1]
    dev = adj.device
    if active is None:
        active = torch.ones(adj.shape[:-1], dtype=torch.bool, device=dev)
    alive = active.expand(adj.shape[:-1]).clone()
    a = (_mask_active(adj, alive) & ~torch.eye(n, dtype=torch.bool, device=dev)).to(torch.float32)
    k = torch.ones(adj.shape[:-2], dtype=torch.int64, device=dev)
    cores = torch.zeros(adj.shape[:-1], dtype=torch.int64, device=dev)
    reads = 0
    while n > 0:
        for _ in range(chunk):
            deg = mm(a, alive.to(torch.float32)[..., None])[..., 0].to(torch.int64)
            fall = alive & (deg < k[..., None])
            any_fall = fall.any(-1)
            cores = torch.where(fall, k[..., None] - 1, cores)
            alive = alive & ~fall
            # Nothing fell: every live vertex has core >= k, and none can fall
            # before the level of the least live degree plus one.
            least = torch.where(alive, deg, n).amin(-1)
            cores = torch.where(alive & ~any_fall[..., None], least[..., None], cores)
            k = torch.where(any_fall, k, least + 1)
        reads += 1
        if not bool(alive.any()):
            break
    return cores, reads


def max_kcore_mask(adj: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """Vertices whose core number equals the largest: the KCORE_HEU "clique"
    (graph.cc:72-82)."""
    cores, _ = core_numbers(adj, active)
    return cores == cores.amax(-1, keepdim=True)


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
    repeat=None,
    steps_run: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Greedy clique: start from the best-scored active vertex, then add the
    candidate (adjacent to every member so far) with the highest score until
    no candidate is left; ties go to the lower index, as jnp.argmax's do.

    adj: (..., N, N) bool; active: (..., N) bool or None; order_scores:
    (..., N), for example `triangle_scores`; by default the core numbers
    (PMC's `heu_strat = "kcore"`, graph.cc:50), whose peeling reads the host
    too (`core_numbers`). The steps run in
    chunks of `chunk`: a step whose candidate set is empty changes nothing,
    and the host reads whether any candidate is left once per chunk.
    With `max_steps` exactly that many steps run and the host reads nothing:
    the same clique whenever max_steps is at least the clique's size less
    one (N - 1 always is; a graph of E edges holds no clique beyond
    `max_clique_size_for_edges(E)` vertices).
    With `repeat` (`GraphControl.repeat` of solver/conditional.py, inside a
    CUDA graph capture: `repeat(flag, body)` runs `body`, which returns the
    next flag, while the flag holds) the chunks run in a loop on the device
    while any candidate is left, as the JAX package's `lax.while_loop`, and
    nothing is read on the host either; `steps_run`, an int64 tensor of the
    graphs' batch shape, then has each graph's steps added to it: the chunks
    that its own greedy needs, times `chunk` (a graph whose candidates ran
    out early is frozen while another's run on).

    Returns ((..., N) bool clique mask, host reads)."""
    reads = 0
    if order_scores is None:
        order_scores, reads = core_numbers(adj, active, chunk)
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

    if repeat is not None:
        # Each step writes its pick at its own column of buffers that
        # outlive the loop's body; the columns of steps that never ran keep
        # a best score of -inf. Every step removes a candidate, so at most
        # N - 1 steps run.
        width = n - 1 + chunk
        top_all = torch.full(adj.shape[:-2] + (width,), -torch.inf, device=dev)
        pick_all = torch.zeros(adj.shape[:-2] + (width,), dtype=torch.int64, device=dev)
        cand_now = cand.clone()
        done = torch.zeros((), dtype=torch.int64, device=dev)

        def body():
            c = cand_now
            for j in range(chunk):
                c = step(c)
                at = (done + j).reshape(1)
                top_all.index_copy_(-1, at, best.pop()[..., None])
                pick_all.index_copy_(-1, at, picked.pop()[..., None])
            cand_now.copy_(c)
            done.add_(chunk)
            return cand_now.any()

        repeat(cand_now.any(), body)
        if steps_run is not None:
            picks = (top_all > -torch.inf).sum(-1)
            steps_run.add_(torch.div(picks + chunk - 1, chunk, rounding_mode="floor") * chunk)
        best, picked = [top_all], [pick_all]
    elif max_steps is not None:
        for _ in range(max_steps):
            cand = step(cand)
    else:
        while True:
            for _ in range(chunk):
                cand = step(cand)
            reads += 1
            if not bool(cand.any()):
                break
    if repeat is not None:
        added = scatter_or(n, picked[0], best[0] > -torch.inf)
        clique = clique | added
    elif picked:
        added = scatter_or(n, torch.stack(picked, -1), torch.stack(best, -1) > -torch.inf)
        clique = clique | added
    return clique, reads


def max_clique_mask(
    adj: torch.Tensor,
    active: torch.Tensor | None = None,
    mode: str = "heu",
    time_limit_s: float = 3600.0,
) -> torch.Tensor:
    """The modes of MaxCliqueSolver::findMaxClique as (N,) masks: "kcore"
    (KCORE_HEU, the largest core), "heu" (PMC_HEU, the greedy on core
    ordering), "exact" (the native branch and bound of clique/pmc.py on the
    host: the graph is copied there and the mask comes back on adj's
    device)."""
    if mode == "kcore":
        return max_kcore_mask(adj, active)
    if mode == "heu":
        return greedy_clique(adj, active)[0]
    if mode == "exact":
        from psulvsb_tpu_torch.clique.pmc import exact_max_clique_mask

        mask = exact_max_clique_mask(
            adj.cpu().numpy(), None if active is None else active.cpu().numpy(), time_limit_s
        )
        return torch.as_tensor(mask, device=adj.device)
    raise ValueError(f"unknown clique mode {mode!r}")
