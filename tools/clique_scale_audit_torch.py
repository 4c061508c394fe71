"""Greedy-vs-exact clique audit of the PyTorch port at reference scale.

The counterpart of tools/clique_scale_audit.py, on its 16 cases: C in
{2000, 5000}, 95% and 93% mismatch and 90% and 95% clustered outliers, each
on the known-scale beta window and on the scale-estimation ratio-histogram
window. The graphs are the solver's own, `dense_consistency_adjacency` (the
exact (C, C) membership grid the escalation seed builds), built on the card;
the core-ordered and triangle-ordered greedy cliques (`clique/kcore.py`) run
on the card too, and the exact column is the native branch and bound on the
host (`clique/pmc.py::exact_max_clique`, the port's g++ build of
native/maxclique.cpp). The pairs come from the port's numpy
`make_synthetic_pair`, so the graphs are not the JAX audit's.

Usage:
    python tools/clique_scale_audit_torch.py [--out docs/CLIQUE_AUDIT_torch.md]
        [--time-limit 600] [--device cuda]
The graphs and the greedy run on the card unless `--device cpu` is given;
without a card the tool exits at once and says why. An exact search that
reaches `--time-limit` returns the best clique found so far, and the table
marks its size as a lower bound.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import card_line  # noqa: E402

from psulvsb_tpu_torch.clique.kcore import greedy_clique, triangle_scores  # noqa: E402
from psulvsb_tpu_torch.clique.pmc import exact_max_clique, native_available  # noqa: E402
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud  # noqa: E402
from psulvsb_tpu_torch.solver.config import SolverParams  # noqa: E402
from psulvsb_tpu_torch.solver.fused import resolve_device  # noqa: E402
from psulvsb_tpu_torch.solver.psulvsb import dense_consistency_adjacency  # noqa: E402

SIZES = (2000, 5000)
RATES = ((0.95, "mismatch"), (0.93, "mismatch"), (0.9, "clustered"), (0.95, "clustered"))
TIME_LIMIT_S = 600.0


def case_pair(c: int, rate: float, mode: str, seed: int):
    """The audit's pair of C correspondences (noise 0.01, translations up to 2)."""
    base = synthetic_cloud(c, seed=seed)
    return make_synthetic_pair(
        np.random.default_rng(seed * 7919 + 13), base, noise_bound=0.01, outlier_rate=rate,
        max_translation=2.0, outlier_mode=mode,
    )


def case_adjacency(pair, estimate_scaling: bool, device) -> torch.Tensor:
    """The solver's (C, C) consistency graph of `pair` at the caps of the
    full-scale sweep. On the ratio window the pool that fixes the peak is
    the chain of true inliers (the stage receives peak ±1 window members; the
    chain is a faithful stand-in for the audit)."""
    params = SolverParams.preset_3dmatch(
        estimate_scaling=estimate_scaling, sampled_cap=2048, basic_cap=256, hypothesis_batch=4,
    )
    src = torch.as_tensor(np.array(pair.src, np.float32), device=device)
    dst = torch.as_tensor(np.array(pair.dst, np.float32), device=device)
    c = src.shape[1]
    if estimate_scaling:
        inl = np.where(~np.asarray(pair.outlier_mask))[0]
        ri = torch.as_tensor(inl[:-1], dtype=torch.int64, device=device)
        rj = torch.as_tensor(inl[1:], dtype=torch.int64, device=device)
        rp = torch.full((), ri.shape[0], dtype=torch.int64, device=device)
    else:
        ri = rj = torch.zeros(1, dtype=torch.int64, device=device)
        rp = torch.zeros((), dtype=torch.int64, device=device)
    active = torch.ones(c, dtype=torch.bool, device=device)
    return dense_consistency_adjacency(src, dst, ri, rj, rp, params, active)


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def greedy_sizes(adj: torch.Tensor) -> dict:
    """Core-ordered and triangle-ordered greedy clique sizes of `adj`, each
    with its wall to a device synchronisation."""
    dev = adj.device
    (core, _), t_core = _timed(lambda: greedy_clique(adj), dev)
    (tri, _), t_tri = _timed(lambda: greedy_clique(adj, order_scores=triangle_scores(adj)), dev)
    return {"core_greedy": int(core.sum()), "tri_greedy": int(tri.sum()),
            "t_core_s": round(t_core, 3), "t_tri_s": round(t_tri, 3)}


def audit_case(c, rate, mode, estimate_scaling, seed, time_limit_s=TIME_LIMIT_S, device="cuda"):
    """One row of the audit: the graph and the greedy cliques on `device`,
    the exact search on the host."""
    device = resolve_device(device)
    pair = case_pair(c, rate, mode, seed)
    adj = case_adjacency(pair, estimate_scaling, device)
    row = greedy_sizes(adj)
    adj_np = adj.cpu().numpy()
    t0 = time.monotonic()
    exact = len(exact_max_clique(adj_np, time_limit_s=time_limit_s))
    t_exact = time.monotonic() - t0
    return {
        "C": c, "rate": rate, "mode": mode,
        "window": "ratio-hist" if estimate_scaling else "beta",
        "inliers": int((~np.asarray(pair.outlier_mask)).sum()),
        "core_greedy": row["core_greedy"], "tri_greedy": row["tri_greedy"], "exact": exact,
        "exact_timed_out": t_exact >= time_limit_s,
        "ratio": round(row["tri_greedy"] / max(exact, 1), 4),
        "t_core_s": row["t_core_s"], "t_tri_s": row["t_tri_s"], "t_exact_s": round(t_exact, 2),
        "edges": int(adj_np.sum()) // 2,
    }


def warm_up(device: torch.device) -> None:
    """First calls (library loads, the card's first products) outside the
    timed greedy runs."""
    adj = case_adjacency(case_pair(64, 0.5, "mismatch", 0), False, device)
    greedy_sizes(adj)


def render(cases: list[dict], card: str, time_limit_s: float) -> str:
    limit_note = (
        f"{time_limit_s:g} s budget, JAX's own" if time_limit_s >= TIME_LIMIT_S else
        f"a {time_limit_s:g} s budget, below JAX's {TIME_LIMIT_S:g} s"
    )
    lines = [
        "# Greedy-vs-exact clique at reference scale (PyTorch port)",
        "",
        "Graphs are the solver's own (`dense_consistency_adjacency`, the exact (C, C)",
        "membership grid the escalation seed builds) at the full-scale regime: C in",
        "{2000, 5000}, 90-95% outliers, mismatch and clustered, both membership windows.",
        "The graphs and the greedy cliques ran on the card; exact = the native branch and",
        f"bound on the host (`native/maxclique.cpp`, 12 threads), {limit_note}; a size",
        "marked >= is the best clique found when the search reached its budget.",
        "Generated by `tools/clique_scale_audit_torch.py`.",
        "",
        f"Card: {card}. The pairs come from the port's numpy `make_synthetic_pair` with the",
        "JAX audit's seeds, so these graphs are not the ones of docs/CLIQUE_AUDIT.md;",
        "compare the two tables as regimes, not row by row. The greedy times are walls",
        "to a device synchronisation on the card.",
        "",
        "| C | rate | mode | window | inliers | core-greedy | tri-greedy | exact | tri/exact"
        " | t_core s (card) | t_tri s (card) | t_exact s (host) | edges |",
        "|---|------|------|--------|---------|-------------|-----------|-------|-----------"
        "|-----------------|----------------|------------------|-------|",
    ]
    for r in cases:
        exact = f">= {r['exact']}" if r["exact_timed_out"] else str(r["exact"])
        ratio = f"<= {r['ratio']}" if r["exact_timed_out"] else str(r["ratio"])
        lines.append(
            f"| {r['C']} | {r['rate']} | {r['mode']} | {r['window']} | {r['inliers']} |"
            f" {r['core_greedy']} | {r['tri_greedy']} | {exact} | {ratio} | {r['t_core_s']} |"
            f" {r['t_tri_s']} | {r['t_exact_s']} | {r['edges']} |"
        )
    worst = min(r["ratio"] for r in cases)
    worst_core = min(r["core_greedy"] / max(r["exact"], 1) for r in cases)
    timed_out = sum(r["exact_timed_out"] for r in cases)
    lines += [
        "",
        f"Worst triangle-greedy/exact ratio over the sweep: **{worst}**; core-number greedy",
        f"bottomed at {worst_core:.4f}. Exact searches that reached the budget: {timed_out} of"
        f" {len(cases)} (their ratios are upper bounds).",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/CLIQUE_AUDIT_torch.md")
    ap.add_argument("--time-limit", type=float, default=TIME_LIMIT_S,
                    help="seconds of one exact search (default JAX's 600)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the graphs and the greedy (default cuda)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"clique_scale_audit_torch: {e}; pass --device cpu to run on the host",
              file=sys.stderr)
        return 1
    if not native_available():
        print("clique_scale_audit_torch: the native exact clique library cannot be built "
              "(g++ or native/maxclique.cpp missing)", file=sys.stderr)
        return 1

    warm_up(device)
    cases = []
    for c in SIZES:
        for rate, mode in RATES:
            for es in (False, True):
                cases.append(audit_case(c, rate, mode, es, seed=c + int(rate * 100),
                                        time_limit_s=args.time_limit, device=device))
                print(cases[-1], flush=True)
    with open(args.out, "w") as f:
        f.write(render(cases, card_line() if device.type == "cuda" else "cpu", args.time_limit))
    print(f"wrote {args.out}; worst ratio {min(r['ratio'] for r in cases)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
