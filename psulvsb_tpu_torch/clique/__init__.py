"""Inlier selection by greedy cliques (port of psulvsb_tpu.clique)."""

from psulvsb_tpu_torch.clique.kcore import greedy_clique, triangle_scores

__all__ = ["greedy_clique", "triangle_scores"]
