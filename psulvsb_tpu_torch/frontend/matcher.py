"""Feature correspondence matcher (port of psulvsb_tpu/frontend/matcher.py;
teaser::Matcher, matcher.cc:22-335): FLANN kd-trees over FPFH features
become one feature-distance sweep a direction (frontend/knn.py), then the
reference's lazy mutual-NN initial matching, the optional cross-check, the
optional random tuple (triangle scale consistency) test, and dedup.

The reference's initial matching is asymmetric and lazy (matcher.cc:152-168):
every target point j contributes (nn_i(j), j); each source point i that was
ever hit also contributes (i, nn_j(i)). Replicated exactly; it matters for
the path without the cross-check.

The tuple test takes its random triads as an input (`draw_triads` makes
them from a torch.Generator), so the JAX package's triads can be fed in.
"""

from __future__ import annotations

import numpy as np
import torch

from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.utils.precision import pin_float32

TRIAD_CHUNK = 500_000  # triads a batch: bounds memory, not the number drawn


def normalize_points(
    src: np.ndarray, dst: np.ndarray, use_absolute_scale: bool
) -> tuple[np.ndarray, np.ndarray, float]:
    """Mean-center both clouds; divide by the largest point norm of either
    unless absolute scale is asked for (matcher.cc:56-114). Returns
    (src_n, dst_n, global_scale)."""
    out = []
    scale = 0.0
    for pts in (src, dst):
        centered = pts - pts.mean(axis=1, keepdims=True)
        scale = max(scale, float(np.linalg.norm(centered, axis=0).max()))
        out.append(centered)
    if not use_absolute_scale and scale > 0:
        out = [p / scale for p in out]
    return out[0], out[1], scale


class Matcher:
    """Class facade mirroring teaser::Matcher (matcher.h:18-63)."""

    def calculateCorrespondences(
        self,
        source_points,
        target_points,
        source_features,
        target_features,
        use_absolute_scale: bool = False,
        use_crosscheck: bool = True,
        use_tuple_test: bool = True,
        tuple_scale: float = 0.95,
        seed: int = 0,
        device="cuda",
    ) -> np.ndarray:
        """(M, 2) int array of (source_idx, target_idx) pairs."""
        return match_features(
            np.asarray(source_points), np.asarray(target_points),
            np.asarray(source_features), np.asarray(target_features),
            use_absolute_scale=use_absolute_scale, use_crosscheck=use_crosscheck,
            use_tuple_test=use_tuple_test, tuple_scale=tuple_scale, seed=seed, device=device,
        )


def draw_triads(ncorr: int, seed: int, device, chunk: int = TRIAD_CHUNK) -> list[torch.Tensor]:
    """The tuple test's ncorr * 100 random triads of correspondence indices,
    in (chunk, 3) batches, from a torch.Generator on `device` seeded by
    `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    trials = ncorr * 100
    return [
        torch.randint(0, ncorr, (min(chunk, trials - start), 3), generator=gen, device=device)
        for start in range(0, trials, chunk)
    ]


def match_features(
    source_points: np.ndarray,
    target_points: np.ndarray,
    source_features: np.ndarray,
    target_features: np.ndarray,
    use_absolute_scale: bool = False,
    use_crosscheck: bool = True,
    use_tuple_test: bool = True,
    tuple_scale: float = 0.95,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Functional matcher. Points (3, N) and features (N, 33), numpy; the
    feature sweeps and the tuple test run on `device` (the card unless the
    caller asks for the CPU), list compaction in numpy. Returns (M, 2)
    int64 (source_idx, target_idx) pairs, sorted and unique."""
    from psulvsb_tpu_torch.solver.fused import resolve_device

    device = resolve_device(device)
    pin_float32()
    src_n, dst_n, _ = normalize_points(
        source_points.astype(np.float32), target_points.astype(np.float32),
        use_absolute_scale,
    )
    # Cloud "i" is the one with MORE points (matcher.cc:122-127).
    swapped = dst_n.shape[1] > src_n.shape[1]
    if swapped:
        pts_i, pts_j = dst_n, src_n
        feat_i, feat_j = target_features, source_features
    else:
        pts_i, pts_j = src_n, dst_n
        feat_i, feat_j = source_features, target_features

    fi = torch.as_tensor(np.asarray(feat_i, np.float32), device=device).T  # (33, Ni)
    fj = torch.as_tensor(np.asarray(feat_j, np.float32), device=device).T
    nn_ji = knn(fj, fi, k=1, dist_dtype=torch.float64)[0][:, 0].cpu().numpy()  # j: nearest i
    nn_ij = knn(fi, fj, k=1, dist_dtype=torch.float64)[0][:, 0].cpu().numpy()  # i: nearest j

    corres_ji = np.stack([nn_ji, np.arange(nn_ji.shape[0])], axis=1)  # (i, j)
    hit = np.zeros(pts_i.shape[1], bool)
    hit[nn_ji] = True
    i_idx = np.where(hit)[0]
    corres_ij = np.stack([i_idx, nn_ij[i_idx]], axis=1)

    if use_crosscheck:
        # (i, j) kept iff present in both directions (matcher.cc:184-218).
        corres = corres_ij[nn_ji[corres_ij[:, 1]] == corres_ij[:, 0]]
    else:
        corres = np.concatenate([corres_ij, corres_ji], axis=0)

    if use_tuple_test and tuple_scale != 0 and corres.shape[0] >= 3:
        corres = _tuple_test(corres, pts_i, pts_j, tuple_scale,
                             draw_triads(corres.shape[0], seed, device))
    if swapped:
        corres = corres[:, ::-1]
    return np.unique(corres, axis=0)  # sort + dedup (matcher.cc:301-302)


def _tuple_test(corres: np.ndarray, pts_i: np.ndarray, pts_j: np.ndarray, tuple_scale: float,
                triads) -> np.ndarray:
    """Random triangle scale-consistency test (matcher.cc:225-285): a triad
    of correspondences passes if all three edge-length ratios lie in
    (tuple_scale, 1/tuple_scale); the correspondences of any passing triad
    survive. `triads`: batches of (T, 3) indices into `corres` (tensors or
    arrays), all ncorr * 100 of them; the test runs on their device."""
    triads = [t if isinstance(t, torch.Tensor) else torch.as_tensor(np.array(t)) for t in triads]
    device = triads[0].device if triads else torch.device("cpu")
    ci = torch.as_tensor(corres[:, 0], device=device)
    cj = torch.as_tensor(corres[:, 1], device=device)
    pi = torch.as_tensor(np.asarray(pts_i, np.float32), device=device)
    pj = torch.as_tensor(np.asarray(pts_j, np.float32), device=device)

    def edges(p):  # (3, T, 3) -> (T, 3) edge lengths
        return torch.stack([
            torch.linalg.vector_norm(p[:, :, a] - p[:, :, b], dim=0)
            for a, b in ((0, 1), (1, 2), (2, 0))
        ], dim=1)

    hits = torch.zeros(corres.shape[0], dtype=torch.int64, device=device)
    for tri in triads:
        tri = tri.to(device=device, dtype=torch.int64)
        li = edges(pi[:, ci[tri]])
        lj = edges(pj[:, cj[tri]])
        ok = ((li * tuple_scale < lj) & (lj < li / tuple_scale)).all(dim=1)
        hits.index_add_(0, tri.reshape(-1), ok.repeat_interleave(3).to(torch.int64))
    return corres[(hits > 0).cpu().numpy()]
