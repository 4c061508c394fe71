"""Voxel-grid downsampling (copy of psulvsb_tpu/frontend/voxel.py).

Equivalent of the PCL VoxelGrid stage of the correspondence generator
(teaser_cpp_ply.cc: voxel leaf = noise bound): the centroid of the points
in each occupied voxel. Host-side numpy, as in the JAX package: the output
size depends on the data, and it runs once a cloud.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, leaf_size: float) -> np.ndarray:
    """points: (3, N) -> (3, M) voxel centroids, ordered by voxel hash."""
    pts = np.asarray(points)
    if pts.shape[1] == 0:
        return pts
    mins = pts.min(axis=1, keepdims=True)
    idx = np.floor((pts - mins) / leaf_size).astype(np.int64)
    # Unique voxel key per column.
    dims = idx.max(axis=1) + 1
    key = (idx[0] * dims[1] + idx[1]) * dims[2] + idx[2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pts_s = pts[:, order]
    # Vectorized segment means (a per-voxel Python loop costs seconds of
    # host time at KITTI scale, ~1e5-1e6 occupied voxels).
    starts = np.concatenate([[0], np.nonzero(np.diff(key_s))[0] + 1])
    counts = np.diff(np.concatenate([starts, [key_s.size]]))
    sums = np.add.reduceat(pts_s, starts, axis=1)
    return (sums / counts[None, :]).astype(pts.dtype)
