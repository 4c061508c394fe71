"""Point-cloud container (copy of psulvsb_tpu/core/geometry.py): parity
with teaser::PointCloud (geometry.h:15-70, a thin std::vector<PointXYZ> with
push_back, indexing and size). A list of points with a (3, N) float32 numpy
view; `asarray` is the bridge into the compute path.
"""

from __future__ import annotations

import numpy as np


class PointCloud:
    def __init__(self, points=None):
        if points is None:
            self._pts: list[tuple[float, float, float]] = []
            self._arr = None
        else:
            arr = np.asarray(points, np.float32)
            assert arr.ndim == 2 and arr.shape[0] == 3
            self._pts = [tuple(c) for c in arr.T]
            self._arr = None

    def push_back(self, p) -> None:
        x, y, z = (p["x"], p["y"], p["z"]) if isinstance(p, dict) else tuple(p)
        self._pts.append((float(x), float(y), float(z)))
        self._arr = None

    def append(self, p) -> None:
        self.push_back(p)

    def size(self) -> int:
        return len(self._pts)

    def __len__(self) -> int:
        return len(self._pts)

    def __getitem__(self, i: int):
        return self._pts[i]

    def clear(self) -> None:
        self._pts.clear()
        self._arr = None

    def reserve(self, n: int) -> None:
        pass  # parity no-op

    def asarray(self) -> np.ndarray:
        """(3, N) float32 view for the compute path."""
        if self._arr is None or self._arr.shape[1] != len(self._pts):
            self._arr = np.asarray(self._pts, np.float32).reshape(-1, 3).T
        return self._arr
