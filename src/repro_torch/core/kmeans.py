"""Subset selection for tnum < pnum (paper §4.2 case 3).

When a job has fewer tasks than allocated cores, the mapper selects the
"closest" subset of ``tnum`` cores (modified K-means in the paper, after
Hartigan & Wong): iteratively take the ``tnum`` cores nearest to the
centroid of the current selection until the selection stabilises.
"""

from __future__ import annotations

import numpy as np


def closest_subset(coords: np.ndarray, k: int, *, iters: int = 32,
                   seed: int = 0) -> np.ndarray:
    """Indices of a compact subset of ``k`` points of ``coords``."""
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    if k >= n:
        return np.arange(n)
    centre = coords.mean(axis=0)
    chosen = None
    for _ in range(iters):
        d = np.linalg.norm(coords - centre, axis=1)
        new = np.argpartition(d, k)[:k]
        new_sorted = np.sort(new)
        if chosen is not None and np.array_equal(new_sorted, chosen):
            break
        chosen = new_sorted
        centre = coords[chosen].mean(axis=0)
    return chosen
