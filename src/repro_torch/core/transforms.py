"""Coordinate transforms that improve mapping quality (paper §4.3, §5).

- :func:`shift_torus` — cut each torus dimension at its largest coordinate
  gap so wrap-around neighbours become geometrically adjacent.
- :func:`permutations` / :func:`apply_permutation` — the rotation search.
- :func:`scale_by_bandwidth` — Gemini/DCN-style heterogeneous links: node
  distance across a link becomes proportional to 1/bw (Z2_2).
- :func:`box_lift` — Z2_3's 3D->6D lift: (box coords * big weight, coords
  within box * small weight) so the partitioner cuts between boxes first.
- :func:`drop_dims` — BG/Q "+E": remove a dimension from processor coords
  so the partitioner keeps the fast-dim pairs together.
"""

from __future__ import annotations

import itertools

import numpy as np

from .machine import Machine


def shift_torus(coords: np.ndarray, machine: Machine) -> np.ndarray:
    """Shift coordinates along each wrapped dimension at the largest gap.

    For each torus dimension: find the largest circular gap between the
    *occupied* coordinates; if it exceeds one grid step, rotate the
    coordinate system so the gap sits at the boundary.  Nodes that were
    split across the wrap-around then appear contiguous to the geometric
    partitioner (paper §4.3 "Shifting the machine coordinates").
    """
    coords = np.asarray(coords, dtype=np.float64).copy()
    nd = machine.ndim - machine.core_dims
    for k in range(nd):
        if not machine.wrap[k]:
            continue
        s = machine.dims[k]
        occ = np.unique(coords[:, k].astype(np.int64))
        if len(occ) <= 1:
            continue
        gaps = np.diff(np.concatenate([occ, occ[:1] + s]))
        g = int(np.argmax(gaps))
        if gaps[g] <= 1:
            continue
        # gap follows occ[g]; rotate so the first coordinate AFTER the gap
        # becomes 0.
        origin = (occ[g] + gaps[g]) % s
        coords[:, k] = (coords[:, k] - origin) % s
    return coords


def permutations(ndim: int, limit: int | None = None) -> list[tuple[int, ...]]:
    """All dimension orderings (the paper's td!/pd! rotations)."""
    perms = list(itertools.permutations(range(ndim)))
    if limit is not None and len(perms) > limit:
        idx = np.linspace(0, len(perms) - 1, limit).astype(int)
        perms = [perms[i] for i in idx]
    return perms


def apply_permutation(coords: np.ndarray, perm) -> np.ndarray:
    return np.asarray(coords)[:, list(perm)]


def scale_by_bandwidth(coords: np.ndarray, machine: Machine,
                       ref_bw: float | None = None) -> np.ndarray:
    """Z2_2: stretch each dimension so crossing a link costs distance
    proportional to 1/bandwidth.  Integer coordinate x along dim k maps to
    the cumulative inverse-bandwidth of links 0..x-1 (times ref_bw)."""
    coords = np.asarray(coords, dtype=np.float64)
    out = coords.copy()
    nd = machine.ndim - machine.core_dims
    if ref_bw is None:
        ref_bw = max(float(np.max(p[np.isfinite(p)])) if np.isfinite(
            p).any() else 1.0 for p in machine.link_bw[:nd])
    for k in range(nd):
        s = machine.dims[k]
        idx = np.arange(s)
        bw = np.asarray(machine.bw(k, idx), dtype=np.float64)
        cost = np.where(np.isfinite(bw), ref_bw / bw, 0.0)
        cum = np.concatenate([[0.0], np.cumsum(cost)])
        # interpolate (coords may already be shifted/fractional)
        x = coords[:, k]
        xi = np.clip(np.floor(x).astype(int), 0, s - 1)
        frac = x - xi
        out[:, k] = cum[xi] + frac * cost[np.clip(xi, 0, s - 1)]
    return out


def box_lift(coords: np.ndarray, box: tuple[int, ...],
             outer_weight: float = 16.0, inner_weight: float = 1.0
             ) -> np.ndarray:
    """Z2_3: lift d-dim coords to 2d dims — (box index, index within box).

    ``outer_weight`` >> ``inner_weight`` steers the partitioner to cut
    between boxes before cutting within them (the paper uses 2x2x8 boxes
    on Gemini so a box == the set of nodes sharing fast local links)."""
    coords = np.asarray(coords, dtype=np.float64)
    box = np.asarray(box, dtype=np.float64)
    outer = np.floor(coords / box) * outer_weight
    inner = (coords % box) * inner_weight
    return np.concatenate([outer, inner], axis=1)


def drop_dims(coords: np.ndarray, dims_to_drop) -> np.ndarray:
    """BG/Q "+E": remove dimensions from processor coordinates."""
    keep = [i for i in range(coords.shape[1]) if i not in set(dims_to_drop)]
    return np.asarray(coords)[:, keep]


def normalize_extents(coords: np.ndarray) -> np.ndarray:
    """Scale every dimension to unit extent (useful before comparing task
    and processor spaces of very different scales)."""
    coords = np.asarray(coords, dtype=np.float64)
    lo = coords.min(axis=0)
    span = coords.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    return (coords - lo) / span
