"""Task communication graphs (the application side of the mapping).

- :func:`stencil_graph`      — MiniGhost-style d-dim grid, 2d-point stencil.
- :func:`cube_sphere_graph`  — HOMME-style cubed-sphere element mesh, with
                               the paper's sphere / cube / 2D-face task
                               coordinate transforms (Fig. 7).
- :func:`logical_mesh_graph` — the TPU adaptation: a logical device
                               mesh whose edges carry per-axis collective
                               traffic weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TaskGraph:
    """Tasks with coordinates and weighted communication edges.

    coords  : (n, td) float task coordinates (centroids).
    edges   : (E, 2) int task-index pairs (directed; a symmetric pattern
              lists both directions so per-link directed traffic is right).
    weights : (E,) message volumes.
    meta    : free-form info (grid dims, transforms applied, ...).
    """

    coords: np.ndarray
    edges: np.ndarray
    weights: np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.coords)

    def with_coords(self, coords: np.ndarray, note: str = "") -> "TaskGraph":
        meta = dict(self.meta)
        if note:
            meta.setdefault("transforms", []).append(note) if isinstance(
                meta.get("transforms"), list) else meta.update(
                transforms=[note])
        return TaskGraph(np.asarray(coords, float), self.edges, self.weights,
                         meta)


# ---------------------------------------------------------------------------
# Structured stencils (MiniGhost, Table 1 generators)
# ---------------------------------------------------------------------------

def stencil_graph(dims: tuple[int, ...], *, torus: bool = False,
                  weight: float = 1.0, directed: bool = True) -> TaskGraph:
    """d-dim grid of tasks, each communicating with +-1 neighbours per dim.

    ``torus=False`` gives MiniGhost's non-periodic boundaries.  Edges are
    emitted in both directions when ``directed`` (volume ``weight`` each
    way, as a halo exchange sends both ways).
    """
    dims = tuple(int(x) for x in dims)
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    srcs, dsts = [], []
    for k in range(len(dims)):
        if dims[k] < 2:
            continue
        a = np.moveaxis(idx, k, 0)
        fwd_src, fwd_dst = a[:-1], a[1:]
        srcs.append(fwd_src.ravel())
        dsts.append(fwd_dst.ravel())
        if torus and dims[k] > 2:
            srcs.append(a[-1:].ravel())
            dsts.append(a[:1].ravel())
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    if directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    edges = np.stack([src, dst], axis=1)
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    return TaskGraph(coords.astype(float), edges,
                     np.full(len(edges), float(weight)),
                     meta={"dims": dims, "torus": torus})


# ---------------------------------------------------------------------------
# HOMME cubed-sphere
# ---------------------------------------------------------------------------
# Face layout (standard equatorial strip): faces 0..3 around the equator,
# face 4 = north pole (attached above face 0), face 5 = south pole
# (below face 0).  Within a face, (i, j) in [0, ne)^2.

def _face_uv(ne: int):
    u = (np.arange(ne) + 0.5) / ne * 2.0 - 1.0  # in (-1, 1)
    return np.meshgrid(u, u, indexing="ij")


def _cell(f: int, fi, fj, ne: int):
    return f * ne * ne + np.asarray(fi) * ne + np.asarray(fj)


def cube_sphere_graph(ne: int, weight: float = 1.0) -> TaskGraph:
    """Cubed-sphere element mesh: 6*ne*ne tasks, 4-neighbour connectivity
    including across cube edges (exact stitching tables for the standard
    equatorial-strip face parameterisation; see _cube_shell_points).
    Coordinates are 3D points on the unit sphere (the paper's 'Sphere'
    task coordinates)."""
    n = 6 * ne * ne
    ids = np.arange(n)
    coords = _sphere_coords(ne)

    srcs, dsts = [], []
    # In-face neighbours
    grid = ids.reshape(6, ne, ne)
    for axis in (1, 2):
        a = np.moveaxis(grid, axis, 1)
        srcs.append(a[:, :-1].ravel())
        dsts.append(a[:, 1:].ravel())

    r = np.arange(ne)
    rr = ne - 1 - r
    last = ne - 1
    # Equatorial ring: face f edge fi=last <-> face (f+1)%4 edge fi=0,
    # fj aligned.
    for f in range(4):
        srcs.append(_cell(f, last, r, ne))
        dsts.append(_cell((f + 1) % 4, 0, r, ne))
    # North face 4 (+z): derived from the gnomonic parameterisation
    stitches = [
        (_cell(4, r, 0, ne), _cell(0, r, last, ne)),       # v=-1 <-> f0 top
        (_cell(4, r, last, ne), _cell(2, rr, last, ne)),   # v=+1 <-> f2 top
        (_cell(4, 0, r, ne), _cell(3, rr, last, ne)),      # u=-1 <-> f3 top
        (_cell(4, last, r, ne), _cell(1, r, last, ne)),    # u=+1 <-> f1 top
        # South face 5 (-z)
        (_cell(5, r, 0, ne), _cell(2, rr, 0, ne)),         # v=-1 <-> f2 bot
        (_cell(5, r, last, ne), _cell(0, r, 0, ne)),       # v=+1 <-> f0 bot
        (_cell(5, 0, r, ne), _cell(3, r, 0, ne)),          # u=-1 <-> f3 bot
        (_cell(5, last, r, ne), _cell(1, rr, 0, ne)),      # u=+1 <-> f1 bot
    ]
    for s_, d_ in stitches:
        srcs.append(s_)
        dsts.append(d_)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    edges = np.stack([src, dst], axis=1)
    return TaskGraph(coords, edges, np.full(len(edges), float(weight)),
                     meta={"ne": ne, "kind": "cube_sphere"})


def _cube_shell_points(ne: int) -> np.ndarray:
    """Cell centres on the surface of the unit cube (gnomonic grid)."""
    pts = np.zeros((6 * ne * ne, 3))
    uu, vv = _face_uv(ne)
    u, v = uu.ravel(), vv.ravel()
    one = np.ones_like(u)
    # faces: +x, +y, -x, -y (equatorial), +z (north), -z (south)
    faces = [
        np.stack([one, u, v], axis=1),
        np.stack([-u, one, v], axis=1),
        np.stack([-one, -u, v], axis=1),
        np.stack([u, -one, v], axis=1),
        np.stack([-v, u, one], axis=1),
        np.stack([v, u, -one], axis=1),
    ]
    for f in range(6):
        pts[f * ne * ne:(f + 1) * ne * ne] = faces[f]
    return pts


def _sphere_coords(ne: int) -> np.ndarray:
    p = _cube_shell_points(ne)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _boundary_ids(ne: int) -> np.ndarray:
    rem = np.arange(6 * ne * ne) % (ne * ne)
    fi, fj = rem // ne, rem % ne
    onb = (fi == 0) | (fi == ne - 1) | (fj == 0) | (fj == ne - 1)
    return np.flatnonzero(onb)


def cube_coords(ne: int) -> np.ndarray:
    """The paper's 'Cube' transform: gnomonic cube-surface coordinates."""
    return _cube_shell_points(ne)


def face2d_coords(ne: int) -> np.ndarray:
    """The paper's '2DFace' transform (Fig. 7c/d): unfold the cube onto a
    2D plane — four equatorial faces in a strip (x wraps around), polar
    faces attached above/below the first face.  Locality across the strip
    ends is captured downstream by treating x as a torus dimension (the
    shift transform / FZ ordering exploit it)."""
    n = 6 * ne * ne
    rem = np.arange(n) % (ne * ne)
    fi, fj = (rem // ne).astype(float), (rem % ne).astype(float)
    out = np.zeros((n, 2))
    for f in range(4):  # equatorial strip along x (wraps at 4*ne)
        s = slice(f * ne * ne, (f + 1) * ne * ne)
        out[s, 0] = fi[s] + f * ne
        out[s, 1] = fj[s]
    # north pole above face 0, south pole below face 0
    s = slice(4 * ne * ne, 5 * ne * ne)
    out[s, 0] = fi[s]
    out[s, 1] = fj[s] + ne
    s = slice(5 * ne * ne, 6 * ne * ne)
    out[s, 0] = fi[s]
    out[s, 1] = fj[s] - ne
    return out


# ---------------------------------------------------------------------------
# Logical device mesh (the TPU adaptation's task graph)
# ---------------------------------------------------------------------------

def logical_mesh_graph(axis_sizes: tuple[int, ...],
                       axis_bytes: tuple[float, ...],
                       axis_names: tuple[str, ...] | None = None,
                       ring: bool = True) -> TaskGraph:
    """Task graph of a logical device mesh.

    One task per logical mesh coordinate.  Along each mesh axis we add
    ring edges (XLA lowers all-reduce/all-gather/reduce-scatter to
    bidirectional ring passes on TPU), weighted by ``axis_bytes`` — the
    per-step collective bytes crossing each link of that axis (e.g. TP
    all-reduces dominate, FSDP all-gathers are lighter, cross-pod DP is
    lightest).  Task coordinates are the logical mesh indices.
    """
    axis_sizes = tuple(int(s) for s in axis_sizes)
    n = int(np.prod(axis_sizes))
    idx = np.arange(n).reshape(axis_sizes)
    srcs, dsts, ws = [], [], []
    for k, size in enumerate(axis_sizes):
        if size < 2:
            continue
        a = np.moveaxis(idx, k, 0)
        s_, d_ = a[:-1].ravel(), a[1:].ravel()
        srcs.append(s_)
        dsts.append(d_)
        ws.append(np.full(len(s_), float(axis_bytes[k])))
        if ring and size > 2:
            srcs.append(a[-1:].ravel())
            dsts.append(a[:1].ravel())
            ws.append(np.full(a[:1].size, float(axis_bytes[k])))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = np.concatenate(ws)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.concatenate([w, w])
    edges = np.stack([src, dst], axis=1)
    coords = np.stack(np.unravel_index(np.arange(n), axis_sizes), axis=1)
    return TaskGraph(coords.astype(float), edges, w,
                     meta={"axis_sizes": axis_sizes,
                           "axis_names": axis_names,
                           "axis_bytes": axis_bytes})
