"""Graph kind ``cube_sphere``: HOMME's cubed-sphere element mesh at
``ne``, each element sending ``volume`` to its 4 neighbours."""

import numpy as np


def build(spec: dict):
    return cube_sphere(spec["ne"], spec["volume"])


def _cell(f, fi, fj, ne):
    return f * ne * ne + np.asarray(fi) * ne + np.asarray(fj)


def cube_sphere(ne: int, volume: float):
    """HOMME's cubed-sphere element mesh: 6 ne^2 elements on the unit
    sphere (gnomonic face grids, faces 0-3 around the equator, 4 the
    north and 5 the south pole), each sending to its 4 neighbours,
    across cube edges too."""
    n = 6 * ne * ne
    u = (np.arange(ne) + 0.5) / ne * 2.0 - 1.0
    uu, vv = np.meshgrid(u, u, indexing="ij")
    u, v = uu.ravel(), vv.ravel()
    one = np.ones_like(u)
    faces = [np.stack(f, axis=1) for f in (
        (one, u, v), (-u, one, v), (-one, -u, v), (u, -one, v),
        (-v, u, one), (v, u, -one))]
    pts = np.concatenate(faces)
    coords = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    grid = np.arange(n).reshape(6, ne, ne)
    srcs, dsts = [], []
    for axis in (1, 2):
        a = np.moveaxis(grid, axis, 1)
        srcs.append(a[:, :-1].ravel())
        dsts.append(a[:, 1:].ravel())
    r = np.arange(ne)
    rr, last = ne - 1 - r, ne - 1
    pairs = [(_cell(f, last, r, ne), _cell((f + 1) % 4, 0, r, ne))
             for f in range(4)]
    pairs += [
        (_cell(4, r, 0, ne), _cell(0, r, last, ne)),
        (_cell(4, r, last, ne), _cell(2, rr, last, ne)),
        (_cell(4, 0, r, ne), _cell(3, rr, last, ne)),
        (_cell(4, last, r, ne), _cell(1, r, last, ne)),
        (_cell(5, r, 0, ne), _cell(2, rr, 0, ne)),
        (_cell(5, r, last, ne), _cell(0, r, 0, ne)),
        (_cell(5, 0, r, ne), _cell(3, r, 0, ne)),
        (_cell(5, last, r, ne), _cell(1, rr, 0, ne)),
    ]
    for s_, d_ in pairs:
        srcs.append(s_)
        dsts.append(d_)
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], axis=1)
    return coords, edges.astype(np.int64), np.full(len(edges), float(volume))
