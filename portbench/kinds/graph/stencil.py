"""Graph kind ``stencil``: a d-dim grid of tasks (``dims``), each sending
``volume`` to its +-1 neighbours, across the grid's ends too where
``periodic``; the tasks' coordinates are their grid indices."""

import numpy as np


def build(spec: dict):
    return stencil(spec["dims"], spec["periodic"], spec["volume"])


def stencil(dims, periodic: bool, volume: float):
    """A d-dim grid of tasks, each sending to its +-1 neighbours."""
    dims = tuple(int(x) for x in dims)
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    srcs, dsts = [], []
    for k in range(len(dims)):
        a = np.moveaxis(idx, k, 0)
        srcs.append(a[:-1].ravel())
        dsts.append(a[1:].ravel())
        if periodic and dims[k] > 2:
            srcs.append(a[-1:].ravel())
            dsts.append(a[:1].ravel())
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], axis=1)
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    return (coords.astype(np.float64), edges.astype(np.int64),
            np.full(len(edges), float(volume)))
