"""The jobs a launcher sends: task graphs, the machine and sparse
allocations, made from a configuration file and a seed in plain numpy.

The same seed gives the same pool of jobs.  Jobs of one configuration
share the task graph and the machine, and differ in their allocation:
each is an ALPS-style sparse allocation, a Hilbert-curve order of the
routers cut into fragments placed at random free offsets, as other jobs
hold the rest of the machine.  Both the program and the reference get
the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ref.engine import Machine
from .ref.orderings import hilbert_index


@dataclasses.dataclass
class Job:
    """One mapping problem as plain arrays."""

    task_coords: np.ndarray   # (n, td) float64
    edges: np.ndarray         # (E, 2) int64, both directions listed
    weights: np.ndarray       # (E,) float64 message volumes
    alloc: np.ndarray         # (n, ndim) int64 router + core coordinates
    machine: Machine


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


def torus(spec: dict) -> Machine:
    """A torus of routers, each holding ``cores_per_router`` cores, with
    a repeating pattern of link rates along each dim (any unit: only
    their ratios move a mapping, and Latency(M) is read in its own)."""
    dims = tuple(spec["router_dims"]) + (int(spec["cores_per_router"]),)
    return Machine(dims, tuple(spec["wrap"]) + (False,),
                   tuple(tuple(float(x) for x in p)
                         for p in spec["link_gbit_s"]))


class HilbertSparse:
    """Sparse allocations of ``tasks`` cores, one router's cores whole
    (the last router's trimmed), in ``fragments`` runs of the routers'
    Hilbert order placed at random free offsets."""

    def __init__(self, machine: Machine, spec: dict):
        self.spec = spec
        rdims = machine.dims[:machine.nd]
        self.routers = np.stack(
            [g.ravel() for g in np.indices(rdims)], axis=1)
        bits = max(1, int(np.ceil(np.log2(max(max(rdims), 2)))))
        self.order = np.argsort(hilbert_index(self.routers, bits),
                                kind="stable")
        cores = machine.dims[machine.nd]
        self.cores = np.arange(cores)
        self.nrouters = -(-int(spec["tasks"]) // cores)

    def draw(self, rng: np.random.Generator) -> np.ndarray:
        total, nr = len(self.order), self.nrouters
        nf = int(self.spec["fragments"])
        sizes = np.full(nf, nr // nf)
        sizes[:nr % nf] += 1
        occupied = np.zeros(total, dtype=bool)
        segs = []
        for sz in sizes:
            for _ in range(256):
                s = int(rng.integers(0, total - sz + 1))
                if not occupied[s:s + sz].any():
                    break
            else:
                raise ValueError("no free run for a fragment")
            occupied[s:s + sz] = True
            segs.append(self.order[s:s + sz])
        chosen = self.routers[np.concatenate(segs)]
        k = len(self.cores)
        coords = np.concatenate([np.repeat(chosen, k, axis=0),
                                 np.tile(self.cores, len(chosen))[:, None]],
                                axis=1)[:int(self.spec["tasks"])]
        box = self.spec.get("rank_box")
        if box is not None:
            # the system's default rank order: whole boxes of routers
            # before the slow links between them
            b = np.asarray(box)
            outer, inner = coords[:, :3] // b, coords[:, :3] % b
            coords = coords[np.lexsort((
                coords[:, 3], inner[:, 2], inner[:, 1], inner[:, 0],
                outer[:, 2], outer[:, 1], outer[:, 0]))]
        return coords.astype(np.int64)


# what a configuration's ``kind`` of graph, machine and allocation names;
# a configuration of another kind needs its own entry here
GRAPHS = {
    "stencil": lambda g: stencil(g["dims"], g["periodic"], g["volume"]),
    "cube_sphere": lambda g: cube_sphere(g["ne"], g["volume"]),
}
MACHINES = {"gemini-torus": torus}
ALLOCATORS = {"hilbert-sfc": HilbertSparse}


def of_kind(table: dict, spec: dict, what: str):
    kind = spec.get("kind")
    if kind not in table:
        raise ValueError(f"no {what} of kind {kind!r}: known are "
                         f"{sorted(table)}")
    return table[kind]


def job_pool(config: dict, seed: int, count: int) -> list[Job]:
    """``count`` jobs of ``config``; job ``i`` draws its allocation from
    its own stream of ``seed``."""
    graph = config["graph"]
    coords, edges, weights = of_kind(GRAPHS, graph, "graph")(graph)
    machine = of_kind(MACHINES, config["machine"], "machine")(
        config["machine"])
    if int(config["allocation"]["tasks"]) != len(coords):
        raise ValueError("the allocation must hold one core a task")
    alloc = of_kind(ALLOCATORS, config["allocation"], "allocation")(
        machine, config["allocation"])
    streams = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(count)
    return [Job(coords, edges, weights,
                alloc.draw(np.random.default_rng(s)), machine)
            for s in streams]
