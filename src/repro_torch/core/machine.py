"""Machine (network) models: meshes/tori with per-link bandwidths.

The paper's machines:

- Cray XK7 *Gemini* 3D torus (Titan): heterogeneous links — X cables
  75 GB/s; Y mezzanine 75 / Y cables 37.5; Z backplane 120 / Z cables 75.
- IBM BlueGene/Q 5D torus: uniform links, block allocations, E dim <= 2.

Our TPU targets (the machines the dry-run meshes run on):

- TPU v5e pod: 16x16 2D torus of chips, ICI ~50 GB/s per link/direction.
- Multi-pod: a slow "pod" dimension (DCN) stitched in front of the ICI
  torus: (npods, 16, 16) with no wraparound and much lower bandwidth.

A :class:`Machine` holds the *full* physical network; an
:class:`Allocation` is the subset of nodes a job received (contiguous on
BG/Q-like systems; sparse/fragmented on Cray/cloud-like systems).  Node
coordinates are integer router coordinates; multicore nodes are modelled
with a trailing "core" dimension whose links are infinitely fast (messages
inside a node cost zero hops — matching the paper's treatment).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .orderings import hilbert_index

INF_BW = float("inf")


@dataclasses.dataclass(frozen=True)
class Machine:
    """A mesh/torus network.

    dims      : physical grid extent per dimension.
    wrap      : per-dimension wraparound (torus) flag.
    link_bw   : per-dimension link bandwidth spec.  Either a scalar
                (uniform along the dim) or a 1D pattern array tiled along
                the dim: ``bw(dim d, link index i) = link_bw[d][i % len]``.
                Link *i* along dim *d* connects coord i -> i+1 (mod extent).
    name      : label for reports.
    core_dims : how many trailing dims are intra-node "core" dims (zero
                network hops; infinite bandwidth).
    """

    dims: tuple[int, ...]
    wrap: tuple[bool, ...]
    link_bw: tuple[np.ndarray, ...]
    name: str = "machine"
    core_dims: int = 0

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def nnodes(self) -> int:
        return int(np.prod(self.dims))

    @property
    def network_ndim(self) -> int:
        """Network (router) dimensions — ``ndim`` minus the core dims."""
        return self.ndim - self.core_dims

    @property
    def cores_per_node(self) -> int:
        """Cores sharing one router (product of the core dims; 1 when
        the machine has none).  The node-level arity that
        :meth:`repro_torch.hier.HierarchySpec.from_machine` derives."""
        if not self.core_dims:
            return 1
        return int(np.prod(self.dims[self.network_ndim:]))

    def bw(self, dim: int, index: np.ndarray | int):
        pat = self.link_bw[dim]
        return pat[np.asarray(index) % len(pat)]

    def bw_field(self, dim: int) -> np.ndarray:
        """Per-link bandwidth along ``dim`` broadcast to the full machine
        shape: entry at coordinate ``x`` is the bandwidth of the link
        x -> x+e_dim.  One shared helper for every latency computation
        (``Traffic.link_latency``, ``per_dim_stats``,
        ``evaluate_candidates`` and the torch scoring backend); prepend a
        ``[None]`` axis to broadcast against candidate stacks.
        """
        bw = np.asarray(self.bw(dim, np.arange(self.dims[dim])),
                        dtype=np.float64)
        shape = [1] * self.ndim
        shape[dim] = self.dims[dim]
        return np.broadcast_to(bw.reshape(shape), self.dims)

    def all_coords(self) -> np.ndarray:
        """(nnodes, ndim) integer coordinates of every node, row-major."""
        grids = np.indices(self.dims)
        return np.stack([g.ravel() for g in grids], axis=1)

    def coords_to_index(self, coords: np.ndarray) -> np.ndarray:
        return np.ravel_multi_index(tuple(coords.T), self.dims)


def make_machine(dims, wrap=True, bw=1.0, name="machine", core_dims=0,
                 bw_patterns=None) -> Machine:
    dims = tuple(int(d) for d in dims)
    nd = len(dims)
    if isinstance(wrap, bool):
        wrap = tuple(wrap for _ in dims)
    else:
        wrap = tuple(bool(w) for w in wrap)
    if bw_patterns is None:
        if np.isscalar(bw):
            bw_patterns = [np.array([float(bw)])] * nd
        else:
            bw_patterns = [np.array([float(b)]) for b in bw]
    pats = tuple(np.asarray(p, dtype=np.float64) for p in bw_patterns)
    return Machine(dims, wrap, pats, name=name, core_dims=core_dims)


# ---------------------------------------------------------------------------
# Concrete machines
# ---------------------------------------------------------------------------

def gemini_xk7(dims=(25, 16, 24), cores_per_node: int = 16) -> Machine:
    """Cray XK7 Gemini 3D torus (Titan-like) with heterogeneous links.

    X: uniform cables 75 GB/s.
    Y: alternating mezzanine (75) / cable (37.5) — mezzanine links join
       node pairs, cables join neighbouring mezzanines.
    Z: backplane traces 120 GB/s inside groups of 8, cables 75 between.
    A trailing core dimension models the multicore node (free comms).
    """
    x = np.array([75.0])
    y = np.array([75.0, 37.5])
    z = np.array([120.0] * 7 + [75.0])
    dims = tuple(dims) + (cores_per_node,)
    wrap = (True, True, True, False)
    core = np.array([INF_BW])
    return Machine(dims, wrap, (x, y, z, core), name="cray-xk7", core_dims=1)


def bgq(dims=(4, 4, 4, 8, 2), cores_per_node: int = 16,
        bw_gbs: float = 2.0) -> Machine:
    """IBM BlueGene/Q 5D torus with uniform links (A,B,C,D,E) + core dim."""
    pats = tuple(np.array([bw_gbs]) for _ in dims) + (np.array([INF_BW]),)
    dims = tuple(dims) + (cores_per_node,)
    wrap = tuple(True for _ in range(len(dims) - 1)) + (False,)
    return Machine(dims, wrap, pats, name="bgq", core_dims=1)


def tpu_v5e_pod(side: int = 16, ici_gbs: float = 50.0) -> Machine:
    """Single TPU v5e pod: side x side 2D ICI torus."""
    pats = (np.array([ici_gbs]), np.array([ici_gbs]))
    return Machine((side, side), (True, True), pats, name="tpu-v5e-pod")


def tpu_v5e_multipod(npods: int = 2, side: int = 16,
                     ici_gbs: float = 50.0, dcn_gbs: float = 3.125) -> Machine:
    """Multi-pod v5e: slow non-wrapping DCN dim in front of the ICI torus.

    The DCN "links" connect corresponding chips of adjacent pods — a
    simplification of the real aggregated-NIC fabric, but it gives the
    mapper the right relative cost (DCN ~16x slower than ICI).
    """
    pats = (np.array([dcn_gbs]), np.array([ici_gbs]), np.array([ici_gbs]))
    return Machine((npods, side, side), (False, True, True), pats,
                   name=f"tpu-v5e-{npods}pod")


def tpu_v4_cube(dims=(8, 8, 8), ici_gbs: float = 45.0) -> Machine:
    """TPU v4-like 3D ICI torus."""
    pats = tuple(np.array([ici_gbs]) for _ in dims)
    return Machine(tuple(dims), (True,) * len(dims), pats, name="tpu-v4")


# ---------------------------------------------------------------------------
# Allocations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Allocation:
    """A set of machine nodes given to a job.

    coords : (n, ndim) integer router coordinates (one row per *core* when
             the machine has a core dim).
    machine: the full machine the nodes belong to.
    """

    machine: Machine
    coords: np.ndarray

    @property
    def n(self) -> int:
        return len(self.coords)


def block_allocation(machine: Machine, block_dims=None) -> Allocation:
    """Contiguous block allocation (BG/Q style).  Default: whole machine."""
    dims = machine.dims if block_dims is None else tuple(block_dims)
    grids = np.indices(dims)
    coords = np.stack([g.ravel() for g in grids], axis=1)
    if len(dims) < machine.ndim:
        pad = np.zeros((len(coords), machine.ndim - len(dims)), dtype=int)
        coords = np.concatenate([coords, pad], axis=1)
    return Allocation(machine, coords)


def _first_free_window(occupied: np.ndarray, sz: int) -> int:
    """Start of the first run of >= ``sz`` consecutive free slots, or -1."""
    free = ~occupied
    if sz <= 0 or not free.any():
        return -1
    # run-length encode the free mask: starts/ends of maximal free runs
    edges = np.diff(free.astype(np.int8))
    starts = np.flatnonzero(edges == 1) + 1
    ends = np.flatnonzero(edges == -1) + 1
    if free[0]:
        starts = np.concatenate([[0], starts])
    if free[-1]:
        ends = np.concatenate([ends, [len(free)]])
    fits = np.flatnonzero(ends - starts >= sz)
    return int(starts[fits[0]]) if len(fits) else -1


def sfc_allocation(machine: Machine, nnodes: int, *, start: int | None = None,
                   nfragments: int = 1, seed: int = 0) -> Allocation:
    """ALPS-like sparse allocation: nodes ordered by a Hilbert SFC over the
    router grid; the job receives ``nfragments`` segments of that ordering
    (fragmentation models other jobs occupying interleaved segments).

    Only router dims participate in the SFC; core dims are expanded after
    selection (all cores of a selected node belong to the job).
    """
    rng = np.random.default_rng(seed)
    rdims = machine.dims[: machine.ndim - machine.core_dims]
    router_grid = np.indices(rdims)
    pts = np.stack([g.ravel() for g in router_grid], axis=1)
    bits = max(1, int(np.ceil(np.log2(max(max(rdims), 2)))))
    h = hilbert_index(pts, bits)
    order = np.argsort(h, kind="stable")
    total = len(pts)
    ncores = int(np.prod(machine.dims[machine.ndim - machine.core_dims:])) \
        if machine.core_dims else 1
    nrouters = (nnodes + ncores - 1) // ncores if machine.core_dims else nnodes
    if nrouters > total:
        raise ValueError("allocation larger than machine")
    if nfragments <= 1:
        s = rng.integers(0, total - nrouters + 1) if start is None else start
        chosen = order[s: s + nrouters]
    else:
        # split the request into fragments placed at random SFC offsets
        sizes = np.full(nfragments, nrouters // nfragments)
        sizes[: nrouters % nfragments] += 1
        segs = []
        occupied = np.zeros(total, dtype=bool)
        for sz in sizes:
            if sz == 0:
                continue
            for _ in range(64):
                s = int(rng.integers(0, total - sz + 1))
                if not occupied[s: s + sz].any():
                    occupied[s: s + sz] = True
                    segs.append(order[s: s + sz])
                    break
            else:
                # fallback: first window of >= sz genuinely free slots
                # (blindly taking free[0] could overlap earlier fragments
                # and duplicate coordinates in the allocation)
                s = _first_free_window(occupied, sz)
                if s < 0:
                    raise ValueError(
                        f"no free window of {sz} contiguous SFC slots for "
                        f"a fragment ({int(occupied.sum())}/{total} "
                        f"occupied); lower nfragments or nnodes")
                occupied[s: s + sz] = True
                segs.append(order[s: s + sz])
        chosen = (np.concatenate(segs)[:nrouters] if segs
                  else np.zeros(0, dtype=np.int64))
    router_coords = pts[chosen]
    if machine.core_dims:
        cdims = machine.dims[machine.ndim - machine.core_dims:]
        cores = np.indices(cdims).reshape(len(cdims), -1).T
        coords = np.concatenate(
            [np.repeat(router_coords, len(cores), axis=0),
             np.tile(cores, (len(router_coords), 1))], axis=1)
        # trim the core expansion of the last router to the exact request
        # (nnodes == 0 must give an EMPTY allocation, not the full grid)
        coords = coords[:nnodes]
    else:
        coords = router_coords
    return Allocation(machine, coords)


def random_allocation(machine: Machine, nnodes: int, seed: int = 0
                      ) -> Allocation:
    """Worst-case scattered allocation (uniform random nodes)."""
    rng = np.random.default_rng(seed)
    rdims = machine.dims[: machine.ndim - machine.core_dims]
    total = int(np.prod(rdims))
    ncores = int(np.prod(machine.dims[machine.ndim - machine.core_dims:])) \
        if machine.core_dims else 1
    nrouters = (nnodes + ncores - 1) // ncores if machine.core_dims else nnodes
    idx = rng.choice(total, size=nrouters, replace=False)
    pts = np.stack(np.unravel_index(idx, rdims), axis=1)
    if machine.core_dims:
        cdims = machine.dims[machine.ndim - machine.core_dims:]
        cores = np.indices(cdims).reshape(len(cdims), -1).T
        coords = np.concatenate(
            [np.repeat(pts, len(cores), axis=0),
             np.tile(cores, (len(pts), 1))], axis=1)[:nnodes]
    else:
        coords = pts
    return Allocation(machine, coords)
