"""Scenario registry: every workload x allocation x hierarchy x
objective combination the repo serves, generated from ONE source of
truth.

Benchmarks, tests and the mapping service all draw their problems here
instead of hand-rolling graph/allocation constructors per caller.  A
:class:`Scenario` is a frozen, named point of the cross-product

    workloads   : minighost (3D stencil), homme (cubed-sphere element
                  mesh), random (sparse random geometric graph)
    allocations : xk7_sparse (fragmented SFC allocation on the
                  heterogeneous Gemini torus), bgq_block (contiguous
                  BG/Q 5D-torus prefix), tpu_mesh (v5e ICI torus),
                  fat_tree (three-level tree approximated as a
                  non-wrapping grid with per-level bandwidth taper +
                  an intra-node core dim)
    hierarchy   : flat | node (the two-level coarsen -> map ->
                  refine) | depth3 (the recursive N-level hierarchy of
                  :class:`repro_torch.hier.HierarchySpec` with one grouping
                  level above the nodes)
    objective   : wh (WeightedHops) | latency (Latency, WeightedHops)

and everything it builds is a pure function of ``(scale, seed)`` — the
same scenario always yields bit-identical graphs and allocations (the
determinism the serve layer's content-addressed cache relies on, and
tests assert).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core import (Allocation, TaskGraph, bgq, block_allocation,
                              cube_sphere_graph, gemini_xk7, make_machine,
                              sfc_allocation, stencil_graph, tpu_v5e_pod)
from repro_torch.mapping import HierarchySpec, PipelineConfig
from repro_torch.serve.engine import OBJECTIVES, MappingRequest

WORKLOADS = ("minighost", "homme", "random")
ALLOCATIONS = ("xk7_sparse", "bgq_block", "tpu_mesh", "fat_tree")
HIERARCHIES = ("flat", "node", "depth3")
OBJECTIVE_KEYS = ("wh", "latency")

DEFAULT_SCALE = 4096  # target task count (constructors may round)
DEFAULT_ROTATIONS = 4


def _rng(seed: int, *tags: str) -> np.random.Generator:
    """Deterministic per-(seed, tag...) generator — scenario components
    never share or race on one stream."""
    return np.random.default_rng(
        [int(seed)] + [zlib.crc32(t.encode()) for t in tags])


def _pow2_grid(n: int) -> tuple[int, int, int]:
    """Near-cubic power-of-two 3D grid with product 2^floor(log2 n)."""
    e = max(int(np.log2(max(n, 8))), 3)
    a = e // 3
    return (1 << (e - 2 * a), 1 << a, 1 << a)


def _pow2_split(total_exp: int, parts: int) -> tuple[int, ...]:
    """Split ``2**total_exp`` into ``parts`` near-equal pow2 factors."""
    base, extra = divmod(total_exp, parts)
    return tuple(1 << (base + (1 if i < extra else 0))
                 for i in range(parts))


# ---------------------------------------------------------------------------
# Workload constructors (task graphs)
# ---------------------------------------------------------------------------

def _graph_minighost(scale: int, seed: int) -> TaskGraph:
    return stencil_graph(_pow2_grid(scale), torus=False)


def _graph_homme(scale: int, seed: int) -> TaskGraph:
    ne = max(2, int(round(np.sqrt(scale / 6.0))))
    return cube_sphere_graph(ne)


def _graph_random(scale: int, seed: int, degree: int = 6) -> TaskGraph:
    """Sparse random geometric graph: ``scale`` tasks at uniform 3D
    coordinates, each sending to ``degree`` random peers (both
    directions, lognormal volumes)."""
    rng = _rng(seed, "random-graph")
    n = int(scale)
    coords = rng.random((n, 3)) * n ** (1.0 / 3.0)
    src = np.repeat(np.arange(n), degree)
    dst = rng.integers(0, n - 1, size=n * degree)
    dst = np.where(dst >= src, dst + 1, dst)  # no self-edges
    w = rng.lognormal(mean=0.0, sigma=1.0, size=n * degree)
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], axis=1)
    return TaskGraph(coords, edges, np.concatenate([w, w]),
                     meta={"kind": "random", "degree": degree})


_GRAPHS = {
    "minighost": _graph_minighost,
    "homme": _graph_homme,
    "random": _graph_random,
}


# ---------------------------------------------------------------------------
# Allocation constructors (machine + node rows for exactly n tasks)
# ---------------------------------------------------------------------------

def fat_tree_machine(nnodes: int, cores_per_node: int = 4,
                     bw_gbs: tuple = (12.5, 25.0, 100.0)):
    """Three-level fat tree approximated in the mesh machine model:
    non-wrapping (pods, racks, nodes) dims whose per-dim bandwidth
    tapers toward the root (crossing pods is the oversubscribed slow
    level), plus an intra-node core dim (free, like XK7/BG/Q nodes).
    """
    nrouters = max(1, -(-nnodes // cores_per_node))
    e = max(int(np.ceil(np.log2(nrouters))), 3)
    dims = _pow2_split(e, 3) + (cores_per_node,)
    pats = tuple(np.array([b]) for b in bw_gbs) + \
        (np.array([float("inf")]),)
    return make_machine(dims, wrap=False, name="fat-tree", core_dims=1,
                        bw_patterns=pats)


def _alloc_xk7_sparse(n: int, seed: int) -> Allocation:
    """Fragmented ALPS-style allocation on the heterogeneous XK7 torus,
    sized ~2x the job so fragments scatter."""
    cores = 16
    e = int(np.ceil(np.log2(max(2 * n // cores, 8))))
    a = e // 3
    rdims = (1 << (e - 2 * a), 1 << a, 1 << a)
    machine = gemini_xk7(dims=rdims, cores_per_node=cores)
    return sfc_allocation(machine, n, nfragments=8, seed=seed)


def _alloc_bgq_block(n: int, seed: int) -> Allocation:
    """Contiguous BG/Q allocation: the first ``n`` cores of a 5D-torus
    block in row-major order (E dim fixed at 2, cores 16/node)."""
    cores = 16
    e = max(int(np.ceil(np.log2(max(-(-n // cores), 2)))), 1)
    dims = _pow2_split(e - 1, 4) + (2,)
    machine = bgq(dims=dims, cores_per_node=cores)
    return Allocation(machine, block_allocation(machine).coords[:n])


def _alloc_tpu_mesh(n: int, seed: int) -> Allocation:
    """TPU v5e ICI torus sized to the job (first ``n`` chips)."""
    side = 1 << max(int(np.ceil(np.log2(np.sqrt(max(n, 4))))), 1)
    machine = tpu_v5e_pod(side=side)
    return Allocation(machine, block_allocation(machine).coords[:n])


def _alloc_fat_tree(n: int, seed: int) -> Allocation:
    machine = fat_tree_machine(n)
    return Allocation(machine, block_allocation(machine).coords[:n])


_ALLOCS = {
    "xk7_sparse": _alloc_xk7_sparse,
    "bgq_block": _alloc_bgq_block,
    "tpu_mesh": _alloc_tpu_mesh,
    "fat_tree": _alloc_fat_tree,
}


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named point of the scenario cross-product."""

    workload: str
    allocation: str
    hierarchy: str = "flat"
    objective: str = "wh"
    scale: int = DEFAULT_SCALE
    seed: int = 0
    rotations: int = DEFAULT_ROTATIONS
    score_backend: str = "hopper"
    device: str = "cuda"

    def __post_init__(self):
        for field, options in (("workload", WORKLOADS),
                               ("allocation", ALLOCATIONS),
                               ("hierarchy", HIERARCHIES),
                               ("objective", OBJECTIVE_KEYS)):
            if getattr(self, field) not in options:
                raise ValueError(
                    f"unknown {field} {getattr(self, field)!r}; "
                    f"options: {options}")

    @property
    def name(self) -> str:
        return (f"{self.workload}-{self.allocation}-{self.hierarchy}-"
                f"{self.objective}")

    def graph(self) -> TaskGraph:
        return _GRAPHS[self.workload](self.scale, self.seed)

    def alloc_for(self, graph: TaskGraph) -> Allocation:
        return _ALLOCS[self.allocation](graph.n, self.seed)

    def config(self) -> PipelineConfig:
        # resolve the registry's hierarchy tag through the structured
        # spec constructor (the supported API) — never the deprecated
        # string aliases, so scenario configs are warning-free
        return PipelineConfig(sfc="FZ", shift=True,
                              rotations=self.rotations,
                              objective=OBJECTIVES[self.objective],
                              hierarchy=HierarchySpec.from_string(
                                  self.hierarchy),
                              score_backend=self.score_backend,
                              device=self.device)

    def request(self) -> MappingRequest:
        """The scenario as a serve-layer request (deterministic: same
        (scale, seed) -> bit-identical arrays -> same signature)."""
        graph = self.graph()
        return MappingRequest(graph, self.alloc_for(graph),
                              self.config())


def all_scenarios(scale: int = DEFAULT_SCALE, seed: int = 0,
                  rotations: int = DEFAULT_ROTATIONS,
                  score_backend: str = "hopper",
                  device: str = "cuda") -> list[Scenario]:
    """The full cross-product (|workloads| x |allocations| x
    |hierarchies| x |objectives| scenarios) at one scale/seed."""
    return [Scenario(w, a, h, o, scale, seed, rotations, score_backend,
                     device)
            for w in WORKLOADS for a in ALLOCATIONS
            for h in HIERARCHIES for o in OBJECTIVE_KEYS]


def scenario_names() -> list[str]:
    return [s.name for s in all_scenarios()]


def get_scenario(name: str, scale: int = DEFAULT_SCALE, seed: int = 0,
                 rotations: int = DEFAULT_ROTATIONS,
                 score_backend: str = "hopper",
                 device: str = "cuda") -> Scenario:
    """Scenario by ``workload-allocation-hierarchy-objective`` name;
    ``score_backend`` and ``device`` go into its pipeline config."""
    parts = name.split("-")
    if len(parts) != 4:
        raise ValueError(
            f"scenario name {name!r} is not "
            f"'workload-allocation-hierarchy-objective'")
    return Scenario(*parts, scale=scale, seed=seed, rotations=rotations,
                    score_backend=score_backend, device=device)
