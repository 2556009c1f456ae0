"""Task mapping via consistent geometric ordering (paper §4, Alg. 1).

``geometric_map`` is Algorithm 1: order task coordinates and processor
coordinates with the same Multi-Jagged recursion (+SFC part numbering)
and match equal part numbers.  ``Mapper`` wraps the full Z2 pipeline
(shift, bandwidth scaling, box lift, +E, rotation search).

Both are thin adapters over :mod:`repro_torch.mapping` — the unified mapping
pipeline whose stages (machine transforms -> partitioner backend ->
part matching -> batched candidate scoring) exist exactly once.
This module hosts the result/matching primitives; the pipeline imports
them (never the other way around), keeping the import graph acyclic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import metrics as M
from .machine import Allocation
from .taskgraph import TaskGraph


@dataclasses.dataclass
class MappingResult:
    """task_to_proc[t] = index into the processor coordinate array.

    For tnum > pnum several tasks share a processor.  ``proc_to_tasks`` is
    a list of task-index arrays per processor.  ``rotation`` records the
    winning (task_perm, proc_perm) of the rotation search; ``score`` its
    objective value (WeightedHops for the classic search).  ``stats``
    carries pipeline-reported accounting (engine-pass point counts, the
    hierarchical coarsening/refinement summary, ...) for benchmarks and
    tests; it never affects the mapping itself.
    """

    task_to_proc: np.ndarray
    rotation: tuple = ((), ())
    score: float = float("nan")
    stats: dict = dataclasses.field(default_factory=dict)

    def proc_to_tasks(self, pnum: int) -> list:
        out = [[] for _ in range(pnum)]
        for t, p in enumerate(self.task_to_proc):
            out[p].append(t)
        return [np.array(x, dtype=np.int64) for x in out]


def match_parts(mu_task: np.ndarray, mu_proc: np.ndarray) -> np.ndarray:
    """task_to_proc from equal part numbers (paper GETMAPPINGARRAYS).

    When several tasks share a part (tnum > pnum) they all map to the
    processor holding that part.  When parts hold one task and one
    processor (tnum == pnum) this is the paper's 1:1 case.
    """
    nparts = int(mu_proc.max()) + 1
    part_to_proc = np.full(nparts, -1, dtype=np.int64)
    part_to_proc[mu_proc] = np.arange(len(mu_proc))
    if (part_to_proc < 0).any():
        # multiple procs per part (pnum > nparts): keep first occurrence
        missing = np.flatnonzero(part_to_proc < 0)
        raise ValueError(f"parts with no processor: {missing[:5]}")
    return part_to_proc[mu_task]


_match_parts = match_parts  # backwards-compatible alias


def geometric_map(
    task_coords: np.ndarray,
    proc_coords: np.ndarray,
    *,
    sfc: str = "FZ",
    mfz: str | bool = "auto",
    longest_dim: bool = True,
    uneven_prime: bool = False,
    task_weights: np.ndarray | None = None,
    task_perm=None,
    proc_perm=None,
    backend: str = "vectorized",
) -> MappingResult:
    """Paper Algorithm 1 for one (task_perm, proc_perm) rotation.

    Partition and match only: nothing is scored, so the pipeline behind
    it is built with the host partitioner and the host scorer and
    touches no device (``backend`` picks the host engine, as in the
    reference).
    """
    from repro_torch.mapping.pipeline import MappingPipeline, PipelineConfig
    pipe = MappingPipeline(PipelineConfig(
        sfc=sfc, mfz=mfz, longest_dim=longest_dim,
        uneven_prime=uneven_prime, backend=backend,
        partition_backend="numpy", score_backend="numpy", device="cpu"))
    return pipe.map_candidate(task_coords, proc_coords,
                              task_weights=task_weights,
                              task_perm=task_perm, proc_perm=proc_perm)


# ---------------------------------------------------------------------------
# Full Z2 pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapperConfig:
    """Configuration of the Z2-style mapper.

    sfc            : part-numbering ordering ("FZ" is the paper's winner).
    mfz            : use the MFZ task-side variant when pd % td == 0.
    shift          : torus wrap-around shifting of machine coords.
    bandwidth_scale: Z2_2 — scale distances by 1/link-bandwidth.
    box            : Z2_3 — lift machine coords by this box shape (None=off).
    box_outer_weight: scale of the between-box coordinates.
    drop           : dims to drop from machine coords (BG/Q "+E").
    rotations      : 0 = identity only; otherwise max number of
                     (task!, proc!) permutation pairs evaluated, keeping
                     the best WeightedHops (paper's rotation search).
    uneven_prime   : Z2_2 — largest-prime-divisor uneven bisection.
    longest_dim    : cut the longest dimension (False = strict alternation).
    backend        : partitioner engine ("vectorized" or "recursive").
    partition_backend : partition engine ("torch", the device sweep, by
                     default; "numpy" the host engine).
    fused          : "auto" (the one-pass device sweep where the
                     backends allow it) or "off" (the staged path).
    sweep          : rotation-sweep mode ("batched" = ~2 engine passes
                     for the whole sweep; "loop" = per-candidate oracle).
    score_backend  : candidate scoring engine ("hopper", "torch" or
                     "numpy"; the name given runs or the mapper raises).
    device         : where the device partitioner and the scoring run
                     ("cuda" by default, or "cpu").
    hierarchy      : a :class:`repro_torch.hier.HierarchySpec` (ordered
                     coarsening levels with per-level refine budgets;
                     ``HierarchySpec.flat()`` / ``.node()`` /
                     ``.with_depth(n)``); the legacy "flat"/"node"
                     strings are deprecated aliases.
    refine_rounds / refine_top / refine_degree : DEPRECATED flat
                     refinement knobs — non-None values fold into every
                     spec level with a DeprecationWarning.
    """

    sfc: str = "FZ"
    mfz: str | bool = "auto"
    shift: bool = True
    bandwidth_scale: bool = False
    box: tuple | None = None
    box_outer_weight: float = 16.0
    drop: tuple = ()
    rotations: int = 0
    uneven_prime: bool = False
    longest_dim: bool = True
    backend: str = "vectorized"
    partition_backend: str = "torch"
    fused: str = "auto"
    sweep: str = "batched"
    score_backend: str = "hopper"
    hierarchy: object = "flat"
    refine_rounds: int | None = None
    refine_top: int | None = None
    refine_degree: int | None = None
    device: str = "cuda"

    def __post_init__(self):
        from repro_torch.hier.spec import normalize_config_hierarchy
        normalize_config_hierarchy(self)


class Mapper:
    """Maps a TaskGraph onto an Allocation (the paper's Z2).

    Delegates to :class:`repro_torch.mapping.MappingPipeline` with the
    paper's objective (WeightedHops) — kept as the stable public API.
    """

    def __init__(self, config: MapperConfig | None = None):
        from repro_torch.mapping.pipeline import (MappingPipeline,
                                                  PipelineConfig)
        self.config = config or MapperConfig()
        # shallow per-field forwarding (NOT dataclasses.asdict, which
        # would deep-convert the nested HierarchySpec into plain dicts)
        kw = {f.name: getattr(self.config, f.name)
              for f in dataclasses.fields(self.config)}
        self.pipeline = MappingPipeline(PipelineConfig(
            objective="weighted_hops", **kw))

    def machine_coords(self, alloc: Allocation) -> np.ndarray:
        """Machine-side transform stage (see MappingPipeline)."""
        return self.pipeline.machine_coords(alloc)

    def map(self, graph: TaskGraph, alloc: Allocation,
            task_coords: np.ndarray | None = None) -> MappingResult:
        return self.pipeline.map(graph, alloc, task_coords=task_coords)


def evaluate(graph: TaskGraph, alloc: Allocation, res: MappingResult) -> dict:
    """All paper metrics (§3) for a mapping result."""
    task_to_coord = alloc.coords[res.task_to_proc]
    return M.evaluate_mapping(alloc.machine, graph.edges, graph.weights,
                              task_to_coord)


def identity_mapping(graph: TaskGraph, alloc: Allocation) -> MappingResult:
    """Task i -> core i in allocation order (the "default" mapping of the
    paper's applications: MPI rank order)."""
    n = graph.n
    return MappingResult(np.arange(n) % alloc.n)
