"""The mapping pipeline: machine transforms -> partitioner -> matching
-> candidate scoring (paper Alg. 1 + §4.3, one engine for every caller).

``MappingPipeline`` owns the full Z2-style flow that used to be split
(and partially duplicated) between ``core/mapping.py::Mapper`` and
``meshmap/device_mesh.py::select_mapping``:

- :meth:`machine_coords` applies the machine-side transforms (core-dim
  drop, torus shift, bandwidth scaling, "+E" dim drops, box lift);
- :meth:`map_candidate` runs one geometric mapping (Algorithm 1) for a
  single rotation/scaling candidate through the level-synchronous
  vectorised partitioner (``backend`` selects the engine);
- :meth:`map_candidates` runs a WHOLE rotation sweep in ~2 batched
  engine passes (``sweep="batched"``, the default): the unique task and
  processor dimension permutations become outermost segments of one
  ``order_points_batched`` call per side, bit-identical to the
  per-candidate loop (``sweep="loop"``, kept as the oracle);
- :meth:`map` enumerates the rotation candidates and scores them with
  the batched :class:`repro_torch.mapping.candidates.CandidateSearch`
  (``score_backend`` selects the CUDA kernel, the plain torch scorer or
  the numpy reference; ``device`` says where the scoring runs).

``core.mapping.Mapper`` is a thin adapter over this class.  In this
package the partitioner still runs on the host; a non-flat hierarchy
and the fused whole-pipeline program are not part of it yet.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch import obs
from repro_torch.core.kmeans import closest_subset
from repro_torch.core.machine import Allocation
from repro_torch.core.mapping import MappingResult, match_parts
from repro_torch.core.orderings import (order_points, order_points_batched,
                                        resolve_partition_backend)
from repro_torch.core.transforms import (apply_permutation, box_lift,
                                         drop_dims, scale_by_bandwidth,
                                         shift_torus)
from repro_torch.hier.spec import (HierarchySpec, Level,  # noqa: F401
                                   normalize_config_hierarchy)
from repro_torch.mapping.candidates import CandidateSearch, rotation_candidates


@dataclasses.dataclass
class PipelineConfig:
    """Configuration of the unified mapping pipeline.

    Partitioner stage:
      sfc          : part-numbering ordering ("FZ" is the paper's winner).
      mfz          : use the MFZ task-side variant when pd % td == 0.
      longest_dim  : cut the longest dimension (False = strict
                     alternation).
      uneven_prime : Z2_2 — largest-prime-divisor uneven bisection.
      backend      : ``order_points`` backend ("vectorized"/"recursive").
      partition_backend : partition engine — only "numpy" (the host
                     engine) so far; any other name raises (the device
                     partitioner is a later slice of the port).
      fused        : "auto" (default) or "off".  There is no fused
                     whole-pipeline program in this package yet, so
                     both run the staged path; other values raise.

    Machine-transform stage:
      shift           : torus wrap-around shifting of machine coords.
      bandwidth_scale : Z2_2 — scale distances by 1/link-bandwidth.
      box             : Z2_3 — lift machine coords by this box shape.
      box_outer_weight: scale of the between-box coordinates.
      drop            : dims to drop from machine coords (BG/Q "+E").

    Candidate-search stage:
      rotations : 0 = identity rotation only; otherwise max number of
                  (task_perm, proc_perm) pairs evaluated.
      objective : metric key (or tuple, lexicographic) minimised by the
                  search; "weighted_hops" is the paper's choice.
      sweep     : "batched" partitions every rotation of a sweep in ~2
                  engine passes (one task-side, one proc-side batched
                  ``order_points_batched`` call over the UNIQUE
                  permutations of each side); "loop" runs
                  ``map_candidate`` per candidate — the bit-identical
                  oracle the ``candidates`` benchmark times against.
      score_backend : candidate scoring engine — "hopper" (default:
                  the CUDA kernel of :mod:`repro_torch.kernels.mapscore`),
                  "torch" (plain tensor operations on ``device``) or
                  "numpy" (host reference).  The name given is the one
                  that runs, or the pipeline raises: nothing falls back.
      device    : where scoring runs — "cuda" (default) or "cpu".
                  "cuda" with no CUDA device raises, and so does
                  "hopper" on a CPU device.  The device is not part of
                  a request's content signature: the same problem is
                  the same problem wherever it is scored.

    Hierarchy stage (:mod:`repro_torch.hier`):
      hierarchy : a :class:`repro_torch.hier.HierarchySpec` — ordered
                  coarsening levels (fine -> coarse), each with its own
                  arity and refinement budget.  ``HierarchySpec.flat()``
                  partitions one point per core (classic);
                  ``HierarchySpec.node()`` coarsens tasks into
                  node-sized clusters and sweeps at router granularity
                  (~cores_per_node x fewer points per engine pass);
                  ``HierarchySpec.with_depth(n)`` adds geometric
                  grouping levels above the node level, each dividing
                  the top-sweep point count by its arity and refining
                  on the way down.  The legacy strings "flat"/"node"
                  are accepted as deprecated aliases (normalised to
                  the equivalent spec with one DeprecationWarning).
                  Only the flat spec maps in this package so far.
      refine_rounds / refine_top / refine_degree : DEPRECATED — the old
                  flat refinement knobs.  When set (non-None) they fold
                  into every level of the spec and warn; use the
                  per-level ``Level`` budgets instead.
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
    partition_backend: str = "numpy"
    fused: str = "auto"
    objective: str | tuple = "weighted_hops"
    sweep: str = "batched"
    score_backend: str = "hopper"
    hierarchy: HierarchySpec | str = "flat"
    refine_rounds: int | None = None
    refine_top: int | None = None
    refine_degree: int | None = None
    device: str = dataclasses.field(
        default="cuda", metadata={"signature": False})

    def __post_init__(self):
        normalize_config_hierarchy(self)


# Process-wide pipeline registry: one MappingPipeline per distinct
# config and device.  Pipelines are stateless between map() calls; the
# registry lets every repeat-config caller (the serve layer above all)
# resolve its evaluator once instead of once per request.
_SHARED_PIPELINES: dict = {}
_SHARED_LOCK = threading.Lock()


def shared_pipeline(config: PipelineConfig | None = None
                    ) -> "MappingPipeline":
    """The process-wide :class:`MappingPipeline` for ``config``.

    Keyed by content (:func:`repro_torch.core.signature.config_signature`), so
    two independently-built equal configs share one pipeline instance
    per device and therefore one resolved evaluator — including under
    concurrent first calls (the serve layer maps from many threads).
    The registry never evicts: distinct pipeline configs are few (they
    are small dataclasses of knobs, not per-request data).
    """
    from repro_torch.core.signature import config_signature

    cfg = config or PipelineConfig()
    key = (config_signature(cfg), str(cfg.device))
    with _SHARED_LOCK:
        pipe = _SHARED_PIPELINES.get(key)
        if pipe is None:
            pipe = _SHARED_PIPELINES[key] = MappingPipeline(cfg)
    return pipe


class MappingPipeline:
    """Maps a TaskGraph onto an Allocation through pluggable stages."""

    def __init__(self, config: PipelineConfig | None = None):
        self.config = config or PipelineConfig()
        cfg = self.config
        # resolves the evaluator: an unknown backend, an unreachable
        # device or "hopper" on a CPU device raises HERE, at construction
        self.search = CandidateSearch(cfg.objective,
                                      backend=cfg.score_backend,
                                      device=cfg.device)
        self.partition_backend = resolve_partition_backend(
            cfg.partition_backend)
        self.order_backend = cfg.backend
        if cfg.fused not in ("auto", "off"):
            raise ValueError(f"unknown fused mode {cfg.fused!r}; "
                             "options: 'auto', 'off'")

    # -- stage 1: machine transforms ------------------------------------

    def machine_coords(self, alloc: Allocation) -> np.ndarray:
        """Apply the machine-side transforms of the pipeline.

        Core dims are dropped first: every core of a node carries its
        ROUTER's coordinates (paper §2 — coordinates come from the
        router; intra-node communication is free).  MJ then keeps a
        node's cores in consecutive parts automatically (equal
        coordinates are never separated before everything else is cut).
        """
        cfg = self.config
        machine = alloc.machine
        coords = alloc.coords.astype(np.float64)
        if machine.core_dims:
            nd = machine.ndim - machine.core_dims
            coords = coords[:, :nd]
        if cfg.shift:
            coords = shift_torus(coords, machine)
        if cfg.bandwidth_scale:
            coords = scale_by_bandwidth(coords, machine)
        if cfg.drop:
            coords = drop_dims(coords, cfg.drop)
        if cfg.box is not None:
            nd = coords.shape[1]
            box = tuple(cfg.box) + (1,) * (nd - len(cfg.box))
            coords = box_lift(coords, box, outer_weight=cfg.box_outer_weight)
        return coords

    # -- stages 2+3: partition + match for ONE candidate -----------------

    def _sfc_pair(self, td: int, pd: int) -> tuple[str, str]:
        """(task_sfc, proc_sfc) with the MFZ task-side variant when the
        processor dimensionality is a multiple of the task's."""
        cfg = self.config
        use_mfz = (cfg.mfz is True) or (
            cfg.mfz == "auto" and cfg.sfc == "FZ" and pd != td
            and pd % max(td, 1) == 0)
        if use_mfz:
            return "FZlow", "FZ"  # MFZ: flip the LOW half, smaller side
        return cfg.sfc, cfg.sfc

    def map_candidate(
        self,
        task_coords: np.ndarray,
        proc_coords: np.ndarray,
        *,
        task_weights: np.ndarray | None = None,
        task_perm=None,
        proc_perm=None,
    ) -> MappingResult:
        """Paper Algorithm 1 for one (task_perm, proc_perm) rotation."""
        cfg = self.config
        tc = np.asarray(task_coords, dtype=np.float64)
        pc = np.asarray(proc_coords, dtype=np.float64)
        if task_perm is not None:
            tc = apply_permutation(tc, task_perm)
        if proc_perm is not None:
            pc = apply_permutation(pc, proc_perm)
        tnum, td = tc.shape
        pnum, pd = pc.shape

        subset = None
        if tnum < pnum:
            subset = closest_subset(pc, tnum)
            pc = pc[subset]
            pnum = tnum
        np_parts = min(tnum, pnum)
        task_sfc, proc_sfc = self._sfc_pair(td, pd)

        mu_t = order_points(tc, np_parts, task_sfc, weights=task_weights,
                            longest_dim=cfg.longest_dim,
                            uneven_prime=cfg.uneven_prime,
                            backend=self.order_backend)
        mu_p = order_points(pc, np_parts, proc_sfc,
                            longest_dim=cfg.longest_dim,
                            uneven_prime=cfg.uneven_prime,
                            backend=self.order_backend)
        t2p = match_parts(mu_t, mu_p)
        if subset is not None:
            t2p = subset[t2p]
        return MappingResult(t2p, rotation=(tuple(task_perm or ()),
                                            tuple(proc_perm or ())))

    # -- stages 2+3 for a WHOLE rotation sweep ---------------------------

    def map_candidates(
        self,
        task_coords: np.ndarray,
        proc_coords: np.ndarray,
        cands,
        *,
        task_weights: np.ndarray | None = None,
    ) -> list:
        """Algorithm 1 for every rotation candidate of a sweep.

        A rotation only permutes the columns of one shared point cloud,
        which is equivalent to permuting the partitioner's cut-dimension
        priority (``dim_order``) over the un-permuted cloud.  The
        batched sweep therefore partitions the UNIQUE task-side and
        proc-side permutations in one ``order_points_batched`` call per
        side — ~2 engine passes for the whole sweep — and assembles the
        per-candidate ``task_to_proc`` arrays with one vectorised
        part-matching gather.  Results are bit-identical to the
        ``sweep="loop"`` per-candidate path (guarded by the
        ``candidates`` benchmark and tests/test_batched.py).

        Falls back to the loop only for the tnum < pnum closest-subset
        case (the subset's centroid iteration sums coordinates in
        column order).  Hilbert batches too: ``order_points_batched``
        treats each ``dim_orders`` row as a COLUMN permutation of the
        cloud (quantisation commutes with it), bit-identical to the
        per-candidate loop.
        """
        cfg = self.config
        tc = np.asarray(task_coords, dtype=np.float64)
        pc = np.asarray(proc_coords, dtype=np.float64)
        (tnum, td), (pnum, pd) = tc.shape, pc.shape
        if cfg.sweep == "loop" or len(cands) == 1 or tnum < pnum:
            return [
                self.map_candidate(tc, pc, task_weights=task_weights,
                                   task_perm=c.task_perm,
                                   proc_perm=c.proc_perm)
                for c in cands
            ]
        if cfg.sweep != "batched":
            raise ValueError(f"unknown sweep mode {cfg.sweep!r}")

        np_parts = min(tnum, pnum)
        task_sfc, proc_sfc = self._sfc_pair(td, pd)

        # dedup each side: many (task_perm, proc_perm) pairs share a perm
        t_perms = [tuple(c.task_perm) if c.task_perm is not None
                   else tuple(range(td)) for c in cands]
        p_perms = [tuple(c.proc_perm) if c.proc_perm is not None
                   else tuple(range(pd)) for c in cands]
        ut = sorted(set(t_perms))
        up = sorted(set(p_perms))
        t_of = {p: i for i, p in enumerate(ut)}
        p_of = {p: i for i, p in enumerate(up)}

        common = dict(longest_dim=cfg.longest_dim,
                      uneven_prime=cfg.uneven_prime,
                      backend=self.order_backend)
        mu_t = order_points_batched(tc, np_parts, task_sfc,
                                    dim_orders=np.array(ut),
                                    weights=task_weights, **common)
        mu_p = order_points_batched(pc, np_parts, proc_sfc,
                                    dim_orders=np.array(up), **common)

        # vectorised GETMAPPINGARRAYS: part -> processor per proc rotation
        # (pnum == np_parts here, so every part holds exactly one proc);
        # int32 keeps the per-candidate assembly gathers cache-friendly
        part_to_proc = np.full((len(up), np_parts), -1, dtype=np.int32)
        part_to_proc[np.arange(len(up))[:, None], mu_p] = \
            np.arange(pnum, dtype=np.int32)[None, :]
        if (part_to_proc < 0).any():
            missing = np.flatnonzero((part_to_proc < 0).any(axis=0))
            raise ValueError(f"parts with no processor: {missing[:5]}")
        mu_t = mu_t.astype(np.int32)

        return [
            MappingResult(
                part_to_proc[p_of[pp]][mu_t[t_of[tp]]],
                rotation=(tuple(c.task_perm or ()),
                          tuple(c.proc_perm or ())))
            for c, tp, pp in zip(cands, t_perms, p_perms)
        ]

    # -- stage 4: candidate search ---------------------------------------

    def map(self, graph, alloc: Allocation,
            task_coords: np.ndarray | None = None,
            task_weights: np.ndarray | None = None) -> MappingResult:
        """Full pipeline: transforms, one batched rotation sweep through
        the partitioner, batched scoring; returns the best MappingResult
        (score = objective).

        A non-flat :class:`HierarchySpec` raises
        ``NotImplementedError``: the hierarchical path (coarsen, sweep
        at the top granularity, expand and refine level by level) is a
        later slice of the port.
        """
        cfg = self.config
        if not isinstance(cfg.hierarchy, HierarchySpec):
            # configs are validated at construction; this only fires
            # when a caller mutates cfg.hierarchy afterwards
            normalize_config_hierarchy(cfg)
        if not cfg.hierarchy.is_flat:
            raise NotImplementedError(
                f"hierarchy {cfg.hierarchy.kind!r} is not mapped by "
                "repro_torch yet: the hierarchical path (repro.hier) "
                "belongs to a later slice of the port; use "
                "HierarchySpec.flat()")
        # span-derived stage timings (repro_torch.obs): the spans ARE the
        # clocks — ``stats["timings"]`` is {partition_s, score_s,
        # total_s}, derived from the span durations
        timings = {}
        with obs.span("pipeline.map", hierarchy="flat",
                      partition_backend=self.partition_backend,
                      score_backend=cfg.score_backend,
                      device=str(cfg.device)) as root:
            pc = self.machine_coords(alloc)
            tc = np.asarray(task_coords if task_coords is not None
                            else graph.coords, dtype=np.float64)
            cands = rotation_candidates(tc.shape[1], pc.shape[1],
                                        cfg.rotations)
            sweep_points = int(len(tc) + alloc.n)
            root.annotate(sweep_points=sweep_points,
                          candidates=len(cands))
            with obs.span("pipeline.partition",
                          points=sweep_points) as sp:
                results = self.map_candidates(
                    tc, pc, cands, task_weights=task_weights)
            timings["partition_s"] = sp.duration_s
            with obs.span("pipeline.score",
                          candidates=len(cands)) as sp:
                if len(results) == 1:
                    best = results[0]
                else:
                    best, best_i, scores = self.search.best(
                        graph, alloc, results)
                    best.score = float(scores[best_i][0])
            timings["score_s"] = sp.duration_s
        timings["total_s"] = root.duration_s
        # stats schema v2: ONE per-level entry per mapped granularity
        # (flat = the single core level); the legacy keys (hierarchy /
        # sweep_points / timings) stay derived — see README
        # "MappingResult.stats schema"
        map_s = timings["partition_s"] + timings["score_s"]
        best.stats.update(
            schema=2,
            hierarchy="flat",
            depth=1,
            levels=[{"level": 0, "name": "core",
                     "points": sweep_points,
                     "clusters": int(len(tc)), "units": int(alloc.n),
                     "coarsen_s": 0.0, "map_s": map_s, "refine_s": 0.0,
                     "refine_accepted": 0, "refine_evaluated": 0}],
            sweep_points=sweep_points,
            partition_backend=self.partition_backend,
            timings=timings,
            trace_id=root.trace_id)
        return best
