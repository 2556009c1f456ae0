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
  the numpy reference; ``device`` says where the partitioner and the
  scoring run), or runs the whole sweep on the device in one pass
  (:mod:`repro_torch.mapping.fused`).

``core.mapping.Mapper`` is a thin adapter over this class.  A non-flat
hierarchy maps through :func:`repro_torch.hier.levels.map_hierarchical`.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kmeans import closest_subset
from repro_torch.core.machine import Allocation
from repro_torch.core.mapping import MappingResult, match_parts
from repro_torch.core.orderings import (order_points, order_points_batched,
                                        resolve_partition_backend)
from repro_torch.core.partition_torch import partition
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
      partition_backend : partition engine — "torch" (default: the
                     device sweep of
                     :mod:`repro_torch.core.partition_torch` on
                     ``device``) or "numpy" (the host engine, the
                     oracle).  Both return bit-identical permutations;
                     any other name raises, and so does "torch" on an
                     unreachable device.  With a "torch"/"hopper" score
                     backend and the batched vectorized sweep, the whole
                     partition -> match -> score -> select chain runs on
                     the device in one pass (:mod:`repro_torch.mapping.fused`).
      fused        : "auto" (default) takes that one-pass sweep whenever
                     the backends allow it; "off" forces the staged path;
                     other values raise.

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
      device    : where the "torch" partitioner and the scoring run —
                  "cuda" (default) or "cpu".  "cuda" with no CUDA
                  device raises, and so does "hopper" on a CPU device.
                  The device is not part of a request's content
                  signature: the same problem is
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
    partition_backend: str = "torch"
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


@dataclasses.dataclass
class SweepPlan:
    """The two partitioner calls of one batched rotation sweep.

    ``task`` / ``proc`` are each side's keyword arguments of
    ``order_points_batched`` (and of the device engine's ``upload``),
    with one ``dim_orders`` row per UNIQUE rotation of that side;
    ``t_sel`` / ``p_sel`` ((ncand,) int64) give each candidate's row.
    """

    task: dict
    proc: dict
    t_sel: np.ndarray
    p_sel: np.ndarray


def _unique_perms(perms, d: int) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique permutations, each entry's row among them); None
    is the identity."""
    rows = [tuple(p) if p is not None else tuple(range(d)) for p in perms]
    uniq = sorted(set(rows))
    of = {p: i for i, p in enumerate(uniq)}
    return (np.array(uniq, dtype=np.int64),
            np.array([of[p] for p in rows], dtype=np.int64))


def rotation_of(c) -> tuple:
    """A candidate's ``MappingResult.rotation``."""
    return (tuple(c.task_perm or ()), tuple(c.proc_perm or ()))


def assign_parts(mu_t, mu_p, t_sel, p_sel):
    """GETMAPPINGARRAYS for a whole sweep, in tensor operations on the
    part numbers' device: the part -> processor table of every proc
    rotation (pnum == nparts, so each part holds one processor), then
    each candidate's (ncand, tnum) int64 task -> processor through it.
    Returns ``(t2p, ptp)``; ``ptp < 0`` marks a part with no processor.
    Nothing is read back."""
    ptp = torch.full_like(mu_p, -1)
    ptp.scatter_(1, mu_p, torch.arange(mu_p.shape[1], dtype=mu_p.dtype,
                                       device=mu_p.device).expand_as(mu_p))
    return ptp[p_sel].gather(1, mu_t[t_sel]), ptp


def missing_parts(ptp) -> ValueError:
    """The error for a part table with parts no processor holds."""
    missing = torch.nonzero((ptp < 0).any(dim=0)).flatten().cpu().numpy()
    return ValueError(f"parts with no processor: {missing[:5]}")


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
            cfg.partition_backend, cfg.device)
        self.order_backend = ("torch" if (self.partition_backend == "torch"
                                          and cfg.backend == "vectorized")
                              else cfg.backend)
        if cfg.fused not in ("auto", "off"):
            raise ValueError(f"unknown fused mode {cfg.fused!r}; "
                             "options: 'auto', 'off'")
        # the one-pass device sweep: partition + match + score + select
        # on the device, when both stages run there and the sweep is the
        # batched vectorized one (the fused gathers mirror it exactly)
        self._fused = None
        if (cfg.fused != "off" and self.order_backend == "torch"
                and cfg.sweep == "batched"
                and self.search.backend in ("torch", "hopper")):
            from repro_torch.mapping.fused import FusedSweep
            self._fused = FusedSweep(self, self.search.backend)

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
                            backend=self.order_backend, device=cfg.device)
        mu_p = order_points(pc, np_parts, proc_sfc,
                            longest_dim=cfg.longest_dim,
                            uneven_prime=cfg.uneven_prime,
                            backend=self.order_backend, device=cfg.device)
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
        tc = np.asarray(task_coords, dtype=np.float64)
        pc = np.asarray(proc_coords, dtype=np.float64)
        if self._per_candidate(tc, pc, cands):
            return [
                self.map_candidate(tc, pc, task_weights=task_weights,
                                   task_perm=c.task_perm,
                                   proc_perm=c.proc_perm)
                for c in cands
            ]
        t2p = self._sweep_t2p(self.sweep_plan(tc, pc, cands, task_weights))
        return [MappingResult(row, rotation=rotation_of(c))
                for row, c in zip(t2p.to(torch.int32).cpu().numpy(), cands)]

    def _per_candidate(self, tc, pc, cands) -> bool:
        """Whether a sweep loops ``map_candidate`` (the oracle, one
        candidate, or the tnum < pnum closest-subset case, whose
        centroid iteration sums coordinates in column order)."""
        cfg = self.config
        if cfg.sweep == "loop" or len(cands) == 1 or len(tc) < len(pc):
            return True
        if cfg.sweep != "batched":
            raise ValueError(f"unknown sweep mode {cfg.sweep!r}")
        return False

    def sweep_plan(self, tc, pc, cands, task_weights=None) -> SweepPlan:
        """Both partitioner calls of a batched sweep over the UNIQUE
        rotations of each side (many candidates share a permutation)."""
        cfg = self.config
        (tnum, td), (pnum, pd) = tc.shape, pc.shape
        task_sfc, proc_sfc = self._sfc_pair(td, pd)
        ut, t_sel = _unique_perms([c.task_perm for c in cands], td)
        up, p_sel = _unique_perms([c.proc_perm for c in cands], pd)
        common = dict(nparts=min(tnum, pnum), longest_dim=cfg.longest_dim,
                      uneven_prime=cfg.uneven_prime)
        return SweepPlan(
            task=dict(coords=tc, sfc=task_sfc, dim_orders=ut,
                      weights=task_weights, **common),
            proc=dict(coords=pc, sfc=proc_sfc, dim_orders=up,
                      weights=None, **common),
            t_sel=t_sel, p_sel=p_sel)

    def _sweep_t2p(self, plan: SweepPlan) -> torch.Tensor:
        """Every candidate's task -> processor of a batched sweep, on
        the partition engine's device (the host for the numpy engine);
        a part with no processor raises."""
        if self.order_backend == "torch":
            dev = torch.device(self.config.device)
            sel = [torch.from_numpy(s).to(dev)
                   for s in (plan.t_sel, plan.p_sel)]
            mu = [partition(**kw, device=dev)
                  for kw in (plan.task, plan.proc)]
        else:
            sel = [torch.from_numpy(s) for s in (plan.t_sel, plan.p_sel)]
            mu = [torch.from_numpy(order_points_batched(
                **kw, backend=self.order_backend))
                for kw in (plan.task, plan.proc)]
        t2p, ptp = assign_parts(*mu, *sel)
        if bool((ptp < 0).any()):
            raise missing_parts(ptp)
        return t2p

    # -- stage 4: candidate search ---------------------------------------

    def map(self, graph, alloc: Allocation,
            task_coords: np.ndarray | None = None,
            task_weights: np.ndarray | None = None) -> MappingResult:
        """Full pipeline: transforms, one batched rotation sweep through
        the partitioner, batched scoring; returns the best MappingResult
        (score = objective).

        A non-flat :class:`HierarchySpec` routes through
        :mod:`repro_torch.hier` instead: coarsen tasks level by level,
        run the SAME rotation sweep at the TOP granularity (with a
        ``swap`` top level, the one-pass device sweep folds that level's
        refinement in), then expand downward one level at a time with a
        refinement pass per level.
        """
        cfg = self.config
        if not isinstance(cfg.hierarchy, HierarchySpec):
            # configs are validated at construction; this only fires
            # when a caller mutates cfg.hierarchy afterwards
            normalize_config_hierarchy(cfg)
        if not cfg.hierarchy.is_flat:
            from repro_torch.hier.levels import map_hierarchical
            return map_hierarchical(self, graph, alloc,
                                    task_coords=task_coords,
                                    task_weights=task_weights)
        # span-derived stage timings (repro_torch.obs): the spans ARE the
        # clocks — ``stats["timings"]`` is {fused_s | partition_s +
        # score_s} + total_s, derived from the span durations
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
            best = None
            if self._fused is not None:
                with obs.span("pipeline.fused") as sp:
                    best = self._fused.run(graph, alloc, tc, pc, cands,
                                           task_weights=task_weights)
                if best is not None:
                    # partition + match + score ran as one device pass;
                    # the stage split does not exist here
                    timings["fused_s"] = sp.duration_s
            if best is None:
                with obs.span("pipeline.partition",
                              points=sweep_points) as sp:
                    if self._per_candidate(tc, pc, cands):
                        results = self.map_candidates(
                            tc, pc, cands, task_weights=task_weights)
                        t2p = np.stack([r.task_to_proc for r in results])
                    else:
                        t2p = self._sweep_t2p(self.sweep_plan(
                            tc, pc, cands, task_weights))
                timings["partition_s"] = sp.duration_s
                with obs.span("pipeline.score",
                              candidates=len(cands)) as sp:
                    best_i, score = 0, float("nan")
                    if len(cands) > 1:
                        best_i, scores = self.search.best_of(
                            graph, alloc, t2p)
                        score = float(scores[best_i][0])
                    row = t2p[best_i]
                    if isinstance(row, torch.Tensor):
                        row = row.to(torch.int32).cpu().numpy()
                    best = MappingResult(row, score=score,
                                         rotation=rotation_of(cands[best_i]))
                timings["score_s"] = sp.duration_s
        timings["total_s"] = root.duration_s
        # stats schema v2: ONE per-level entry per mapped granularity
        # (flat = the single core level); the legacy keys (hierarchy /
        # sweep_points / timings) stay derived — see README
        # "MappingResult.stats schema"
        map_s = timings.get(
            "fused_s",
            timings.get("partition_s", 0.0) + timings.get("score_s", 0.0))
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
