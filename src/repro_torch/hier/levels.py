"""N-level (coarsen* -> map -> refine/expand*) hierarchical mapping.

``map_hierarchical`` maps a task graph through an arbitrary-depth
recursive hierarchy described by the pipeline config's
:class:`repro_torch.hier.HierarchySpec` (the recursive level
structure of Schulz & Woydt's shared-memory hierarchical process
mapping):

1. **coarsen, level by level** — the task graph is contracted bottom-up
   with :func:`repro_torch.hier.aggregate.aggregate_tasks` (one
   contraction per level; level 1 groups tasks into node-sized
   clusters, level j groups level j-1 clusters by the level's arity).
   The machine side mirrors it: level 1 units are the allocation's
   routers (:func:`router_view`), level j units are geometric groups of
   level j-1 units (:func:`group_units`) represented by their MEDOID —
   a real member's integer coordinates, so hop metrics treat a group
   exactly like a router.
2. **map at the top** — the UNCHANGED rotation sweep
   (``MappingPipeline.best_rotation``: the staged sweep, or the
   one-pass device sweep of :mod:`repro_torch.mapping.fused`, which
   then also runs a ``swap`` top level's refinement) runs once, at the
   top granularity: every added level divides the sweep's point count
   by its arity.
3. **expand downward, refining per level** — from the top down, each
   level's assignment is refined (``refine_mode="swap"`` — the
   bounded greedy network-nearest pass, fused-foldable;
   ``"qap"`` — the sparse-QAP local search of Schulz & Träff, see
   :func:`repro_torch.hier.refine.refine_qap`) and then expanded one
   level with :func:`repro_torch.hier.refine.assign_cores` (children
   dealt onto their group's member units in SFC order), until tasks sit
   on cores.

The coarsening labels come from the pipeline's partition engine (the
device partitioner by default); every contraction
(:mod:`repro_torch.hier.aggregate`: the ``contract`` kernels on a card)
and every expansion (the ``coredeal`` kernels) runs on the pipeline's
``device``; the
refinement passes score with the pipeline's ``score_backend`` on its
``device`` (the mapscore kernel by default) except for sum-separable
objectives, which the numpy evaluator scores exactly.  Every decision
is the reference's: the same calls, arguments and order, so the answers
equal the reference's bit for bit (tests/test_torch_hier.py).  Because
every task inherits its node's router coordinates, the level-1 refined score
equals the fine mapping's volume-weighted metrics exactly, whatever
the depth.
"""

from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.machine import Allocation
from repro_torch.core.mapping import MappingResult
from repro_torch.core.orderings import hilbert_key, order_points

from .aggregate import aggregate_tasks
from .refine import assign_cores, polish_groups, refine_qap, refine_swaps
from .spec import DEFAULT_GROUP_ARITY


def router_view(alloc: Allocation):
    """Collapse a core-granularity allocation to its routers.

    Returns ``(router_coords, core_router, router_alloc)``:

    router_coords : (r, nd_net) int coordinates of the distinct routers.
    core_router   : (ncores,) router id of every allocation core row.
    router_alloc  : an :class:`Allocation` with ONE row per router
                    (core dims zero-padded) — a drop-in for the machine
                    transforms and the candidate scorer.
    """
    machine = alloc.machine
    nd = machine.ndim - machine.core_dims
    rows = np.asarray(alloc.coords[:, :nd], dtype=np.int64)
    # flat router keys instead of np.unique(axis=0): one 1D unique pass
    # (the structured-dtype row compare is ~10x slower at 2^18 cores)
    rdims = machine.dims[:nd]
    keys = np.ravel_multi_index(tuple(rows.T), rdims)
    ukeys, core_router = np.unique(keys, return_inverse=True)
    router_coords = np.stack(np.unravel_index(ukeys, rdims), axis=1)
    core_router = core_router.reshape(-1)
    pad = np.zeros((len(router_coords), machine.core_dims), dtype=np.int64)
    router_alloc = Allocation(
        machine, np.concatenate([router_coords, pad], axis=1))
    return router_coords, core_router, router_alloc


def group_units(unit_coords: np.ndarray, ngroups: int, *,
                sfc: str = "FZ", longest_dim: bool = True,
                uneven_prime: bool = False,
                backend: str = "torch", device="cuda"):
    """Geometrically group machine units (routers, or groups thereof).

    One ``order_points`` pass over the unit coordinates (on ``device``
    for ``backend="torch"``) — the same
    Multi-Jagged machinery that groups the task side — yields balanced
    group labels; each group is then REPRESENTED by its medoid: the
    member unit closest to the group centroid (squared Euclidean,
    lowest unit id on ties).  Medoids are real machine coordinates, so
    ``pairwise_hops`` / the rotation sweep / the swap refinement treat
    a group of nodes exactly like a single router.

    Returns ``(labels, rep_coords)`` — (n,) group id per unit and
    (ngroups, nd) integer medoid coordinates.
    """
    unit_coords = np.asarray(unit_coords)
    fc = unit_coords.astype(np.float64)
    labels = order_points(fc, int(ngroups), sfc,
                          longest_dim=longest_dim,
                          uneven_prime=uneven_prime, backend=backend,
                          device=device)
    counts = np.maximum(np.bincount(labels, minlength=ngroups), 1)
    cents = np.stack([
        np.bincount(labels, weights=fc[:, j], minlength=ngroups) / counts
        for j in range(fc.shape[1])], axis=1)
    d2 = ((fc - cents[labels]) ** 2).sum(axis=1)
    # first-per-group of the (group, distance, id) stable order = medoid
    order = np.lexsort((np.arange(len(fc)), d2, labels))
    first = np.searchsorted(labels[order], np.arange(ngroups))
    return labels, unit_coords[order[first]]


def map_hierarchical(
    pipe,
    graph,
    alloc: Allocation,
    task_coords: np.ndarray | None = None,
    task_weights: np.ndarray | None = None,
) -> MappingResult:
    """Hierarchical coarsen* -> map -> refine/expand* for ``pipe``'s
    config (``pipe.config.hierarchy`` is a non-flat
    :class:`HierarchySpec`).

    ``pipe`` is the owning :class:`repro_torch.mapping.MappingPipeline`; its
    config controls the partitioner/sweep/scoring stages exactly as in
    the flat path, plus the per-level arities and refinement budgets.
    Returns a core-level :class:`MappingResult` whose ``stats`` carry
    the schema-v2 per-level breakdown (``stats["levels"]``) plus the
    legacy flat keys, derived for one release.
    """
    from repro_torch.mapping.candidates import rotation_candidates

    cfg = pipe.config
    spec = cfg.hierarchy
    levels = spec.levels  # fine -> coarse; T = len(levels) granularities
    T = len(levels)
    machine = alloc.machine
    tc = np.asarray(task_coords if task_coords is not None
                    else graph.coords, dtype=np.float64)
    tnum = len(tc)

    router_coords, core_router, router_alloc = router_view(alloc)
    nrouters = len(router_coords)
    cores_per_node = max(1, -(-alloc.n // nrouters))  # ceil: max cores/router

    # per-level unit/cluster counts (pure integer math, so the root
    # span can carry the top sweep size up front).  Level 1 clusters:
    # one per allocated node (fewer when the job has fewer tasks than
    # nodes; the coarse map then picks the closest unit subset exactly
    # like the flat tnum < pnum case).  Level j >= 2 groups the level
    # below by the level's arity, on both sides.
    arities = [levels[0].arity or cores_per_node]
    arities += [lv.arity or DEFAULT_GROUP_ARITY for lv in levels[1:]]
    unit_counts = [nrouters]
    cluster_counts = [min(nrouters, max(1, -(-tnum // arities[0])))]
    for a in arities[1:]:
        unit_counts.append(max(1, -(-unit_counts[-1] // a)))
        cluster_counts.append(
            min(unit_counts[-1], max(1, -(-cluster_counts[-1] // a))))

    timings = {"coarsen_s": 0.0, "refine_s": 0.0}
    level_stats = [
        {"level": i + 1, "name": levels[i].name,
         "points": int(cluster_counts[i] + unit_counts[i]),
         "clusters": int(cluster_counts[i]),
         "units": int(unit_counts[i]),
         "coarsen_s": 0.0, "map_s": 0.0, "refine_s": 0.0,
         "refine_accepted": 0, "refine_evaluated": 0}
        for i in range(T)]

    with obs.span("pipeline.map", hierarchy=spec.kind,
                  depth=int(spec.depth),
                  partition_backend=pipe.partition_backend,
                  score_backend=cfg.score_backend,
                  device=str(cfg.device),
                  sweep_points=int(cluster_counts[-1] + unit_counts[-1])
                  ) as root:
        # -- stage 1: coarsen bottom-up, both sides ---------------------
        aggs = []      # aggs[i]: Aggregation at level i+1
        m_coords = []  # m_coords[i]: unit int coords at level i+1
        m_member = []  # m_member[i]: level-i unit -> level-(i+1) unit
        for i in range(T):
            fine_n = tnum if i == 0 else aggs[i - 1].nclusters
            with obs.span("pipeline.coarsen", level=i + 1,
                          points=int(fine_n),
                          nclusters=int(cluster_counts[i])) as sp:
                if i == 0:
                    aggs.append(aggregate_tasks(
                        graph, cluster_counts[0], task_coords=tc,
                        task_weights=task_weights,
                        sfc=cfg.sfc, longest_dim=cfg.longest_dim,
                        uneven_prime=cfg.uneven_prime,
                        backend=pipe.order_backend, device=cfg.device))
                    m_coords.append(router_coords)
                    m_member.append(core_router)
                else:
                    aggs.append(aggregate_tasks(
                        aggs[i - 1].coarse, cluster_counts[i],
                        task_weights=aggs[i - 1].weights,
                        sfc=cfg.sfc, longest_dim=cfg.longest_dim,
                        uneven_prime=cfg.uneven_prime,
                        backend=pipe.order_backend, device=cfg.device))
                    member, reps = group_units(
                        m_coords[i - 1], unit_counts[i], sfc=cfg.sfc,
                        longest_dim=cfg.longest_dim,
                        uneven_prime=cfg.uneven_prime,
                        backend=pipe.order_backend, device=cfg.device)
                    m_coords.append(reps)
                    m_member.append(member)
            timings["coarsen_s"] += sp.duration_s
            level_stats[i]["coarsen_s"] = sp.duration_s

        # -- stage 2: the UNCHANGED batched rotation sweep, at the TOP
        # granularity (depth 2: router granularity)
        top = T - 1
        if top == 0:
            top_alloc = router_alloc
        else:
            pad = np.zeros((len(m_coords[top]), machine.core_dims),
                           dtype=np.int64)
            top_alloc = Allocation(
                machine, np.concatenate([m_coords[top], pad], axis=1))
        pc = pipe.machine_coords(top_alloc)
        cands = rotation_candidates(aggs[top].coarse.coords.shape[1],
                                    pc.shape[1], cfg.rotations)
        root.annotate(candidates=len(cands))
        coarse_best, sweep_t = pipe.best_rotation(
            aggs[top].coarse, top_alloc, aggs[top].coarse.coords, pc,
            cands, task_weights=aggs[top].weights)
        timings.update(sweep_t)
        level_stats[top]["map_s"] = sum(sweep_t.values())

        # -- stage 3: refine + expand, top-down -------------------------
        # When the fused program already refined the top level on
        # device, its refine span only unpacks stats and expands — the
        # stats/timings schema is the same either way (refine_s always
        # present).
        fused_refined = coarse_best.stats.get("fused_refine", False)
        cur = np.asarray(coarse_best.task_to_proc, dtype=np.int64)
        # the winning rotation of the top sweep, applied to BOTH sides
        # of every group-level expansion below: Alg. 1's consistent-
        # ordering requirement extends into the groups — matching
        # Hilbert curves drawn in UNROTATED task/machine axes would
        # misalign every group interior the sweep just aligned
        tperm, pperm = coarse_best.rotation
        tperm = np.asarray(tperm, dtype=np.int64) if len(tperm) else None
        pperm = np.asarray(pperm, dtype=np.int64) if len(pperm) else None
        rstats = None  # level-1 refinement stats (the legacy flat keys)
        for i in range(top, -1, -1):
            lvl = levels[i]
            with obs.span("pipeline.refine", level=i + 1,
                          rounds=int(lvl.refine_rounds),
                          mode=lvl.refine_mode,
                          fused=bool(fused_refined and i == top)) as sp:
                if fused_refined and i == top:
                    rstats_i = {k: coarse_best.stats[k] for k in (
                        "refine_rounds_run", "refine_accepted",
                        "refine_evaluated", "refine_history",
                        "refine_initial", "refine_final")}
                else:
                    refine = (refine_swaps if lvl.refine_mode == "swap"
                              else refine_qap)
                    cur, rstats_i = refine(
                        machine, aggs[i].coarse, m_coords[i], cur,
                        objective=pipe.objective, rounds=lvl.refine_rounds,
                        top=lvl.refine_top, degree=lvl.refine_degree,
                        score_backend=cfg.score_backend, device=cfg.device)
                if i > 0:
                    # one-level expansion as a per-group GEOMETRIC
                    # match (paper Alg. 1's consistent-ordering trick):
                    # assign_cores deals Hilbert-ordered children onto
                    # member units in input order, so presenting each
                    # group's units in THEIR intra-group Hilbert order
                    # aligns both curves.  (The i == 0 core expansion
                    # keeps allocation order: cores of a node are hop-0,
                    # order cannot change a metric.)
                    child = aggs[i - 1].coarse.coords
                    if tperm is not None and child.shape[1] == len(tperm):
                        child = child[:, tperm]
                    units = m_coords[i - 1].astype(np.float64)
                    if pperm is not None and units.shape[1] == len(pperm):
                        units = units[:, pperm]
                    sub = np.lexsort((hilbert_key(units), m_member[i]))
                    cur = sub[assign_cores(
                        aggs[i].labels, cur, m_member[i][sub], child,
                        len(m_coords[i]), device=cfg.device)]
                else:
                    t2p = assign_cores(aggs[0].labels, cur, core_router, tc,
                                       nrouters, device=cfg.device)
            timings["refine_s"] += sp.duration_s
            level_stats[i]["refine_s"] = sp.duration_s
            level_stats[i]["refine_accepted"] = \
                rstats_i["refine_accepted"]
            level_stats[i]["refine_evaluated"] = \
                rstats_i["refine_evaluated"]
            level_stats[i]["refine_history"] = rstats_i["refine_history"]
            rstats = rstats_i
            if i > 0 and levels[i - 1].polish_rounds > 0:
                # intra-group polish of the freshly expanded level-i
                # assignment: the expansion above ordered each group's
                # members by geometry alone, blind to where their heavy
                # edges point; this repairs every group interior at
                # once with exact KL deltas BEFORE the level's own
                # bounded refinement (next loop iteration) spends its
                # budget on the residual
                with obs.span("pipeline.polish", level=i,
                              rounds=int(levels[i - 1].polish_rounds)
                              ) as psp:
                    cur, pstats = polish_groups(
                        machine, aggs[i - 1].coarse, m_coords[i - 1],
                        cur, m_member[i],
                        objective=pipe.objective,
                        rounds=levels[i - 1].polish_rounds,
                        score_backend=cfg.score_backend,
                        device=cfg.device)
                timings["refine_s"] += psp.duration_s
                level_stats[i - 1]["polish_s"] = psp.duration_s
                for k in ("polish_rounds_run", "polish_accepted",
                          "polish_evaluated", "polish_initial",
                          "polish_final"):
                    level_stats[i - 1][k] = pstats[k]
    timings["total_s"] = root.duration_s

    stats = {
        # -- schema v2: the per-level breakdown -------------------------
        "schema": 2,
        "hierarchy": spec.kind,
        "depth": int(spec.depth),
        "levels": level_stats,
        # -- legacy keys, derived for one release (README schema doc) --
        "nclusters": int(cluster_counts[0]),
        "nrouters": int(nrouters),
        "cores_per_node": int(cores_per_node),
        "intra_volume": aggs[0].intra_volume,
        # points partitioned by ONE engine pass of the rotation sweep
        # (flat partitions tnum tasks + alloc.n cores instead)
        "sweep_points": int(cluster_counts[-1] + unit_counts[-1]),
        "flat_sweep_points": int(tnum + alloc.n),
        "coarsen_points": int(tnum),
        "partition_backend": pipe.partition_backend,
        "timings": timings,
        "trace_id": root.trace_id,
    }
    stats.update(rstats)
    if fused_refined:
        stats["fused_refine"] = True
        stats["fused_score_backend"] = \
            coarse_best.stats.get("fused_score_backend")
    return MappingResult(t2p, rotation=coarse_best.rotation,
                         score=float(rstats["refine_final"]), stats=stats)
