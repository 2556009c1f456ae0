"""The plain reference of a node-hierarchy request (two levels: cores
grouped by router).

Coarsen the tasks into one cluster per allocated router (Multi-Jagged
labels, centroids and summed volumes), run the flat rotation sweep of
:mod:`pbench.ref.engine` on clusters and routers, refine the winner by
the bounded greedy swap pass, and deal each cluster's tasks onto its
router's cores in Hilbert order.  WeightedHops only: the pass below
scores sums of integer-valued volumes, which are exact.  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .engine import (OBJECTIVES, first_best, hops, rotation_candidates,
                     shift_torus, sweep_assignments)
from .orderings import hilbert_key, order_points

# the node level's refinement budget: rounds, hottest clusters, nearest
# routers tried for each
ROUNDS, TOP, DEGREE = 2, 64, 4


def router_view(alloc: np.ndarray, nd: int):
    """(distinct router coordinates, each core row's router id)."""
    rows = np.asarray(alloc[:, :nd], dtype=np.int64)
    span = rows.max(axis=0) + 1
    keys = np.ravel_multi_index(tuple(rows.T), tuple(span))
    ukeys, core_router = np.unique(keys, return_inverse=True)
    return (np.stack(np.unravel_index(ukeys, tuple(span)), axis=1),
            core_router.reshape(-1))


def aggregate(tc, edges, w, nclusters: int, sfc: str):
    """Cluster labels, centroids, cluster weights and the contracted
    inter-cluster edges with their summed volumes."""
    n, d = tc.shape
    labels = order_points(tc, nclusters, sfc, longest_dim=True)
    cw = np.bincount(labels, minlength=nclusters).astype(np.float64)
    denom = np.where(cw > 0, cw, 1.0)
    cents = np.stack([np.bincount(labels, weights=tc[:, j],
                                  minlength=nclusters) / denom
                      for j in range(d)], axis=1)
    ce = labels[edges]
    inter = ce[:, 0] != ce[:, 1]
    key = ce[inter, 0] * nclusters + ce[inter, 1]
    uniq, inv = np.unique(key, return_inverse=True)
    vol = np.bincount(inv, weights=w[inter], minlength=len(uniq))
    cedges = np.stack([uniq // nclusters, uniq % nclusters], axis=1)
    return labels, cents, cw, cedges, vol


def wh_stack(machine, edges, w, stack) -> np.ndarray:
    """WeightedHops of each row of a (B, clusters, nd) coordinate stack."""
    h = hops(machine, stack[:, edges[:, 0]], stack[:, edges[:, 1]])
    return (h * w).sum(axis=-1)


def _lex_less(a: float, b: float, tol: float = 1e-12) -> bool:
    return a < b - tol


def refine_swaps(machine, edges, w, units, c2r, *, rounds=ROUNDS, top=TOP,
                 degree=DEGREE):
    """Greedy swap refinement of a bijective cluster -> unit map: each
    round ranks clusters by their weighted hops, offers the ``top``
    hottest a swap (or a move) with each of their ``degree`` nearest
    units (ties by unit id), accepts the best disjoint improving
    proposals, and keeps only the best one if together they do not
    improve.  Returns the refined map and the final score."""
    c2r = np.asarray(c2r, dtype=np.int64).copy()
    n, nu = len(c2r), len(units)
    r2c = np.full(nu, -1, dtype=np.int64)
    r2c[c2r] = np.arange(n)
    base = float(wh_stack(machine, edges, w, units[c2r][None])[0])
    for _ in range(rounds):
        cc = units[c2r]
        h = hops(machine, cc[edges[:, 0]], cc[edges[:, 1]]) * w
        contrib = (np.bincount(edges[:, 0], weights=h, minlength=n)
                   + np.bincount(edges[:, 1], weights=h, minlength=n))
        hot = np.argsort(-contrib, kind="stable")[:top]
        hot = hot[contrib[hot] > 0]
        k = min(degree, nu - 1)
        if len(hot) == 0 or k <= 0:
            break
        shape = (len(hot), nu, cc.shape[1])
        d = hops(machine, np.broadcast_to(cc[hot][:, None, :], shape),
                 np.broadcast_to(units[None, :, :], shape)).astype(float)
        d[np.arange(len(hot)), c2r[hot]] = np.inf
        near = np.argsort(d, axis=1, kind="stable")[:, :k]
        seen, props = set(), []
        for i, a in enumerate(hot):
            ra = int(c2r[a])
            for rb in near[i]:
                rb = int(rb)
                key = (min(ra, rb), max(ra, rb))
                if key not in seen:
                    seen.add(key)
                    props.append((int(a), ra, int(r2c[rb]), rb))
        # a proposal only moves two clusters: its score is the base less
        # the touched edges' old weighted hops plus their new ones
        touched = np.zeros(n, dtype=bool)
        for a, _, b, _ in props:
            touched[a] = True
            if b >= 0:
                touched[b] = True
        em = touched[edges[:, 0]] | touched[edges[:, 1]]
        s_edges, s_w = edges[em], w[em]
        uc = np.unique(s_edges)
        remap = np.full(n, -1, dtype=np.int64)
        remap[uc] = np.arange(len(uc))
        s_edges = remap[s_edges]
        s_cc = cc[uc]
        offset = base - float(wh_stack(machine, s_edges, s_w,
                                       s_cc[None])[0])
        p = np.asarray(props, dtype=np.int64)
        stack = np.repeat(s_cc[None], len(p), axis=0)
        rows_a = remap[p[:, 0]]
        rows_b = np.where(p[:, 2] >= 0, remap[np.maximum(p[:, 2], 0)], -1)
        va = np.flatnonzero(rows_a >= 0)
        stack[va, rows_a[va]] = units[p[va, 3]]
        vb = np.flatnonzero(rows_b >= 0)
        stack[vb, rows_b[vb]] = units[p[vb, 1]]
        scores = offset + wh_stack(machine, s_edges, s_w, stack)
        order = np.lexsort((scores,))
        used, chosen = set(), []
        for i in order:
            if not _lex_less(scores[i], base):
                break
            _, ra, _, rb = props[i]
            if {ra, rb} & used:
                continue
            used |= {ra, rb}
            chosen.append(int(i))
        if not chosen:
            break

        def apply(sel):
            nc, nr = c2r.copy(), r2c.copy()
            for i in sel:
                a, ra, b, rb = props[i]
                nc[a], nr[rb], nr[ra] = rb, a, b
                if b >= 0:
                    nc[b] = ra
            return nc, nr

        new_c2r, new_r2c = apply(chosen)
        combined = float(wh_stack(machine, edges, w,
                                  units[new_c2r][None])[0])
        if len(chosen) > 1 and not _lex_less(combined, base):
            chosen = [int(order[0])]
            new_c2r, new_r2c = apply(chosen)
            combined = float(scores[chosen[0]])
        if not _lex_less(combined, base):
            break
        c2r, r2c, base = new_c2r, new_r2c, combined
    return c2r, base


def assign_cores(labels, c2r, core_router, tc, nrouters):
    """Tasks of each cluster, in Hilbert order, dealt onto their router's
    cores in allocation order (one task a core here)."""
    n, ncores = len(labels), len(core_router)
    r_task = np.asarray(c2r)[labels]
    order = np.lexsort((hilbert_key(tc), labels, r_task))
    rsz_t = np.bincount(r_task, minlength=nrouters)
    r = r_task[order]
    rank = np.arange(n) - (np.cumsum(rsz_t) - rsz_t)[r]
    core_order = np.argsort(core_router, kind="stable").astype(np.int64)
    rsizes = np.bincount(core_router, minlength=nrouters)
    rstarts = np.cumsum(rsizes) - rsizes
    q = -(-n // ncores)
    if (rank >= rsizes[r] * q).any():
        raise ValueError("a router received more tasks than its cores")
    t2p = np.empty(n, dtype=np.int64)
    t2p[order] = core_order[rstarts[r] + rank % rsizes[r]]
    return t2p


def map_node(job, *, sfc="FZ", shift=True, rotations=8,
             objective="wh") -> dict:
    """The answer of a node-hierarchy request (see the module's doc)."""
    if OBJECTIVES[objective] != ("weighted_hops",):
        raise ValueError("the node reference scores WeightedHops only")
    m = job.machine
    tc = np.asarray(job.task_coords, dtype=np.float64)
    if len(tc) != len(job.alloc):
        raise ValueError("the node reference maps one task a core: "
                         f"{len(tc)} tasks, {len(job.alloc)} cores")
    units, core_router = router_view(job.alloc, m.nd)
    nrouters = len(units)
    arity = -(-len(job.alloc) // nrouters)
    ncl = min(nrouters, max(1, -(-len(tc) // arity)))
    labels, cents, cw, cedges, vol = aggregate(
        tc, job.edges, job.weights, ncl, sfc)
    pc = units.astype(np.float64)
    if shift:
        pc = shift_torus(pc, m)
    cands = rotation_candidates(cents.shape[1], pc.shape[1], rotations)
    t2p = sweep_assignments(cents, pc, cands, sfc=sfc, task_weights=cw)
    rows = [(float(wh_stack(m, cedges, vol, units[row][None])[0]),)
            for row in t2p]
    i = first_best(rows)
    c2r, final = refine_swaps(m, cedges, vol, units, t2p[i])
    return {"task_to_proc": assign_cores(labels, c2r, core_router, tc,
                                         nrouters),
            "rotation": cands[i], "score": final}
