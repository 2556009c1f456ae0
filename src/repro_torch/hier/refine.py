"""Intra-node core assignment + inter-node swap refinement (stage 3).

After the coarse map places one task cluster per allocated node, two
things remain:

- :func:`assign_cores` expands the node-level assignment to core
  granularity: each cluster's tasks are laid onto its node's cores in
  intra-node SFC (Hilbert) order.  Cores of a node sit at hop distance
  zero, so this choice never changes a metric — it only keeps the
  within-node rank order deterministic and geometrically contiguous
  (neighbouring tasks get neighbouring ranks, which real applications
  exploit for shared-memory optimisations).

- :func:`refine_swaps` is a bounded greedy local search in the spirit of
  Schulz & Träff's process-mapping refinement: swap the clusters of two
  network-adjacent nodes when it lowers the objective.  Because every
  fine task carries its node's router coordinates, the coarse graph's
  volume-weighted metrics (``weighted_hops``, ``latency_max``,
  ``data_max``) are EXACTLY the fine mapping's — scoring swaps on the
  contracted graph loses nothing.  Candidate swaps of a round are scored
  in batched :func:`repro_torch.core.metrics.evaluate_candidates` passes (one
  coordinate stack per chunk), and a whole accepted set is re-verified
  against the base score so the pass is monotone by construction.

- :func:`refine_qap` is the sparse-QAP local search used by
  the N-level hierarchy's grouping levels (``Level.refine_mode="qap"``):
  per-cluster best-single-move (into empty units) AND pairwise-swap
  neighbourhoods drawn from the SPARSE inter-cluster edge set — the
  units of graph-adjacent clusters, heaviest communication first — in
  addition to the network-nearest units ``refine_swaps`` considers.
  Improving proposals are applied in gain-bucket order (quantized gain
  buckets, deterministic proposal-id tie-break), and the accepted set
  is re-verified on the full graph exactly like ``refine_swaps``, so
  the pass is monotone by the same construction.  Both passes share the
  batched proposal scorer (:func:`_proposal_scores`); a hierarchy level
  selects between them with its ``refine_mode``.

- :func:`polish_groups` repairs a GROUP expansion: when a
  depth >= 3 hierarchy expands a group-level assignment one level down,
  the members of every group were placed by intra-group geometry alone
  — blind to which neighbouring group their heavy edges point at — and
  the medoid abstraction hid ~1 hop on every inter-cluster edge.  The
  bounded ``refine_swaps``/``refine_qap`` passes cannot recover that
  (they touch ``top`` clusters a round; the damage is in EVERY group
  interior), so this pass runs a cheap exact local search restricted to
  same-group swaps: closed-form KL-style weighted-hops deltas (O(deg)
  per candidate, no proposal stacks), the best improving swap of every
  group applied Jacobi-style in one batch, the batch re-verified
  against the full objective exactly like the other passes (monotone),
  and later rounds narrowed to the groups a previous accept touched.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import (STACK_BYTE_BUDGET, get_evaluator,
                                      pairwise_hops)
from repro_torch.core.metrics import lex_less as _lex_less
from repro_torch.core.orderings import hilbert_key

# gain quantization of refine_qap's bucket-ordered accept: more buckets
# = closer to strict best-first, fewer = more id-deterministic batching
_QAP_BUCKETS = 32


def assign_cores(
    labels: np.ndarray,
    cluster_to_router: np.ndarray,
    core_router: np.ndarray,
    task_coords: np.ndarray,
    nrouters: int,
) -> np.ndarray:
    """Expand cluster -> node into task -> core (intra-node SFC order).

    labels            : (n,) cluster id per task.
    cluster_to_router : (nclusters,) router id per cluster.
    core_router       : (ncores,) router id of every allocation core row.
    task_coords       : (n, d) task coordinates (for the Hilbert order).
    nrouters          : number of distinct routers in the allocation.

    Returns ``task_to_proc``: (n,) index into the allocation's core rows.
    Tasks of a cluster are sorted by their Hilbert index and dealt onto
    the node's cores in allocation order.  No core ever receives more
    than ``ceil(n / ncores)`` tasks: a node holds at most that many
    tasks per core (round-robin, like the flat mapper's tnum > pnum
    case), and tasks beyond a node's capacity — possible when router
    core counts are uneven (a trimmed allocation) or task clusters are
    weight-balanced — spill onto the remaining free core slots in
    allocation (SFC) order.  In particular ``n == ncores`` is always a
    BIJECTION, matching the flat pipeline's tnum == pnum contract.
    """
    labels = np.asarray(labels)
    n = len(labels)
    ncores = len(core_router)
    # tasks grouped by ROUTER (then cluster, then Hilbert index): the
    # rank is taken within the router group, so even a non-injective
    # cluster -> router map (possible when skewed task weights starve a
    # coarse part) packs co-located clusters without collisions
    r_task = np.asarray(cluster_to_router)[labels]
    order = np.lexsort((hilbert_key(task_coords), labels, r_task))
    rsz_t = np.bincount(r_task, minlength=nrouters)  # tasks per router
    rstarts_t = np.cumsum(rsz_t) - rsz_t
    r = r_task[order]
    rank = np.arange(n) - rstarts_t[r]

    # allocation core rows grouped by router (allocation order within)
    core_order = np.argsort(core_router, kind="stable").astype(np.int64)
    rsizes = np.bincount(core_router, minlength=nrouters)
    rstarts = np.cumsum(rsizes) - rsizes

    q = -(-n // ncores)  # global per-core task budget (>= 1)
    fits = rank < rsizes[r] * q
    t2p = np.empty(n, dtype=np.int64)
    t2p[order[fits]] = core_order[rstarts[r[fits]]
                                  + rank[fits] % rsizes[r[fits]]]
    if not fits.all():
        # spill: fill the remaining per-core budget in allocation order
        counts = np.bincount(t2p[order[fits]], minlength=ncores)
        free = np.repeat(core_order, q - counts[core_order])
        t2p[order[~fits]] = free[: int((~fits).sum())]
    return t2p


def _pad_stack(stack: np.ndarray, ndim: int) -> np.ndarray:
    """Zero-pad network-dim coordinate stacks to the machine's full ndim
    (the batched router indexes every machine dimension)."""
    pad = ndim - stack.shape[-1]
    if pad <= 0:
        return stack
    z = np.zeros(stack.shape[:-1] + (pad,), dtype=stack.dtype)
    return np.concatenate([stack, z], axis=-1)


def _evaluator(objective, score_backend: str, device):
    """``(separable, evaluator)`` of one refinement run, resolved once.

    Sum-separable objectives (``weighted_hops``, ``total_hops``) score
    with the numpy evaluator whatever ``score_backend`` says: hop sums
    of integer-valued volumes are EXACT in float64 whatever the
    summation order, so the numpy evaluator on the compacted union
    graphs is both the cheapest and the one the fused device refinement
    (:mod:`repro_torch.mapping.fused`) matches bit for bit.  Every other
    objective scores with ``score_backend`` on ``device``
    (:func:`repro_torch.core.metrics.get_evaluator`: no fallback).
    """
    if all(k in ("weighted_hops", "total_hops") for k in objective):
        return True, get_evaluator("numpy", "cpu")[1]
    return False, get_evaluator(score_backend, device)[1]


def _scores(machine, edges, weights, stack, objective, evaluator,
            chunk_elems: int = 1 << 24):
    """(B, len(objective)) score matrix for a coordinate stack.

    ``evaluator`` is a RESOLVED scoring callable (one
    :func:`repro_torch.core.metrics.get_evaluator` call per refinement
    run, hoisted out of the swap loop).  Hops-only objectives read just
    the network columns, so the stack is zero-padded to the machine's
    full ndim only when the batched router runs (traffic objectives
    index every machine dimension)."""
    traffic = any(k in ("latency_max", "data_max") for k in objective)
    if traffic:
        stack = _pad_stack(stack, machine.ndim)
    ev = evaluator(machine, edges, weights, stack, traffic=traffic,
                   chunk_elems=chunk_elems)
    return np.stack([np.asarray(ev[k], dtype=np.float64)
                     for k in objective], axis=1)


def _proposal_scores(machine, edges, w, router_coords, cc, proposals,
                     objective, evaluator, base, separable, chunk):
    """(nb, len(objective)) FULL-graph scores of move/swap proposals.

    ``proposals`` rows are ``(a, ra, b, rb)``: move cluster ``a`` from
    unit ``ra`` to unit ``rb``, exchanging with occupant ``b`` (``-1``
    when ``rb`` is empty).  Shared by :func:`refine_swaps` and
    :func:`refine_qap` — the operations are exactly the former's
    original inline block, so the greedy pass keeps its bit-identity
    with the fused device refinement.

    The edge set the scores run on: a proposal only moves two clusters,
    so for separable objectives the edges incident to a touched cluster
    carry ALL the score difference — ``score = base_full - base_union +
    union(proposal)``, exact.  Max-based objectives score full stacks.
    """
    nclusters = len(cc)
    if separable:
        touched_c = np.zeros(nclusters, dtype=bool)
        for a, ra, b, rb in proposals:
            touched_c[a] = True
            if b >= 0:
                touched_c[b] = True
        em = touched_c[edges[:, 0]] | touched_c[edges[:, 1]]
        s_edges, s_w = edges[em], w[em]
        # compact the stacks to the clusters the union edges touch:
        # an edited row outside the union cannot change the score
        uc = np.unique(s_edges)
        remap = np.full(nclusters, -1, dtype=np.int64)
        remap[uc] = np.arange(len(uc))
        s_edges = remap[s_edges]
        s_cc = cc[uc]
        base_union = _scores(machine, s_edges, s_w, s_cc[None],
                             objective, evaluator)[0]
        offset = base - base_union
    else:
        s_edges, s_w = edges, w
        remap = np.arange(nclusters)
        s_cc = cc
        offset = np.zeros_like(base)

    # score every proposal through ONE batched entry per (large)
    # slice: the edited stacks are built with two vectorised
    # scatters (a proposal only swaps two rows of the base stack)
    # and the evaluator chunks internally — no per-proposal Python
    # re-entry, so an accelerator backend sees a whole slice as one
    # launch.  Slices exist only to bound HOST memory: at least
    # ``chunk`` proposals each, growing to whatever fits the stack
    # byte budget (one slice for every realistic round).
    nb = len(proposals)
    prop = np.asarray(proposals, dtype=np.int64)  # (nb, 4) columns
    a_c, ra_c, b_c, rb_c = prop.T
    rows_a = remap[a_c]
    rows_b = np.where(b_c >= 0, remap[np.maximum(b_c, 0)], -1)
    sc = max(max(chunk, 1), STACK_BYTE_BUDGET // max(s_cc.nbytes, 1))
    scores = np.empty((nb, len(base)))
    for c0 in range(0, nb, sc):
        sl = slice(c0, min(c0 + sc, nb))
        stack = np.repeat(s_cc[None], sl.stop - c0, axis=0)
        va = np.flatnonzero(rows_a[sl] >= 0)
        stack[va, rows_a[sl][va]] = router_coords[rb_c[sl][va]]
        vb = np.flatnonzero(rows_b[sl] >= 0)
        stack[vb, rows_b[sl][vb]] = router_coords[ra_c[sl][vb]]
        scores[sl] = offset + _scores(
            machine, s_edges, s_w, stack, objective, evaluator)
    return scores


def refine_swaps(
    machine,
    coarse,
    router_coords: np.ndarray,
    cluster_to_router: np.ndarray,
    *,
    objective: tuple = ("weighted_hops",),
    rounds: int = 2,
    top: int = 64,
    degree: int = 4,
    chunk: int = 64,
    score_backend: str = "hopper",
    device="cuda",
) -> tuple[np.ndarray, dict]:
    """Bounded greedy swap refinement of a cluster -> router assignment.

    Each round: rank clusters by their contribution to the weighted-hops
    objective, take the ``top`` hottest, and propose exchanging each with
    the occupants of its ``degree`` network-nearest allocated routers
    (a move when the target router is empty).  All proposals of a round
    are scored through batched ``evaluate_candidates`` entries: the
    edited proposal stacks are built with two vectorised scatters in
    slices of at least ``chunk`` proposals (one slice for every
    realistic round — slices exist only to bound host memory), and the
    evaluator bounds device memory internally, so a round no longer
    re-enters Python per proposal and an accelerator backend typically
    sees it as a single launch.  The backend named by
    ``score_backend`` ("numpy", "torch" or "hopper", the last two on
    ``device``; by default the mapscore kernel on the card) is
    resolved ONCE per call (:func:`_evaluator`) and reused for every
    round; a name or device that cannot run raises.
    For sum-separable objectives (``weighted_hops``, ``total_hops``)
    the pass scores with the numpy evaluator and restricts the edge
    list to edges incident to a touched cluster — a proposal only moves
    two clusters, so ``score = base_full - base_union +
    union(proposal)`` is EXACT (for integer-valued volumes) while
    costing |union edges| instead of |all edges| per proposal.
    Max-based objectives (``latency_max``/``data_max``) score full
    stacks.  A greedy disjoint set of strictly-improving proposals
    is applied, then the combined assignment is re-scored on the FULL
    graph — if the interactions between accepted swaps ever made it
    worse, the round falls back to the single best proposal, whose
    exact score is known to improve.  The returned assignment therefore
    NEVER scores worse than the input (monotone; asserted in
    tests/test_torch_hier.py).

    Returns ``(refined cluster_to_router, stats)`` where stats carries
    the per-round objective history and acceptance counts.
    """
    router_coords = np.asarray(router_coords, dtype=np.int64)
    c2r = np.asarray(cluster_to_router, dtype=np.int64).copy()
    nclusters = len(c2r)
    nrouters = len(router_coords)
    # occupant table (last writer wins if c2r is ever non-injective —
    # proposal bookkeeping only; scores always come from the true c2r)
    r2c = np.full(nrouters, -1, dtype=np.int64)
    r2c[c2r] = np.arange(nclusters)

    edges = coarse.edges
    w = np.asarray(coarse.weights, dtype=np.float64)
    separable, evaluator = _evaluator(objective, score_backend, device)

    base = _scores(machine, edges, w, router_coords[c2r][None],
                   objective, evaluator)[0]
    history = [base.copy()]
    accepted_total = 0
    evaluated_total = 0

    for _ in range(max(rounds, 0)):
        cc = router_coords[c2r]
        if len(edges) == 0:
            break
        # per-cluster objective contribution (weighted hops both ways)
        h = pairwise_hops(machine, cc[edges[:, 0]], cc[edges[:, 1]]) * w
        contrib = (np.bincount(edges[:, 0], weights=h, minlength=nclusters)
                   + np.bincount(edges[:, 1], weights=h,
                                 minlength=nclusters))
        hot = np.argsort(-contrib, kind="stable")[:top]
        hot = hot[contrib[hot] > 0]
        if len(hot) == 0:
            break

        # network-nearest allocated routers per hot cluster
        shape = (len(hot), nrouters, cc.shape[1])
        d = pairwise_hops(machine,
                          np.broadcast_to(cc[hot][:, None, :], shape),
                          np.broadcast_to(router_coords[None, :, :], shape)
                          ).astype(np.float64)
        d[np.arange(len(hot)), c2r[hot]] = np.inf  # not itself
        k = min(degree, nrouters - 1)
        if k <= 0:
            break
        # full stable argsort (NOT argpartition): integer hop distances
        # tie constantly, and the stable order — distance, then router
        # id — is the one the fused device refinement reproduces bit
        # for bit (argpartition picks tie-holders arbitrarily)
        near = np.argsort(d, axis=1, kind="stable")[:, :k]

        # dedup unordered proposals: (cluster a, target router rb)
        seen = set()
        proposals = []  # (a, ra, b_or_minus1, rb)
        for i, a in enumerate(hot):
            ra = int(c2r[a])
            for rb in near[i]:
                rb = int(rb)
                b = int(r2c[rb])
                key = (min(ra, rb), max(ra, rb))
                if key in seen:
                    continue
                seen.add(key)
                proposals.append((int(a), ra, b, rb))
        if not proposals:
            break
        evaluated_total += len(proposals)
        scores = _proposal_scores(machine, edges, w, router_coords, cc,
                                  proposals, objective, evaluator, base,
                                  separable, chunk)

        # greedy disjoint accept, best improvement first
        order = np.lexsort(tuple(scores[:, j]
                                 for j in reversed(range(scores.shape[1]))))
        touched = set()
        chosen = []
        for i in order:
            if not _lex_less(scores[i], base):
                break  # sorted: nothing further improves
            a, ra, b, rb = proposals[i]
            if {ra, rb} & touched:
                continue
            touched |= {ra, rb}
            chosen.append(i)
        if not chosen:
            break

        def _apply(sel, c2r=c2r, r2c=r2c):
            nc, nr = c2r.copy(), r2c.copy()
            for i in sel:
                a, ra, b, rb = proposals[i]
                nc[a] = rb
                nr[rb] = a
                nr[ra] = b
                if b >= 0:
                    nc[b] = ra
            return nc, nr

        new_c2r, new_r2c = _apply(chosen)
        combined = _scores(machine, edges, w, router_coords[new_c2r][None],
                           objective, evaluator)[0]
        if len(chosen) > 1 and not _lex_less(combined, base):
            # accepted swaps interacted badly: keep only the best one,
            # whose exact score is already known to beat the base
            chosen = [int(order[0])]
            new_c2r, new_r2c = _apply(chosen)
            combined = scores[chosen[0]]
        if not _lex_less(combined, base):
            break  # cannot happen for a single exact swap; safety net
        c2r, r2c = new_c2r, new_r2c
        base = np.asarray(combined, dtype=np.float64)
        history.append(base.copy())
        accepted_total += len(chosen)

    stats = {
        "refine_rounds_run": len(history) - 1,
        "refine_accepted": accepted_total,
        "refine_evaluated": evaluated_total,
        "refine_history": [tuple(float(x) for x in h) for h in history],
        "refine_initial": float(history[0][0]),
        "refine_final": float(history[-1][0]),
    }
    return c2r, stats

def refine_qap(
    machine,
    coarse,
    router_coords: np.ndarray,
    cluster_to_router: np.ndarray,
    *,
    objective: tuple = ("weighted_hops",),
    rounds: int = 2,
    top: int = 64,
    degree: int = 4,
    chunk: int = 64,
    score_backend: str = "hopper",
    device="cuda",
) -> tuple[np.ndarray, dict]:
    """Sparse-QAP local search over a cluster -> unit assignment.

    The mapping problem at one hierarchy level IS a sparse quadratic
    assignment problem: flow matrix = the coarse graph's inter-cluster
    volumes (sparse), distance matrix = unit pairwise hops.  Following
    Schulz & Träff's local search, each round:

    1. ranks clusters by their weighted-hops contribution and takes the
       ``top`` hottest;
    2. builds each hot cluster's neighbourhood from the SPARSE edge
       set — the units of its ``degree`` heaviest-communication graph
       neighbours (pulling chatty clusters together regardless of
       current distance) — plus its ``degree`` network-nearest units
       (the ``refine_swaps`` neighbourhood, catching moves the graph
       cannot see).  A proposal is a best-single-MOVE when the target
       unit is empty, a pairwise SWAP with the occupant otherwise;
    3. scores all proposals in one batched pass
       (:func:`_proposal_scores`: exact separable deltas on the union
       edge set) and applies a disjoint improving subset in GAIN-BUCKET
       order — gains quantized into ``_QAP_BUCKETS`` buckets of the
       round's best gain, buckets visited best-first, proposal id
       breaking ties inside a bucket, so the accept order is
       deterministic and independent of float argsort jitter;
    4. re-scores the combined assignment on the FULL graph and falls
       back to the single best proposal if the accepted set interacted
       badly — the pass is monotone by the same construction as
       ``refine_swaps`` (asserted in tests/test_torch_hier.py).

    Same signature and stats contract as :func:`refine_swaps`; hierarchy
    levels select it with ``Level(refine_mode="qap")`` (the default for
    the grouping levels of ``HierarchySpec.with_depth``).
    """
    router_coords = np.asarray(router_coords, dtype=np.int64)
    c2r = np.asarray(cluster_to_router, dtype=np.int64).copy()
    nclusters = len(c2r)
    nrouters = len(router_coords)
    r2c = np.full(nrouters, -1, dtype=np.int64)
    r2c[c2r] = np.arange(nclusters)

    edges = coarse.edges
    w = np.asarray(coarse.weights, dtype=np.float64)
    separable, evaluator = _evaluator(objective, score_backend, device)

    # symmetric CSR adjacency, heaviest edge first per cluster (built
    # once: the flow matrix never changes, only the assignment does)
    if len(edges):
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        ew = np.concatenate([w, w])
        adj_order = np.lexsort((dst, -ew, src))
        adj_src = src[adj_order]
        adj_dst = dst[adj_order]
        adj_starts = np.searchsorted(adj_src, np.arange(nclusters + 1))
    else:
        adj_dst = np.empty(0, dtype=np.int64)
        adj_starts = np.zeros(nclusters + 1, dtype=np.int64)

    base = _scores(machine, edges, w, router_coords[c2r][None],
                   objective, evaluator)[0]
    history = [base.copy()]
    accepted_total = 0
    evaluated_total = 0

    for _ in range(max(rounds, 0)):
        cc = router_coords[c2r]
        if len(edges) == 0:
            break
        h = pairwise_hops(machine, cc[edges[:, 0]], cc[edges[:, 1]]) * w
        contrib = (np.bincount(edges[:, 0], weights=h, minlength=nclusters)
                   + np.bincount(edges[:, 1], weights=h,
                                 minlength=nclusters))
        hot = np.argsort(-contrib, kind="stable")[:top]
        hot = hot[contrib[hot] > 0]
        if len(hot) == 0:
            break

        # network-nearest allocated units (the refine_swaps
        # neighbourhood; stable distance-then-id order)
        shape = (len(hot), nrouters, cc.shape[1])
        d = pairwise_hops(machine,
                          np.broadcast_to(cc[hot][:, None, :], shape),
                          np.broadcast_to(router_coords[None, :, :], shape)
                          ).astype(np.float64)
        d[np.arange(len(hot)), c2r[hot]] = np.inf  # not itself
        k = min(degree, nrouters - 1)
        if k <= 0:
            break
        near = np.argsort(d, axis=1, kind="stable")[:, :k]

        seen = set()
        proposals = []  # (a, ra, b_or_minus1, rb)

        def _propose(a, rb, seen=seen, proposals=proposals):
            ra = int(c2r[a])
            rb = int(rb)
            if rb == ra:
                return
            key = (min(ra, rb), max(ra, rb))
            if key in seen:
                return
            seen.add(key)
            proposals.append((int(a), ra, int(r2c[rb]), rb))

        for i, a in enumerate(hot):
            # sparse-QAP neighbourhood: units of the ``degree``
            # heaviest graph neighbours — move next to who you talk to
            nbrs = adj_dst[adj_starts[a]:adj_starts[a + 1]][:degree]
            for b in nbrs:
                rb = int(c2r[b])
                _propose(a, rb)
                # best-single-move half of the neighbourhood: the empty
                # units network-nearest to the chatty neighbour's unit
                # (swap-free relocation when the machine has slack)
                for rn in near[i]:
                    if r2c[rn] < 0:
                        _propose(a, rn)
                        break
            for rb in near[i]:
                _propose(a, rb)
        if not proposals:
            break
        evaluated_total += len(proposals)
        scores = _proposal_scores(machine, edges, w, router_coords, cc,
                                  proposals, objective, evaluator, base,
                                  separable, chunk)

        # gain-bucket ordered disjoint accept: quantized primary-
        # objective gains, best bucket first, proposal id inside
        gain = base[0] - scores[:, 0]
        improving = np.flatnonzero(gain > 1e-12)
        if len(improving) == 0:
            break
        gmax = float(gain[improving].max())
        bucket = np.zeros(len(proposals), dtype=np.int64)
        bucket[improving] = 1 + np.minimum(
            (gain[improving] / gmax * (_QAP_BUCKETS - 1)).astype(np.int64),
            _QAP_BUCKETS - 1)
        order = np.lexsort((np.arange(len(proposals)), -bucket))
        touched = set()
        chosen = []
        for i in order:
            if bucket[i] == 0:
                break  # sorted: only non-improving proposals remain
            if not _lex_less(scores[i], base):
                continue  # primary gain but lex-worse on a tiebreaker
            a, ra, b, rb = proposals[i]
            if {ra, rb} & touched:
                continue
            touched |= {ra, rb}
            chosen.append(i)
        if not chosen:
            break

        def _apply(sel, c2r=c2r, r2c=r2c):
            nc, nr = c2r.copy(), r2c.copy()
            for i in sel:
                a, ra, b, rb = proposals[i]
                nc[a] = rb
                nr[rb] = a
                nr[ra] = b
                if b >= 0:
                    nc[b] = ra
            return nc, nr

        new_c2r, new_r2c = _apply(chosen)
        combined = _scores(machine, edges, w, router_coords[new_c2r][None],
                           objective, evaluator)[0]
        if len(chosen) > 1 and not _lex_less(combined, base):
            # accepted proposals interacted badly: keep only the single
            # truly best one (exact score known to beat the base)
            best = np.lexsort(tuple(scores[:, j] for j in
                                    reversed(range(scores.shape[1]))))[0]
            chosen = [int(best)]
            new_c2r, new_r2c = _apply(chosen)
            combined = scores[chosen[0]]
        if not _lex_less(combined, base):
            break  # cannot happen for a single exact proposal; safety
        c2r, r2c = new_c2r, new_r2c
        base = np.asarray(combined, dtype=np.float64)
        history.append(base.copy())
        accepted_total += len(chosen)

    stats = {
        "refine_rounds_run": len(history) - 1,
        "refine_accepted": accepted_total,
        "refine_evaluated": evaluated_total,
        "refine_history": [tuple(float(x) for x in h) for h in history],
        "refine_initial": float(history[0][0]),
        "refine_final": float(history[-1][0]),
    }
    return c2r, stats


def polish_groups(
    machine,
    coarse,
    unit_coords: np.ndarray,
    cluster_to_unit: np.ndarray,
    member: np.ndarray,
    *,
    objective: tuple = ("weighted_hops",),
    rounds: int = 4,
    chunk_elems: int = 1 << 24,
    score_backend: str = "hopper",
    device="cuda",
) -> tuple[np.ndarray, dict]:
    """Intra-group polish of an expanded cluster -> unit assignment.

    ``member[u]`` is the group (level above) that unit ``u`` belongs
    to.  The pass ONLY exchanges clusters within a group — group
    contents are exactly what the level above decided; this repairs the
    member ORDER inside each group, which the expansion chose from
    intra-group geometry alone.

    Per round:

    1. For every cluster ``a`` in an active group, the closed-form
       weighted-hops cost ``S[a, j]`` of parking ``a`` on each unit
       slot ``j`` of its group: one ``pairwise_hops`` + ``bincount``
       sweep over the edges incident to active clusters per slot —
       no per-proposal coordinate stacks, so ALL groups are searched
       at once for the cost ``refine_swaps`` pays on ``top`` clusters.
    2. The best improving same-group swap (or move to an empty member
       unit) of every group by exact KL delta
       ``S[a,k]-S[a,j] + S[b,j]-S[b,k] + 2*vol_ab*hops(ra,rb)``.
    3. All per-group winners applied in ONE Jacobi batch and re-scored
       against the FULL objective (cross-group edges couple the
       updates); a worse batch falls back to the single best group's
       swap, so the pass is monotone exactly like ``refine_swaps``.
    4. The active set shrinks to the groups holding or graph-adjacent
       to a swapped cluster — converged regions stop paying step 1.

    The deltas drive proposals from the weighted-hops objective; the
    accept decision uses the caller's full (possibly lexicographic)
    ``objective``, so a latency-first config stays monotone too (it
    just converges earlier when hop-driven swaps do not help it).

    Returns ``(polished cluster_to_unit, stats)`` with the same shape
    of stats contract as the refine passes (``polish_*`` keys).
    """
    unit_coords = np.asarray(unit_coords, dtype=np.int64)
    c2u = np.asarray(cluster_to_unit, dtype=np.int64).copy()
    member = np.asarray(member, dtype=np.int64)
    edges = coarse.edges
    w = np.asarray(coarse.weights, dtype=np.float64)
    nclusters = len(c2u)
    nunits = len(unit_coords)
    separable, evaluator = _evaluator(objective, score_backend, device)

    base = _scores(machine, edges, w, unit_coords[c2u][None],
                   objective, evaluator)[0]
    history = [base.copy()]
    stats = {
        "polish_rounds_run": 0,
        "polish_accepted": 0,
        "polish_evaluated": 0,
        "polish_initial": float(base[0]),
        "polish_final": float(base[0]),
        "polish_history": [tuple(float(x) for x in base)],
    }
    if rounds <= 0 or len(edges) == 0 or nclusters < 2:
        return c2u, stats

    # group slot tables: slot_unit[g, j] = j-th unit of group g (unit id
    # order; -1 pads ragged groups), unit_slot the inverse
    ngroups = int(member.max()) + 1
    order = np.argsort(member, kind="stable").astype(np.int64)
    gsz = np.bincount(member, minlength=ngroups)
    arity = int(gsz.max()) if len(gsz) else 0
    if arity < 2:
        return c2u, stats  # singleton groups: nothing to exchange
    gstart = np.cumsum(gsz) - gsz
    slot_unit = np.full((ngroups, arity), -1, dtype=np.int64)
    for j in range(arity):
        sel = gsz > j
        slot_unit[sel, j] = order[gstart[sel] + j]

    src, dst = edges[:, 0], edges[:, 1]
    tol = 1e-12
    active = np.ones(ngroups, dtype=bool)
    accepted_total = 0
    evaluated_total = 0

    for _ in range(max(rounds, 0)):
        pos = unit_coords[c2u]
        u2c = np.full(nunits, -1, dtype=np.int64)
        u2c[c2u] = np.arange(nclusters)
        ga = member[c2u]                      # group of each cluster
        act_c = active[ga]
        em = act_c[src] | act_c[dst]
        es, ed, ew = src[em], dst[em], w[em]
        # step 1: S[a, j] over active clusters (both edge directions)
        S = np.zeros((nclusters, arity))
        for j in range(arity):
            uj = slot_unit[ga, j]             # slot-j unit of a's group
            m1 = act_c[es] & (uj[es] >= 0)
            if m1.any():
                v = pairwise_hops(machine, unit_coords[uj[es[m1]]],
                                  pos[ed[m1]]).astype(np.float64) * ew[m1]
                S[:, j] += np.bincount(es[m1], weights=v,
                                       minlength=nclusters)
            m2 = act_c[ed] & (uj[ed] >= 0)
            if m2.any():
                v = pairwise_hops(machine, unit_coords[uj[ed[m2]]],
                                  pos[es[m2]]).astype(np.float64) * ew[m2]
                S[:, j] += np.bincount(ed[m2], weights=v,
                                       minlength=nclusters)

        # step 2: best improving same-group swap/move per active group
        bestd = np.full(ngroups, -tol)
        best_a = np.full(ngroups, -1, dtype=np.int64)
        best_b = np.full(ngroups, -1, dtype=np.int64)
        best_ua = np.full(ngroups, -1, dtype=np.int64)
        best_ub = np.full(ngroups, -1, dtype=np.int64)
        for j in range(arity):
            for k in range(j + 1, arity):
                ua, ub = slot_unit[:, j], slot_unit[:, k]
                gi = np.flatnonzero(active & (ua >= 0) & (ub >= 0))
                if len(gi) == 0:
                    continue
                a = u2c[ua[gi]]
                b = u2c[ub[gi]]
                occ = (a >= 0) & (b >= 0)
                # swap candidates (both slots occupied)
                gs, as_, bs = gi[occ], a[occ], b[occ]
                d = (S[as_, k] - S[as_, j]) + (S[bs, j] - S[bs, k])
                evaluated_total += len(gs)
                imp = d < bestd[gs]
                gs, as_, bs, d = gs[imp], as_[imp], bs[imp], d[imp]
                bestd[gs] = d
                best_a[gs], best_b[gs] = as_, bs
                best_ua[gs], best_ub[gs] = ua[gi][occ][imp], ub[gi][occ][imp]
                # move candidates (exactly one of the two slots occupied)
                for aa, jj, kk, uu in ((a, j, k, ub[gi]), (b, k, j, ua[gi])):
                    mv = (aa >= 0) & ((a < 0) | (b < 0))
                    gm, am = gi[mv], aa[mv]
                    if len(gm) == 0:
                        continue
                    dm = S[am, kk] - S[am, jj]
                    evaluated_total += len(gm)
                    imp = dm < bestd[gm]
                    gm, am, dm = gm[imp], am[imp], dm[imp]
                    bestd[gm] = dm
                    best_a[gm], best_b[gm] = am, -1
                    best_ua[gm] = c2u[am]
                    best_ub[gm] = uu[mv][imp]
        gsel = np.flatnonzero(best_a >= 0)
        if len(gsel):
            # exact-delta correction for swapped pairs that share edges:
            # the slot costs double-count the a-b rows, so add back
            # 2 * vol_ab * hops(ra, rb) before the improving filter
            aa, bb = best_a[gsel], best_b[gsel]
            sw = bb >= 0
            if sw.any():
                ie = (ga[src] == ga[dst]) & (src != dst)
                ia, ib, iw = src[ie], dst[ie], w[ie]
                key = (np.minimum(ia, ib).astype(np.int64) * nclusters
                       + np.maximum(ia, ib))
                ks = np.argsort(key, kind="stable")
                qa, qb = aa[sw], bb[sw]
                qk = (np.minimum(qa, qb).astype(np.int64) * nclusters
                      + np.maximum(qa, qb))
                lo = np.searchsorted(key[ks], qk, "left")
                hi = np.searchsorted(key[ks], qk, "right")
                vab = np.array([float(iw[ks[l:h]].sum())
                                for l, h in zip(lo, hi)])
                hab = pairwise_hops(machine, pos[qa],
                                    pos[qb]).astype(np.float64)
                fixed = bestd[gsel].copy()
                fixed[sw] = fixed[sw] + 2.0 * vab * hab
                keep = fixed < -tol
            else:
                keep = np.ones(len(gsel), dtype=bool)
            gsel = gsel[keep]
        if len(gsel) == 0:
            break

        # step 3: Jacobi batch apply + full-objective verify
        def _apply(gs):
            prop = c2u.copy()
            pa, pb = best_a[gs], best_b[gs]
            prop[pa] = best_ub[gs]
            swp = pb >= 0
            prop[pb[swp]] = best_ua[gs][swp]
            return prop

        prop = _apply(gsel)
        combined = _scores(machine, edges, w, unit_coords[prop][None],
                           objective, evaluator, chunk_elems)[0]
        if len(gsel) > 1 and not _lex_less(combined, base):
            gsel = gsel[np.argsort(bestd[gsel], kind="stable")[:1]]
            prop = _apply(gsel)
            combined = _scores(machine, edges, w,
                               unit_coords[prop][None],
                               objective, evaluator, chunk_elems)[0]
        if not _lex_less(combined, base):
            break  # hop-driven deltas do not improve this objective
        c2u = prop
        base = np.asarray(combined, dtype=np.float64)
        history.append(base.copy())
        accepted_total += len(gsel)

        # step 4: shrink to the neighbourhood the accepts disturbed
        moved = np.zeros(nclusters, dtype=bool)
        moved[best_a[gsel]] = True
        bsel = best_b[gsel]
        moved[bsel[bsel >= 0]] = True
        ga = member[c2u]
        active[:] = False
        active[ga[moved]] = True
        tm = moved[src] | moved[dst]
        active[ga[src[tm]]] = True
        active[ga[dst[tm]]] = True

    stats.update({
        "polish_rounds_run": len(history) - 1,
        "polish_accepted": accepted_total,
        "polish_evaluated": evaluated_total,
        "polish_final": float(base[0]),
        "polish_history": [tuple(float(x) for x in h) for h in history],
    })
    return c2u, stats
