"""One-program rotation sweep: partition -> match -> score -> select on
the device.

When the pipeline resolves ``partition_backend="torch"`` with the
``"torch"`` or ``"hopper"`` score backend and the batched vectorized
sweep, :class:`FusedSweep` runs the whole rotation sweep of
:meth:`MappingPipeline.map` on the pipeline's device: both sides'
level-synchronous partitions (:mod:`repro_torch.core.partition_torch`),
the part -> processor matching gathers (the staged path's own
:meth:`MappingPipeline.sweep_plan` and ``assign_parts``), the
per-candidate coordinate stack, and the metric evaluation (the mapscore
kernel, one launch for the whole stack, or the plain torch scorer).  Every input is uploaded
before the first kernel is enqueued; between the upload and the result
the host reads two things: the score matrix with the kernel's status
word and the "every part has a processor" flag, then the winner's row.
The winner is picked on the host from the copied matrix by
``candidates.first_best``, as :meth:`CandidateSearch.best` picks it.

Results are bit-identical to the staged path by construction: the
partitioner is the bit-identity-tested device engine, the rotation plan
and the gathers are the staged path's own, and the score columns are
the float64 values the staged :class:`CandidateSearch` lexsorts.

With a ``refine`` spec (the hierarchy's ``swap`` top level), the
bounded greedy swap refinement of
:func:`repro_torch.hier.refine.refine_swaps` runs after the winner is
picked, on the device, starting from the winner's row where the sweep
left it (:class:`_Refinement`): hot clusters by contribution, their
network-nearest routers, proposals deduplicated by unordered router
pair, scores of every proposal's edited stack (``base + sum w * dhops``
in float64 for sum-separable objectives, as the reference's fused pass;
the pipeline's scorer otherwise), then the greedy disjoint accept.
That accept is a sequential walk over the sorted proposals: each round
copies its sorted proposal table to the host once, runs the host pass's
own accept there, and uploads the chosen swaps; the monotone apply, the
full rescoring and the single-best fallback stay on the device.  One
more copy brings back the refined assignment and its history.  The
trajectory equals the host pass's decision for decision (for
integer-valued volumes; tests/test_torch_hier.py).

Unlike the reference there is no size bound (the kernel gathers its own
endpoints, so no src/dst arrays are built) and no quiet switch of
scorer: the score backend the pipeline resolved is the one that runs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.core.mapping import MappingResult
from repro_torch.core.metrics import STACK_BYTE_BUDGET, lex_less
from repro_torch.core.metrics_torch import message_inputs, score_stack
from repro_torch.core.partition_torch import run, upload
from repro_torch.kernels.mapscore import ops as _mapscore
from repro_torch.mapping.candidates import first_best
from repro_torch.mapping.pipeline import (assign_parts, missing_parts,
                                          rotation_of)

# metric keys the column builder understands (== the full
# evaluate_candidates contract; anything else takes the staged path)
_KNOWN_KEYS = frozenset(("weighted_hops", "total_hops", "average_hops",
                         "data_max", "latency_max"))

# the largest int64: a router's distance to itself, so that the stable
# sort of a hot row's distances puts it last (the host pass uses inf)
_FAR = torch.iinfo(torch.int64).max


def _columns(ev: dict, objective, ne: int) -> torch.Tensor:
    """The (nb, nobj) float64 objective matrix of a scorer's result
    (``average_hops`` from the integer sums, as the host evaluators)."""
    cols = []
    for key in objective:
        if key == "average_hops":
            cols.append(ev["total_hops"].to(torch.float64) / ne)
        else:
            cols.append(ev[key].to(torch.float64))
    return torch.stack(cols, dim=1)


def _lex_less_t(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Device mirror of :func:`repro_torch.core.metrics.lex_less` for two
    (nobj,) rows: a 0-dim bool, component 0 most significant."""
    res = torch.zeros((), dtype=torch.bool, device=s.device)
    for j in reversed(range(len(s))):
        res = torch.where(s[j] < t[j] - 1e-12, True,
                          torch.where(s[j] > t[j] + 1e-12, False, res))
    return res


class FusedSweep:
    """Runs a whole rotation sweep on the pipeline's device.

    Constructed by :class:`MappingPipeline` only when the partition
    backend is ``"torch"``, the score backend ``"torch"`` or
    ``"hopper"`` and the sweep the batched vectorized one.  :meth:`run`
    returns the winning :class:`MappingResult` (score and winner index
    filled in) or ``None`` when the stack is ineligible — the caller
    then takes the staged path.
    """

    def __init__(self, pipe, score_kind: str):
        self.pipe = pipe
        self.score_kind = score_kind

    def run(self, graph, alloc, task_coords, proc_coords, cands,
            task_weights=None, refine=None):
        """The sweep's winner as a :class:`MappingResult`, or ``None``
        when the stack is ineligible.

        ``refine`` (the hierarchy only): a ``{"rounds", "top",
        "degree"}`` dict folds the bounded swap refinement into the same
        device pass when the assignment is a bijection (as many tasks as
        processors: the hierarchy's top level always is).  The result
        then carries the REFINED cluster -> router assignment and the
        ``refine_*`` stats :func:`repro_torch.hier.refine.refine_swaps`
        would emit, with ``stats["fused_refine"]`` set; otherwise the
        caller's host pass refines.
        """
        faults.fire("fused")
        pipe = self.pipe
        cfg = pipe.config
        tc = np.asarray(task_coords, dtype=np.float64)
        pc = np.asarray(proc_coords, dtype=np.float64)
        if len(tc) < len(pc) or len(cands) < 2:
            return None
        objective = pipe.search.objective
        if not set(objective) <= _KNOWN_KEYS:
            return None
        ne = len(graph.edges)
        if ne == 0:
            return None
        machine = alloc.machine
        traffic = pipe.search.needs_traffic
        dev = pipe.search.device
        kind = self.score_kind
        ncand = len(cands)
        plan = pipe.sweep_plan(tc, pc, cands, task_weights)

        # --- upload everything before the first kernel is enqueued ------
        t_in = upload(**plan.task, device=dev)
        p_in = upload(**plan.proc, device=dev)
        t_sel = torch.from_numpy(plan.t_sel).to(dev)
        p_sel = torch.from_numpy(plan.p_sel).to(dev)
        acoords = torch.from_numpy(np.ascontiguousarray(
            alloc.coords, dtype=np.int32)).to(dev)
        edges, w, inv_bw = message_inputs(machine, graph.edges,
                                          graph.weights, traffic, dev)

        # --- partition both sides + GETMAPPINGARRAYS ---------------------
        t2p, ptp = assign_parts(run(t_in), run(p_in), t_sel, p_sel)

        # --- score the stack ---------------------------------------------
        stack = acoords[t2p]                     # (ncand, tnum, ndim) i32
        ev = self._score(machine, stack, edges, w, inv_bw, traffic)
        scores = _columns(ev, objective, ne)              # (ncand, nobj)

        # --- copy (i): scores + status + flag; select on the host -------
        host = torch.cat([scores.reshape(-1),
                          ev["status"].to(torch.float64).reshape(1),
                          (ptp.min() >= 0).to(torch.float64).reshape(1)]
                         ).cpu().numpy()
        if not host[-1]:
            raise missing_parts(ptp)
        _mapscore.raise_for_status(int(host[-2]), machine.dims)
        scores_h = host[:-2].reshape(ncand, len(objective))
        best_i = first_best(scores_h)

        obs.annotate(score_backend=kind, candidates=ncand)
        if refine is not None and len(tc) == len(pc):
            # --- the refinement, from the winner's row on the device ----
            ref = _Refinement(self, machine, acoords, edges, w, inv_bw,
                              graph, traffic, objective)
            row, rstats, reads = ref.run(t2p[best_i], **refine)
            best = MappingResult(row, score=rstats["refine_final"],
                                 rotation=rotation_of(cands[best_i]))
            best.stats.update(fused_refine=True, **rstats)
            obs.annotate(refine_rounds=rstats["refine_rounds_run"],
                         refine_accepted=rstats["refine_accepted"],
                         refine_host_reads=reads)
        else:
            # --- copy (ii): the winner's row -----------------------------
            row = t2p[best_i].to(torch.int32).cpu().numpy()
            best = MappingResult(row, score=float(scores_h[best_i][0]),
                                 rotation=rotation_of(cands[best_i]))
        best.stats.update(fused=True, fused_score_backend=kind,
                          winner_index=best_i)
        return best

    def _score(self, machine, stack, edges, w, inv_bw, traffic) -> dict:
        """The stack's metrics as device tensors, plus the 0-dim int64
        ``status`` (the kernel's; 0 for the plain scorer)."""
        if self.score_kind == "hopper":
            return _mapscore.mapscore(
                stack, edges, w, inv_bw, dims=machine.dims,
                wrap=machine.wrap, core_dims=machine.core_dims,
                traffic=traffic)
        ev = score_stack(machine, stack, edges, w, inv_bw, traffic=traffic)
        ev["status"] = torch.zeros((), dtype=torch.int64,
                                   device=stack.device)
        return ev


class _Refinement:
    """The bounded greedy swap refinement of one bijective assignment on
    the device: :func:`repro_torch.hier.refine.refine_swaps` decision for
    decision.

    Built by :meth:`FusedSweep.run` from the tensors the sweep uploaded
    (the allocation's coordinates, the messages) and the pipeline's
    scorer.  Every sort that decides the trajectory is a stable
    ``torch.sort`` (a multi-key order is successive stable sorts, least
    significant key first) on float keys canonicalised with ``+ 0.0``:
    the card's radix sort orders ``-0.0`` before ``0.0``, and a cluster
    of zero contribution negates to ``-0.0``.
    """

    def __init__(self, sweep: FusedSweep, machine, acoords, edges, w,
                 inv_bw, graph, traffic: bool, objective: tuple):
        self.sweep = sweep
        self.machine = machine
        self.dims = tuple(int(d) for d in machine.dims)
        self.wrap = tuple(bool(x) for x in machine.wrap)
        self.nd = machine.ndim - machine.core_dims
        self.acoords = acoords                    # (n, ndim) int32
        self.rc = acoords.to(torch.int64)
        self.edges, self.w, self.inv_bw = edges, w, inv_bw
        self.e0, self.e1 = edges[:, 0], edges[:, 1]
        self.ew64 = w.to(torch.float64) if graph.weights is None else \
            torch.as_tensor(np.asarray(graph.weights, dtype=np.float64)
                            ).to(edges.device)
        self.traffic = traffic
        self.objective = tuple(objective)
        self.separable = all(k in ("weighted_hops", "total_hops")
                             for k in objective)
        self.n = len(acoords)
        self.ne = len(graph.edges)
        self.dev = acoords.device
        self.status = torch.zeros((), dtype=torch.int64, device=self.dev)

    # -- metrics -----------------------------------------------------------

    def _hops(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """int64 network hop distance of coordinate rows (the first
        ``nd`` columns; wrapped dims take the shorter way round), as
        :func:`repro_torch.core.metrics.pairwise_hops`."""
        tot = torch.zeros(torch.broadcast_shapes(x.shape[:-1],
                                                 y.shape[:-1]),
                          dtype=torch.int64, device=self.dev)
        for k in range(self.nd):
            d = (x[..., k] - y[..., k]).abs()
            if self.wrap[k]:
                d = torch.minimum(d, self.dims[k] - d)
            tot = tot + d
        return tot

    def _stack_cols(self, stack: torch.Tensor) -> torch.Tensor:
        """(nb, nobj) objective matrix of an int32 coordinate stack
        through the pipeline's scorer (its status word folded in)."""
        ev = self.sweep._score(self.machine, stack, self.edges, self.w,
                               self.inv_bw, self.traffic)
        self.status = self.status | ev["status"]
        return _columns(ev, self.objective, self.ne)

    def full_cols(self, c2r: torch.Tensor) -> torch.Tensor:
        """(nobj,) objective of a whole assignment.  Separable keys sum
        in float64 (exact for integer-valued volumes, as the host's numpy
        evaluator); others score through the pipeline's scorer."""
        if not self.separable:
            return self._stack_cols(self.acoords[c2r][None])[0]
        st = self.rc[c2r]
        h = self._hops(st[self.e0], st[self.e1])
        return torch.stack([(self.ew64 * h.to(torch.float64)).sum()
                            if key == "weighted_hops"
                            else h.sum().to(torch.float64)
                            for key in self.objective])

    def _edit(self, cur, a, b, ra, rb) -> torch.Tensor:
        """(p, n, ndim) int32 stacks: ``cur`` with each proposal's swap
        applied, b's row first, then a's: an empty target (b < 0)
        rewrites row 0 with its own value before a's row is written."""
        st = cur.expand(len(a), -1, -1).clone()
        rows = torch.arange(len(st), device=self.dev)
        bi = b.clamp(min=0)
        st[rows, bi] = torch.where((b >= 0)[:, None], self.acoords[ra],
                                   st[rows, bi])
        st[rows, a] = self.acoords[rb]
        return st

    def _scored(self, c2r, ho, a, b, ra, rb, base, k_s: int):
        """(P, nobj) full-graph scores of every proposal's edited stack,
        in chunks of whole hot rows within ``STACK_BYTE_BUDGET`` of device
        memory.  Separable keys are ``base + sum w * (h_new - h_old)`` in
        float64, the reference's fused sum (exact for integer-valued
        volumes); others score through the pipeline's scorer."""
        cur = self.acoords[c2r]                         # (n, ndim) i32
        per_prop = cur.numel() * 4
        if self.separable:   # the endpoint gathers, hops and products
            per_prop += self.ne * (2 * cur.shape[1] * 4 + 3 * 8)
        per = k_s * max(1, STACK_BYTE_BUDGET // (k_s * per_prop))
        out = []
        for p0 in range(0, len(a), per):
            sl = slice(p0, p0 + per)
            st = self._edit(cur, a[sl], b[sl], ra[sl], rb[sl])
            if not self.separable:
                out.append(self._stack_cols(st))
                continue
            dh = (self._hops(st[:, self.e0], st[:, self.e1]) - ho
                  ).to(torch.float64)
            out.append(torch.stack(
                [base[j] + ((self.ew64 * dh).sum(dim=1)
                            if key == "weighted_hops" else dh.sum(dim=1))
                 for j, key in enumerate(self.objective)], dim=1))
        return torch.cat(out)

    # -- one round's proposals ----------------------------------------------

    def proposal_pairs(self, c2r, r2c, top_s: int, k_s: int):
        """The round's P = top_s * k_s proposals in the host's generation
        order: ``(a, ra, b, rb, valid, ho)`` (move cluster ``a`` from
        router ``ra`` to ``rb``, exchanging with its occupant ``b``, -1
        when empty; ``valid`` false for padding hot rows and duplicate
        router pairs; ``ho`` the current hops of every message)."""
        n = self.n
        cc = self.rc[c2r]
        ho = self._hops(cc[self.e0], cc[self.e1])
        h_e = ho.to(torch.float64) * self.ew64
        zero = torch.zeros(n, dtype=torch.float64, device=self.dev)
        contrib = (zero.index_add(0, self.e0, h_e)
                   + zero.index_add(0, self.e1, h_e))
        hot = torch.sort(-contrib + 0.0, stable=True).indices[:top_s]
        hot_valid = contrib[hot] > 0

        # network-nearest routers: distance, then router id
        dm = self._hops(cc[hot][:, None, :], self.rc[None, :, :])
        dm[torch.arange(top_s, device=self.dev), c2r[hot]] = _FAR
        near = torch.sort(dm, dim=1, stable=True).indices[:, :k_s]

        # proposals in the host's generation order (hot-major), deduped by
        # unordered router pair, first occurrence wins: valid hot rows
        # precede invalid ones, so padding never takes a pair
        a = hot.repeat_interleave(k_s)
        ra = c2r[a]
        rb = near.reshape(-1)
        b = r2c[rb]
        key = torch.minimum(ra, rb) * n + torch.maximum(ra, rb)
        srt = torch.sort(key, stable=True)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = srt.values[1:] != srt.values[:-1]
        valid = hot_valid.repeat_interleave(k_s) & torch.zeros_like(
            first).index_put((srt.indices,), first)
        return a, ra, b, rb, valid, ho

    def _proposals(self, c2r, r2c, base, top_s: int, k_s: int):
        """The round's sorted proposal table on the device:
        ``(scores (P, nobj), a, ra, b, rb, n_valid)``, invalid rows
        scored ``inf``."""
        a, ra, b, rb, valid, ho = self.proposal_pairs(c2r, r2c, top_s, k_s)
        scores = self._scored(c2r, ho, a, b, ra, rb, base, k_s)
        scores = torch.where(valid[:, None], scores, torch.inf)
        # the host's np.lexsort: objective[0] most significant, then the
        # generation index (stable sorts, least significant key first)
        order = torch.arange(len(a), device=self.dev)
        for j in reversed(range(scores.shape[1])):
            order = order[torch.sort(scores[order, j] + 0.0,
                                     stable=True).indices]
        return (scores[order], a[order], ra[order], b[order], rb[order],
                valid.sum())

    # -- the rounds -----------------------------------------------------------

    def _apply(self, c2r, r2c, table, sel):
        """The assignment with the swaps ``sel`` (rows of the host copy of
        the sorted table) applied, as in the host pass's ``_apply``."""
        ci, cv, ri, rv = [], [], [], []
        for i in sel:
            a, ra, b, rb = (int(x) for x in table[i])
            ci.append(a)
            cv.append(rb)
            ri += [rb, ra]
            rv += [a, b]
            if b >= 0:
                ci.append(b)
                cv.append(ra)
        up = torch.tensor([ci + ri, cv + rv], dtype=torch.int64,
                          device=self.dev)
        nc, nr = c2r.clone(), r2c.clone()
        nc[up[0, :len(ci)]] = up[1, :len(ci)]
        nr[up[0, len(ci):]] = up[1, len(ci):]
        return nc, nr

    def run(self, c2r0: torch.Tensor, *, rounds: int, top: int,
            degree: int):
        """Refine the assignment ``c2r0`` (a device tensor, never copied
        to the host unrefined).  Returns ``(task_to_proc int32, stats,
        host reads)`` with the ``refine_*`` stats of
        :func:`repro_torch.hier.refine.refine_swaps`."""
        n, nobj = self.n, len(self.objective)
        top_s = min(int(top), n)
        k_s = min(int(degree), n - 1)
        rounds_eff = int(rounds) if (rounds > 0 and top_s > 0
                                     and k_s > 0) else 0
        c2r = c2r0.to(torch.int64)
        r2c = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        r2c[c2r] = torch.arange(n, device=self.dev)
        base = self.full_cols(c2r)
        hist = torch.zeros((rounds_eff + 1, nobj), dtype=torch.float64,
                           device=self.dev)
        hist[0] = base
        rows = torch.arange(rounds_eff + 1, device=self.dev)
        hist_len = torch.ones((), dtype=torch.int64, device=self.dev)
        accepted = torch.zeros((), dtype=torch.int64, device=self.dev)
        improved = torch.ones((), dtype=torch.bool, device=self.dev)
        evaluated = reads = 0
        for _ in range(rounds_eff):
            scores, a, ra, b, rb, n_valid = self._proposals(
                c2r, r2c, base, top_s, k_s)
            # --- the round's one copy: the sorted table --------------------
            host = torch.cat([
                torch.stack([improved.to(torch.float64),
                             self.status.to(torch.float64),
                             n_valid.to(torch.float64)]),
                base, scores.reshape(-1),
                torch.stack([a, ra, b, rb], dim=1).to(torch.float64
                                                      ).reshape(-1)
            ]).cpu().numpy()
            reads += 1
            _mapscore.raise_for_status(int(host[1]), self.machine.dims)
            if not host[0]:
                break                   # the previous round changed nothing
            evaluated += int(host[2])
            base_h = host[3:3 + nobj]
            s_h = host[3 + nobj:3 + nobj + len(a) * nobj].reshape(-1, nobj)
            table = host[3 + nobj + len(a) * nobj:].reshape(-1, 4)
            # greedy disjoint accept, best improvement first (the host
            # pass's loop, on the copied table)
            touched = set()
            chosen = []
            for i in range(len(s_h)):
                if not lex_less(s_h[i], base_h):
                    break
                ra_i, rb_i = int(table[i, 1]), int(table[i, 3])
                if ra_i in touched or rb_i in touched:
                    continue
                touched |= {ra_i, rb_i}
                chosen.append(i)
            if not chosen:
                break
            nc, nr = self._apply(c2r, r2c, table, chosen)
            combined = self.full_cols(nc)
            nchosen = torch.full((), len(chosen), dtype=torch.int64,
                                 device=self.dev)
            if len(chosen) > 1:
                # accepted swaps interacted badly: keep only the best one,
                # whose exact score is known to beat the base
                nc1, nr1 = self._apply(c2r, r2c, table, chosen[:1])
                single = ~_lex_less_t(combined, base)
                nc = torch.where(single, nc1, nc)
                nr = torch.where(single, nr1, nr)
                combined = torch.where(single, scores[0], combined)
                nchosen = torch.where(single, 1, nchosen)
            improved = _lex_less_t(combined, base)
            c2r = torch.where(improved, nc, c2r)
            r2c = torch.where(improved, nr, r2c)
            base = torch.where(improved, combined, base)
            at = (rows == hist_len) & improved
            hist = torch.where(at[:, None], combined[None, :], hist)
            hist_len = hist_len + improved.to(torch.int64)
            accepted = accepted + torch.where(improved, nchosen, 0)
        # --- the last copy: the refined assignment and its history -------
        host = torch.cat([
            torch.stack([hist_len.to(torch.float64),
                         accepted.to(torch.float64),
                         self.status.to(torch.float64)]),
            hist.reshape(-1), c2r.to(torch.float64)]).cpu().numpy()
        reads += 1
        _mapscore.raise_for_status(int(host[2]), self.machine.dims)
        hlen = int(host[0])
        history = [tuple(float(x) for x in row) for row in
                   host[3:3 + hist.numel()].reshape(-1, nobj)[:hlen]]
        stats = {
            "refine_rounds_run": hlen - 1,
            "refine_accepted": int(host[1]),
            "refine_evaluated": evaluated,
            "refine_history": history,
            "refine_initial": history[0][0],
            "refine_final": history[-1][0],
        }
        row = host[3 + hist.numel():].astype(np.int32)
        return row, stats, reads
