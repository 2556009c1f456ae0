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

This is the sweep half of the reference's fused program; the swap
refinement it folds in for the hierarchy comes with the hierarchical
path.  Unlike the reference there is no size bound (the kernel gathers
its own endpoints, so no src/dst arrays are built) and no quiet switch
of scorer: the score backend the pipeline resolved is the one that runs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.core.mapping import MappingResult
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
            task_weights=None):
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
        cols = []
        for key in objective:
            if key == "average_hops":
                cols.append(ev["total_hops"].to(torch.float64) / ne)
            else:
                cols.append(ev[key].to(torch.float64))
        scores = torch.stack(cols, dim=1)                 # (ncand, nobj)

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

        # --- copy (ii): the winner's row ---------------------------------
        row = t2p[best_i].to(torch.int32).cpu().numpy()
        best = MappingResult(row, score=float(scores_h[best_i][0]),
                             rotation=rotation_of(cands[best_i]))
        best.stats.update(fused=True, fused_score_backend=kind,
                          winner_index=best_i)
        obs.annotate(score_backend=kind, candidates=ncand)
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
