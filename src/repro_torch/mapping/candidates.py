"""Candidate generation + the batched candidate-search engine.

A *candidate* is one configuration of the rotation / coordinate-scaling
search of paper §4.3: a (task_perm, proc_perm) dimension rotation,
optionally a per-axis task-coordinate scaling (the traffic-weighted
variant used by the TPU mesh constructor), or the identity assignment
(task i -> processor i, the "default order" baseline every search must
never lose to).

:class:`CandidateSearch` scores a whole list of candidate
``task_to_proc`` arrays in vectorised passes — one
``pairwise_hops`` evaluation over the stacked coordinate tensor and,
for latency objectives, one batched dimension-ordered routing pass
(:func:`repro_torch.core.metrics.evaluate_candidates`) — instead of the
per-candidate Python loops that ``core/mapping.py`` and
``meshmap/device_mesh.py`` used to duplicate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.metrics import get_evaluator
from repro_torch.core.transforms import permutations


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the candidate search space.

    task_perm / proc_perm : dimension rotations (None = identity).
    task_scale            : per-axis divisor of the task coordinates
                            (None = raw coordinates).
    identity              : bypass the geometric mapper entirely and use
                            task i -> proc (i mod pnum).
    label                 : free-form tag for reports.
    """

    task_perm: tuple | None = None
    proc_perm: tuple | None = None
    task_scale: tuple | None = None
    identity: bool = False
    label: str = ""


def rotation_candidates(td: int, pd: int, rotations: int) -> list[Candidate]:
    """The paper's td! x pd! rotation search, subsampled to ``rotations``
    entries (index 0 — the identity rotation — is always kept).
    ``rotations == 0`` means identity only.

    Subsampling uses a balanced factorial design: the smallest
    ``na x nb`` grid of evenly spaced task-side and proc-side
    permutations whose product covers the budget.  Compared to a flat
    ``linspace`` over the pair list this spreads the budget evenly over
    BOTH factors of the search space, and it minimises the number of
    UNIQUE per-side rotations — exactly the quantity the batched
    rotation sweep partitions (one engine segment per unique
    permutation), so a budget of B candidates costs ~``2*sqrt(B)``
    partition-equivalents instead of ~``2*B``.
    """
    if not rotations:
        return [Candidate()]
    ta, pa = permutations(td), permutations(pd)
    if len(ta) * len(pa) <= rotations:
        combos = [(a, b) for a in ta for b in pa]
    else:
        best = None
        for na in range(1, len(ta) + 1):
            nb = min(-(-rotations // na), len(pa))  # ceil division
            if na * nb < rotations:
                continue
            key = (na + nb, abs(na - nb))  # smallest grid, then balanced
            if best is None or key < best[0]:
                best = (key, na, nb)
        _, na, nb = best
        sa = [ta[i] for i in np.linspace(0, len(ta) - 1, na).astype(int)]
        sb = [pa[i] for i in np.linspace(0, len(pa) - 1, nb).astype(int)]
        combos = [(a, b) for a in sa for b in sb][:rotations]
    return [Candidate(task_perm=a, proc_perm=b, label=f"rot{i}")
            for i, (a, b) in enumerate(combos)]


class CandidateSearch:
    """Batched scorer: rank candidate mappings by a metric objective.

    objective : metric key or tuple of keys compared lexicographically
        (e.g. ``"weighted_hops"`` for the paper's rotation search,
        ``("latency_max", "weighted_hops")`` for the TPU mesh constructor).
        Ties keep the EARLIER candidate, so listing the identity /
        default mapping first guarantees never-worse-than-default.
    backend : scoring engine — ``"hopper"`` (default, the CUDA kernel of
        :mod:`repro_torch.kernels.mapscore`), ``"torch"`` (plain tensor
        operations) or ``"numpy"`` (bit-exact host reference).
    device : where ``"hopper"``/``"torch"`` score.  The evaluator is
        resolved at construction (:func:`get_evaluator`): a name or
        device that cannot run raises there, nothing falls back.
    """

    def __init__(self, objective="weighted_hops", backend="hopper",
                 device="cuda"):
        self.objective = (objective,) if isinstance(objective, str) \
            else tuple(objective)
        self.backend, self._evaluate = get_evaluator(backend, device)
        self.device = torch.device(device)

    @property
    def needs_traffic(self) -> bool:
        return any(k in ("latency_max", "data_max") for k in self.objective)

    def score(self, graph, alloc, results) -> np.ndarray:
        """(len(results), len(objective)) score matrix, lower is better."""
        return self.score_assignments(
            graph, alloc, np.stack([r.task_to_proc for r in results]))

    def score_assignments(self, graph, alloc, t2p) -> np.ndarray:
        """The score matrix of the (ncand, tnum) assignments ``t2p``: a
        numpy array, or a tensor (gathered on the scorer's device, so a
        stack already there is not uploaded again).

        Scoring uses the allocation's RAW coordinates (transforms only
        steer the partitioner; the metrics model the physical network).
        """
        if self.backend == "numpy":
            if isinstance(t2p, torch.Tensor):
                t2p = t2p.cpu().numpy()
            coord_stack = alloc.coords[t2p]
        else:
            # gather on the device: ship the allocation's coordinate
            # table and the assignments, not the gathered stack
            coords = torch.as_tensor(np.ascontiguousarray(alloc.coords)).to(
                device=self.device, dtype=torch.int32)
            coord_stack = coords[torch.as_tensor(t2p).to(
                device=self.device, dtype=torch.int64)]
        ev = self._evaluate(
            alloc.machine, graph.edges, graph.weights, coord_stack,
            traffic=self.needs_traffic)
        return np.stack([ev[k] for k in self.objective], axis=1)

    def best_of(self, graph, alloc, t2p):
        """(winner_index, scores) of the assignments ``t2p``."""
        scores = self.score_assignments(graph, alloc, t2p)
        return first_best(scores), scores

    def best(self, graph, alloc, results):
        """(winner, winner_index, scores); first-of-ties wins."""
        best_i, scores = self.best_of(
            graph, alloc, np.stack([r.task_to_proc for r in results]))
        return results[best_i], best_i, scores


def first_best(scores: np.ndarray) -> int:
    """The row of the lexicographically least score (column 0 most
    significant); ties keep the FIRST row.

    One stable ``np.lexsort`` over the objective columns (last key is
    most significant, so the columns go in reversed) — stability keeps
    the FIRST index among equal scores, preserving the
    never-worse-than-default guarantee.
    """
    keys = tuple(scores[:, j] for j in reversed(range(scores.shape[1])))
    return int(np.lexsort(keys)[0])
