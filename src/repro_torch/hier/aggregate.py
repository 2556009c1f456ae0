"""Geometric task-side coarsening (hierarchical mapping stage 1).

The paper treats intra-node communication as free (§2): a multicore
node's cores all carry the ROUTER's coordinates, so the mapping problem
is really a *node*-granularity problem.  This module contracts the task
graph the same way the machine side already is: tasks are clustered
geometrically into node-sized groups with the Multi-Jagged partitioner
(the SAME level-synchronous engine that cuts the fine problem — the
device partitioner of :mod:`repro_torch.core.partition_torch` by
default), and the communication structure is contracted onto the
clusters.

The contraction runs on the caller's device
(:mod:`repro_torch.kernels.contract`: hand-written kernels on a CUDA
device, their plain-torch version on the CPU) and keeps numpy's bits:
the weighted centroids are float64 sums that feed the top sweep's
partitioner, whose cuts move with their last bit.  So every sum adds in
the order ``np.bincount`` does — a cluster's tasks and a pair's edges in
index order, one thread a run after stable sorts, never by atomics,
whose order changes from run to run — and the intra volume is summed by
numpy itself over the intra edges' volumes in edge order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.orderings import order_points
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.contract import contract


@dataclasses.dataclass
class Aggregation:
    """A node-granularity contraction of a task graph.

    coarse      : TaskGraph of the clusters — weighted centroids as
                  coordinates, contracted inter-cluster edges carrying
                  the SUMMED message volumes of their fine edges.
    labels      : (n,) int64 cluster id per fine task, in SFC part-number
                  order (cluster ids are the partitioner's part numbers,
                  so consecutive ids are geometric neighbours).
    sizes       : (nclusters,) fine-task count per cluster.
    weights     : (nclusters,) summed fine-task weight per cluster (task
                  counts when the fine graph is unweighted).
    intra_volume: total message volume of edges internal to a cluster —
                  the traffic the two-level map renders free (both
                  endpoints land on one node).
    """

    coarse: TaskGraph
    labels: np.ndarray
    sizes: np.ndarray
    weights: np.ndarray
    intra_volume: float

    @property
    def nclusters(self) -> int:
        return len(self.sizes)


def aggregate_tasks(
    graph: TaskGraph,
    nclusters: int,
    *,
    task_coords: np.ndarray | None = None,
    task_weights: np.ndarray | None = None,
    sfc: str = "FZ",
    longest_dim: bool = True,
    uneven_prime: bool = False,
    backend: str = "torch",
    device="cuda",
) -> Aggregation:
    """Contract ``graph`` into ``nclusters`` geometric clusters.

    The cluster labels come from ONE ``order_points`` call over the fine
    task coordinates (``backend="torch"`` runs it on ``device``) — the
    identical Algorithm-2 machinery the flat pipeline uses, just stopped
    at ``nclusters`` parts instead of one part per core.  Unit-weight
    tasks therefore land in clusters of ``floor/ceil(n / nclusters)``
    members (the partitioner's balanced cuts), i.e. node-sized groups
    when ``nclusters = n / cores_per_node``.

    Centroids, cluster weights and the contracted edge list are segment
    sums keyed by the labels, as ``np.bincount`` / ``np.unique`` compute
    them, bit for bit: parallel inter-cluster edges collapse to one edge
    with summed volume, intra-cluster edges are dropped from the coarse
    graph and accounted in ``intra_volume``.  The labels, edges, volumes,
    coordinates and weights are uploaded to ``device`` and contracted
    there (:func:`repro_torch.kernels.contract.contract`: the kernels on a
    CUDA device, their plain version on ``"cpu"``), and the packed result
    copied back once, inside a ``hier.contract`` span whose ``path`` is
    the device's type.  Nothing is kept from one call to the next.
    """
    tc = np.asarray(task_coords if task_coords is not None
                    else graph.coords, dtype=np.float64)
    n = len(tc)
    nclusters = int(nclusters)
    if not 1 <= nclusters <= n:
        raise ValueError(f"nclusters={nclusters} outside [1, {n}]")
    w = None if task_weights is None else \
        np.asarray(task_weights, dtype=np.float64)
    dev = resolve_device(device)

    labels = order_points(tc, nclusters, sfc, weights=w,
                          longest_dim=longest_dim,
                          uneven_prime=uneven_prime, backend=backend,
                          device=device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    with obs.span("hier.contract", edges=len(graph.edges),
                  clusters=nclusters, path=dev.type):
        c = contract(up(labels, np.int64), up(graph.edges, np.int64),
                     up(graph.weights, np.float64), up(tc, np.float64),
                     None if w is None else up(w, np.float64),
                     nclusters=nclusters).cpu()
        # numpy's own pairwise sum over the intra volumes in edge order
        intra_volume = float(c.intra.numpy().sum())

    coarse = TaskGraph(c.centroids.numpy(), c.edges.numpy(),
                       c.volumes.numpy(),
                       meta={"kind": "aggregated",
                             "fine_n": n,
                             "fine_edges": len(graph.edges),
                             "intra_volume": intra_volume,
                             "parent_meta": dict(graph.meta)})
    return Aggregation(coarse, labels, c.sizes.numpy(), c.weights.numpy(),
                       intra_volume)
