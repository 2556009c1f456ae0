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

The contractions stay on the host, as ``np.bincount`` / ``np.unique``
segment sums: the weighted centroids are float64 sums that feed the top
sweep's partitioner, whose cuts move with their last bit, and a device
``index_add_`` adds in an order that changes from run to run.  Only the
cluster labels come from the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.orderings import order_points
from repro_torch.core.taskgraph import TaskGraph


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
    sums (``np.bincount``) keyed by the labels; parallel inter-cluster
    edges collapse to one edge with summed volume, intra-cluster edges
    are dropped from the coarse graph and accounted in ``intra_volume``.
    """
    tc = np.asarray(task_coords if task_coords is not None
                    else graph.coords, dtype=np.float64)
    n, d = tc.shape
    nclusters = int(nclusters)
    if not 1 <= nclusters <= n:
        raise ValueError(f"nclusters={nclusters} outside [1, {n}]")
    w = None if task_weights is None else \
        np.asarray(task_weights, dtype=np.float64)

    labels = order_points(tc, nclusters, sfc, weights=w,
                          longest_dim=longest_dim,
                          uneven_prime=uneven_prime, backend=backend,
                          device=device)

    sizes = np.bincount(labels, minlength=nclusters)
    wv = np.ones(n) if w is None else w
    cw = np.bincount(labels, weights=wv, minlength=nclusters)
    # weighted centroids: one segment sum per coordinate column
    denom = np.where(cw > 0, cw, 1.0)
    cents = np.stack([
        np.bincount(labels, weights=tc[:, j] * wv, minlength=nclusters)
        / denom for j in range(d)], axis=1)

    # contract the edge list: label endpoints, split intra/inter, then
    # sum parallel inter-cluster volumes with one flat bincount over the
    # pair key
    ce = labels[graph.edges]
    ew = np.asarray(graph.weights, dtype=np.float64)
    intra = ce[:, 0] == ce[:, 1]
    intra_volume = float(ew[intra].sum())
    inter = ce[~intra]
    if len(inter):
        key = inter[:, 0] * nclusters + inter[:, 1]
        uniq, inv = np.unique(key, return_inverse=True)
        vol = np.bincount(inv, weights=ew[~intra], minlength=len(uniq))
        coarse_edges = np.stack([uniq // nclusters, uniq % nclusters],
                                axis=1)
    else:
        coarse_edges = np.zeros((0, 2), dtype=np.int64)
        vol = np.zeros(0)

    coarse = TaskGraph(cents, coarse_edges, vol,
                       meta={"kind": "aggregated",
                             "fine_n": n,
                             "fine_edges": len(graph.edges),
                             "intra_volume": intra_volume,
                             "parent_meta": dict(graph.meta)})
    return Aggregation(coarse, labels, sizes, cw, intra_volume)
