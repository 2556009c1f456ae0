"""Public wrapper of the contract kernels.

:func:`contract` checks its arguments and, for CUDA tensors, runs the
cluster launch over the stable sort of the labels, then the key launch,
the stable sort of the keys, the head launch, an integer scan and the
segment launch — or raises; for CPU tensors it runs the plain version
(:mod:`.ref`).  One read back, of the pair and intra counts and of the
counts of ids out of range, precedes the answer.
"""

from __future__ import annotations

import torch

from repro_torch import obs

from . import kernel as _kernel
from .ref import Contraction, contract_ref

# wrapper calls that launched the kernels (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("contract_hopper", lambda: {"launches": launch_count})

_INT32_MAX = 2 ** 31 - 1


def _check(t, name: str, dtype, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != got
                                    for s, got in zip(shape, t.shape)):
        want = tuple("*" if s is None else s for s in shape)
        raise ValueError(f"{name} must have shape {want}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def contract(labels: torch.Tensor, edges: torch.Tensor,
             edge_weights: torch.Tensor, coords: torch.Tensor,
             task_weights: torch.Tensor | None = None, *,
             nclusters: int) -> Contraction:
    """The task graph contracted onto its clusters.

    labels       : (n,) int64 — the cluster of each task.
    edges        : (E, 2) int64 — directed task pairs.
    edge_weights : (E,) float64 — their volumes.
    coords       : (n, d) float64 — the tasks' coordinates, d >= 1.
    task_weights : (n,) float64, or None for unit weights.

    Returns a :class:`.ref.Contraction` on the inputs' device: each
    cluster's size, summed weight and weighted centroid, the
    inter-cluster pairs in ascending ``c0 * nclusters + c1`` order with
    their summed volumes, and the intra-cluster volumes in edge order,
    bit-equal to ``np.bincount`` / ``np.unique`` over the same arrays (and
    to the plain version).  An endpoint outside [0, n) or a label outside
    [0, nclusters) raises ``ValueError``.
    """
    global launch_count
    if not isinstance(coords, torch.Tensor) or coords.dim() != 2:
        raise ValueError("coords must be an (n, d) tensor")
    n, d = coords.shape
    dev = coords.device
    _check(coords, "coords", torch.float64, (n, d), dev)
    _check(labels, "labels", torch.int64, (n,), dev)
    _check(edges, "edges", torch.int64, (None, 2), dev)
    nedges = edges.shape[0]
    _check(edge_weights, "edge_weights", torch.float64, (nedges,), dev)
    if task_weights is not None:
        _check(task_weights, "task_weights", torch.float64, (n,), dev)
    if d < 1:
        raise ValueError("coords need at least one dimension")
    if not 1 <= nclusters <= _INT32_MAX:
        raise ValueError(f"nclusters must lie in [1, 2**31), got "
                         f"{nclusters}")
    if nedges > _INT32_MAX:
        raise ValueError(f"at most 2**31 - 1 edges, got {nedges}")
    if dev.type != "cuda":
        return contract_ref(labels, edges, edge_weights, coords,
                            task_weights, nclusters=nclusters)
    base = nclusters * (2 + d)
    out = torch.empty(base + 3 * nedges, dtype=torch.int64, device=dev)
    # (endpoints out of range, labels out of range, intra edges, pairs)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    sl, order = torch.sort(labels, stable=True)
    _kernel.clusters_launch(sl, order, coords, task_weights, counts, out,
                            nclusters=nclusters)
    if nedges:
        key = torch.empty(nedges, dtype=torch.int64, device=dev)
        _kernel.keys_launch(edges, labels, key, counts, n=n,
                            nclusters=nclusters)
        sk, si = torch.sort(key, stable=True)
        head = torch.empty(nedges, dtype=torch.int32, device=dev)
        _kernel.heads_launch(sk, head, nclusters=nclusters)
        scan = torch.cumsum(head, 0, dtype=torch.int32)
        _kernel.segments_launch(sk, si, edge_weights, scan, counts, out,
                                nclusters=nclusters, base=base)
    launch_count += 1
    bad_ends, bad_labels, nintra, npairs = counts.tolist()  # the one read
    if bad_ends:
        raise ValueError(f"an edge endpoint lies outside [0, {n})")
    if bad_labels:
        raise ValueError(f"a cluster label lies outside [0, {nclusters})")
    return Contraction(out[:base + 3 * npairs + nintra], nclusters, d,
                       npairs, nintra)
