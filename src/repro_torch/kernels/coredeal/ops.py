"""Public wrapper of the coredeal kernel.

:func:`coredeal` checks its arguments and, for CUDA tensors, runs the key
launch, the stable sorts and the deal launch — or raises; for CPU tensors
it runs the plain version (:mod:`.ref`).  One read back, the counts of
tasks beyond their router's budget and of ids out of range, precedes the
answer; the spill pass runs on the card only where the first is not 0.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.orderings import hilbert_bits

from . import kernel as _kernel
from . import ref as _ref
from .ref import coredeal_ref

# wrapper calls that launched the kernels (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("coredeal_hopper", lambda: {"launches": launch_count})


def _check(t, name: str, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def coredeal(labels: torch.Tensor, cluster_to_router: torch.Tensor,
             core_router: torch.Tensor, coords: torch.Tensor, *,
             nrouters: int) -> torch.Tensor:
    """Every task's core, tasks of a router in (cluster, Hilbert index)
    order dealt round robin onto the router's cores.

    labels            : (n,) int64 — the cluster of each task.
    cluster_to_router : (nclusters,) int64 — the router of each cluster,
                        each below ``nrouters``.
    core_router       : (ncores,) int64 — the router of each core row.
    coords            : (n, d) float64 — the tasks' coordinates, d in 1..62.

    Returns the (n,) int64 core row of every task, bit-equal to the
    plain version :func:`.ref.coredeal_ref`.  A cluster or router id out
    of range raises ``ValueError``.
    """
    global launch_count
    if not isinstance(coords, torch.Tensor) or coords.dim() != 2:
        raise ValueError("coords must be an (n, d) tensor")
    n, d = coords.shape
    dev = coords.device
    _check(coords, "coords", torch.float64, 2, dev)
    for name, t in (("labels", labels), ("cluster_to_router",
                                         cluster_to_router),
                    ("core_router", core_router)):
        _check(t, name, torch.int64, 1, dev)
    if labels.numel() != n:
        raise ValueError(f"labels has {labels.numel()} entries for {n} tasks")
    if not 1 <= d <= 62:
        raise ValueError(f"Hilbert keys take 1 to 62 dimensions, got {d}")
    if n and (core_router.numel() == 0 or cluster_to_router.numel() == 0):
        raise ValueError("tasks need at least one cluster and one core")
    if nrouters < 1:
        raise ValueError(f"nrouters must be at least 1, got {nrouters}")
    if dev.type != "cuda" or n == 0:
        return coredeal_ref(labels, cluster_to_router, core_router, coords,
                            nrouters=nrouters)
    lo, hi = torch.aminmax(coords, dim=0)
    h = torch.empty(n, dtype=torch.int64, device=dev)
    router = torch.empty(n, dtype=torch.int64, device=dev)
    # (tasks spilled, cluster ids out of range, router ids out of range)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    _kernel.keys_launch(coords, lo, hi, labels, cluster_to_router, h, router,
                        counts, bits=hilbert_bits(n, d), nrouters=nrouters)
    srouter, order = _ref.sort_three(h, labels, router)
    core_sorted, core_order = torch.sort(core_router, stable=True)
    q = -(-n // core_router.numel())
    t2p = torch.empty(n, dtype=torch.int64, device=dev)
    _kernel.deal_launch(srouter, order, core_sorted, core_order, t2p, counts,
                        q=q)
    launch_count += 1
    spilled, bad_clusters, bad_routers = counts.tolist()  # the one read back
    if bad_clusters:
        raise ValueError("a cluster id lies outside [0, nclusters)")
    if bad_routers:
        raise ValueError(f"a router id lies outside [0, {nrouters})")
    if spilled:
        t2p[order] = _ref.spill(t2p[order], core_order, q, spilled)
    return t2p
