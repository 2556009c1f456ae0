"""Plain-torch version of the coredeal kernel, and what both share: the
three stable sorts and the spill pass.

It repeats the kernel's arithmetic with whole-array torch operations on
the inputs' device: the quantisation and Skilling's transform of
:func:`repro_torch.core.orderings.hilbert_key` (the device partitioner's
Hilbert sweep's own functions), the same stable sorts, and the deal by
the same searches.  About 300 operations a call, so it is for the CPU and
for holding the kernel to.
"""

from __future__ import annotations

import torch

from repro_torch.core.orderings import hilbert_bits
from repro_torch.core.partition_torch import (hilbert_quantise,
                                              hilbert_transform)


def hilbert_keys(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """``hilbert_key(coords, bits)`` in torch: (n,) int64, by the device
    partitioner's own quantisation and transform."""
    return hilbert_transform(list(hilbert_quantise(coords.T, bits)), bits)


def sort_three(h, labels, r):
    """The tasks in ``np.lexsort((h, labels, r))`` order by three stable
    sorts, by Hilbert index, then cluster, then router: ``(srouter,
    order)``, the router at each sorted position and the task there."""
    order = torch.sort(h, stable=True).indices
    order = order[torch.sort(labels[order], stable=True).indices]
    srouter, idx = torch.sort(r[order], stable=True)
    return srouter, order[idx]


def deal(r, core_sorted, core_order, q: int) -> torch.Tensor:
    """(n,) core of each sorted position (``r``: its router, ascending):
    its rank within its router's tasks dealt round robin onto the router's
    cores (``core_sorted``, ``core_order``: the stable sort of the cores'
    router ids), -1 beyond ``q`` tasks a core."""
    rank = torch.arange(r.numel(), device=r.device) - torch.searchsorted(r, r)
    cs = torch.searchsorted(core_sorted, r)
    cores = torch.searchsorted(core_sorted, r, right=True) - cs
    fits = rank < cores * q
    slot = cs + torch.where(fits, rank % cores.clamp(min=1), 0)
    return torch.where(fits, core_order[slot.clamp(max=len(core_order) - 1)],
                       -1)


def spill(dealt: torch.Tensor, core_order: torch.Tensor, q: int,
          nspill: int) -> torch.Tensor:
    """``dealt`` with its ``nspill`` positions at -1 given the free core
    slots in allocation (SFC) order, position by position: each core takes
    ``q`` tasks in all, the free slots core by core in ``core_order``."""
    ncores = core_order.numel()
    fits = dealt >= 0
    counts = torch.zeros(ncores + 1, dtype=torch.int64, device=dealt.device)
    counts.index_add_(0, torch.where(fits, dealt, ncores),
                      torch.ones_like(dealt))
    nfree = q * ncores - (dealt.numel() - nspill)
    free = torch.repeat_interleave(core_order, q - counts[core_order],
                                   output_size=nfree)
    k = torch.cumsum(~fits, 0) - 1
    return torch.where(fits, dealt, free[k.clamp(min=0)])


def coredeal_ref(labels: torch.Tensor, c2r: torch.Tensor,
                 core_router: torch.Tensor, coords: torch.Tensor, *,
                 nrouters: int) -> torch.Tensor:
    """The (n,) int64 core of every task, as
    :func:`repro_torch.hier.refine.assign_cores` deals them (the arguments
    are :func:`.ops.coredeal`'s)."""
    n, d = coords.shape
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=coords.device)
    if bool((labels < 0).any()) or bool((labels >= c2r.numel()).any()):
        raise ValueError("a cluster id lies outside [0, nclusters)")
    if bool((c2r < 0).any()) or bool((c2r >= nrouters).any()):
        raise ValueError(f"a router id lies outside [0, {nrouters})")
    h = hilbert_keys(coords, hilbert_bits(n, d))
    srouter, order = sort_three(h, labels, c2r[labels])
    q = -(-n // core_router.numel())
    core_sorted, core_order = torch.sort(core_router, stable=True)
    dealt = deal(srouter, core_sorted, core_order, q)
    nspill = int((dealt < 0).sum())
    if nspill:
        dealt = spill(dealt, core_order, q, nspill)
    t2p = torch.empty_like(dealt)
    t2p[order] = dealt
    return t2p
