"""Plain-torch version of the mapscore kernel.

Same inputs, same outputs as :func:`repro_torch.kernels.mapscore.ops.mapscore`,
computed with ordinary tensor operations through the torch scorer
(:func:`repro_torch.core.metrics_torch._score_chunk`).  The CPU tests use
it, the wrapper takes it for tensors that lie on the CPU, and the kernel
is compared with it on the card.  It repeats the kernel's arithmetic and
is no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core.metrics_torch import _score_chunk


def mapscore_ref(coord_stack: torch.Tensor, edges: torch.Tensor,
                 w: torch.Tensor, inv_bw: torch.Tensor | None, *,
                 dims, wrap, core_dims: int, traffic: bool) -> dict:
    """Per-candidate metric sums for a stack of candidate mappings.

    coord_stack : (nb, ntasks, ncols) integer machine coordinates.
    edges       : (E, 2) int64 task index pairs.
    w           : (E,) float32 message weights (shared by candidates).
    inv_bw      : (sum of network extents,) float32, ``traffic`` only.

    Returns (nb,) tensors: ``weighted_hops`` float64, ``total_hops``
    int64 and — when ``traffic`` — ``data_max`` / ``latency_max``
    float64: the kernel's output types.
    """
    return _score_chunk(coord_stack, edges, w, inv_bw, dims=tuple(dims),
                        wrap=tuple(wrap), core_dims=core_dims,
                        traffic=traffic)
