"""Plain-torch version of the mapscore kernel.

Same inputs, same outputs as :func:`repro_torch.kernels.mapscore.ops.mapscore`,
computed with ordinary tensor operations through the torch scorer
(:func:`repro_torch.core.metrics_torch._score_chunk`).  The CPU tests use
it, the wrapper takes it for tensors that lie on the CPU, and the kernel
is compared with it on the card.  It repeats the kernel's arithmetic and
is no yardstick of speed.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.metrics_torch import _score_chunk

from . import kernel as _kernel


def input_status(coord_stack: torch.Tensor, edges: torch.Tensor,
                 w: torch.Tensor, dims) -> torch.Tensor:
    """The kernel's status word (0-dim int64) for these inputs: an edge
    outside the task range; per column, a coordinate outside its
    dimension; a non-finite |w| sum."""
    ntasks, ncols = coord_stack.shape[1], coord_stack.shape[2]
    dev = coord_stack.device
    bad_edge = ((edges < 0) | (edges >= ntasks)).any()
    lim = torch.tensor(dims[:ncols], dtype=coord_stack.dtype, device=dev)
    off = (coord_stack < 0) | (coord_stack >= lim)
    col_bad = off.reshape(-1, ncols).any(dim=0)
    bits = torch.tensor([_kernel.ST_COL0 << j for j in range(ncols)],
                        dtype=torch.int64, device=dev)
    finite = torch.isfinite(w.abs().sum(dtype=torch.float64))
    return ((col_bad.to(torch.int64) * bits).sum()
            + bad_edge.to(torch.int64) * _kernel.ST_EDGE
            + (~finite).to(torch.int64) * _kernel.ST_WEIGHT)


def shift_of(abs_weight_sum: float, span: int) -> int:
    """Exponent ``e`` of the fixed-point scale ``2**e``: the largest with
    ``abs_weight_sum * span * 2**e < 2**62``, ``span`` the most hops a
    message can take; 0 for a zero sum, ``SHIFT_NONE`` for one that is
    not finite."""
    bound = abs_weight_sum * span
    if not math.isfinite(bound):
        return _kernel.SHIFT_NONE
    return 62 - math.frexp(bound)[1] if bound > 0.0 else 0


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
    float64: the kernel's output types; and 0-dim int64 ``status``
    (:func:`input_status`) and ``shift`` (:func:`shift_of`, the
    fixed-point exponent the kernel uses).  The metrics are those of the
    inputs clamped into range, and mean nothing unless ``status`` is 0.
    With no candidates or no messages nothing is scored or checked, as
    the wrapper launches no kernel then: every output is zero.
    """
    dims = tuple(int(d) for d in dims)
    ntasks, ncols = coord_stack.shape[1], coord_stack.shape[2]
    dev = coord_stack.device
    nb, nd = coord_stack.shape[0], len(dims) - core_dims
    if nb == 0 or edges.shape[0] == 0:
        zero = torch.zeros(nb, dtype=torch.float64, device=dev)
        out = {"weighted_hops": zero, "total_hops": zero.to(torch.int64)}
        if traffic:
            out["data_max"], out["latency_max"] = zero.clone(), zero.clone()
        out["status"] = torch.zeros((), dtype=torch.int64, device=dev)
        out["shift"] = torch.zeros((), dtype=torch.int64, device=dev)
        return out
    status = input_status(coord_stack, edges, w, dims)
    shift = shift_of(float(w.abs().sum(dtype=torch.float64)),
                     max(2, sum(dims[:nd])))
    lim = torch.tensor(dims[:ncols], dtype=coord_stack.dtype, device=dev)
    cs = torch.minimum(coord_stack.clamp_min(0), lim - 1)
    out = _score_chunk(cs, edges.clamp(0, max(ntasks - 1, 0)), w, inv_bw,
                       dims=dims, wrap=tuple(wrap), core_dims=core_dims,
                       traffic=traffic)
    out["status"] = status
    out["shift"] = torch.tensor(shift, dtype=torch.int64, device=dev)
    return out
