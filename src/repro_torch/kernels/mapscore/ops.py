"""Public wrappers of the mapscore kernel.

:func:`mapscore` is the tensor-level entry: for CUDA tensors it checks
its arguments, allocates outputs and the link-accumulator workspace,
and launches the kernel — or raises; for CPU tensors it runs the plain
version (:mod:`.ref`).  :func:`evaluate_candidates_hopper` wraps it in
the ``evaluate_candidates`` contract (numpy in, numpy out, candidate
axis chunked) and is what ``score_backend="hopper"`` resolves to.

Differences from the reference wrapper, by design: endpoints are
gathered by the kernel from ``coord_stack`` and ``edges`` on the device
(no host gather), no axis is padded (one compiled kernel serves every
shape), the link accumulators live in device memory whatever the
machine's size (no size-based switch to another scorer), and
``total_hops`` is accumulated in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.core.machine import Machine
from repro_torch.core.metrics_torch import empty_scores, scoring_inputs

from . import kernel as _kernel
from .ref import mapscore_ref

# default bound of the link-accumulator workspace, in int64 entries
# (512 MiB): device memory is plentiful, and a whole rotation sweep on
# the largest registry machines then goes down in one launch
CHUNK_ELEMS = 1 << 26

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("mapscore_hopper",
                      lambda: {"launches": launch_count})


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mapscore(coord_stack: torch.Tensor, edges: torch.Tensor,
             w: torch.Tensor, inv_bw: torch.Tensor | None = None, *,
             dims, wrap, core_dims: int, traffic: bool) -> dict:
    """Score a stack of candidate mappings.

    coord_stack : (nb, ntasks, ncols) int32 machine coordinates of every
                  task under each candidate; ``ncols == len(dims)`` when
                  ``traffic``, else at least the network dims.
    edges       : (E, 2) int64 task index pairs.
    w           : (E,) float32 message weights (shared by candidates).
    inv_bw      : (sum of network extents,) float32 1/bandwidth per link
                  column, concatenated per dim (``traffic`` only).

    Returns (nb,) tensors on the inputs' device: ``weighted_hops``
    float64, ``total_hops`` int64 and — when ``traffic`` — ``data_max``
    / ``latency_max`` float64.  On CUDA tensors the kernel runs (two
    calls on equal inputs agree bit for bit); on CPU tensors the plain
    version does.
    """
    global launch_count
    dims = tuple(int(d) for d in dims)
    wrap = tuple(bool(x) for x in wrap)
    nd = len(dims) - core_dims
    dev = coord_stack.device
    if dev.type != "cuda":
        return mapscore_ref(coord_stack, edges, w, inv_bw, dims=dims,
                            wrap=wrap, core_dims=core_dims, traffic=traffic)

    if len(dims) > _kernel.MAX_DIMS:
        raise ValueError(f"machines of more than {_kernel.MAX_DIMS} dims "
                         "are not supported by the kernel")
    _check(coord_stack, "coord_stack", torch.int32, 3, dev)
    _check(edges, "edges", torch.int64, 2, dev)
    _check(w, "w", torch.float32, 1, dev)
    nb, ntasks, ncols = coord_stack.shape
    ne = edges.shape[0]
    if edges.shape[1] != 2 or w.shape[0] != ne:
        raise ValueError("edges must be (E, 2) and w (E,)")
    need = len(dims) if traffic else nd
    if ncols < need or ncols > len(dims):
        raise ValueError(f"coord_stack has {ncols} columns; "
                         f"need {need}..{len(dims)}")
    out = {"weighted_hops": torch.zeros(nb, dtype=torch.float64, device=dev),
           "total_hops": torch.zeros(nb, dtype=torch.int64, device=dev)}
    if traffic:
        out["data_max"] = torch.zeros(nb, dtype=torch.float64, device=dev)
        out["latency_max"] = torch.zeros(nb, dtype=torch.float64, device=dev)
    if nb == 0 or ne == 0:
        return out

    # the kernel indexes with what it is given: refuse indices that would
    # leave the coordinate table or the workspace
    lo, hi = torch.aminmax(edges)
    if int(lo) < 0 or int(hi) >= ntasks:
        raise ValueError("edges index outside the task range")
    cmin = coord_stack.amin(dim=(0, 1)).tolist()
    cmax = coord_stack.amax(dim=(0, 1)).tolist()
    for j in range(ncols):
        if cmin[j] < 0 or cmax[j] >= dims[j]:
            raise ValueError(f"coord_stack column {j} leaves [0, {dims[j]})")

    rows, acc_off, ws_per_cand = _kernel.workspace_layout(dims, core_dims)
    p = _kernel.MapscoreParams()
    p.ndim, p.nd, p.ncols, p.traffic = len(dims), nd, ncols, int(traffic)
    p.nb, p.ntasks, p.ne = nb, ntasks, ne
    p.ws_per_cand = ws_per_cand if traffic else 0
    p.nthreads_red = 2 * sum(rows)
    shift = _kernel.fixed_point_shift(
        float(w.abs().sum(dtype=torch.float64)), dims, core_dims)
    p.scale, p.inv_scale = 2.0 ** shift, 2.0 ** -shift
    bw_off = 0
    for k in range(len(dims)):
        p.dims[k], p.wrap[k] = dims[k], int(wrap[k])
    for k in range(nd):
        p.rows[k], p.acc_off[k], p.bw_off[k] = rows[k], acc_off[k], bw_off
        bw_off += dims[k]

    ws = None
    if traffic:
        _check(inv_bw, "inv_bw", torch.float32, 1, dev)
        if inv_bw.shape[0] != bw_off:
            raise ValueError(f"inv_bw must have {bw_off} entries")
        ws = torch.zeros((nb, ws_per_cand), dtype=torch.int64, device=dev)
    acc = torch.zeros((nb, 2), dtype=torch.int64, device=dev)
    outf = torch.zeros((nb, 3), dtype=torch.float64, device=dev)
    _kernel.mapscore_launch(coord_stack, edges, w, inv_bw, ws, acc, outf, p)
    launch_count += 1

    out["weighted_hops"] = outf[:, 0]
    out["total_hops"] = acc[:, 1]
    if traffic:
        out["data_max"] = outf[:, 1]
        out["latency_max"] = outf[:, 2]
    return out


def candidate_chunk(machine: Machine, traffic: bool,
                    chunk_elems: int = CHUNK_ELEMS) -> int:
    """Candidates scored per launch: ``chunk_elems`` bounds the entries
    of the link-accumulator workspace (hop-only scoring has none and
    takes the whole stack at once; 0 means unbounded)."""
    if not traffic:
        return 0
    dims = tuple(int(d) for d in machine.dims)
    _, _, per_cand = _kernel.workspace_layout(dims, machine.core_dims)
    return int(max(1, chunk_elems // max(per_cand, 1)))


def evaluate_candidates_hopper(machine: Machine, task_edges: np.ndarray,
                               edge_weights: np.ndarray | None,
                               coord_stack, *,
                               traffic: bool = False,
                               chunk_elems: int = CHUNK_ELEMS,
                               device="cuda") -> dict:
    """``evaluate_candidates`` through the CUDA kernel (same contract;
    results within fp tolerance of the numpy reference).

    Inputs go to ``device`` once; each chunk of candidates is one
    kernel launch, and only the per-candidate metric vectors return to
    the host.  With a CPU ``device`` the plain version runs instead —
    the path the CPU tests take; ``get_evaluator("hopper", "cpu")``
    refuses to resolve to it.
    """
    nb = len(coord_stack)
    ne = len(task_edges)
    out = empty_scores(nb, traffic)
    if ne == 0 or nb == 0:
        return out
    # marker span at the fault hook: an injected kernel fault lands in
    # the trace error-annotated exactly where a real one would; the
    # enclosing score.hopper span carries the wall-clock
    with obs.span("kernel.mapscore", candidates=int(nb), edges=int(ne)):
        faults.fire("kernel.mapscore")
    cs, edges, w, inv_bw = scoring_inputs(
        machine, task_edges, edge_weights, coord_stack, traffic, device)
    chunk = candidate_chunk(machine, traffic, chunk_elems) or nb
    for c0 in range(0, nb, chunk):
        ev = mapscore(cs[c0:c0 + chunk], edges, w, inv_bw,
                      dims=machine.dims, wrap=machine.wrap,
                      core_dims=machine.core_dims, traffic=traffic)
        sl = slice(c0, c0 + chunk)
        for key, val in ev.items():
            out[key][sl] = val.cpu().numpy().astype(out[key].dtype)
    out["average_hops"] = out["total_hops"] / ne
    return out
