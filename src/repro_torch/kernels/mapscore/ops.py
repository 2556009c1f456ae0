"""Public wrappers of the mapscore kernel.

:func:`mapscore` is the tensor-level entry: for CUDA tensors it checks
its arguments' types and shapes, allocates the outputs, and launches the
kernel — or raises; for CPU tensors it runs the plain version
(:mod:`.ref`).  :func:`evaluate_candidates_hopper` wraps it in the
``evaluate_candidates`` contract (numpy in, numpy out) and is what
``score_backend="hopper"`` resolves to.

Nothing between the entry of :func:`mapscore` and the launch waits for
the card.  What needs the data is checked by the kernel itself, in its
first pass: an edge outside the task range, a coordinate outside its
dimension and a non-finite weight sum each set a bit of a status word,
and then no message is routed (no index can leave the coordinate tables
or the workspace).  :func:`mapscore` returns that word beside the metrics
(``"status"``, int64; the plain version computes the same word), with
``"shift"``, the fixed-point exponent the sums used.  The metrics are
only meaningful when the status is 0: :func:`raise_for_status` raises
the ``ValueError`` the word stands for, and
:func:`evaluate_candidates_hopper` does so with the copy that brings its
results to the host.

The candidates go through the kernel in groups (``kernel.group_size``:
at most :data:`GROUP_ELEMS` accumulator entries a group, at least four
groups a stack), a group's reduce beside the next group's accumulate.
An empty stack or edge list launches nothing and returns zeros, status
0, on both paths.  The two
link-accumulator workspaces and the per-candidate sums live in a scratch
buffer kept per (device, stream), all zero between launches: the
kernel's last passes leave it so.  A second one holds what each launch
writes before it reads (narrowed edges, packed coordinates, partial
sums).  Both grow with the largest launch.

Differences from the reference wrapper, by design: endpoints are
gathered by the kernel from ``coord_stack`` and ``edges`` on the device
(no host gather), no axis is padded (one compiled kernel serves every
shape), the link accumulators live in device memory whatever the
machine's size (no size-based switch to another scorer), and
``total_hops`` is accumulated in int64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.core.machine import Machine
from repro_torch.core.metrics_torch import empty_scores, scoring_inputs

from . import kernel as _kernel
from .ref import mapscore_ref

# default bound of one group's link accumulators, in int64 entries: the
# H100's 50 MiB L2 cache.  With four groups to a stack of 8, a group is two
# candidates on each full-size machine: 48 MiB on a (32,32,32,16) Gemini
# torus, 40 MiB on a BG/Q, 16 MiB on a 512 x 512 torus
GROUP_ELEMS = 50 << 17

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("mapscore_hopper",
                      lambda: {"launches": launch_count})

# persistent scratch per (device index, stream): all zero between launches
_SCRATCH: dict = {}


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


def _scratch(dev: torch.device, stream: int, zero: int, work: int) -> tuple:
    """The two scratch buffers of ``dev`` and ``stream``, grown to at least
    ``zero`` and ``work`` int64 entries: one all zero between launches
    (header, per-candidate slots, link accumulators), one that each launch
    overwrites (narrowed edges, packed coordinates, partial sums).
    ``(key, zero buffer, work buffer)``."""
    key = (dev.index, stream)
    bufs = _SCRATCH.get(key)
    if bufs is None or bufs[0].numel() < zero or bufs[1].numel() < work:
        old = bufs or (None, None)
        bufs = tuple(
            b if b is not None and b.numel() >= n
            else torch.zeros(n, dtype=torch.int64, device=dev)
            for b, n in zip(old, (zero, work)))
        _SCRATCH[key] = bufs
    return key, bufs[0], bufs[1]


def unpack(res: torch.Tensor, nb: int, traffic: bool) -> dict:
    """The result dict of :func:`mapscore` as views of its packed int64
    buffer ``[status, shift, total_hops (nb), then as float64
    weighted_hops, data_max, latency_max (nb each)]``."""
    f = res[2 + nb:].view(torch.float64)
    out = {"weighted_hops": f[:nb], "total_hops": res[2:2 + nb],
           "status": res[0], "shift": res[1]}
    if traffic:
        out["data_max"] = f[nb:2 * nb]
        out["latency_max"] = f[2 * nb:]
    return out


def pack(ev: dict, nb: int) -> torch.Tensor:
    """Inverse of :func:`unpack` (for the plain version's results)."""
    dev = ev["total_hops"].device
    res = torch.zeros(2 + 4 * nb, dtype=torch.int64, device=dev)
    res[0] = ev["status"]
    res[1] = ev["shift"]
    res[2:2 + nb] = ev["total_hops"]
    f = res[2 + nb:].view(torch.float64)
    f[:nb] = ev["weighted_hops"]
    if "data_max" in ev:
        f[nb:2 * nb] = ev["data_max"]
        f[2 * nb:] = ev["latency_max"]
    return res


def raise_for_status(status, dims) -> None:
    """Raise the ``ValueError`` a status word stands for (reads it to
    the host: a sync)."""
    msg = _kernel.status_error(int(status), dims)
    if msg is not None:
        raise ValueError(msg)


@functools.lru_cache(maxsize=64)
def _params(dims, wrap, core_dims, traffic, nb, ntasks, ncols, ne,
            group_elems) -> tuple:
    """``(params, sizes)`` of one launch shape, built once so that the
    path to the launch stays short.  ``sizes``: int64 entries of the zero
    scratch (header, per-candidate slots, one group's link
    accumulators), then the offsets in the work scratch of the packed
    coordinate table and the partial sums (the narrowed edges start it),
    and its length."""
    nd = len(dims) - core_dims
    rows, _, per_cand = _kernel.workspace_layout(dims, core_dims)
    if traffic and per_cand >= 2 ** 31:
        raise ValueError("a candidate's link accumulators exceed the "
                         "kernel's int32 offsets (2**31 entries)")
    group = _kernel.group_size(per_cand if traffic else 0, nb, group_elems)
    ws_entries = group * per_cand if traffic else 0
    cand_off, ws_off, nzero = _kernel.scratch_entries(nb, ws_entries)
    pshift, pmask, wide = _kernel.packing(dims, ncols)
    p = _kernel.MapscoreParams()
    p.ndim, p.nd, p.ncols, p.traffic = len(dims), nd, ncols, int(traffic)
    p.group, p.packed64 = group, int(wide)
    p.nb, p.ntasks, p.ne = nb, ntasks, ne
    p.unit, p.rows_max = 2 * math.prod(dims), max(rows, default=0)
    p.cand_off, p.ws_off = cand_off, ws_off
    p.prep_blocks = _kernel.prep_blocks(ne, nb * ntasks)
    p.span = float(_kernel.hop_span(dims, core_dims))
    for j, d in enumerate(dims):
        p.dims[j], p.wrap[j] = d, int(wrap[j])
    for j in range(ncols):
        p.pshift[j], p.pmask[j] = pshift[j], pmask[j]
    bw_off = 0
    for k, st in enumerate(_kernel.row_strides(dims, core_dims)):
        p.rows[k], p.bw_off[k] = rows[k], bw_off
        for j, v in enumerate(st):
            p.stride[k][j] = v
        bw_off += dims[k]
    table_off = ne                              # one int2 edge an entry
    parts_off = table_off + -(-nb * ntasks * (2 if wide else 1) // 2)
    return p, (nzero, table_off, parts_off, parts_off + p.prep_blocks)


def _scores(coord_stack, edges, w, inv_bw, *, dims, wrap, core_dims,
            traffic, group_elems) -> torch.Tensor:
    """Packed results (see :func:`unpack`) on the inputs' device.  Every
    call passes the ``kernel.mapscore`` fault site first, the staged
    scorer's and the fused sweep's alike."""
    global launch_count
    faults.fire("kernel.mapscore")
    dims = tuple(int(d) for d in dims)
    wrap = tuple(bool(x) for x in wrap)
    nd = len(dims) - core_dims
    dev = coord_stack.device
    if dev.type != "cuda":
        ev = mapscore_ref(coord_stack, edges, w, inv_bw, dims=dims,
                          wrap=wrap, core_dims=core_dims, traffic=traffic)
        return pack(ev, coord_stack.shape[0])

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
    if ntasks >= 2 ** 31:
        raise ValueError("the kernel indexes tasks with int32")
    if nb == 0 or ne == 0:
        return torch.zeros(2 + 4 * nb, dtype=torch.int64, device=dev)
    if traffic:
        _check(inv_bw, "inv_bw", torch.float32, 1, dev)
        if inv_bw.shape[0] != sum(dims[:nd]):
            raise ValueError(f"inv_bw must have {sum(dims[:nd])} entries")
    if coord_stack.data_ptr() % 16:
        coord_stack = coord_stack.clone()  # 16-byte rows for the loads

    p, (nzero, table_off, parts_off, nwork) = _params(
        dims, wrap, core_dims, bool(traffic), nb, ntasks, ncols, ne,
        int(group_elems))
    stream = torch.cuda.current_stream(dev).cuda_stream
    key, zero, work = _scratch(dev, stream, nzero, nwork)
    res = torch.empty(2 + 4 * nb, dtype=torch.int64, device=dev)
    base = work.data_ptr()
    try:
        _kernel.mapscore_launch(
            coord_stack.data_ptr(), edges.data_ptr(), w.data_ptr(),
            inv_bw.data_ptr() if traffic else None, base,
            base + 8 * table_off, base + 8 * parts_off, zero.data_ptr(),
            res.data_ptr(), p, stream)
    except RuntimeError:
        # a refused pass may leave the scratch non-zero: start afresh
        _SCRATCH.pop(key, None)
        raise
    launch_count += 1
    return res


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

    Returns tensors on the inputs' device: (nb,) ``weighted_hops``
    float64, ``total_hops`` int64 and — when ``traffic`` — ``data_max``
    / ``latency_max`` float64; 0-dim int64 ``status`` (0: all clear, see
    :func:`raise_for_status`) and ``shift``.  On CUDA tensors the kernel
    runs without a host sync (two calls on equal inputs agree bit for
    bit); on CPU tensors the plain version does.
    """
    res = _scores(coord_stack, edges, w, inv_bw, dims=dims, wrap=wrap,
                  core_dims=core_dims, traffic=traffic,
                  group_elems=GROUP_ELEMS)
    return unpack(res, coord_stack.shape[0], traffic)


def candidate_chunk(machine: Machine, traffic: bool,
                    chunk_elems: int = GROUP_ELEMS,
                    nb: int = _kernel.GROUP_MAX * _kernel.PIPELINE_GROUPS
                    ) -> int:
    """Candidates the kernel scores per group of a stack of ``nb``:
    ``chunk_elems`` bounds the entries of a group's link accumulators
    (hop-only scoring has none: 0, and the kernel takes groups of
    ``kernel.group_size``)."""
    if not traffic:
        return 0
    dims = tuple(int(d) for d in machine.dims)
    _, _, per_cand = _kernel.workspace_layout(dims, machine.core_dims)
    return _kernel.group_size(per_cand, nb, chunk_elems)


def evaluate_candidates_hopper(machine: Machine, task_edges: np.ndarray,
                               edge_weights: np.ndarray | None,
                               coord_stack, *,
                               traffic: bool = False,
                               chunk_elems: int = GROUP_ELEMS,
                               device="cuda") -> dict:
    """``evaluate_candidates`` through the CUDA kernel (same contract;
    results within fp tolerance of the numpy reference).

    Inputs go to ``device`` once, the whole stack is one kernel launch
    (``chunk_elems`` bounds a group's link accumulators inside it), and
    one copy brings the metric vectors and the status word to the host;
    a fault the kernel found raises ``ValueError`` there.  With a CPU
    ``device`` the plain version runs instead — the path the CPU tests
    take; ``get_evaluator("hopper", "cpu")`` refuses to resolve to it.
    """
    nb = len(coord_stack)
    ne = len(task_edges)
    out = empty_scores(nb, traffic)
    if ne == 0 or nb == 0:
        return out
    cs, edges, w, inv_bw = scoring_inputs(
        machine, task_edges, edge_weights, coord_stack, traffic, device)
    res = _scores(cs, edges, w, inv_bw, dims=machine.dims, wrap=machine.wrap,
                  core_dims=machine.core_dims, traffic=traffic,
                  group_elems=chunk_elems).cpu()
    ev = unpack(res, nb, traffic)
    raise_for_status(ev["status"], machine.dims)
    for key in out:
        if key in ev:
            out[key] = ev[key].numpy().astype(out[key].dtype)
    out["average_hops"] = out["total_hops"] / ne
    return out
