"""Torch scoring backend for the candidate search (plain tensor path).

Mirrors :func:`repro_torch.core.metrics.evaluate_candidates` — vectorised
hop metrics plus the batched dimension-ordered router — as plain tensor
operations on an explicit ``device``.  It is also the plain version the
CUDA kernel of :mod:`repro_torch.kernels.mapscore` is held against:

- the circular difference-array range-add of the router is a flat
  ``Tensor.index_add_`` into a zeros buffer over ``row*(s+1)+col`` keys
  followed by a per-row ``cumsum`` (the same formulation the numpy
  backend runs through ``np.bincount``);
- the candidate axis is a written-out batch dimension: the candidate
  index is folded into the row key, so one pass routes a whole chunk of
  candidates;
- nothing is compiled per shape, so no axis is padded: message and
  candidate counts run at their true sizes.

Every tensor states its dtype (coordinates and keys int64, hop counts
int64, weights float32 on arrival); the process-wide default dtype is
never touched.  Sums are taken in float64: ``index_add_`` on a GPU adds
in an order that changes from run to run, and float64 keeps the sums of
float32 weights exact in practice, so two candidates with equal
assignments score equal and the search's first-of-ties rule holds.
Numbers match the numpy backend within floating-point tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from .machine import Machine

MSG_BUCKET_MIN = 128  # smallest padded message-count bucket


def bucket_size(n: int, lo: int = MSG_BUCKET_MIN) -> int:
    """Next power of two >= max(n, lo).  Kept for callers that want
    bucketed shapes; the torch scorer itself never pads."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def pad_axis(arr, size, axis=0):
    """Zero-pad ``arr`` along ``axis`` to ``size`` entries (companion of
    :func:`bucket_size`; unused by the scorer)."""
    pad = size - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def _circular_range_add(row: torch.Tensor, start: torch.Tensor,
                        length: torch.Tensor, w: torch.Tensor,
                        nrows: int, s: int) -> torch.Tensor:
    """Difference-array range-add: add ``w`` to the circular interval
    [start, start+length) of each row's length-``s`` lane; returns the
    (nrows, s) link loads.  Column ``s`` is the dump bucket closing
    wrapped head intervals; zero-length messages contribute exact zeros.
    """
    base = row * (s + 1)
    end = start + length
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    wz = torch.where(length > 0, w, zero)
    wrapped = end > s
    wwr = torch.where(wrapped, wz, zero)
    idx = torch.cat([
        base + start,                              # open [start, ...)
        base + end.clamp(max=s),                   # close at end (or dump)
        base,                                      # wrapped tail opens at 0
        base + torch.where(wrapped, end - s, torch.zeros_like(end)),
    ])
    val = torch.cat([wz, -wz, wwr, -wwr])
    diff = torch.zeros(nrows * (s + 1), dtype=w.dtype, device=w.device)
    diff.index_add_(0, idx, val)
    return diff.view(nrows, s + 1)[:, :s].cumsum(dim=1)


def _route(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
           dims, wrap, nd: int):
    """Dimension-ordered routing of a chunk of candidates; per network
    dim the (+, -) link loads as ``(nb, rows_k, s_k)`` lanes (``rows_k``
    runs over the other machine dims in mixed-radix order).

    Same traversal as ``metrics._batched_route``: dim 0 first, shortest
    direction on tori; while dim ``k`` is routed the dims before it sit
    at the destination, the dims after it and the core dims at the
    source.  The candidate index is folded into the row key.
    """
    nb, ne, _ = src.shape
    cand = torch.arange(nb, dtype=torch.int64, device=src.device)[:, None]
    wb = w.to(torch.float64)[None, :].expand(nb, ne).reshape(-1)
    out = []
    for k in range(nd):
        s = dims[k]
        a = src[..., k]
        b = dst[..., k]
        if wrap[k]:
            fwd = (b - a) % s
            bwd = (a - b) % s
            use_fwd = fwd <= bwd
            len_f = torch.where(use_fwd, fwd, torch.zeros_like(fwd))
            len_b = torch.where(use_fwd, torch.zeros_like(bwd), bwd)
            start_b = (a - len_b) % s
        else:
            use_fwd = b >= a
            len_f = torch.where(use_fwd, b - a, torch.zeros_like(a))
            len_b = torch.where(use_fwd, torch.zeros_like(a), a - b)
            start_b = a - len_b
        rkey = torch.zeros_like(a)
        nrows = 1
        for j in range(len(dims)):
            if j == k:
                continue
            col = dst[..., j] if j < k else src[..., j]
            rkey = rkey * dims[j] + col
            nrows *= dims[j]
        row = (cand * nrows + rkey).reshape(-1)
        lane_p = _circular_range_add(row, a.reshape(-1), len_f.reshape(-1),
                                     wb, nb * nrows, s)
        lane_n = _circular_range_add(row, start_b.reshape(-1),
                                     len_b.reshape(-1), wb, nb * nrows, s)
        out.append((lane_p.view(nb, nrows, s), lane_n.view(nb, nrows, s)))
    return out


def _score_chunk(coord_stack: torch.Tensor, edges: torch.Tensor,
                 w: torch.Tensor, inv_bw: torch.Tensor | None, *,
                 dims, wrap, core_dims: int, traffic: bool) -> dict:
    """Score one chunk of candidates with plain tensor operations.

    coord_stack : (nb, ntasks, ncols) integer machine coordinates.
    edges       : (E, 2) int64 task index pairs.
    w           : (E,) float32 message weights.
    inv_bw      : (sum of network extents,) float32 — 1/bandwidth per
                  link column, concatenated per dim (``traffic`` only).

    Returns tensors on the inputs' device: ``weighted_hops`` (nb,)
    float64, ``total_hops`` (nb,) int64 and — with ``traffic`` —
    ``data_max`` / ``latency_max`` (nb,) float64.
    """
    nd = len(dims) - core_dims
    cs = coord_stack.to(torch.int64)
    src = cs[:, edges[:, 0]]
    dst = cs[:, edges[:, 1]]
    nb = src.shape[0]
    hops = torch.zeros(src.shape[:-1], dtype=torch.int64, device=src.device)
    for k in range(nd):
        s = dims[k]
        d = (src[..., k] - dst[..., k]).abs()
        if wrap[k]:
            d = torch.minimum(d, s - d)
        hops = hops + d
    out = {
        "weighted_hops": (hops.to(torch.float64)
                          * w.to(torch.float64)[None, :]).sum(dim=-1),
        "total_hops": hops.sum(dim=-1),
    }
    if traffic:
        data = torch.zeros(nb, dtype=torch.float64, device=src.device)
        lat = torch.zeros(nb, dtype=torch.float64, device=src.device)
        off = 0
        for k, lanes in enumerate(_route(src, dst, w, dims, wrap, nd)):
            inv = inv_bw[off:off + dims[k]].to(torch.float64)[None, None, :]
            off += dims[k]
            for lane in lanes:
                data = torch.maximum(data, lane.amax(dim=(1, 2)))
                lat = torch.maximum(lat, (lane * inv).amax(dim=(1, 2)))
        out["data_max"] = data
        out["latency_max"] = lat
    return out


def inverse_bandwidths(machine: Machine) -> np.ndarray:
    """1/bandwidth of every link column of the network dims,
    concatenated per dim: entry ``sum(dims[:k]) + c`` belongs to the
    link ``c -> c+1`` along dim ``k``.  Core dims are left out (their
    links are free and never routed)."""
    nd = machine.ndim - machine.core_dims
    if not nd:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate([
        1.0 / np.asarray(machine.bw(k, np.arange(machine.dims[k])),
                         dtype=np.float64)
        for k in range(nd)]).astype(np.float32)


def scoring_inputs(machine: Machine, task_edges, edge_weights, coord_stack,
                   traffic: bool, device):
    """The scorer's inputs as tensors on ``device``:
    ``(coord_stack int32, edges int64, w float32, inv_bw float32|None)``.
    Shared by the torch scorer and the kernel wrapper so both see the
    same values."""
    dev = torch.device(device)
    ne = len(task_edges)
    cs = torch.as_tensor(coord_stack).to(device=dev, dtype=torch.int32)
    if traffic and cs.shape[-1] < machine.ndim:
        # routing keys its rows on every machine dim; a stack that left
        # the core columns out gets them back as zeros (they are free)
        cs = torch.nn.functional.pad(cs, (0, machine.ndim - cs.shape[-1]))
    edges = torch.as_tensor(np.ascontiguousarray(task_edges)).to(
        device=dev, dtype=torch.int64)
    if edge_weights is None:
        w = torch.ones(ne, dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(np.asarray(edge_weights)).to(
            device=dev, dtype=torch.float32)
    inv_bw = None
    if traffic:
        inv_bw = torch.from_numpy(inverse_bandwidths(machine)).to(dev)
    return cs.contiguous(), edges.contiguous(), w.contiguous(), inv_bw


def empty_scores(nb: int, traffic: bool) -> dict:
    """The all-zero result dict of ``evaluate_candidates`` for ``nb``
    candidates (what an empty edge list or candidate stack scores)."""
    out = {
        "weighted_hops": np.zeros(nb),
        "total_hops": np.zeros(nb, dtype=np.int64),
        "average_hops": np.zeros(nb),
    }
    if traffic:
        out["data_max"] = np.zeros(nb)
        out["latency_max"] = np.zeros(nb)
    return out


def evaluate_candidates_torch(machine: Machine, task_edges: np.ndarray,
                              edge_weights: np.ndarray | None,
                              coord_stack, *,
                              traffic: bool = False,
                              chunk_elems: int = 1 << 24,
                              device="cuda") -> dict:
    """Torch implementation of ``evaluate_candidates`` (same contract,
    results within fp tolerance of the numpy backend), run on
    ``device``.  The candidate axis is chunked by ``chunk_elems``
    message-coordinates and link entries, as in the numpy backend."""
    nb = len(coord_stack)
    ne = len(task_edges)
    out = empty_scores(nb, traffic)
    if ne == 0 or nb == 0:
        return out
    nd = machine.ndim - machine.core_dims
    dims = tuple(int(x) for x in machine.dims)
    wrap = tuple(bool(x) for x in machine.wrap)
    cs, edges, w, inv_bw = scoring_inputs(
        machine, task_edges, edge_weights, coord_stack, traffic, device)

    per_cand = max(ne * machine.ndim, 1)
    if traffic:
        per_cand += 2 * nd * machine.nnodes
    chunk = int(max(1, chunk_elems // per_cand))
    for c0 in range(0, nb, chunk):
        ev = _score_chunk(cs[c0:c0 + chunk], edges, w, inv_bw, dims=dims,
                          wrap=wrap, core_dims=machine.core_dims,
                          traffic=traffic)
        sl = slice(c0, c0 + chunk)
        for key, val in ev.items():
            out[key][sl] = val.cpu().numpy().astype(out[key].dtype)
    # averages from the integer sums (bit-identical to numpy's h.mean)
    out["average_hops"] = out["total_hops"] / ne
    return out
