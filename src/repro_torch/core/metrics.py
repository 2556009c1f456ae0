"""Mapping quality metrics (paper §3, Eqns. 1-7).

All metrics assume static dimension-ordered routing (dim 0 first, then dim
1, ...), shortest direction per dimension on tori, messages never split
across paths — the paper's assumptions.  Links are directed (the paper's
Fig. 12 reports X+/X- separately).

Core dimensions of a machine (intra-node) contribute zero hops and carry
no accountable traffic (infinite bandwidth), matching the paper's
treatment of multicore nodes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.device import resolve_device

from .machine import Machine


# ---------------------------------------------------------------------------
# Hops (Eqns. 1-3)
# ---------------------------------------------------------------------------

def pairwise_hops(machine: Machine, src: np.ndarray, dst: np.ndarray
                  ) -> np.ndarray:
    """Shortest-path hop count between coordinate rows (per message).

    ``src``/``dst`` may carry leading batch dimensions (``(..., E, nd)``)
    — the candidate-search engine scores whole candidate stacks in one
    call; the result has shape ``src.shape[:-1]``.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    nd = machine.ndim - machine.core_dims
    total = np.zeros(src.shape[:-1], dtype=np.int64)
    for k in range(nd):
        s = machine.dims[k]
        d = np.abs(src[..., k] - dst[..., k])
        if machine.wrap[k]:
            d = np.minimum(d, s - d)
        total += d
    return total


def total_hops(machine, src, dst) -> int:
    return int(pairwise_hops(machine, src, dst).sum())


def average_hops(machine, src, dst) -> float:
    h = pairwise_hops(machine, src, dst)
    return float(h.mean()) if len(h) else 0.0


def weighted_hops(machine, src, dst, weights) -> float:
    h = pairwise_hops(machine, src, dst)
    return float((h * np.asarray(weights)).sum())


# ---------------------------------------------------------------------------
# Per-link traffic under dimension-ordered routing (Eqns. 4-7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Traffic:
    """Directed per-link traffic.

    ``pos[k]`` has the machine's full shape; entry at coordinate ``x`` is
    the bytes crossing the + link of ``x`` along dim ``k`` (from x to
    x+e_k, wrapping).  ``neg[k]`` likewise for the - direction (from
    x+e_k down to x).  Core dims carry no entries (None).
    """

    machine: Machine
    pos: list
    neg: list

    def link_data(self) -> np.ndarray:
        """All directed link loads as one flat vector (network dims only)."""
        parts = []
        nd = self.machine.ndim - self.machine.core_dims
        for k in range(nd):
            parts.append(self.pos[k].ravel())
            parts.append(self.neg[k].ravel())
        return np.concatenate(parts) if parts else np.zeros(0)

    def link_latency(self) -> np.ndarray:
        parts = []
        nd = self.machine.ndim - self.machine.core_dims
        for k in range(nd):
            bw_full = self.machine.bw_field(k)
            parts.append((self.pos[k] / bw_full).ravel())
            parts.append((self.neg[k] / bw_full).ravel())
        return np.concatenate(parts) if parts else np.zeros(0)


def route_traffic(machine: Machine, src: np.ndarray, dst: np.ndarray,
                  weights: np.ndarray | None = None) -> Traffic:
    """Accumulate per-link traffic for messages src->dst (dim-ordered)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    pos, neg = _batched_route(machine, src[None], dst[None], weights)
    return Traffic(machine, [p[0] for p in pos], [p[0] for p in neg])


def _batched_route(machine: Machine, src: np.ndarray, dst: np.ndarray,
                   weights: np.ndarray | None = None):
    """Dimension-ordered routing for a whole STACK of mappings at once.

    ``src``/``dst``: (B, E, ndim) integer coordinates — one candidate
    mapping per leading index.  Returns ``(pos, neg)``: per network dim,
    a ``(B, *machine.dims)`` array of directed link loads.  The batch is
    folded into the row index of the shared difference-array range-add,
    so scoring B candidates costs one vectorised pass instead of B
    python-level routing loops (the mapping pipeline's candidate search
    relies on this).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    nb, nmsg, _ = src.shape
    if weights is None:
        w = np.ones(nb * nmsg)
    else:
        w = np.broadcast_to(np.asarray(weights, dtype=np.float64),
                            (nb, nmsg)).reshape(-1)
    nd = machine.ndim - machine.core_dims
    dims = machine.dims

    pos = [np.zeros((nb,) + dims) for _ in range(nd)]
    neg = [np.zeros((nb,) + dims) for _ in range(nd)]

    # current position starts at src; after routing dim k it holds dst[:k+1]
    cur = src.copy()
    for k in range(nd):
        s = dims[k]
        a = cur[..., k].reshape(-1)
        b = dst[..., k].reshape(-1)
        if machine.wrap[k]:
            fwd = (b - a) % s
            bwd = (a - b) % s
            use_fwd = fwd <= bwd
            length_f = np.where(use_fwd, fwd, 0)
            length_b = np.where(use_fwd, 0, bwd)
        else:
            use_fwd = b >= a
            length_f = np.where(use_fwd, b - a, 0)
            length_b = np.where(use_fwd, 0, a - b)

        # rows: all machine dims fixed except k, plus the candidate index
        # as the leading coordinate.  (Core dims stay at the src's core
        # coords — they are free, routing order irrelevant.)
        other = [cur[..., j].reshape(-1)
                 for j in range(machine.ndim) if j != k]
        row_dims = tuple(d for j, d in enumerate(dims) if j != k)
        if row_dims:
            row = np.ravel_multi_index(other, row_dims)
        else:
            row = np.zeros(nb * nmsg, dtype=np.int64)
        nrows = int(np.prod(row_dims)) if row_dims else 1
        row = row + np.repeat(np.arange(nb, dtype=np.int64) * nrows, nmsg)

        # + direction: links a, a+1, ..., a+len-1 (mod s)
        _accumulate_circular(pos[k], row, nb * nrows, s, a, length_f, w,
                             dims, k)
        # - direction: crossing from a down by len uses - channels at
        # indices (a-1, a-2, ..., a-len) mod s == start (a-len) length len
        start_b = (a - length_b) % s if machine.wrap[k] else a - length_b
        _accumulate_circular(neg[k], row, nb * nrows, s, start_b, length_b,
                             w, dims, k)
        cur = cur.copy()
        cur[..., k] = dst[..., k]
    return pos, neg


def _accumulate_circular(out, row, nrows, s, start, length, w, dims, k):
    """Range-add ``w`` to circular intervals [start, start+length) of each
    row's 1D link array, writing into ``out`` ((B,) + machine shape).

    The difference-array contributions are summed with one flat
    ``np.bincount`` over ``row*(s+1)+col`` keys — a contiguous segment
    sum instead of the ``np.add.at`` scatters this used to run, which
    serialise on repeated indices and dominated the routing profile.
    Column ``s`` is the overflow bucket for wrapped intervals (it is
    excluded from the prefix sum).
    """
    m = length > 0
    if not m.any():
        return
    row = row[m]
    start = start[m] % s
    length = length[m]
    ww = w[m]
    base = row * (s + 1)
    end = start + length
    nowrap = end <= s
    wr = ~nowrap
    # non-wrapping part: +w at start, -w at end (s = dump bucket)
    idx = [base + start, base[nowrap] + end[nowrap]]
    val = [ww, -ww[nowrap]]
    if wr.any():
        # wrapping tail [0, end-s): +w at 0, -w at end-s; close the head
        # interval [start, s) in the dump bucket
        idx += [base[wr], base[wr] + end[wr] - s, base[wr] + s]
        val += [ww[wr], -ww[wr], -ww[wr]]
    diff = np.bincount(np.concatenate(idx), weights=np.concatenate(val),
                       minlength=nrows * (s + 1)).reshape(nrows, s + 1)
    lane = np.cumsum(diff[:, :s], axis=1)
    # scatter back into the batched machine-shaped array: axis k of the
    # machine sits at position k+1 of ``out``
    shape_rows = tuple(d for j, d in enumerate(dims) if j != k)
    lane = lane.reshape((len(out),) + shape_rows + (s,))
    out += np.moveaxis(lane, -1, k + 1)


# ---------------------------------------------------------------------------
# Batched candidate evaluation (the mapping pipeline's scoring engine)
# ---------------------------------------------------------------------------

# memory cap on one slice of edited proposal stacks: host memory in the
# refinement passes (hier.refine), device memory in the fused refinement
# (mapping.fused); one slice for every realistic round
STACK_BYTE_BUDGET = 1 << 28


def lex_less(a, b, tol: float = 1e-12) -> bool:
    """Strict lexicographic a < b of two score rows, with a tolerance per
    component (the refinement passes' acceptance test)."""
    for x, y in zip(a, b):
        if x < y - tol:
            return True
        if x > y + tol:
            return False
    return False


SCORE_BACKENDS = ("numpy", "torch", "hopper")


def _hooked(name: str, fn):
    """Wrap an evaluator with its fault-injection site and span.

    Every scoring call — candidate search or direct
    ``evaluate_candidates`` — passes through
    ``faults.fire("score.<name>")`` so injected build failures / device
    OOMs surface exactly where real ones would.
    """
    site = f"score.{name}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # the span wraps the fire too: an injected backend fault shows
        # up in the trace exactly like a real one (error-annotated span)
        with obs.span(site) as sp:
            faults.fire(site)
            out = fn(*args, **kwargs)
            if len(args) >= 4:  # (machine, edges, weights, coord_stack)
                sp.annotate(candidates=int(len(args[3])))
            return out

    return wrapper


@functools.lru_cache(maxsize=None)
def _evaluator(backend: str, device: torch.device):
    if backend == "numpy":
        return _hooked("numpy", evaluate_candidates_numpy)
    if backend == "torch":
        from .metrics_torch import evaluate_candidates_torch
        return _hooked("torch", functools.partial(
            evaluate_candidates_torch, device=device))
    from repro_torch.kernels.mapscore.ops import evaluate_candidates_hopper
    return _hooked("hopper", functools.partial(
        evaluate_candidates_hopper, device=device))


def get_evaluator(backend: str, device="cuda"):
    """Resolve a scoring backend: ``(name, callable)``.

    The callable has :func:`evaluate_candidates`' signature minus
    ``backend`` and ``device``.  There is no fallback: the name given is
    the name that runs, or the call raises — an unknown name, a CUDA
    device the process cannot reach, or ``"hopper"`` (the hand-written
    CUDA kernel of :mod:`repro_torch.kernels.mapscore`) asked to run on
    a CPU device.  ``"numpy"`` is the host reference and ignores where
    ``device`` points; ``"torch"`` runs the plain tensor scorer of
    :mod:`repro_torch.core.metrics_torch` on ``device``.  The callable
    fires the ``score.<name>`` fault-injection site
    (:mod:`repro_torch.faults`) on every call.
    """
    if backend not in SCORE_BACKENDS:
        raise ValueError(f"unknown scoring backend {backend!r}; "
                         f"options: {SCORE_BACKENDS}")
    dev = resolve_device(device)
    if backend == "hopper" and dev.type != "cuda":
        raise ValueError(
            "score backend 'hopper' launches a CUDA kernel and cannot "
            f"run on device {str(device)!r}; use 'torch' or 'numpy' there")
    return backend, _evaluator(backend, dev)


def evaluate_candidates(machine: Machine, task_edges: np.ndarray,
                        edge_weights: np.ndarray | None,
                        coord_stack, *,
                        traffic: bool = False,
                        chunk_elems: int | None = None,
                        backend: str = "hopper",
                        device="cuda") -> dict:
    """Score a stack of candidate mappings in vectorised passes.

    ``coord_stack``: (B, ntasks, ndim) — machine coordinate of every task
    under each of B candidate mappings (a numpy array or, for the
    ``"torch"``/``"hopper"`` backends, a tensor).  Returns a dict of (B,)
    numpy arrays: ``weighted_hops``, ``total_hops``, ``average_hops`` and
    — when ``traffic`` is requested — ``data_max`` / ``latency_max`` from
    the batched dimension-ordered router.  Candidates are processed in
    chunks bounded by ``chunk_elems`` (``None``: the backend's own
    default) so arbitrarily large candidate sets cannot blow up memory.

    ``backend="hopper"`` (default) scores on ``device`` with the CUDA
    kernel; ``"torch"`` with plain tensor operations (the kernel's plain
    version); ``"numpy"`` is the bit-exact host reference.  All agree
    within floating-point tolerance.  See :func:`get_evaluator` for what
    raises.
    """
    _, fn = get_evaluator(backend, device)
    kw = {} if chunk_elems is None else {"chunk_elems": chunk_elems}
    return fn(machine, task_edges, edge_weights, coord_stack,
              traffic=traffic, **kw)


def evaluate_candidates_numpy(machine: Machine, task_edges: np.ndarray,
                              edge_weights: np.ndarray | None,
                              coord_stack: np.ndarray, *,
                              traffic: bool = False,
                              chunk_elems: int = 1 << 24) -> dict:
    """The numpy scoring implementation (the bit-exact reference)."""
    coord_stack = np.asarray(coord_stack)
    nb = len(coord_stack)
    ne = len(task_edges)
    w = np.ones(ne) if edge_weights is None else \
        np.asarray(edge_weights, dtype=np.float64)
    out = {
        "weighted_hops": np.empty(nb),
        "total_hops": np.empty(nb, dtype=np.int64),
        "average_hops": np.empty(nb),
    }
    if traffic:
        out["data_max"] = np.empty(nb)
        out["latency_max"] = np.empty(nb)
    nd = machine.ndim - machine.core_dims
    per_cand = max(ne * machine.ndim, 1)
    if traffic:
        per_cand += 2 * nd * machine.nnodes
    chunk = int(max(1, chunk_elems // per_cand))
    for c0 in range(0, nb, chunk):
        cs = coord_stack[c0:c0 + chunk]
        src = cs[:, task_edges[:, 0]]
        dst = cs[:, task_edges[:, 1]]
        h = pairwise_hops(machine, src, dst)  # (chunk, E)
        sl = slice(c0, c0 + len(cs))
        out["weighted_hops"][sl] = (h * w).sum(axis=-1)
        out["total_hops"][sl] = h.sum(axis=-1)
        out["average_hops"][sl] = h.mean(axis=-1) if ne else 0.0
        if traffic:
            pos, neg = _batched_route(machine, src.astype(np.int64),
                                      dst.astype(np.int64), w)
            b = len(cs)
            data = np.zeros(b)
            lat = np.zeros(b)
            for k in range(nd):
                bw_full = machine.bw_field(k)[None]
                for arr in (pos[k], neg[k]):
                    data = np.maximum(data, arr.reshape(b, -1).max(axis=1))
                    lat = np.maximum(
                        lat, (arr / bw_full).reshape(b, -1).max(axis=1))
            out["data_max"][sl] = data
            out["latency_max"][sl] = lat
    return out


# ---------------------------------------------------------------------------
# Aggregate metrics
# ---------------------------------------------------------------------------

def data_metric(traffic: Traffic) -> float:
    """Data(M) = max over links of Data(e)  (Eqn. 5)."""
    d = traffic.link_data()
    return float(d.max()) if len(d) else 0.0


def latency_metric(traffic: Traffic) -> float:
    """Latency(M) = max over links of Data(e)/bw(e)  (Eqn. 7)."""
    lat = traffic.link_latency()
    return float(lat.max()) if len(lat) else 0.0


def per_dim_stats(traffic: Traffic) -> dict:
    """Per-dimension, per-direction max/mean Data and Latency (Figs 9/12)."""
    out = {}
    m = traffic.machine
    nd = m.ndim - m.core_dims
    for k in range(nd):
        bw_full = m.bw_field(k)
        for sign, arr in (("+", traffic.pos[k]), ("-", traffic.neg[k])):
            key = f"dim{k}{sign}"
            out[key] = {
                "data_max": float(arr.max()),
                "data_mean": float(arr.mean()),
                "lat_max": float((arr / bw_full).max()),
                "lat_mean": float((arr / bw_full).mean()),
            }
    return out


def evaluate_mapping(machine: Machine, task_edges: np.ndarray,
                     edge_weights: np.ndarray | None,
                     task_to_coord: np.ndarray) -> dict:
    """All paper metrics for a mapping.

    task_edges    : (E, 2) task index pairs.
    edge_weights  : (E,) message volumes (None = uniform 1).
    task_to_coord : (ntasks, ndim) machine coordinate of each task.
    """
    src = task_to_coord[task_edges[:, 0]]
    dst = task_to_coord[task_edges[:, 1]]
    if edge_weights is None:
        edge_weights = np.ones(len(task_edges))
    h = pairwise_hops(machine, src, dst)
    traffic = route_traffic(machine, src, dst, edge_weights)
    nz = int(np.count_nonzero(h))
    return {
        "total_hops": int(h.sum()),
        "average_hops": float(h.mean()) if len(h) else 0.0,
        "weighted_hops": float((h * edge_weights).sum()),
        "data_max": data_metric(traffic),
        "latency_max": latency_metric(traffic),
        "num_messages": len(task_edges),
        "num_offnode_messages": nz,
        "per_dim": per_dim_stats(traffic),
    }
