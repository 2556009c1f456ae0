"""Torch device engine of the level-synchronous Multi-Jagged partitioner.

The counterpart of the reference's device partitioner: the same
``vectorized_order`` / ``vectorized_order_batched`` contract, with the
recursion levels of paper Algorithm 2 run as torch operations on an
explicit ``device``:

- the per-level *segmented stable sort* is a stable sort by the cut
  coordinate followed by a stable sort by segment start, carrying the
  point ids and every coordinate column;
- segment extents (longest-dimension selection) are ``scatter_reduce``
  maxima and minima keyed by segment start;
- cuts are rank comparisons (unit weights) or comparisons against a
  weighted prefix sum taken left to right within each segment by the
  ``segscan`` kernel (:mod:`repro_torch.kernels.segscan`);
- the SFC coordinate flips are masked negations;
- from the first level whose segments all fit one block, an unweighted
  sweep on a CUDA device hands its state to the ``mjfinish`` kernel
  (:mod:`repro_torch.kernels.mjfinish`), which runs every remaining
  level of a segment in one block's shared memory: one launch a side.
  The handoff level is host arithmetic (:func:`finish_level`: an
  unweighted sweep's segment sizes do not depend on the points).

The representation is *positional*: every one of the ``nb * n`` slots
carries its segment's ``(start, size, nparts)``, constant within a
segment, so the within-segment sorts never move the segment table.
Candidate ``b`` owns slots ``[b*n, (b+1)*n)``.  Nothing is compiled, so
nothing is padded, and the level loop runs a count fixed on the host —
the depth of ``nparts``' split tree — instead of reading "any segment
still active" back from the device at every level: a level past the
last split only reorders points inside finished segments, whose part
number is constant, so the result changes no bit.  Between the upload
and the result nothing waits for the device.

Bit-identity with the numpy engines (the ``np.lexsort`` tie order of
``partition._exact_order`` is the oracle) rests on four choices:

- float64 coordinates, cut targets and prefix sums, int64 indices, all
  created with explicit dtypes (torch's default float32 never appears);
- ``+ 0.0`` on the sort key: a radix sort on the GPU orders ``-0.0``
  before ``0.0``, where numpy treats them as equal ties, and the
  FZ/FZlow/Gray flips mint ``-0.0``;
- stable sorts only;
- weighted prefix sums added left to right (``segscan``): a parallel
  ``torch.cumsum`` re-associates them and moves a cut by one ulp.

There are no compile-cache counters (nothing compiles) and no fallback:
an index never outgrows int64, and a failed kernel launch raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.mjfinish import max_tile, mjfinish
from repro_torch.kernels.segscan import segscan

from .orderings import SFC_KINDS, _split_counts, hilbert_bits

__all__ = ["partition", "order_points_batched_torch", "upload", "run",
           "finish_level"]

_I64 = torch.int64
_F64 = torch.float64


# ---------------------------------------------------------------------------
# split-count table (host side)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _split_table(nparts: int, uneven_prime: bool) -> np.ndarray:
    """``tab[v] = npl`` of splitting ``v`` parts, for every v <= nparts
    (0 for v < 2).  Matches ``orderings._split_counts`` exactly; for
    ``uneven_prime`` a smallest-slice sieve supplies largest prime
    factors so Table-scale part counts stay cheap to tabulate."""
    m = int(nparts)
    tab = np.zeros(m + 1, dtype=np.int32)
    if m < 2:
        return tab
    v = np.arange(2, m + 1, dtype=np.int64)
    if not uneven_prime:
        tab[2:] = (v // 2).astype(np.int32)
        return tab
    lpf = np.zeros(m + 1, dtype=np.int64)
    for p in range(2, m + 1):
        if lpf[p] == 0:  # p is prime: overwrite multiples ascending
            lpf[p::p] = p
    p = lpf[2:]
    k = p // 2
    npl = np.where(p <= 2, v // 2, (k * v) // p)
    # cross-check the host rule on a few rows (cheap, catches drift)
    for probe in {2, 3, m, max(2, m - 1)} & set(range(2, m + 1)):
        assert int(npl[probe - 2]) == _split_counts(probe, True)[0]
    tab[2:] = npl.astype(np.int32)
    return tab


@functools.lru_cache(maxsize=64)
def split_depth(nparts: int, uneven_prime: bool) -> int:
    """Levels of ``nparts``' split tree: ``1 + max(depth(npl),
    depth(v - npl))``, 0 for v <= 1 — the most levels any segment of a
    sweep can be split."""
    tab = _split_table(int(nparts), bool(uneven_prime))
    memo = {0: 0, 1: 0}

    def depth(v: int) -> int:
        if v not in memo:
            npl = int(tab[v])
            memo[v] = 1 + max(depth(npl), depth(v - npl))
        return memo[v]

    return depth(int(nparts))


# ---------------------------------------------------------------------------
# inputs on the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepInputs:
    """One batched partition's inputs, uploaded.

    cols : (d, n) float64 — the shared point cloud, one row per dim.
    sdo  : (nb, d) int64 — per-candidate cut-dimension priority rows
           (for ``"H"``: per-candidate column permutations).
    w    : (n,) float64 point weights, or None (unit weights).
    tab  : (nparts + 1,) int64 — npl by current part count.
    """

    cols: torch.Tensor
    sdo: torch.Tensor
    w: torch.Tensor | None
    tab: torch.Tensor
    nparts: int
    sfc: str
    longest_dim: bool
    levels: int
    uneven_prime: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return self.sdo.shape[0], self.cols.shape[1]


def upload(coords, nparts: int, sfc: str, *, dim_orders, weights=None,
           longest_dim: bool = True, uneven_prime: bool = False,
           device="cuda") -> SweepInputs:
    """Check the arguments and copy the inputs of one batched partition
    to ``device`` (a CUDA device the process cannot reach raises)."""
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    dev = resolve_device(device)
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim == 1:
        coords = coords[:, None]
    dim_orders = np.ascontiguousarray(
        np.atleast_2d(np.asarray(dim_orders, dtype=np.int64)))
    n, d = coords.shape
    if dim_orders.shape[1] != d:
        raise ValueError(f"dim_orders rows have {dim_orders.shape[1]} "
                         f"entries for {d}-dimensional points")
    nparts = int(nparts)
    w = None
    if weights is not None:
        w = np.ascontiguousarray(weights, dtype=np.float64)
        if w.shape != (n,):
            raise ValueError(f"weights must be ({n},), got {w.shape}")
        w = torch.from_numpy(w).to(dev)
    tab = _split_table(max(nparts, 0), bool(uneven_prime))
    return SweepInputs(
        cols=torch.from_numpy(np.ascontiguousarray(coords.T)).to(dev),
        sdo=torch.from_numpy(dim_orders).to(dev),
        w=w,
        tab=torch.from_numpy(tab.astype(np.int64)).to(dev),
        nparts=nparts, sfc=sfc,
        longest_dim=bool(longest_dim) or sfc == "H",
        levels=split_depth(max(nparts, 0), bool(uneven_prime)),
        uneven_prime=bool(uneven_prime))


def run(inp: SweepInputs, levels: int | None = None) -> torch.Tensor:
    """The whole batched partition on the inputs' device: (nb, n) int64
    part numbers in original point order.  ``levels`` overrides the
    level count of the Multi-Jagged sweep (a larger count must change
    nothing; the tests check that).  An unweighted Multi-Jagged sweep on
    a CUDA device runs the torch loop down to :func:`finish_level` and
    ``mjfinish`` from there; the open span's ``finish_from`` gets that
    level (-1: no handoff).  Every sweep passes the ``partition.torch``
    fault site, staged or inside the fused sweep."""
    from repro_torch import faults
    faults.fire("partition.torch")
    nb, n = inp.shape
    levels = inp.levels if levels is None else int(levels)
    plan = _finish_plan(inp, levels)
    _note_finish(plan[0])
    if inp.nparts <= 1 or n == 0 or nb == 0:
        return torch.zeros((nb, n), dtype=_I64, device=inp.cols.device)
    if inp.sfc == "H":
        return _hilbert_sweep(inp)
    return _sweep(inp, levels, plan)


# ---------------------------------------------------------------------------
# the Multi-Jagged sweep
# ---------------------------------------------------------------------------

class SweepState(NamedTuple):
    """The positional state of a Multi-Jagged sweep between two levels.

    pts  : (N,) int64 — the slot id of the point at each position.
    cols : (d, N) float64 — coordinates by position, flips applied.
    mu, seg_start, seg_size, seg_np : (N,) int64 — each position's part
           offset, and its segment's first position, length and parts
           (constant within a segment).
    """

    pts: torch.Tensor
    cols: torch.Tensor
    mu: torch.Tensor
    seg_start: torch.Tensor
    seg_size: torch.Tensor
    seg_np: torch.Tensor


def initial_state(inp: SweepInputs) -> SweepState:
    """Level 0's state: one segment a candidate, every point in order."""
    nb, n = inp.shape
    dev = inp.cols.device
    N = nb * n
    pos = torch.arange(N, dtype=_I64, device=dev)
    return SweepState(
        pts=pos,
        cols=inp.cols.repeat(1, nb),       # (d, N), diverges via flips
        mu=torch.zeros(N, dtype=_I64, device=dev),
        seg_start=(pos // n) * n,
        seg_size=torch.full((N,), n, dtype=_I64, device=dev),
        seg_np=torch.full((N,), inp.nparts, dtype=_I64, device=dev))


def mj_levels(st: SweepState, sdo: torch.Tensor, tab: torch.Tensor, *,
              sfc: str, longest_dim: bool, lo: int, hi: int,
              w: torch.Tensor | None = None) -> SweepState:
    """Levels ``lo .. hi - 1`` of the sweep as whole-array torch
    operations.  ``sdo`` (nb, d), ``tab`` and ``w`` (the (N,) weights
    repeated per candidate, or None) are :class:`SweepInputs`' fields;
    ``lo`` is the absolute level number that strict alternation reads."""
    if lo >= hi:
        return st
    pts, cols, mu, seg_start, seg_size, seg_np = st
    d, N = cols.shape
    nb = sdo.shape[0]
    dev = cols.device
    pos = torch.arange(N, dtype=_I64, device=dev)
    sdoN = sdo[:, None, :].expand(nb, N // nb, d).reshape(N, d)  # invariant
    dims_col = torch.arange(d, dtype=_I64, device=dev)[:, None]
    zero = torch.zeros((), dtype=_I64, device=dev)
    neg_inf = torch.full((N,), -np.inf, dtype=_F64, device=dev)
    pos_inf = torch.full((N,), np.inf, dtype=_F64, device=dev)

    for level in range(lo, hi):
        act = (seg_np > 1) & (seg_size > 1)

        # --- cut dimension (host rule: _longest_dim / alternation) -----
        if d == 1:
            cut = torch.zeros(N, dtype=_I64, device=dev)
        elif longest_dim:
            ext = torch.empty((N, d), dtype=_F64, device=dev)
            for j in range(d):
                hi_ = neg_inf.scatter_reduce(0, seg_start, cols[j], "amax")
                lo_ = pos_inf.scatter_reduce(0, seg_start, cols[j], "amin")
                ext[:, j] = (hi_ - lo_)[seg_start]
            pri = ext.gather(1, sdoN)
            best_p = torch.zeros(N, dtype=_I64, device=dev)
            best_e = pri[:, 0]
            for p in range(1, d):
                better = pri[:, p] > best_e + 1e-12
                best_p = torch.where(better, p, best_p)
                best_e = torch.where(better, pri[:, p], best_e)
            cut = sdoN.gather(1, best_p[:, None])[:, 0]
        else:
            cut = sdoN[:, level % d]

        # --- segmented stable sort by the cut coordinate ----------------
        # ``+ 0.0`` turns -0.0 into 0.0 so that the two tie, as in numpy
        ckey = cols.gather(0, cut[None, :])[0] + 0.0
        by_key = torch.sort(ckey, stable=True).indices
        perm = by_key[torch.sort(seg_start[by_key], stable=True).indices]
        pts = pts[perm]
        cols = cols[:, perm]
        # mu / seg_* are constant within segments: the within-segment
        # permutation leaves them correct without riding the sort
        rank = pos - seg_start

        # --- cut placement (host rule: searchsorted on the cumsum) ------
        npl = tab[seg_np]
        ratio = npl.to(_F64) / seg_np.to(_F64)
        if w is None:
            below = (rank + 1).to(_F64) < seg_size.to(_F64) * ratio
        else:
            cw = segscan(w[pts], seg_start, seg_size)
            last = seg_start + seg_size - 1
            below = cw < cw[last] * ratio
        k = torch.zeros(N, dtype=_I64, device=dev).index_add_(
            0, seg_start, below.to(_I64))[seg_start] + 1
        k = torch.minimum(k.clamp(min=1), (seg_size - 1).clamp(min=1))

        # --- flips + part numbers + child segments ----------------------
        right = rank >= k
        ar = act & right
        mu = mu + torch.where(ar, npl, zero)
        if sfc == "Gray":
            cols = torch.where(ar[None, :], -cols, cols)
        elif sfc == "FZ":
            oh = (dims_col == cut[None, :]) & ar[None, :]
            cols = torch.where(oh, -cols, cols)
        elif sfc == "FZlow":
            oh = (dims_col == cut[None, :]) & (act & ~right)[None, :]
            cols = torch.where(oh, -cols, cols)
        seg_np = torch.where(act, torch.where(right, seg_np - npl, npl),
                             seg_np)
        seg_start = torch.where(ar, seg_start + k, seg_start)
        seg_size = torch.where(act, torch.where(right, seg_size - k, k),
                               seg_size)
    return SweepState(pts, cols, mu, seg_start, seg_size, seg_np)


def part_numbers(st: SweepState, nb: int) -> torch.Tensor:
    """The (nb, n) part numbers in point order: ``mu`` put back by
    ``pts``."""
    N = st.pts.numel()
    out = torch.empty(N, dtype=_I64, device=st.pts.device).scatter_(
        0, st.pts, st.mu)
    return out.view(nb, N // nb)


def _sweep(inp: SweepInputs, levels: int, plan: tuple) -> torch.Tensor:
    """The torch loop for levels ``0 .. l0 - 1``, then ``mjfinish`` for
    the rest, as ``plan = (l0, heads, cap)`` (:func:`_finish_plan`) says;
    ``l0 = -1``: the loop for every level."""
    nb, n = inp.shape
    l0, heads, cap = plan
    st = initial_state(inp)
    kw = dict(sfc=inp.sfc, longest_dim=inp.longest_dim)
    if l0 < 0:
        w = inp.w.repeat(nb) if inp.w is not None else None
        st = mj_levels(st, inp.sdo, inp.tab, lo=0, hi=levels, w=w, **kw)
        return part_numbers(st, nb)
    st = mj_levels(st, inp.sdo, inp.tab, lo=0, hi=l0, **kw)
    return mjfinish(*st, inp.sdo, inp.tab, heads, level=l0, levels=levels,
                    cap=cap, **kw)


# ---------------------------------------------------------------------------
# where mjfinish takes over (host side)
# ---------------------------------------------------------------------------

_NO_HANDOFF = (-1, None, 0)


def _unweighted_segments(n: int, nparts: int, uneven_prime: bool):
    """One candidate's segments at each level of an unweighted sweep,
    level 0 first, until none is live: (sizes, parts, live) in position
    order.  Without weights the cut is the loop's rank rule alone,
    ``#{r : (r + 1) < size * (npl / np)}``, whose count is
    ``ceil(size * (npl / np)) - 1`` clamped to ``[0, size]`` (the same
    float64 operations), so the sizes do not depend on the points."""
    tab = _split_table(nparts, uneven_prime).astype(np.int64)
    size = np.array([n], dtype=np.int64)
    parts = np.array([nparts], dtype=np.int64)
    while True:
        live = (parts > 1) & (size > 1)
        yield size, parts, live
        if not live.any():
            return
        npl = tab[parts]
        x = size.astype(np.float64) * (npl.astype(np.float64)
                                       / parts.astype(np.float64))
        below = np.clip(np.ceil(x) - 1.0, 0.0, size).astype(np.int64)
        k = np.minimum(np.maximum(below + 1, 1), np.maximum(size - 1, 1))
        # a live segment becomes (k, npl) then (size - k, np - npl)
        at = np.cumsum(1 + live) - (1 + live)
        new_size = np.empty(len(size) + int(live.sum()), dtype=np.int64)
        new_parts = np.empty_like(new_size)
        new_size[at] = np.where(live, k, size)
        new_parts[at] = np.where(live, npl, parts)
        new_size[at[live] + 1] = (size - k)[live]
        new_parts[at[live] + 1] = (parts - npl)[live]
        size, parts = new_size, new_parts


@functools.lru_cache(maxsize=64)
def _handoff_plan(n: int, nparts: int, uneven_prime: bool, d: int,
                  levels: int, device: str
                  ) -> tuple[int, torch.Tensor | None, int]:
    """Where ``mjfinish`` takes over an unweighted sweep of ``levels``
    levels of ``n`` ``d``-dimensional points into ``nparts`` parts, from
    one walk of :func:`_unweighted_segments`: ``(l0, heads, cap)``, with
    ``l0`` the first level whose live segments all fit one block,
    ``heads`` the first position, within one candidate, of every segment
    at ``l0`` (on ``device``, uploaded once, from pinned memory so that
    the copy waits for nothing) and ``cap`` the power of two that holds
    the largest live one; ``(-1, None, 0)`` when no level below
    ``levels`` fits.  Host arithmetic, nothing read from a device."""
    tile = max_tile(d)
    if tile == 0 or n == 0 or not 1 < nparts < 2 ** 31:
        return _NO_HANDOFF
    for level, (size, _, live) in zip(
            range(levels), _unweighted_segments(n, nparts, uneven_prime)):
        largest = int(size[live].max()) if live.any() else 1
        if largest > tile:
            continue
        heads = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(size)[:-1]]).astype(np.int64))
        if torch.device(device).type == "cuda":
            heads = heads.pin_memory().to(device, non_blocking=True)
        cap = max(2, 1 << (largest - 1).bit_length())
        return level, heads.to(device), cap
    return _NO_HANDOFF


def _finish_plan(inp: SweepInputs, levels: int
                 ) -> tuple[int, torch.Tensor | None, int]:
    """The :func:`_handoff_plan` of the sweep ``inp`` when it is
    unweighted, Multi-Jagged and on a CUDA device; ``(-1, None, 0)``
    (the loop runs every level) otherwise."""
    nb, n = inp.shape
    if (inp.w is not None or inp.sfc == "H" or nb == 0
            or inp.cols.device.type != "cuda"):
        return _NO_HANDOFF
    return _handoff_plan(n, inp.nparts, inp.uneven_prime,
                         inp.cols.shape[0], levels, str(inp.cols.device))


def finish_level(inp: SweepInputs, levels: int) -> int:
    """The level from which ``mjfinish`` finishes the sweep ``inp`` of
    ``levels`` levels, or -1 when the torch loop runs every level."""
    return _finish_plan(inp, levels)[0]


def _note_finish(l0: int) -> None:
    """Append the sweep's handoff level to the open span's
    ``finish_from`` (one entry a sweep, in call order)."""
    sp = obs.current_span()
    if sp is not None:
        sp.annotate(finish_from=[*sp.attrs.get("finish_from", ()), l0])


# ---------------------------------------------------------------------------
# the Hilbert sweep
# ---------------------------------------------------------------------------

def hilbert_quantise(cols: torch.Tensor, bits: int) -> torch.Tensor:
    """(d, n) coordinates onto the 2^bits-per-side grid, (d, n) int64, per
    dimension (host rule: ``orderings._hilbert_quantise``)."""
    side = 1 << bits
    lo = cols.amin(dim=1)
    span = cols.amax(dim=1) - lo
    span = torch.where(span > 0, span, torch.ones_like(span))
    q = ((cols - lo[:, None]) / span[:, None] * (side - 1)).round()
    return q.to(_I64).clamp(0, side - 1)


def hilbert_transform(X: list, bits: int) -> torch.Tensor:
    """The Hilbert index of quantised points given as ``d`` int64 tensors
    of one shape, one a dimension (Skilling's transpose algorithm, host
    rule: ``orderings.hilbert_index``, op for op).  Rebinds the entries of
    ``X``; writes into no tensor."""
    d = len(X)
    if d == 1:
        return X[0]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:  # inverse undo excess work
        P = Q - 1
        for i in range(d):
            has = (X[i] & Q) != 0
            X[0] = torch.where(has, X[0] ^ P, X[0])
            t = torch.where(has, 0, (X[0] ^ X[i]) & P)
            X[0] = X[0] ^ t
            X[i] = X[i] ^ t
        Q >>= 1
    for i in range(1, d):  # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(d):
        X[i] = X[i] ^ t
    h = torch.zeros_like(X[0])
    for i in range(d):  # interleave: bit b of dim i -> b*d + (d-1-i)
        for b in range(bits):
            h = h | (((X[i] >> b) & 1) << (b * d + (d - 1 - i)))
    return h


def _hilbert_sweep(inp: SweepInputs) -> torch.Tensor:
    """Batched Hilbert numbering (Skilling's transpose algorithm,
    mirroring ``orderings.hilbert_index`` / ``orderings._hilbert_split``
    op for op).  Quantisation is per dimension, so it commutes with the
    candidates' column permutations and runs once; candidate ``b`` is
    bit-identical to ``order_points(coords[:, dim_orders[b]], nparts,
    "H")``."""
    nb, n = inp.shape
    d = inp.cols.shape[0]
    dev = inp.cols.device
    bits = hilbert_bits(n, d)
    q = hilbert_quantise(inp.cols, bits)                  # (d, n)
    # --- fold the dim-order: X[i] = q[sdo[b, i]] per candidate ---------
    X = [q.index_select(0, inp.sdo[:, i]) for i in range(d)]   # (nb, n)
    h = hilbert_transform(X, bits)
    # --- stable sort per candidate + split (host rule: _hilbert_split) -
    order = torch.sort(h, dim=1, stable=True).indices     # (nb, n)
    rank = torch.arange(n, dtype=_I64, device=dev)
    npart = inp.nparts
    if inp.w is None:
        # closed form of searchsorted((arange(1,np)*n)//np, j, "right")
        part = (((rank + 1) * npart - 1) // n).clamp(max=npart - 1)
        part = part.expand(nb, n)
    else:
        w_srt = inp.w[order]                                 # (nb, n)
        starts = (torch.arange(nb * n, dtype=_I64, device=dev) // n) * n
        incl = segscan(w_srt.reshape(-1), starts,
                       torch.full((nb * n,), n, dtype=_I64, device=dev)
                       ).view(nb, n)
        cwx = incl - w_srt  # EXCLUSIVE prefix, like cumsum(w) - w
        w_last = w_srt[:, -1:]
        # total = cw[-1] + w[-1] with cw[-1] = incl[-1] - w[-1]: the
        # host's exact association (NOT plain incl[-1])
        total = (incl[:, -1:] - w_last) + w_last
        part = (cwx / total * float(npart)).to(_I64).clamp(max=npart - 1)
    return torch.empty((nb, n), dtype=_I64, device=dev).scatter_(
        1, order, part)


# ---------------------------------------------------------------------------
# host entry points (the orderings-module backend contract)
# ---------------------------------------------------------------------------

def partition(
    coords: np.ndarray,
    nparts: int,
    sfc: str,
    *,
    dim_orders: np.ndarray,
    weights: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
    device="cuda",
) -> torch.Tensor:
    """:func:`upload` then :func:`run` as one traced, fault-injectable
    device span (``partition.torch``): the (B, n) int64 part numbers,
    left on ``device``."""
    with obs.span("partition.torch", points=len(coords), nparts=int(nparts),
                  batch=len(dim_orders), device=device):
        return run(upload(coords, nparts, sfc, dim_orders=dim_orders,
                          weights=weights, longest_dim=longest_dim,
                          uneven_prime=uneven_prime, device=device))


def order_points_batched_torch(coords: np.ndarray, nparts: int, sfc: str,
                               **kw) -> np.ndarray:
    """Device implementation of ``vectorized_order_batched`` (same
    contract, numpy in, (B, n) int64 numpy out; bit-identical, asserted
    in tests/test_torch_partition_device.py): :func:`partition`, copied
    back to the host."""
    return partition(coords, nparts, sfc, **kw).cpu().numpy()
