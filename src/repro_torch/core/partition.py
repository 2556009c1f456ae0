"""Level-synchronous vectorised Multi-Jagged partitioning engine.

The reference implementation of paper Algorithm 2
(:func:`repro_torch.core.orderings.order_points_recursive`) recurses part by
part in Python: every one of the ~``2*nparts`` recursion nodes pays a
Python call, a fancy-index gather, an ``argsort`` and a ``cumsum``.  At
Table-1 scale (2^18+ points, thousands of parts) the interpreter
overhead dominates and the partitioner runs orders of magnitude below
NumPy speed.

This module replaces the recursion with *level-synchronous* sweeps that
cut every active part of one recursion level simultaneously.  Two
engines implement the sweep; both return part numbers **bit-identical**
to the recursive reference (cross-checked in tests/test_partition.py):

``_fast_order`` (primary)
    Sorts each coordinate dimension ONCE up front, then maintains, for
    every dimension, a permutation in which each active segment
    (= recursion node) occupies one contiguous, value-sorted block.
    A level then needs no sorting at all: cut positions come from
    segmented weight prefix sums over the presorted blocks, and the
    splits are applied to every dimension's permutation with O(n)
    vectorised *stable partitions* (one cumsum + one scatter per dim).
    Coordinate flips (FZ / FZlow / Gray) are never materialised — a
    flip only negates one dimension of one segment, so it is tracked as
    a per-(segment, dim) sign and handled by walking the presorted
    block from the other end.  Segment extents are sign-invariant
    (``max(s*x) - min(s*x) == max(x) - min(x)`` exactly in IEEE
    arithmetic), so longest-dimension selection reads only the block
    ends of each presorted permutation.

    The one thing presorted permutations cannot reproduce is the
    reference's *evolving* tie order: ``argsort(kind="stable")`` inside
    the recursion breaks equal coordinates by the order the previous
    levels produced, while the presorted blocks keep the original-index
    order.  Tie order is observable only when a tie group straddles a
    cut boundary (the cut then splits equal points by current order) or
    when float weights are summed across a tie group (different
    summation order, different rounding).  Both situations are detected
    exactly — O(#segments) boundary comparisons per level — and the
    engine restarts on the exact fallback below.  Power-of-two grids,
    distinct coordinates (any weights), and every paper benchmark stay
    on the fast path.

``_exact_order`` (fallback)
    One segmented ``np.lexsort`` per level keyed by ``(segment,
    coordinate)`` — the stability-preserving equivalent of the per-part
    stable ``argsort`` — with materialised coordinate flips.  Handles
    arbitrary tie structure; slower than the fast engine but still
    free of per-part Python overhead.

Both engines are *batched over rotation candidates*: the paper's §4.3
rotation search only permutes the cut-dimension priority of the same
point cloud, so B candidates run as B outermost segments of ONE
level-synchronous sweep (:func:`vectorized_order_batched`).  The
per-dimension presorts are computed once and shared by every candidate;
the per-segment tables (sizes, part counts, flip signs, dim priorities)
simply start with B rows instead of one.  A full rotation sweep thus
costs one engine pass instead of B Python-level partitioner calls —
the mapping pipeline's batched candidate sweep relies on this.

Total fast-path work is O(d * n log n) for the initial sorts plus
O(levels * B * n * d) for the sweeps.
"""

from __future__ import annotations

import numpy as np

__all__ = ["vectorized_order", "vectorized_order_batched"]


# Ceiling for the padded per-segment cumsum buffer (entries).  Above it
# weighted cuts fall back to the recursive-equivalent exact path with a
# per-segment loop (huge, pathologically unbalanced inputs only).
_PAD_CAP = 1 << 26


class _TieFallback(Exception):
    """Fast path detected a cut whose result depends on evolving tie
    order (or an oversized weighted buffer); restart on _exact_order."""


def vectorized_order(
    coords: np.ndarray,
    nparts: int,
    sfc: str,
    *,
    weights: np.ndarray | None = None,
    dim_order: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
) -> np.ndarray:
    """Level-synchronous Algorithm 2; same contract as ``order_points``.

    Returns the ``(n,)`` int64 part numbers ``mu``, bit-identical to the
    recursive reference.  ``sfc`` must be one of Z | Gray | FZ | FZlow
    (Hilbert is dispatched before reaching the MJ engine).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    if nparts <= 1 or n == 0:
        return np.zeros(n, dtype=np.int64)
    d = coords.shape[1]
    dimo = (np.arange(d) if dim_order is None
            else np.asarray(dim_order, dtype=np.int64))
    w = None if weights is None else np.asarray(weights, dtype=np.float64)
    try:
        return _fast_order(coords, nparts, sfc, w, dimo[None], longest_dim,
                           uneven_prime)[0]
    except _TieFallback:
        return _exact_order(coords, nparts, sfc, w, dimo[None], longest_dim,
                            uneven_prime)[0]


def vectorized_order_batched(
    coords: np.ndarray,
    nparts: int,
    sfc: str,
    *,
    dim_orders: np.ndarray,
    weights: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
) -> np.ndarray:
    """Cut B rotation candidates of one point cloud in a single sweep.

    ``dim_orders`` is a ``(B, d)`` stack of cut-dimension priority
    permutations; row ``b`` of the returned ``(B, n)`` int64 array is
    bit-identical to ``vectorized_order(coords, ..., dim_order=
    dim_orders[b])`` — which in turn equals the partition of the
    column-permuted cloud ``coords[:, dim_orders[b]]``.  Each candidate
    is one outermost segment of the shared level-synchronous machinery,
    so the whole batch costs one engine pass (shared presorts, one
    segment table) instead of B separate calls.
    """
    coords = np.asarray(coords, dtype=np.float64)
    dim_orders = np.atleast_2d(np.asarray(dim_orders, dtype=np.int64))
    nb = len(dim_orders)
    n = len(coords)
    if nparts <= 1 or n == 0:
        return np.zeros((nb, n), dtype=np.int64)
    w = None if weights is None else np.asarray(weights, dtype=np.float64)
    try:
        return _fast_order(coords, nparts, sfc, w, dim_orders, longest_dim,
                           uneven_prime)
    except _TieFallback:
        return _exact_order(coords, nparts, sfc, w, dim_orders, longest_dim,
                            uneven_prime)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _split_counts_table(values: np.ndarray, uneven_prime: bool):
    """Vectorised mapping nparts -> (npl, npr) through the reference's
    own ``_split_counts`` (largest-prime uneven bisection when
    requested), so the engines can never desync from the oracle."""
    from .orderings import _split_counts
    npl = np.zeros_like(values)
    npr = np.zeros_like(values)
    for v in np.unique(values):
        if v < 2:
            continue
        l, r = _split_counts(int(v), uneven_prime)
        m = values == v
        npl[m] = l
        npr[m] = r
    return npl, npr


def _pick_cut_dims(ext: np.ndarray, sdo: np.ndarray) -> np.ndarray:
    """Longest-dim selection for all segments at once.  Replicates
    ``orderings._longest_dim``: scan each segment's own priority row
    ``sdo[s]``, replacing the best only on a strict ``> best + 1e-12``
    improvement (per-segment rows because batched candidates carry
    different rotation priorities).  One ``take_along_axis`` reorders
    the extents into priority order so the scan runs on plain columns.
    """
    nseg, d = ext.shape
    pri = np.take_along_axis(ext, sdo, axis=1)
    best_p = np.zeros(nseg, dtype=np.int64)
    best_ext = pri[:, 0].copy()
    for p in range(1, d):
        better = pri[:, p] > best_ext + 1e-12
        best_p[better] = p
        best_ext[better] = pri[better, p]
    return np.take_along_axis(sdo, best_p[:, None], axis=1)[:, 0]


def _uniform_cuts(sizes: np.ndarray, ratio: np.ndarray,
                  base: np.ndarray | None = None) -> np.ndarray:
    """Reference cut index for unit weights: ``cw`` of every segment is
    a prefix of [1, 2, 3, ...], so one shared base array serves all
    segments (identical float comparisons to the reference)."""
    maxlen = int(sizes.max())
    if base is None or len(base) < maxlen:
        base = np.arange(1, maxlen + 1, dtype=np.float64)
    targets = sizes.astype(np.float64) * ratio
    k = np.searchsorted(base[:maxlen], targets, side="left") + 1
    return np.minimum(np.maximum(k, 1), sizes - 1)


def _padded_cuts(w_seq: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
                 ratio: np.ndarray, *, on_overflow: str = "raise"
                 ) -> np.ndarray:
    """Reference cut index for per-point weights.

    ``w_seq`` holds the weights in reference visit order, segments
    contiguous at ``starts``/``sizes``.  Row-wise ``np.cumsum`` over a
    padded (nseg, maxlen) buffer performs the exact same sequence of
    float additions as the reference's fresh per-segment ``np.cumsum``,
    keeping the cut placement bit-identical.
    """
    nseg = len(starts)
    maxlen = int(sizes.max())
    if nseg * maxlen > _PAD_CAP:
        if on_overflow == "raise":
            raise _TieFallback
        # exact-engine fallback for pathologically unbalanced inputs: a
        # per-segment loop (still the reference arithmetic)
        k = np.empty(nseg, dtype=np.int64)  # pragma: no cover - huge only
        for i in range(nseg):  # pragma: no cover
            cw = np.cumsum(w_seq[starts[i]:starts[i] + sizes[i]])
            k[i] = np.searchsorted(cw, cw[-1] * ratio[i], side="left") + 1
        return np.minimum(np.maximum(k, 1), sizes - 1)  # pragma: no cover
    pad = np.zeros((nseg, maxlen), dtype=np.float64)
    rows = np.repeat(np.arange(nseg), sizes)
    cols = np.arange(len(w_seq)) - np.repeat(starts, sizes)
    pad[rows, cols] = w_seq
    cw = np.cumsum(pad, axis=1)
    totals = cw[np.arange(nseg), sizes - 1]
    targets = totals * ratio
    in_seg = np.arange(maxlen)[None, :] < sizes[:, None]
    k = ((cw < targets[:, None]) & in_seg).sum(axis=1) + 1
    return np.minimum(np.maximum(k, 1), sizes - 1)


# ---------------------------------------------------------------------------
# fast engine: presorted per-dim permutations + segmented stable partitions
# ---------------------------------------------------------------------------

_IEEE_TOP = np.uint64(0x8000000000000000)
_IEEE_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
_IEEE_63 = np.uint64(63)


def _presort(col: np.ndarray) -> np.ndarray:
    """Value-ascending argsort at quicksort speed (tie order arbitrary).

    Maps the doubles to order-preserving uint64 keys (IEEE total-order
    trick; ``+0.0`` canonicalises ``-0.0`` first) and argsorts those
    with the default introsort.  The fast engine never relies on tie
    ORDER — every cut whose outcome could depend on it is caught by the
    value-based straddle/tie detection and rerouted to the exact engine
    — so the stable-sort repair pass is unnecessary.
    """
    u = (col + 0.0).view(np.uint64)  # owns its buffer: in-place is safe
    m = u >> _IEEE_63
    m *= _IEEE_ONES
    m |= _IEEE_TOP
    u ^= m
    return np.argsort(u)


def _fast_order(coords, nparts, sfc, w, dim_orders, longest_dim,
                uneven_prime):
    npts, d = coords.shape
    if dim_orders is None:
        dim_orders = np.arange(d, dtype=np.int64)[None]
    nb = len(dim_orders)
    N = nb * npts  # total rows: candidate b owns rows [b*npts, (b+1)*npts)
    if N >= 1 << 31:  # int32 row ids bound the batch (no realistic input)
        raise _TieFallback  # pragma: no cover - exact engine handles it
    # (d, npts) coordinate values, SHARED by every candidate block.  Q
    # stores BLOCK-LOCAL point ids (0..npts-1): values, weights and the
    # first-child table are all indexed locally, so every per-point
    # structure a block touches is candidate-sized and cache-resident
    # however many candidates are stacked — the batched sweep pays no
    # working-set blowup over B separate runs, it only saves.
    cols1 = np.ascontiguousarray(coords.T)
    cols1_flat = cols1.reshape(-1)
    offs = np.arange(nb, dtype=np.int32) * npts
    # int32 permutations: the gather/scatter passes over Q dominate the
    # sweep and are memory-bound, so halving the index width ~halves the
    # engine's DRAM traffic (the batched sweep works on nb*n rows)
    Q = np.empty((d, N), dtype=np.int32)
    for j in range(d):
        ps = _presort(cols1[j]).astype(np.int32)  # shared by every block
        Q[j] = np.tile(ps, nb) if nb > 1 else ps
    q_buf = np.empty_like(Q) if d > 1 else Q  # partition double-buffer
    g_loc = np.empty(npts, dtype=bool) if d > 1 else None  # per-block
    loc = np.arange(npts, dtype=np.int32) if d > 1 else None
    pos = None  # built lazily: unused on the pure-1D fast path

    def _positions():
        nonlocal pos
        if pos is None:
            pos = np.arange(N, dtype=np.int64)
        return pos

    cut_base = np.arange(1, npts + 1, dtype=np.float64)
    weighted = w is not None  # w indexed by block-local ids: no tiling

    # segment table (sorted by start; int32 throughout — the table is
    # rebuilt every level and its traffic shows at deep levels);
    # signs[s, j] = net flip of dim j; base[s] = part offset of the
    # segment (mu is scattered once at end); sdo[s] = the segment's
    # cut-dimension priority row (candidates of a batched sweep differ
    # only here; children inherit their parent's row)
    starts = offs.copy()
    sizes = np.full(nb, npts, dtype=np.int32)
    pnum = np.full(nb, nparts, dtype=np.int32)
    base = np.zeros(nb, dtype=np.int32)
    signs = np.ones((nb, d), dtype=np.int8)
    sdo = np.ascontiguousarray(np.asarray(dim_orders, dtype=np.int64))
    level = 0
    # ``pending``: when the final level's split was computed but never
    # applied to the permutation rows, the closing scatter must read
    # each candidate block through that level's cut layout (a block's
    # own cut-dim row splits in place).  None = every row matches the
    # final segment table.
    pending = None

    while True:
        act = (pnum > 1) & (sizes > 1)
        if not act.any():
            break
        nseg = len(starts)
        ends = starts + sizes

        # --- candidate blocks of the segment table ----------------------
        # Each candidate's segments stay inside its contiguous row block
        # [b*npts, (b+1)*npts); per-point work below runs per block, so
        # every pass operates on cache-sized slices however many
        # candidates are stacked.
        if nb == 1:
            seg_b = np.array([0, nseg])
        else:
            seg_b = np.append(np.searchsorted(starts, offs), nseg)

        # --- cut dimension ----------------------------------------------
        # Each block of Q[j] is ascending along dim j, so per-segment
        # extents are just the block-end values; extents are also
        # flip-invariant (max(s*x) - min(s*x) == max(x) - min(x) exactly)
        if d == 1:  # only one dimension to cut
            cut = np.zeros(nseg, dtype=np.int64)
            sgn = signs[:, 0]
        elif longest_dim:
            lo = np.empty((nseg, d))
            hi = np.empty((nseg, d))
            for j in range(d):
                lo[:, j] = cols1[j][Q[j, starts]]
                hi[:, j] = cols1[j][Q[j, ends - 1]]
            cut = _pick_cut_dims(hi - lo, sdo)
            sgn = signs[np.arange(nseg), cut]
        else:
            cut = sdo[:, level % d]  # never mutated: view is fine
            sgn = signs[np.arange(nseg), cut]
        one_dim = d == 1 or (cut[act] == cut[act][0]).all()
        c0 = int(cut[act][0])

        # per-block uniform cut dim over the ACTIVE segments (-1 = no
        # active segment in the block, -2 = mixed cut dims)
        if d > 1:
            blocks = []
            for bi in range(nb):
                s0, s1 = int(seg_b[bi]), int(seg_b[bi + 1])
                a_sl = act[s0:s1]
                if not a_sl.any():
                    u = -1
                else:
                    cb = cut[s0:s1][a_sl]
                    u = int(cb[0]) if (cb == cb[0]).all() else -2
                blocks.append((bi * npts, (bi + 1) * npts, s0, s1, u))

        # --- split counts + cut index k (in reference visit order) ------
        if uneven_prime:
            npl, npr = _split_counts_table(np.where(act, pnum, 0), True)
        else:  # plain bisection: no table walk needed
            npl = np.where(act, pnum >> 1, 0)
            npr = np.where(act, pnum - (pnum >> 1), 0)
        ratio = np.where(act, npl / np.maximum(pnum, 1), 0.0)
        if weighted and not one_dim:
            cut_pt = np.repeat(cut, sizes)
        if not weighted:
            k = _uniform_cuts(sizes, ratio, cut_base).astype(np.int32)
        else:
            # weight sequence in reference order: ascending block for
            # sign +1, descending for sign -1 (no ties on this path)
            start_pt = np.repeat(starts, sizes)
            sgn_pt = np.repeat(sgn, sizes)
            end_pt = np.repeat(ends, sizes)
            p_ = _positions()
            asc = np.where(sgn_pt > 0, p_, start_pt + end_pt - 1 - p_)
            if one_dim:
                w_seq = w[Q[c0, asc]]
            else:
                w_seq = w[Q.reshape(-1)[cut_pt * N + asc]]
            blk = np.repeat(np.arange(nseg), sizes)
            ab = act[blk]
            a_sz = sizes[act]
            k = np.ones(nseg, dtype=np.int32)
            k[act] = _padded_cuts(w_seq[ab], np.cumsum(a_sz) - a_sz, a_sz,
                                  ratio[act])
        # first child block holds kappa points: the reference's left
        # child for sign +1, its right child for sign -1
        kappa = np.where(act, np.where(sgn > 0, k, sizes - k), sizes)

        # --- tie detection ----------------------------------------------
        a = np.flatnonzero(act)
        if weighted:
            # any tie inside an active block reorders the weight cumsum;
            # compare adjacent sorted values per active block
            if one_dim:
                v_blk = cols1[c0][Q[c0]]
            else:
                qg = Q.reshape(-1)[cut_pt * N + _positions()]
                v_blk = cols1_flat[cut_pt * npts + qg]
            same = (blk[1:] == blk[:-1]) & ab[:-1]
            if (same & (v_blk[1:] == v_blk[:-1])).any():
                raise _TieFallback
        else:
            b0 = starts[a] + kappa[a] - 1
            b1 = b0 + 1
            ca = cut[a]
            q0 = Q.reshape(-1)[ca * N + b0]  # block-local point ids
            q1 = Q.reshape(-1)[ca * N + b1]
            if (cols1_flat[ca * npts + q0]
                    == cols1_flat[ca * npts + q1]).any():
                raise _TieFallback

        # --- next level's segment table (mu deferred via base) ----------
        prev_starts, prev_sizes = starts, sizes
        s2 = sizes - kappa  # 0 for inactive segments
        p1 = np.where(act, np.where(sgn > 0, npl, npr), pnum)
        p2 = np.where(sgn > 0, npr, npl)
        # reference: left child keeps base, right child gets base + npl
        b1_ = np.where(act, np.where(sgn > 0, base, base + npl), base)
        b2_ = np.where(sgn > 0, base + npl, base)
        new_starts = np.repeat(starts, 2)
        new_starts[1::2] += kappa
        new_sizes = np.stack([kappa, s2], axis=1).reshape(-1)
        new_pnum = np.stack([p1, p2], axis=1).reshape(-1)
        new_base = np.stack([b1_, b2_], axis=1).reshape(-1)
        new_signs = np.repeat(signs, 2, axis=0)
        new_sdo = np.repeat(sdo, 2, axis=0)
        if sfc in ("Gray", "FZ", "FZlow"):
            # reference-right child = second block for sign +1, first
            # block for sign -1; FZlow flips the reference-LEFT child
            flip_left = sfc == "FZlow"
            child = np.where((sgn > 0) != flip_left, 1, 0)
            rows = (2 * np.arange(nseg) + child)[act]
            if sfc == "Gray":
                new_signs[rows] = -new_signs[rows]
            else:
                new_signs[rows, cut[act]] = -new_signs[rows, cut[act]]
        keep = new_sizes > 0
        if keep.all():  # common case: every active split fills both sides
            starts, sizes, pnum = new_starts, new_sizes, new_pnum
            base, signs, sdo = new_base, new_signs, new_sdo
        else:
            starts = new_starts[keep]
            sizes = new_sizes[keep]
            pnum = new_pnum[keep]
            base = new_base[keep]
            signs = new_signs[keep]
            sdo = new_sdo[keep]
        level += 1

        if not ((pnum > 1) & (sizes > 1)).any():
            if d > 1:
                pending = (blocks, cut, prev_sizes)
            break
        if d == 1:
            continue  # blocks of the only dim split in place

        # --- apply the splits to the other dims' permutations -----------
        # Stable partition per dim, per candidate block: each segment's
        # first-child members move to the front, second-child members to
        # the back, both in block order, so every segment stays
        # value-sorted.  A block's own cut-dim row splits in place (its
        # partition is the identity), so that row is just copied.  The
        # first-child table ``g_loc`` is block-local and reused block to
        # block, so the whole inner loop runs on candidate-sized arrays.
        for r0, r1, s0, s1, u in blocks:
            if u == -1:  # no active segment: rows already match
                q_buf[:, r0:r1] = Q[:, r0:r1]
                continue
            thr = np.repeat(prev_starts[s0:s1] + kappa[s0:s1] - r0,
                            prev_sizes[s0:s1])
            g_sl = loc < thr  # first-child membership by local position
            if u >= 0:
                g_loc[Q[u, r0:r1]] = g_sl
            else:
                cp = np.repeat(cut[s0:s1], prev_sizes[s0:s1])
                flat = cp * N
                flat += np.arange(r0, r1, dtype=np.int64)
                g_loc[Q.reshape(-1)[flat]] = g_sl
            bs = prev_starts[s0:s1] - r0
            szs = prev_sizes[s0:s1]
            kp = kappa[s0:s1]
            # Positions [0, bs) of EVERY row hold the points of the
            # earlier segments (rows share the segment blocks, only the
            # order within differs), so the first-child count before a
            # segment is the row-independent exclusive cumsum of kappa
            # — both destination offsets hoist out of the dim loop:
            # dest_first = T + (start - c_ex);  dest_second = local +
            # (kappa + c_ex) - T, with T the row's first-child prefix.
            c_ex = np.cumsum(kp, dtype=np.int32) - kp
            a_pt = np.repeat(bs - c_ex, szs)
            b_pt = np.repeat(kp + c_ex, szs)
            b_pt += loc
            for j in range(d):
                if u == j:
                    q_buf[j, r0:r1] = Q[j, r0:r1]
                    continue
                Qj = Q[j, r0:r1]
                G = g_loc[Qj]
                T = np.empty(npts, dtype=np.int32)  # exclusive prefix of G
                T[0] = 0
                np.cumsum(G[:-1], dtype=np.int32, out=T[1:])
                d2 = b_pt - T
                T += a_pt
                np.logical_not(G, out=G)
                np.copyto(T, d2, where=G)  # T becomes dest in place
                q_buf[j, r0:r1][T] = Qj
        Q, q_buf = q_buf, Q

    mu = np.empty(N, dtype=np.int32)  # nparts <= npts, N < 2^31
    vals = np.repeat(base.astype(np.int32), sizes)
    if pending is None:  # every row matches the final table
        for bi in range(nb):
            r0 = bi * npts
            mu[r0:r0 + npts][Q[0, r0:r0 + npts]] = vals[r0:r0 + npts]
    else:
        blocks, cut, prev_sizes = pending
        for r0, r1, s0, s1, u in blocks:
            if u == -2:
                cp = np.repeat(cut[s0:s1], prev_sizes[s0:s1])
                flat = cp * N
                flat += np.arange(r0, r1, dtype=np.int64)
                mu[r0:r1][Q.reshape(-1)[flat]] = vals[r0:r1]
            else:  # untouched block or uniform cut: one row matches
                mu[r0:r1][Q[max(u, 0), r0:r1]] = vals[r0:r1]
    return mu.astype(np.int64).reshape(nb, npts)


# ---------------------------------------------------------------------------
# exact engine: one segmented lexsort per level, materialised flips
# ---------------------------------------------------------------------------

def _exact_order(coords, nparts, sfc, w, dim_orders, longest_dim,
                 uneven_prime):
    npts, d = coords.shape
    if dim_orders is None:
        dim_orders = np.arange(d, dtype=np.int64)[None]
    nb = len(dim_orders)
    # candidates flip coordinates independently -> each owns a copy
    coords = np.tile(coords, (nb, 1)) if nb > 1 else coords.copy()
    N = nb * npts
    mu = np.zeros(N, dtype=np.int64)
    weighted = w is not None
    if weighted and nb > 1:
        w = np.tile(w, nb)

    order = np.arange(N)
    starts = np.arange(nb, dtype=np.int64) * npts
    sizes = np.full(nb, npts, dtype=np.int64)
    seg_np = np.full(nb, nparts, dtype=np.int64)
    sdo = np.ascontiguousarray(np.asarray(dim_orders, dtype=np.int64))
    level = 0

    while True:
        active = (seg_np > 1) & (sizes > 1)
        if not active.any():
            break
        a_starts = starts[active]
        a_sizes = sizes[active]
        a_np = seg_np[active]

        # --- cut dimension per active segment ---------------------------
        if longest_dim:
            vals = coords[order]
            hi = np.maximum.reduceat(vals, starts, axis=0)
            lo = np.minimum.reduceat(vals, starts, axis=0)
            cut = _pick_cut_dims(hi - lo, sdo)[active]
        else:
            cut = sdo[active][:, level % d].copy()

        # active-point positions (a union of contiguous blocks of order)
        p_starts = np.cumsum(a_sizes) - a_sizes  # packed per-segment starts
        pos = (np.repeat(a_starts - p_starts, a_sizes)
               + np.arange(int(a_sizes.sum())))
        seg_of = np.repeat(np.arange(len(a_starts)), a_sizes)

        # --- segmented stable sort along each segment's cut dim ---------
        pts = order[pos]
        key = coords[pts, cut[seg_of]]
        perm = np.lexsort((key, seg_of))
        pts = pts[perm]
        order[pos] = pts

        # --- cut placement ----------------------------------------------
        npl, npr = _split_counts_table(a_np, uneven_prime)
        ratio = npl / a_np
        if not weighted:
            k = _uniform_cuts(a_sizes, ratio)
        else:
            k = _padded_cuts(w[pts], p_starts, a_sizes, ratio,
                             on_overflow="loop")

        # --- flips + part-number updates --------------------------------
        in_seg_idx = np.arange(len(pts)) - p_starts[seg_of]
        right = in_seg_idx >= k[seg_of]
        r_pts = pts[right]
        if sfc == "Gray":
            coords[r_pts] = -coords[r_pts]
        elif sfc == "FZ":
            rc = cut[seg_of[right]]
            coords[r_pts, rc] = -coords[r_pts, rc]
        elif sfc == "FZlow":
            l_pts = pts[~right]
            lc = cut[seg_of[~right]]
            coords[l_pts, lc] = -coords[l_pts, lc]
        mu[r_pts] += npl[seg_of[right]]

        # --- next level's segment table ---------------------------------
        # The start-sorted rebuild needs no argsort: children occupy
        # their parent's position (the left child keeps the parent's
        # start, the right child's start is strictly between the parent
        # and its successor), so with ``c_ex`` = exclusive running count
        # of splits, segment i of the old table lands at ``i + c_ex[i]``
        # and active segments' right children at the slot after — an
        # O(nseg) interleave instead of the former concatenate +
        # O(nseg log nseg) ``argsort(starts)`` whose traffic showed at
        # deep part counts.
        nseg = len(starts)
        c_ex = np.cumsum(active) - active
        pos_all = np.arange(nseg) + c_ex
        pos_r = pos_all[active] + 1
        n_out = nseg + int(c_ex[-1] + active[-1])
        k_full = np.zeros(nseg, dtype=k.dtype)
        k_full[active] = k
        npl_full = np.zeros(nseg, dtype=npl.dtype)
        npl_full[active] = npl

        new_starts = np.empty(n_out, dtype=starts.dtype)
        new_starts[pos_all] = starts  # left child keeps the parent start
        new_starts[pos_r] = a_starts + k
        new_sizes = np.empty(n_out, dtype=sizes.dtype)
        new_sizes[pos_all] = np.where(active, k_full, sizes)
        new_sizes[pos_r] = a_sizes - k
        new_np = np.empty(n_out, dtype=seg_np.dtype)
        new_np[pos_all] = np.where(active, npl_full, seg_np)
        new_np[pos_r] = npr
        new_sdo = np.empty((n_out, sdo.shape[1]), dtype=sdo.dtype)
        new_sdo[pos_all] = sdo  # children inherit the parent's row
        new_sdo[pos_r] = sdo[active]
        starts, sizes, seg_np, sdo = new_starts, new_sizes, new_np, new_sdo
        level += 1

    return mu.reshape(nb, npts)
