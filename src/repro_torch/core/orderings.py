"""Space-filling-curve part numberings (paper Alg. 2 + Appendix A).

The paper's Multi-Jagged partitioner assigns part numbers to the parts it
creates.  The *ordering* of those part numbers determines which task part is
matched with which processor part, and is the paper's headline algorithmic
contribution:

- ``Z``     : Morton order — lower part numbers below each cut (no flips).
- ``Gray``  : flip *all* coordinates of the high half after each bisection.
- ``FZ``    : Flipped-Z — flip only the *cut dimension* of the high half.
- ``FZlow`` : the MFZ companion — flip the cut dimension of the *low* half.
              (MFZ = number one side with FZ and the other with FZlow; used
              when ``pd mod td == 0``, see :mod:`repro_torch.core.mapping`.)
- ``H``     : Hilbert order (Skilling's transpose algorithm, any dimension).

Three implementations are provided:

``order_points``            — generic Algorithm 2 on arbitrary coordinates.
                              Dispatches to the level-synchronous
                              vectorised engine
                              (:mod:`repro_torch.core.partition`)
                              by default; ``backend="recursive"`` selects
                              the original per-part Python recursion, kept
                              as the cross-check oracle.
``grid_order`` / fast paths — closed-form bit-twiddling for structured
                              2^k-per-side grids (used by the Table-1
                              benchmark at up to 2^20 points).  The generic
                              and closed-form paths are cross-checked in
                              tests/test_orderings.py.

The two generic backends return bit-identical part numbers (the
equivalence suite in tests/test_partition.py asserts this across random
point sets, weights, ``uneven_prime`` and every SFC kind); the vectorised
engine is the default because it removes the Python-per-part overhead.
"""

from __future__ import annotations

import numpy as np

SFC_KINDS = ("Z", "Gray", "FZ", "FZlow", "H")
BACKENDS = ("vectorized", "recursive")

# Partition engines (the pipeline-level knob).  Only the host engine is
# part of this package so far; the device partitioner arrives with a
# later slice of the port, and asking for it raises rather than running
# the host engine under its name.
PARTITION_BACKENDS = ("numpy",)


def resolve_partition_backend(backend: str) -> str:
    """Check a partition-backend request; returns the name that runs.

    There is no fallback chain: ``"numpy"`` (the vectorized host engine)
    is the only engine this package has, and any other name raises.
    """
    if backend not in PARTITION_BACKENDS:
        raise ValueError(
            f"unknown partition backend {backend!r}; options: "
            f"{PARTITION_BACKENDS} (the device partitioner belongs to a "
            "later slice of the PyTorch port)")
    return backend


# ---------------------------------------------------------------------------
# Generic Algorithm 2: recursive bisection with coordinate flips.
# ---------------------------------------------------------------------------

def _longest_dim(coords: np.ndarray, dim_order: np.ndarray | None) -> int:
    """Pick the cut dimension: largest extent, ties broken by ``dim_order``.

    ``dim_order`` is a permutation of the dimensions giving tie-break
    priority (the rotation-search in mapping.py permutes it).
    """
    ext = coords.max(axis=0) - coords.min(axis=0)
    if dim_order is None:
        dim_order = np.arange(coords.shape[1])
    # argmax over ext in priority order
    best = dim_order[0]
    for d in dim_order:
        if ext[d] > ext[best] + 1e-12:
            best = d
    return int(best)


def order_points(
    coords: np.ndarray,
    nparts: int,
    sfc: str = "FZ",
    *,
    weights: np.ndarray | None = None,
    dim_order: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
    backend: str = "vectorized",
) -> np.ndarray:
    """Paper Algorithm 2: assign part numbers ``mu`` to ``coords``.

    Parameters
    ----------
    coords : (n, d) float array.  Not modified (we copy; the algorithm flips
        coordinates in place as it recurses).
    nparts : target number of parts.  Need not be a power of two when
        ``uneven_prime`` (Z2_2's largest-prime-divisor bisection) is on.
    sfc : one of ``Z | Gray | FZ | FZlow | H``.
    weights : optional per-point weights; cuts balance total weight.
    dim_order : tie-break priority permutation for the cut dimension.
    longest_dim : if False, strictly alternate dimensions per recursion
        level (the paper's earlier [21] behaviour).
    uneven_prime : Z2_2 — split ``nparts`` by its largest prime divisor
        (3/5 vs 2/5 for p=5) instead of requiring powers of two.
    backend : ``"vectorized"`` (level-synchronous engine, default) or
        ``"recursive"`` (the original reference recursion).  Both
        return bit-identical part numbers.

    Returns
    -------
    mu : (n,) int64 part numbers in ``[0, nparts)``.
    """
    coords = np.asarray(coords, dtype=np.float64)
    if sfc == "H":
        return _hilbert_order_points(coords.copy(), nparts, weights=weights)
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "recursive":
        return order_points_recursive(
            coords, nparts, sfc, weights=weights, dim_order=dim_order,
            longest_dim=longest_dim, uneven_prime=uneven_prime)
    from .partition import vectorized_order
    return vectorized_order(
        coords, nparts, sfc, weights=weights, dim_order=dim_order,
        longest_dim=longest_dim, uneven_prime=uneven_prime)


def order_points_batched(
    coords: np.ndarray,
    nparts: int,
    sfc: str = "FZ",
    *,
    dim_orders: np.ndarray,
    weights: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
    backend: str = "vectorized",
) -> np.ndarray:
    """Paper Algorithm 2 for a whole stack of dimension rotations at once.

    The §4.3 rotation search evaluates many column permutations of the
    SAME point cloud.  Permuting columns only changes which dimension
    the cut-selection rule prefers — the cut values, weights and flips
    are untouched — so rotation ``perm`` is exactly ``order_points(
    coords, ..., dim_order=perm)``.  This entry point exploits that:
    all B rotations run as outermost segments of ONE level-synchronous
    engine pass (shared per-dimension presorts, one segment table),
    instead of B Python-level ``order_points`` calls.

    Parameters
    ----------
    coords : (n, d) float array, shared by every candidate.
    nparts : target number of parts (same contract as ``order_points``).
    sfc : one of ``Z | Gray | FZ | FZlow | H``.
    dim_orders : (B, d) int array; row ``b`` is candidate ``b``'s
        cut-dimension priority permutation (the rotation itself).  For
        ``"H"`` there is no cut priority — the Hilbert index depends on
        the column order itself — so each row acts as a COLUMN
        permutation of the cloud instead: row ``b`` equals
        ``order_points(coords[:, dim_orders[b]], nparts, "H")``, which
        is exactly what the rotation sweep's per-candidate
        ``apply_permutation`` + ``order_points`` pair computes.
    weights, longest_dim, uneven_prime : as in ``order_points``.
    backend : ``"vectorized"`` runs the single batched engine pass (for
        ``"H"`` a per-candidate Hilbert-index loop over ONE memoised
        quantisation); ``"recursive"`` loops the reference
        per-candidate oracle (slow, kept for equivalence tests).

    Returns
    -------
    mu : (B, n) int64 part numbers.  Row ``b`` is bit-identical to both
        ``order_points(coords, nparts, sfc, dim_order=dim_orders[b])``
        and ``order_points(coords[:, dim_orders[b]], nparts, sfc)``
        (asserted in tests/test_batched.py; for ``"H"`` only the
        latter identity holds — see ``dim_orders`` above).
    """
    coords = np.asarray(coords, dtype=np.float64)
    dim_orders = np.atleast_2d(np.asarray(dim_orders, dtype=np.int64))
    if sfc == "H":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "recursive":
            # the per-candidate oracle: quantise per permuted cloud
            return np.stack([
                _hilbert_order_points(coords[:, do].copy(), nparts,
                                      weights=weights)
                for do in dim_orders])
        return _hilbert_order_batched(coords, nparts, dim_orders,
                                      weights=weights)
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "recursive":
        return np.stack([
            order_points_recursive(
                coords, nparts, sfc, weights=weights, dim_order=do,
                longest_dim=longest_dim, uneven_prime=uneven_prime)
            for do in dim_orders])
    from .partition import vectorized_order_batched
    return vectorized_order_batched(
        coords, nparts, sfc, dim_orders=dim_orders, weights=weights,
        longest_dim=longest_dim, uneven_prime=uneven_prime)


def order_points_recursive(
    coords: np.ndarray,
    nparts: int,
    sfc: str = "FZ",
    *,
    weights: np.ndarray | None = None,
    dim_order: np.ndarray | None = None,
    longest_dim: bool = True,
    uneven_prime: bool = False,
) -> np.ndarray:
    """The original per-part recursion (paper Alg. 2), kept as the
    cross-check oracle for the vectorised engine."""
    coords = np.asarray(coords, dtype=np.float64).copy()
    n, d = coords.shape
    if sfc == "H":
        return _hilbert_order_points(coords, nparts, weights=weights)
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    if weights is None:
        weights = np.ones(n, dtype=np.float64)
    else:
        weights = np.asarray(weights, dtype=np.float64)
    mu = np.zeros(n, dtype=np.int64)
    idx = np.arange(n)
    _mj_helper(
        coords, idx, weights, nparts, sfc, mu,
        dim_order=dim_order,
        longest=longest_dim,
        level=0,
        uneven_prime=uneven_prime,
    )
    return mu


def _split_counts(nparts: int, uneven_prime: bool) -> tuple[int, int]:
    """How many parts go left/right of the bisection cut.

    Z2_2 (uneven_prime): split by the largest prime divisor p — e.g.
    10800 = 2^4*3^3*5^2 splits 2/5 vs 3/5 (the paper's example), so node
    boundaries are respected high in the hierarchy.  Power-of-two counts
    reduce to plain bisection.
    """
    if not uneven_prime:
        return nparts // 2, nparts - nparts // 2
    p = _largest_prime_factor(nparts)
    if p <= 2:
        return nparts // 2, nparts - nparts // 2
    k = p // 2
    return (k * nparts) // p, nparts - (k * nparts) // p


def _largest_prime_factor(x: int) -> int:
    best = 1
    n = x
    f = 2
    while f * f <= n:
        while n % f == 0:
            best = max(best, f)
            n //= f
        f += 1
    if n > 1:
        best = max(best, n)
    return best


def _mj_helper(coords, idx, weights, nparts, sfc, mu, *, dim_order, longest,
               level, uneven_prime):
    if nparts <= 1 or len(idx) == 0:
        return
    d = coords.shape[1]
    if longest:
        cut_dim = _longest_dim(coords[idx], dim_order)
    else:
        order = dim_order if dim_order is not None else np.arange(d)
        cut_dim = int(order[level % d])

    npl, npr = _split_counts(nparts, uneven_prime)
    # 1D partition: cut so the left side holds npl/nparts of the weight.
    sub = idx[np.argsort(coords[idx, cut_dim], kind="stable")]
    cw = np.cumsum(weights[sub])
    total = cw[-1]
    target = total * (npl / nparts)
    # number of points on the left = first index where cumweight >= target
    k = int(np.searchsorted(cw, target, side="left")) + 1
    k = min(max(k, 1), len(sub) - 1) if len(sub) > 1 else 0
    if len(sub) <= 1:
        # fewer points than parts: everything stays in part 0 of this range
        return
    left, right = sub[:k], sub[k:]

    if sfc == "Gray":
        coords[right] = -coords[right]
    elif sfc == "FZ":
        coords[right, cut_dim] = -coords[right, cut_dim]
    elif sfc == "FZlow":
        coords[left, cut_dim] = -coords[left, cut_dim]
    mu[right] += npl

    _mj_helper(coords, left, weights, npl, sfc, mu, dim_order=dim_order,
               longest=longest, level=level + 1, uneven_prime=uneven_prime)
    _mj_helper(coords, right, weights, npr, sfc, mu, dim_order=dim_order,
               longest=longest, level=level + 1, uneven_prime=uneven_prime)


# ---------------------------------------------------------------------------
# Closed-form grid orderings (power-of-two sides, equal extents).
#
# On an equal-sided grid the longest-dimension rule visits dimensions
# cyclically (0, 1, .., d-1, 0, ..), so part numbers have the structure
# analysed in Appendix A: the bits of dimension i land at bit positions
# ``cuts_i = [i, i+d, i+2d, ...]`` (0-based from the *least* significant
# cut).  Z interleaves plain binary per-dim indices; FZ interleaves
# Gray-coded per-dim indices (Appendix A.2); FZlow interleaves
# reflected-Gray-coded indices.  Cross-checked against order_points.
# ---------------------------------------------------------------------------

def gray_encode(x: np.ndarray) -> np.ndarray:
    return x ^ (x >> 1)


def gray_decode(g: np.ndarray) -> np.ndarray:
    x = np.asarray(g).copy()
    s = 1
    while True:
        shifted = x >> s
        if not shifted.any():
            break
        x = x ^ shifted
        s *= 2
    return x


def _fzlow_encode(x: np.ndarray, bits: int) -> np.ndarray:
    """Per-dimension index ordering induced by FZlow on 2^bits points.

    Derived by running Algorithm 2 with the flip on the *low* half: the
    resulting sequence is the reflection-complement of the Gray sequence.
    Computed by simulation once and memoised (bits is small).
    """
    table = _fzlow_table(bits)
    return table[x]


_FZLOW_CACHE: dict[int, np.ndarray] = {}


def _fzlow_table(bits: int) -> np.ndarray:
    if bits in _FZLOW_CACHE:
        return _FZLOW_CACHE[bits]
    n = 1 << bits
    coords = np.arange(n, dtype=np.float64)[:, None]
    mu = order_points(coords, n, "FZlow")
    _FZLOW_CACHE[bits] = mu.astype(np.int64)
    return _FZLOW_CACHE[bits]


def grid_order(shape: tuple[int, ...], sfc: str) -> np.ndarray:
    """Part number for every cell of a structured grid.

    ``shape`` must be power-of-two per side with equal sides (the Table-1
    setting).  Returns an int64 array of ``shape`` giving each cell's part
    number under the requested ordering, matching ``order_points`` on the
    grid's cell-centre coordinates.
    """
    d = len(shape)
    side = shape[0]
    if any(s != side for s in shape):
        raise ValueError("grid_order requires equal sides")
    bits = int(side).bit_length() - 1
    if (1 << bits) != side:
        raise ValueError("grid_order requires power-of-two sides")

    ix = np.indices(shape)  # (d, *shape)
    if sfc == "Z":
        per_dim = ix
    elif sfc == "FZ":
        per_dim = gray_encode(ix)
    elif sfc == "FZlow":
        tab = _fzlow_table(bits)
        per_dim = tab[ix]
    elif sfc == "H":
        return _hilbert_grid(shape, bits)
    elif sfc == "Gray":
        # No independent per-dim structure; fall back to the generic path.
        coords = np.stack([c.ravel() for c in ix], axis=1).astype(np.float64)
        mu = order_points(coords, side ** d, "Gray")
        return mu.reshape(shape)
    else:
        raise ValueError(f"unknown sfc {sfc!r}")

    # Interleave bits: cut with reverse-index j (0 = last/least significant)
    # along dimension i takes bit (j) of per_dim[i] into part-number bit
    # position i + d*j ... but numbered from the most significant cut first:
    # the FIRST cut is along dim 0 and is the most significant bit.
    # Equivalently: part = sum over dims i, bits j of
    #   bit_j(per_dim[i]) << (j*d + (d-1-i)).
    part = np.zeros(shape, dtype=np.int64)
    for i in range(d):
        v = per_dim[i].astype(np.int64)
        for j in range(bits):
            bit = (v >> j) & 1
            part |= bit << (j * d + (d - 1 - i))
    return part


# ---------------------------------------------------------------------------
# Hilbert (Skilling's transpose algorithm), vectorised, any dimension.
# ---------------------------------------------------------------------------

def hilbert_index(X: np.ndarray, bits: int) -> np.ndarray:
    """Hilbert index of integer points ``X`` (n, d) with ``bits`` per dim."""
    X = np.asarray(X, dtype=np.int64).copy()
    n, d = X.shape
    if d == 1:
        return X[:, 0].copy()
    M = np.int64(1) << (bits - 1)
    # Inverse undo excess work
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(d):
            has = (X[:, i] & Q) != 0
            # if bit set: invert low bits of X[0]
            X[:, 0] = np.where(has, X[:, 0] ^ P, X[:, 0])
            # else: exchange low bits of X[0] and X[i]
            t = np.where(has, 0, (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= 1
    # Gray encode
    for i in range(1, d):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(n, dtype=np.int64)
    Q = M
    while Q > 1:
        has = (X[:, d - 1] & Q) != 0
        t = np.where(has, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(d):
        X[:, i] ^= t
    # Interleave transposed bits into a single index: bit b of dim i goes to
    # position b*d + (d-1-i).
    out = np.zeros(n, dtype=np.int64)
    for i in range(d):
        for b in range(bits):
            bit = (X[:, i] >> b) & 1
            out |= bit << (b * d + (d - 1 - i))
    return out


def _hilbert_grid(shape: tuple[int, ...], bits: int) -> np.ndarray:
    ix = np.indices(shape)
    pts = np.stack([c.ravel() for c in ix], axis=1)
    h = hilbert_index(pts, bits)
    # ranks = part numbers (h is a permutation of 0..n-1 for full grids)
    return h.reshape(shape)


def hilbert_bits(n: int, d: int) -> int:
    """Default Hilbert quantisation resolution (bits per dimension).

    Enough bits to separate ~n points per dimension, capped so the
    interleaved index fits int64.  One definition for every engine
    that quantises — they MUST agree for bit-identity.
    """
    return max(1, min(62 // max(d, 1),
                      int(np.ceil(np.log2(max(n, 2)) / max(d, 1))) + 2))


def _hilbert_quantise(coords: np.ndarray, bits: int) -> np.ndarray:
    """Quantise float points onto the 2^bits-per-side Hilbert grid."""
    side = 1 << bits
    lo = coords.min(axis=0)
    span = coords.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    return np.clip(((coords - lo) / span * (side - 1))
                   .round().astype(np.int64), 0, side - 1)


def hilbert_key(coords: np.ndarray, bits: int | None = None) -> np.ndarray:
    """Hilbert index of arbitrary float points (quantised to a grid).

    Default resolution: :func:`hilbert_bits`.  Shared by the generic
    Hilbert part numbering below and the hierarchical subsystem's
    intra-node task ordering (:mod:`repro_torch.hier.refine`).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n, d = coords.shape
    if bits is None:
        bits = hilbert_bits(n, d)
    return hilbert_index(_hilbert_quantise(coords, bits), bits)


def _hilbert_split(h: np.ndarray, nparts: int,
                   weights: np.ndarray | None) -> np.ndarray:
    """Part numbers from Hilbert indices: stable-sort, split the run."""
    n = len(h)
    order = np.argsort(h, kind="stable")
    mu = np.zeros(n, dtype=np.int64)
    if weights is None:
        # equal-count split
        bounds = (np.arange(1, nparts) * n) // nparts
        mu[order] = np.searchsorted(bounds, np.arange(n), side="right")
    else:
        # weight-proportional split on the EXCLUSIVE prefix (the weight
        # strictly before each point): part = floor(prefix/total *
        # nparts).  The old inclusive cumsum shifted every boundary by
        # one point — part 0 was always empty and the last part doubled
        # (equal weights with n == nparts were not even a permutation).
        w = np.asarray(weights, dtype=np.float64)[order]
        cw = np.cumsum(w) - w
        total = cw[-1] + w[-1]
        mu[order] = np.minimum((cw / total * nparts).astype(np.int64),
                               nparts - 1)
    return mu


def _hilbert_order_points(coords: np.ndarray, nparts: int,
                          weights: np.ndarray | None) -> np.ndarray:
    """Hilbert ordering for arbitrary point sets: quantise to a grid,
    order by Hilbert index, split into equal-count parts."""
    return _hilbert_split(hilbert_key(coords), nparts, weights)


def _hilbert_order_batched(coords: np.ndarray, nparts: int,
                           dim_orders: np.ndarray,
                           weights: np.ndarray | None) -> np.ndarray:
    """Batched Hilbert numbering: one candidate per ``dim_orders`` row,
    row ``b`` bit-identical to ``order_points(coords[:, dim_orders[b]],
    nparts, "H")``.

    Per-column quantisation commutes with column permutation (lo/span
    are per-dimension), so the grid coordinates are computed ONCE and
    each candidate only re-runs the Skilling index on a column gather —
    the memoisation that lets rotation sweeps include "H" without B
    full quantisation passes.
    """
    n, d = coords.shape
    bits = hilbert_bits(n, d)
    q = _hilbert_quantise(coords, bits)
    out = np.empty((len(dim_orders), n), dtype=np.int64)
    for b, do in enumerate(dim_orders):
        out[b] = _hilbert_split(hilbert_index(q[:, do], bits), nparts,
                                weights)
    return out
