"""Space-filling-curve part numberings (paper Alg. 2 + Appendix A): a
frozen copy of the mapping service's host engine, kept here as the
benchmark's plain reference.  It imports nothing of the program.

- ``Z``     : Morton order — lower part numbers below each cut (no flips).
- ``Gray``  : flip *all* coordinates of the high half after each bisection.
- ``FZ``    : Flipped-Z — flip only the *cut dimension* of the high half.
- ``FZlow`` : the MFZ companion — flip the cut dimension of the *low* half.

``order_points`` / ``order_points_batched`` run the level-synchronous
vectorised engine of :mod:`pbench.ref.partition`; the Hilbert index
below orders allocations and a cluster's tasks.
"""

from __future__ import annotations

import numpy as np

SFC_KINDS = ("Z", "Gray", "FZ", "FZlow")


def order_points(coords: np.ndarray, nparts: int, sfc: str = "FZ", *,
                 weights: np.ndarray | None = None,
                 dim_order: np.ndarray | None = None,
                 longest_dim: bool = True,
                 uneven_prime: bool = False) -> np.ndarray:
    """Paper Algorithm 2: part numbers ``mu`` ((n,) int64 in
    ``[0, nparts)``) of ``coords`` ((n, d) float), cuts balancing
    ``weights``; ``dim_order`` breaks ties of the longest dimension."""
    from .partition import vectorized_order
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    return vectorized_order(
        np.asarray(coords, dtype=np.float64), nparts, sfc, weights=weights,
        dim_order=dim_order, longest_dim=longest_dim,
        uneven_prime=uneven_prime)


def order_points_batched(coords: np.ndarray, nparts: int, sfc: str = "FZ",
                         *, dim_orders: np.ndarray,
                         weights: np.ndarray | None = None,
                         longest_dim: bool = True,
                         uneven_prime: bool = False) -> np.ndarray:
    """Algorithm 2 for a stack of rotations of one point cloud: row ``b``
    of the (B, n) result equals ``order_points(coords, nparts, sfc,
    dim_order=dim_orders[b])`` — a rotation permutes the columns, which
    only changes the cut dimension's tie-break priority."""
    from .partition import vectorized_order_batched
    if sfc not in SFC_KINDS:
        raise ValueError(f"unknown sfc {sfc!r}")
    return vectorized_order_batched(
        np.asarray(coords, dtype=np.float64), nparts, sfc,
        dim_orders=np.atleast_2d(np.asarray(dim_orders, dtype=np.int64)),
        weights=weights, longest_dim=longest_dim,
        uneven_prime=uneven_prime)


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
    intra-node task ordering.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n, d = coords.shape
    if bits is None:
        bits = hilbert_bits(n, d)
    return hilbert_index(_hilbert_quantise(coords, bits), bits)

