"""The port's host partitioner against the reference package:
``order_points`` and ``order_points_batched`` must return the same part
numbers bit for bit — every SFC kind including Hilbert, weights,
``uneven_prime``, strict alternation, duplicate-heavy grids, both host
engines — on point clouds made with numpy from a seed."""

import numpy as np
import pytest
import torch

import repro.core.orderings as RO
import repro_torch.core.orderings as PO
from repro_torch.core.partition import (vectorized_order,
                                        vectorized_order_batched)

SFCS = ("Z", "Gray", "FZ", "FZlow", "H")


def _cloud(kind, seed, n=300, d=3):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((n, d)) * 7.0
    if kind == "grid":  # power-of-two grid: distinct coordinates per axis
        g = np.indices((8, 8, 4)).reshape(3, -1).T.astype(np.float64)
        return g[rng.permutation(len(g))]
    # duplicate-heavy: few distinct values per axis, many ties at cuts
    return rng.integers(0, 4, size=(n, d)).astype(np.float64)


@pytest.mark.parametrize("sfc", SFCS)
@pytest.mark.parametrize("kind", ["random", "grid", "dups"])
@pytest.mark.parametrize("seed", range(2))
def test_order_points_equal(sfc, kind, seed):
    pts = _cloud(kind, seed)
    nparts = 32
    a = RO.order_points(pts, nparts, sfc)
    b = PO.order_points(pts, nparts, sfc)
    assert b.dtype == np.int64
    assert np.array_equal(a, b)


@pytest.mark.parametrize("sfc", SFCS)
@pytest.mark.parametrize("kind", ["random", "dups"])
def test_order_points_weighted_equal(sfc, kind):
    pts = _cloud(kind, 5)
    w = np.random.default_rng(9).uniform(0.5, 3.0, size=len(pts))
    assert np.array_equal(RO.order_points(pts, 16, sfc, weights=w),
                          PO.order_points(pts, 16, sfc, weights=w))


@pytest.mark.parametrize("sfc", ("Z", "Gray", "FZ", "FZlow"))
@pytest.mark.parametrize("nparts", [10, 12, 45])
def test_order_points_uneven_prime_equal(sfc, nparts):
    pts = _cloud("random", 11, n=360)
    assert np.array_equal(
        RO.order_points(pts, nparts, sfc, uneven_prime=True),
        PO.order_points(pts, nparts, sfc, uneven_prime=True))


@pytest.mark.parametrize("sfc", ("Z", "FZ"))
def test_order_points_strict_alternation_and_dim_order_equal(sfc):
    pts = _cloud("random", 3)
    do = np.array([2, 0, 1])
    for kw in (dict(longest_dim=False), dict(dim_order=do),
               dict(longest_dim=False, dim_order=do)):
        assert np.array_equal(RO.order_points(pts, 16, sfc, **kw),
                              PO.order_points(pts, 16, sfc, **kw))


@pytest.mark.parametrize("sfc", ("Z", "Gray", "FZ", "FZlow"))
def test_recursive_backend_equal_and_agrees_with_vectorized(sfc):
    pts = _cloud("dups", 2, n=120)
    a = RO.order_points(pts, 8, sfc, backend="recursive")
    b = PO.order_points(pts, 8, sfc, backend="recursive")
    c = PO.order_points(pts, 8, sfc, backend="vectorized")
    assert np.array_equal(a, b) and np.array_equal(b, c)


@pytest.mark.parametrize("sfc", SFCS)
@pytest.mark.parametrize("kind", ["random", "dups"])
def test_order_points_batched_equal(sfc, kind):
    pts = _cloud(kind, 4)
    dim_orders = np.array([[0, 1, 2], [2, 1, 0], [1, 2, 0], [0, 2, 1]])
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=len(pts))
    for weights in (None, w):
        a = RO.order_points_batched(pts, 16, sfc, dim_orders=dim_orders,
                                    weights=weights)
        b = PO.order_points_batched(pts, 16, sfc, dim_orders=dim_orders,
                                    weights=weights)
        assert b.shape == (4, len(pts))
        assert np.array_equal(a, b)


def test_batched_rows_equal_single_calls():
    pts = _cloud("random", 8)
    dim_orders = np.array([[0, 1, 2], [2, 0, 1]])
    mu = PO.order_points_batched(pts, 16, "FZ", dim_orders=dim_orders)
    for b, do in enumerate(dim_orders):
        assert np.array_equal(mu[b],
                              PO.order_points(pts, 16, "FZ", dim_order=do))
        assert np.array_equal(mu[b], vectorized_order(
            pts, 16, "FZ", dim_order=do))
    assert np.array_equal(mu, vectorized_order_batched(
        pts, 16, "FZ", dim_orders=dim_orders))


@pytest.mark.parametrize("sfc", ("Z", "FZ", "FZlow", "H"))
def test_grid_order_and_hilbert_helpers_equal(sfc):
    assert np.array_equal(RO.grid_order((8, 8), sfc),
                          PO.grid_order((8, 8), sfc))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 16, size=(50, 3))
    assert np.array_equal(RO.hilbert_index(x, 4), PO.hilbert_index(x, 4))
    pts = rng.random((50, 3))
    assert np.array_equal(RO.hilbert_key(pts), PO.hilbert_key(pts))
    assert RO.hilbert_bits(1000, 3) == PO.hilbert_bits(1000, 3)


def test_unknown_names_raise():
    pts = _cloud("random", 0, n=20)
    with pytest.raises(ValueError, match="unknown sfc"):
        PO.order_points(pts, 4, "Peano")
    with pytest.raises(ValueError, match="unknown backend"):
        PO.order_points(pts, 4, "FZ", backend="jax")
    with pytest.raises(ValueError, match="unknown backend"):
        PO.order_points_batched(pts, 4, "FZ", dim_orders=[[0, 1, 2]],
                                backend="jax")


def test_device_partitioner_is_refused_not_replaced():
    # "torch" resolves to itself (on a device the process reaches), a
    # reference-only name raises as unknown, and so does an unreachable
    # device: nothing is replaced by the host engine
    assert PO.resolve_partition_backend("numpy") == "numpy"
    assert PO.resolve_partition_backend("torch", "cpu") == "torch"
    with pytest.raises(ValueError, match="unknown partition backend"):
        PO.resolve_partition_backend("jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PO.resolve_partition_backend("torch", "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PO.order_points(_cloud("random", 0, n=20), 4, "FZ",
                            backend="torch")
