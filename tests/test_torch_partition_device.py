"""The port's device partitioner (``core/partition_torch.py``) on the CPU
against the port's numpy engine and the reference's device partitioner
(``order_points(..., backend="jax")``): the same part numbers bit for
bit — every SFC kind including Hilbert, weights with zero-weight points,
``uneven_prime``, duplicate-heavy grids, dims 1-3, more parts than
points, strict alternation, batched ``dim_orders``, the scenario
registry's point clouds — on inputs made with numpy from a seed.  Also
the split table, the fixed level count (extra levels change nothing),
and ``segscan``'s plain version against per-segment ``np.cumsum``.

The reference entry points turn on ``jax_enable_x64`` for the whole
process (``repro.core.partition_jax``), as ``tests/test_partition_jax.py``
does on its worker; this file uses nothing else of JAX.
"""

import itertools

import numpy as np
import pytest
import torch

import repro.core.orderings as RO
import repro_torch.core.orderings as PO
from repro_torch.core import partition_torch as PT
from repro_torch.kernels.segscan import ops as seg_ops
from repro_torch.kernels.segscan import segscan, segscan_ref

SFCS = ("Z", "Gray", "FZ", "FZlow")


def _three(coords, nparts, sfc, **kw):
    """(reference jax, port numpy, port torch on the CPU) part numbers."""
    a = RO.order_points(coords, nparts, sfc, backend="jax", **kw)
    b = PO.order_points(coords, nparts, sfc, backend="vectorized", **kw)
    c = PO.order_points(coords, nparts, sfc, backend="torch", device="cpu",
                        **kw)
    return a, b, c


def _assert_equal(coords, nparts, sfc, **kw):
    a, b, c = _three(coords, nparts, sfc, **kw)
    assert c.dtype == np.int64 and c.shape == (len(coords),)
    assert np.array_equal(b, c), (sfc, nparts, kw, int((b != c).sum()))
    assert np.array_equal(a, c), (sfc, nparts, kw, int((a != c).sum()))


def _assert_batched_equal(coords, nparts, sfc, **kw):
    a = RO.order_points_batched(coords, nparts, sfc, backend="jax", **kw)
    b = PO.order_points_batched(coords, nparts, sfc, backend="vectorized",
                                **kw)
    c = PO.order_points_batched(coords, nparts, sfc, backend="torch",
                                device="cpu", **kw)
    assert c.shape == b.shape
    assert np.array_equal(b, c) and np.array_equal(a, c)
    return c


# ---------------------------------------------------------------------------
# property-style bit-identity across every knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(16))
def test_random_points_all_knobs(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 4))
    n = int(rng.integers(2, 400))
    nparts = int(rng.integers(1, 70))
    sfc = SFCS[seed % 4]
    weights = rng.random(n) if seed % 3 == 0 else None
    uneven = bool(seed % 2)
    longest = seed % 5 != 0
    dim_order = rng.permutation(d) if seed % 4 == 0 else None
    coords = rng.normal(size=(n, d))
    if seed % 6 == 0:  # duplicate-heavy: the tie order is the test
        coords = np.repeat(coords[: max(n // 5, 1)], 5, axis=0)
        if weights is not None:
            weights = rng.random(len(coords))
    _assert_equal(coords, nparts, sfc, weights=weights, uneven_prime=uneven,
                  longest_dim=longest, dim_order=dim_order)


@pytest.mark.parametrize("seed", range(8))
def test_batched_bit_identity(seed):
    rng = np.random.default_rng(100 + seed)
    d = int(rng.integers(2, 4))
    n = int(rng.integers(8, 300))
    nparts = int(rng.integers(2, 48))
    dim_orders = np.stack([rng.permutation(d)
                           for _ in range(int(rng.integers(1, 5)))])
    _assert_batched_equal(
        rng.normal(size=(n, d)), nparts, SFCS[seed % 4],
        dim_orders=dim_orders,
        weights=rng.random(n) if seed % 2 else None,
        uneven_prime=bool(seed % 3 == 0), longest_dim=seed % 4 != 1)


@pytest.mark.parametrize("nparts", [7, 97])
@pytest.mark.parametrize("sfc", SFCS)
def test_uneven_prime_parts_on_grids(nparts, sfc):
    ix = np.indices((16, 16))
    coords = np.stack([c.ravel() for c in ix], axis=1).astype(float)
    _assert_equal(coords, nparts, sfc, uneven_prime=True)


@pytest.mark.parametrize("sfc", SFCS + ("H",))
def test_zero_weight_points_and_more_parts_than_points(sfc):
    rng = np.random.default_rng(7)
    coords = rng.normal(size=(40, 2))
    w = rng.random(40)
    w[::3] = 0.0
    _assert_equal(coords, 8, sfc, weights=w)
    _assert_equal(rng.normal(size=(5, 2)), 16, sfc)


@pytest.mark.parametrize("sfc", SFCS + ("H",))
@pytest.mark.parametrize("d", [1, 2, 3])
def test_duplicate_heavy_grids_every_dim(sfc, d):
    rng = np.random.default_rng(30 + d)
    coords = rng.integers(0, 3, size=(300, d)).astype(np.float64)
    w = rng.uniform(0.0, 2.0, size=300)
    for kw in (dict(), dict(weights=w), dict(longest_dim=False)):
        _assert_equal(coords, 24, sfc, **kw)


@pytest.mark.parametrize("sfc", ("FZ", "Gray", "FZlow"))
def test_signed_zero_coordinates(sfc):
    """Flips mint -0.0; the engine adds 0.0 to its sort keys so that
    -0.0 and 0.0 tie as in numpy (the CPU's comparison sort ties them
    anyway; chip_smoke.py holds the same cloud on the card)."""
    rng = np.random.default_rng(7)
    pts = rng.integers(-2, 3, size=(600, 3)).astype(np.float64)
    flip = rng.random(pts.shape) < 0.5
    pts[flip] = -pts[flip]
    assert np.signbit(pts[pts == 0]).any()
    _assert_batched_equal(pts, 32, sfc,
                          dim_orders=np.array([[0, 1, 2], [2, 0, 1]]))


# ---------------------------------------------------------------------------
# Hilbert: Skilling's transpose on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_hilbert_bit_identity(seed):
    rng = np.random.default_rng(500 + seed)
    d = int(rng.integers(1, 4))
    n = int(rng.integers(2, 400))
    nparts = int(rng.integers(1, 48))
    weights = rng.random(n) if seed % 3 == 0 else None
    coords = rng.normal(size=(n, d))
    if seed % 4 == 0:
        coords = rng.integers(0, 4, size=(n, d)).astype(float)
    _assert_equal(coords, nparts, "H", weights=weights)


def test_hilbert_batched_dim_order_candidates():
    rng = np.random.default_rng(21)
    coords = rng.normal(size=(200, 3))
    dos = np.array(list(itertools.permutations(range(3))))
    for weights in (None, rng.random(200)):
        c = _assert_batched_equal(coords, 12, "H", dim_orders=dos,
                                  weights=weights)
        for i, p in enumerate(dos):
            assert np.array_equal(c[i], PO.order_points(
                coords[:, list(p)], 12, "H", weights=weights))


# ---------------------------------------------------------------------------
# scenario registry: every machine x workload, both sides, at scale 192
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["minighost", "homme", "random"])
@pytest.mark.parametrize("allocation",
                         ["xk7_sparse", "bgq_block", "tpu_mesh", "fat_tree"])
def test_scenario_registry_bit_identity(workload, allocation):
    from repro.mapping.pipeline import MappingPipeline, PipelineConfig
    from repro.serve.scenarios import Scenario

    sc = Scenario(workload, allocation, scale=192)
    graph = sc.graph()
    alloc = sc.alloc_for(graph)
    pc = MappingPipeline(PipelineConfig(sfc="FZ", shift=True)
                         ).machine_coords(alloc)
    for coords in (graph.coords.astype(float), pc):
        d = coords.shape[1]
        _assert_batched_equal(
            coords, min(len(coords), len(pc)), "FZ",
            dim_orders=np.stack([np.arange(d), np.arange(d)[::-1]]))


# ---------------------------------------------------------------------------
# the engine's own pieces
# ---------------------------------------------------------------------------

def test_split_table_equals_reference():
    from repro.core import partition_jax
    for nparts in (1, 2, 97, 1000):
        for uneven in (False, True):
            ref = partition_jax._split_table(nparts, uneven)
            got = PT._split_table(nparts, uneven)
            assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_split_depth_is_the_split_trees():
    assert PT.split_depth(1, False) == 0
    assert PT.split_depth(2, False) == 1
    assert PT.split_depth(2 ** 18, False) == 18
    assert PT.split_depth(97, False) == 7
    # 7 = 3 | 4 under uneven primes: 3 = 1 | 2 -> depth 3
    assert PT.split_depth(7, True) == 3


@pytest.mark.parametrize("sfc", SFCS)
@pytest.mark.parametrize("weighted", [False, True])
def test_extra_levels_change_nothing(sfc, weighted):
    """The sweep runs the split tree's depth on a fixed count; levels
    past it only reorder points inside finished segments."""
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 6, size=(500, 3)).astype(np.float64)
    inp = PT.upload(coords, 37, sfc, dim_orders=[[0, 1, 2], [1, 2, 0]],
                    weights=rng.random(500) if weighted else None,
                    uneven_prime=True, device="cpu")
    base = PT.run(inp)
    assert torch.equal(base, PT.run(inp, levels=inp.levels + 2))
    assert not torch.equal(base, PT.run(inp, levels=inp.levels - 1))


def test_inputs_are_float64_and_int64_on_the_device_asked():
    rng = np.random.default_rng(0)
    inp = PT.upload(rng.normal(size=(50, 2)).astype(np.float32), 8, "FZ",
                    dim_orders=[[1, 0]], weights=np.ones(50, np.float32),
                    device="cpu")
    assert inp.cols.dtype == inp.w.dtype == torch.float64
    assert inp.sdo.dtype == inp.tab.dtype == torch.int64
    assert inp.cols.device.type == "cpu"
    out = PT.run(inp)
    assert out.dtype == torch.int64 and out.shape == (1, 50)
    with pytest.raises(ValueError, match="unknown sfc"):
        PT.upload(rng.normal(size=(5, 2)), 2, "Peano", dim_orders=[[0, 1]],
                  device="cpu")


def test_unreachable_device_raises_and_nothing_falls_back():
    pts = np.random.default_rng(0).normal(size=(30, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PO.order_points(pts, 4, "FZ", backend="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PO.order_points_batched(pts, 4, "FZ", dim_orders=[[0, 1]],
                                    backend="torch")
    assert np.array_equal(
        PO.order_points(pts, 4, "FZ", backend="torch", device="cpu"),
        PO.order_points(pts, 4, "FZ"))


# ---------------------------------------------------------------------------
# segscan: the plain version and the wrapper's CPU route
# ---------------------------------------------------------------------------

def _layout(rng, n, max_len):
    lens = rng.integers(1, max_len + 1, size=n)
    ends = np.minimum(np.cumsum(lens), n)
    starts = np.unique(np.concatenate([[0], ends[:-1]]))
    starts = starts[starts < n]
    size = np.diff(np.append(starts, n))
    return starts, size


@pytest.mark.parametrize("max_len", [1, 3, 50, 5000])
def test_segscan_ref_equals_per_segment_cumsum(max_len):
    rng = np.random.default_rng(max_len)
    n = 5000
    starts, size = _layout(rng, n, max_len)
    # magnitudes over twelve decades: any other order of the adds moves
    # last bits
    w = rng.random(n) * 10.0 ** rng.uniform(-6, 6, n)
    want = np.concatenate([np.cumsum(w[s:s + k])
                           for s, k in zip(starts, size)])
    st = torch.from_numpy(np.repeat(starts, size))
    sz = torch.from_numpy(np.repeat(size, size))
    got = segscan_ref(torch.from_numpy(w), st, sz).numpy()
    assert np.array_equal(got, want)
    if max_len > 1:
        # the same sums in another order (one running sum over all
        # segments, less each segment's offset) differ: exactness is not
        # automatic
        glob = np.cumsum(w)
        base = np.concatenate([[0.0], glob])[starts]
        assert (glob - np.repeat(base, size) != want).any()
    n0 = seg_ops.launch_count
    again = segscan(torch.from_numpy(w), st, sz).numpy()
    assert np.array_equal(again, want)
    assert seg_ops.launch_count == n0  # the CPU runs the plain version


def test_segscan_wrapper_checks():
    w = torch.zeros(4, dtype=torch.float64)
    i = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="float64"):
        segscan(w.float(), i, i)
    with pytest.raises(TypeError, match="int64"):
        segscan(w, i.int(), i)
    with pytest.raises(ValueError, match=r"\(4,\)"):
        segscan(w, i[:3], i)
    assert segscan(torch.zeros(0, dtype=torch.float64),
                   torch.zeros(0, dtype=torch.int64),
                   torch.zeros(0, dtype=torch.int64)).numel() == 0
