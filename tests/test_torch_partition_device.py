"""The port's device partitioner (``core/partition_torch.py``) on the CPU
against the port's numpy engine and the reference's device partitioner
(``order_points(..., backend="jax")``): the same part numbers bit for
bit — every SFC kind including Hilbert, weights with zero-weight points,
``uneven_prime``, duplicate-heavy grids, dims 1-3, more parts than
points, strict alternation, batched ``dim_orders``, the scenario
registry's point clouds — on inputs made with numpy from a seed.  Also
the split table, the fixed level count (extra levels change nothing),
``segscan``'s plain version against per-segment ``np.cumsum``, and the
``mjfinish`` handoff: the host plan of segment sizes against the loop's,
the loop stopped at any level and finished by ``mjfinish``'s plain
version against the whole loop, and the wrapper's checks.

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
from repro_torch.kernels.mjfinish import max_tile, mjfinish, mjfinish_ref
from repro_torch.kernels.mjfinish import ops as mj_ops
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


# ---------------------------------------------------------------------------
# mjfinish: the host plan, the handoff to the plain version, the wrapper
# ---------------------------------------------------------------------------

def _live_largest(st):
    live = (st.seg_np > 1) & (st.seg_size > 1)
    return int(st.seg_size[live].max()) if bool(live.any()) else 0


# (n, nparts, uneven_prime, nb, d): the four main-path shapes (both sides
# of the cold cells, the node cell's router side and its coarsening), then
# odd counts, uneven primes, more parts than points
PLAN_SHAPES = [
    (131072, 131072, False, 1, 1),
    (86400, 86400, False, 1, 1),
    (4096, 4096, False, 2, 3),
    (131072, 4096, False, 1, 1),
    (5000, 97, True, 3, 2),
    (3001, 3001, True, 2, 4),
    (777, 2000, False, 2, 3),
    (10000, 10000, True, 1, 2),
]


@pytest.mark.parametrize("n,nparts,uneven,nb,d", PLAN_SHAPES)
def test_mjfinish_plan_equals_the_loops_segments(n, nparts, uneven, nb, d):
    """The host plan's largest live segment at every level is the loop's,
    on points whose coordinates the sizes must not depend on."""
    rng = np.random.default_rng(n + nparts + d)
    coords = rng.integers(0, 5, size=(n, d)).astype(np.float64)
    dos = np.stack([rng.permutation(d) for _ in range(nb)])
    inp = PT.upload(coords, nparts, "FZ", dim_orders=dos,
                    uneven_prime=uneven, device="cpu")
    plan = [int(size[live].max()) for size, _, live
            in PT._unweighted_segments(n, nparts, uneven) if live.any()]
    l0, heads, cap = PT._handoff_plan(n, nparts, uneven, d, inp.levels,
                                      "cpu")
    st = PT.initial_state(inp)
    pos = torch.arange(n)
    seen = []
    for level in range(inp.levels + 1):
        seen.append(_live_largest(st))
        if level == l0:
            want_heads = pos[st.seg_start[:n] == pos]
        st = PT.mj_levels(st, inp.sdo, inp.tab, sfc="FZ", longest_dim=True,
                          lo=level, hi=level + 1)
    assert len(plan) <= inp.levels
    assert list(plan) + [0] * (len(seen) - len(plan)) == seen
    assert l0 == next(lv for lv, big in enumerate(seen)
                      if big <= max_tile(d))
    assert torch.equal(heads, want_heads)
    assert cap >= seen[l0] and cap & (cap - 1) == 0


def test_mjfinish_handoff_levels_of_the_main_path():
    """Level 5 on both sides of the cold cells and for the node cell's
    coarsening, level 0 for its router side; CPU tensors hand nothing
    over."""
    def l0(n, nparts, d, levels):
        return PT._handoff_plan(n, nparts, False, d, levels, "cpu")[0]

    assert max_tile(3) == 4096 and max_tile(4) == 2048
    assert max_tile(0) == max_tile(7) == 0
    assert l0(131072, 131072, 3, 17) == 5
    assert l0(86400, 86400, 3, 17) == 5
    assert l0(4096, 4096, 3, 12) == 0
    assert l0(131072, 4096, 3, 12) == 5
    assert l0(131072, 131072, 4, 17) == 6
    assert l0(131072, 131072, 3, 5) == -1
    assert l0(131072, 1, 3, 17) == -1
    _, heads, cap = PT._handoff_plan(131072, 131072, False, 3, 17, "cpu")
    assert cap == 4096 and torch.equal(heads, torch.arange(32) * 4096)
    inp = PT.upload(np.zeros((8, 3)), 4, "FZ", dim_orders=[[0, 1, 2]],
                    device="cpu")
    assert PT.finish_level(inp, inp.levels) == -1


def _handoff_equal(coords, nparts, sfc, dos, *, longest=True, uneven=False,
                   extra=0):
    """The loop stopped at every level and finished by mjfinish's plain
    version (directly and through the wrapper) equals the whole loop."""
    inp = PT.upload(coords, nparts, sfc, dim_orders=dos, longest_dim=longest,
                    uneven_prime=uneven, device="cpu")
    levels = inp.levels + extra
    want = PT.run(inp, levels=levels)
    n, d = coords.shape
    l0 = PT._handoff_plan(n, nparts, uneven, d, levels, "cpu")[0]
    stops = sorted({0, max(l0, 0), levels // 2, levels})
    n0 = mj_ops.launch_count
    for stop in stops:
        st = PT.mj_levels(PT.initial_state(inp), inp.sdo, inp.tab, sfc=sfc,
                          longest_dim=inp.longest_dim, lo=0, hi=stop)
        got = mjfinish_ref(*st, inp.sdo, inp.tab, level=stop, levels=levels,
                           sfc=sfc, longest_dim=inp.longest_dim)
        assert torch.equal(got, want), (sfc, stop, int((got != want).sum()))
        pos = torch.arange(n)
        heads = pos[st.seg_start[:n] == pos]
        again = mjfinish(*st, inp.sdo, inp.tab, heads, level=stop,
                         levels=levels, cap=max_tile(d), sfc=sfc,
                         longest_dim=inp.longest_dim)
        assert torch.equal(again, want)
    assert mj_ops.launch_count == n0  # the CPU runs the plain version
    return want


@pytest.mark.parametrize("sfc", SFCS)
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_mjfinish_ref_after_the_loop_equals_the_sweep(sfc, d):
    rng = np.random.default_rng(40 + d)
    n = 4700 if d < 4 else 2600          # past one block's tile
    coords = rng.normal(size=(n, d))
    dos = np.stack([rng.permutation(d) for _ in range(2)])
    for longest in (True, False):
        _handoff_equal(coords, n // 2, sfc, dos, longest=longest,
                       uneven=d % 2 == 0)


@pytest.mark.parametrize("sfc", ("FZ", "Gray", "FZlow"))
def test_mjfinish_ref_signed_zeros_duplicates_and_extra_levels(sfc):
    rng = np.random.default_rng(8)
    pts = rng.integers(-2, 3, size=(600, 3)).astype(np.float64)
    flip = rng.random(pts.shape) < 0.5
    pts[flip] = -pts[flip]
    assert np.signbit(pts[pts == 0]).any()
    dos = np.array([[0, 1, 2], [2, 0, 1]])
    want = _handoff_equal(pts, 32, sfc, dos, extra=3)
    assert np.array_equal(want.numpy(), RO.order_points_batched(
        pts, 32, sfc, dim_orders=dos, backend="jax"))
    grid = np.repeat(rng.integers(0, 3, size=(1000, 2)), 5, axis=0
                     ).astype(np.float64)
    _handoff_equal(grid, 700, sfc, np.array([[1, 0]]), extra=2)


def test_the_sweep_hands_off_where_finish_level_says(monkeypatch):
    """The handoff path of ``run`` (taken on a CUDA device) with the
    device test stood in for: the loop to the handoff level, the planned
    heads, the wrapper (here its plain version) equal the whole loop and
    the reference's partitioner (JAX), and each sweep appends its handoff
    level to the open span."""
    from repro_torch import obs
    rng = np.random.default_rng(12)
    coords = rng.normal(size=(9000, 3))
    dos = np.array([[0, 1, 2], [2, 1, 0]])
    inp = PT.upload(coords, 9000, "FZ", dim_orders=dos, device="cpu")
    w_inp = PT.upload(coords, 9000, "FZ", dim_orders=dos, device="cpu",
                      weights=rng.random(9000))
    with obs.span("probe") as sp:
        want = PT.run(inp)
        assert sp.attrs["finish_from"] == [-1]
        monkeypatch.setattr(PT, "_finish_plan", lambda i, levels: (
            PT._NO_HANDOFF if i.w is not None else PT._handoff_plan(
                i.shape[1], i.nparts, i.uneven_prime, i.cols.shape[0],
                levels, "cpu")))
        assert torch.equal(PT.run(inp), want)
        PT.run(w_inp)
    assert sp.attrs["finish_from"] == [-1, 2, -1]   # 9,000 > 4,500 > 4,096
    assert np.array_equal(want.numpy(), RO.order_points_batched(
        coords, 9000, "FZ", dim_orders=dos, backend="jax"))


def test_mjfinish_wrapper_checks():
    n, nb, d = 8, 2, 3
    N = n * nb
    i64 = torch.zeros(N, dtype=torch.int64)
    cols = torch.zeros((d, N), dtype=torch.float64)
    sdo = torch.zeros((nb, d), dtype=torch.int64)
    tab = torch.zeros(9, dtype=torch.int64)
    heads = torch.zeros(1, dtype=torch.int64)

    def call(**over):
        args = dict(pts=i64, cols=cols, mu=i64, seg_start=i64, seg_size=i64,
                    seg_np=i64, sdo=sdo, tab=tab, heads=heads)
        kw = dict(level=0, levels=0, cap=8, sfc="FZ", longest_dim=True)
        for key, val in over.items():
            (args if key in args else kw)[key] = val
        return mjfinish(*args.values(), **kw)

    assert call().shape == (nb, n)
    with pytest.raises(TypeError, match="float64"):
        call(cols=cols.float())
    with pytest.raises(TypeError, match="int64"):
        call(mu=i64.int())
    with pytest.raises(ValueError, match=r"\(16,\)"):
        call(seg_np=i64[:5])
    with pytest.raises(ValueError, match="contiguous"):
        call(cols=torch.zeros((N, d), dtype=torch.float64).T)
    with pytest.raises(ValueError, match="split into"):
        call(sdo=torch.zeros((3, d), dtype=torch.int64))
    with pytest.raises(ValueError, match="lies on"):
        call(heads=torch.zeros(1, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="sfc"):
        call(sfc="H")
    with pytest.raises(ValueError, match="heads must list"):
        call(heads=torch.zeros(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="heads must list"):
        call(heads=torch.zeros(n + 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="power of two"):
        call(cap=6)
    with pytest.raises(ValueError, match="power of two"):
        call(cap=8192)
    with pytest.raises(ValueError, match="outside"):
        call(level=2, levels=1)
