"""The hierarchical path of the port (``repro_torch.hier`` and the
refinement half of ``mapping/fused.py``) against the reference
(``repro.hier``) on the CPU, on numpy-seeded problems carried across with
``compat``.

Held bit for bit: ``aggregate_tasks`` (labels, sizes, weights, centroids,
coarse edges and volumes, intra volume) with both partition engines,
``router_view``, ``group_units``, ``assign_cores`` (uneven router core
counts, the spill, tied points, the node cell's shape reduced; through
the coredeal kernel's plain version, up to 20 dimensions, with inputs
as the hierarchy hands them over), ``refine_swaps`` / ``refine_qap`` /
``polish_groups`` from scrambled starts with the numpy evaluator on both
sides, and ``MappingPipeline.map`` for node, depth-3, depth-4 and
``from_machine`` specs: the port's fused path (device partitioner on the
CPU, torch scorer, the device refinement) and its staged path
(``fused="off"``) against the reference's all-numpy host path and its
fused ``partition_backend="jax", score_backend="jax"`` program — equal
``task_to_proc``, ``rotation``, stats key sets (every ``levels`` entry's
too) and, for WeightedHops, ``refine_history``.

Held to a tolerance, and why:

- ``LAT_RTOL`` (1e-6): the latency objective's history values scored by
  the port's torch scorer (float32 volumes, float64 sums) against the
  reference's numpy (float64 volumes) and jax (float32 arithmetic)
  scorers — the inputs differ in their float32 rounding.  The
  assignments are still equal, and the port's fused and staged paths
  equal each other bit for bit.
- ``LOGNORMAL_RTOL`` (1e-12): WeightedHops on ``random-*`` graphs, whose
  volumes are lognormal.  The fused refinement sums each proposal's
  score as ``base + sum w * dhops`` (the reference's fused sum), the
  host pass as ``base - base_union + union``: the two agree exactly
  only for integer-valued volumes; the reference's own fused and host passes
  differ in the last bit there too
  (``test_lognormal_volumes_differ_in_the_last_bit_on_the_reference``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.hier as RH
import repro.serve as RSV
from repro.core import (bgq, block_allocation, gemini_xk7, sfc_allocation,
                        stencil_graph, tpu_v5e_pod)
from repro.mapping.pipeline import MappingPipeline as RPipeline
from repro.mapping.pipeline import PipelineConfig as RConfig
from repro_torch import compat, hier, obs
from repro_torch.kernels.coredeal import coredeal
from repro_torch.mapping import MappingPipeline
from repro_torch.mapping.fused import FusedSweep, _Refinement
from repro_torch.serve import MappingService

LAT_RTOL = 1e-6
LOGNORMAL_RTOL = 1e-12
LATENCY = ("latency_max", "weighted_hops")


def _grid(n):
    e = int(np.log2(n))
    a = e // 3
    return (1 << (e - 2 * a), 1 << a, 1 << a)


def _xk7(ntasks=256, seed=3):
    """Reference (machine, alloc, graph): ``ntasks`` stencil tasks on a
    fragmented 256-core allocation of an (8, 4, 4) Gemini torus with 4
    cores a node."""
    m = gemini_xk7(dims=(8, 4, 4), cores_per_node=4)
    alloc = sfc_allocation(m, 256, nfragments=2, seed=seed)
    return m, alloc, stencil_graph(_grid(ntasks))


def _hist_close(a, b, rtol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.allclose(x, y, rtol=rtol, atol=0), (a, b)


def _monotone(hist):
    for x, y in zip(hist, hist[1:]):
        assert tuple(y) <= tuple(x)


# ---------------------------------------------------------------------------
# aggregation, machine grouping, core assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sfc", ["FZ", "H"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("backend", ["vectorized", "torch"])
def test_aggregate_tasks_matches_reference(backend, weighted, sfc):
    g = stencil_graph((16, 8, 8))
    g.weights = np.random.default_rng(1).integers(1, 9, len(g.edges)) * 1.0
    w = (np.random.default_rng(0).uniform(0.5, 2.0, g.n) if weighted
         else None)
    want = RH.aggregate_tasks(g, 64, task_weights=w, sfc=sfc)
    got = hier.aggregate_tasks(compat.taskgraph(g), 64, task_weights=w,
                               sfc=sfc, backend=backend, device="cpu")
    assert got.nclusters == want.nclusters
    for key in ("labels", "sizes", "weights"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert np.array_equal(got.coarse.coords, want.coarse.coords)
    assert np.array_equal(got.coarse.edges, want.coarse.edges)
    assert np.array_equal(got.coarse.weights, want.coarse.weights)
    assert got.intra_volume == want.intra_volume
    assert got.coarse.meta["kind"] == "aggregated"
    with pytest.raises(ValueError, match="nclusters"):
        hier.aggregate_tasks(compat.taskgraph(g), 0, device="cpu")


def _allocations():
    xk7 = _xk7()[1]
    b = bgq(dims=(2, 2, 4, 2, 2), cores_per_node=4)
    return {"xk7_sparse": xk7, "bgq_block": block_allocation(b),
            "tpu_pod": block_allocation(tpu_v5e_pod(side=8))}


@pytest.mark.parametrize("name", ["xk7_sparse", "bgq_block", "tpu_pod"])
@pytest.mark.parametrize("backend", ["vectorized", "torch"])
def test_router_view_and_group_units_match_reference(name, backend):
    ref = _allocations()[name]
    want = RH.router_view(ref)
    got = hier.router_view(compat.allocation(ref))
    for x, y in zip(got[:2], want[:2]):
        assert np.array_equal(x, y)
    assert np.array_equal(got[2].coords, want[2].coords)
    rc = want[0]
    for ngroups in (max(1, len(rc) // 4), max(1, len(rc) // 3)):
        for sfc in ("FZ", "H"):
            wl, wm = RH.group_units(rc, ngroups, sfc=sfc)
            gl, gm = hier.group_units(rc, ngroups, sfc=sfc, backend=backend,
                                      device="cpu")
            assert np.array_equal(gl, wl)
            assert np.array_equal(gm, wm)


ASSIGN_CASES = ("even", "uneven", "spill", "ties", "wide", "node")


def _assign_case(case):
    """(labels, c2r, core_router, coords, nrouters) of an assign_cores
    case: ``ties`` many tasks on few points (lexsort's stability);
    ``wide`` 20-dimensional coordinates, a Hilbert index of 60 bits (3 a
    dimension); ``node`` the
    node cell's shape reduced: a (16, 16, 8) grid in boxes of 32 on
    routers of 32 cores."""
    rng = np.random.default_rng(ASSIGN_CASES.index(case))
    nrouters, cores = 16, 4
    if case == "node":
        g = np.indices((16, 16, 8)).reshape(3, -1).T.astype(np.float64)
        labels = ((g[:, 0] // 4) * 16 + (g[:, 1] // 4) * 4
                  + g[:, 2] // 2).astype(np.int64)
        nrouters = 64
        core_router = np.repeat(np.arange(nrouters), 32)
        return labels, rng.permutation(nrouters), core_router, g, nrouters
    core_router = np.repeat(np.arange(nrouters), cores)
    if case in ("uneven", "spill"):
        # a trimmed allocation: some routers lose cores
        core_router = core_router[rng.random(len(core_router)) < 0.8]
        core_router = np.sort(core_router)
    ncores = len(core_router)
    n = ncores if case != "spill" else ncores + 7
    d = 20 if case == "wide" else 3
    coords = rng.random((n, d)) * 8
    if case == "ties":
        coords = rng.integers(0, 3, (n, d)).astype(np.float64)
    if case == "spill":
        # weight-balanced clusters of uneven sizes
        labels = rng.integers(0, nrouters, n)
    else:
        labels = np.repeat(np.arange(nrouters), -(-n // nrouters))[:n]
        labels = rng.permutation(labels)
    return labels, rng.permutation(nrouters), core_router, coords, nrouters


@pytest.mark.parametrize(
    "case,view",
    [pytest.param(c, False, id=f"{c}-on-cpu") for c in ASSIGN_CASES]
    + [pytest.param(c, True, id=f"{c}-cpu-view") for c in ASSIGN_CASES])
def test_assign_cores_matches_reference(case, view):
    """The expansion on ``"cpu"`` (the coredeal kernel's plain-torch
    version) against the reference; ``view`` hands the inputs over as
    ``levels.py`` can: coordinates as a non-contiguous column view, the
    labels and the cluster -> router table as int32 (the upload
    converts them)."""
    labels, c2r, core_router, coords, nrouters = _assign_case(case)
    n, ncores = len(labels), len(core_router)
    want = RH.assign_cores(labels, c2r, core_router, coords, nrouters)
    args = (labels, c2r, core_router, coords)
    if view:
        wide = np.concatenate([coords[:, ::-1], coords], axis=1)
        args = (labels.astype(np.int32), c2r.astype(np.int32), core_router,
                wide[:, coords.shape[1]:])
        assert not args[3].flags.c_contiguous
        assert np.array_equal(args[3], coords)
    got = hier.assign_cores(*args, nrouters, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    if n == ncores:
        assert np.array_equal(np.sort(got), np.arange(ncores))
    assert np.bincount(got, minlength=ncores).max() <= -(-n // ncores)
    if case == "node":
        # each router's 32 tasks (one cluster) fill its 32 cores
        assert np.array_equal(core_router[got], c2r[labels])


def test_coredeal_wrapper_checks():
    labels, c2r, core_router, coords, nrouters = _assign_case("even")
    args = dict(labels=torch.from_numpy(labels),
                cluster_to_router=torch.from_numpy(c2r),
                core_router=torch.from_numpy(core_router),
                coords=torch.from_numpy(coords))

    def call(nr=nrouters, **over):
        return coredeal(**{**args, **over}, nrouters=nr)

    t2p = call()
    assert np.array_equal(
        t2p.numpy(), RH.assign_cores(labels, c2r, core_router, coords,
                                     nrouters))
    with pytest.raises(TypeError, match="float64"):
        call(coords=args["coords"].float())
    with pytest.raises(TypeError, match="int64"):
        call(labels=args["labels"].int())
    with pytest.raises(ValueError, match="entries for"):
        call(labels=args["labels"][:-1])
    with pytest.raises(ValueError, match="1 to 62 dimensions"):
        call(coords=torch.zeros((len(labels), 63), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        call(coords=args["coords"].T.contiguous().T)
    with pytest.raises(ValueError, match="lies on"):
        call(core_router=args["core_router"].to("meta"))
    with pytest.raises(ValueError, match="cluster id"):
        call(labels=args["labels"] + len(c2r))
    with pytest.raises(ValueError, match="router id"):
        call(nr=nrouters - 1)
    with pytest.raises(ValueError, match="router id"):
        call(cluster_to_router=args["cluster_to_router"] - 1)
    with pytest.raises(ValueError, match="one cluster and one core"):
        call(core_router=args["core_router"][:0])
    empty = call(labels=args["labels"][:0], coords=args["coords"][:0])
    assert empty.shape == (0,) and empty.dtype == torch.int64


# ---------------------------------------------------------------------------
# the host refinement passes
# ---------------------------------------------------------------------------

def _cluster_case(seed):
    """(reference machine, coarse graph, router coords, scrambled start)
    with integer volumes."""
    rng = np.random.default_rng(seed)
    m, alloc, g = _xk7()
    g.weights = rng.integers(1, 17, len(g.edges)).astype(np.float64)
    rc, _, _ = RH.router_view(alloc)
    agg = RH.aggregate_tasks(g, len(rc))
    return m, agg.coarse, rc, rng.permutation(len(rc))


def _both(fn_ref, fn_port, m, coarse, rc, start, *extra, **kw):
    port_kw = dict(kw)
    backend = port_kw.pop("port_backend", "numpy")
    want = fn_ref(m, coarse, rc, start, *extra, **port_kw)
    got = fn_port(compat.machine(m), compat.taskgraph(coarse), rc, start,
                  *extra, score_backend=backend, device="cpu", **port_kw)
    return want, got


@pytest.mark.parametrize("objective", [("weighted_hops",), LATENCY])
@pytest.mark.parametrize("fn", ["refine_swaps", "refine_qap"])
def test_refine_passes_match_reference(fn, objective):
    m, coarse, rc, start = _cluster_case(seed=0)
    kw = dict(objective=objective, rounds=3, top=16, degree=4)
    (wc, ws), (gc, gs) = _both(getattr(RH, fn), getattr(hier, fn), m,
                               coarse, rc, start, **kw)
    assert np.array_equal(gc, wc)
    assert gs == ws
    assert ws["refine_accepted"] > 0
    _monotone(gs["refine_history"])
    # the torch scorer on the CPU (float32 volumes): the same trajectory
    (_, _), (tc, ts) = _both(getattr(RH, fn), getattr(hier, fn), m, coarse,
                             rc, start, port_backend="torch", **kw)
    assert np.array_equal(tc, wc)
    assert {k: v for k, v in ts.items() if k != "refine_history"
            and not k.endswith(("_initial", "_final"))} == \
        {k: v for k, v in ws.items() if k != "refine_history"
         and not k.endswith(("_initial", "_final"))}
    _hist_close(ts["refine_history"], ws["refine_history"], LAT_RTOL)
    _monotone(ts["refine_history"])


@pytest.mark.parametrize("objective", [("weighted_hops",), LATENCY])
def test_polish_groups_matches_reference(objective):
    m, coarse, rc, start = _cluster_case(seed=1)
    member, _ = RH.group_units(rc, len(rc) // 4)
    (wc, ws), (gc, gs) = _both(RH.polish_groups, hier.polish_groups, m,
                               coarse, rc, start, member,
                               objective=objective, rounds=6)
    assert np.array_equal(gc, wc)
    assert gs == ws
    assert np.array_equal(member[gc], member[start])
    _monotone(gs["polish_history"])
    (_, _), (tc, ts) = _both(RH.polish_groups, hier.polish_groups, m, coarse,
                             rc, start, member, objective=objective,
                             rounds=6, port_backend="torch")
    assert np.array_equal(tc, wc)
    _hist_close(ts["polish_history"], ws["polish_history"], LAT_RTOL)


def test_refine_passes_resolve_their_scorer_once_with_no_fallback():
    m, coarse, rc, start = _cluster_case(seed=2)
    pm, pc = compat.machine(m), compat.taskgraph(coarse)
    with pytest.raises(ValueError, match="hopper"):
        hier.refine_swaps(pm, pc, rc, start, objective=LATENCY,
                          score_backend="hopper", device="cpu")
    with pytest.raises(ValueError, match="unknown scoring backend"):
        hier.refine_qap(pm, pc, rc, start, objective=LATENCY,
                        score_backend="jax", device="cpu")
    # separable objectives score with the numpy evaluator whatever is asked
    out, _ = hier.refine_swaps(pm, pc, rc, start, score_backend="hopper",
                               device="cpu")
    want, _ = RH.refine_swaps(m, coarse, rc, start)
    assert np.array_equal(out, want)


def test_entry_points_default_to_the_card():
    """Called with their defaults, the hierarchy's functions partition on
    the card and score a latency objective with the mapscore kernel; a
    CPU caller must ask for the CPU's scorer."""
    import inspect
    for fn, key, want in ((hier.aggregate_tasks, "backend", "torch"),
                          (hier.group_units, "backend", "torch"),
                          (hier.refine_swaps, "score_backend", "hopper"),
                          (hier.refine_qap, "score_backend", "hopper"),
                          (hier.polish_groups, "score_backend", "hopper")):
        params = inspect.signature(fn).parameters
        assert params[key].default == want, fn.__name__
        assert params["device"].default == "cuda", fn.__name__
    m, coarse, rc, start = _cluster_case(seed=2)
    with pytest.raises(ValueError, match="hopper"):
        hier.refine_swaps(compat.machine(m), compat.taskgraph(coarse), rc,
                          start, objective=LATENCY, device="cpu")


# ---------------------------------------------------------------------------
# the fused refinement's sort traps (ties, zero contributions)
# ---------------------------------------------------------------------------

def _ring_case(zero: bool):
    """16 clusters on a 4x4 torus from a scrambled start.  A ring of equal
    volumes ties every contribution and many hop distances; with
    ``zero`` only four clusters talk, so twelve contribute 0 (-0.0 once
    negated)."""
    from repro_torch.core import TaskGraph, make_machine
    m = make_machine((4, 4), wrap=True)
    rc = np.stack(np.unravel_index(np.arange(16), (4, 4)), axis=1)
    n = 4 if zero else 16
    src = np.arange(n)
    edges = np.concatenate([np.stack([src, (src + 1) % n], 1),
                            np.stack([(src + 1) % n, src], 1)])
    g = TaskGraph(np.zeros((16, 2)), edges, np.full(len(edges), 3.0))
    start = np.random.default_rng(5).permutation(16)
    return m, g, rc, start


@pytest.mark.parametrize("objective", [("weighted_hops",), LATENCY])
@pytest.mark.parametrize("zero", [False, True], ids=["ties", "zeros"])
def test_fused_refinement_sort_traps(zero, objective):
    import torch
    from repro_torch.core.machine import Allocation
    from repro_torch.core.metrics_torch import message_inputs
    m, g, rc, start = _ring_case(zero)
    alloc = Allocation(m, rc)
    want_c, want = hier.refine_swaps(m, g, rc, start, objective=objective,
                                     rounds=4, top=8, degree=3,
                                     score_backend="torch", device="cpu")
    pipe = MappingPipeline(dataclasses.replace(
        _port_config(RConfig(objective=objective)), fused="auto"))
    traffic = pipe.search.needs_traffic
    edges, w, inv_bw = message_inputs(m, g.edges, g.weights, traffic, "cpu")
    ref = _Refinement(pipe._fused, m, torch.from_numpy(rc.astype(np.int32)),
                      edges, w, inv_bw, g, traffic, pipe.search.objective)
    row, got, reads = ref.run(torch.from_numpy(start), rounds=4, top=8,
                              degree=3)
    assert np.array_equal(row, want_c)
    assert got == want
    # one copy a round that ran, one for the result
    assert reads == min(want["refine_rounds_run"] + 1, 4) + 1


@pytest.mark.parametrize("objective", [("weighted_hops",), LATENCY])
def test_fused_refinement_scores_in_chunks_of_hot_rows(monkeypatch,
                                                       objective):
    """A stack byte budget too small for two hot rows scores the
    proposals one hot row a chunk: the same trajectory, bit for bit."""
    import torch
    import repro_torch.mapping.fused as F
    from repro_torch.core.metrics_torch import message_inputs
    m, g, rc, start = _ring_case(False)
    pipe = MappingPipeline(dataclasses.replace(
        _port_config(RConfig(objective=objective)), fused="auto"))
    traffic = pipe.search.needs_traffic
    edges, w, inv_bw = message_inputs(m, g.edges, g.weights, traffic, "cpu")

    def refine():
        ref = _Refinement(pipe._fused, m,
                          torch.from_numpy(rc.astype(np.int32)), edges, w,
                          inv_bw, g, traffic, pipe.search.objective)
        return ref.run(torch.from_numpy(start), rounds=4, top=8, degree=3)

    whole = refine()
    monkeypatch.setattr(F, "STACK_BYTE_BUDGET", 1)
    chunked = refine()
    assert np.array_equal(chunked[0], whole[0])
    assert chunked[1:] == whole[1:]
    assert whole[1]["refine_accepted"] > 0


# ---------------------------------------------------------------------------
# MappingPipeline.map through the hierarchy
# ---------------------------------------------------------------------------

def _port_config(rcfg, **kw):
    cfg = compat.pipeline_config(rcfg, device="cpu")
    return dataclasses.replace(cfg, partition_backend="torch",
                               score_backend="torch", **kw)


def _scenario(name, scale=512):
    req = RSV.get_scenario(name, scale=scale, rotations=4).request()
    return req.graph, req.alloc, req.config, None


def _custom(ntasks, spec, objective="weighted_hops", weights=False):
    _, alloc, g = _xk7(ntasks)
    w = (np.random.default_rng(4).uniform(0.5, 2.0, g.n) if weights
         else None)
    return g, alloc, RConfig(rotations=4, hierarchy=spec,
                             objective=objective), w


CASES = {
    "node-xk7-wh-FZ": lambda: _scenario("minighost-xk7_sparse-node-wh"),
    "node-xk7-latency-H": lambda: _with(
        _scenario("minighost-xk7_sparse-node-latency"), sfc="H"),
    "node-bgq-latency": lambda: _scenario("homme-bgq_block-node-latency"),
    "depth3-xk7-wh-H": lambda: _with(
        _scenario("minighost-xk7_sparse-depth3-wh"), sfc="H"),
    "depth3-bgq-latency": lambda: _scenario("homme-bgq_block-depth3-latency"),
    "depth4-tpu-no-core-dims": lambda: _with(
        _scenario("homme-tpu_mesh-depth3-wh"),
        hierarchy=RH.HierarchySpec.with_depth(4)),
    "from-machine-bgq-depth3": lambda: _with(
        _scenario("minighost-bgq_block-depth3-wh"),
        hierarchy=RH.HierarchySpec.from_machine(
            _scenario("minighost-bgq_block-depth3-wh")[1].machine, 3)),
    "node-task-weights": lambda: _custom(256, RH.HierarchySpec.node(),
                                         weights=True),
    "node-fewer-tasks-than-nodes": lambda: _custom(
        64, RH.HierarchySpec.node(), objective=LATENCY),
    "node-oversubscribed": lambda: _custom(512, RH.HierarchySpec.node()),
    "node-refine-rounds-0": lambda: _custom(
        256, RH.HierarchySpec.node(refine_rounds=0)),
}


def _with(case, **kw):
    g, alloc, cfg, w = case
    return g, alloc, dataclasses.replace(cfg, **kw), w


def _levels_keys(res):
    return [set(lv) for lv in res.stats["levels"]]


@pytest.mark.parametrize("case", list(CASES))
def test_map_matches_reference(case):
    g, alloc, rcfg, w = CASES[case]()
    latency = "latency_max" in (rcfg.objective if isinstance(
        rcfg.objective, tuple) else (rcfg.objective,))
    host = RPipeline(dataclasses.replace(
        rcfg, score_backend="numpy", partition_backend="numpy")
    ).map(g, alloc, task_weights=w)
    rfused = RPipeline(dataclasses.replace(
        rcfg, score_backend="jax", partition_backend="jax")
    ).map(g, alloc, task_weights=w)
    pg, pa = compat.taskgraph(g), compat.allocation(alloc)
    fused = MappingPipeline(_port_config(rcfg)).map(pg, pa, task_weights=w)
    staged = MappingPipeline(_port_config(rcfg, fused="off")).map(
        pg, pa, task_weights=w)
    numpy_ = MappingPipeline(dataclasses.replace(
        _port_config(rcfg), partition_backend="numpy",
        score_backend="numpy")).map(pg, pa, task_weights=w)

    top_swap = rcfg.hierarchy.levels[-1].refine_mode == "swap"
    assert bool(fused.stats.get("fused_refine")) == \
        bool(rfused.stats.get("fused_refine"))
    if top_swap and g.n >= alloc.n:
        assert fused.stats["fused_refine"] is True
        assert fused.stats["fused_score_backend"] == "torch"
    assert "fused_refine" not in staged.stats
    for res in (rfused, fused, staged, numpy_):
        assert np.array_equal(res.task_to_proc, host.task_to_proc), case
        assert res.rotation == host.rotation
    # the port's own paths agree bit for bit, and its all-numpy path
    # equals the reference's
    assert fused.stats["refine_history"] == staged.stats["refine_history"]
    assert numpy_.stats["refine_history"] == host.stats["refine_history"]
    for k in ("refine_rounds_run", "refine_accepted", "refine_evaluated"):
        assert fused.stats[k] == staged.stats[k] == host.stats[k], k
    if latency:
        _hist_close(fused.stats["refine_history"],
                    host.stats["refine_history"], LAT_RTOL)
        _hist_close(fused.stats["refine_history"],
                    rfused.stats["refine_history"], LAT_RTOL)
    else:
        assert fused.stats["refine_history"] == \
            host.stats["refine_history"] == rfused.stats["refine_history"]
        assert fused.score == host.score
    # the same stats schema, level by level
    assert set(fused.stats) == set(rfused.stats)
    assert set(staged.stats) == set(host.stats) == set(numpy_.stats)
    assert _levels_keys(fused) == _levels_keys(rfused)
    assert _levels_keys(staged) == _levels_keys(host)
    assert fused.stats["depth"] == rcfg.hierarchy.depth
    assert fused.stats["partition_backend"] == "torch"
    for lv in fused.stats["levels"]:
        _monotone(lv.get("refine_history", []))
    for key in ("nclusters", "nrouters", "cores_per_node", "intra_volume",
                "sweep_points", "flat_sweep_points", "coarsen_points"):
        assert fused.stats[key] == host.stats[key], key
    assert {"coarsen_s", "refine_s", "total_s"} <= set(fused.stats["timings"])


def test_lognormal_volumes_differ_in_the_last_bit_on_the_reference():
    """WeightedHops on a random graph (lognormal volumes): the reference's
    fused and host refinements give the same assignment with histories
    that differ in the last bit; the port's two paths stay as close."""
    g, alloc, rcfg, _ = _scenario("random-xk7_sparse-node-wh", scale=1024)
    host = RPipeline(dataclasses.replace(rcfg, score_backend="numpy")
                     ).map(g, alloc)
    rfused = RPipeline(dataclasses.replace(
        rcfg, score_backend="jax", partition_backend="jax")).map(g, alloc)
    assert rfused.stats["fused_refine"] is True
    assert np.array_equal(rfused.task_to_proc, host.task_to_proc)
    assert rfused.stats["refine_history"] != host.stats["refine_history"]
    _hist_close(rfused.stats["refine_history"], host.stats["refine_history"],
                LOGNORMAL_RTOL)
    pg, pa = compat.taskgraph(g), compat.allocation(alloc)
    fused = MappingPipeline(_port_config(rcfg)).map(pg, pa)
    staged = MappingPipeline(_port_config(rcfg, fused="off")).map(pg, pa)
    assert fused.stats["fused_refine"] is True
    for res in (fused, staged):
        assert np.array_equal(res.task_to_proc, host.task_to_proc)
        _hist_close(res.stats["refine_history"],
                    host.stats["refine_history"], LOGNORMAL_RTOL)


def test_map_spans_and_fused_refinement_reads():
    g, alloc, rcfg, _ = _scenario("minighost-xk7_sparse-node-wh")
    pipe = MappingPipeline(_port_config(rcfg))
    assert isinstance(pipe._fused, FusedSweep)
    obs.reset()
    res = pipe.map(compat.taskgraph(g), compat.allocation(alloc))
    spans = {s.name: s for s in obs.finished(res.stats["trace_id"])}
    assert {"pipeline.map", "pipeline.coarsen", "pipeline.fused",
            "pipeline.refine"} <= set(spans)
    attrs = spans["pipeline.fused"].attrs
    # one copy a round that ran, one for the result
    rounds = rcfg.hierarchy.levels[-1].refine_rounds
    assert attrs["refine_host_reads"] == \
        min(res.stats["refine_rounds_run"] + 1, rounds) + 1
    assert spans["pipeline.map"].attrs["device"] == "cpu"
    # the expansion to cores ran on the pipeline's device
    assert spans["hier.assign_cores"].attrs["path"] == "cpu"


def test_depth3_top_sweep_is_staged_under_the_map_span():
    """A ``qap`` top level (``with_depth(3)``) sweeps on the staged path:
    ``pipeline.partition`` then ``pipeline.score`` under ``pipeline.map``,
    no ``pipeline.fused``, and both expansions on the pipeline's device
    under ``pipeline.refine``."""
    g, alloc, rcfg, _ = _scenario("minighost-xk7_sparse-depth3-wh")
    assert rcfg.hierarchy.levels[-1].refine_mode == "qap"
    pipe = MappingPipeline(_port_config(rcfg))
    assert isinstance(pipe._fused, FusedSweep)
    obs.reset()
    res = pipe.map(compat.taskgraph(g), compat.allocation(alloc))
    spans = obs.finished(res.stats["trace_id"])
    by_id = {s.span_id: s for s in spans}
    parent = {s.name: by_id[s.parent_id].name for s in spans
              if s.parent_id in by_id}
    names = [s.name for s in spans]
    assert "pipeline.fused" not in names
    assert parent["pipeline.partition"] == parent["pipeline.score"] \
        == "pipeline.map"
    part = next(s for s in spans if s.name == "pipeline.partition")
    score = next(s for s in spans if s.name == "pipeline.score")
    assert part.t0 <= score.t0
    assert set(res.stats["timings"]) >= {"partition_s", "score_s"}
    assert "fused_s" not in res.stats["timings"]
    top = res.stats["levels"][-1]
    assert top["map_s"] == (res.stats["timings"]["partition_s"]
                            + res.stats["timings"]["score_s"])
    assigns = [s for s in spans if s.name == "hier.assign_cores"]
    assert len(assigns) == 2
    for s in assigns:
        assert by_id[s.parent_id].name == "pipeline.refine"
        assert s.attrs["path"] == "cpu"


@pytest.mark.parametrize("hierarchy", ["node", "depth3"])
def test_service_serves_hierarchical_requests(hierarchy):
    ref = RSV.get_scenario(f"homme-bgq_block-{hierarchy}-latency",
                           scale=512, rotations=4).request()
    want = RPipeline(ref.config).map(ref.graph, ref.alloc)
    req = compat.mapping_request(ref, device="cpu")
    req = dataclasses.replace(req, config=dataclasses.replace(
        req.config, score_backend="torch"))
    svc = MappingService()
    resp = svc.map(req)
    assert resp.status == "cold"
    assert np.array_equal(resp.result.task_to_proc, want.task_to_proc)
    assert resp.result.stats["hierarchy"] == hierarchy
    assert svc.map(req).status == "warm"


def test_latency_score_is_the_coarse_graphs_as_in_the_reference():
    """A latency objective's hierarchical score is the coarse graph's:
    every coarse message routes on core row 0 of the router's link
    tables, where the fine mapping spreads its messages over its cores'
    rows, so it is not the fine mapping's latency (the reference
    reports the same number).  WeightedHops ignores the core dims and
    agrees."""
    from repro_torch.core import evaluate
    ref = RSV.get_scenario("minighost-xk7_sparse-node-latency", scale=4096,
                           rotations=4).request()
    want = RPipeline(dataclasses.replace(ref.config, score_backend="numpy")
                     ).map(ref.graph, ref.alloc)
    port = compat.mapping_request(ref, device="cpu")
    got = MappingPipeline(dataclasses.replace(
        port.config, partition_backend="numpy", score_backend="numpy")
    ).map(port.graph, port.alloc)
    assert got.score == want.score
    fine = evaluate(port.graph, port.alloc, got)
    assert fine["latency_max"] < got.score / 4
    assert fine["weighted_hops"] == got.stats["refine_history"][-1][1]
