"""The one-pass rotation sweep (``mapping/fused.py``) on the CPU: the port's
pipeline with the device partitioner and the torch scorer (the fused
path) against the reference's all-numpy pipeline and the reference's
fused program (``partition_backend="jax"``, ``score_backend="jax"``) on
``tests/test_partition_jax.py``'s mesh problem, both objectives and
Hilbert: the same winner, rotation and ``task_to_proc``, the score within
``rtol=1e-5``.  Also: ineligible stacks take the staged path with the
device partitioner, ``fused="off"`` serves the same answer, task weights,
the fault site, a default-config ``MappingService`` on the CPU
serving the reference's answer, and the ``refine=`` keyword (the
hierarchy's device swap refinement) against the host ``refine_swaps``
and the reference's fused program.
"""

import dataclasses

import numpy as np
import pytest

import repro.serve as RSV
from repro.mapping.pipeline import MappingPipeline as RPipeline
from repro.mapping.pipeline import PipelineConfig as RConfig
from repro_torch import compat, faults
from repro_torch.mapping import MappingPipeline, PipelineConfig
from repro_torch.serve import MappingService, get_scenario, make_request

OBJECTIVES = ["weighted_hops", ("latency_max", "weighted_hops")]


def _mesh_problem():
    """(reference graph, alloc), (port graph, alloc): a 64-task 2D logical
    mesh on an 8x8 TPU v5e pod slice."""
    from repro.core import block_allocation, logical_mesh_graph, tpu_v5e_pod
    machine = tpu_v5e_pod(side=8)
    alloc = block_allocation(machine)
    graph = logical_mesh_graph((8, 8), (8.0, 64.0), ("data", "model"))
    return (graph, alloc), (compat.taskgraph(graph),
                            compat.allocation(alloc))


def _port(**kw):
    return MappingPipeline(PipelineConfig(
        partition_backend="torch", score_backend="torch", device="cpu",
        **kw))


def _assert_same(ref, got, rtol=1e-5):
    assert np.array_equal(ref.task_to_proc, got.task_to_proc)
    assert ref.rotation == got.rotation
    assert np.isclose(ref.score, got.score, rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("sfc", ["FZ", "H"])
def test_fused_pipeline_matches_reference(objective, sfc):
    (rg, ra), (pg, pa) = _mesh_problem()
    base = RPipeline(RConfig(rotations=4, objective=objective, sfc=sfc)
                     ).map(rg, ra)
    rfused = RPipeline(RConfig(rotations=4, objective=objective, sfc=sfc,
                               score_backend="jax",
                               partition_backend="jax")).map(rg, ra)
    assert rfused.stats.get("fused") is True
    pipe = _port(rotations=4, objective=objective, sfc=sfc)
    assert pipe._fused is not None
    got = pipe.map(pg, pa)
    assert got.stats["fused"] is True
    assert got.stats["fused_score_backend"] == "torch"
    assert got.stats["partition_backend"] == "torch"
    assert set(got.stats["timings"]) == {"fused_s", "total_s"}
    assert got.stats["levels"][0]["map_s"] == got.stats["timings"]["fused_s"]
    assert got.task_to_proc.dtype == np.int32
    _assert_same(base, got)
    _assert_same(rfused, got)
    assert got.stats["winner_index"] == rfused.stats["winner_index"]


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fused_off_serves_the_same_answer_staged(objective):
    (_, _), (pg, pa) = _mesh_problem()
    fused = _port(rotations=6, objective=objective).map(pg, pa)
    staged_pipe = _port(rotations=6, objective=objective, fused="off")
    assert staged_pipe._fused is None
    staged = staged_pipe.map(pg, pa)
    assert "fused" not in staged.stats
    assert {"partition_s", "score_s"} <= set(staged.stats["timings"])
    assert staged.stats["partition_backend"] == "torch"
    _assert_same(staged, fused, rtol=0)


@pytest.mark.parametrize("scenario", [
    "minighost-xk7_sparse-flat-wh", "homme-bgq_block-flat-latency",
    "random-fat_tree-flat-latency", "homme-tpu_mesh-flat-wh"])
def test_registry_scenarios_with_task_weights_match_reference(scenario):
    """Task weights take the weighted cuts (segscan's plain version on
    the CPU) inside the fused sweep."""
    ref = RSV.get_scenario(scenario, scale=512, rotations=8).request()
    w = np.random.default_rng(0).uniform(0.5, 2.0, size=ref.graph.n)
    want = RPipeline(ref.config).map(ref.graph, ref.alloc, task_weights=w)
    port = compat.mapping_request(ref, device="cpu")
    cfg = dataclasses.replace(port.config, partition_backend="torch",
                              score_backend="torch")
    got = MappingPipeline(cfg).map(port.graph, port.alloc, task_weights=w)
    assert got.stats["fused"] is True
    _assert_same(want, got)


def test_ineligible_stacks_take_the_staged_path_on_the_device_partitioner():
    (rg, ra), (pg, pa) = _mesh_problem()
    # one candidate (rotations=0): nothing to select
    want = RPipeline(RConfig()).map(rg, ra)
    got = _port().map(pg, pa)
    assert "fused" not in got.stats
    assert got.stats["partition_backend"] == "torch"
    assert "partition_s" in got.stats["timings"]
    _assert_same(want, got)
    # fewer tasks than processors: the closest-subset path
    sub = compat.taskgraph(rg)
    sub.coords = sub.coords[:40]
    sub.edges = sub.edges[(sub.edges < 40).all(axis=1)]
    sub.weights = None
    got = _port(rotations=4).map(sub, pa)
    assert "fused" not in got.stats
    ref = dataclasses.replace(rg, coords=rg.coords[:40], edges=sub.edges,
                              weights=None)
    _assert_same(RPipeline(RConfig(rotations=4)).map(ref, ra), got)
    # no messages: every candidate scores zero
    empty = dataclasses.replace(pg, edges=np.zeros((0, 2), np.int64),
                                weights=None)
    got = _port(rotations=4).map(empty, pa)
    assert "fused" not in got.stats
    # the numpy host engine never takes the fused path
    pipe = MappingPipeline(PipelineConfig(
        rotations=4, partition_backend="numpy", score_backend="torch",
        device="cpu"))
    assert pipe._fused is None and pipe.order_backend == "vectorized"


def test_fused_fault_site_fires():
    (_, _), (pg, pa) = _mesh_problem()
    pipe = _port(rotations=4)
    with faults.injected("fused", "error", count=1):
        with pytest.raises(faults.InjectedFault):
            pipe.map(pg, pa)
    assert pipe.map(pg, pa).stats["fused"] is True


@pytest.mark.parametrize("name", ["minighost-xk7_sparse-flat-latency",
                                  "random-tpu_mesh-flat-wh"])
def test_default_config_service_serves_the_reference_answer(name):
    """A service request with the default config but for the device
    (``cpu``) and the CPU scorer: device partitioner, fused sweep."""
    ref = RSV.get_scenario(name, scale=1024, rotations=8).request()
    r = RSV.MappingService().map(ref)
    port = compat.mapping_request(ref, device="cpu")
    req = make_request(port.graph, port.alloc,
                       config=dataclasses.replace(
                           PipelineConfig(), objective=port.config.objective,
                           rotations=8, score_backend="torch",
                           device="cpu"))
    assert req.config.partition_backend == "torch"
    own = get_scenario(name, scale=1024, rotations=8, score_backend="torch",
                       device="cpu").request()
    assert own.config == req.config
    p = MappingService().map(req)
    assert p.status == "cold"
    assert p.result.stats["fused"] is True
    _assert_same(r.result, p.result, rtol=1e-4)


@pytest.mark.parametrize("partition_backend", ["numpy", "torch"])
def test_staged_sweep_assignments_match_map_candidates(partition_backend):
    """Both engines assemble the sweep through one plan and one gather:
    the staged torch path keeps the (ncand, tnum) assignments as a tensor
    (on the pipeline's device), equal to ``map_candidates``' rows and to
    the reference's."""
    import torch

    from repro_torch.mapping.candidates import rotation_candidates
    (rg, ra), (pg, pa) = _mesh_problem()
    pipe = MappingPipeline(PipelineConfig(
        rotations=6, partition_backend=partition_backend,
        score_backend="torch", device="cpu", fused="off"))
    pc = pipe.machine_coords(pa)
    tc = pg.coords.astype(np.float64)
    cands = rotation_candidates(tc.shape[1], pc.shape[1], 6)
    plan = pipe.sweep_plan(tc, pc, cands)
    assert len(plan.task["dim_orders"]) * len(plan.proc["dim_orders"]) \
        >= len(cands) > len(plan.task["dim_orders"])
    t2p = pipe._sweep_t2p(plan)
    assert isinstance(t2p, torch.Tensor) and t2p.dtype == torch.int64
    rows = [r.task_to_proc for r in pipe.map_candidates(tc, pc, cands)]
    assert all(r.dtype == np.int32 for r in rows)
    assert np.array_equal(t2p.numpy(), np.stack(rows))
    ref = RPipeline(RConfig(rotations=6)).map_candidates(
        tc, RPipeline(RConfig()).machine_coords(ra), cands)
    assert np.array_equal(np.stack([r.task_to_proc for r in ref]),
                          np.stack(rows))
    search = pipe.search
    assert np.array_equal(search.score_assignments(pg, pa, t2p),
                          search.score(pg, pa, pipe.map_candidates(
                              tc, pc, cands)))


def test_assign_parts_reports_parts_without_a_processor():
    import torch

    from repro_torch.mapping.pipeline import assign_parts, missing_parts
    mu_t = torch.tensor([[0, 1, 2, 2], [2, 1, 0, 0]])
    mu_p = torch.tensor([[2, 0, 1], [1, 2, 0]])
    sel = torch.tensor([0, 1])
    t2p, ptp = assign_parts(mu_t, mu_p, sel, sel.flip(0))
    assert torch.equal(ptp, torch.tensor([[1, 2, 0], [2, 0, 1]]))
    assert torch.equal(t2p, torch.tensor([[2, 0, 1, 1], [0, 2, 1, 1]]))
    _, ptp = assign_parts(mu_t, torch.tensor([[2, 0, 0]]), sel[:1],
                          sel[:1])
    assert int(ptp.min()) < 0
    with pytest.raises(ValueError, match=r"parts with no processor: \[1\]"):
        raise missing_parts(ptp)



def _coarse_problem():
    """(reference coarse graph, router alloc), (port ones): 256 stencil
    tasks contracted onto the 64 routers of a fragmented allocation of
    an (8, 4, 4) Gemini torus, with integer volumes."""
    import repro.hier as RH
    from repro.core import gemini_xk7, sfc_allocation, stencil_graph
    alloc = sfc_allocation(gemini_xk7(dims=(8, 4, 4), cores_per_node=4),
                           256, nfragments=2, seed=3)
    g = stencil_graph((16, 4, 4))
    g.weights = np.random.default_rng(0).integers(1, 9, len(g.edges)) * 1.0
    _, _, ralloc = RH.router_view(alloc)
    coarse = RH.aggregate_tasks(g, ralloc.n).coarse
    return (coarse, ralloc), (compat.taskgraph(coarse),
                              compat.allocation(ralloc))


def _refine_inputs(pipe, graph, alloc):
    from repro_torch.mapping.candidates import rotation_candidates
    pc = pipe.machine_coords(alloc)
    tc = np.asarray(graph.coords, dtype=np.float64)
    return tc, pc, rotation_candidates(tc.shape[1], pc.shape[1], 4)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_refine_keyword_folds_in_the_host_swap_pass(objective):
    """``run(..., refine=)``: the sweep's winner refined on the device
    equals the host ``refine_swaps`` from that winner and the reference's
    fused program with the same spec (histories: bit for bit for the
    integer volumes of WeightedHops, ``rtol=1e-6`` for the latency
    scored from float32 volumes)."""
    from repro.hier import refine_swaps as rrefine
    from repro.mapping.candidates import rotation_candidates as rrot
    from repro_torch.hier import refine_swaps
    (rg, ra), (pg, pa) = _coarse_problem()
    spec = dict(rounds=3, top=16, degree=4)
    pipe = _port(rotations=4, objective=objective)
    tc, pc, cands = _refine_inputs(pipe, pg, pa)
    plain = pipe._fused.run(pg, pa, tc, pc, cands)
    got = pipe._fused.run(pg, pa, tc, pc, cands, refine=spec)
    assert "fused_refine" not in plain.stats
    assert got.stats["fused_refine"] is True
    assert got.stats["winner_index"] == plain.stats["winner_index"]
    assert got.rotation == plain.rotation
    want_c, want = refine_swaps(
        pa.machine, pg, pa.coords, plain.task_to_proc,
        objective=pipe.search.objective, score_backend="torch",
        device="cpu", **spec)
    assert want["refine_accepted"] > 0
    assert np.array_equal(got.task_to_proc, want_c)
    assert got.task_to_proc.dtype == np.int32
    for k, v in want.items():
        assert got.stats[k] == v, k
    assert got.score == want["refine_final"]

    rpipe = RPipeline(RConfig(rotations=4, objective=objective,
                              score_backend="jax", partition_backend="jax"))
    rfused = rpipe._fused.run(rg, ra, tc, pc, rrot(3, 3, 4), refine=spec)
    assert np.array_equal(rfused.task_to_proc, got.task_to_proc)
    assert rfused.stats["refine_accepted"] == got.stats["refine_accepted"]
    for x, y in zip(rfused.stats["refine_history"],
                    got.stats["refine_history"]):
        assert np.allclose(x, y, rtol=1e-6 if len(x) > 1 else 0, atol=0)
    host_c, _ = rrefine(ra.machine, rg, ra.coords, plain.task_to_proc,
                        objective=pipe.search.objective, **spec)
    assert np.array_equal(host_c, got.task_to_proc)


def test_refine_keyword_only_refines_a_bijection():
    """More tasks than processors: the sweep still runs, the refinement
    is left to the caller's host pass (no ``fused_refine``)."""
    from repro.core import logical_mesh_graph
    (_, _), (_, pa) = _mesh_problem()
    g = compat.taskgraph(logical_mesh_graph((16, 8), (8.0, 64.0),
                                            ("data", "model")))
    pipe = _port(rotations=4)
    tc, pc, cands = _refine_inputs(pipe, g, pa)
    res = pipe._fused.run(g, pa, tc, pc, cands,
                          refine=dict(rounds=2, top=8, degree=4))
    assert res.stats["fused"] is True
    assert "fused_refine" not in res.stats
    assert np.bincount(res.task_to_proc, minlength=pa.n).max() == 2
