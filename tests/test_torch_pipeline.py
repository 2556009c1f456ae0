"""The slice as a whole, on the CPU: ``MappingPipeline.map`` and
``MappingService.map`` of the port against the reference package on flat
scenarios of the registry.  Every problem is built once through the
reference's scenario registry (numpy, from a seed), carried over with
``repro_torch.compat`` and run through both packages: ``task_to_proc``
must be equal bit for bit, the score within ``rtol=1e-4``, statuses and
signatures equal; a node and a depth-3 request serve the reference's
answer.  Also: what the slice refuses (an unknown partition backend,
the card when there is none) and the rule that the port imports
neither ``jax`` nor the reference package.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import repro.serve as RSV
from repro.mapping import MappingPipeline as RPipeline
from repro_torch import compat, faults, obs
from repro_torch.core import (Mapper, MapperConfig, evaluate,
                              geometric_map, identity_mapping)
from repro_torch.mapping import (HierarchySpec, MappingPipeline,
                                 PipelineConfig, shared_pipeline)
from repro_torch.serve import (MappingService, ServiceOverloaded,
                               all_scenarios, get_scenario, make_request,
                               scenario_names)

ROOT = pathlib.Path(__file__).resolve().parents[1]

FLAT_SCENARIOS = [
    "minighost-xk7_sparse-flat-wh",
    "minighost-xk7_sparse-flat-latency",
    "homme-bgq_block-flat-latency",
    "random-tpu_mesh-flat-wh",
    "random-fat_tree-flat-latency",
    "homme-tpu_mesh-flat-wh",
    "minighost-bgq_block-flat-wh",
    "random-xk7_sparse-flat-latency",
]
SCALE, ROTATIONS = 1024, 8


def _pair(name, backend):
    """The scenario as (reference request, port request on the CPU)."""
    ref = RSV.get_scenario(name, scale=SCALE, rotations=ROTATIONS).request()
    ref.config.score_backend = "numpy"
    port = compat.mapping_request(ref, device="cpu")
    port.config.score_backend = backend
    return ref, port


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("name", FLAT_SCENARIOS)
def test_pipeline_map_equals_reference(name, backend):
    ref, port = _pair(name, backend)
    r = RPipeline(ref.config).map(ref.graph, ref.alloc)
    p = MappingPipeline(port.config).map(port.graph, port.alloc)
    assert np.array_equal(r.task_to_proc, p.task_to_proc)
    assert p.rotation == r.rotation
    assert np.isclose(p.score, r.score, rtol=1e-4)
    assert p.stats["hierarchy"] == "flat" and p.stats["schema"] == 2
    assert p.stats["sweep_points"] == r.stats["sweep_points"]
    assert set(p.stats["timings"]) == {"partition_s", "score_s", "total_s"}
    assert "degraded" not in p.stats


@pytest.mark.parametrize("name", FLAT_SCENARIOS)
def test_service_map_equals_reference(name):
    ref, port = _pair(name, "torch")
    r = RSV.MappingService().map(ref)
    svc = MappingService()
    p = svc.map(port)
    assert (p.status, r.status) == ("cold", "cold")
    assert np.array_equal(r.result.task_to_proc, p.result.task_to_proc)
    assert np.isclose(p.result.score, r.result.score, rtol=1e-4)
    again = svc.map(port)
    assert again.status == "warm"
    assert again.result is p.result
    assert svc.stats()["cold"] == 1 and svc.stats()["warm"] == 1


@pytest.mark.parametrize("name", FLAT_SCENARIOS)
def test_request_signatures_equal(name):
    ref, port = _pair(name, "numpy")
    assert port.signature() == ref.signature()
    # the port's own registry builds the same problem from the same seed
    own = get_scenario(name, scale=SCALE, rotations=ROTATIONS,
                       score_backend="numpy", partition_backend="numpy",
                       device="cpu").request()
    assert own.signature() == ref.signature()
    assert np.array_equal(own.graph.edges, ref.graph.edges)
    assert np.array_equal(own.alloc.coords, ref.alloc.coords)


def test_map_many_coalesces_batch_duplicates():
    _, a = _pair(FLAT_SCENARIOS[0], "torch")
    _, b = _pair(FLAT_SCENARIOS[3], "torch")
    _, a2 = _pair(FLAT_SCENARIOS[0], "torch")
    svc = MappingService()
    out = svc.map_many([a, b, a2])
    assert [r.status for r in out] == ["cold", "cold", "coalesced"]
    assert out[2].result is out[0].result
    assert svc.stats()["coalesced"] == 1


def test_concurrent_duplicates_share_one_computation():
    import threading
    _, req = _pair(FLAT_SCENARIOS[1], "torch")
    gate = threading.Event()
    calls = []

    class Slow(MappingService):
        def _compute(self, request):
            calls.append(1)
            gate.wait(5)
            return super()._compute(request)

    svc = Slow()
    out = []
    threads = [threading.Thread(target=lambda: out.append(svc.map(req)))
               for _ in range(3)]
    for th in threads:
        th.start()
    while svc.stats()["inflight"] == 0:
        pass
    gate.set()
    for th in threads:
        th.join()
    assert len(calls) == 1
    assert sorted(r.status for r in out) == ["coalesced", "coalesced",
                                             "cold"]


def test_compute_error_propagates_no_ladder():
    """A failing scorer is not papered over by a slower rung."""
    _, req = _pair(FLAT_SCENARIOS[0], "torch")
    svc = MappingService()
    with faults.injected("score.torch", "error", count=1):
        with pytest.raises(faults.InjectedFault):
            svc.map(req)
    assert svc.stats()["inflight"] == 0 and svc.stats()["cold"] == 0
    assert svc.map(req).status == "cold"  # nothing was cached or poisoned


def test_bounded_admission_sheds():
    import threading
    _, req = _pair(FLAT_SCENARIOS[0], "numpy")
    _, other = _pair(FLAT_SCENARIOS[3], "numpy")
    gate = threading.Event()

    class Blocked(MappingService):
        def _compute(self, request):
            gate.wait(5)
            return super()._compute(request)

    svc = Blocked(max_inflight=1, max_queue=0)
    th = threading.Thread(target=lambda: svc.map(req))
    th.start()
    while svc.stats()["inflight"] == 0:
        pass
    with pytest.raises(ServiceOverloaded):
        svc.map(other)
    gate.set()
    th.join()
    assert svc.stats()["shed"] == 1


def test_spans_and_counters_of_a_cold_request():
    _, req = _pair(FLAT_SCENARIOS[1], "torch")
    obs.reset()
    resp = MappingService().map(req)
    names = {s.name for s in obs.finished()
             if s.trace_id == resp.trace_id}
    assert {"serve.request", "pipeline.map", "pipeline.partition",
            "pipeline.score", "score.torch"} <= names
    snap = obs.snapshot()
    assert snap["counters"]["serve.responses.cold"] >= 1
    assert "mapscore_hopper" in snap and "launches" in \
        snap["mapscore_hopper"]


def test_registry_is_the_full_cross_product():
    names = scenario_names()
    assert names == RSV.scenario_names()
    assert len(all_scenarios(device="cpu", score_backend="torch")) == \
        len(names)
    with pytest.raises(ValueError, match="unknown workload"):
        get_scenario("nope-tpu_mesh-flat-wh")


@pytest.mark.parametrize("hier", ["node", "depth3"])
def test_non_flat_hierarchy_serves_the_reference_answer(hier):
    ref = RSV.get_scenario(f"minighost-xk7_sparse-{hier}-wh",
                           scale=256).request()
    want = RPipeline(ref.config).map(ref.graph, ref.alloc)
    req = get_scenario(f"minighost-xk7_sparse-{hier}-wh", scale=256,
                       score_backend="torch", device="cpu").request()
    assert not req.config.hierarchy.is_flat
    got = MappingPipeline(req.config).map(req.graph, req.alloc)
    resp = MappingService().map(req)
    assert resp.status == "cold"
    for res in (got, resp.result):
        assert np.array_equal(res.task_to_proc, want.task_to_proc)
        assert res.rotation == want.rotation
        assert res.stats["refine_history"] == want.stats["refine_history"]
        assert res.stats["hierarchy"] == hier


def test_device_partitioner_and_fused_modes():
    from repro_torch.mapping.fused import FusedSweep
    with pytest.raises(ValueError, match="unknown partition backend"):
        MappingPipeline(PipelineConfig(partition_backend="jax",
                                       score_backend="torch", device="cpu"))
    with pytest.raises(ValueError, match="unknown fused mode"):
        MappingPipeline(PipelineConfig(fused="on", score_backend="torch",
                                       device="cpu"))
    auto = MappingPipeline(PipelineConfig(
        partition_backend="torch", fused="auto", score_backend="torch",
        device="cpu"))
    assert isinstance(auto._fused, FusedSweep)
    assert auto.order_backend == "torch"
    off = MappingPipeline(PipelineConfig(
        partition_backend="torch", fused="off", score_backend="torch",
        device="cpu"))
    assert off._fused is None and off.order_backend == "torch"


def test_device_rule_defaults_and_refusals():
    cfg = PipelineConfig()
    assert (cfg.device, cfg.score_backend, cfg.partition_backend) == \
        ("cuda", "hopper", "torch")
    assert MapperConfig().device == "cuda"
    assert MapperConfig().partition_backend == "torch"
    with pytest.raises(ValueError, match="hopper"):
        MappingPipeline(PipelineConfig(device="cpu"))
    with pytest.raises(ValueError, match="unknown scoring backend"):
        MappingPipeline(PipelineConfig(score_backend="pallas",
                                       device="cpu"))
    with pytest.raises(ValueError, match="unknown hierarchy"):
        PipelineConfig(hierarchy="tree")
    if not torch.cuda.is_available():
        for backend in ("hopper", "torch", "numpy"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                MappingPipeline(PipelineConfig(score_backend=backend))


def test_shared_pipeline_is_keyed_by_content_and_device():
    a = shared_pipeline(PipelineConfig(rotations=3, score_backend="torch",
                                       device="cpu"))
    b = shared_pipeline(PipelineConfig(rotations=3, score_backend="torch",
                                       device="cpu"))
    c = shared_pipeline(PipelineConfig(rotations=4, score_backend="torch",
                                       device="cpu"))
    assert a is b and a is not c


def test_mapper_adapter_equals_reference():
    import repro.core as R
    ref, port = _pair(FLAT_SCENARIOS[0], "numpy")
    r = R.Mapper(R.MapperConfig(rotations=4)).map(ref.graph, ref.alloc)
    p = Mapper(MapperConfig(rotations=4, score_backend="torch",
                            device="cpu")).map(port.graph, port.alloc)
    assert np.array_equal(r.task_to_proc, p.task_to_proc)
    g1 = R.geometric_map(ref.graph.coords, ref.alloc.coords[:, :3],
                         task_perm=(1, 0, 2))
    g2 = geometric_map(port.graph.coords, port.alloc.coords[:, :3],
                       task_perm=(1, 0, 2))
    assert np.array_equal(g1.task_to_proc, g2.task_to_proc)
    e1 = R.evaluate(ref.graph, ref.alloc, r)
    e2 = evaluate(port.graph, port.alloc, p)
    assert e1["total_hops"] == e2["total_hops"]
    assert np.isclose(e1["latency_max"], e2["latency_max"])
    assert np.array_equal(
        identity_mapping(port.graph, port.alloc).task_to_proc,
        R.identity_mapping(ref.graph, ref.alloc).task_to_proc)


def test_make_request_objective_aliases():
    _, port = _pair(FLAT_SCENARIOS[0], "numpy")
    req = make_request(port.graph, port.alloc, "latency", rotations=2,
                       score_backend="torch", device="cpu")
    assert req.config.objective == ("latency_max", "weighted_hops")
    assert req.config.hierarchy == HierarchySpec.flat()
    with pytest.raises(ValueError, match="not both"):
        make_request(port.graph, port.alloc, config=req.config, rotations=3)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, \
            (path, roots)
        text = path.read_text()
        assert "import_module(\"repro." not in text
        assert "import_module('jax" not in text
