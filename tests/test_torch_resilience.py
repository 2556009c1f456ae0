"""The service's degradation ladder (``repro_torch.serve.resilience`` and
the ladder half of ``serve/engine.py``) against the reference
(``repro.serve.resilience``) on the CPU.

- The breaker state machine and ``BreakerBoard`` run the same cases on
  both packages (each case is parametrised over the two modules).
- A CPU config's ladder has the reference's rungs under the port's
  backend names (``RUNG_NAMES``: ``score_torch`` is the reference's
  ``score_jax``), for flat, node and depth-3 configs; a CUDA config's
  ladder has the same rungs less those that change a backend.  The
  ladder is a pure function of the config, so ``score_backend="hopper"``
  ladders are built here without a card.
- Every injected fault of the reference's service tests is served by the
  corresponding rung, with a permutation equal bit for bit to the
  reference's all-numpy answer to the same scenario and seed; admission,
  failed flights and eviction storms behave as the reference's.
- What the ladder must not hide: an unreachable ``device="cuda"``,
  ``"hopper"`` on a CPU device and a kernel library that does not build
  raise from ``svc.map`` before any rung runs (no ``serve.compute``
  fire, no rung failure).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.serve as RSV
import repro.serve.resilience as RR
from repro.mapping import HierarchySpec as RSpec
from repro.mapping import PipelineConfig as RConfig
from repro.mapping import shared_pipeline as r_shared_pipeline
from repro_torch import compat, faults, obs
from repro_torch.mapping import (HierarchySpec, PipelineConfig,
                                 shared_pipeline)
from repro_torch.mapping.pipeline import fused_eligible
from repro_torch.serve import (MappingService, ServiceOverloaded,
                               degradation_ladder, rung_key)
from repro_torch.serve import resilience as PR
from repro_torch.serve.engine import ServiceOverloaded as EngineOverloaded

SCALE = 256
BASE = "minighost-xk7_sparse-flat-wh"

# port rung -> reference rung
RUNG_NAMES = {"full": "full", "unfused": "unfused",
              "score_torch": "score_jax", "score_numpy": "score_numpy",
              "partition_numpy": "partition_numpy", "depth_2": "depth_2",
              "refine_0": "refine_0"}
# port backend -> reference backend
SCORE = {"hopper": "pallas", "torch": "jax", "numpy": "numpy"}
PARTITION = {"torch": "jax", "numpy": "numpy"}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# Circuit breakers: one case, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(params=["reference", "port"])
def res(request):
    return {"reference": RR, "port": PR}[request.param]


def test_breaker_state_machine(res):
    clk = _Clock()
    br = res.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=clk)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"        # below threshold
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    assert not br.allow()              # open: requests refused
    clk.t = 10.0
    assert br.state == "half_open"
    assert br.allow()                  # the single probe
    assert not br.allow()              # second prober refused
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_failed_probe_reopens(res):
    clk = _Clock()
    br = res.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
    br.record_failure()
    assert br.state == "open"
    clk.t = 5.0
    assert br.allow()                  # probe
    br.record_failure()                # probe failed
    assert br.state == "open" and br.opens == 2
    clk.t = 9.9
    assert not br.allow()              # new cooldown window
    assert br.stats() == {"state": "open", "opens": 2, "failures": 2}


def test_breaker_success_resets_consecutive_failures(res):
    br = res.CircuitBreaker(threshold=2, cooldown_s=1.0)
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"        # never two CONSECUTIVE failures
    assert br.failures == 2            # cumulative counter still counts


def test_breaker_threshold_must_be_positive(res):
    with pytest.raises(ValueError, match="threshold"):
        res.CircuitBreaker(threshold=0)


def test_breaker_board_shares_per_key(res):
    board = res.BreakerBoard(threshold=1, cooldown_s=1.0)
    assert board.get("k") is board.get("k")
    assert board.get("k") is not board.get("other")
    board.get("k").record_failure()
    assert board.states()["k"]["state"] == "open"
    assert board.states()["other"]["state"] == "closed"


def test_breaker_trips_are_counted():
    before = obs.snapshot()["counters"].get("serve.breaker_trips", 0)
    br = PR.CircuitBreaker(threshold=1)
    br.record_failure()
    assert obs.snapshot()["counters"]["serve.breaker_trips"] == before + 1


def test_overloaded_moved_and_reexported():
    assert ServiceOverloaded is PR.ServiceOverloaded is EngineOverloaded
    assert issubclass(PR.DeadlineExceeded, TimeoutError)


# ---------------------------------------------------------------------------
# The ladder: the reference's rungs under the port's names
# ---------------------------------------------------------------------------

HIERARCHIES = {"flat": ("flat", "flat"),
               "node": (HierarchySpec.node(), RSpec.node()),
               "depth3": (HierarchySpec.with_depth(3), RSpec.with_depth(3))}


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("partition", ["torch", "numpy"])
@pytest.mark.parametrize("score", ["hopper", "torch", "numpy"])
@pytest.mark.parametrize("hier", sorted(HIERARCHIES))
def test_ladder_rungs_equal_the_reference(hier, score, partition, fused):
    spec, rspec = HIERARCHIES[hier]
    cfg = PipelineConfig(score_backend=score, partition_backend=partition,
                         fused=fused, rotations=4, hierarchy=spec,
                         device="cpu")
    rcfg = RConfig(score_backend=SCORE[score],
                   partition_backend=PARTITION[partition], fused=fused,
                   rotations=4, hierarchy=rspec)
    lad, rlad = degradation_ladder(cfg), RR.degradation_ladder(rcfg)
    assert [RUNG_NAMES[n] for n, _ in lad] == [n for n, _ in rlad]
    assert lad[0][1] is cfg            # the caller's config, untouched
    for (_, c), (_, r) in zip(lad, rlad):
        assert SCORE[c.score_backend] == r.score_backend
        assert PARTITION[c.partition_backend] == r.partition_backend
        assert c.fused == r.fused and c.device == cfg.device
        assert c.hierarchy == compat.hierarchy(r.hierarchy)
    # the terminal rung of every ladder runs on host numpy
    last = lad[-1][1]
    assert (last.score_backend, last.partition_backend) == ("numpy",
                                                            "numpy")


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("partition", ["torch", "numpy"])
@pytest.mark.parametrize("score", ["hopper", "torch", "numpy"])
@pytest.mark.parametrize("hier", sorted(HIERARCHIES))
def test_card_ladder_never_changes_a_backend(hier, score, partition, fused):
    """On a CUDA device the ladder is the reference's less the rungs that
    change a backend: no rung moves the work to a plain version or to
    the host, and the remaining rungs downgrade as the reference's do."""
    spec, rspec = HIERARCHIES[hier]
    cfg = PipelineConfig(score_backend=score, partition_backend=partition,
                         fused=fused, rotations=4, hierarchy=spec,
                         device="cuda")
    rcfg = RConfig(score_backend=SCORE[score],
                   partition_backend=PARTITION[partition], fused=fused,
                   rotations=4, hierarchy=rspec)
    lad = degradation_ladder(cfg)
    rlad = [(n, r) for n, r in RR.degradation_ladder(rcfg)
            if n not in ("score_jax", "score_numpy", "partition_numpy")]
    assert [RUNG_NAMES[n] for n, _ in lad] == [n for n, _ in rlad]
    assert lad[0][1] is cfg
    for (_, c), (_, r) in zip(lad, rlad):
        assert (c.score_backend, c.partition_backend, c.device) == (
            score, partition, "cuda")
        assert c.fused == r.fused
        assert c.hierarchy == compat.hierarchy(r.hierarchy)


def test_full_accelerator_ladder():
    cfg = PipelineConfig(rotations=4, hierarchy=HierarchySpec.node())
    assert [n for n, _ in degradation_ladder(cfg)] == [
        "full", "unfused", "refine_0"]
    assert all((c.score_backend, c.partition_backend, c.device)
               == ("hopper", "torch", "cuda")
               for _, c in degradation_ladder(cfg))
    last = degradation_ladder(cfg)[-1][1]
    assert (last.fused, last.hierarchy.refine_rounds_total) == ("off", 0)
    cpu = dataclasses.replace(cfg, device="cpu")
    assert [n for n, _ in degradation_ladder(cpu)] == [
        "full", "unfused", "score_torch", "score_numpy", "partition_numpy",
        "refine_0"]
    d = dict(degradation_ladder(cpu))
    assert d["score_torch"].device == "cpu"    # same device, plain scorer


def test_deep_hierarchy_gets_depth_rung():
    cfg = PipelineConfig(rotations=4, score_backend="numpy",
                         partition_backend="numpy",
                         hierarchy=HierarchySpec.with_depth(3))
    names = [n for n, _ in degradation_ladder(cfg)]
    assert names == ["full", "depth_2", "refine_0"]
    d2 = dict(degradation_ladder(cfg))["depth_2"]
    assert d2.hierarchy.depth == 2
    assert d2.hierarchy.levels == cfg.hierarchy.levels[:1]


@pytest.mark.parametrize("changes", [
    {}, {"fused": "off"}, {"partition_backend": "numpy"},
    {"score_backend": "numpy"}, {"sweep": "loop"},
    {"backend": "recursive"}, {"score_backend": "torch"}])
def test_fused_candidate_is_the_pipelines_gate(changes):
    """One predicate: the ladder's ``fused_candidate`` and the pipeline's
    fused path agree for every config (resolved on the CPU)."""
    from repro_torch.mapping import MappingPipeline
    cfg = PipelineConfig(**{"score_backend": "torch", "device": "cpu",
                            **changes})
    pipe = MappingPipeline(cfg)
    assert PR.fused_candidate(cfg) is fused_eligible(cfg)
    assert fused_eligible(cfg) is (pipe._fused is not None)


def test_rung_key_resolves_backends_and_device():
    k = rung_key(PipelineConfig(score_backend="torch", device="cpu"))
    assert k == "fused/score=torch/partition=torch/device=cpu"
    k = rung_key(PipelineConfig(score_backend="numpy",
                                partition_backend="numpy", device="cpu",
                                hierarchy=HierarchySpec.node()))
    assert k.startswith("staged/score=numpy/partition=numpy/device=cpu/")
    assert "depth=2" in k
    with pytest.raises(ValueError, match="hopper"):
        rung_key(PipelineConfig(device="cpu"))


# ---------------------------------------------------------------------------
# Service-level degradation against the reference's numpy oracle
# ---------------------------------------------------------------------------

def _pair(name=BASE, seed=0, **port):
    """(reference request, port request on the CPU) of one scenario;
    ``port`` are the port config's fields."""
    ref = RSV.get_scenario(name, scale=SCALE, seed=seed,
                           rotations=4).request()
    req = compat.mapping_request(ref, device="cpu")
    req.config = dataclasses.replace(req.config, **port)
    return ref, req


def _oracle(ref):
    """The reference's all-numpy answer to the same request."""
    cfg = dataclasses.replace(ref.config, score_backend="numpy",
                              partition_backend="numpy", fused="off")
    return r_shared_pipeline(cfg).map(ref.graph, ref.alloc)


def _served_by(resp, ref, rung):
    assert resp.status == "cold"
    assert resp.result.stats["degraded"] == rung
    np.testing.assert_array_equal(resp.result.task_to_proc,
                                  _oracle(ref).task_to_proc)


def test_torch_scorer_fault_degrades_to_numpy_bit_identical():
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="torch", partition_backend="numpy")
        with faults.injected("score.torch", "error", count=1) as spec:
            resp = svc.map(req)
            assert spec.fired == 1
        _served_by(resp, ref, "score_numpy")
        s = svc.stats()
        assert s["degraded"] == 1 and s["rungs"] == {"score_numpy": 1}
        assert s["rung_failures"] == 1


def test_torch_partition_fault_degrades_to_numpy_bit_identical():
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="numpy", partition_backend="torch")
        with faults.injected("partition.torch", "error", count=1) as spec:
            resp = svc.map(req)
            assert spec.fired == 1
        _served_by(resp, ref, "partition_numpy")


@pytest.mark.parametrize("count,rung", [(1, "unfused"), (2, "score_numpy"),
                                        (3, "partition_numpy")])
def test_partition_fault_walks_the_device_rungs(count, rung):
    """The fused sweep partitions on the device too: each rung that runs
    the device partitioner passes its fault site once."""
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="torch", partition_backend="torch")
        assert fused_eligible(req.config)
        with faults.injected("partition.torch", "error",
                             count=count) as spec:
            resp = svc.map(req)
            assert spec.fired == count
        _served_by(resp, ref, rung)
        assert svc.stats()["rung_failures"] == count


def test_the_fused_sweeps_k1_call_passes_the_kernel_fault_site():
    """The fused sweep calls the kernel wrapper's ``mapscore`` directly
    (not the staged ``evaluate_candidates_hopper``); the site fires
    there too, so a fused rung fails on an injected kernel fault.  CPU
    tensors run the plain version behind the same site."""
    from repro_torch.core.machine import make_machine
    from repro_torch.core.metrics_torch import message_inputs
    from repro_torch.kernels.mapscore import ops
    m = make_machine((4, 4), wrap=True, bw=1.0)
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    e, w, inv_bw = message_inputs(m, edges, np.ones(3), True, "cpu")
    stack = torch.randint(0, 4, (2, 4, 2), dtype=torch.int32)
    kw = dict(dims=m.dims, wrap=m.wrap, core_dims=0, traffic=True)
    with faults.isolated():
        with faults.injected("kernel.mapscore", "error", count=1) as spec:
            with pytest.raises(faults.InjectedFault):
                ops.mapscore(stack, e, w, inv_bw, **kw)
            ops.mapscore(stack, e, w, inv_bw, **kw)
            assert (spec.calls, spec.fired) == (2, 1)


def test_device_oom_degrades_and_result_is_valid():
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="torch", partition_backend="numpy")
        with faults.injected("score.torch", "oom", count=1):
            resp = svc.map(req)
        _served_by(resp, ref, "score_numpy")
        t2p = resp.result.task_to_proc
        assert np.array_equal(np.sort(t2p), np.arange(len(t2p)))


def test_fused_fault_degrades_to_unfused_bit_identical():
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="torch", partition_backend="torch")
        with faults.injected("fused", "compile", count=1):
            resp = svc.map(req)
        _served_by(resp, ref, "unfused")
        direct = shared_pipeline(dataclasses.replace(
            req.config, fused="off")).map(req.graph, req.alloc)
        np.testing.assert_array_equal(resp.result.task_to_proc,
                                      direct.task_to_proc)


def test_slow_stage_with_deadline_degrades():
    with faults.isolated():
        svc = MappingService(deadline_s=0.15)
        ref, req = _pair(score_backend="torch", partition_backend="numpy")
        # the first rung hangs well past the deadline; the numpy rung
        # then serves the request
        with faults.injected("serve.compute", "slow", delay=2.0, count=1):
            resp = svc.map(req)
        _served_by(resp, ref, "score_numpy")
        s = svc.stats()
        assert s["deadline_misses"] == 1 and s["degraded"] == 1


def test_deadline_rung_stays_in_the_request_trace():
    with faults.isolated():
        svc = MappingService(deadline_s=30.0)
        _, req = _pair(score_backend="torch", partition_backend="numpy")
        resp = svc.map(req)
        spans = obs.finished(resp.trace_id)
        names = {s.name for s in spans}
        assert {"serve.request", "serve.rung", "pipeline.map"} <= names
        [rung] = [s for s in spans if s.name == "serve.rung"]
        assert rung.attrs["rung"] == "full" and "degraded" not in rung.attrs


def test_breaker_opens_skips_and_recovers():
    with faults.isolated():
        clk = _Clock()
        svc = MappingService(breaker_threshold=2, breaker_cooldown_s=30.0,
                             clock=clk)
        torch_cfg = dict(score_backend="torch", partition_backend="numpy")
        spec = faults.install("score.torch", "error")
        try:
            for seed in (0, 1):  # two failures trip the rung's breaker
                ref, req = _pair(seed=seed, **torch_cfg)
                _served_by(svc.map(req), ref, "score_numpy")
            fired_before = spec.fired
            ref, req = _pair(seed=2, **torch_cfg)
            _served_by(svc.map(req), ref, "score_numpy")
            assert spec.fired == fired_before  # rung skipped, not tried
            s = svc.stats()
            assert s["breaker_skips"] >= 1
            [open_key] = [k for k, v in s["breakers"].items()
                          if v["state"] == "open"]
            assert "score=torch" in open_key and "device=cpu" in open_key
        finally:
            faults.remove(spec)
        # cooldown elapses, fault gone: the probe closes the breaker
        clk.t = 30.0
        ref, req = _pair(seed=3, **torch_cfg)
        resp = svc.map(req)
        assert "degraded" not in resp.result.stats
        np.testing.assert_array_equal(resp.result.task_to_proc,
                                      _oracle(ref).task_to_proc)
        assert all(v["state"] == "closed"
                   for v in svc.stats()["breakers"].values())


def test_hierarchical_request_degrades_to_refine_0():
    """A node request whose scorer keeps failing ends on the terminal
    rung: host numpy, no refinement rounds."""
    with faults.isolated():
        svc = MappingService()
        name = "minighost-xk7_sparse-node-wh"
        ref, req = _pair(name, score_backend="numpy",
                         partition_backend="numpy")
        assert [n for n, _ in degradation_ladder(req.config)] == [
            "full", "refine_0"]
        with faults.injected("score.numpy", "error", count=1):
            resp = svc.map(req)
        assert resp.result.stats["degraded"] == "refine_0"
        rcfg = dataclasses.replace(
            ref.config, score_backend="numpy", partition_backend="numpy",
            hierarchy=ref.config.hierarchy.with_refine(rounds=0, polish=0))
        want = r_shared_pipeline(rcfg).map(ref.graph, ref.alloc)
        np.testing.assert_array_equal(resp.result.task_to_proc,
                                      want.task_to_proc)


# ---------------------------------------------------------------------------
# What the ladder must not hide: configs that do not resolve
# ---------------------------------------------------------------------------

def test_unreachable_cuda_raises_before_any_rung(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with faults.isolated():
        svc = MappingService()
        _, req = _pair(score_backend="hopper", device="cuda")
        with faults.injected("serve.compute", "slow", delay=0.0) as spec:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                svc.map(req)
            assert spec.calls == 0
        s = svc.stats()
        assert s["rung_failures"] == s["degraded"] == s["cold"] == 0
        assert s["inflight"] == 0 and s["breakers"] == {}


def test_hopper_on_cpu_raises_before_any_rung():
    with faults.isolated():
        svc = MappingService()
        _, req = _pair(score_backend="hopper")
        with faults.injected("serve.compute", "slow", delay=0.0) as spec:
            with pytest.raises(ValueError, match="hopper"):
                svc.map(req)
            assert spec.calls == 0
        s = svc.stats()
        assert s["rung_failures"] == s["degraded"] == s["cold"] == 0


def test_kernel_build_failure_raises_before_any_rung(monkeypatch):
    """Resolving a card config builds the kernel library: a build that
    fails raises to the caller, and no rung runs or is counted."""
    from repro_torch.kernels import _build

    def refuse():
        raise _build.KernelBuildFailure("nvcc refused the sources")

    monkeypatch.setattr(PR, "get_evaluator", lambda b, d: (b, None))
    monkeypatch.setattr(PR, "resolve_partition_backend", lambda b, d: b)
    monkeypatch.setattr(_build, "load_library", refuse)
    with faults.isolated():
        svc = MappingService()
        _, req = _pair(score_backend="hopper", partition_backend="torch",
                       device="cuda")
        with faults.injected("serve.compute", "slow", delay=0.0) as spec:
            with pytest.raises(_build.KernelBuildFailure, match="nvcc"):
                svc.map(req)
            assert spec.calls == 0
        s = svc.stats()
        assert s["rung_failures"] == s["degraded"] == s["cold"] == 0
        assert s["breakers"] == {} and svc._ladders == {}
    # the library is loaded only where a card kernel runs
    assert rung_key(PipelineConfig(score_backend="numpy",
                                   partition_backend="numpy",
                                   device="cuda")) == (
        "staged/score=numpy/partition=numpy/device=cuda")


def test_ladder_cache_keeps_devices_apart(monkeypatch):
    """``config_signature`` leaves the device out; the ladder cache
    does not: a ``cuda`` config never reuses a ``cpu`` config's
    resolved ladder."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = MappingService()
    cpu = PipelineConfig(score_backend="torch", device="cpu")
    lad = svc._ladder_for(cpu)
    assert [n for n, _, _ in lad] == ["full", "unfused", "score_numpy",
                                      "partition_numpy"]
    assert all(k.endswith("device=cpu") for _, _, k in lad)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc._ladder_for(dataclasses.replace(cpu, device="cuda"))
    assert [dev for _, dev in svc._ladders] == ["cpu"]
    assert svc._ladder_for(dataclasses.replace(cpu)) is lad


# ---------------------------------------------------------------------------
# Admission, failed flights, eviction storms
# ---------------------------------------------------------------------------

def _numpy_req(seed):
    return _pair(seed=seed, score_backend="numpy",
                 partition_backend="numpy")[1]


def test_admission_shedding_and_queueing():
    with faults.isolated():
        gate = threading.Event()
        entered = threading.Event()

        class Blocking(MappingService):
            def _compute(self, request):
                entered.set()
                gate.wait()
                return super()._compute(request)

        svc = Blocking(max_inflight=1, max_queue=0)
        errs = []

        def owner():
            try:
                svc.map(_numpy_req(10))
            except BaseException as e:  # pragma: no cover
                errs.append(e)

        t = threading.Thread(target=owner)
        t.start()
        assert entered.wait(5.0)
        with pytest.raises(ServiceOverloaded):
            svc.map(_numpy_req(11))  # queue full: shed
        gate.set()
        t.join(10.0)
        assert not t.is_alive() and not errs
        assert svc.stats()["shed"] == 1
        # warm hits bypass admission entirely
        assert svc.map(_numpy_req(10)).status == "warm"


def test_failed_compute_not_cached_and_recomputable():
    with faults.isolated():
        svc = MappingService()
        req = _numpy_req(20)
        with faults.injected("serve.compute", "error", count=1):
            with pytest.raises(faults.InjectedFault):
                svc.map(req)
        assert len(svc.results) == 0       # errors never enter the LRU
        assert svc.stats()["inflight"] == 0
        resp = svc.map(_numpy_req(20))     # fresh identical request
        assert resp.status == "cold"
        assert len(svc.results) == 1


def test_waiter_recomputes_after_owner_failure():
    with faults.isolated():
        release = threading.Event()
        entered = threading.Event()
        calls = []

        class FlakyOnce(MappingService):
            def _compute(self, request):
                calls.append(1)
                if len(calls) == 1:
                    entered.set()
                    release.wait(5.0)
                    raise RuntimeError("transient backend failure")
                return super()._compute(request)

        svc = FlakyOnce()
        req = _numpy_req(21)
        outcomes = {}

        def run(tag):
            try:
                outcomes[tag] = svc.map(_numpy_req(21))
            except RuntimeError as e:
                outcomes[tag] = e

        t1 = threading.Thread(target=run, args=("owner",))
        t1.start()
        assert entered.wait(5.0)
        t2 = threading.Thread(target=run, args=("waiter",))
        t2.start()
        time.sleep(0.1)  # let the waiter reach the in-flight wait
        release.set()
        t1.join(10.0)
        t2.join(10.0)
        assert not t1.is_alive() and not t2.is_alive()
        assert isinstance(outcomes["owner"], RuntimeError)
        # the waiter did NOT replay the owner's error: it recomputed
        assert outcomes["waiter"].result is not None
        np.testing.assert_array_equal(
            outcomes["waiter"].result.task_to_proc,
            svc.map(req).result.task_to_proc)
        assert len(calls) == 2


def test_eviction_storm_recomputes_but_serves():
    with faults.isolated():
        svc = MappingService()
        first = svc.map(_numpy_req(22))
        with faults.injected("serve.cache", "evict", count=1):
            resp = svc.map(_numpy_req(22))
        assert resp.status == "cold"       # storm wiped the warm entry
        np.testing.assert_array_equal(resp.result.task_to_proc,
                                      first.result.task_to_proc)
        assert svc.results.stats()["storms"] == 1
        assert svc.map(_numpy_req(22)).status == "warm"  # storm over


def test_no_faults_bit_identical_and_breakers_closed():
    with faults.isolated():
        svc = MappingService()
        ref, req = _pair(score_backend="torch", partition_backend="torch")
        resp = svc.map(req)
        assert resp.result.stats.get("fused") is True
        np.testing.assert_array_equal(resp.result.task_to_proc,
                                      _oracle(ref).task_to_proc)
        s = svc.stats()
        assert "degraded" not in resp.result.stats
        assert s["degraded"] == s["rung_failures"] == 0
        assert s["breaker_skips"] == s["deadline_misses"] == 0
        assert s["deadline_skips"] == 0 and s["rungs"] == {}
        assert all(v["state"] == "closed" and v["opens"] == 0
                   for v in s["breakers"].values())


def test_stats_requests_counts_only_request_statuses():
    svc = MappingService()
    svc.map(_numpy_req(23))
    svc.map(_numpy_req(23))
    s = svc.stats()
    assert s["requests"] == 2 == s["cold"] + s["warm"] + s["coalesced"]
    assert set(RSV.MappingService().stats()) == set(s)
