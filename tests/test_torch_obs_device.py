"""Spans inside the sweep, the service and the hierarchy, and device
spans: which spans a fused flat and a node request open and under which
parents, the bytes ``serve.signature`` hashes, device timing on a
process without CUDA (a no-op), the hold-and-resolve order of device
spans (with a stand-in clock, since the CPU has no timing events), and
the Chrome trace's device row."""

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.obs import export as PE
from repro_torch.obs import metrics as PM
from repro_torch.obs.trace import Tracer
from repro_torch.serve import MappingService, get_scenario

SCALE = 2048


def _served(name):
    req = get_scenario(name, scale=SCALE, device="cpu",
                       score_backend="torch", rotations=4).request()
    obs.reset()
    resp = MappingService().map(req)
    spans = obs.finished(resp.trace_id)
    by_id = {s.span_id: s for s in spans}
    parents = {s.name: by_id[s.parent_id].name for s in spans
               if s.parent_id in by_id}
    return req, resp, {s.name: s for s in spans}, parents


SWEEP = ("sweep.plan", "sweep.upload", "sweep.partition", "sweep.score",
         "sweep.select")


def test_fused_flat_request_opens_the_sweep_spans():
    req, resp, spans, parents = _served("minighost-xk7_sparse-flat-wh")
    assert resp.result.stats["fused"] is True
    assert parents["serve.signature"] == "serve.request"
    for name in SWEEP + ("sweep.winner",):
        assert parents[name] == "pipeline.fused", name
    assert "sweep.refine" not in spans
    # the existing spans keep their nesting: pipeline.fused stays the
    # direct child of pipeline.map
    assert parents["pipeline.fused"] == "pipeline.map"
    assert spans["sweep.plan"].attrs == {"candidates": 4}
    assert spans["sweep.upload"].attrs["bytes"] > 0
    assert spans["sweep.partition"].attrs["points"] == 2 * SCALE
    score = spans["sweep.score"].attrs
    assert (score["kernel"], score["candidates"], score["tasks"],
            score["traffic"]) == ("torch", 4, SCALE, False)
    assert score["edges"] == len(req.graph.edges)
    assert spans["pipeline.fused"].attrs["candidates"] == 4
    # the sweep's steps run one after another inside pipeline.fused
    steps = [spans[n] for n in SWEEP + ("sweep.winner",)]
    for a, b in zip(steps, steps[1:]):
        assert a.t1 <= b.t0
    # no device timing on the CPU
    assert not any("device_t0_s" in s.attrs for s in spans.values())


def test_node_request_opens_the_hierarchy_spans():
    _, resp, spans, parents = _served("minighost-xk7_sparse-node-wh")
    assert resp.result.stats["fused_refine"] is True
    assert parents["hier.contract"] == "pipeline.coarsen"
    assert parents["partition.torch"] == "pipeline.coarsen"
    assert parents["hier.assign_cores"] == "pipeline.refine"
    assert parents["sweep.refine"] == "pipeline.fused"
    for name in SWEEP:
        assert parents[name] == "pipeline.fused", name
    assert "sweep.winner" not in spans
    clusters = spans["pipeline.coarsen"].attrs["nclusters"]
    assert spans["hier.contract"].attrs["clusters"] == clusters
    assert spans["hier.assign_cores"].attrs["tasks"] == SCALE
    assert spans["hier.assign_cores"].attrs["path"] == "cpu"
    refine = spans["sweep.refine"].attrs
    fused = spans["pipeline.fused"].attrs
    assert refine["rounds"] == fused["refine_rounds"]
    assert refine["host_reads"] == fused["refine_host_reads"]
    assert spans["partition.torch"].attrs["device"] == "cpu"


def test_signature_span_carries_the_hashed_bytes():
    req = get_scenario("homme-bgq_block-flat-wh", scale=512, device="cpu",
                       score_backend="torch", rotations=2).request()
    want = sum(np.asarray(a).nbytes for a in (
        req.graph.coords, req.graph.edges, req.graph.weights,
        req.alloc.coords))
    assert req.hashed_bytes() == want
    svc = MappingService()
    obs.reset()
    cold = svc.map(req)
    warm = svc.map(req)                  # the signature is memoised now
    assert warm.status == "warm"
    got = [s.attrs["bytes"] for tid in (cold.trace_id, warm.trace_id)
           for s in obs.finished(tid) if s.name == "serve.signature"]
    assert got == [want, 0]


def test_device_time_on_the_cpu_leaves_host_spans():
    t = Tracer()
    assert t.device_time(True) is False
    with t.span("root"):
        with t.span("work", device=True):
            pass
        with t.span("copy", device="cpu"):
            pass
    assert [s.name for s in t.finished()] == ["work", "copy", "root"]
    assert all(not any(k.startswith("device_") for k in s.attrs)
               for s in t.finished())
    assert t.finished()[1].attrs == {"device": "cpu"}
    assert obs.device_time(False) is False


def _tree(tracer):
    with tracer.span("serve.request"):
        with tracer.span("pipeline.map"):
            with tracer.span("sweep.partition", device=True):
                with tracer.span("partition.torch", device="cuda:0"):
                    pass
            with tracer.span("sweep.select"):
                pass


class _Event:
    def __init__(self, clock):
        self.t = clock.now = clock.now + 1.0
        self.waited = False

    def synchronize(self):
        self.waited = True


class _Clock:
    """Stands in for :class:`repro_torch.obs.trace.DeviceClock`: each
    event is reached one second after the last."""

    def __init__(self):
        self.now = 100.0
        self.events = []

    def renewed(self):
        self.renewals = getattr(self, "renewals", 0) + 1
        return self

    def mark(self):
        self.events.append(_Event(self))
        return self.events[-1]

    def at(self, ev):
        return ev.t


def test_sink_order_is_unchanged_with_timing_off():
    t = Tracer()
    seen = []
    t.add_sink(seen.append)
    _tree(t)
    order = ["partition.torch", "sweep.partition", "sweep.select",
             "pipeline.map", "serve.request"]
    assert [s.name for s in seen] == order
    assert [s.name for s in t.finished()] == order
    assert all(s.dev is None for s in seen)


def test_device_spans_are_held_until_their_root_resolves_them():
    t = Tracer()
    seen = []
    t.add_sink(seen.append)
    clock = t._clock = _Clock()
    _tree(t)
    # host spans go out as they close; device spans with their root
    assert [s.name for s in seen] == [
        "sweep.select", "pipeline.map", "partition.torch",
        "sweep.partition", "serve.request"]
    assert [s.name for s in t.finished()] == [s.name for s in seen]
    part, outer = seen[2], seen[3]
    # events: outer open 101, inner open 102, inner close 103, outer
    # close 104
    assert (part.attrs["device_t0_s"], part.attrs["device_t1_s"],
            part.attrs["device_s"]) == (102.0, 103.0, 1.0)
    assert (outer.attrs["device_t0_s"], outer.attrs["device_t1_s"]) == \
        (101.0, 104.0)
    assert part.attrs["device"] == "cuda:0"
    assert all(e.waited for e in clock.events[2:])
    assert clock.renewals == 1              # one anchor a trace
    assert not t._held
    for s in seen:
        assert s.dev is None
        if s.name not in ("sweep.partition", "partition.torch"):
            assert "device_t0_s" not in s.attrs


def test_device_span_without_an_armed_root_resolves_at_its_close():
    t = Tracer()
    seen = []
    t.add_sink(seen.append)
    with t.span("serve.request"):              # opened before arming
        t._clock = _Clock()
        with t.span("sweep.score", device=True):
            pass
        assert [s.name for s in seen] == ["sweep.score"]
        assert seen[0].attrs["device_s"] == 1.0
    with t.span("partition.torch", device=True):   # a root device span
        pass
    assert [s.name for s in seen] == [
        "sweep.score", "serve.request", "partition.torch"]
    assert seen[-1].attrs["device_s"] == 1.0
    t._clock = None
    with t.span("sweep.score", device=True):
        pass
    assert "device_s" not in seen[-1].attrs and not t._held


def test_chrome_trace_draws_device_intervals_on_a_device_row():
    t = Tracer()
    t._clock = _Clock()
    _tree(t)
    doc = PE.chrome_trace(t.finished())
    events = doc["traceEvents"]
    host = [e for e in events if e["ph"] == "X" and e["tid"] != PE.DEVICE_TID]
    dev = [e for e in events if e["ph"] == "X" and e["tid"] == PE.DEVICE_TID]
    assert len(host) == 5
    assert [(e["name"], e["ts"], e["dur"]) for e in dev] == [
        ("partition.torch", 102e6, 1e6), ("sweep.partition", 101e6, 3e6)]
    [meta] = [e for e in events if e["ph"] == "M"]
    assert meta["args"] == {"name": "device"}
    assert meta["pid"] == dev[0]["pid"] == host[0]["pid"]


def test_unread_registry_api_is_gone():
    for name in ("span_rollup", "instrument_compile_cache", "register_cache"):
        assert not hasattr(obs, name) and not hasattr(PM, name)
    for name in ("cache_names", "reset_cache", "_caches"):
        assert not hasattr(PM.REGISTRY, name)
    snap = obs.snapshot()
    assert snap["caches"] == {}
    assert snap["derived"]["compile_cache_hit_rate"] is None


@pytest.mark.parametrize("device,dev", [(False, None), (True, None),
                                        ("cpu", "cpu"), ("cuda", "cuda")])
def test_a_device_given_by_value_is_kept_as_an_attribute(device, dev):
    t = Tracer()
    with t.span("s", device=device, k=1):
        pass
    [s] = t.finished()
    assert s.attrs == ({"k": 1} if dev is None else {"k": 1, "device": dev})
