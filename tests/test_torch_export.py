"""The exporters (``repro_torch.obs.export``) against the reference's
(``repro.obs.export``) on the CPU.

Span trees and snapshots are built the same way in both packages (each
with its own private ``Tracer`` / ``MetricsRegistry``, or one shared
snapshot dict); the JSONL log, the Chrome trace document and the
Prometheus text must then be equal once what differs by nature is left
out: timestamps, durations, span and trace ids, thread ids and the
producer's name.  ``torch_profile`` does nothing with
``REPRO_TORCH_PROFILE`` unset, and writes a profiler trace inside a
``torch.profile`` span when it names a directory.
"""

import json
import os
import subprocess
import sys

import pytest

import repro.obs as RO
import repro.serve as RSV
from repro.obs import metrics as RM
from repro.obs import trace as RT
from repro_torch import compat, obs
from repro_torch.obs import export as PE
from repro_torch.obs import metrics as PM
from repro_torch.obs import trace as PT
from repro_torch.serve import MappingService

TIMING = {"t0_s", "duration_s", "wall", "thread", "span_id", "parent_id",
          "trace_id"}


def _tree(tracer):
    """One request-like span tree: a root, a degraded rung with a failed
    sibling before it, a nested backend span, and a second trace."""
    with tracer.span("serve.request", status="cold") as root:
        with tracer.span("serve.rung", rung="full", index=0):
            pass
        try:
            with tracer.span("serve.rung", rung="unfused", index=1):
                raise RuntimeError("injected")
        except RuntimeError:
            pass
        with tracer.span("serve.rung", rung="score_numpy", index=2) as sp:
            with tracer.span("score.numpy", candidates=4):
                pass
            sp.annotate(degraded="score_numpy")
        root.annotate(signature="abc")
    with tracer.span("pipeline.map", hierarchy="flat", points=512):
        pass
    return tracer.finished()


def _shape(spans):
    """The tree's structure without ids: each span's name, attrs and the
    index of its parent in the list."""
    index = {s["span_id"]: i for i, s in enumerate(spans)}
    return [(s["name"], s["attrs"], index.get(s["parent_id"]),
             s["trace_id"] == spans[-1]["trace_id"]) for s in spans]


def test_jsonl_log_equals_reference(tmp_path):
    logs = {}
    for tag, trace, export in (("ref", RT, RO.export), ("port", PT, PE)):
        tracer = trace.Tracer()
        sink = export.JsonlSink(str(tmp_path / f"{tag}.jsonl"))
        tracer.add_sink(sink)
        _tree(tracer)
        sink.close()
        logs[tag] = export.read_jsonl(sink.path)
    assert len(logs["port"]) == len(logs["ref"]) == 6
    for a, b in zip(logs["port"], logs["ref"]):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in TIMING} == \
            {k: v for k, v in b.items() if k not in TIMING}
    assert _shape(logs["port"]) == _shape(logs["ref"])
    [bad] = [s for s in logs["port"] if "error" in s["attrs"]]
    assert bad["attrs"] == {"rung": "unfused", "index": 1,
                            "error": "RuntimeError"}


def _events(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            | {"args": {k: v for k, v in e["args"].items()
                        if k not in ("trace_id", "span_id", "parent_id")}}
            for e in doc["traceEvents"]]


def test_chrome_trace_equals_reference(tmp_path):
    docs = {}
    for tag, trace, export in (("ref", RT, RO.export), ("port", PT, PE)):
        spans = _tree(trace.Tracer())
        docs[tag] = export.write_chrome_trace(
            str(tmp_path / f"{tag}.json"), spans)
        with open(tmp_path / f"{tag}.json") as f:
            assert json.load(f) == docs[tag]
    port, ref = docs["port"], docs["ref"]
    assert _events(port) == _events(ref)
    assert port["displayTimeUnit"] == ref["displayTimeUnit"] == "ms"
    assert sorted(port["otherData"]["traces"].values()) == \
        sorted(ref["otherData"]["traces"].values()) == [0, 1]
    assert port["otherData"]["producer"] == "repro_torch.obs"
    for e in port["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0


SNAPSHOT = {
    "counters": {"serve.degraded": 2, "serve.rung_failures": 3},
    "gauges": {"queue.depth": 1.5},
    "histograms": {"serve.latency_s": {"count": 4, "sum": 0.25}},
    "caches": {"mapscore": {"hits": 1, "misses": 2, "entries": 3}},
    "lrus": {"lru#0": {"hits": 5, "misses": 1, "evictions": 0,
                       "storms": 1, "hit_rate": 0.8333}},
    "services": {"service#0": {"cold": 3, "warm": 1, "degraded": 1,
                               "rungs": {"score_numpy": 1},
                               "breakers": {}, "healthy": True}},
    "derived": {"cache_hit_rate": None, "degraded_rate": 0.25,
                "note": "text is not exported"},
}


def test_prometheus_text_of_one_snapshot_equals_reference():
    text = PE.prometheus_text(SNAPSHOT)
    assert text == RO.export.prometheus_text(SNAPSHOT)
    assert "# TYPE repro_serve_degraded_total counter" in text
    assert 'repro_services_degraded{instance="service#0"} 1.0' in text
    assert "repro_derived_cache_hit_rate NaN" in text
    assert "rungs" not in text and "note" not in text


def test_prometheus_text_of_registries_built_alike_equals_reference():
    """Two registries fed the same series and a service each that served
    the same requests."""
    ref = RSV.get_scenario("random-tpu_mesh-flat-wh", scale=256,
                           rotations=2).request()
    port = compat.mapping_request(ref, device="cpu")
    port.config.score_backend = "numpy"
    snaps = {}
    for tag, mod, svc, req in (("ref", RM, RSV.MappingService(), ref),
                               ("port", PM, MappingService(), port)):
        reg = mod.MetricsRegistry()
        reg.counter("serve.responses.cold", 2)
        reg.gauge("inflight", 0)
        for v in (0.5, 0.25):
            reg.observe("serve.latency_s", v)
        svc.map(req)
        svc.map(req)
        reg.register_object("services", svc)
        snaps[tag] = reg.snapshot()
    text = PE.prometheus_text(snaps["port"])
    assert text == RO.export.prometheus_text(snaps["ref"])
    assert 'repro_services_warm{instance="service#0"} 1.0' in text
    assert 'repro_services_rung_failures{instance="service#0"} 0.0' in text


def test_prometheus_text_parses():
    for line in PE.prometheus_text(SNAPSHOT).splitlines():
        if line.startswith("#"):
            assert line.split()[:2] == ["#", "TYPE"]
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        assert name.startswith("repro_")


def test_env_sink_is_armed_once_at_import(tmp_path):
    path = tmp_path / "trace.jsonl"
    code = ("from repro_torch import obs\n"
            "with obs.span('serve.request', status='cold'):\n"
            "    pass\n")
    env = dict(os.environ, REPRO_TRACE=str(path),
               PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    [span] = PE.read_jsonl(str(path))
    assert span["name"] == "serve.request"
    assert span["attrs"] == {"status": "cold"}


def test_install_env_sink(monkeypatch, tmp_path):
    tracer = PT.Tracer()
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    assert PE.install_env_sink(tracer) is None
    monkeypatch.setenv("REPRO_TRACE", str(tmp_path / "t.jsonl"))
    sink = PE.install_env_sink(tracer)
    with tracer.span("a"):
        pass
    sink.close()
    assert [s["name"] for s in PE.read_jsonl(sink.path)] == ["a"]


def test_torch_profile_is_a_no_op_when_unset(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PROFILE", raising=False)
    before = len(obs.finished())
    with obs.torch_profile("x") as out:   # default device: not resolved
        assert out is None
    assert len(obs.finished()) == before
    assert not any(s.name == "torch.profile" for s in obs.finished())


def test_torch_profile_writes_a_trace_in_a_span(monkeypatch, tmp_path):
    import torch
    monkeypatch.setenv("REPRO_TORCH_PROFILE", str(tmp_path / "prof"))
    with obs.torch_profile("cpu-block", device="cpu") as out:
        torch.ones(8).cumsum(0)
    assert out == str(tmp_path / "prof")
    [sp] = [s for s in obs.finished() if s.name == "torch.profile"
            and s.attrs.get("label") == "cpu-block"]
    with open(sp.attrs["path"]) as f:
        doc = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in doc["traceEvents"])


def test_torch_profile_refuses_an_unreachable_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_TORCH_PROFILE", str(tmp_path / "prof"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with obs.torch_profile("card", device="cuda"):
            pass
