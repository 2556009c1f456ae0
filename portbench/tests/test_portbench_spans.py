"""The readers of the spans inside the sweep, the service and the
hierarchy: their arithmetic on synthetic spans (device intervals and
profiler operations inside and outside them), and a traced CPU run of
each cell, which reports the span metrics the cell lists and leaves out
the two device ones (no card, so no device intervals)."""

import json

import percell
import pytest

from pbench import trace
from pbench.cell import Run
from pbench.spec import Spec
from pbench_tiny import BENCH_DIR, REPO, tiny_root

SEED = 2 ** 31 + 26
DEVICE_METRICS = percell.DEVICE_METRICS
WORKLOADS = [w["name"] for w in
             json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def span(name, i, parent, t0, t1, **attrs):
    return trace.SpanRec(name, i, parent, "t", t0, t1, attrs)


def sweep_spans(t0, dev=None, **extra):
    """One request's spans from ``t0`` (host seconds), each sweep step a
    second long, with device intervals ``dev`` = (partition's, score's)
    where the card's timing was armed, and ``extra`` spans (name:
    seconds) under ``pipeline.map``."""
    base = 100 + int(t0) * 10
    spans = [span("pipeline.map", base, None, t0, t0 + 8),
             span("pipeline.fused", base + 1, base, t0 + 1, t0 + 8)]
    for k, name in enumerate(("sweep.plan", "sweep.upload",
                              "sweep.partition", "sweep.score",
                              "sweep.select", "sweep.winner")):
        attrs = {}
        if dev and name in ("sweep.partition", "sweep.score"):
            lo, hi = dev[name == "sweep.score"]
            attrs = {"device_t0_s": lo, "device_t1_s": hi,
                     "device_s": hi - lo}
        spans.append(span(name, base + 2 + k, base + 1, t0 + 1 + k,
                          t0 + 2 + k, **attrs))
    return spans + [span(n, base + 9 + i, base, t0 + 7.2, t0 + 7.2 + d)
                    for i, (n, d) in enumerate(extra.items())]


def run_of(spans, ops=()):
    return Run([], trace.Tree(spans), list(ops), (0.0, 20.0), {}, {}, [])


def test_sweep_readers_on_synthetic_spans():
    spec = Spec(REPO, BENCH_DIR)
    run = run_of(sweep_spans(0.0) + sweep_spans(10.0))
    # plan + upload + partition + score: 4 s a request; select 1 s
    assert spec.reader("sweep.host_ms")(run) == pytest.approx(4e3)
    assert spec.reader("sweep.wait_ms")(run) == pytest.approx(1e3)
    assert spec.reader("sweep.fused_ms")(run) == pytest.approx(7e3)
    # no device interval, no hierarchy, no request root
    for name in DEVICE_METRICS | {"hier.assign_ms", "service.signature_ms"}:
        assert spec.reader(name)(run) is None, name


def test_device_readers_on_synthetic_intervals_and_ops():
    spec = Spec(REPO, BENCH_DIR)
    timed = (sweep_spans(0.0, dev=((3.5, 4.5), (4.5, 5.75)))
             + sweep_spans(10.0, dev=((13.25, 14.0), (14.0, 14.5)),
                           **{"hier.assign_cores": 0.5}))
    ops = [("a", 3.4, 0.1), ("b", 3.5, 0.1), ("c", 4.0, 0.1),
           ("d", 4.5, 0.1), ("e", 4.6, 0.1), ("f", 13.3, 0.1),
           ("g", 14.2, 0.1)]
    run = run_of(timed, ops)
    # score's end less partition's start: 2.25 and 1.25 s
    assert spec.reader("sweep.device_ms")(run) == pytest.approx(1.75e3)
    # b, c, d start inside [3.5, 4.5]; f inside [13.25, 14.0]
    assert spec.reader("sweep.partition_ops")(run) == pytest.approx(2.0)
    assert spec.reader("hier.assign_ms")(run) == pytest.approx(0.25e3)
    # intervals but no profiler operations: nothing to count
    assert spec.reader("sweep.partition_ops")(run_of(timed)) is None


def test_signature_reader_on_synthetic_spans():
    spec = Spec(REPO, BENCH_DIR)
    spans = [span("serve.request", 1, None, 0.0, 10.0),
             span("serve.signature", 2, 1, 0.5, 0.75, bytes=10),
             span("serve.request", 3, None, 10.0, 11.0),     # memoised
             span("serve.signature", 4, 3, 10.0, 10.25, bytes=0)]
    assert spec.reader("service.signature_ms")(run_of(spans)) == \
        pytest.approx(250.0)


def test_device_readers_arm_nothing_on_the_cpu():
    spec = Spec(REPO, BENCH_DIR)
    for name in DEVICE_METRICS:
        assert spec.reader_module(name).start() is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_the_span_metrics(tmp_path, workload):
    percell.span_metrics_are_read(Spec(tiny_root(tmp_path), BENCH_DIR),
                                  workload, SEED)
