"""What every cell of a benchmark has to show on the CPU, at its tiny
sizes: the program's answers are correct, the control and an answer
altered where it is made are not, and a traced run reads the span
metrics the cell lists.  Each check takes the cell's own lists from
``BENCHMARK.json`` (:meth:`pbench.spec.Spec.metrics`), so a cell that a
later change adds as files and entries is held to the same checks."""

import dataclasses

import numpy as np

from pbench import cell as pcell

# the readers of the program's spans: each is read on the CPU wherever
# a cell lists it
SPAN_METRICS = {"service.signature_ms", "sweep.host_ms", "sweep.wait_ms",
                "sweep.fused_ms", "hier.host_ms", "hier.assign_ms"}
# read from the card's timing or the profiler's device operations: none
# on the CPU
DEVICE_METRICS = {"sweep.device_ms", "sweep.partition_ops"}


def run(spec, workload, seed, seconds=0.3, traced=False, **kw):
    return pcell.run_cell(spec, workload, seed, seconds, traced,
                          t_start=0.0, device="cpu", score_backend="torch",
                          **kw)


def program_answers_are_correct(spec, workload, seed):
    res = run(spec, workload, seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in spec.metrics("end_to_end", workload)}
    assert set(res["metrics"]) == e2e
    assert all(v["value"] > 0 for v in res["metrics"].values())


def control_is_not_correct(spec, workload, seed):
    # the count, not the clock, ends the window: the jobs judged are the
    # same however loaded the host is
    res = run(spec, workload, seed, seconds=600.0, serve="control",
              limit=100)
    assert res["attempted"] == 100
    assert not res["correct"]
    assert res["checks"]["wrong_tasks"]["value"] > 0


def altered_answer_is_not_correct(spec, workload, seed, monkeypatch):
    """Task 0 swaps cores with the last task placed on another core (the
    last task where each core holds one)."""
    from repro_torch.serve import MappingService
    compute = MappingService._compute

    def altered(self, request):
        res = compute(self, request)
        t2p = np.array(res.task_to_proc, copy=True)
        other = np.flatnonzero(t2p != t2p[0])[-1]
        t2p[[0, other]] = t2p[[other, 0]]
        return dataclasses.replace(res, task_to_proc=t2p)

    monkeypatch.setattr(MappingService, "_compute", altered)
    res = run(spec, workload, seed)
    assert not res["correct"]
    assert res["checks"]["wrong_tasks"]["value"] == 2


def span_metrics_are_read(spec, workload, seed) -> dict:
    """A traced run reports only what the cell lists, every span metric
    among them, and no device metric; returns its metrics."""
    res = run(spec, workload, seed, traced=True)
    assert res["correct"]
    listed = {m["name"] for m in spec.metrics("per_layer", workload)}
    m = res["metrics"]
    assert set(m) <= listed
    assert SPAN_METRICS & listed <= set(m)
    assert not DEVICE_METRICS & set(m)
    if {"hier.assign_ms", "hier.host_ms"} <= listed:
        assert 0 < m["hier.assign_ms"]["value"] < m["hier.host_ms"]["value"]
    # the sweep's host steps lie inside pipeline.fused
    if {"sweep.host_ms", "sweep.wait_ms", "sweep.fused_ms"} <= listed:
        assert m["sweep.host_ms"]["value"] + m["sweep.wait_ms"]["value"] \
            <= m["sweep.fused_ms"]["value"]
    return m
