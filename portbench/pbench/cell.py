"""One run of one cell: set up the service and the job pool, drive the
closed loop for the window, read the trace, judge the answers.

The system under test is ``repro_torch.serve.MappingService`` (the
program); everything else here is the benchmark's.  One launcher sends
its next request when the last one returns.  A request's latency is the
host clock from just before ``MappingService.map`` to its return, whose
answer is a host array, so the device has finished.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np

from . import gen, judge, trace
from . import traffic as _traffic
from .ref.engine import OBJECTIVES

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
JUDGED_JOBS = 2


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that no run
    may load, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads: the window's answers, the
    program's spans, the device operations, the window on the host
    clock, the cell's configuration and mix, its job pool, and what each
    metric's ``start()`` returned as the window opened, by the metric's
    name."""

    requests: list
    tree: trace.Tree
    ops: list
    window: tuple
    config: dict
    mix: dict
    jobs: list
    started: dict = dataclasses.field(default_factory=dict)


class Port:
    """The program: a fresh ``MappingService`` and a launcher that sends
    each request as a new ``MappingRequest`` built from a job's arrays,
    with one ``TaskGraph`` and one machine a variant of the
    configuration, shared by that variant's jobs."""

    def __init__(self, config: dict, mix: dict, jobs: list, device: str,
                 score_backend: str | None = None):
        from repro_torch.core import Allocation, TaskGraph, make_machine
        from repro_torch.mapping import HierarchySpec, PipelineConfig
        from repro_torch.serve import MappingRequest, MappingService
        self.graphs, machines = {}, {}
        for j in jobs:
            if j.variant in machines:
                continue
            m = j.machine
            machines[j.variant] = make_machine(
                m.dims, wrap=m.wrap, core_dims=m.core_dims,
                bw_patterns=[np.array(p) for p in m.link_bw]
                + [np.array([math.inf])] * m.core_dims)
            self.graphs[j.variant] = TaskGraph(j.task_coords, j.edges,
                                               j.weights)
        self.jobs = jobs
        self.allocs = [Allocation(machines[j.variant], j.alloc)
                       for j in jobs]
        p = config["pipeline"]
        objective = OBJECTIVES[p["objective"]]
        self.config = PipelineConfig(
            sfc=p["sfc"], shift=p["shift"], rotations=p["rotations"],
            objective=objective[0] if len(objective) == 1 else objective,
            hierarchy=HierarchySpec.from_string(mix["hierarchy"]),
            score_backend=score_backend or p["score_backend"],
            partition_backend=p["partition_backend"], device=device)
        self._request = MappingRequest
        self.service = MappingService(capacity=int(mix["cache_entries"]))

    def serve(self, job: int) -> dict:
        j = self.jobs[job]
        req = self._request(self.graphs[j.variant], self.allocs[job],
                            self.config, task_weights=j.task_weights)
        t0 = time.perf_counter()
        try:
            resp = self.service.map(req)
        except Exception as e:  # a failed request: infinitely slow
            t1 = time.perf_counter()
            print(f"request for job {job} failed: {e!r}", file=sys.stderr)
            return {"job": job, "t0": t0, "t1": t1, "failed": True,
                    "status": "failed"}
        t1 = time.perf_counter()
        res = resp.result
        degraded = res.stats.get("degraded")
        return {"job": job, "t0": t0, "t1": t1, "failed": bool(degraded),
                "status": resp.status, "degraded": degraded,
                "trace_id": resp.trace_id, "task_to_proc": res.task_to_proc,
                "rotation": res.rotation, "score": res.score}


class Control:
    """The control: the reference put in the program's place, with one
    guarantee broken (the winner is the identity rotation's mapping, not
    the best of the configured rotation search)."""

    def __init__(self, config: dict, jobs: list, answer):
        self.jobs = jobs
        self.options = reference_options(config) | {"rotations": 0}
        self.answer = answer
        self.answers: dict = {}

    def serve(self, job: int) -> dict:
        t0 = time.perf_counter()
        if job not in self.answers:
            self.answers[job] = self.answer(self.jobs[job], **self.options)
        a = self.answers[job]
        return {"job": job, "t0": t0, "t1": time.perf_counter(),
                "failed": False, "status": "control", "trace_id": None,
                "task_to_proc": a["task_to_proc"], "rotation": a["rotation"],
                "score": a["score"]}


def reference_options(config: dict) -> dict:
    p = config["pipeline"]
    return {"sfc": p["sfc"], "shift": p["shift"],
            "rotations": p["rotations"], "objective": p["objective"]}


def p90(latencies) -> float:
    """Nearest-rank 90th percentile."""
    xs = sorted(latencies)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def slice_latencies(answers, lo: float, hi: float, n: int) -> list[list]:
    """The latencies of the answered requests sent in each of ``n``
    equal slices of the window ``(lo, hi)``, to show how the host's
    speed moves within a run."""
    out = [[] for _ in range(n)]
    for a in answers:
        if not a["failed"]:
            k = int((a["t0"] - lo) / max(hi - lo, 1e-9) * n)
            out[min(max(k, 0), n - 1)].append(a["t1"] - a["t0"])
    return out


def drive(server, sched, seconds: float, limit: int | None = None
          ) -> tuple[list, float, float]:
    """The closed loop: requests back to back until ``seconds`` have
    passed since the first was sent (or ``limit`` were sent); the window
    runs to the last answer."""
    out = []
    lo = time.perf_counter()
    end = lo + seconds
    while time.perf_counter() < end and (limit is None or len(out) < limit):
        out.append(server.serve(next(sched)))
    return out, lo, time.perf_counter()


def device_ops(prof) -> list:
    """Every device operation of a finished ``torch.profiler`` run as
    ``(name, start_s, dur_s)`` on the host's ``perf_counter`` clock (the
    profiler stamps them in nanoseconds of the epoch)."""
    from torch.autograd import DeviceType
    epoch = time.time_ns() - time.perf_counter_ns()
    return [(ev.name(), (ev.start_ns() - epoch) * 1e-9,
             ev.duration_ns() * 1e-9)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0]


def run_cell(spec, workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device: str = "cuda",
             score_backend: str | None = None, serve: str = "port",
             limit: int | None = None, log=sys.stderr) -> dict:
    """One run; returns the result line's fields (``metrics`` holds the
    end-to-end metrics untraced, the per-layer ones traced) and
    ``checks``, the compared numbers beside their limits."""
    t_enter = time.perf_counter()
    import torch

    from repro_torch import obs
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    pool, nwarm = int(mix["pool"]), int(mix["warmup_jobs"])
    # a hierarchy with no reference is refused before anything is served
    answer = judge.reference(mix["hierarchy"], spec.bench_dir)
    t_import = time.perf_counter()
    jobs = gen.job_pool(config, seed, pool + nwarm, spec.bench_dir)
    t_pool = time.perf_counter()
    server = (Port(config, mix, jobs, device, score_backend)
              if serve == "port" else Control(config, jobs, answer))
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for j in range(pool, pool + nwarm):       # set-up: jobs outside
        first = server.serve(j)               # the timed rotation
        if first["failed"]:
            raise RuntimeError(f"warm-up request for job {j} failed")
    sync()
    t_warm = time.perf_counter()
    print(f"set-up: {t_enter - t_start:.2f} s to the cell, imports "
          f"{t_import - t_enter:.2f} s, job pool {t_pool - t_import:.2f} s, "
          f"warm-up {t_warm - t_pool:.2f} s", file=log)
    sched = _traffic.schedule(mix, seed)
    spans, prof, anchor = [], None, 0.0
    if traced:
        obs.add_sink(spans.append)
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA]
                       if on_card else [ProfilerActivity.CPU])
        prof.__enter__()
        marker = torch.zeros(1, device=device)
        sync()
        anchor = time.perf_counter()
        marker.add_(1)
        sync()
    readers = ({m["name"]: spec.reader_module(m["name"])
                for m in spec.metrics("per_layer", workload)}
               if traced else {})
    started = {name: mod.start() for name, mod in readers.items()
               if hasattr(mod, "start")}
    setup_s = time.perf_counter() - t_start
    answers, lo, hi = drive(server, sched, seconds, limit)
    sync()
    ops = []
    if traced:
        t_read = time.perf_counter()
        prof.__exit__(None, None, None)
        obs.remove_sink(spans.append)
        ops = device_ops(prof) if on_card else []
        del prof
        lag = min((s for _, s, _ in ops), default=anchor) - anchor
        print(f"trace: {len(ops)} device operations, {len(spans)} spans, "
              f"read in {time.perf_counter() - t_read:.2f} s; the marker "
              f"ran {lag * 1e6:.0f} us after its enqueue", file=log)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    done = [a for a in answers if not a["failed"]]
    lat = [math.inf if a["failed"] else a["t1"] - a["t0"] for a in answers]
    q = np.percentile(lat, [10, 50, 90, 100]) * 1e3 if lat else [math.nan]
    print("latency ms p10 p50 p90 max: " + " ".join(f"{x:.2f}" for x in q)
          + f"; {sum(a['t1'] - a['t0'] for a in answers) / (hi - lo):.3f}"
          " of the window inside requests; the first 8 requests' mean "
          f"{np.mean(lat[:8] or [math.nan]) * 1e3:.2f} ms", file=log)
    print("slices: median ms in each sixth of the window: " + " ".join(
        f"{np.median(s) * 1e3:.2f}" if len(s) else "-"
        for s in slice_latencies(answers, lo, hi, 6)), file=log)
    result = {"attempted": len(answers), "failed": len(answers) - len(done)}
    if traced:
        run = Run(answers, trace.Tree(trace.from_span(s) for s in spans),
                  ops, (lo, hi), config, mix, jobs, started)
        metrics = {}
        for m in spec.metrics("per_layer", workload):
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = trace.breakdown(ops, run.tree.spans, lo, hi)
        busy = trace.busy_s(ops, lo, hi)
        result["device_extra"] = {"busy_s": busy, "window_s": hi - lo}
    else:
        e2e = {"setup_s": setup_s, "request_ms_p90": p90(lat) * 1e3,
               "requests_per_s": len(done) / (hi - lo)}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics("end_to_end", workload)}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = int(peak)
    del server
    # the judge: a sample of the jobs served, mapped again by the reference
    t_ref = time.perf_counter()
    picked = judge.sample_jobs([a["job"] for a in answers], seed, JUDGED_JOBS)
    refs = judge.reference_answers({j: jobs[j] for j in picked},
                                   reference_options(config),
                                   mix["hierarchy"], spec.bench_dir)
    judged = [a for a in answers if a["job"] in refs]
    numbers = judge.compare(judged, refs)
    print(f"judged {len(judged)} answers of jobs {picked}; reference "
          f"{time.perf_counter() - t_ref:.2f} s", file=log)
    result["correct"] = judge.verdict(numbers) and result["failed"] == 0
    result["checks"] = {k: {"value": numbers[k], "limit": judge.LIMITS[k]}
                        for k in judge.LIMITS}
    return result
