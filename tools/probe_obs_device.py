"""Probe: what device spans cost, and whether their clock agrees with the
profiler's.

    python3 tools/probe_obs_device.py spans
    python3 tools/probe_obs_device.py clock --workload <cell> --seed <n>
    python3 tools/probe_obs_device.py cost --workload <cell> --seed <n>

``spans``: host microseconds a span, device timing off and armed, for a
host span and a device span (the armed device span pays its two events
and, at its root's close, their resolution).

``clock``: one traced run of the cell (``pbench.cell.run_cell``, as the
benchmark's ``--trace 1``), keeping its spans and the profiler's device
operations: the share of ``mapscore_*`` kernels that lie inside a
``sweep.score`` device interval and the distance from each such kernel's
end to its interval's end, with the operations on the harness's clock
and on one corrected by each request's own epoch offset, and once more
with the profiler's offset taken out request by request (the first
device-to-host copy after the scoring put at ``sweep.score``'s device
close); and, with no
profiler involved, how long after the host recorded a span's open event
the card reached it, and how long before ``sweep.select`` closed the
card finished the scoring (neither may be negative).

``cost``: one process serves the cell's jobs (the benchmark's generator,
one seed) in back-to-back windows of ``--seconds``: device timing off,
armed, off, armed, ..., then one window traced as the benchmark traces
(the profiler on, spans collected, timing armed); each window's p50, p90
and requests a second.

Needs a CUDA card; writes ``chiprun_out/probe_obs_device/<phase>.<cell>.json``.
"""

import argparse
import bisect
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]
OUT = ROOT / "chiprun_out" / "probe_obs_device"


def card() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe measures the card")
    return {"device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def spans_phase(args) -> dict:
    import torch

    from repro_torch import obs
    x = torch.zeros(1, device="cuda")
    n = args.spans
    out = {}
    for armed in (False, True):
        obs.device_time(armed)
        for device in (False, True):
            for _ in range(2):                    # the first pass warms
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with obs.span("probe.root"):
                    for _ in range(n):
                        with obs.span("probe", device=device):
                            x.add_(1)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize()
            bare = time.perf_counter() - t0
            key = f"{'armed' if armed else 'off'}.{'device' if device else 'host'}"
            out[key] = (dt - bare) / n * 1e6
    obs.device_time(False)
    obs.reset()
    return {"us_a_span": out, "spans": n}


def inside(intervals, lo, hi):
    """The interval of ``intervals`` (sorted by start) holding
    ``[lo, hi]``, or None."""
    for a, b in intervals:
        if a <= lo and hi <= b:
            return a, b
        if a > lo:
            break
    return None


def clock_phase(args) -> dict:
    from pbench import cell as pcell
    from pbench.spec import Spec
    from repro_torch import obs
    got, full = {}, []
    breakdown, device_ops = pcell.trace.breakdown, pcell.device_ops

    def keep(ops, spans, lo, hi, top=10):
        got.update(ops=ops, spans=spans)
        return breakdown(ops, spans, lo, hi, top)

    def ops_and_epoch(prof):
        got["epoch_s"] = (time.time_ns() - time.perf_counter_ns()) * 1e-9
        return device_ops(prof)

    pcell.trace.breakdown, pcell.device_ops = keep, ops_and_epoch
    obs.add_sink(full.append)
    res = pcell.run_cell(Spec(ROOT, ROOT / "portbench"), args.workload,
                         args.seed, args.seconds, True,
                         t_start=time.perf_counter())
    obs.remove_sink(full.append)
    spans = got["spans"]
    # the harness puts the profiler's epoch stamps on perf_counter with
    # one offset taken after the window; each request's root also holds
    # its own (wall - t0) pair, which follows a drift between the two
    roots = sorted((s.t0, s.wall - s.t0) for s in full
                   if s.name == "serve.request")
    starts = [t for t, _ in roots]

    def per_request(t):
        i = max(bisect.bisect_right(starts, t) - 1, 0)
        return t + got["epoch_s"] - roots[i][1]

    def intervals(name):
        return sorted((s.attrs["device_t0_s"], s.attrs["device_t1_s"])
                      for s in spans if s.name == name
                      and "device_t0_s" in s.attrs)

    score = intervals("sweep.score")

    def k1_check(shift):
        k1 = [(shift(s), shift(s) + d) for name, s, d in got["ops"]
              if "mapscore_" in name]
        ends, missed = [], []
        for lo, hi in k1:
            iv = inside(score, lo, hi)
            if iv is None:
                near = min(score, key=lambda ab: abs(ab[1] - hi),
                           default=None)
                missed.append(None if near is None else
                              [(lo - near[0]) * 1e6, (near[1] - hi) * 1e6])
            else:
                ends.append((iv[1] - hi) * 1e6)
        return {"kernels": len(k1),
                "inside_share": len(ends) / len(k1) if k1 else None,
                "end_to_interval_end_us": {
                    "median": statistics.median(ends) if ends else None,
                    "max": max(ends) if ends else None,
                    "min": min(ends) if ends else None},
                "outside": missed[:10]}

    # causality, with no profiler involved: the card reaches a span's
    # open event after the host recorded it, and the scores are on the
    # host when sweep.select closes
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, {})[s.name] = s
    after_open = [(s.attrs["device_t0_s"] - s.t0) * 1e6 for s in spans
                  if "device_t0_s" in s.attrs]
    before_read = [(k["sweep.select"].t1
                    - k["sweep.score"].attrs["device_t1_s"]) * 1e6
                   for k in by_parent.values()
                   if "sweep.select" in k and "sweep.score" in k
                   and "device_t1_s" in k["sweep.score"].attrs]

    # the profiler's clock against the host's: no K1 kernel can start
    # before its sweep.score span opened on the host
    host_open = sorted(s.t0 for s in spans if s.name == "sweep.score")

    def k1_after_host(shift):
        early = []
        for name, st, _ in got["ops"]:
            if "mapscore_" in name:
                t = shift(st)
                i = bisect.bisect_right(host_open, t) - 1
                nxt = host_open[i + 1] if i + 1 < len(host_open) else None
                # a kernel is early when it starts before the open of the
                # sweep.score span that follows it closely (within 5 ms)
                if nxt is not None and nxt - t < 5e-3:
                    early.append((nxt - t) * 1e6)
        return {"early": len(early), "largest_us": max(early, default=0)}

    # the profiler's offset taken out request by request: the first
    # device-to-host copy after the scoring (copy (i), which follows
    # sweep.score's close event on the stream) is put at that event, and
    # the request's K1 kernels are checked against its sweep.score
    # interval (the device metrics read intervals and differences, which
    # an offset between the two clocks leaves alone)
    def per_request_fit():
        copies = sorted(st for name, st, _ in got["ops"] if "DtoH" in name)
        k1 = sorted((st, st + d) for name, st, d in got["ops"]
                    if "mapscore_" in name)
        k1_starts = [a for a, _ in k1]
        offsets, ends, outside = [], [], 0
        for sp in spans:
            if sp.name != "sweep.score" or "device_t0_s" not in sp.attrs:
                continue
            lo, hi = sp.attrs["device_t0_s"], sp.attrs["device_t1_s"]
            i = bisect.bisect_left(copies, hi - 10e-3)
            if i == len(copies) or copies[i] > hi + 10e-3:
                continue
            off = copies[i] - hi
            offsets.append(off * 1e6)
            a = bisect.bisect_left(k1_starts, lo + off - 10e-3)
            b = bisect.bisect_right(k1_starts, hi + off)
            for ks, ke in k1[a:b]:
                ks, ke = ks - off, ke - off
                if lo <= ks and ke <= hi:
                    ends.append((hi - ke) * 1e6)
                else:
                    outside += 1
        n = len(ends) + outside
        return {"intervals": len(offsets), "kernels": n,
                "inside_share": len(ends) / n if n else None,
                "end_to_interval_end_us": {
                    "median": statistics.median(ends) if ends else None,
                    "max": max(ends, default=None),
                    "min": min(ends, default=None)},
                "profiler_offset_us": {
                    "median": statistics.median(offsets) if offsets
                    else None,
                    "min": min(offsets, default=None),
                    "max": max(offsets, default=None)}}

    def stats(xs):
        return {"n": len(xs), "min": min(xs, default=None),
                "median": statistics.median(xs) if xs else None}

    names = sorted({n for n, _, _ in got["ops"]})
    return {
        "metrics": res["metrics"], "correct": res["correct"],
        "breakdown": res["breakdown"], "device_extra": res["device_extra"],
        "score_intervals": len(score),
        "k1_harness_clock": k1_check(lambda t: t),
        "k1_per_request_clock": k1_check(per_request),
        "k1_aligned_per_request": per_request_fit(),
        "k1_before_host_open_harness": k1_after_host(lambda t: t),
        "k1_before_host_open_per_request": k1_after_host(per_request),
        "device_t0_after_host_open_us": stats(after_open),
        "score_end_before_select_close_us": stats(before_read),
        "event_like_ops": [n for n in names
                           if any(w in n.lower() for w in
                                  ("event", "sync", "record"))],
    }


def cost_phase(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pbench import cell as pcell
    from pbench import gen
    from pbench import traffic as ptraffic
    from pbench.spec import Spec
    from repro_torch import obs
    spec = Spec(ROOT, ROOT / "portbench")
    cellspec = spec.workload(args.workload)
    config = spec.config(cellspec["config"])
    mix = spec.traffic(cellspec["traffic"])
    pool, nwarm = int(mix["pool"]), int(mix["warmup_jobs"])
    jobs = gen.job_pool(config, args.seed, pool + nwarm)
    port = pcell.Port(config, mix, jobs, "cuda")
    for j in range(pool, pool + nwarm):
        port.serve(j)
    torch.cuda.synchronize()
    sched = ptraffic.schedule(mix, args.seed)
    windows = []
    modes = ["off", "armed"] * args.pairs + ["traced"]
    for mode in modes:
        obs.device_time(mode != "off")
        spans, prof = [], None
        if mode == "traced":
            obs.add_sink(spans.append)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        answers, lo, hi = pcell.drive(port, sched, args.seconds)
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
            obs.remove_sink(spans.append)
            del prof
        obs.reset()
        lat = sorted(a["t1"] - a["t0"] for a in answers
                     if not a["failed"])
        failed = sum(a["failed"] for a in answers)
        windows.append({
            "mode": mode, "requests": len(answers), "failed": failed,
            "p50_ms": statistics.median(lat) * 1e3,
            "p90_ms": pcell.p90([math.inf] * failed + lat) * 1e3,
            "requests_per_s": len(lat) / (hi - lo)})
        print(json.dumps(windows[-1]), flush=True)
    obs.device_time(False)

    def med(mode, key):
        return statistics.median(w[key] for w in windows
                                 if w["mode"] == mode)
    summary = {m: {k: med(m, k) for k in ("p50_ms", "p90_ms",
                                          "requests_per_s")}
               for m in ("off", "armed", "traced")}
    return {"windows": windows, "median": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("spans", "clock", "cost"))
    ap.add_argument("--workload", default="minighost-xk7.cold")
    ap.add_argument("--seed", type=int, default=4300000026)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--spans", type=int, default=20000)
    args = ap.parse_args(argv)
    info = card()
    res = {"spans": spans_phase, "clock": clock_phase,
           "cost": cost_phase}[args.phase](args)
    res = {"phase": args.phase, "workload": args.workload,
           "seed": args.seed, **info, **res}
    OUT.mkdir(parents=True, exist_ok=True)
    name = args.phase if args.phase == "spans" else \
        f"{args.phase}.{args.workload}"
    (OUT / f"{name}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("breakdown", "windows")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
