#!/usr/bin/env python3
"""First check of the mapscore kernel on a GPU: compile, compare, time.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit::

    python3 tools/probe_mapscore.py [--old-dir DIR] [--rev REV] [--reps N]
        [--variant NAME[=FILE][:NVCC_FLAGS] ...] [--profile]
        [--stacks NAME ...] [--json FILE]

It compiles ``src/repro_torch/kernels/mapscore/csrc/mapscore.cu`` with
``nvcc -Xptxas -v`` and prints what ptxas reports per kernel (registers,
spills).  The previous design is built beside it from its own three
files, ``csrc/mapscore.cu``, ``kernel.py`` and ``ops.py`` (and its
``ref.py``), which it takes from ``--old-dir`` (default
``build/probe_mapscore/old``), written there first from ``git show
REV:<path>`` (default ``HEAD~``) when missing and the repository has its
history — the copy a remote run gets may not, so write them before.  The
previous wrapper runs as it was, host syncs included, on its own library.
Each design choice of ``mapscore.cu`` is also built the other way, the
others held (``LEVERS``: text edits of the current source, written to
``build/probe_mapscore/NAME.cu`` — zeroing by memset, no reduce beside
the accumulate, other reduce shares, warp-combined atomics), as is each
``--variant``: the current source with extra ``nvcc`` flags
(``NAME:FLAGS``) or another source (``NAME=FILE[:FLAGS]``, for example
an edited copy under ``build/``; it must keep ``mapscore_launch``'s
signature and the parameter struct).  They run through the current
wrapper, as do other group sizes (``GROUPS``) and the current wrapper
behind the parent's host reads (``host-syncs``).  Everything it builds
goes to ``build/probe_mapscore/``, which git ignores.

Then:

1. every small case of ``chip_smoke.small_cases`` under every setting
   against the plain version, both objectives: float metrics within
   ``chip_smoke.RTOL`` / ``ATOL``, ``total_hops``, ``status`` and
   ``shift`` exact, each setting bit-identical to the default;
2. the three full-size candidate stacks ``chip_smoke.py`` scores
   (``STACKS``: scale 2^18, 8 rotations, seed 0), hop-only and with
   traffic: every setting and the old design against the plain version,
   and a rerun bit-identical;
3. at each stack, the median of ``--reps`` CUDA events (wrapper
   included) of the old design, the new one and each setting with the
   others held, in the order old, new, settings, new, old, so that the
   designs compare inside one call; the wrapper's host time; and the
   device time when a sleep kernel queued first hides the host's share;
4. with ``--profile``, one call of each at each stack under
   ``torch.profiler``: device time by kernel name, wall time, idle share,
   and the new design's kernels in launch order with the gaps between.

It checks nothing and exits 0 when everything ran (``chip_smoke.py``
holds the limits); the results also go to ``--json`` (default
``build/probe_mapscore/report.json``).  Meant as the short first call
after a change to the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (imports no torch at the top)

PKG = "src/repro_torch/kernels/mapscore"
OLD_FILES = ("csrc/mapscore.cu", "kernel.py", "ops.py", "ref.py")
OUT = os.path.join(ROOT, "build", "probe_mapscore")
STACKS = ("minighost-xk7_sparse-flat", "homme-bgq_block-flat",
          "random-tpu_mesh-flat")
SCALE, ROTATIONS = 2 ** 18, 8
PTXAS_KEYS = ("Compiling entry", "registers", "spill")


# each design choice of mapscore.cu built the other way, the others held:
# {name: [(text of the current source, its replacement[, copies]), ...]}
# (an edit applies to every copy of the text; 1 copy unless stated)
_STEP = ("        err = launch_step(blocks, nred, st, table, e32, w, inv_bw, "
         "scr, acc,\n                          red, buf, p);\n")
LEVERS = {
    # the workspace zeroed by a memset after each reduce, not by the reduce
    "memset": [
        ("                    if (v[j] != 0) col[(int64_t)(cb + j) * rows] = "
         "0;\n", ""),
        (_STEP, _STEP + "        if (err == cudaSuccess && red >= 0)\n"
         "            err = cudaMemsetAsync(scr + p.ws_off + (1 - buf) * "
         "(int64_t)p.group * p.nd * p.unit, 0, (size_t)p.group * p.nd * "
         "p.unit * 8, st);\n")],
    # a group's reduce in a launch of its own, before the next accumulate
    "no-overlap": [
        (_STEP, _STEP.replace("acc,\n", "-1,\n") + "        if (err == "
         "cudaSuccess)\n" + _STEP.replace("red, buf", "-1, buf"))],
    "red4": [("kRedShare16 = 6;", "kRedShare16 = 4;")],
    "red8": [("kRedShare16 = 6;", "kRedShare16 = 8;")],
    # lanes of a warp that aim at the same workspace entry add their
    # values first (integer sums: still exact), one atomic a group
    "combine": [
        ("// The difference-array entries of one message",
         "__device__ __forceinline__ void combined_add(int64_t* p, int64_t v)"
         " {\n"
         "    const unsigned peers = __match_any_sync(__activemask(),\n"
         "                                            (unsigned long long)p);"
         "\n"
         "    int64_t sum = 0;\n"
         "    for (unsigned m = peers; m; m &= m - 1)\n"
         "        sum += __shfl_sync(peers, v, __ffs(m) - 1);\n"
         "    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)"
         " atomic_add_i64(p, sum);\n"
         "}\n\n"
         "// The difference-array entries of one message"),
        ("atomic_add_i64(wsc", "combined_add(wsc", 4)],
}
# candidates per group, up to the wrapper's cap of a quarter of the stack
GROUPS = (1, 2)


def old_sources(old_dir: str, rev: str) -> str | None:
    """Directory of the previous design's package ``old_mapscore``,
    written from ``git show REV:<path>`` first where files are missing."""
    pkg = os.path.join(old_dir, "old_mapscore")
    os.makedirs(os.path.join(pkg, "csrc"), exist_ok=True)
    for name in OLD_FILES:
        path = os.path.join(pkg, name)
        if not os.path.exists(path):
            r = subprocess.run(["git", "-C", ROOT, "show",
                                f"{rev}:{PKG}/{name}"],
                               capture_output=True, text=True)
            if r.returncode != 0:
                return None
            with open(path, "w") as f:
                f.write(r.stdout)
    open(os.path.join(pkg, "__init__.py"), "a").close()
    return old_dir


def lever_source(src: str, name: str) -> str:
    """Path of ``build/probe_mapscore/NAME.cu``: the source at ``src``
    with lever ``name``'s edits; each edited text must occur once."""
    with open(src) as f:
        text = f.read()
    for old, new, *copies in LEVERS[name]:
        want = copies[0] if copies else 1
        if text.count(old) != want:
            raise SystemExit(f"lever {name}: the source has {text.count(old)}"
                             f" copies of {old!r}, not {want}; update LEVERS")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(builds: dict) -> dict:
    """{name: (source, extra flags)} -> {name: library}, compiled side by
    side with ``-Xptxas -v``; prints ptxas' lines per build."""
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (src, flags) in builds.items():
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared",
               "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        print(f"== {name}: nvcc exit {proc.returncode}", flush=True)
        lines = [ln for ln in out.splitlines()
                 if any(k in ln for k in PTXAS_KEYS)]
        print("\n".join(lines if proc.returncode == 0 else out.splitlines()),
              flush=True)
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def old_wrapper(old_dir: str, lib: str):
    """The previous design's ``ops`` module, bound to ``lib``."""
    sys.path.insert(0, old_dir)
    kernel = importlib.import_module("old_mapscore.kernel")
    ops = importlib.import_module("old_mapscore.ops")
    cdll = ctypes.CDLL(lib)
    cdll.mapscore_error_string.restype = ctypes.c_char_p
    cdll.mapscore_error_string.argtypes = [ctypes.c_int]
    fn = cdll.mapscore_launch
    fn.restype = ctypes.c_int
    # every argument of the old ``mapscore_launch`` before the parameter
    # struct and the stream is a device address
    nptr = len(inspect.signature(kernel.mapscore_launch).parameters) - 2
    fn.argtypes = [ctypes.c_void_p] * nptr + [
        ctypes.POINTER(kernel.MapscoreParams), ctypes.c_void_p]
    kernel._LAUNCH = (fn, cdll.mapscore_error_string)
    return ops


def bind(lib: str) -> tuple:
    """``kernel._LAUNCH`` of the library at ``lib`` (a variant's build)."""
    from repro_torch.kernels.mapscore import kernel
    cdll = ctypes.CDLL(lib)
    cdll.mapscore_error_string.restype = ctypes.c_char_p
    cdll.mapscore_error_string.argtypes = [ctypes.c_int]
    fn = cdll.mapscore_launch
    fn.restype = ctypes.c_int
    fn.argtypes = kernel._launch_fn()[0].argtypes
    return fn, cdll.mapscore_error_string


def calls(ops, old_ops, variants, machine, cs, edges, w, inv_bw, traffic):
    """{name: zero-argument call} of every design, variant and lever
    setting."""
    from repro_torch.kernels.mapscore import kernel as k
    kw = dict(dims=machine.dims, wrap=machine.wrap,
              core_dims=machine.core_dims, traffic=traffic)
    _, _, per_cand = k.workspace_layout(machine.dims, machine.core_dims)
    out = {"new": lambda: ops.mapscore(cs, edges, w, inv_bw, **kw)}
    if old_ops is not None:
        out["old"] = lambda: old_ops.mapscore(cs, edges, w, inv_bw, **kw)

    def host_syncs():
        """The parent wrapper's host reads before its launch (edge range,
        coordinate range, |w| sum), then the current wrapper."""
        import torch
        lo, hi = torch.aminmax(edges)
        int(lo), int(hi)
        cs.amin(dim=(0, 1)).tolist(), cs.amax(dim=(0, 1)).tolist()
        float(w.abs().sum(dtype=torch.float64))
        return ops.mapscore(cs, edges, w, inv_bw, **kw)
    out["host-syncs"] = host_syncs

    def on(launch):
        own = k._LAUNCH
        k._LAUNCH = launch
        try:
            return ops.mapscore(cs, edges, w, inv_bw, **kw)
        finally:
            k._LAUNCH = own
    for name, launch in variants.items():
        out[name] = lambda launch=launch: on(launch)
    if not traffic:
        return out
    for n in GROUPS:
        out[f"group{n}"] = (lambda n=n: ops.unpack(ops._scores(
            cs, edges, w, inv_bw, **kw, group_elems=n * per_cand),
            cs.shape[0], traffic))
    return out


def timeline(call) -> list:
    """Device time of each kernel and copy of one call, in launch order
    (microseconds), with the gap before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                 key=lambda e: e.time_range.start)
    out, end = [], None
    for e in evs:
        gap = 0.0 if end is None else e.time_range.start - end
        out.append([e.name.split("(")[0][-24:],
                    round(e.time_range.elapsed_us(), 1), round(gap, 1)])
        end = e.time_range.end
    return out


def host_costs() -> dict:
    """Host microseconds of the calls the wrapper makes before its
    launch (median of 2000)."""
    import statistics
    import time
    import torch
    dev = torch.device("cuda", 0)
    x = torch.zeros((8, 64, 4), dtype=torch.int32, device=dev)
    calls = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "empty": lambda: torch.empty(34, dtype=torch.int64, device=dev),
        "data_ptr": x.data_ptr,
        "check": lambda: ops_module()._check(x, "x", torch.int32, 3, dev),
    }
    out = {}
    for name, fn in calls.items():
        ts = []
        for _ in range(2000):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        out[name] = statistics.median(ts) * 1e6
    return out


def ops_module():
    from repro_torch.kernels.mapscore import ops
    return ops


def queued_ms(call, reps: int) -> float:
    """Median device time of ``call`` when the card is kept busy while
    the host prepares it (a 2 ms sleep kernel queued first, its own time
    taken off): what a caller that queues work ahead pays."""
    import statistics
    import torch
    cycles = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)

    def sleep():
        torch.cuda._sleep(cycles)
    base = statistics.median(
        [smoke.cuda_ms(sleep, 1, 1) for _ in range(5)])
    both = smoke.cuda_ms(lambda: (sleep(), call()), reps)
    return both - base


def host_time_us(call, reps: int) -> float:
    """Median host time of ``call`` from entry to return (the card idle
    before each call): the wrapper's own cost, syncs included."""
    import statistics
    import time
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def compare(name, machine, cs, edges, w, inv_bw, traffic, runs, record):
    """Every call in ``runs`` against the plain version; new twice."""
    import numpy as np
    import torch
    from repro_torch.kernels.mapscore import ref
    want = ref.mapscore_ref(cs, edges, w, inv_bw, dims=machine.dims,
                            wrap=machine.wrap, core_dims=machine.core_dims,
                            traffic=traffic)
    new = runs["new"]()
    for lib, call in runs.items():
        got = call()
        again = call() if lib == "new" else None
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for key, r in want.items():
            if key not in got:
                continue
            g, rr = got[key].cpu().numpy(), r.cpu().numpy()
            if key in smoke.EXACT_KEYS:
                ok &= bool(np.array_equal(g, rr))
            else:
                ok &= bool(np.allclose(g, rr, rtol=smoke.RTOL,
                                       atol=smoke.ATOL))
                err = max(err, float(np.max(np.abs(g - rr))))
        same = all(torch.equal(got[key], new[key]) for key in new
                   if key in got)
        rerun = (all(torch.equal(again[key], got[key]) for key in got)
                 if again is not None else None)
        line = {"case": name, "traffic": traffic, "lib": lib,
                "max_abs_err": err, "within_tol": ok,
                "equal_to_new": same, "rerun_bit_identical": rerun}
        print(json.dumps(line), flush=True)
        record.append(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", default=os.path.join(OUT, "old"))
    ap.add_argument("--rev", default="HEAD~")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME[=FILE][:NVCC_FLAGS]")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stacks", nargs="*", default=list(STACKS),
                    choices=STACKS)
    ap.add_argument("--json", default=os.path.join(OUT, "report.json"))
    args = ap.parse_args(argv)
    import torch
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import kernel, ops
    if not torch.cuda.is_available():
        print("probe_mapscore: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.nvidia_smi_line()
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(ROOT, PKG, "csrc", "mapscore.cu")
    builds = {"new": (src, [])}
    for name in LEVERS:
        builds[name] = (lever_source(src, name), [])
    for v in args.variant:
        name, _, flags = v.partition(":")
        name, _, path = name.partition("=")
        builds[name] = (os.path.abspath(path) if path else src, flags.split())
    old_dir = old_sources(args.old_dir, args.rev)
    if old_dir:
        builds["old"] = (os.path.join(old_dir, "old_mapscore", "csrc",
                                      "mapscore.cu"), [])
    else:
        print("no previous sources: old design not timed", flush=True)
    libs = build(builds)
    kernel._launch_fn()  # the port's own build, for ops.mapscore
    old_ops = old_wrapper(old_dir, libs["old"]) if "old" in libs else None
    variants = {name: bind(lib) for name, lib in libs.items()
                if name not in ("new", "old")}
    report = {"nvidia_smi": smi, "checks": [], "timed": [], "profiles": [],
              "host_us": host_costs()}
    print("host_us", json.dumps(report["host_us"]), flush=True)

    for name, m, e, w, st in smoke.small_cases():
        for traffic in (False, True):
            cs, edges, wt, inv_bw = scoring_inputs(m, e, w, st, traffic,
                                                   "cuda")
            compare(name, m, cs, edges, wt, inv_bw, traffic,
                    calls(ops, old_ops, variants, m, cs, edges, wt, inv_bw,
                          traffic),
                    report["checks"])

    for stack in args.stacks:
        prob = smoke.full_size_problem(stack + "-latency", SCALE, ROTATIONS)
        req, st = prob["req"], prob["stack"]
        m = req.alloc.machine
        for traffic in (True, False):
            cs, edges, w, inv_bw = scoring_inputs(
                m, req.graph.edges, req.graph.weights, st, traffic, "cuda")
            runs = calls(ops, old_ops, variants, m, cs, edges, w, inv_bw,
                         traffic)
            compare(stack, m, cs, edges, w, inv_bw, traffic, runs,
                    report["checks"])
            order = [v for v in ("old", "new") if v in runs]
            order = order + [v for v in runs if v not in order] + order[::-1]
            times = [(lib, smoke.cuda_ms(runs[lib], args.reps))
                     for lib in order]
            host_us = {lib: host_time_us(runs[lib], args.reps)
                       for lib in ("old", "new") if lib in runs}
            queued = {lib: queued_ms(runs[lib], args.reps)
                      for lib in ("old", "new") if lib in runs}
            bound = smoke.bound(m, cs, edges, w, inv_bw, traffic, "x")
            line = {"case": stack, "traffic": traffic,
                    "dims": list(m.dims), "nb": int(cs.shape[0]),
                    "ne": int(edges.shape[0]),
                    "ms": [[k, v] for k, v in times],
                    "host_us": host_us, "queued_ms": queued,
                    "bound_ms": bound["bound_ms_x"],
                    "bound_by": bound["bound_by_x"]}
            print("timed", json.dumps(line), flush=True)
            report["timed"].append(line)
            if args.profile and traffic:
                for lib, call in runs.items():
                    try:
                        prof = smoke.device_profile(call)
                    except AssertionError as exc:  # an empty trace
                        print("profile", stack, lib, exc, flush=True)
                        continue
                    if lib == "new":
                        print("timeline", stack, json.dumps(timeline(call)),
                              flush=True)
                    line = {"case": stack, "lib": lib,
                            **{k: v for k, v in prof.items()
                               if k != "by_name"},
                            "us_by_kernel": {
                                n.split("(")[0][:40]: [round(v["us"], 1),
                                                       v["calls"]]
                                for n, v in prof["by_name"].items()}}
                    print("profile", json.dumps(line), flush=True)
                    report["profiles"].append(line)
            del cs, edges, w, inv_bw, runs
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
