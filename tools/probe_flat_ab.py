#!/usr/bin/env python3
"""A/B of the flat mapping path on one GPU: cold flat requests served by
two source trees in turns.

Run from the repository root, with the other tree unpacked into a
directory that ``.gitignore`` lists (``git archive HEAD~ | tar -x -C
.parent``)::

    python3 tools/probe_flat_ab.py [--a parent=.parent] [--b change=.]
                                   [--procs 3] [--reps 3]

Each turn is a fresh process that imports ``repro_torch`` from one
tree's ``src/`` (its kernels built under that tree), serves one
warm-up request, then each of the first three flat scenarios of
``chip_smoke.SCENARIOS`` ``--reps`` times at 2^18 tasks and 8 rotations,
each through a fresh ``MappingService`` (a cold answer): per request the
service's latency and ``stats["timings"]["fused_s"]`` (host clock).
Turns go A B B A A B ...; ``--procs`` is the number of turns a tree.
Prints one JSON line a turn and one of medians a tree and scenario, and
writes every sample to ``chiprun_out/ab_flat.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("minighost-xk7_sparse-flat-wh",
             "minighost-xk7_sparse-flat-latency",
             "homme-bgq_block-flat-latency")


def child(reps: int) -> None:
    """One turn: the samples of this process's tree as a JSON line."""
    import torch
    from repro_torch.serve import MappingService, get_scenario
    reqs = {n: get_scenario(n, scale=2 ** 18, rotations=8).request()
            for n in SCENARIOS}
    MappingService().map(reqs[SCENARIOS[0]])       # build, first use
    torch.cuda.synchronize()
    out = {}
    for name, req in reqs.items():
        out[name] = []
        for _ in range(reps):
            resp = MappingService().map(req)
            torch.cuda.synchronize()
            out[name].append([resp.latency_s,
                              resp.result.stats["timings"]["fused_s"]])
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", default="parent=.parent")
    ap.add_argument("--b", default="change=.")
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.reps)
        return 0
    trees = dict(t.split("=", 1) for t in (args.a, args.b))
    a, b = list(trees)
    order = [(a, b) if i % 2 == 0 else (b, a) for i in range(args.procs)]
    turns = []
    for label in (x for pair in order for x in pair):
        root = os.path.abspath(os.path.join(ROOT, trees[label]))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--reps", str(args.reps)],
                           cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            return 1
        samples = json.loads(r.stdout.strip().splitlines()[-1])
        turns.append([label, samples])
        print(json.dumps({"turn": label, "samples": samples}), flush=True)
    medians = {label: {n: {"cold_s": statistics.median(
        s[0] for t, sm in turns if t == label for s in sm[n]),
        "fused_s": statistics.median(
        s[1] for t, sm in turns if t == label for s in sm[n])}
        for n in SCENARIOS} for label in trees}
    print(json.dumps({"medians": medians, "turns": len(turns),
                      "reps": args.reps}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_flat.json"), "w") as f:
        json.dump({"turns": turns, "medians": medians}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
