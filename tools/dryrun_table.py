#!/usr/bin/env python3
"""The dry run's records as one markdown table, a row per (arch, shape)
with the single-pod and two-pod meshes side by side (``p1 / p2``).

Run from the repository root after the dry runs::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    python3 tools/dryrun_table.py [--dir build/dryrun_torch]

Per device: argument and temp GiB, TFLOP, HBM GB, collective GiB by
type (all-gather, all-reduce, reduce-scatter; DTensor ran no
all-to-all or collective-permute in any cell, which the last line
checks), and the fake run's seconds.  The last line counts the statuses.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402

GIB = 2 ** 30
MESHES = ("pod1", "pod2")


def _pair(recs, fn, fmt="{:.2f}"):
    return " / ".join(fmt.format(fn(r)) if r and r["status"] == "ok"
                      else "—" for r in recs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "build",
                                                  "dryrun_torch"))
    args = ap.parse_args(argv)
    status = collections.Counter()
    unused = collections.Counter()
    print("| arch × shape | status | args GiB | temp GiB | TFLOP | HBM GB "
          "| all-gather GiB | all-reduce GiB | reduce-scatter GiB | s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for arch in ARCHS:
        for shape in SHAPES:
            recs = []
            for mesh in MESHES:
                path = os.path.join(args.dir, mesh, f"{arch}__{shape}.json")
                rec = json.load(open(path)) if os.path.exists(path) else None
                recs.append(rec)
                status[rec["status"] if rec else "missing"] += 1
                if rec and rec["status"] == "ok":
                    for kind in ("all-to-all", "collective-permute"):
                        unused[kind] += rec["collectives"]["bytes"][kind]
            sts = " / ".join(r["status"] if r else "missing" for r in recs)
            if all(r and r["status"] == "skipped" for r in recs):
                print(f"| {arch} × {shape} | skipped | | | | | | | | |")
                continue
            coll = [_pair(recs, lambda r, k=k: r["collectives"]["bytes"][k]
                          / GIB) for k in ("all-gather", "all-reduce",
                                           "reduce-scatter")]
            print(" | ".join([
                f"| {arch} × {shape}", sts,
                _pair(recs, lambda r: r["memory"]["argument_size_in_bytes"]
                      / GIB),
                _pair(recs, lambda r: r["memory"]["temp_size_in_bytes"]
                      / GIB),
                _pair(recs, lambda r: r["cost"]["flops"] / 1e12, "{:.3g}"),
                _pair(recs, lambda r: r["cost"]["bytes_hbm"] / 1e9,
                      "{:.4g}"),
                *coll,
                _pair(recs, lambda r: r["time_lower_s"], "{:.0f}")]) + " |")
    print(f"\nstatuses: {dict(status)}; all-to-all and collective-permute "
          f"bytes: {dict(unused)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
