"""Read the comparison's numbers of the control, for setting limits.

    python3 portbench/control.py --workload <cell> --seed <n> \
        [--seconds <s>] [--requests <n>]

The control is the plain reference put in the program's place with one
guarantee of the configuration broken: it serves the identity rotation's
mapping instead of the best of the rotation search.  The run drives the
cell's traffic through it, as many requests as a run of the program
sends, and judges its answers as a run of the program is judged; it
prints the compared numbers, one JSON line.  The benchmark's own runs
never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--requests", type=int, default=400)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]
    from pbench.cell import run_cell
    from pbench.spec import Spec
    res = run_cell(Spec(BENCH_DIR.parent, BENCH_DIR), args.workload,
                   args.seed, args.seconds, False,
                   t_start=time.perf_counter(), device="cpu",
                   serve="control", limit=args.requests)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"],
                      "checks": {k: v["value"]
                                 for k, v in res["checks"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
