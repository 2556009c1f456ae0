#!/usr/bin/env python3
"""Phase ``hier`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

Run from the repository root::

    python3 tools/probe_hier.py [--scale 262144] [--rotations 8] [--profile]

Builds the kernel library, checks the contract kernels against their
plain version and numpy's body (``chip_smoke.contract_cases``: the node
cell's shape timed), partitions the full-size minighost-xk7_sparse stack
on the host for K1's whole-versus-halves check, then runs
``chip_smoke.hier_phase``
(the refinement traps and K1 against its plain version on a proposal
stack on the card, the four node / depth-3 requests cold with their
oracles; no flat requests to set them beside) and, with ``--profile``,
the device time by kernel of one cold node-latency request; last the
all-numpy latency answers, one worker process each, checked.
One JSON line a phase, as ``chip_smoke.py`` prints them; any failed
check raises.  About a minute and a half beside the build on an H100.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=2 ** 18)
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("probe_hier: torch finds no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.mapscore import kernel as ms_kernel
    from repro_torch.kernels.segscan import kernel as seg_kernel
    ms_kernel._launch_fn()
    seg_kernel._launch_fn()
    cs.emit("device", nvidia_smi=cs.nvidia_smi_line(),
            kind=torch.cuda.get_device_name(0), torch=torch.__version__,
            build_seconds=_build.build_info()["seconds"])
    cs.emit("contract", cases=cs.contract_cases())
    lead = cs.SCENARIOS[0].rsplit("-", 1)[0]
    problems = {lead: cs.full_size_problem(lead + "-latency", args.scale,
                                           args.rotations)}
    hier = cs.hier_phase(None, problems, args.scale, args.rotations)
    cs.emit("hier", scale=args.scale, rotations=args.rotations, **hier)
    if args.profile:
        cs.hier_profile(args.scale, args.rotations)
    cs.emit("hier_numpy", requests=cs.numpy_oracles(
        hier["requests"], args.scale, args.rotations))
    cs.emit("done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
