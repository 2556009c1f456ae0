#!/usr/bin/env python3
"""Probe of the device partitioner and its kernels (segscan, mjfinish)
on one GPU.

Run from the repository root (one CUDA device and ``nvcc``)::

    python3 tools/probe_partition.py [--scale 262144] [--profile]
                                     [--mjfinish]

1. ``nvcc -Xptxas -v`` on ``csrc/segscan.cu`` and ``csrc/mjfinish.cu``:
   registers, shared memory, spills; with ``--mjfinish``, mjfinish at
   the main path's shapes (``chip_smoke.mjfinish_cases``) first;
2. segscan against its plain version, exactly, on random segment
   layouts, and a rerun bit for bit;
3. the device engine (``core/partition_torch.py``) against the host
   engine on random clouds (every SFC, weights with zeros, uneven
   primes, dims 1-3, strict alternation, duplicate-heavy grids) and on
   ``chip_smoke.signed_zero_cloud`` under FZ and Gray, each sweep under
   ``set_sync_debug_mode("error")`` (an unweighted one launches mjfinish
   where it hands off);
4. with ``--scale``: both sides of ``chip_smoke.SCENARIOS[1]``'s rotation
   sweep at that many tasks, unweighted and with weights on the task
   side, through ``chip_smoke.partition_case`` (host engine and device
   times, CUDA events), and segscan at the first level's layout timed
   beside ``torch.cumsum``; with ``--profile`` also the device time by
   kernel name of one sweep per side (``torch.profiler``).

It exits non-zero at the first disagreement; ``chip_smoke.py`` holds the
same checks at full size.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SRCS = ("src/repro_torch/kernels/segscan/csrc/segscan.cu",
        "src/repro_torch/kernels/mjfinish/csrc/mjfinish.cu")


def ptxas_report(src: str) -> str:
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "kernel.o"),
                            os.path.join(ROOT, src)],
                           capture_output=True, text=True)
    return f"{src}: nvcc exit {r.returncode}\n{r.stdout}{r.stderr}"


def random_cases(count: int):
    """(name, order_points_batched kwargs) on small random clouds."""
    import numpy as np
    sfcs = ("Z", "Gray", "FZ", "FZlow", "H")
    for seed in range(count):
        rng = np.random.default_rng(seed)
        d = int(rng.integers(1, 4))
        n = int(rng.integers(2, 3000))
        nparts = int(rng.integers(1, 300))
        w = None
        if seed % 3 == 0:
            w = rng.random(n)
            w[::4] = 0.0
        coords = rng.normal(size=(n, d))
        if seed % 4 == 0:
            coords = rng.integers(0, 4, size=(n, d)).astype(float)
        dos = np.stack([rng.permutation(d)
                        for _ in range(int(rng.integers(1, 5)))])
        yield f"random{seed}", dict(
            coords=coords, nparts=nparts, sfc=sfcs[seed % 5],
            dim_orders=dos, weights=w, longest_dim=seed % 5 != 1,
            uneven_prime=bool(seed % 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=0)
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--cases", type=int, default=60)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--mjfinish", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.partition_torch import run, upload
    from repro_torch.kernels import _build
    from repro_torch.kernels.segscan import kernel, ops, ref
    if not torch.cuda.is_available():
        print("probe_partition: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    for src in SRCS:
        print(ptxas_report(src), flush=True)
    kernel._launch_fn()
    print("build", _build.build_info(), flush=True)
    if args.mjfinish:
        for rec in cs.mjfinish_cases():
            print("mjfinish", rec, flush=True)

    rng = np.random.default_rng(1)
    for i in range(8):
        n = int(rng.integers(1, 200_000))
        lens = rng.integers(1, [3, 40, 5000, 200_000][i % 4], size=n)
        ends = np.minimum(np.cumsum(lens), n)
        starts = np.unique(np.concatenate([[0], ends[:-1]]))
        starts = starts[starts < n]
        size = np.diff(np.append(starts, n))
        st = torch.from_numpy(np.repeat(starts, size)).cuda()
        sz = torch.from_numpy(np.repeat(size, size)).cuda()
        w = torch.from_numpy(rng.random(n) * 10.0 ** rng.uniform(-6, 6, n)
                             ).cuda()
        got = cs.no_sync(ops.segscan, w, st, sz)
        again = ops.segscan(w, st, sz)
        want = ref.segscan_ref(w, st, sz)
        cs.check(torch.equal(got, want) and torch.equal(got, again),
                 f"segscan case {i}: kernel differs")
        print("segscan", i, "n", n, "segments", len(starts), "exact", True,
              flush=True)

    for name, kw in random_cases(args.cases):
        cs.partition_case(name, kw)
    pts = cs.signed_zero_cloud()
    for sfc in ("FZ", "Gray", "FZlow"):
        for w in (None, np.linspace(0.5, 2.0, len(pts))):
            rec = cs.partition_case(
                f"signed-zeros/{sfc}", dict(
                    coords=pts, nparts=64, sfc=sfc,
                    dim_orders=np.array([[0, 1, 2], [2, 0, 1]]),
                    weights=w, longest_dim=True, uneven_prime=False))
            print("signed-zeros", sfc, "weighted", w is not None,
                  "bit-identical, device_ms", rec["device_ms"], flush=True)
    print("random cases bit-identical:", args.cases, flush=True)

    if args.scale:
        name = cs.SCENARIOS[1]
        prob = cs.full_size_problem(name, args.scale, args.rotations)
        wprob = cs.full_size_problem(name, args.scale, args.rotations,
                                     weights_seed=0)
        for tag, p in (("", prob), ("+weights", wprob)):
            for side, kw in p["sides"].items():
                if tag and side == "proc":
                    continue
                rec = cs.partition_case(f"{name}{tag}/{side}", kw,
                                        p["host"][side])
                print("timed", rec, flush=True)
                if args.profile:
                    inp = upload(**kw, device="cuda")
                    prof = cs.device_profile(lambda: run(inp))
                    top = sorted(prof["by_name"].items(),
                                 key=lambda kv: -kv[1]["us"])[:12]
                    print("profile", side + tag,
                          {k: v for k, v in prof.items() if k != "by_name"},
                          flush=True)
                    for k, v in top:
                        print("   ", round(v["us"], 1), v["calls"], k[:90],
                              flush=True)
        wkw = wprob["sides"]["task"]
        for rec in cs.segscan_cases(len(wkw["dim_orders"]),
                                    len(wkw["coords"])):
            print("timed segscan", rec, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
