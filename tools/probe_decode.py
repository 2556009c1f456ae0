#!/usr/bin/env python3
"""Decode steps and the flash-attention wrapper at one query, timed on
one NVIDIA GPU, for two source trees in turns.

Run from the repository root::

    git archive HEAD~ | tar -x -C .parent      # the tree to compare with
    python3 tools/probe_decode.py --ab .parent/src

A child process a turn (parent, this tree, this tree, parent, parent,
this tree) imports ``repro_torch`` from the tree it is given (``--src``)
and prints one JSON line:

- ``k2_s1_ms``: the flash-attention wrapper (``ops.flash_attention``) at
  whisper-small's decode cross-attention (q (4, 1, 12, 64) over k, v
  (4, 1500, 12, 64), bfloat16, non-causal), the median of 200 calls by
  CUDA events (the call is host-bound: the wrapper's host work is most
  of it);
- ``decode_ms_per_token`` of the six models of ``chip_smoke.py``'s model
  phases in bfloat16 (yi-6b, mamba2-2.7b, zamba2-1.2b, mixtral-8x22b at
  4 of 56 layers, whisper-small, internvl2-26b), 4 sequences: 31
  ``decode_step`` calls from a cache of the phase's prompt length plus
  16 (zeros; a step's work does not depend on what the cache holds),
  each ending in its tokens' read to the host as ``generate``'s do,
  over the host clock.  Weights are ``init_params(seed=0)``.

The summary line gives each number's runs by tree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (model, layers or 0 for all, cache length): chip_smoke.py's phases
MODELS = (("yi-6b", 0, 4000 + 16), ("mamba2-2.7b", 0, 256 + 16),
          ("zamba2-1.2b", 0, 256 + 16), ("mixtral-8x22b", 4, 5000 + 16),
          ("whisper-small", 0, 64 + 16), ("internvl2-26b", 0, 2048 + 16))
BATCH, STEPS = 4, 31


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def measure() -> dict:
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import decode_step, init_cache, init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((4, 1, 12, 64), (4, 1500, 12, 64),
                             (4, 1500, 12, 64)))
    out = {"k2_s1_ms": cuda_ms(
        lambda: ops.flash_attention(q, k, v, causal=False), 200)}
    ms = {}
    for name, layers, max_seq in MODELS:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = init_params(cfg, 0, "cuda")
        cache = init_cache(cfg, BATCH, max_seq, "cuda")
        tok = torch.zeros((BATCH, 1), dtype=torch.int64, device="cuda")
        with torch.inference_mode():
            decode_step(cfg, params, cache, tok, 0)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(STEPS):
                lg, cache = decode_step(cfg, params, cache, tok, 1 + i)
                tok = lg[:, 0].argmax(-1, keepdim=True)
                tok.cpu()
            ms[name] = (time.perf_counter() - t0) / STEPS * 1e3
        del params, cache
        torch.cuda.empty_cache()
    out["decode_ms_per_token"] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="measure the repro_torch of this tree")
    ap.add_argument("--ab", metavar="PARENT_SRC",
                    help="turns of PARENT_SRC and this tree's src")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
        import torch
        if not torch.cuda.is_available():
            print("probe_decode: torch finds no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(dict(measure(), src=args.src)), flush=True)
        return 0
    here = os.path.join(ROOT, "src")
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent", "parent", "change"):
        src = args.ab if tag == "parent" else here
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--src", src], capture_output=True, text=True,
                             check=True, timeout=1200)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(line, tree=tag)), flush=True)
        runs[tag].append(line)
    summary = {tag: {"k2_s1_ms": [r["k2_s1_ms"] for r in rs],
                     "decode_ms_per_token": {
                         m: [r["decode_ms_per_token"][m] for r in rs]
                         for m, _, _ in MODELS}}
               for tag, rs in runs.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
