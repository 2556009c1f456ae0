#!/usr/bin/env python3
"""First check of the SSD kernel on a GPU: compile, compare, time.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit::

    python3 tools/probe_ssd.py

It compiles ``src/repro_torch/kernels/ssd/csrc/ssd.cu`` alone with
``nvcc -Xptxas -v`` and prints what ptxas reports (registers, spills),
builds the port's kernel library, then for each shape and dtype launches
the kernel twice and compares it with its plain version (the sequential
recurrence): max abs error, the output's mean and max magnitude, whether
the second launch is bit-identical, the kernel's mean time over 5
launches by CUDA events and the plain version's host time.  It checks
nothing and exits 0 when everything ran; ``chip_smoke.py`` holds the
limits.  Meant as the short first call after a change to the kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (B, L, H, P, N): small shapes, then zamba2-1.2b's and mamba2-2.7b's
# prefill
SHAPES = [(1, 48, 2, 16, 16), (2, 128, 2, 32, 32), (2, 384, 4, 64, 64),
          (1, 256, 1, 128, 128), (4, 4096, 64, 64, 64),
          (4, 4096, 80, 64, 128)]


def ptxas_report() -> str:
    from repro_torch.kernels import _build
    src = os.path.join(ROOT, "src/repro_torch/kernels/ssd/csrc/ssd.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "ssd.o"), src],
                           capture_output=True, text=True)
    return f"nvcc exit {r.returncode}\n{r.stdout}{r.stderr}"


def inputs(b, l, h, p, n, dtype, seed):
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    return (randn(b, l, h, p).to(dtype), F.softplus(randn(b, l, h)),
            -torch.exp(randn(h) * 0.5), randn(b, l, n).to(dtype),
            randn(b, l, n).to(dtype))


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel, ops, ref
    if not torch.cuda.is_available():
        print("probe_ssd: no CUDA device", file=sys.stderr)
        return 1
    print(ptxas_report(), flush=True)
    kernel._launch_fn()
    print("build", _build.build_info(), flush=True)
    for b, l, h, p, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, B, C = inputs(b, l, h, p, n, dtype, l + p)
            y = ops.ssd(x, dt, A, B, C)
            y2 = ops.ssd(x, dt, A, B, C)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = ref.ssd_model_ref(x, dt, A, B, C)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(5):
                ops.ssd(x, dt, A, B, C)
            ev[1].record()
            ev[1].synchronize()
            err = (y.float() - w.float()).abs()
            print((b, l, h, p, n), dtype, "max_abs_err", float(err.max()),
                  "mean_abs_out", float(w.float().abs().mean()),
                  "max_abs_out", float(w.float().abs().max()),
                  "bit_identical", torch.equal(y, y2),
                  "ms", ev[0].elapsed_time(ev[1]) / 5, "plain_s", plain_s,
                  flush=True)
            del x, dt, A, B, C, y, y2, w
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
