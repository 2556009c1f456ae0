#!/usr/bin/env python3
"""First check of the flash-attention kernel on a GPU: compile, compare,
time.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit::

    python3 tools/probe_flash_attention.py

It compiles ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` alone with ``nvcc -Xptxas -v`` and prints what ptxas
reports (registers, spills, shared memory per instantiation), builds the
port's kernel library, then launches the kernel twice at every shape of
``chip_smoke.ATTN_CASES`` and compares it with its plain version
(``ref.attention_ref``) under ``chip_smoke.ATTN_TOL``: max abs error,
whether every element is within the limit, whether the second launch is
bit-identical.  Last it times the timed shapes of ``chip_smoke``
(``ATTN_TIMED_CASES``, yi-6b's prefill first) by CUDA events, beside
``scaled_dot_product_attention``.  It checks nothing and exits 0 when
everything ran; ``chip_smoke.py`` holds the limits.  Meant as the short
first call after a change to the kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"


def ptxas_report() -> str:
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "fa.o"),
                            os.path.join(ROOT, SRC)],
                           capture_output=True, text=True)
    return f"nvcc exit {r.returncode}\n{r.stdout}{r.stderr}"


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    if not torch.cuda.is_available():
        print("probe_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    print(ptxas_report(), flush=True)
    kernel._launch_fn()
    print("build", _build.build_info(), flush=True)
    for i, (name, b, s, h, kh, d, dtype, window, cap) in enumerate(
            cs.ATTN_CASES):
        q, k, v = cs.attention_inputs(b, s, h, kh, d, dtype, i)
        kw = dict(causal=True, window=window, cap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), **kw).transpose(1, 2)
        torch.cuda.synchronize()
        atol, rtol = cs.ATTN_TOL[dtype]
        err = (got.float() - want.float()).abs()
        print(name, dtype, (b, s, h, kh, d), "max_abs_err", float(err.max()),
              "within_tol", bool(torch.allclose(got.float(), want.float(),
                                                atol=atol, rtol=rtol)),
              "finite", bool(torch.isfinite(got).all()),
              "mean_abs_out", float(want.float().abs().mean()),
              "bit_identical", torch.equal(got, again), flush=True)
        del q, k, v, got, again, want, err
        torch.cuda.empty_cache()
    for name, dtype in cs.ATTN_TIMED_CASES:
        c = next(c for c in cs.ATTN_CASES if (c[0], c[6]) == (name, dtype))
        _, b, s, h, kh, d, _, window, cap = c
        q, k, v = cs.attention_inputs(b, s, h, kh, d, dtype, 0)
        kw = dict(causal=True, window=window, cap=cap)
        ms = cs.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
        lib = cs.cuda_ms(cs.library_attention(q, k, v, window), 10)
        bound = cs.attention_bound(b, s, h, kh, d, dtype, window)
        print("timed", name, dtype, "ms", ms, "library_ms", lib,
              "bound_ms", bound["bound_ms"],
              "tflops", bound["bound_flops"] / ms / 1e9, flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
