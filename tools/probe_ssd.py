#!/usr/bin/env python3
"""First check of the SSD kernel on a GPU: compile, compare, time.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit::

    python3 tools/probe_ssd.py [--old FILE] [--variant NAME[=FILE]:FLAGS ...]

It compiles ``src/repro_torch/kernels/ssd/csrc/ssd.cu`` with ``nvcc
-Xptxas -v`` into a library of its own and prints what ptxas reports for
each kernel instantiation (registers, spills, any wgmma-serialisation
note); the same for the previous design (``--old``, default
``build/probe_ssd/old_ssd.cu``, written from ``git show HEAD~:<source>``
when the file is missing and the repository has its history — the
copy a remote run gets may not, so write it before) and for each
``--variant``: the current source with extra ``nvcc`` flags
(``NAME:FLAGS``), or another source (``NAME=FILE[:FLAGS]``, for example a
copy under ``build/`` with one phase left out, to see what it costs).
All of them build side by side into ``build/probe_ssd/``, which git
ignores.

Then, for every case of ``chip_smoke.SSD_CASES`` in both dtypes, the
current library (through the wrapper, ``ops.ssd``) and each variant are
launched twice and held against the plain version (the sequential
recurrence) under ``chip_smoke.SSD_TOL``: max abs error, whether every
element is within the limit, whether the second launch is bit-identical.
Last, both dtypes at both model shapes (zamba2-1.2b's and mamba2-2.7b's
prefill) are timed, median of 10 CUDA events each, in the order old,
new, variants, new, old, so that the designs compare inside one call.
It checks nothing and exits 0 when everything ran; ``chip_smoke.py``
holds the limits.  Meant as the short first call after a change to the
kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
OUT = os.path.join(ROOT, "build", "probe_ssd")
TIMED = ("zamba2-1.2b-prefill", "mamba2-2.7b-prefill")
PTXAS_KEYS = ("Compiling entry", "registers", "spill", "wgmma", "C75")


def old_source(path: str) -> str | None:
    """The previous design's source: ``path``, written from
    ``git show HEAD~:SRC`` first if it is missing and git can."""
    if not os.path.exists(path):
        r = subprocess.run(["git", "-C", ROOT, "show", f"HEAD~:{SRC}"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            return None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(r.stdout)
    return path


def build_all(builds: dict) -> dict:
    """{name: (source, extra flags)} -> {name: library path}, compiled
    side by side with ``-Xptxas -v``; prints ptxas' lines per build."""
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
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


def launcher(path: str):
    """A callable (x, dt, A, B, C) -> y that launches ``ssd_launch`` of
    the library at ``path``."""
    import torch
    from repro_torch.kernels.ssd import kernel
    lib = ctypes.CDLL(path)
    fn = lib.ssd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(kernel.SsdParams),
                                           ctypes.c_void_p]

    def run(x, dt, A, B, C):
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        prm = kernel.make_params(x, dt, B, C, y)
        code = fn(x.data_ptr(), dt.data_ptr(), A.contiguous().data_ptr(),
                  B.data_ptr(), C.data_ptr(), y.data_ptr(), ctypes.byref(prm),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{path}: CUDA error {code}")
        return y
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=os.path.join(OUT, "old_ssd.cu"))
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME[=FILE]:FLAGS")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ssd import kernel, ops, ref
    if not torch.cuda.is_available():
        print("probe_ssd: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    src = os.path.join(ROOT, SRC)
    builds = {"new": (src, [])}
    for v in args.variant:
        name, _, flags = v.partition(":")
        name, _, path = name.partition("=")
        builds[name] = (os.path.abspath(path) if path else src, flags.split())
    old = old_source(args.old)
    if old:
        builds["old"] = (old, [])
    else:
        print("no previous source: old design not timed", flush=True)
    libs = build_all(builds)
    runs = {name: launcher(path) for name, path in libs.items()}
    kernel._launch_fn()               # the port's own build, for ops.ssd
    variants = [v for v in runs if v not in ("new", "old")]

    for i, (name, b, l, h, p, n, chunk, a_value, views) in enumerate(
            cs.SSD_CASES):
        for dtype in ("float32", "bfloat16"):
            x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, dtype, a_value,
                                           views, i)
            want = ref.ssd_model_ref(x, dt, A, B, C).float()
            a_frac, rtol = cs.SSD_TOL[dtype]
            atol = a_frac * float(want.abs().max())
            for lib in ["new", *variants]:
                if lib == "new":
                    def call():
                        return ops.ssd(x, dt, A, B, C, chunk=chunk)
                else:
                    def call(run=runs[lib]):
                        return run(x, dt, A, B, C)
                got, again = call(), call()
                torch.cuda.synchronize()
                g = got.float()
                print(name, dtype, lib, (b, l, h, p, n), "max_abs_err",
                      float((g - want).abs().max()), "within_tol",
                      bool(torch.allclose(g, want, atol=atol, rtol=rtol)),
                      "finite", bool(torch.isfinite(g).all()),
                      "bit_identical", torch.equal(got, again), flush=True)
            del x, dt, A, B, C, want, got, again, g
            torch.cuda.empty_cache()

    order = [v for v in ("old", "new") if v in runs]
    order = order + variants + order[::-1]
    for name in TIMED:
        c = next(c for c in cs.SSD_CASES if c[0] == name)
        _, b, l, h, p, n, _, a_value, views = c
        for dtype in ("float32", "bfloat16"):
            x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, dtype, a_value,
                                           views, 0)
            times = []
            for lib in order:
                ms = cs.cuda_ms(lambda run=runs[lib]: run(x, dt, A, B, C), 10)
                times.append((lib, ms))
            bound = cs.ssd_bound(b, l, h, p, n, dtype)
            print("timed", name, dtype, " ".join(f"{k} {v:.4f}"
                                                 for k, v in times),
                  "bound_ms", round(bound["bound_ms"], 4), flush=True)
            del x, dt, A, B, C
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
