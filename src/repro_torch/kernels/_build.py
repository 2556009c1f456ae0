"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles every ``kernels/*/csrc/*.cu`` of this package for
``sm_90a`` — one compiler process per source, all started together —
and links the objects into ``build/repro_torch/libkernels-<hash>.so``
under the repository root, keyed by a hash of the sources; the library
is loaded with :mod:`ctypes`.  The sources expose a plain C interface,
so the build takes seconds and needs nothing but the CUDA toolkit.

Nothing happens at import: :func:`load_library` runs at the first kernel
launch.  A failed build raises :class:`KernelBuildFailure` with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_KERNELS_DIR = Path(__file__).resolve().parent
_REPO_ROOT = _KERNELS_DIR.parents[2]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_INFO: dict = {}


class KernelBuildFailure(RuntimeError):
    """``nvcc`` is missing or refused the sources."""


def sources() -> list[Path]:
    """Every CUDA source of the package, in a fixed order."""
    return sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))


BUILD_DIR = _REPO_ROOT / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildFailure(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built on this machine")


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of every one
    that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{output}")
    if failed:
        raise KernelBuildFailure("\n".join(failed))


def _compile_and_link(nvcc: str, srcs, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in srcs]
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(srcs, objs)])
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent process sees all
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        if not srcs:
            raise KernelBuildFailure(f"no CUDA sources under {_KERNELS_DIR}")
        out = BUILD_DIR / f"libkernels-{_source_hash(srcs)}.so"
        t0 = time.perf_counter()
        built = False
        if not out.exists():
            _compile_and_link(find_nvcc(), srcs, out)
            built = True
        _LIB = ctypes.CDLL(str(out))
        _INFO.update(path=str(out), built=built,
                     seconds=time.perf_counter() - t0,
                     sources=[str(s.relative_to(_REPO_ROOT)) for s in srcs])
        return _LIB


def build_info() -> dict:
    """Where the loaded library lies, whether this process compiled it,
    and how long building + loading took (empty before the first load)."""
    return dict(_INFO)
