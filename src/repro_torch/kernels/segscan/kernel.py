"""ctypes binding of ``csrc/segscan.cu``: the launch call.

The CUDA source has no Pallas counterpart: it stands in for the
sequential ``lax.scan`` of the reference's device partitioner
(``src/repro/core/partition_jax.py``); the note at its top says what
bounds it.  This module is imported freely on machines without a GPU —
the library is built and loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the design, as the kernels line of chip_smoke.py reports it
DESIGN = "thread-or-block-per-segment"

_LAUNCH = None


def _launch_fn():
    """``segscan_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.segscan_error_string.restype = ctypes.c_char_p
        lib.segscan_error_string.argtypes = [ctypes.c_int]
        fn = lib.segscan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        _LAUNCH = (fn, lib.segscan_error_string)
    return _LAUNCH


def segscan_launch(w: torch.Tensor, seg_start: torch.Tensor,
                   seg_size: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the kernel on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = fn(w.data_ptr(), seg_start.data_ptr(), seg_size.data_ptr(),
              out.data_ptr(), w.numel(), stream)
    if code != 0:
        raise RuntimeError(f"segscan launch failed: CUDA error {code} "
                           f"({errstr(code).decode()})")
