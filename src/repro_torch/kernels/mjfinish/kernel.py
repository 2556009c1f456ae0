"""ctypes binding of ``csrc/mjfinish.cu``: the launch call, and the
largest segment a block takes (``MAX_TILE``).

The CUDA source has no Pallas counterpart: it finishes the level loop of
the reference's device partitioner (``src/repro/core/partition_jax.py``)
from a handoff level on; the note at its top says what bounds it.  This
module is imported freely on machines without a GPU — the library is
built and loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the design, as the kernels line of chip_smoke.py reports it
DESIGN = "block-per-segment-shared"

SFC_CODES = {"Z": 0, "Gray": 1, "FZ": 2, "FZlow": 3}

# The most points a segment may hold for one block, by dimension count d
# (0: d not supported): the largest power of two up to 4,096 whose slots,
# 8 d + 31 shared bytes each, fit a block's dynamic shared memory.  The
# one table of it: csrc/mjfinish.cu refuses a cap whose slots do not fit.
MAX_TILE = (0, 4096, 4096, 4096, 2048, 2048, 2048)

_LAUNCH = None


def max_tile(d: int) -> int:
    """``MAX_TILE[d]``, 0 outside the table; planning a sweep with it
    loads nothing."""
    return MAX_TILE[d] if 0 <= d < len(MAX_TILE) else 0


def _launch_fn():
    """``mjfinish_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.mjfinish_error_string.restype = ctypes.c_char_p
        lib.mjfinish_error_string.argtypes = [ctypes.c_int]
        fn = lib.mjfinish_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        _LAUNCH = (fn, lib.mjfinish_error_string)
    return _LAUNCH


def mjfinish_launch(pts, cols, mu, seg_start, seg_size, seg_np, sdo, tab,
                    heads, out, *, nb: int, n: int, level: int, levels: int,
                    cap: int, sfc: str, longest_dim: bool) -> None:
    """Enqueue the kernel on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = fn(pts.data_ptr(), cols.data_ptr(), mu.data_ptr(),
              seg_start.data_ptr(), seg_size.data_ptr(), seg_np.data_ptr(),
              sdo.data_ptr(), tab.data_ptr(), heads.data_ptr(),
              heads.numel(), nb, n, cols.shape[0], level, levels, cap,
              SFC_CODES[sfc], int(bool(longest_dim)), out.data_ptr(),
              stream)
    if code != 0:
        raise RuntimeError(f"mjfinish launch failed: CUDA error {code} "
                           f"({errstr(code).decode()})")
