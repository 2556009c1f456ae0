"""ctypes binding of ``csrc/mapscore.cu``: parameter struct, workspace
layout and the launch call.

The CUDA source replaces the Pallas kernel of the reference package
(``src/repro/kernels/mapscore/kernel.py``); see the note at its top for
what bounds it and what the design does about that.  This module only
describes the buffers and calls ``mapscore_launch``; it is imported
freely on machines without a GPU — the library is built and loaded at
the first launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_DIMS = 8


class MapscoreParams(ctypes.Structure):
    """Mirror of ``struct MapscoreParams`` in ``csrc/mapscore.cu``."""

    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("nd", ctypes.c_int32),
        ("ncols", ctypes.c_int32),
        ("traffic", ctypes.c_int32),
        ("nb", ctypes.c_int64),
        ("ntasks", ctypes.c_int64),
        ("ne", ctypes.c_int64),
        ("ws_per_cand", ctypes.c_int64),
        ("nthreads_red", ctypes.c_int64),
        ("scale", ctypes.c_double),
        ("inv_scale", ctypes.c_double),
        ("dims", ctypes.c_int32 * MAX_DIMS),
        ("wrap", ctypes.c_int32 * MAX_DIMS),
        ("rows", ctypes.c_int64 * MAX_DIMS),
        ("acc_off", ctypes.c_int64 * MAX_DIMS),
        ("bw_off", ctypes.c_int32 * MAX_DIMS),
    ]


def workspace_layout(dims, core_dims: int):
    """Link-accumulator layout of ONE candidate.

    Per network dim ``k`` two int64 arrays (+ then - direction) of shape
    ``(s_k + 1, rows_k)``, rows contiguous, ``rows_k`` the product of
    the other machine dims; column ``s_k`` is the dump bucket of wrapped
    intervals.  Returns ``(rows, acc_off, entries)``: per-dim row
    counts, per-dim start offsets and the total entry count.
    """
    nd = len(dims) - core_dims
    rows, acc_off, off = [], [], 0
    for k in range(nd):
        r = 1
        for j, d in enumerate(dims):
            if j != k:
                r *= int(d)
        rows.append(r)
        acc_off.append(off)
        off += 2 * (int(dims[k]) + 1) * r
    return rows, acc_off, off


def fixed_point_shift(abs_weight_sum: float, dims, core_dims: int) -> int:
    """Exponent ``e`` of the power-of-two fixed-point scale ``2**e``.

    Chosen so that neither the weighted hop sum (every message at the
    machine's largest hop count) nor any link load or difference-array
    entry can reach 2**62: 64-bit integer sums then cannot overflow in
    whatever order the atomics land.
    """
    nd = len(dims) - core_dims
    span = max(2, sum(int(d) for d in dims[:nd]))
    bound = float(abs_weight_sum) * span
    if not math.isfinite(bound):
        raise ValueError("message weights must be finite")
    if bound <= 0.0:
        return 0
    _, exp = math.frexp(bound)  # bound < 2**exp
    return 62 - exp


_LAUNCH = None


def _launch_fn():
    """``mapscore_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.mapscore_params_size.restype = ctypes.c_int
        if lib.mapscore_params_size() != ctypes.sizeof(MapscoreParams):
            raise RuntimeError(
                "MapscoreParams layout differs between kernel.py "
                f"({ctypes.sizeof(MapscoreParams)} bytes) and mapscore.cu "
                f"({lib.mapscore_params_size()} bytes)")
        lib.mapscore_error_string.restype = ctypes.c_char_p
        lib.mapscore_error_string.argtypes = [ctypes.c_int]
        fn = lib.mapscore_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.POINTER(MapscoreParams), ctypes.c_void_p]
        _LAUNCH = (fn, lib.mapscore_error_string)
    return _LAUNCH


def mapscore_launch(coord_stack: torch.Tensor, edges: torch.Tensor,
                    w: torch.Tensor, inv_bw: torch.Tensor | None,
                    ws: torch.Tensor | None, acc: torch.Tensor,
                    outf: torch.Tensor, params: MapscoreParams) -> None:
    """Enqueue the kernel's passes on torch's current stream.  Raises
    when a launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    stream = torch.cuda.current_stream(coord_stack.device).cuda_stream
    code = fn(coord_stack.data_ptr(), edges.data_ptr(), w.data_ptr(),
              inv_bw.data_ptr() if inv_bw is not None else None,
              ws.data_ptr() if ws is not None else None,
              acc.data_ptr(), outf.data_ptr(), ctypes.byref(params),
              stream)
    if code != 0:
        raise RuntimeError(
            f"mapscore launch failed: CUDA error {code} "
            f"({errstr(code).decode()})")
