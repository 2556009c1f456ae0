"""ctypes binding of ``csrc/ssd.cu``: parameter struct and the launch call.

The CUDA source replaces the Pallas kernel of the reference package
(``src/repro/kernels/ssd/kernel.py``); see the note at its top for what
bounds it and what the design does about that.  This module only
describes the arguments and calls ``ssd_launch``; it is imported freely
on machines without a GPU — the library is built and loaded at the first
launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)          # the kernel's instantiations (P)
MAX_STATE = 128                        # largest N; N must be a multiple of 4
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SsdParams(ctypes.Structure):
    """Mirror of ``struct SsdParams`` in ``csrc/ssd.cu``."""

    _fields_ = [(name, ctypes.c_int64) for name in (
        "b", "l", "h", "p", "n",
        "x_sb", "x_sl", "x_sh", "dt_sb", "dt_sl", "dt_sh",
        "b_sb", "b_sl", "c_sb", "c_sl", "y_sb", "y_sl", "y_sh")] + [
        ("dtype", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


_LAUNCH = None


def _launch_fn():
    """``ssd_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.ssd_params_size.restype = ctypes.c_int
        if lib.ssd_params_size() != ctypes.sizeof(SsdParams):
            raise RuntimeError(
                "SsdParams layout differs between kernel.py "
                f"({ctypes.sizeof(SsdParams)} bytes) and ssd.cu "
                f"({lib.ssd_params_size()} bytes)")
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        fn = lib.ssd_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(SsdParams), ctypes.c_void_p]
        _LAUNCH = (fn, lib.ssd_error_string)
    return _LAUNCH


def make_params(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, y: torch.Tensor) -> SsdParams:
    """Shapes and element strides of model-layout tensors: x, y
    (b, l, h, p), dt (b, l, h), B and C (b, l, n)."""
    p = SsdParams()
    p.b, p.l, p.h, p.p = x.shape
    p.n = B.shape[-1]
    p.x_sb, p.x_sl, p.x_sh = x.stride()[:3]
    p.dt_sb, p.dt_sl, p.dt_sh = dt.stride()
    p.b_sb, p.b_sl = B.stride()[:2]
    p.c_sb, p.c_sl = C.stride()[:2]
    p.y_sb, p.y_sl, p.y_sh = y.stride()[:3]
    p.dtype = DTYPES[x.dtype]
    return p


def ssd_launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, y: torch.Tensor,
               params: SsdParams) -> None:
    """Enqueue the kernel on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), ctypes.byref(params), stream)
    if code != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {code} "
                           f"({errstr(code).decode()})")
