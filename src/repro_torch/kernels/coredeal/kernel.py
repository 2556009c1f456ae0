"""ctypes binding of ``csrc/coredeal.cu``: the key launch and the deal
launch.

The CUDA source has no Pallas counterpart: it moves the host
``assign_cores`` of the hierarchy (``src/repro/hier/refine.py``) onto the
card; the note at its top says what bounds it.  This module is imported
freely on machines without a GPU — the library is built and loaded at the
first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the design, as the kernels line of chip_smoke.py reports it
DESIGN = "key-sort-deal"

_LAUNCH = None


def _launch_fns():
    """``(coredeal_keys_launch, coredeal_deal_launch, error_string)`` of
    the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.coredeal_error_string.restype = ctypes.c_char_p
        lib.coredeal_error_string.argtypes = [ctypes.c_int]
        keys = lib.coredeal_keys_launch
        keys.restype = ctypes.c_int
        keys.argtypes = ([ctypes.c_void_p] * 5
                         + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int]
                         + [ctypes.c_void_p] * 4)
        deal = lib.coredeal_deal_launch
        deal.restype = ctypes.c_int
        deal.argtypes = ([ctypes.c_void_p] * 4
                         + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3)
        _LAUNCH = (keys, deal, lib.coredeal_error_string)
    return _LAUNCH


def _raise(what: str, code: int, errstr) -> None:
    if code != 0:
        raise RuntimeError(f"coredeal {what} launch failed: CUDA error "
                           f"{code} ({errstr(code).decode()})")


def keys_launch(coords, lo, hi, labels, c2r, h, router, counts, *,
                bits: int, nrouters: int) -> None:
    """Enqueue the key launch on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    keys, _, errstr = _launch_fns()
    n, d = coords.shape
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    _raise("key", keys(coords.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                       labels.data_ptr(), c2r.data_ptr(), n, d, c2r.numel(),
                       nrouters, bits, h.data_ptr(), router.data_ptr(),
                       counts.data_ptr(), stream), errstr)


def deal_launch(srouter, order, core_sorted, core_order, t2p, counts, *,
                q: int) -> None:
    """Enqueue the deal launch on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    _, deal, errstr = _launch_fns()
    stream = torch.cuda.current_stream(srouter.device).cuda_stream
    _raise("deal", deal(srouter.data_ptr(), order.data_ptr(),
                        core_sorted.data_ptr(), core_order.data_ptr(),
                        srouter.numel(), core_sorted.numel(), q,
                        t2p.data_ptr(), counts.data_ptr(), stream), errstr)
