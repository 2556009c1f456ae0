"""ctypes binding of ``csrc/contract.cu``: the key, head, segment and
cluster launches.

The CUDA source has no Pallas counterpart: it moves the host contraction
of the hierarchy's ``aggregate_tasks`` (``src/repro/hier/aggregate.py``)
onto the card; the note at its top says what bounds it.  This module is
imported freely on machines without a GPU — the library is built and
loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the design, as the kernels line of chip_smoke.py reports it
DESIGN = "key-sort-segment"

_LAUNCH = None

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _launch_fns() -> dict:
    """The built library's four launch functions by name (argtypes set),
    and ``error_string``."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.contract_error_string.restype = ctypes.c_char_p
        lib.contract_error_string.argtypes = [_INT]
        sigs = {
            "keys": [_P, _P, _I64, _I64, _I64, _P, _P, _P],
            "heads": [_P, _I64, _I64, _P, _P],
            "segments": [_P] * 4 + [_I64] * 3 + [_P] * 3,
            "clusters": [_P] * 4 + [_I64, _INT, _I64] + [_P] * 3,
        }
        fns = {}
        for name, argtypes in sigs.items():
            fn = getattr(lib, f"contract_{name}_launch")
            fn.restype = _INT
            fn.argtypes = argtypes
            fns[name] = fn
        fns["error_string"] = lib.contract_error_string
        _LAUNCH = fns
    return _LAUNCH


def _launch(name: str, *args) -> None:
    """Enqueue launch ``name`` on torch's current stream with ``args``
    (tensors by their data pointer); raises when it is refused, does not
    synchronise."""
    fns = _launch_fns()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fns[name](*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                       for a in args), stream)
    if code != 0:
        raise RuntimeError(f"contract {name} launch failed: CUDA error "
                           f"{code} ({fns['error_string'](code).decode()})")


def keys_launch(edges, labels, key, counts, *, n: int, nclusters: int):
    _launch("keys", edges, labels, key.numel(), n, nclusters, key, counts)


def heads_launch(sk, head, *, nclusters: int):
    _launch("heads", sk, sk.numel(), nclusters, head)


def segments_launch(sk, si, ew, scan, counts, out, *, nclusters: int,
                    base: int):
    _launch("segments", sk, si, ew, scan, sk.numel(), nclusters, base,
            counts, out)


def clusters_launch(sl, order, coords, w, counts, out, *, nclusters: int):
    n, d = coords.shape
    _launch("clusters", sl, order, coords, w, n, d, nclusters, counts, out)
