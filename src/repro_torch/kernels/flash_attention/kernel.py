"""ctypes binding of ``csrc/flash_attention.cu``: parameter struct and the
launch call.

The CUDA source replaces the Pallas kernel of the reference package
(``src/repro/kernels/flash_attention/kernel.py``) with two designs,
chosen by dtype, never by size:

* bfloat16 — the tensor cores: a producer warpgroup keeps K and V tiles
  of 128 rows arriving by TMA (tensor maps built at each launch from the
  model-layout strides) in a 3-stage ring of 128-byte-swizzled shared
  memory; two consumer warpgroups of 64 query rows run ``wgmma``
  (Q·Kᵀ from shared memory, P·V with P from registers), take turns at
  the tensor cores and overlap each tile's softmax with the previous
  tile's P·V.  P is rounded to bf16 for P·V, the one rounding the
  reference does not have; scores, max and sums stay float32.
* float32 — the CUDA cores in full float32 (no TF32): the arithmetic
  check of the callers.

The note at the top of the source says what bounds each.  This module
only describes the arguments and calls ``flash_attention_launch``; it is
imported freely on machines without a GPU — the library is built and
loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch


def live_entries(s: int, window: int, t: int | None = None,
                 causal: bool = True) -> int:
    """Score entries one head of an attention of ``s`` queries over
    ``t`` keys (default ``s``) needs: query q sees the keys k < t with
    k <= q when causal and q - k < window when windowed."""
    import numpy as np
    t = s if t is None else t
    q = np.arange(s, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = np.minimum(q, t - 1) if causal else np.full_like(q, t - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(b: int, s: int, h: int, kh: int, d: int, elt: int,
         window: int = 0, t: int | None = None, causal: bool = True):
    """(flops, bytes) one call needs, whatever the design: 4*D flops (q.k
    and p.v) per live score entry, and q, k, v read once and the output
    written once (``elt`` bytes an element).  ``chip_smoke.py``'s bound
    and the dry run's op count (``launch/op_cost.py``) both read it."""
    t = s if t is None else t
    nbytes = (2 * b * s * h * d + 2 * b * t * kh * d) * elt
    return b * h * live_entries(s, window, t, causal) * 4 * d, nbytes

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)          # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what each dtype runs on the card (the note at the top of the source)
DESIGN = {torch.float32: "fma", torch.bfloat16: "wgmma+tma"}
BF16_KEY_TILE = 128                    # key rows a tile of the bf16 path


class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in ``csrc/flash_attention.cu``."""

    _fields_ = [(name, ctypes.c_int64) for name in (
        "b", "s", "t", "h", "kh", "d",
        "q_sb", "q_ss", "q_sh", "k_sb", "k_st", "k_sh",
        "v_sb", "v_st", "v_sh", "o_sb", "o_ss", "o_sh")] + [
        ("causal", ctypes.c_int32), ("window", ctypes.c_int32),
        ("dtype", ctypes.c_int32), ("reserved", ctypes.c_int32),
        ("scale", ctypes.c_float), ("cap", ctypes.c_float),
    ]


_LAUNCH = None


def _launch_fn():
    """``flash_attention_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        lib.flash_attention_params_size.restype = ctypes.c_int
        if lib.flash_attention_params_size() != ctypes.sizeof(FlashParams):
            raise RuntimeError(
                "FlashParams layout differs between kernel.py "
                f"({ctypes.sizeof(FlashParams)} bytes) and "
                f"flash_attention.cu ({lib.flash_attention_params_size()} "
                "bytes)")
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        fn = lib.flash_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(FlashParams), ctypes.c_void_p]
        _LAUNCH = (fn, lib.flash_attention_error_string)
    return _LAUNCH


def make_params(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, *, causal: bool, window: int,
                cap: float) -> FlashParams:
    """Shapes and element strides of model-layout (B, S, H, D) tensors."""
    p = FlashParams()
    p.b, p.s, p.h, p.d = q.shape
    p.t, p.kh = k.shape[1], k.shape[2]
    p.q_sb, p.q_ss, p.q_sh = q.stride()[:3]
    p.k_sb, p.k_st, p.k_sh = k.stride()[:3]
    p.v_sb, p.v_st, p.v_sh = v.stride()[:3]
    p.o_sb, p.o_ss, p.o_sh = o.stride()[:3]
    p.causal, p.window = int(causal), int(window)
    p.dtype = DTYPES[q.dtype]
    p.scale = q.shape[-1] ** -0.5
    p.cap = float(cap)
    return p


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           params: FlashParams) -> None:
    """Enqueue the kernel on torch's current stream.  Raises when the
    launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              ctypes.byref(params), stream)
    if code != 0:
        raise RuntimeError(
            f"flash_attention launch failed: CUDA error {code} "
            f"({errstr(code).decode()})")
