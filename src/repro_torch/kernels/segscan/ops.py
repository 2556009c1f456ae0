"""Public wrapper of the segscan kernel.

:func:`segscan` checks its arguments, allocates the output and launches
the kernel for CUDA tensors — or raises; for CPU tensors it runs the
plain version (:mod:`.ref`).  Nothing between its entry and the launch
waits for the card: the segment lengths are not read back (the kernel
cuts a segment that claims to run past the end).
"""

from __future__ import annotations

import torch

from repro_torch import obs

from . import kernel as _kernel
from .ref import segscan_ref

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("segscan_hopper", lambda: {"launches": launch_count})


def _check(t: torch.Tensor, name: str, dtype, n: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.numel() != n:
        raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segscan(w: torch.Tensor, seg_start: torch.Tensor,
            seg_size: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 prefix sums within segments, added left to right.

    w         : (n,) float64.
    seg_start : (n,) int64 — the first position of each position's
                segment (segments are contiguous and cover [0, n)).
    seg_size  : (n,) int64 — that segment's length.

    Returns (n,) float64 on the inputs' device: ``out[j] = w[s] + w[s+1]
    + ... + w[j]`` for the segment starting at ``s``, summed in that order
    (bit-identical to ``np.cumsum`` over the segment).
    """
    global launch_count
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"w must be a tensor, got {type(w).__name__}")
    n, dev = w.numel(), w.device
    _check(w, "w", torch.float64, n, dev)
    _check(seg_start, "seg_start", torch.int64, n, dev)
    _check(seg_size, "seg_size", torch.int64, n, dev)
    if dev.type != "cuda":
        return segscan_ref(w, seg_start, seg_size)
    out = torch.empty_like(w)
    if n == 0:
        return out
    _kernel.segscan_launch(w, seg_start, seg_size, out)
    launch_count += 1
    return out
