"""Public wrapper of the mjfinish kernel.

:func:`mjfinish` checks its arguments, allocates the output and launches
the kernel for CUDA tensors — or raises; for CPU tensors it runs the
plain version (:mod:`.ref`).  Nothing between its entry and the launch
waits for the card: the segment table is not read back.  The host plans
the segment heads; a block whose planned segment disagrees with the
state traps, so the next call that waits on the stream raises (and the
CUDA context is lost) instead of returning wrong part numbers.
"""

from __future__ import annotations

import torch

from repro_torch import obs

from . import kernel as _kernel
from .ref import mjfinish_ref

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0

obs.register_provider("mjfinish_hopper", lambda: {"launches": launch_count})


def _check(t, name: str, dtype, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mjfinish(pts: torch.Tensor, cols: torch.Tensor, mu: torch.Tensor,
             seg_start: torch.Tensor, seg_size: torch.Tensor,
             seg_np: torch.Tensor, sdo: torch.Tensor, tab: torch.Tensor,
             heads: torch.Tensor, *, level: int, levels: int, cap: int,
             sfc: str, longest_dim: bool) -> torch.Tensor:
    """Levels ``level .. levels - 1`` of an unweighted Multi-Jagged sweep,
    one block a segment, from the sweep's positional state at ``level``.

    pts       : (N,) int64 — the slot id of the point at each position.
    cols      : (d, N) float64 — coordinates by position, flips applied.
    mu, seg_start, seg_size, seg_np : (N,) int64 — each position's part
                offset and its segment's first position, length and parts.
    sdo       : (nb, d) int64 — the candidates' cut-dimension priorities;
                N = nb * n, candidate b owning positions [b*n, (b+1)*n).
    tab       : (nparts + 1,) int64 — npl by current part count.
    heads     : (S,) int64 — the first position, within one candidate, of
                every segment at ``level``, ascending from 0; the live ones
                at most ``cap`` points long.
    cap       : a power of two, at most ``max_tile(d)``.

    Returns the (nb, n) int64 part numbers in point order, bit-identical
    to running the level loop on (:func:`.ref.mjfinish_ref`).
    """
    global launch_count
    if not isinstance(cols, torch.Tensor):
        raise TypeError(f"cols must be a tensor, got {type(cols).__name__}")
    if cols.dim() != 2:
        raise ValueError(f"cols must be (d, N), got {tuple(cols.shape)}")
    d, N = cols.shape
    dev = cols.device
    _check(cols, "cols", torch.float64, (d, N), dev)
    for name, t in (("pts", pts), ("mu", mu), ("seg_start", seg_start),
                    ("seg_size", seg_size), ("seg_np", seg_np)):
        _check(t, name, torch.int64, (N,), dev)
    if not isinstance(sdo, torch.Tensor) or sdo.dim() != 2:
        raise ValueError("sdo must be an (nb, d) tensor")
    nb = sdo.shape[0]
    _check(sdo, "sdo", torch.int64, (nb, d), dev)
    if nb == 0 or N % nb:
        raise ValueError(f"{N} positions do not split into {nb} candidates")
    for name, t in (("tab", tab), ("heads", heads)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-d tensor")
        _check(t, name, torch.int64, tuple(t.shape), dev)
    if N and not 0 < heads.numel() <= N // nb:
        raise ValueError(f"heads must list 1 to {N // nb} segments, got "
                         f"{heads.numel()}")
    if sfc not in _kernel.SFC_CODES:
        raise ValueError(f"mjfinish takes no sfc {sfc!r}")
    if not 0 <= level <= levels:
        raise ValueError(f"level {level} outside [0, {levels}]")
    if cap < 2 or cap & (cap - 1) or cap > _kernel.max_tile(d):
        raise ValueError(f"cap {cap} is not a power of two in "
                         f"[2, {_kernel.max_tile(d)}] for d = {d}")
    if dev.type != "cuda" or N == 0 or level == levels:
        return mjfinish_ref(pts, cols, mu, seg_start, seg_size, seg_np, sdo,
                            tab, level=level, levels=levels, sfc=sfc,
                            longest_dim=longest_dim)
    n = N // nb
    out = torch.empty(N, dtype=torch.int64, device=dev)
    _kernel.mjfinish_launch(pts, cols, mu, seg_start, seg_size, seg_np, sdo,
                            tab, heads, out, nb=nb, n=n, level=level,
                            levels=levels, cap=cap, sfc=sfc,
                            longest_dim=longest_dim)
    launch_count += 1
    return out.view(nb, n)
