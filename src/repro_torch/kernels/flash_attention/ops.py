"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` takes the model layout (B, S, H, D).  For CUDA
tensors it checks its arguments, allocates the output and launches the
kernel — or raises; for CPU tensors it runs the plain version
(:mod:`.ref`) in the kernel layout.

Differences from the reference wrapper, by design: nothing is transposed
or padded (the kernel reads the model layout by strides and masks the
ragged ends of S and T itself), and there are no block-size arguments —
the kernel has its own tiles.  It refuses what the reference refuses at
its default key block of 512: a non-causal call whose keys that block
would pad.  Where the reference pads keys under the causal mask the
padded rows lie beyond every query when ``S <= T``, so both compute the
same function there.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import attention_ref

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0

# the reference wrapper's default key block (``bk``)
REF_BK = 512


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, KH, D) with KH | H.  Returns
    (B, S, H, D) in q's dtype."""
    global launch_count
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,S,H,D) and k, v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and D, kv heads dividing heads)")
    bk = min(REF_BK, t)
    if bk and t % bk and not causal:
        raise ValueError("key padding requires causal masking to be safe; "
                         "pass block sizes dividing T for non-causal use")
    if q.device.type != "cuda":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            cap=cap)
        return out.transpose(1, 2).contiguous()

    if q.dtype not in _kernel.DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if d not in _kernel.HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of the kernel's "
                         f"{_kernel.HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    params = _kernel.make_params(q, k, v, out, causal=causal, window=window,
                                 cap=cap)
    _kernel.flash_attention_launch(q, k, v, out, params)
    launch_count += 1
    return out
