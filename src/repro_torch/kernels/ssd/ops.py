"""Public wrapper of the SSD kernel, in the model layout.

:func:`ssd` takes the ``mamba_block`` quantities (x, dt, A, B, C) and
returns y with the semantics of ``repro.models.layers.ssd_reference``
(without the final state, which the full-sequence pass does not keep).
For CUDA tensors it checks its arguments, allocates the output and
launches the kernel — or raises; for CPU tensors it runs the plain
version (:func:`.ref.ssd_model_ref`), which feeds the sequential
recurrence as the reference wrapper feeds its kernel.

Differences from the reference wrapper, by design: on the card nothing
is transposed, premultiplied or broadcast per head — the kernel reads x,
dt, B and C by strides and applies dt and dt * A itself — and the
kernel scans in chunks of its own length (``chunk`` changes only the
order of the sums); ``chunk`` is validated as the reference asserts it.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import ssd_model_ref

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.shape != B.shape:
        raise ValueError(
            "x must be (b,l,h,p), dt (b,l,h), A (h,), B and C (b,l,n); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, l, h, _ = x.shape
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (b, l):
        raise ValueError(
            f"dt {tuple(dt.shape)}, A {tuple(A.shape)} and B/C "
            f"{tuple(B.shape)} do not fit x {tuple(x.shape)}")
    if x.dtype not in _kernel.DTYPES:
        raise TypeError(f"x, B and C must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share one dtype; got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    q = min(chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {q}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
        ) -> torch.Tensor:
    """x: (b, l, h, p); dt: (b, l, h) float32; A: (h,) float32; B, C:
    (b, l, n), shared by every head.  Returns y: (b, l, h, p) in x's
    dtype."""
    global launch_count
    _check(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        return ssd_model_ref(x, dt, A, B, C)

    b, l, h, p = x.shape
    n = B.shape[-1]

    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must lie on one device")
    if p not in _kernel.HEAD_DIMS:
        raise ValueError(f"head dim {p} is not one of the kernel's "
                         f"{_kernel.HEAD_DIMS}")
    if n % 4 or n > _kernel.MAX_STATE:
        raise ValueError(f"state size {n} must be a multiple of 4 and at "
                         f"most {_kernel.MAX_STATE}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("the last dim of x, B and C must be contiguous")
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    A = A.contiguous()
    params = _kernel.make_params(x, dt, B, C, y)
    _kernel.ssd_launch(x, dt, A, B, C, y, params)
    launch_count += 1
    return y
