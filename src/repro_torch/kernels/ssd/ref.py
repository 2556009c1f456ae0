"""Plain-torch version of the SSD kernel: the naive per-step recurrence
(exact semantics, O(L) sequential), as the reference package's
``kernels/ssd/ref.py``, in the TPU kernel's (BH, L, ...) layout
(:func:`ssd_ref`) and fed the model layout as the reference wrapper
feeds its kernel (:func:`ssd_model_ref`)."""

from __future__ import annotations

import torch


def ssd_ref(x, a, B, C):
    """Naive SSD recurrence.

    x : (BH, L, P)  -- dt-premultiplied inputs (dt_j * x_j)
    a : (BH, L)     -- log-decay increments (dt_j * A_h, negative)
    B : (BH, L, N)
    C : (BH, L, N)
    returns y: (BH, L, P) in x's dtype, final state (BH, N, P) float32

    Recurrence:  S_t = exp(a_t) S_{t-1} + B_t^T x_t ;  y_t = C_t S_t.
    """
    bh, l, p = x.shape
    n = B.shape[-1]
    xf, af, Bf, Cf = (t.float() for t in (x, a, B, C))
    S = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = torch.empty((bh, l, p), dtype=torch.float32, device=x.device)
    for t in range(l):
        S = S * torch.exp(af[:, t])[:, None, None] \
            + Bf[:, t, :, None] * xf[:, t, None, :]
        ys[:, t] = torch.bmm(Cf[:, t, None, :], S)[:, 0]
    return ys.to(x.dtype), S


def ssd_model_ref(x, dt, A, B, C):
    """:func:`ssd_ref` on the ``mamba_block`` quantities — x (b, l, h, p),
    dt (b, l, h), A (h,), B and C (b, l, n) — with dt * x, dt * A and the
    per-head broadcast of B and C formed first.  Returns y (b, l, h, p) in
    x's dtype."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xdt = (x.float() * dt[..., None]).transpose(1, 2).reshape(b * h, l, p)
    a = (dt * A).transpose(1, 2).reshape(b * h, l)
    Bb = B[:, None].expand(b, h, l, n).reshape(b * h, l, n)
    Cb = C[:, None].expand(b, h, l, n).reshape(b * h, l, n)
    y, _ = ssd_ref(xdt, a, Bb, Cb)
    return y.reshape(b, h, l, p).transpose(1, 2).to(x.dtype).contiguous()
