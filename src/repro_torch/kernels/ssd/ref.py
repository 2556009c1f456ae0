"""Plain-torch versions of the SSD kernel.

:func:`ssd_ref` is the naive per-step recurrence (exact semantics, O(L)
sequential), as the reference package's ``kernels/ssd/ref.py``, in the
TPU kernel's (BH, L, ...) layout; :func:`ssd_model_ref` feeds it the
model layout as the reference wrapper feeds its kernel.  That is the
kernel's plain version.

:func:`ssd_reference` is the reference's chunked scan
(``repro.models.layers.ssd_reference``): the function the reference's
Mamba2 block runs, and differentiates, in training, so the one the
wrapper's backward differentiates on the card.  It lives here, not in
``models/``, so that the kernel package does not import the model
package; ``models.layers`` re-exports it.
"""

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


def f32(*ts):
    """The tensors in float32, as jnp.einsum promotes mixed operands."""
    return tuple(t.float() for t in ts)


def ssd_reference(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD scan (Dao & Gu 2024), plain torch.

    x : (b, l, h, p)   dt: (b, l, h)   A: (h,) negative decay
    B : (b, l, n)      C : (b, l, n)
    returns y: (b, l, h, p) and final state (b, h, p, n)
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    nc = l // q
    if nc * q != l:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {q}")
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    a = dtc * A  # (b, nc, q, h) log-decay increments (negative)
    s_cum = torch.cumsum(a, dim=2)  # within-chunk cumulative
    # intra-chunk: L[i,j] = exp(s_i - s_j) for j <= i.  The mask goes
    # on the exponent (-inf above the diagonal), not on exp's output as
    # in the reference: the same values, but where s_i - s_j passes ~88
    # above the diagonal (a chunk whose decay sums past that) the
    # reference's exp overflows there and its gradient is 0 * inf = NaN
    si = s_cum[:, :, :, None, :]        # (b,nc,q,1,h)
    sj = s_cum[:, :, None, :, :]        # (b,nc,1,q,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(mask[None, None, :, :, None], si - sj,
                                 float("-inf")))  # (b,nc,q,q,h)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b,nc,q,q), x's dtype
    scores = cb[..., None] * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", *f32(scores, xc))
    # chunk-final states: S_c = sum_j exp(s_Q - s_j) dt_j B_j x_j
    decay_out = torch.exp(s_cum[:, :, -1:, :] - s_cum)   # (b,nc,q,h)
    dBx = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                       *f32(decay_out * dtc, Bc, xc))
    chunk_decay = torch.exp(s_cum[:, :, -1, :])          # (b,nc,h)
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    S_enter = []  # the state *entering* each chunk
    for c in range(nc):
        S_enter.append(S)
        S = S * chunk_decay[:, c, :, None, None].float() + dBx[:, c]
    S_enter = torch.stack(S_enter, dim=1)  # (b,nc,h,p,n)
    # inter-chunk: y_i += C_i . (exp(s_i) * S_enter)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp",
                           *f32(Cc, S_enter.to(Cc.dtype), torch.exp(s_cum)))
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y.to(x.dtype), S
