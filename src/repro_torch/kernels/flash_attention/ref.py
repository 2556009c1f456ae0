"""Plain-torch version of the flash-attention kernel.

Layout is the kernel's (B, H, S, D) — the ops.py wrapper adapts the model
layout.  Supports GQA (kv_heads divides heads), causal masking, sliding
windows and gemma-style logit soft-capping, with exactly the semantics
of the reference package's ``kernels/flash_attention/ref.py``: scores,
softmax and the value product in float32, masked logits set to the
finite -1e30, the output cast back to q's dtype.  Positions are the row
and column indices.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  cap: float = 0.0):
    """q: (B, H, S, D); k/v: (B, KH, T, D) with KH | H."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float() * (d ** -0.5)
    kf = k.float()
    vf = v.float()
    qf = qf.reshape(b, kh, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, kf)
    if cap:
        scores = torch.tanh(scores / cap) * cap
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= qpos - kpos < window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, vf)
    return out.reshape(b, h, s, d).to(q.dtype)
