"""Plain-torch versions of the flash-attention kernel.

:func:`attention_ref` is the kernel's plain version, in the kernel's
(B, H, S, D) layout — the ops.py wrapper adapts the model layout.
Supports GQA (kv_heads divides heads), causal masking, sliding windows
and gemma-style logit soft-capping, with exactly the semantics of the
reference package's ``kernels/flash_attention/ref.py``: scores, softmax
and the value product in float32, masked logits set to the finite
-1e30, the output cast back to q's dtype.  Positions are the row and
column indices.

:func:`attention_xla_flash` is the reference's training attention
(``repro.models.layers.attention_xla_flash``, its default ``attn_impl``),
in the model layout: the function whose gradient the reference takes,
and so the one the wrapper's backward differentiates on the card.  It
lives here, not in ``models/``, so that the kernel package does not
import the model package; ``models.layers`` re-exports it.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.rules import logical

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


def mask_bias(q_pos, k_pos, causal: bool, window: int, dtype):
    """(q, k) additive bias: 0 where attendable, -1e30 otherwise."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    d = q_pos[:, None] - k_pos[None, :]
    if causal:
        ok &= d >= 0
    if window:
        ok &= d < window
    return torch.zeros(ok.shape, dtype=dtype,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


def _repeat_heads(x, g: int):
    """(B, T, KH, D) -> (B, T, KH * g, D), each kv head ``g`` times in a
    row: ``repeat_interleave``'s values, but its backward is a sum over
    the group (a reduction), never an ``index_add`` with atomics, so
    gradients come out with the same bits on every run."""
    b, t, kh, d = x.shape
    return x[:, :, :, None, :].expand(b, t, kh, g, d).reshape(b, t, kh * g,
                                                              d)


def attention_xla_flash(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                        cap=0.0, block: int = 512):
    """Query-chunked attention.  q: (B,S,H,D); k/v: (B,T,KH,D).

    The reference's ``attention_xla_flash`` in plain torch: per chunk of
    ``block`` queries the softmax runs over the full key length in one
    pass and nothing is carried between chunks.  k/v are repeated across
    each query-head group once; scores are float32, the probabilities
    are cast to q's dtype before the value product, as in the reference.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    block = min(block, s)
    qc = (q * (d ** -0.5)).to(q.dtype)
    kf = logical(_repeat_heads(k, g), ("batch", None, "act_heads", None))
    vf = logical(_repeat_heads(v, g), ("batch", None, "act_heads", None))
    kf = kf.float()
    out = torch.empty_like(q)
    for c0 in range(0, s, block):
        qi = qc[:, c0:c0 + block]
        sc = torch.einsum("bshd,bthd->bhst", qi.float(), kf)
        if cap:
            sc = torch.tanh(sc / cap) * cap
        sc = sc + mask_bias(q_pos[c0:c0 + block], k_pos, causal, window,
                            sc.dtype)
        # heads when the model axis divides them, else the query block
        sc = logical(sc, ("batch", "act_heads", "sp_seq", None))
        p = torch.softmax(sc, dim=-1).to(q.dtype)
        out[:, c0:c0 + block] = torch.einsum("bhst,bthd->bshd", p, vf)
    return out
