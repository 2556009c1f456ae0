"""Model layers in plain torch (functional; params are nested dicts).

The dense subset of the reference package's ``models/layers.py``.
Attention comes in three implementations selected by cfg.attn_impl:

- "quadratic": materialises the score matrix — the readable oracle, used
  for small shapes and as the reference for everything else.
- "xla_flash": query-chunked attention, plain torch (the name is the
  reference's); memory O(block * seq) per chunk.
- "hopper": the hand-written CUDA kernel of
  :mod:`repro_torch.kernels.flash_attention` (on CPU tensors its wrapper
  runs the plain version).

All attention paths support GQA, causal masking, sliding windows and
gemma-style logit soft-capping.  The reference's sharding annotations
are no-ops on one card and are left out.  The MoE and Mamba2 blocks
belong to later slices of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30

_LATER = ("belongs to a later slice of the PyTorch port; this one serves "
          "the dense family")


# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x, positions, theta: float):
    """Rotary embeddings. x: (..., seq, heads, head_dim); positions (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def activation(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(x)


# ---------------------------------------------------------------------------
# Attention (GQA + causal + sliding window + softcap)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: int, dtype):
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


def attention_quadratic(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                        cap=0.0):
    """Reference attention.  q: (B,S,H,D); k/v: (B,T,KH,D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qs = q.reshape(b, s, kh, g, d) * (d ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qs.float(), k.float())
    scores = softcap(scores, cap)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window, scores.dtype)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def attention_xla_flash(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                        cap=0.0, block: int = 512):
    """Query-chunked attention.

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
    kf = torch.repeat_interleave(k, g, dim=2).float()
    vf = torch.repeat_interleave(v, g, dim=2)
    out = torch.empty_like(q)
    for c0 in range(0, s, block):
        qi = qc[:, c0:c0 + block]
        sc = torch.einsum("bshd,bthd->bhst", qi.float(), kf)
        sc = softcap(sc, cap)
        sc = sc + _mask_bias(q_pos[c0:c0 + block], k_pos, causal, window,
                             sc.dtype)
        p = torch.softmax(sc, dim=-1).to(q.dtype)
        out[:, c0:c0 + block] = torch.einsum("bhst,bthd->bshd", p, vf)
    return out


def attention_decode(q, k_cache, v_cache, *, pos, window=0, cap=0.0):
    """Single-token decode vs a (B,S,KH,D) cache filled up to ``pos``.

    q: (B,1,H,D); pos: (B,) int.
    """
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qs = (q.reshape(b, kh, g, d) * (d ** -0.5)).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qs, k_cache.float())
    scores = softcap(scores, cap)
    kpos = torch.arange(t, device=q.device)
    valid = kpos[None, :] <= pos[:, None]                  # causal vs fill
    if window:
        valid &= kpos[None, :] > pos[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention(cfg, q, k, v, *, q_pos, k_pos, causal=True, window=0, cap=0.0):
    impl = cfg.attn_impl
    if impl == "hopper":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap)
    if impl == "quadratic" or q.shape[1] <= 256:
        return attention_quadratic(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                   causal=causal, window=window, cap=cap)
    return attention_xla_flash(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=window, cap=cap)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def attn_block(cfg, p, x, *, positions, window: int = 0, cache=None,
               cache_pos=None, causal=True):
    """Self-attention block.

    p: {"q","k","v","o"} projection kernels.
    window: sliding-window size (0 = full attention).
    cache: None (prefill without cache) or dict {"k","v"} of (B,S,KH,D)
        buffers to update at cache_pos and read (decode).  The update is
        IN PLACE: the reference's jitted decode step donates the cache
        buffers, and writing into them here is what that donation buys.
    Returns (out, new_kv) where new_kv is the (k, v) pair produced by this
    call (prefill) or the updated cache dict (decode).  Cross-attention
    (encoder-decoder) belongs to a later slice.
    """
    b, s, e = x.shape
    q = torch.einsum("bse,ehd->bshd", x, p["q"])
    k = torch.einsum("bse,ekd->bskd", x, p["k"])
    v = torch.einsum("bse,ekd->bskd", x, p["v"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = attention(cfg, q, k, v, q_pos=positions, k_pos=positions,
                        causal=causal, window=window, cap=cfg.attn_softcap)
        new_kv = (k, v)
    else:
        kc, vc = cache["k"], cache["v"]
        kc[:, cache_pos:cache_pos + s] = k.to(kc.dtype)
        vc[:, cache_pos:cache_pos + s] = v.to(vc.dtype)
        pos_vec = torch.full((b,), cache_pos, dtype=torch.int64,
                             device=x.device)
        out = attention_decode(q, kc, vc, pos=pos_vec, window=window,
                               cap=cfg.attn_softcap)
        new_kv = {"k": kc, "v": vc}
    out = torch.einsum("bshd,hde->bse", out, p["o"])
    return out, new_kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(cfg, p, x):
    """Gated MLP (llama-style).  p: {"wi","wg","wo"}."""
    h = torch.einsum("bse,ef->bsf", x, p["wi"])
    g = torch.einsum("bse,ef->bsf", x, p["wg"])
    h = activation(g, cfg.act) * h
    return torch.einsum("bsf,fe->bse", h, p["wo"])


def moe_block(cfg, p, x):
    raise NotImplementedError(f"moe_block {_LATER}")


def mamba_block(cfg, p, x, *, cache=None):
    raise NotImplementedError(f"mamba_block {_LATER} (with kernel K3, ssd)")


def ssd_reference(x, dt, A, B, C, *, chunk: int):
    raise NotImplementedError(f"ssd_reference {_LATER} (with kernel K3, ssd)")


def ssd_step(x, dt, A, B, C, state):
    raise NotImplementedError(f"ssd_step {_LATER} (with kernel K3, ssd)")
