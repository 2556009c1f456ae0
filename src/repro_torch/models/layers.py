"""Model layers in plain torch (functional; params are nested dicts).

The reference package's ``models/layers.py``.  Attention comes in three
implementations selected by cfg.attn_impl:

- "quadratic": materialises the score matrix — the readable oracle, used
  for small shapes and as the reference for everything else.
- "xla_flash": query-chunked attention, plain torch (the name is the
  reference's); memory O(block * seq) per chunk.
- "hopper": the hand-written CUDA kernel of
  :mod:`repro_torch.kernels.flash_attention` (on CPU tensors its wrapper
  runs the plain version).

All attention paths support GQA, causal masking, sliding windows and
gemma-style logit soft-capping.  The Mamba2 block's full-sequence SSD
goes through the hand-written kernel of :mod:`repro_torch.kernels.ssd`
(its wrapper runs the plain version on CPU tensors); its decode step is
the single-token recurrence.  The MoE block is plain torch (its expert
products are ``torch.einsum``, as the reference computes them outside
any kernel).  The reference's sharding annotations are no-ops on one
card and are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the training attention and the chunked SSD scan, the functions the
# reference differentiates, live beside the kernels whose backward they
# are (and are this module's ``attention_xla_flash`` / ``ssd_reference``)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, attention_xla_flash, mask_bias as _mask_bias)
from repro_torch.kernels.ssd.ref import (  # noqa: F401
    f32 as _f32, ssd_reference)


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
               cache_pos=None, cross_kv=None, causal=True):
    """Self- or cross-attention block.

    p: {"q","k","v","o"} projection kernels.
    window: sliding-window size (0 = full attention).
    cache: None (prefill without cache) or dict {"k","v"} of (B,S,KH,D)
        buffers to update at cache_pos and read (decode).  The update is
        IN PLACE: the reference's jitted decode step donates the cache
        buffers, and writing into them here is what that donation buys.
    cross_kv: (k, v) precomputed encoder projections (B,T,KH,D) for
        cross-attention: non-causal over all T keys through ``attention``
        (on the card the kernel, for a decode step's single query too),
        and neither q nor k is roped, as in the reference.
    Returns (out, new_kv) where new_kv is the (k, v) pair produced by this
    call (prefill), the updated cache dict (decode), or None (cross).
    """
    b, s, e = x.shape
    q = torch.einsum("bse,ehd->bshd", x, p["q"])
    if cross_kv is not None:
        k, v = cross_kv
        out = attention(cfg, q, k, v, q_pos=positions,
                        k_pos=torch.arange(k.shape[1], device=x.device),
                        causal=False, window=0, cap=cfg.attn_softcap)
        new_kv = None
    else:
        k = torch.einsum("bse,ekd->bskd", x, p["k"])
        v = torch.einsum("bse,ekd->bskd", x, p["v"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is None:
            out = attention(cfg, q, k, v, q_pos=positions, k_pos=positions,
                            causal=causal, window=window,
                            cap=cfg.attn_softcap)
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


def top_k(gates, k: int):
    """The ``k`` largest gates and their experts, the lower expert first
    among equal gates (as ``jax.lax.top_k``; ``torch.topk`` promises no
    order on ties): a stable descending sort, cut to ``k``."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(cfg, router, x):
    """The routing of :func:`moe_block`, the reference's grouped capacity
    dispatch: one group a sequence, ``cap = ceil(tokens * k / E *
    capacity_factor)`` slots an expert in a group, the (token, choice)
    pairs taken in stable expert order and those past an expert's
    capacity dropped.

    router: (E, e) float32, cast to x's dtype as in the reference.
    Returns (st, sg, slot, keep, cap): for each group's tg * k pairs in
    dispatch order the token, its renormalised gate (float32), its row
    of the (E * cap + 1)-row buffer (E * cap, the overflow row, when
    dropped) and whether it was kept.
    """
    b, s, e = x.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    groups, tg = b, s
    logits = torch.einsum("gte,Ee->gtE", x.reshape(groups, tg, e),
                          router.to(x.dtype))
    gates = torch.softmax(logits.float(), dim=-1)
    topg, tope = top_k(gates, k)                           # (g, tg, k)
    topg = topg / torch.clamp(topg.sum(-1, keepdim=True), min=1e-9)

    cap = int(math.ceil(tg * k / E * cfg.capacity_factor))
    flat_e = tope.reshape(groups, tg * k)
    flat_t = torch.arange(tg, device=x.device).repeat_interleave(k)[None] \
        .expand(groups, tg * k)
    flat_g = topg.reshape(groups, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sg = torch.gather(flat_g, 1, order)
    onehot = F.one_hot(se, E)                              # (g, tg*k, E)
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                            se[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)  # overflow slot
    return st, sg, slot, keep, cap


def moe_block(cfg, p, x):
    """Top-k token-choice MoE with grouped capacity dispatch
    (:func:`moe_dispatch`); the experts' products are ``torch.einsum``
    over every expert's capacity slots.

    p: {"router": (E, e) float32, "wi": (X, e, f), "wg": (X, e, f),
    "wo": (X, f, e)}.
    """
    b, s, e = x.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    if k > 2:
        # the combine below adds k terms into zeros in x's dtype; two
        # terms sum to the same bits in either order, more do not
        raise ValueError(f"experts_per_tok {k} > 2: the combine's sum "
                         "would depend on the order of its terms")
    groups, tg = b, s
    xt = x.reshape(groups, tg, e)
    st, sg, slot, keep, cap = moe_dispatch(cfg, p["router"], x)
    # rows of the (groups * (E*cap + 1), e) buffer; every dropped pair
    # writes the group's overflow row, so which of them lands there is
    # left to the scatter (nondeterministic on the card) and harmless:
    # that row is cut off before the experts run
    row = torch.arange(groups, device=x.device)[:, None] * (E * cap + 1) \
        + slot
    tok = torch.gather(xt, 1, st[..., None].expand(groups, tg * k, e))
    buf = torch.zeros((groups * (E * cap + 1), e), dtype=x.dtype,
                      device=x.device)
    buf[row.reshape(-1)] = tok.reshape(-1, e)
    buf = buf.view(groups, E * cap + 1, e)[:, :E * cap] \
        .reshape(groups, E, cap, e)
    hh = torch.einsum("gEce,Eef->gEcf", buf, p["wi"])
    gg = torch.einsum("gEce,Eef->gEcf", buf, p["wg"])
    hh = activation(gg, cfg.act) * hh
    yy = torch.einsum("gEcf,Efe->gEce", hh, p["wo"]).reshape(
        groups, E * cap, e)
    picked = torch.gather(
        yy, 1, torch.clamp(slot, 0, E * cap - 1)[..., None]
        .expand(groups, tg * k, e))
    contrib = torch.where(keep[..., None], sg[..., None] * picked, 0.0)
    # k <= 2 terms a token into zeros: the same bits in any order
    out = torch.zeros((groups * tg, e), dtype=x.dtype, device=x.device)
    out.index_add_(0, (torch.arange(groups, device=x.device)[:, None] * tg
                       + st).reshape(-1),
                   contrib.to(x.dtype).reshape(-1, e))
    return out.reshape(b, s, e)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def ssd_step(x, dt, A, B, C, state):
    """Single-token SSD recurrence.  x: (b,h,p); state: (b,h,p,n)."""
    dA = torch.exp(dt * A)                        # (b,h)
    dBx = torch.einsum("bh,bn,bhp->bhpn", *_f32(dt, B, x))
    state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", *_f32(C, state.to(C.dtype)))
    return y.to(x.dtype), state


def _depthwise_conv(seq, w, state=None):
    """Causal depthwise conv1d.  seq: (b, l, c); w: (width, c).

    state: (b, width-1, c) carried context for decode; returns (out,
    new_state).  The taps are summed left to right in seq's dtype."""
    width = w.shape[0]
    if state is None:
        ctx = F.pad(seq, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state.to(seq.dtype), seq], dim=1)
    out = sum(ctx[:, i:i + seq.shape[1], :] * w[i] for i in range(width))
    new_state = ctx[:, -(width - 1):, :] if width > 1 else None
    return out.to(seq.dtype), new_state


def mamba_block(cfg, p, x, *, cache=None):
    """Mamba2 block.  p: {"z_proj","x_proj","bc_proj","dt_proj","conv_w",
    "A_log","D","dt_bias","norm","out_proj"}.

    cache: None for the full sequence, or {"state": (b,h,hp,n) float32,
    "conv": (b,w-1,conv_dim)} for single-token decode; the decode branch
    writes both IN PLACE (as ``attn_block`` writes its k/v cache) and
    returns the same dict.  The full sequence goes through the SSD
    kernel's wrapper (:func:`repro_torch.kernels.ssd.ops.ssd`), the
    reference's ``ssd_reference`` semantics: on the card the hand-written
    kernel, on CPU tensors its plain version.
    Returns (y, cache_or_None).
    """
    from repro_torch.kernels.ssd import ops as ssd_ops
    b, l, e = x.shape
    inner = cfg.ssm_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    hp = cfg.ssm_head_dim
    z = torch.einsum("ble,ed->bld", x, p["z_proj"])
    xin = torch.einsum("ble,ed->bld", x, p["x_proj"])
    bc = torch.einsum("ble,ed->bld", x, p["bc_proj"])
    dt = torch.einsum("ble,eh->blh", x, p["dt_proj"])
    Bc, Cc = bc[..., :n], bc[..., n:]
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _depthwise_conv(conv_in, p["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :inner]
    Bc = conv_out[..., inner:inner + n]
    Cc = conv_out[..., inner + n:]
    dt = F.softplus(dt + p["dt_bias"])                # (b,l,h) float32
    A = -torch.exp(p["A_log"].float())                # (h,)
    xh = xin.reshape(b, l, h, hp)
    if cache is None:
        y = ssd_ops.ssd(xh, dt, A, Bc, Cc, chunk=min(cfg.ssm_chunk, l))
    else:
        y, new_state = ssd_step(xh[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                cache["state"])
        y = y[:, None]
        cache["state"].copy_(new_state)
        cache["conv"].copy_(new_conv)
    y = (y + xh * p["D"][None, None, :, None]).to(x.dtype)
    y = y.reshape(b, l, inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bld,de->ble", y, p["out_proj"]).to(x.dtype)
    return out, cache
