"""Model layers in plain torch (functional; params are nested dicts).

The reference package's ``models/layers.py`` but for the MoE block.
Attention comes in three implementations selected by cfg.attn_impl:

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
the single-token recurrence.  The reference's sharding annotations are
no-ops on one card and are left out.  The MoE block belongs to a later
slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30

_LATER = "belongs to a later slice of the PyTorch port"


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


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def _f32(*ts):
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
    # intra-chunk: L[i,j] = exp(s_i - s_j) for j <= i
    si = s_cum[:, :, :, None, :]        # (b,nc,q,1,h)
    sj = s_cum[:, :, None, :, :]        # (b,nc,1,q,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask[None, None, :, :, None], torch.exp(si - sj),
                       0.0)  # (b,nc,q,q,h)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b,nc,q,q), x's dtype
    scores = cb[..., None] * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", *_f32(scores, xc))
    # chunk-final states: S_c = sum_j exp(s_Q - s_j) dt_j B_j x_j
    decay_out = torch.exp(s_cum[:, :, -1:, :] - s_cum)   # (b,nc,q,h)
    dBx = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                       *_f32(decay_out * dtc, Bc, xc))
    chunk_decay = torch.exp(s_cum[:, :, -1, :])          # (b,nc,h)
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    S_enter = []  # the state *entering* each chunk
    for c in range(nc):
        S_enter.append(S)
        S = S * chunk_decay[:, c, :, None, None].float() + dBx[:, c]
    S_enter = torch.stack(S_enter, dim=1)  # (b,nc,h,p,n)
    # inter-chunk: y_i += C_i . (exp(s_i) * S_enter)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp",
                           *_f32(Cc, S_enter.to(Cc.dtype), torch.exp(s_cum)))
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y.to(x.dtype), S


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
