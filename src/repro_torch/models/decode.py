"""Serving path: KV / SSM caches, prefill and decode steps.

Cache layout (leading ``layers`` axis, as in the reference):

dense/moe/vlm : {"k","v": (L, B, S, KH, D)} in the model dtype
ssm           : {"state": (L, B, H, P, N) float32, "conv": (L, B, W-1, C)}
hybrid        : ssm caches + {"attn_k","attn_v": (sites, B, S, KH, D)}
encdec        : {"k","v": (L, B, S, KH, D), "xk","xv": (L, B, T, KH, D)}

The decode step consumes one token per sequence at position ``pos`` and
returns next-token logits plus the cache, which it updates IN PLACE:
the reference's serving engine donates the cache to its jitted step, and
writing into the same buffers is what that donation buys.  The cache's
sequence dim carries the "kv_seq" logical axis (:func:`cache_axes`), so
a DTensor cache at scale shards it over the model axis.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import logical, zeros

from . import layers as L
from .config import ModelConfig
from .params import DTYPES, ShapeDtype
from .transformer import (_attn_windowed, _dense_block, _layer_flags,
                          _mamba_layer, _stack_dense, _stack_encdec_decoder,
                          _stack_hybrid, _stack_ssm, embed_tokens,
                          embed_with_patches, encode, is_attn_site,
                          layer_params, unembed)

ATTENTION = ("dense", "moe", "vlm")   # the dense layer stack and cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """:class:`ShapeDtype` of every cache entry (the dry run's stand-ins);
    mirrors :func:`init_cache`."""
    dt = DTYPES[cfg.dtype]
    nl, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    out: dict = {}
    if cfg.family in ATTENTION + ("encdec",):
        out["k"] = out["v"] = ShapeDtype((nl, batch, max_seq, kh, hd), dt)
    if cfg.family == "encdec":
        out["xk"] = out["xv"] = ShapeDtype(
            (nl, batch, cfg.encoder_seq, kh, hd), dt)
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
        out["state"] = ShapeDtype((nl, batch, h, p, n), torch.float32)
        out["conv"] = ShapeDtype((nl, batch, cfg.conv_width - 1, conv_dim),
                                 dt)
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        out["attn_k"] = out["attn_v"] = ShapeDtype(
            (sites, batch, max_seq, kh, hd), dt)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Zeros of :func:`cache_spec` on ``device``; under
    :func:`~repro_torch.sharding.rules.use_mesh` DTensors placed by
    :func:`cache_axes`."""
    dev = resolve_device(device)
    ax = cache_axes(cfg)
    return {k: zeros(v.shape, v.dtype, ax[k], dev)
            for k, v in cache_spec(cfg, batch, max_seq).items()}


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes tree matching :func:`init_cache`'s structure."""
    kv = ("layers", "kv_batch", "kv_seq", "act_kv_heads", None)
    ssm = {"state": ("layers", "kv_batch", "ssm_heads", None, None),
           "conv": ("layers", "kv_batch", None, "ssm_inner")}
    if cfg.family in ATTENTION:
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return dict(ssm, attn_k=kv, attn_v=kv)
    if cfg.family == "encdec":
        xkv = ("layers", "kv_batch", None, "act_kv_heads", None)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}
    return {}


def _constrain_cache(cfg, cache: dict) -> dict:
    """``cache`` itself, each DTensor entry placed by :func:`cache_axes`."""
    ax = cache_axes(cfg)
    for k, v in cache.items():
        cache[k] = logical(v, ax[k])
    return cache


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, pos: int):
    """One decoding step.

    tokens: (B, 1) integer tensor — the token just produced/fed.
    pos   : its position (cache fill level), a Python int.
    Returns (logits (B, 1, V), cache) — the same cache dict, its tensors
    written in place (k/v at ``pos``; the ssm state and conv context);
    encdec reads its cross-attention k/v (``xk``, ``xv``) and leaves them.
    """
    x = embed_tokens(cfg, params, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    cache = _constrain_cache(cfg, cache)
    lp = params["layers"]
    if cfg.family in ATTENTION:
        flags = _layer_flags(cfg)
        for i in range(cfg.num_layers):
            x, _ = _attn_windowed(cfg, layer_params(lp, i), x, positions,
                                  flags[i],
                                  cache={"k": cache["k"][i],
                                         "v": cache["v"][i]},
                                  cache_pos=pos)
    elif cfg.family == "encdec":
        for i in range(cfg.num_layers):
            p = layer_params(lp, i)
            h, _ = L.attn_block(cfg, p["attn"],
                                L.rms_norm(x, p["ln1"], cfg.norm_eps),
                                positions=positions, window=0,
                                cache={"k": cache["k"][i],
                                       "v": cache["v"][i]},
                                cache_pos=pos)
            x = x + h
            h, _ = L.attn_block(cfg, p["xattn"],
                                L.rms_norm(x, p["ln2"], cfg.norm_eps),
                                positions=positions,
                                cross_kv=(cache["xk"][i], cache["xv"][i]))
            x = x + h
            x = x + L.mlp_block(cfg, p["mlp"],
                                L.rms_norm(x, p["ln3"], cfg.norm_eps))
    else:  # ssm, hybrid
        for i in range(cfg.num_layers):
            x, _ = _mamba_layer(cfg, layer_params(lp, i), x,
                                cache={"state": cache["state"][i],
                                       "conv": cache["conv"][i]})
            if cfg.family == "hybrid" and is_attn_site(cfg, i):
                site = i // cfg.attn_every
                x, _ = _dense_block(cfg, params["shared_attn"], x, positions,
                                    0, cache={"k": cache["attn_k"][site],
                                              "v": cache["attn_v"][site]},
                                    cache_pos=pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), _constrain_cache(cfg, cache)


def prefill(cfg: ModelConfig, params, batch, max_seq: int | None = None):
    """Run the prompt through the backbone, returning (last-token logits,
    cache of ``max_seq`` positions — the prompt length when not given).

    dense / moe / vlm: the cache is filled to the prompt length and zero
    beyond it (vlm: ``batch["patches"]`` take the first positions).
    encdec: ``batch["frames"]`` through the encoder; ``xk`` / ``xv`` are
    every layer's projections of its output, and the self-attention
    cache comes back as ``init_cache`` made it, unfilled, as in the
    reference: decode steps attend over zero keys at the prompt's
    positions.
    ssm / hybrid: as in the reference, the full-sequence pass (the SSD
    kernel) keeps no final states, so the cache comes back as
    ``init_cache`` made it, unfilled; ``ServeEngine`` ingests such
    prompts through the recurrence instead.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = torch.arange(s, device=tokens.device)
    kvs = None
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"])
        lp = params["layers"]
        cache = init_cache(cfg, b, max_seq, device=tokens.device)
        cache["xk"] = L.project("bse,lekd->lbskd", enc,
                                lp["xattn"]["k"]).contiguous()
        cache["xv"] = L.project("bse,lekd->lbskd", enc,
                                lp["xattn"]["v"]).contiguous()
        x = embed_tokens(cfg, params, tokens)
        x = _stack_encdec_decoder(cfg, lp, x, positions, enc)
    else:
        if cfg.family in ATTENTION:
            x = embed_with_patches(cfg, params, batch)
            x, kvs = _stack_dense(cfg, params["layers"], x, positions,
                                  collect_kv=True)
        elif cfg.family == "ssm":
            x = embed_tokens(cfg, params, tokens)
            x, kvs = _stack_ssm(cfg, params["layers"], x, positions)
        else:  # hybrid
            x = embed_tokens(cfg, params, tokens)
            x, kvs = _stack_hybrid(cfg, params["layers"],
                                   params["shared_attn"], x, positions)
        # made after the stack, so that it never sits beside its
        # activations
        cache = init_cache(cfg, b, max_seq, device=tokens.device)
    for i, (k, v) in enumerate(kvs or ()):
        L.write_cache(cache["k"][i], k, 0)
        L.write_cache(cache["v"][i], v, 0)
    del kvs
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
