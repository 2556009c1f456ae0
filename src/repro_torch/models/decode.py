"""Serving path: KV / SSM caches, prefill and decode steps.

Cache layout (leading ``layers`` axis, as in the reference):

dense  : {"k","v": (L, B, S, KH, D)} in the model dtype
ssm    : {"state": (L, B, H, P, N) float32, "conv": (L, B, W-1, C)}
hybrid : ssm caches + {"attn_k","attn_v": (sites, B, S, KH, D)}

The decode step consumes one token per sequence at position ``pos`` and
returns next-token logits plus the cache, which it updates IN PLACE:
the reference's serving engine donates the cache to its jitted step, and
writing into the same buffers is what that donation buys.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .config import ModelConfig
from .params import DTYPES
from .transformer import (_attn_windowed, _dense_block, _layer_flags,
                          _mamba_layer, _stack_dense, _stack_hybrid,
                          _stack_ssm, embed_tokens, is_attn_site,
                          layer_params, require_ported, unembed)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    nl, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    out: dict = {}
    if cfg.family == "dense":
        out["k"] = torch.zeros((nl, batch, max_seq, kh, hd), dtype=dt,
                               device=dev)
        out["v"] = torch.zeros_like(out["k"])
    else:  # ssm, hybrid
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
        out["state"] = torch.zeros((nl, batch, h, p, n),
                                   dtype=torch.float32, device=dev)
        out["conv"] = torch.zeros((nl, batch, cfg.conv_width - 1, conv_dim),
                                  dtype=dt, device=dev)
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        out["attn_k"] = torch.zeros((sites, batch, max_seq, kh, hd),
                                    dtype=dt, device=dev)
        out["attn_v"] = torch.zeros_like(out["attn_k"])
    return out


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, pos: int):
    """One decoding step.

    tokens: (B, 1) integer tensor — the token just produced/fed.
    pos   : its position (cache fill level), a Python int.
    Returns (logits (B, 1, V), cache) — the same cache dict, its tensors
    written in place (k/v at ``pos``; the ssm state and conv context).
    """
    require_ported(cfg, "decode_step")
    x = embed_tokens(cfg, params, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    lp = params["layers"]
    if cfg.family == "dense":
        flags = _layer_flags(cfg)
        for i in range(cfg.num_layers):
            x, _ = _attn_windowed(cfg, layer_params(lp, i), x, positions,
                                  flags[i],
                                  cache={"k": cache["k"][i],
                                         "v": cache["v"][i]},
                                  cache_pos=pos)
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
    return unembed(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, batch, max_seq: int | None = None):
    """Run the prompt through the backbone, returning (last-token logits,
    cache of ``max_seq`` positions — the prompt length when not given).

    dense: the cache is filled to the prompt length and zero beyond it.
    ssm / hybrid: as in the reference, the full-sequence pass (the SSD
    kernel) keeps no final states, so the cache comes back as
    ``init_cache`` made it, unfilled; ``ServeEngine`` ingests such
    prompts through the recurrence instead.
    """
    require_ported(cfg, "prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = torch.arange(s, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "dense":
        x, kvs = _stack_dense(cfg, params["layers"], x, positions,
                              collect_kv=True)
    elif cfg.family == "ssm":
        x, kvs = _stack_ssm(cfg, params["layers"], x, positions)
    else:  # hybrid
        x, kvs = _stack_hybrid(cfg, params["layers"], params["shared_attn"],
                               x, positions)
    # made after the stack, so that it never sits beside its activations
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    for i, (k, v) in enumerate(kvs or ()):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    del kvs
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
