"""Serving path of the dense family: KV cache, prefill and decode steps.

Cache layout (leading ``layers`` axis, as in the reference):

dense : {"k","v": (L, B, S, KH, D)} in the model dtype

The decode step consumes one token per sequence at position ``pos`` and
returns next-token logits plus the cache, which it updates IN PLACE:
the reference's serving engine donates the cache to its jitted step, and
writing into the same buffers is what that donation buys.  The caches
of the other families belong to later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .config import ModelConfig
from .params import DTYPES
from .transformer import (_attn_windowed, _layer_flags, _stack_dense,
                          embed_tokens, layer_params, require_dense, unembed)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    require_dense(cfg, "init_cache")
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=dev),
            "v": torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=dev)}


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, pos: int):
    """One decoding step.

    tokens: (B, 1) integer tensor — the token just produced/fed.
    pos   : its position (cache fill level), a Python int.
    Returns (logits (B, 1, V), cache) — the same cache dict, written in
    place at ``pos``.
    """
    require_dense(cfg, "decode_step")
    x = embed_tokens(cfg, params, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    flags = _layer_flags(cfg)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        x, _ = _attn_windowed(cfg, layer_params(lp, i), x, positions,
                              flags[i],
                              cache={"k": cache["k"][i], "v": cache["v"][i]},
                              cache_pos=pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, batch, max_seq: int | None = None):
    """Run the prompt through the backbone, returning (last-token logits,
    cache filled to the prompt length and zero beyond it, up to
    ``max_seq`` positions — the prompt length when not given)."""
    require_dense(cfg, "prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = torch.arange(s, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    x, kvs = _stack_dense(cfg, params["layers"], x, positions,
                          collect_kv=True)
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    del kvs
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
