"""Model assembly: parameter declarations and the forward pass of the
dense family.

The reference scans its stacked layers with ``lax.scan`` and dispatches
gemma's local / global layers with ``lax.cond`` on a per-layer flag;
here the scan is a Python loop over the stacked tensors and the
``cond`` an ``if`` on the same flag.  The other families (moe, ssm,
hybrid, encdec, vlm), the loss and training belong to later slices of
the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .params import DTYPES, P


def require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family ({cfg.name}) belongs to "
            "a later slice of the PyTorch port; this one serves the dense "
            "family")


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, nl: int):
    e, h, kh, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre = (nl,) if nl else ()
    lax_ = ("layers",) if nl else ()
    return {
        "q": P(pre + (e, h, d), lax_ + ("embed", "heads", "head_dim")),
        "k": P(pre + (e, kh, d), lax_ + ("embed", "kv_heads", "head_dim")),
        "v": P(pre + (e, kh, d), lax_ + ("embed", "kv_heads", "head_dim")),
        "o": P(pre + (h, d, e), lax_ + ("heads", "head_dim", "embed")),
    }


def _mlp_spec(cfg: ModelConfig, nl: int):
    e, f = cfg.d_model, cfg.d_ff
    pre = (nl,) if nl else ()
    lax_ = ("layers",) if nl else ()
    return {
        "wi": P(pre + (e, f), lax_ + ("embed", "mlp")),
        "wg": P(pre + (e, f), lax_ + ("embed", "mlp")),
        "wo": P(pre + (f, e), lax_ + ("mlp", "embed")),
    }


def _norm(nl: int, e: int):
    if nl:
        return P((nl, e), ("layers", None), init="zeros", dtype="float32")
    return P((e,), (None,), init="zeros", dtype="float32")


def params_spec(cfg: ModelConfig) -> dict:
    require_dense(cfg, "params_spec")
    e, v, nl = cfg.d_model, cfg.vocab_size, cfg.num_layers
    spec: dict = {"tok_embed": P((v, e), ("vocab", "embed"), init="embed")}
    spec["layers"] = {"ln1": _norm(nl, e), "ln2": _norm(nl, e),
                      "attn": _attn_spec(cfg, nl), "mlp": _mlp_spec(cfg, nl)}
    spec["final_norm"] = _norm(0, e)
    if not cfg.tie_embeddings:
        spec["unembed"] = P((e, v), ("embed", "vocab"))
    return spec


# ---------------------------------------------------------------------------
# Blocks and the layer stack
# ---------------------------------------------------------------------------

def _dense_block(cfg, p, x, positions, window, *, cache=None, cache_pos=None):
    h, kv = L.attn_block(cfg, p["attn"],
                         L.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions=positions, window=window,
                         cache=cache, cache_pos=cache_pos)
    x = x + h
    inner = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(cfg, p["mlp"], inner)
    return x, kv


def _attn_windowed(cfg, p, x, positions, is_global, *, cache=None,
                   cache_pos=None):
    """Global or local attention by the layer's flag (the reference's
    ``lax.cond`` over two static windows)."""
    window = cfg.window_size
    if window and cfg.global_every and is_global:
        window = 0
    return _dense_block(cfg, p, x, positions, window, cache=cache,
                        cache_pos=cache_pos)


def _layer_flags(cfg: ModelConfig) -> np.ndarray:
    return np.array([1 if cfg.layer_is_global(i) else 0
                     for i in range(cfg.num_layers)], dtype=np.int32)


def layer_params(lp: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``(L, ...)`` tensors (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in lp.items()}


def _stack_dense(cfg, lp, x, positions, *, collect_kv=False):
    flags = _layer_flags(cfg)
    kvs = []
    for i in range(cfg.num_layers):
        x, kv = _attn_windowed(cfg, layer_params(lp, i), x, positions,
                               flags[i])
        if collect_kv:
            kvs.append(kv)
    return x, (kvs if collect_kv else None)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens):
    x = params["tok_embed"][tokens] * (cfg.d_model ** 0.5)
    return x.to(DTYPES[cfg.dtype])


def unembed(cfg, params, x):
    w = (params["tok_embed"].T if cfg.tie_embeddings
         else params["unembed"])
    logits = torch.einsum("bse,ev->bsv", x, w)
    return L.softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params, batch):
    """Run the backbone to final hidden states (no unembedding)."""
    require_dense(cfg, "forward_hidden")
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _stack_dense(cfg, params["layers"], x, positions)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params, batch):
    return unembed(cfg, params, forward_hidden(cfg, params, batch))
