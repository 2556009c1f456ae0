"""Model assembly: parameter declarations and the forward pass of every
family: dense | moe | ssm (mamba2) | hybrid (zamba2) | encdec (whisper) |
vlm (internvl).

The reference scans its stacked layers with ``lax.scan`` and dispatches
gemma's local / global layers and zamba's shared-attention sites with
``lax.cond`` on a per-layer flag; here the scan is a Python loop over
the stacked tensors and the ``cond`` an ``if`` on the same flag.  Each
loop body is checkpointed as ``cfg.remat`` asks (:func:`_remat`) when
autograd records; :func:`loss_fn` is the training loss.  The residual
stream, embeddings and logits carry the reference's sharding annotations
(:func:`_sp`, :func:`embed_tokens`, :func:`unembed`), which act on
DTensors only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.rules import logical

from . import layers as L
from .config import ModelConfig
from .params import DTYPES, P


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


def _moe_spec(cfg: ModelConfig, nl: int):
    e, f, x = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": P((nl, x, e), ("layers", "experts", "embed"),
                    dtype="float32"),
        "wi": P((nl, x, e, f), ("layers", "experts", "embed", "mlp")),
        "wg": P((nl, x, e, f), ("layers", "experts", "embed", "mlp")),
        "wo": P((nl, x, f, e), ("layers", "experts", "mlp", "embed")),
    }


def _mamba_spec(cfg: ModelConfig, nl: int):
    e = cfg.d_model
    inner, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = inner + 2 * n
    return {
        "z_proj": P((nl, e, inner), ("layers", "embed", "ssm_inner")),
        "x_proj": P((nl, e, inner), ("layers", "embed", "ssm_inner")),
        "bc_proj": P((nl, e, 2 * n), ("layers", "embed", None)),
        "dt_proj": P((nl, e, h), ("layers", "embed", "ssm_heads")),
        "conv_w": P((nl, cfg.conv_width, conv_dim),
                    ("layers", "conv", "ssm_inner")),
        "A_log": P((nl, h), ("layers", "ssm_heads"), init="zeros",
                   dtype="float32"),
        "D": P((nl, h), ("layers", "ssm_heads"), init="ones",
               dtype="float32"),
        "dt_bias": P((nl, h), ("layers", "ssm_heads"), init="zeros",
                     dtype="float32"),
        "norm": P((nl, inner), ("layers", "ssm_inner"), init="zeros",
                  dtype="float32"),
        "out_proj": P((nl, inner, e), ("layers", "ssm_inner", "embed")),
    }


def _norm(nl: int, e: int):
    if nl:
        return P((nl, e), ("layers", None), init="zeros", dtype="float32")
    return P((e,), (None,), init="zeros", dtype="float32")


def params_spec(cfg: ModelConfig) -> dict:
    e, v, nl = cfg.d_model, cfg.vocab_size, cfg.num_layers
    spec: dict = {"tok_embed": P((v, e), ("vocab", "embed"), init="embed")}
    if cfg.family in ("dense", "moe", "vlm"):
        blk = {"ln1": _norm(nl, e), "ln2": _norm(nl, e),
               "attn": _attn_spec(cfg, nl)}
        if cfg.family == "moe":
            blk["moe"] = _moe_spec(cfg, nl)
        else:
            blk["mlp"] = _mlp_spec(cfg, nl)
        spec["layers"] = blk
    elif cfg.family in ("ssm", "hybrid"):
        spec["layers"] = {"ln1": _norm(nl, e),
                          "mamba": _mamba_spec(cfg, nl)}
        if cfg.family == "hybrid":  # one shared block, unstacked
            spec["shared_attn"] = {
                "ln1": _norm(0, e), "ln2": _norm(0, e),
                "attn": _attn_spec(cfg, 0), "mlp": _mlp_spec(cfg, 0)}
    elif cfg.family == "encdec":
        ne = cfg.encoder_layers
        spec["encoder"] = {"ln1": _norm(ne, e), "ln2": _norm(ne, e),
                           "attn": _attn_spec(cfg, ne),
                           "mlp": _mlp_spec(cfg, ne)}
        spec["layers"] = {"ln1": _norm(nl, e), "ln2": _norm(nl, e),
                          "ln3": _norm(nl, e), "attn": _attn_spec(cfg, nl),
                          "xattn": _attn_spec(cfg, nl),
                          "mlp": _mlp_spec(cfg, nl)}
        spec["enc_final_norm"] = _norm(0, e)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.frontend:
        spec["frontend_proj"] = P((cfg.frontend_dim, e),
                                  ("frontend", "embed"))
    spec["final_norm"] = _norm(0, e)
    if not cfg.tie_embeddings:
        spec["unembed"] = P((e, v), ("embed", "vocab"))
    return spec


# ---------------------------------------------------------------------------
# Blocks and the layer stack
# ---------------------------------------------------------------------------

REMAT = ("none", "full", "names", "dots", "offload_dots")


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one layer's body) as ``cfg.remat`` asks: the reference's
    ``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant)
    around the whole body, applied only while autograd records.

    The reference's policies ("names": keep the attention outputs;
    "dots": keep every matrix product's output; "offload_dots": keep
    nothing on the card) save more or less of the body; here each is the
    full checkpoint.  Gradients are the same under every policy — only
    memory and recompute differ.  The layers draw no random numbers, so
    no generator state is stashed for the recompute."""
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    if cfg.remat == "none":
        return fn

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return body


_sp = L.seq_sharded


def _dense_block(cfg, p, x, positions, window, *, cache=None, cache_pos=None):
    h, kv = L.attn_block(cfg, p["attn"],
                         L.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions=positions, window=window,
                         cache=cache, cache_pos=cache_pos)
    x = _sp(x + h)
    inner = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        x = _sp(x + L.moe_block(cfg, p["moe"], inner))
    else:
        x = _sp(x + L.mlp_block(cfg, p["mlp"], inner))
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
    body = _remat(cfg, lambda x, p, flag: _attn_windowed(cfg, p, x,
                                                         positions, flag))
    kvs = []
    for i in range(cfg.num_layers):
        x, kv = body(x, layer_params(lp, i), flags[i])
        if collect_kv:
            kvs.append(kv)
    return x, (kvs if collect_kv else None)


def _mamba_layer(cfg, p, x, *, cache=None):
    h, cache = L.mamba_block(cfg, p["mamba"],
                             L.rms_norm(x, p["ln1"], cfg.norm_eps),
                             cache=cache)
    return _sp(x + h), cache


def _stack_ssm(cfg, lp, x, positions):
    body = _remat(cfg, lambda x, p: _mamba_layer(cfg, p, x)[0])
    for i in range(cfg.num_layers):
        x = body(x, layer_params(lp, i))
    return x, None


def is_attn_site(cfg: ModelConfig, i: int) -> bool:
    """Whether hybrid layer ``i`` is followed by the shared block."""
    return (i + 1) % cfg.attn_every == 0


def _stack_hybrid(cfg, lp, shared, x, positions, *, collect_kv=False):
    """Zamba2-style: mamba backbone + one shared attention block applied
    every cfg.attn_every layers (same weights at every site).  With
    ``collect_kv`` also the per-layer (k, v) of the shared block, zeros
    at the layers that are not sites (the reference's scan outputs)."""
    def layer(x, p, site):
        x, _ = _mamba_layer(cfg, p, x)
        if site:
            return _dense_block(cfg, shared, x, positions, 0)
        return x, None

    body = _remat(cfg, layer)
    kvs = []
    for i in range(cfg.num_layers):
        x, kv = body(x, layer_params(lp, i), is_attn_site(cfg, i))
        if collect_kv:
            kvs.append(kv)
    if not collect_kv:
        return x, None
    zero = tuple(map(torch.zeros_like, next(kv for kv in kvs if kv)))
    return x, [kv or zero for kv in kvs]


def _stack_encoder(cfg, lp, x):
    """The encoder: non-causal self-attention (roped over the frame
    positions) and the MLP, ``cfg.encoder_layers`` times."""
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, p):
        h, _ = L.attn_block(cfg, p["attn"],
                            L.rms_norm(x, p["ln1"], cfg.norm_eps),
                            positions=positions, window=0, causal=False)
        x = _sp(x + h)
        return _sp(x + L.mlp_block(cfg, p["mlp"],
                                   L.rms_norm(x, p["ln2"], cfg.norm_eps)))

    body = _remat(cfg, layer)
    for i in range(cfg.encoder_layers):
        x = body(x, layer_params(lp, i))
    return x


def _stack_encdec_decoder(cfg, lp, x, positions, enc_out):
    """The decoder: causal self-attention, cross-attention over the
    encoder output (each layer projects its own k / v), the MLP."""
    def layer(x, p, enc_out):
        h, _ = L.attn_block(cfg, p["attn"],
                            L.rms_norm(x, p["ln1"], cfg.norm_eps),
                            positions=positions, window=0)
        x = _sp(x + h)
        xk = L.project("bse,ekd->bskd", enc_out, p["xattn"]["k"])
        xv = L.project("bse,ekd->bskd", enc_out, p["xattn"]["v"])
        h, _ = L.attn_block(cfg, p["xattn"],
                            L.rms_norm(x, p["ln2"], cfg.norm_eps),
                            positions=positions, cross_kv=(xk, xv))
        x = _sp(x + h)
        return _sp(x + L.mlp_block(cfg, p["mlp"],
                                   L.rms_norm(x, p["ln3"], cfg.norm_eps)))

    body = _remat(cfg, layer)
    for i in range(cfg.num_layers):
        x = body(x, layer_params(lp, i), enc_out)
    return x


# ---------------------------------------------------------------------------
# Embedding / logits / frontends
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens):
    x = L.embed_lookup(params["tok_embed"], tokens) * (cfg.d_model ** 0.5)
    return logical(x.to(DTYPES[cfg.dtype]),
                   ("batch", "act_seq", "act_embed"))


def embed_with_patches(cfg, params, batch):
    """Token embeddings; for vlm the first ``patches.shape[1]`` positions
    are the projected patch embeddings instead."""
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = L.project("bpf,fe->bpe",
                            batch["patches"].to(DTYPES[cfg.dtype]),
                            params["frontend_proj"])
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        x = logical(x, ("batch", "act_seq", "act_embed"))
    return x


def encode(cfg, params, frames):
    """The encdec encoder's output, normed: frames (B, T, frontend_dim)
    projected, through the encoder stack and ``enc_final_norm``."""
    enc_in = L.project("btf,fe->bte", frames.to(DTYPES[cfg.dtype]),
                       params["frontend_proj"])
    enc = _stack_encoder(cfg, params["encoder"], _sp(enc_in))
    return L.seq_gathered(
        L.rms_norm(enc, params["enc_final_norm"], cfg.norm_eps))


def unembed(cfg, params, x):
    w = (params["tok_embed"].T if cfg.tie_embeddings
         else params["unembed"])
    logits = L.project("bse,ev->bsv", L.seq_gathered(x), w)
    logits = L.softcap(logits, cfg.final_softcap)
    return logical(logits, ("batch", "act_seq", "act_vocab"))


def _logsumexp(logits):
    """``torch.logsumexp(logits, -1)``.  On a DTensor the max and the sum
    over the (possibly sharded) vocab are reduced as such (a ``Partial``
    max and sum), never by gathering the logits whole; the max is a
    constant of the gradient, as in any stable logsumexp."""
    if not L.is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Partial, Replicate

    def reduced(x):   # all-reduced where partial, so no shard moves
        return x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])

    m = reduced(logits.detach().amax(-1))
    return m + torch.log(reduced(torch.exp(logits - m[..., None]).sum(-1)))


def _gold_logits(logits, labels):
    """``logits[..., labels]``.  On a DTensor whose vocab dim is sharded
    each shard picks the labels it holds (zero elsewhere), and the
    result is their ``Partial`` sum."""
    if not L.is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, lp = logits.device_mesh, list(logits.placements)
    vi, vn = L._mesh_coordinate(mesh, lp, 2)
    vl = logits.shape[-1] // vn
    lab = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
           for p in lp]
    out = [Partial() if isinstance(p, Shard) and p.dim == 2 else p
           for p in lp]

    def local(lg, lab):
        return L._vocab_shard_pick(
            lambda i: torch.gather(lg, -1, i[..., None])[..., 0], lab, vi,
            vl)

    return L._local_map(local, (lp, lab), out, mesh)(logits, labels)


def _ce_loss_chunk(cfg, params, x, labels, mask):
    """(summed masked negative log-likelihood, summed mask), float32."""
    logits = unembed(cfg, params, x).float()
    logz = _logsumexp(logits)
    gold = _gold_logits(logits, labels)
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def lm_loss_from_hidden(cfg, params, x, labels, mask):
    """Cross-entropy with optional sequence chunking (``cfg.loss_chunk``
    positions at a time, so the (B, S, V) logits are never whole in one
    product).  The chunks' sums are added left to right in float32, as
    the reference's ``lax.scan`` carries them."""
    b, s, e = x.shape
    c = cfg.loss_chunk
    if not c or s <= c or s % c != 0:
        nll, denom = _ce_loss_chunk(cfg, params, x, labels, mask)
        return nll / torch.clamp(denom, min=1.0)
    nll = denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        n, d = _ce_loss_chunk(cfg, params, x[:, c0:c0 + c],
                              labels[:, c0:c0 + c], mask[:, c0:c0 + c])
        nll, denom = nll + n, denom + d
    return nll / torch.clamp(denom, min=1.0)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params, batch):
    """Run the backbone to final hidden states (no unembedding)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"])
        x = embed_tokens(cfg, params, tokens)
        x = _stack_encdec_decoder(cfg, params["layers"], x, positions, enc)
    elif cfg.family in ("dense", "moe", "vlm"):
        x = embed_with_patches(cfg, params, batch)
        x, _ = _stack_dense(cfg, params["layers"], x, positions)
    elif cfg.family == "ssm":
        x = embed_tokens(cfg, params, tokens)
        x, _ = _stack_ssm(cfg, params["layers"], x, positions)
    else:  # hybrid
        x = embed_tokens(cfg, params, tokens)
        x, _ = _stack_hybrid(cfg, params["layers"], params["shared_attn"],
                             x, positions)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch):
    """The mean masked next-token cross-entropy of ``batch`` ("tokens",
    "labels", optional "mask" (ones), and the family's "frames" /
    "patches"), a float32 scalar."""
    x = forward_hidden(cfg, params, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return lm_loss_from_hidden(cfg, params, x, labels, mask.float())


def logits_fn(cfg: ModelConfig, params, batch):
    return unembed(cfg, params, forward_hidden(cfg, params, batch))
