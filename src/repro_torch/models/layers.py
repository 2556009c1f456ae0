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
any kernel).

The reference's sharding annotations are here at the same points with
the same logical axes (:func:`~repro_torch.sharding.rules.logical`):
on plain tensors they do nothing, and under
:func:`~repro_torch.sharding.rules.use_mesh` they redistribute DTensors.
Each block also gathers the residual's sequence on entry and scatters
its output over it (:func:`seq_gathered`, :func:`seq_sharded`), as XLA
does around Megatron sequence sharding.  Where DTensor has no sharding
strategy, or a poor or failing one, the call runs on each rank's shard
through ``local_map``: the kernels with their inputs placed by the
reference's ``act_heads`` / ``act_kv_heads`` / ``ssm_heads`` axes
(:func:`_attention_sharded`, :func:`_ssd_sharded`), the weight products
(:func:`project`), the embedding (:func:`embed_lookup`), the cache write
(:func:`write_cache`), the conv, and the MoE dispatch per group under
batch sharding, which is local as the reference's "batched: local"
comment says (:func:`moe_block`).  On plain tensors every one of them is
the one-card code.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import (is_dtensor, logical,
                                        logical_placements)

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


def seq_sharded(x):
    """Megatron-style sequence sharding of the residual stream (the
    reference's ``transformer._sp``).  Every block leaves its output so,
    a ``Partial`` sum reduced and scattered over the sequence, so that
    its gradient comes back whole (``Redistribute``'s backward) and not
    sequence-sharded (a strided shard, see :func:`seq_gathered`)."""
    return logical(x, ("batch", "sp_seq", "act_embed"))


def seq_gathered(x):
    """``x`` (B, S, E) with its sequence whole (``act_seq``): what XLA's
    partitioner does to a sequence-sharded residual (``sp_seq``) before a
    projection, stated here because DTensor would otherwise flatten the
    sharded S into the matmul's rows as a strided shard, whose
    redistributions it plans by graph search, op by op.  Plain tensors
    pass through."""
    return logical(x, ("batch", "act_seq", "act_embed"))


def _mesh_coordinate(device_mesh, placements, dim: int):
    """This rank's shard index of tensor dim ``dim`` under
    ``placements`` and the number of shards (mesh dims in order, the
    first major)."""
    from torch.distributed.tensor import Shard
    idx, n = 0, 1
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size = device_mesh.size(mdim)
            idx = idx * size + device_mesh.get_local_rank(mdim)
            n *= size
    return idx, n


def _grad_placements(in_placements):
    """The gradients' placements of a ``local_map`` call's inputs: an
    input replicated on a mesh dim where another input is sharded saw
    only its shard's part of the work there, so its gradient is a
    ``Partial()`` sum on that dim; elsewhere the input's own placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    split = [any(isinstance(pl[m], Shard) for pl in in_placements)
             for m in range(len(in_placements[0]))]
    return tuple([Partial() if isinstance(p, Replicate) and split[m] else p
                  for m, p in enumerate(pl)] for pl in in_placements)


def _local_map(fn, in_placements, out_placements, device_mesh):
    """``fn`` on every rank's shard: inputs redistributed to
    ``in_placements``, outputs placed by ``out_placements``, gradients by
    :func:`_grad_placements`."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=_grad_placements(in_placements),
                     device_mesh=device_mesh, redistribute_inputs=True)


def project(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w``.  On DTensors the product runs on every rank's shards
    (``local_map``), placed as XLA's partitioner places an FSDP + tensor
    parallel product: ``w`` is gathered over each mesh dim where ``x``
    shards a label ``w`` lacks (the batch over the FSDP axes); a label
    both shard on one mesh dim stays sharded, a contracted one leaving a
    ``Partial`` sum; a label only one of them shards is sliced locally
    from the other where it is contracted.  DTensor's own einsum would
    flatten sharded dims into the matmul and, at the production mesh,
    fail to split them back (kv heads fewer than the model axis)."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    mesh = w.device_mesh
    xp = [Replicate() if isinstance(pl, Partial) else pl
          for pl in x.placements]
    wp = list(w.placements)
    op = []
    for m in range(mesh.ndim):
        xa = xl[xp[m].dim] if isinstance(xp[m], Shard) else None
        wa = wl[wp[m].dim] if isinstance(wp[m], Shard) else None
        if xa and wa and xa != wa:     # keep the batch, gather the other
            if xa not in wl:
                wp[m], wa = Replicate(), None
            else:
                xp[m], xa = Replicate(), None
        label = xa or wa
        if label is None:
            op.append(Replicate())
        elif label in out:
            op.append(Shard(out.index(label)))
        else:                          # contracted: both sides sliced
            xp[m], wp[m] = Shard(xl.index(label)), Shard(wl.index(label))
            op.append(Partial())

    def local(x, w):
        return torch.einsum(eq, x, w)

    return _local_map(local, (xp, wp), op, mesh)(x, w)


def _vocab_shard_pick(pick, ids, vi: int, vl: int):
    """``pick(i)`` for the ids that vocab shard ``vi`` (of ``vl`` ids)
    holds, ``i`` an id's offset in the shard, and zero for the others
    (whose offsets are clamped into the shard)."""
    idx = ids.long() - vi * vl
    ok = (idx >= 0) & (idx < vl)
    got = pick(idx.clamp(0, vl - 1))
    return torch.where(ok.reshape(ok.shape + (1,) * (got.dim() - ok.dim())),
                       got, 0.0)


def embed_lookup(table, tokens):
    """``table[tokens]``.  On a DTensor table the lookup runs on every
    rank's shards: the table gathered over its embed dim (the FSDP axes)
    and kept sharded over its vocab, each shard looking up the tokens it
    holds (zero for the others; the shards' sum is reduced over the
    vocab's axes), the tokens keeping their batch sharding.  DTensor
    would gather the tokens whole and look every one up on every rank."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tp = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
          for pl in table.placements]
    kp = list(tokens.placements)
    vi, vn = _mesh_coordinate(mesh, tp, 0)
    vl = table.shape[0] // vn
    op = [Shard(k.dim) if isinstance(k, Shard) else
          Partial() if isinstance(t, Shard) else Replicate()
          for t, k in zip(tp, kp)]

    def local(table, tokens):
        if vn == 1:
            return table[tokens]
        return _vocab_shard_pick(lambda i: table[i], tokens, vi, vl)

    out = _local_map(local, (tp, kp), op, mesh)(table, tokens)
    # reduce here: an elementwise op on a Partial sum makes DTensor
    # gather the whole batch first
    return out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                   else p for p in op])


def _attention_sharded(fn, q, k, v, kv_axes):
    """``fn(q, k, v)`` on every rank's shard: q placed by ``("batch",
    "act_seq", "act_heads", None)``, k and v by ``kv_axes`` (their
    sequence whole).  Where q's heads are sharded and k's are not (kv
    heads fewer than the model axis), each shard's query heads meet their
    own kv heads, the slice ``h // (H // KH)`` of the replicated k and v;
    their gradients are then partial sums over that axis.  Heads that the
    model axis does not divide (minitron's 24, whisper's 12) stay
    replicated there: every rank of the axis computes the whole attention
    of its batch shard."""
    mesh = q.device_mesh
    qp = logical_placements(("batch", "act_seq", "act_heads", None),
                            q.shape, device_mesh=mesh)
    kp = logical_placements(kv_axes, k.shape, device_mesh=mesh)
    h, kh = q.shape[2], k.shape[2]
    g = h // kh
    qi, qn = _mesh_coordinate(mesh, qp, 2)
    _, kn = _mesh_coordinate(mesh, kp, 2)
    lo = hi = None
    if qn != kn:  # k's heads replicated where q's are split
        hl = h // qn
        if kn != 1 or (hl % g and g % hl):
            raise ValueError(f"{h} query heads in {qn} shards do not align "
                             f"with {kh} kv heads in {kn}")
        lo, hi = qi * hl // g, ((qi + 1) * hl - 1) // g + 1

    def local(q, k, v):
        if lo is not None:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return fn(q, k, v)

    return _local_map(local, (qp, kp, kp), qp, mesh)(q, k, v)


def _flash_attention_sharded(q, k, v, *, causal, window, cap):
    """The kernel on every rank's shard (:func:`_attention_sharded`, k and
    v placed by ``act_kv_heads``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def fn(q, k, v):
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap)
    return _attention_sharded(fn, q, k, v,
                              ("batch", "act_seq", "act_kv_heads", None))


def attention(cfg, q, k, v, *, q_pos, k_pos, causal=True, window=0, cap=0.0):
    impl = cfg.attn_impl
    if impl == "hopper":
        if is_dtensor(q):
            return _flash_attention_sharded(q, k, v, causal=causal,
                                            window=window, cap=cap)
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

def write_cache(cache, new, pos: int):
    """``cache[:, pos:pos + S] = new`` IN PLACE (cache (B, T, ...), new
    (B, S, ...)).  A DTensor cache whose T is sharded ("kv_seq") is
    written shard by shard: each rank writes the positions it holds."""
    s = new.shape[1]
    if not is_dtensor(cache):
        cache[:, pos:pos + s] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, cp = cache.device_mesh, list(cache.placements)
    np_ = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
           for pl in cp]
    si, sn = _mesh_coordinate(mesh, cp, 1)
    t = cache.shape[1] // sn
    a, b = max(pos, si * t), min(pos + s, (si + 1) * t)

    def local(c, new):
        if a < b:
            c[:, a - si * t:b - si * t] = new[:, a - pos:b - pos].to(c.dtype)
        return c

    _local_map(local, (cp, np_), cp, mesh)(cache, new)


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
    x = seq_gathered(x)
    q = project("bse,ehd->bshd", x, p["q"])
    q = logical(q, ("batch", "act_seq", "act_heads", None))
    if cross_kv is not None:
        k, v = cross_kv
        out = attention(cfg, q, k, v, q_pos=positions,
                        k_pos=torch.arange(k.shape[1], device=x.device),
                        causal=False, window=0, cap=cfg.attn_softcap)
        new_kv = None
    else:
        k = project("bse,ekd->bskd", x, p["k"])
        v = project("bse,ekd->bskd", x, p["v"])
        k = logical(k, ("batch", "act_seq", "act_kv_heads", None))
        v = logical(v, ("batch", "act_seq", "act_kv_heads", None))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is None:
            out = attention(cfg, q, k, v, q_pos=positions, k_pos=positions,
                            causal=causal, window=window,
                            cap=cfg.attn_softcap)
            new_kv = (k, v)
        else:
            kc, vc = cache["k"], cache["v"]
            write_cache(kc, k, cache_pos)
            write_cache(vc, v, cache_pos)
            kc = logical(kc, ("kv_batch", "kv_seq", "act_kv_heads", None))
            vc = logical(vc, ("kv_batch", "kv_seq", "act_kv_heads", None))

            def decode(q, kc, vc):
                pos_vec = torch.full((q.shape[0],), cache_pos,
                                     dtype=torch.int64, device=q.device)
                return attention_decode(q, kc, vc, pos=pos_vec,
                                        window=window, cap=cfg.attn_softcap)

            if is_dtensor(q):
                # the cache's sequence gathered: DTensor has no
                # flash-decoding (XLA's partitioner reduces the softmax
                # across the shards instead)
                out = _attention_sharded(
                    decode, q, kc, vc,
                    ("kv_batch", None, "act_kv_heads", None))
            else:
                out = decode(q, kc, vc)
            new_kv = {"k": kc, "v": vc}
    out = project("bshd,hde->bse", out, p["o"])
    return seq_sharded(out), new_kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(cfg, p, x):
    """Gated MLP (llama-style).  p: {"wi","wg","wo"}."""
    x = seq_gathered(x)
    h = project("bse,ef->bsf", x, p["wi"])
    g = project("bse,ef->bsf", x, p["wg"])
    h = activation(g, cfg.act) * h
    h = logical(h, ("batch", "act_seq", "act_mlp"))
    return seq_sharded(project("bsf,fe->bse", h, p["wo"]))


def top_k(gates, k: int):
    """The ``k`` largest gates and their experts, the lower expert first
    among equal gates (as ``jax.lax.top_k``; ``torch.topk`` promises no
    order on ties): a stable descending sort, cut to ``k``."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tg: int) -> int:
    """Slots an expert takes in a group of ``tg`` tokens."""
    return int(math.ceil(tg * cfg.experts_per_tok / cfg.num_experts
                         * cfg.capacity_factor))


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

    cap = capacity(cfg, tg)
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


def _moe_scatter(cfg, router, xt):
    """:func:`moe_dispatch` of the groups ``xt`` (groups, tg, e) and
    their tokens written to the experts' capacity slots: (st, sg, slot,
    keep, buf (groups, E, cap, e))."""
    groups, tg, e = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    st, sg, slot, keep, cap = moe_dispatch(cfg, router, xt)
    # rows of the (groups * (E*cap + 1), e) buffer; every dropped pair
    # writes the group's overflow row, so which of them lands there is
    # left to the scatter (nondeterministic on the card) and harmless:
    # that row is cut off before the experts run
    row = torch.arange(groups, device=xt.device)[:, None] * (E * cap + 1) \
        + slot
    tok = torch.gather(xt, 1, st[..., None].expand(groups, tg * k, e))
    buf = torch.zeros((groups * (E * cap + 1), e), dtype=xt.dtype,
                      device=xt.device)
    buf[row.reshape(-1)] = tok.reshape(-1, e)
    buf = buf.view(groups, E * cap + 1, e)[:, :E * cap] \
        .reshape(groups, E, cap, e)
    return st, sg, slot, keep, buf


def _moe_combine(yy, st, sg, slot, keep, k: int):
    """Each group's kept expert outputs ``yy`` (groups, E * cap, e)
    weighted by their gates and added to their tokens (``k`` choices a
    token): (groups, tg, e)."""
    groups, n, e = yy.shape
    tg = st.shape[1] // k
    picked = torch.gather(
        yy, 1, torch.clamp(slot, 0, n - 1)[..., None]
        .expand(groups, tg * k, e))
    contrib = torch.where(keep[..., None], sg[..., None] * picked, 0.0)
    # k <= 2 terms a token into zeros: the same bits in any order
    out = torch.zeros((groups * tg, e), dtype=yy.dtype, device=yy.device)
    out.index_add_(0, (torch.arange(groups, device=yy.device)[:, None] * tg
                       + st).reshape(-1),
                   contrib.to(yy.dtype).reshape(-1, e))
    return out.reshape(groups, tg, e)


def moe_block(cfg, p, x):
    """Top-k token-choice MoE with grouped capacity dispatch
    (:func:`moe_dispatch`); the experts' products are ``torch.einsum``
    over every expert's capacity slots.  On DTensors the dispatch and the
    combine run per batch shard (``local_map``), the products on the
    experts' placements.

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
    xt = logical(seq_gathered(x).reshape(groups, tg, e),
                 ("batch", None, None))
    cap = capacity(cfg, tg)

    def scatter(router, xt):
        return _moe_scatter(cfg, router, xt)

    def combine(yy, st, sg, slot, keep):
        return _moe_combine(yy, st, sg, slot, keep, k)

    def experts(buf, wi, wg, wo):
        hh = torch.einsum("gEce,Eef->gEcf", buf, wi)
        gg = torch.einsum("gEce,Eef->gEcf", buf, wg)
        hh = activation(gg, cfg.act) * hh
        hh = logical(hh, ("batch", "act_experts", None, "act_mlp"))
        yy = torch.einsum("gEcf,Efe->gEce", hh, wo)
        return yy.reshape(yy.shape[0], -1, yy.shape[-1])

    if is_dtensor(xt):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = xt.device_mesh
        bp = logical_placements(("batch", None, None), xt.shape,
                                device_mesh=mesh)
        scatter = _local_map(scatter, ([Replicate()] * mesh.ndim, bp),
                             (bp,) * 5, mesh)
        combine = _local_map(combine, (bp,) * 5, bp, mesh)
        # the experts' products on each (group, expert, f) shard of hh,
        # placed by its act_mlp site: f is split where the experts are
        # not (fewer experts than the model axis), wo's product then a
        # Partial sum; the weights are gathered over the FSDP axis.
        # DTensor's einsum would view the permuted shards of these
        # products as if they were dense, and its reshape of the
        # Partial result leaves a shard that fake tensors cannot gather
        hp = logical_placements(("batch", "act_experts", None, "act_mlp"),
                                (groups, E, cap, p["wi"].shape[-1]),
                                device_mesh=mesh)

        def on(dims):  # hh's placements on an operand (hh dim -> its dim)
            return [Shard(dims[pl.dim]) if isinstance(pl, Shard)
                    and pl.dim in dims else Replicate() for pl in hp]
        ep = on({0: 0, 1: 1})
        wp, wop = on({1: 0, 3: 2}), on({1: 0, 3: 1})
        op = [Partial() if isinstance(pl, Shard) and pl.dim == 3 else q
              for pl, q in zip(hp, ep)]
        experts = _local_map(experts, [ep, wp, wp, wop], op, mesh)
    st, sg, slot, keep, buf = scatter(p["router"], xt)
    buf = logical(buf, ("batch", "act_experts", None, None))
    yy = experts(buf, p["wi"], p["wg"], p["wo"])   # (groups, E * cap, e)
    return seq_sharded(combine(yy, st, sg, slot, keep).reshape(b, s, e))


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
    new_state).  The taps are summed left to right in seq's dtype.  On
    DTensors the conv runs on every batch shard with its sequence and
    channels whole (``local_map``; DTensor's padding of a sharded tensor
    fails in some torch releases)."""
    if is_dtensor(seq):
        from torch.distributed.tensor import Replicate
        mesh = seq.device_mesh
        bp = logical_placements(("batch", None, None), seq.shape,
                                device_mesh=mesh)
        args, pl = (seq, w), [bp, [Replicate()] * mesh.ndim]
        if state is not None:
            args, pl = args + (state,), pl + [bp]
        out = (bp, bp if w.shape[0] > 1 else None)
        return _local_map(_depthwise_conv, pl, out, mesh)(*args)
    width = w.shape[0]
    if state is None:
        ctx = F.pad(seq, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state.to(seq.dtype), seq], dim=1)
    out = sum(ctx[:, i:i + seq.shape[1], :] * w[i] for i in range(width))
    new_state = ctx[:, -(width - 1):, :] if width > 1 else None
    return out.to(seq.dtype), new_state


def _ssd_sharded(x, dt, A, B, C, *, chunk: int):
    """The SSD kernel on every rank's shard: x, dt and A placed by the
    ``ssm_heads`` axis and the batch, B and C by the batch (every head
    shares them, so their gradients are partial sums over the heads'
    axis)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    mesh = x.device_mesh
    pl = [logical_placements(axes, t.shape, device_mesh=mesh)
          for axes, t in ((("batch", None, "ssm_heads", None), x),
                          (("batch", None, "ssm_heads"), dt),
                          (("ssm_heads",), A),
                          (("batch", None, None), B),
                          (("batch", None, None), C))]

    def local(x, dt, A, B, C):
        return ssd_ops.ssd(x, dt, A, B, C, chunk=chunk)

    return _local_map(local, pl, pl[0], mesh)(x, dt, A, B, C)


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
    x = seq_gathered(x)
    inner = cfg.ssm_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    hp = cfg.ssm_head_dim
    z = project("ble,ed->bld", x, p["z_proj"])
    xin = project("ble,ed->bld", x, p["x_proj"])
    bc = project("ble,ed->bld", x, p["bc_proj"])
    dt = project("ble,eh->blh", x, p["dt_proj"])
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
    if cache is None and is_dtensor(xh):
        y = _ssd_sharded(xh, dt, A, Bc, Cc, chunk=min(cfg.ssm_chunk, l))
    elif cache is None:
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
    out = project("bld,de->ble", y, p["out_proj"]).to(x.dtype)
    return seq_sharded(out), cache
