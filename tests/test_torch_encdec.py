"""The port's encdec family (whisper-small) against the reference package.

Weights, tokens and frames are made with numpy from a seed and handed to
both packages (``params_from_numpy`` carries the tree across), float32
and reduced size (d_model 64, 2 + 2 layers, 32 encoder frames of 32).
The port runs ``attn_impl="hopper"`` (on CPU tensors the kernel
wrapper's plain version: the encoder and cross-attention are
non-causal), the reference ``"xla_flash"`` or ``"pallas"`` (interpret
mode).  Tolerances are those of ``tests/test_torch_models.py``: 1e-5
for a function, 1e-4 for a model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode as RD
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.serve.decode import ServeEngine as RefServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (count_params, decode_step, init_cache,
                                logits_fn, params_spec, prefill)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import spec_leaves
from repro_torch.serve import ServeEngine
from test_torch_models import (ATOL, MODEL_ATOL, _batches, _both, _close,
                               _extras, _tokens, _x)

NAME = "whisper_small"


def _hopper(impl="xla_flash"):
    return _both(NAME, impl, port_impl="hopper")


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _inputs(cfg, s=40, b=2):
    """Tokens and frames (numpy), and both packages' batches."""
    toks = _tokens(cfg, b=b, s=s)
    extras = _extras(cfg, b=b)
    return toks, extras, *_batches(toks, extras)


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_full_parameter_count():
    cfg = get_config("whisper-small")
    n = count_params(params_spec(cfg))
    assert n == RP.count_params(RT.params_spec(ref_get_config(NAME)))
    assert cfg.family == "encdec" and cfg.encoder_layers == 12


def test_params_spec_matches_the_reference():
    ref_cfg, _, cfg, _ = _both(NAME)
    want = jax.tree.flatten_with_path(RT.params_spec(ref_cfg),
                                      is_leaf=RP.is_spec)[0]
    got = {"/".join(path): p for path, p in spec_leaves(params_spec(cfg))}
    assert len(got) == len(want)
    for path, p in want:
        g = got["/".join(k.key for k in path)]
        assert (tuple(g.shape), g.axes, g.init, g.dtype) == (
            tuple(p.shape), tuple(p.axes), p.init, p.dtype)
    assert {"encoder", "enc_final_norm", "frontend_proj"} <= {
        k.split("/")[0] for k in got}
    assert "layers/ln3" in got and "layers/xattn/q" in got


def test_init_cache_matches_the_reference():
    ref_cfg, _, cfg, _ = _both(NAME)
    want = RD.init_cache(ref_cfg, 2, 24)
    got = init_cache(cfg, 2, 24, device="cpu")
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert not got[key].any()


# ---------------------------------------------------------------------------
# blocks and stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 1])
def test_cross_attention_block(s):
    """Non-causal over every encoder position, q not roped; s = 1 is
    the decode step's shape."""
    ref_cfg, rp, cfg, tp = _hopper()
    rl = _layer(rp["layers"])["xattn"]
    tl = TT.layer_params(tp["layers"], 0)["xattn"]
    xj, xt = _x((2, s, cfg.d_model), seed=31)
    kj, kt = _x((2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim),
                seed=32)
    vj, vt = _x((2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim),
                seed=33)
    pos = np.arange(7, 7 + s)
    got, gkv = TL.attn_block(cfg, tl, xt, positions=torch.from_numpy(pos),
                             cross_kv=(kt, vt))
    want, wkv = RL.attn_block(ref_cfg, rl, xj, positions=jnp.asarray(pos),
                              cross_kv=(kj, vj))
    assert gkv is None and wkv is None
    _close(got, want)


def test_encoder_stack():
    ref_cfg, rp, cfg, tp = _hopper()
    xj, xt = _x((2, cfg.encoder_seq, cfg.d_model), seed=34)
    _close(TT._stack_encoder(cfg, tp["encoder"], xt),
           RT._stack_encoder(ref_cfg, rp["encoder"], xj), atol=MODEL_ATOL)


def test_decoder_stack():
    ref_cfg, rp, cfg, tp = _hopper()
    xj, xt = _x((2, 24, cfg.d_model), seed=35)
    ej, et = _x((2, cfg.encoder_seq, cfg.d_model), seed=36)
    pos = np.arange(24)
    got = TT._stack_encdec_decoder(cfg, tp["layers"], xt,
                                   torch.from_numpy(pos), et)
    want = RT._stack_encdec_decoder(ref_cfg, rp["layers"], xj,
                                    jnp.asarray(pos), ej)
    _close(got, want, atol=MODEL_ATOL)


def test_encode_is_the_references_encoder_output():
    ref_cfg, rp, cfg, tp = _hopper()
    _, extras, _, tb = _inputs(cfg)
    fr = jnp.asarray(extras["frames"])
    enc_in = jnp.einsum("btf,fe->bte", fr, rp["frontend_proj"])
    want = RL.rms_norm(RT._stack_encoder(ref_cfg, rp["encoder"], enc_in),
                       rp["enc_final_norm"], ref_cfg.norm_eps)
    _close(TT.encode(cfg, tp, tb["frames"]), want, atol=MODEL_ATOL,
           rtol=ATOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
def test_logits_fn(impl):
    ref_cfg, rp, cfg, tp = _hopper(impl)
    _, _, rb, tb = _inputs(cfg, s=300)
    want = RT.logits_fn(ref_cfg, rp, rb)
    got = logits_fn(cfg, tp, tb)
    assert got.shape == (2, 300, cfg.vocab_size)
    _close(got, want, atol=MODEL_ATOL)


def test_encdec_prefill_leaves_the_self_attention_cache_unfilled_as_in_the_reference():
    """A limitation of the reference the port keeps: prefill fills the
    cross-attention k / v (every layer's projection of the encoder
    output) and leaves the self-attention cache as ``init_cache`` made
    it, so decode steps attend over zero keys at the prompt positions."""
    ref_cfg, rp, cfg, tp = _hopper("pallas")
    _, _, rb, tb = _inputs(cfg)
    rlog, rcache = RD.prefill(ref_cfg, rp, rb, max_seq=48)
    tlog, tcache = prefill(cfg, tp, tb, max_seq=48)
    _close(tlog, rlog, atol=MODEL_ATOL)
    # the last position of one full forward: the same function
    _close(tlog[:, 0], logits_fn(cfg, tp, tb)[:, -1], atol=MODEL_ATOL)
    assert set(tcache) == set(rcache) == {"k", "v", "xk", "xv"}
    for key in ("xk", "xv"):
        assert tcache[key].shape == rcache[key].shape
        assert tcache[key].abs().max() > 0.1
        _close(tcache[key], rcache[key], atol=MODEL_ATOL)
    for key in ("k", "v"):
        assert tcache[key].shape == rcache[key].shape == (
            cfg.num_layers, 2, 48, cfg.num_kv_heads, cfg.head_dim)
        assert not tcache[key].any() and not np.asarray(rcache[key]).any()


def test_decode_step():
    """Self-attention on the cache in place, cross-attention on xk / xv
    (read, never written), the ln3 MLP; two steps against the
    reference's."""
    ref_cfg, rp, cfg, tp = _hopper("pallas")
    _, _, rb, tb = _inputs(cfg)
    _, rcache = RD.prefill(ref_cfg, rp, rb, max_seq=48)
    _, tcache = prefill(cfg, tp, tb, max_seq=48)
    xk_before = tcache["xk"].clone()
    nxt = np.array([[3], [7]])
    for pos in (40, 41):
        rlog, rcache = RD.decode_step(ref_cfg, rp, rcache, jnp.asarray(nxt),
                                      jnp.int32(pos))
        k_before = tcache["k"]
        tlog, tcache = decode_step(cfg, tp, tcache, torch.from_numpy(nxt),
                                   pos)
        assert tcache["k"] is k_before  # written in place
        _close(tlog, rlog, atol=MODEL_ATOL)
        for key in ("k", "v", "xk", "xv"):
            _close(tcache[key], rcache[key], atol=MODEL_ATOL)
        assert tcache["k"][:, :, pos].abs().max() > 0
        nxt = nxt + 1
    assert torch.equal(tcache["xk"], xk_before)


@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
def test_serve_engine_generates_the_reference_tokens(impl):
    ref_cfg, rp, cfg, tp = _hopper(impl)
    toks, extras, _, _ = _inputs(cfg)
    want = RefServeEngine(ref_cfg, rp, max_seq=48, batch=2).generate(
        toks, max_new_tokens=8, extras=extras)
    n0 = fa_ops.launch_count
    got = ServeEngine(cfg, tp, max_seq=48, batch=2, device="cpu").generate(
        toks, max_new_tokens=8, extras=extras)
    assert fa_ops.launch_count == n0   # CPU tensors: the plain version
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_serve_engine_needs_the_frames():
    """As the reference: an encdec prompt without ``frames`` cannot be
    encoded."""
    _, _, cfg, tp = _hopper()
    toks = _tokens(cfg, s=8)
    with pytest.raises(KeyError, match="frames"):
        ServeEngine(cfg, tp, max_seq=12, batch=2, device="cpu").generate(
            toks, max_new_tokens=2)
