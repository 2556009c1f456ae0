"""The port's dense-family model stack against the reference package.

Every test makes its weights and tokens with numpy from a seed and hands
the same values to both packages (``params_from_numpy`` carries the
tree across), at float32 and reduced size, for four dense
configurations: yi-6b (GQA), minitron-4b, gemma2-27b (window 16 on
alternate layers, attention and final soft-caps, tanh gelu) and
gemma3-27b (5 local : 1 global).  The weights use one layer's fan-in, so
that every block moves the residual stream and the attention shows in
the logits.  Tolerances are stated per test; float32 throughout.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCHS
from repro.models import config as RC
from repro.models import decode as RD
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.serve.decode import ServeEngine as RefServeEngine
from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (count_params, decode_step, init_cache,
                                init_params, logits_fn, params_from_numpy,
                                params_spec, prefill, reduced)
from repro_torch.models import layers as TL
from repro_torch.models.params import spec_leaves
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine

DENSE = ("yi_6b", "minitron_4b", "gemma2_27b", "gemma3_27b")
SSM = ("mamba2_2p7b", "zamba2_1p2b")    # tests/test_torch_ssm.py
OTHERS = tuple(a for a in ARCHS if a not in DENSE + SSM)
ATOL = RTOL = 1e-5     # one layer / one function, float32
MODEL_ATOL = 1e-4      # whole model (logits of order 10), float32


def _cfgs(name, impl="xla_flash"):
    ref = RC.reduced(ref_get_config(name), dtype="float32", attn_impl=impl)
    return ref, compat.model_config(ref)


def _numpy_params(ref_cfg, seed=0):
    """A numpy tree shaped by the reference's ``params_spec``."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(RT.params_spec(ref_cfg),
                                       is_leaf=RP.is_spec)
    out = []
    for p in leaves:
        shape = tuple(int(s) for s in p.shape)
        if p.init == "zeros":   # norms: random too, so the scale is tested
            a = 0.1 * rng.standard_normal(shape)
        elif p.init == "embed":
            a = rng.standard_normal(shape)
        else:
            per_layer = [s for s, ax in zip(shape, p.axes) if ax != "layers"]
            a = rng.standard_normal(shape) / math.sqrt(
                math.prod(per_layer[:-1]))
        out.append(a.astype(np.float32))
    return jax.tree.unflatten(treedef, out)


def _both(name, impl="xla_flash", seed=0):
    ref_cfg, cfg = _cfgs(name, impl)
    tree = _numpy_params(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree),
            cfg, params_from_numpy(tree, cfg, device="cpu"))


def _tokens(cfg, b=2, s=40, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(b, s))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _x(shape, seed=3):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    """Field for field, but for the default attention: the reference's
    is its plain path, the port's its kernel."""
    ref = ref_get_config(name)
    port = get_config(name)
    assert ref.attn_impl == "xla_flash" and port.attn_impl == "hopper"
    assert port == dataclasses.replace(compat.model_config(ref),
                                       attn_impl="hopper")
    assert reduced(port, attn_impl="xla_flash") == compat.model_config(
        RC.reduced(ref))
    assert get_config(ref.name) == port   # the alias


def test_attn_impl_translates_and_nothing_else_passes():
    ref = RC.reduced(ref_get_config("yi_6b"), attn_impl="pallas")
    assert compat.model_config(ref).attn_impl == "hopper"
    with pytest.raises(ValueError, match="attn_impl"):
        reduced(get_config("yi_6b"), attn_impl="pallas")


def test_full_yi_6b_parameter_count():
    cfg = get_config("yi-6b")
    n = count_params(params_spec(cfg))
    assert n == RP.count_params(RT.params_spec(ref_get_config("yi-6b")))
    assert n == 6_061_035_520


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm():
    xj, xt = _x((2, 5, 64))
    wj, wt = _x((64,), seed=4)
    _close(TL.rms_norm(xt, wt, 1e-6), RL.rms_norm(xj, wj, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(theta):
    xj, xt = _x((2, 40, 4, 16))
    pos = np.arange(40)
    _close(TL.rope(xt, torch.from_numpy(pos), theta),
           RL.rope(xj, jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_activation(kind):
    xj, xt = _x((3, 7, 11))
    _close(TL.activation(xt, kind), RL.activation(xj, kind))


ATTN_CASES = [  # (causal, window, cap)
    (True, 0, 0.0), (True, 16, 0.0), (True, 16, 50.0), (False, 0, 0.0)]


@pytest.mark.parametrize("causal,window,cap", ATTN_CASES)
@pytest.mark.parametrize("fn", ["quadratic", "xla_flash"])
def test_attention_functions(fn, causal, window, cap):
    qj, qt = _x((2, 40, 4, 16), seed=5)
    kj, kt = _x((2, 40, 2, 16), seed=6)
    vj, vt = _x((2, 40, 2, 16), seed=7)
    pos = np.arange(40)
    pj, pt = jnp.asarray(pos), torch.from_numpy(pos)
    kw = dict(causal=causal, window=window, cap=cap)
    if fn == "quadratic":
        got = TL.attention_quadratic(qt, kt, vt, q_pos=pt, k_pos=pt, **kw)
        want = RL.attention_quadratic(qj, kj, vj, q_pos=pj, k_pos=pj, **kw)
    else:  # blocks of 16 over 40 queries: a ragged last chunk
        got = TL.attention_xla_flash(qt, kt, vt, q_pos=pt, k_pos=pt,
                                     block=16, **kw)
        want = RL.attention_xla_flash(qj, kj, vj, q_pos=pj, k_pos=pj,
                                      block=16, **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 16])
def test_attention_decode(window):
    qj, qt = _x((2, 1, 4, 16), seed=8)
    kj, kt = _x((2, 48, 2, 16), seed=9)
    vj, vt = _x((2, 48, 2, 16), seed=10)
    pos = np.array([30, 41])
    got = TL.attention_decode(qt, kt, vt, pos=torch.from_numpy(pos),
                              window=window, cap=30.0)
    want = RL.attention_decode(qj, kj, vj, pos=jnp.asarray(pos),
                               window=window, cap=30.0)
    _close(got, want)


@pytest.mark.parametrize("impl", ["pallas", "xla_flash", "quadratic"])
def test_attention_dispatch(impl):
    """``attention`` through each implementation; "pallas" (the Pallas
    kernel in interpret mode) against the port's "hopper" (on CPU tensors
    the wrapper's plain version)."""
    ref_cfg, cfg = _cfgs("gemma2_27b", impl)
    qj, qt = _x((2, 40, 4, 16), seed=11)
    kj, kt = _x((2, 40, 2, 16), seed=12)
    vj, vt = _x((2, 40, 2, 16), seed=13)
    pos = np.arange(40)
    got = TL.attention(cfg, qt, kt, vt, q_pos=torch.from_numpy(pos),
                       k_pos=torch.from_numpy(pos), window=16, cap=50.0)
    want = RL.attention(ref_cfg, qj, kj, vj, q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos), window=16, cap=50.0)
    _close(got, want)


@pytest.mark.parametrize("name", DENSE)
def test_attn_block_and_mlp_block(name):
    ref_cfg, rp, cfg, tp = _both(name)
    rl = jax.tree.map(lambda a: a[0], rp["layers"])
    tl = TT.layer_params(tp["layers"], 0)
    xj, xt = _x((2, 40, cfg.d_model), seed=14)
    pos = np.arange(40)
    window = cfg.window_size
    got, (gk, gv) = TL.attn_block(cfg, tl["attn"], xt,
                                  positions=torch.from_numpy(pos),
                                  window=window)
    want, (wk, wv) = RL.attn_block(ref_cfg, rl["attn"], xj,
                                   positions=jnp.asarray(pos), window=window)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    _close(TL.mlp_block(cfg, tl["mlp"], xt),
           RL.mlp_block(ref_cfg, rl["mlp"], xj))


# ---------------------------------------------------------------------------
# the model: logits, prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
@pytest.mark.parametrize("name", DENSE)
def test_logits_fn(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl)
    toks = _tokens(cfg, s=300)  # > 256: xla_flash runs chunked
    want = RT.logits_fn(ref_cfg, rp, {"tokens": jnp.asarray(toks)})
    got = logits_fn(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 300, cfg.vocab_size)
    _close(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_step(name):
    ref_cfg, rp, cfg, tp = _both(name, "pallas")
    toks = _tokens(cfg, s=40)
    rlog, rcache = RD.prefill(ref_cfg, rp, {"tokens": jnp.asarray(toks)},
                              max_seq=48)
    tlog, tcache = prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                           max_seq=48)
    _close(tlog, rlog, atol=MODEL_ATOL)
    assert set(tcache) == {"k", "v"}
    for key in ("k", "v"):
        assert tcache[key].shape == rcache[key].shape
        _close(tcache[key], rcache[key], atol=MODEL_ATOL)
        assert not tcache[key][:, :, 40:].any()  # zero beyond the prompt
    nxt = np.array([[3], [7]])
    for pos in (40, 41):
        rlog, rcache = RD.decode_step(ref_cfg, rp, rcache, jnp.asarray(nxt),
                                      jnp.int32(pos))
        k_before = tcache["k"]
        tlog, tcache = decode_step(cfg, tp, tcache, torch.from_numpy(nxt),
                                   pos)
        assert tcache["k"] is k_before  # written in place
        _close(tlog, rlog, atol=MODEL_ATOL)
        for key in ("k", "v"):
            _close(tcache[key], rcache[key], atol=MODEL_ATOL)
        nxt = nxt + 1


@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
@pytest.mark.parametrize("name", DENSE)
def test_serve_engine_generates_the_reference_tokens(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl)
    toks = _tokens(cfg, s=40)
    want = RefServeEngine(ref_cfg, rp, max_seq=48, batch=2).generate(
        toks, max_new_tokens=8)
    n0 = fa_ops.launch_count
    got = ServeEngine(cfg, tp, max_seq=48, batch=2, device="cpu").generate(
        toks, max_new_tokens=8)
    assert fa_ops.launch_count == n0   # CPU tensors: the plain version
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_generated_tokens_match_the_full_forward():
    """Greedy decode over the cache agrees with the argmax of one full
    forward pass over prompt + generated tokens (quadratic oracle)."""
    _, _, cfg, tp = _both("gemma2_27b", "xla_flash")
    toks = _tokens(cfg, s=30)
    gen = ServeEngine(cfg, tp, max_seq=40, batch=2, device="cpu").generate(
        toks, max_new_tokens=6)
    seq = torch.from_numpy(np.concatenate([toks, gen[:, :-1]], axis=1))
    full = logits_fn(reduced(get_config("gemma2_27b"), dtype="float32",
                             attn_impl="quadratic"), tp, {"tokens": seq})
    np.testing.assert_array_equal(full[:, 29:].argmax(-1).numpy(), gen)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_numpy_checks_the_tree():
    ref_cfg, cfg = _cfgs("yi_6b")
    tree = _numpy_params(ref_cfg)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["q"] = bad["layers"]["attn"]["q"][:1]
    with pytest.raises(ValueError, match="layers/attn/q"):
        params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    del bad["unembed"]
    with pytest.raises(KeyError, match="unembed"):
        params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a.astype(np.float64), tree)
    with pytest.raises(ValueError, match="float64"):
        params_from_numpy(bad, cfg, device="cpu")


def test_params_from_numpy_carries_bfloat16():
    ref_cfg = RC.reduced(ref_get_config("yi_6b"))   # the config's bfloat16
    params = RP.tree_init(RT.params_spec(ref_cfg), jax.random.PRNGKey(0),
                          ref_cfg.dtype)
    tree = jax.tree.map(np.asarray, params)
    port = params_from_numpy(tree, compat.model_config(ref_cfg),
                             device="cpu")
    q = port["layers"]["attn"]["q"]
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        q.float().numpy(), np.asarray(params["layers"]["attn"]["q"],
                                      np.float32))
    assert port["layers"]["ln1"].dtype == torch.float32


def test_init_params_is_seeded_and_follows_the_spec():
    cfg = reduced(get_config("yi_6b"), dtype="float32")
    a = init_params(cfg, seed=0, device="cpu")
    b = init_params(cfg, seed=0, device="cpu")
    c = init_params(cfg, seed=1, device="cpu")
    half = init_params(reduced(get_config("yi_6b")), seed=0, device="cpu")
    for path, p in spec_leaves(params_spec(cfg)):
        ta, tb, tc, th = (_get(t, path) for t in (a, b, c, half))
        assert tuple(ta.shape) == tuple(p.shape)
        assert torch.equal(ta, tb)
        assert th.dtype == (torch.float32 if p.dtype else torch.bfloat16)
        # the bfloat16 model is the rounding of the float32 one
        assert torch.equal(th, ta.to(th.dtype))
        if p.init == "normal":
            assert not torch.equal(ta, tc)


@pytest.mark.parametrize("name", DENSE + SSM)
def test_init_params_draws_the_reference_scale(name):
    """Leaf by leaf as the reference's ``tree_init``: the same constant
    leaves, and normal draws whose spread is the reference's (the fan-in
    counts the stacked layer axis), to 10% — the two generators differ,
    and one layer's fan-in would be sqrt(L) >= 1.41 times wider."""
    ref_cfg, cfg = _cfgs(name)
    want = jax.tree.map(np.asarray, RP.tree_init(
        RT.params_spec(ref_cfg), jax.random.PRNGKey(0), ref_cfg.dtype))
    got = init_params(cfg, seed=0, device="cpu")
    assert cfg.num_layers >= 2
    stacked = 0
    for path, p in spec_leaves(params_spec(cfg)):
        g, w = _get(got, path).numpy(), _get(want, path)
        assert g.shape == w.shape and g.dtype == w.dtype
        if p.init in ("zeros", "ones"):
            np.testing.assert_array_equal(g, w)
            continue
        assert g.std() / w.std() == pytest.approx(1.0, rel=0.1), path
        stacked += "layers" in p.axes
    assert stacked > 0


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# what this slice does not serve, and the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OTHERS)
def test_other_families_raise(name):
    cfg = reduced(get_config(name), dtype="float32")
    with pytest.raises(NotImplementedError, match="later slice"):
        params_spec(cfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        ServeEngine(cfg, {}, max_seq=8, batch=1, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        prefill(cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})


def test_unported_blocks_raise():
    cfg = reduced(get_config("mixtral_8x22b"), dtype="float32")
    with pytest.raises(NotImplementedError, match="later slice"):
        TL.moe_block(cfg, {}, None)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal cannot be shown")
    cfg = reduced(get_config("yi_6b"), dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA"):
        init_params(cfg, seed=0)           # the default asks for the card
    with pytest.raises(RuntimeError, match="no CUDA"):
        ServeEngine(cfg, {}, max_seq=8, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        init_cache(cfg, 1, 8)
