"""The port's ssm (mamba2) and hybrid (zamba2) model stacks against the
reference package.

Weights and tokens are made with numpy from a seed and handed to both
packages (``params_from_numpy`` carries the tree across), float32 and
reduced size (d_model 64, 8 SSD heads of 16, state 16, chunk 8; zamba2's
shared block every 2nd layer).  The port's full-sequence SSD goes
through the kernel's wrapper, which on CPU tensors runs the sequential
recurrence, while the reference's model path runs its chunked
``ssd_reference``: the two differ in the order of sums only.  Tolerances
are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import decode as RD
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.serve.decode import ServeEngine as RefServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import (count_params, decode_step, init_cache,
                                logits_fn, params_spec, prefill)
from repro_torch.models import layers as TL
from repro_torch.models.params import DTYPES, P, spec_leaves
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine
from test_torch_models import _both, _close, _tokens, _x

FAMILIES = ("mamba2_2p7b", "zamba2_1p2b")
ATOL = RTOL = 1e-5     # one function, float32
MODEL_ATOL = 1e-4      # whole model (logits of order 10), float32


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _ssd_inputs(b=2, l=32, h=3, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.array(jax.nn.softplus(
        rng.standard_normal((b, l, h), dtype=np.float32)))
    A = -np.exp(0.5 * rng.standard_normal(h, dtype=np.float32))
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    return x, dt, A, B, C


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b"])
def test_full_parameter_count(name):
    cfg = get_config(name)
    n = count_params(params_spec(cfg))
    assert n == RP.count_params(RT.params_spec(ref_get_config(name)))
    assert cfg.family in ("ssm", "hybrid") and n > 1e9


@pytest.mark.parametrize("name", FAMILIES)
def test_params_spec_matches_the_reference(name):
    ref_cfg, _, cfg, _ = _both(name)
    want = jax.tree.flatten_with_path(RT.params_spec(ref_cfg),
                                      is_leaf=RP.is_spec)[0]
    got = {"/".join(path): p for path, p in spec_leaves(params_spec(cfg))}
    assert len(got) == len(want)
    for path, p in want:
        key = "/".join(k.key for k in path)
        assert tuple(got[key].shape) == tuple(p.shape), key
        assert (got[key].init, got[key].dtype) == (p.init, p.dtype), key


@pytest.mark.parametrize("name", FAMILIES)
def test_init_cache_matches_the_reference(name):
    ref_cfg, _, cfg, _ = _both(name)
    want = RD.init_cache(ref_cfg, 2, 24)
    got = init_cache(cfg, 2, 24, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


# ---------------------------------------------------------------------------
# SSD and the mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_reference(chunk):
    x, dt, A, B, C = _ssd_inputs()
    wy, ws = RL.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C)),
                              chunk=chunk)
    gy, gs = TL.ssd_reference(*map(torch.from_numpy, (x, dt, A, B, C)),
                              chunk=chunk)
    assert gs.dtype == torch.float32 and gs.shape == ws.shape
    _close(gy, wy)
    _close(gs, ws)


def test_ssd_reference_refuses_a_ragged_chunk():
    x, dt, A, B, C = _ssd_inputs(l=20)
    with pytest.raises(ValueError, match="not a multiple"):
        TL.ssd_reference(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=8)


def test_ssd_wrapper_agrees_with_the_chunked_reference():
    """What the port's model path runs (the kernel's wrapper) against
    what the reference's runs (``ssd_reference``)."""
    x, dt, A, B, C = _ssd_inputs(l=40)
    want, _ = RL.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C)),
                               chunk=8)
    got = ssd_ops.ssd(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=8)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_step(dtype):
    x, dt, A, B, C = _ssd_inputs()
    rng = np.random.default_rng(4)
    state = rng.standard_normal((2, 3, 8, 16), dtype=np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x[:, 0], B[:, 0], C[:, 0]))
    wy, ws = RL.ssd_step(jx, jnp.asarray(dt[:, 0]), jnp.asarray(A), jB, jC,
                         jnp.asarray(state))
    tx, tB, tC = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (jx, jB, jC))
    gy, gs = TL.ssd_step(tx, torch.from_numpy(dt[:, 0]),
                         torch.from_numpy(A), tB, tC,
                         torch.from_numpy(state))
    assert gy.dtype == tdt and gs.dtype == torch.float32
    tol = 2e-2 if dtype == "bfloat16" else ATOL
    _close(gy.float(), wy, atol=tol, rtol=tol)
    _close(gs, ws)


@pytest.mark.parametrize("with_state", [False, True])
def test_depthwise_conv(with_state):
    sj, st = _x((2, 7, 12), seed=5)
    wj, wt = _x((4, 12), seed=6)
    cj, ct = _x((2, 3, 12), seed=7) if with_state else (None, None)
    wo, ws = RL._depthwise_conv(sj, wj, cj)
    go, gs = TL._depthwise_conv(st, wt, ct)
    _close(go, wo)
    _close(gs, ws)


def test_depthwise_conv_sums_left_to_right_in_the_sequence_dtype():
    """bfloat16: each tap's product rounded, then added tap after tap in
    bfloat16 (the reference's Python ``sum``), with the carried context
    cast to the sequence's dtype first."""
    _, st = _x((2, 5, 8), seed=8)
    _, wt = _x((4, 8), seed=9)
    _, ct = _x((2, 3, 8), seed=10)
    seq, w = st.to(torch.bfloat16), wt.to(torch.bfloat16)
    out, new = TL._depthwise_conv(seq, w, ct)       # float32 context
    ctx = torch.cat([ct.to(torch.bfloat16), seq], dim=1)
    want = ctx[:, 0:5] * w[0]
    for i in range(1, 4):
        want = want + ctx[:, i:i + 5] * w[i]
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
    assert torch.equal(new, ctx[:, -3:])
    ref, _ = RL._depthwise_conv(jnp.asarray(np.array(seq.float()),
                                            jnp.bfloat16),
                                jnp.asarray(np.array(w.float()),
                                            jnp.bfloat16),
                                jnp.asarray(ct.numpy()))
    _close(out.float(), ref, atol=3e-2, rtol=1e-2)   # bfloat16 roundings


def test_dt_plus_bias_promotes_bfloat16_to_float32():
    """``softplus(dt + dt_bias)``: a bfloat16 projection plus a float32
    bias is float32 in both frameworks (an ulp of bfloat16 in dt would
    otherwise move every decay)."""
    _, dt_ = _x((2, 5, 4), seed=11)
    bj, bt = _x((4,), seed=12)
    d16 = dt_.to(torch.bfloat16)
    got = d16 + bt
    want = jnp.asarray(np.array(d16.float()), jnp.bfloat16) + bj
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, atol=0, rtol=0)


def test_softplus_matches_jax_across_its_threshold():
    """``F.softplus`` returns x itself above its threshold of 20, where
    ``jax.nn.softplus`` computes log(1 + e^x): equal in float32, and in
    the far negative tail too."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [19.99, 20.0, 20.01, 30.0, -30.0]]).astype(
                            np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-37)


@pytest.mark.parametrize("name", FAMILIES)
def test_mamba_block_full_sequence(name):
    ref_cfg, rp, cfg, tp = _both(name)
    xj, xt = _x((2, 40, cfg.d_model), seed=13)
    want, wc = RL.mamba_block(ref_cfg, _layer(rp["layers"]["mamba"]), xj)
    n0 = ssd_ops.launch_count
    got, gc = TL.mamba_block(cfg, TT.layer_params(tp["layers"], 0)["mamba"],
                             xt)
    assert ssd_ops.launch_count == n0      # CPU tensors: the plain version
    assert wc is None and gc is None
    _close(got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_mamba_block_decode_writes_the_cache_in_place(name):
    ref_cfg, rp, cfg, tp = _both(name)
    rng = np.random.default_rng(14)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_inner + 2 * n
    st = rng.standard_normal((2, h, p, n), dtype=np.float32)
    cv = rng.standard_normal((2, cfg.conv_width - 1, conv_dim),
                             dtype=np.float32)
    xj, xt = _x((2, 1, cfg.d_model), seed=15)
    want, wc = RL.mamba_block(ref_cfg, _layer(rp["layers"]["mamba"]), xj,
                              cache={"state": jnp.asarray(st),
                                     "conv": jnp.asarray(cv)})
    cache = {"state": torch.from_numpy(st.copy()),
             "conv": torch.from_numpy(cv.copy())}
    before = dict(cache)
    got, gc = TL.mamba_block(cfg, TT.layer_params(tp["layers"], 0)["mamba"],
                             xt, cache=cache)
    assert gc is cache
    assert all(gc[k] is before[k] for k in before)
    _close(got, want)
    _close(gc["state"], wc["state"])
    _close(gc["conv"], wc["conv"])


def test_hybrid_stack_collects_the_shared_blocks_kv():
    ref_cfg, rp, cfg, tp = _both("zamba2_1p2b")
    xj, xt = _x((2, 24, cfg.d_model), seed=16)
    pos = np.arange(24)
    wx, (wk, wv) = RT._stack_hybrid(ref_cfg, rp["layers"], rp["shared_attn"],
                                    xj, jnp.asarray(pos), collect_kv=True)
    gx, kvs = TT._stack_hybrid(cfg, tp["layers"], tp["shared_attn"], xt,
                               torch.from_numpy(pos), collect_kv=True)
    _close(gx, wx, atol=MODEL_ATOL)
    assert len(kvs) == cfg.num_layers
    for i, (k, v) in enumerate(kvs):
        _close(k, wk[i], atol=MODEL_ATOL)
        _close(v, wv[i], atol=MODEL_ATOL)
        assert bool(k.any()) == TT.is_attn_site(cfg, i)


# ---------------------------------------------------------------------------
# the model: logits, prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
@pytest.mark.parametrize("name", FAMILIES)
def test_logits_fn(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl)
    toks = _tokens(cfg, s=48)
    want = RT.logits_fn(ref_cfg, rp, {"tokens": jnp.asarray(toks)})
    got = logits_fn(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 48, cfg.vocab_size)
    _close(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_returns_an_unfilled_cache(name):
    """As the reference: the last position's logits, and the cache as
    ``init_cache`` made it (the full-sequence pass keeps no states)."""
    ref_cfg, rp, cfg, tp = _both(name, "pallas")
    toks = _tokens(cfg, s=40)
    rlog, rcache = RD.prefill(ref_cfg, rp, {"tokens": jnp.asarray(toks)},
                              max_seq=48)
    tlog, tcache = prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                           max_seq=48)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    _close(tlog, rlog, atol=MODEL_ATOL)
    assert set(tcache) == set(rcache)
    for key in rcache:
        assert tuple(tcache[key].shape) == rcache[key].shape
        assert not tcache[key].any() and not np.asarray(rcache[key]).any()


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_writes_the_caches_in_place(name):
    ref_cfg, rp, cfg, tp = _both(name, "xla_flash")
    rcache = RD.init_cache(ref_cfg, 2, 16)
    tcache = init_cache(cfg, 2, 16, device="cpu")
    before = dict(tcache)
    toks = _tokens(cfg, s=6, seed=17)
    for pos in range(6):
        rlog, rcache = RD.decode_step(ref_cfg, rp, rcache,
                                      jnp.asarray(toks[:, pos:pos + 1]),
                                      jnp.int32(pos))
        tlog, tcache = decode_step(cfg, tp, tcache,
                                   torch.from_numpy(toks[:, pos:pos + 1]),
                                   pos)
        assert all(tcache[k] is before[k] for k in before)
        _close(tlog, rlog, atol=MODEL_ATOL)
        for key in rcache:
            _close(tcache[key], rcache[key], atol=MODEL_ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
@pytest.mark.parametrize("name", FAMILIES)
def test_serve_engine_generates_the_reference_tokens(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl)
    toks = _tokens(cfg, s=24)
    want = RefServeEngine(ref_cfg, rp, max_seq=32, batch=2).generate(
        toks, max_new_tokens=6)
    n0 = ssd_ops.launch_count
    got = ServeEngine(cfg, tp, max_seq=32, batch=2, device="cpu").generate(
        toks, max_new_tokens=6)
    assert ssd_ops.launch_count == n0   # ingest is the recurrence
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_agrees_with_the_recurrent_ingest(name):
    """The last-position logits of ``prefill`` (the full-sequence SSD,
    the kernel's path) and of the token-by-token ingest ``generate`` runs
    (``ssd_step``) agree to 1e-5 of the largest |logit| in float32 — the
    check ``chip_smoke.py`` makes at full width.  Two chunks and a ragged
    one (20 = 2 * 8 + 4 would be refused, so 24 = 3 * 8)."""
    _, _, cfg, tp = _both(name, "xla_flash")
    toks = torch.from_numpy(_tokens(cfg, s=24, seed=18))
    with torch.inference_mode():
        lg, _ = prefill(cfg, tp, {"tokens": toks})
        eng = ServeEngine(cfg, tp, max_seq=24, batch=2, device="cpu")
        last, _ = eng._ingest_recurrent(toks)
    got, want = lg[:, -1].numpy(), last.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bfloat16_model_runs_and_stays_near_float32():
    """The config's own dtype: bfloat16 activations, float32 state and
    SSD arithmetic; logits within 5e-2 of the float32 model's scale."""
    _, _, cfg, tp = _both("mamba2_2p7b", "xla_flash")
    half = dataclasses.replace(cfg, dtype="bfloat16")
    tp16 = _cast(tp, params_spec(half))
    toks = torch.from_numpy(_tokens(cfg, s=16, seed=19))
    lg32 = logits_fn(cfg, tp, {"tokens": toks})
    lg16 = logits_fn(half, tp16, {"tokens": toks})
    assert lg16.dtype == torch.bfloat16
    assert torch.isfinite(lg16.float()).all()
    err = (lg16.float() - lg32).abs().max() / lg32.abs().max()
    assert err < 5e-2


def _cast(tree, spec):
    """``tree`` rounded leaf by leaf to the dtypes ``spec`` declares."""
    out = {}
    for key, node in tree.items():
        if isinstance(spec[key], P):
            out[key] = node.to(DTYPES[spec[key].dtype or "bfloat16"])
        else:
            out[key] = _cast(node, spec[key])
    return out
