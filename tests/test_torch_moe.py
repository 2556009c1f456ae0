"""The port's moe family (mixtral-8x22b, grok-1-314b) against the
reference package.

Weights, tokens and activations are made with numpy from a seed and
handed to both packages (``params_from_numpy`` carries the tree across),
float32 and reduced size (d_model 64, 4 experts, 2 a token).  The port
runs ``attn_impl="hopper"`` (on CPU tensors the kernel wrapper's plain
version), the reference ``"xla_flash"`` or ``"pallas"`` (interpret
mode).  The dispatch is held to choose and drop exactly what the
reference does: tied gates, capacity overflow, one token a group.
Tolerances are those of ``tests/test_torch_models.py``: 1e-5 for a
function, 1e-4 for a model.
"""

import dataclasses
import math

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
from repro_torch.models import (count_params, decode_step, logits_fn,
                                params_spec, prefill)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import spec_leaves
from repro_torch.serve import ServeEngine
from test_torch_models import MODEL_ATOL, _both, _close, _tokens, _x

MOE = ("mixtral_8x22b", "grok_1_314b")


def _layer0(rp, tp):
    return (jax.tree.map(lambda a: a[0], rp["layers"]["moe"]),
            TT.layer_params(tp["layers"], 0)["moe"])


def _with_router(rmoe, tmoe, router: np.ndarray):
    """Both layers with ``router`` (E, e) in place of theirs."""
    return ({**rmoe, "router": jnp.asarray(router)},
            {**tmoe, "router": torch.from_numpy(router.copy())})


def _ref_gates(x: np.ndarray, router: np.ndarray) -> np.ndarray:
    lg = jnp.einsum("gte,Ee->gtE", jnp.asarray(x), jnp.asarray(router))
    return np.asarray(jax.nn.softmax(lg, axis=-1))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixtral-8x22b", "grok-1-314b"])
def test_full_parameter_count(name):
    cfg = get_config(name)
    n = count_params(params_spec(cfg))
    assert n == RP.count_params(RT.params_spec(ref_get_config(name)))
    assert cfg.family == "moe" and n > 1e11


@pytest.mark.parametrize("name", MOE)
def test_params_spec_matches_the_reference(name):
    """Every leaf, its shape, axes, init and dtype: the router is
    declared float32 whatever the model's dtype."""
    ref_cfg, _, cfg, _ = _both(name)
    want = jax.tree.flatten_with_path(RT.params_spec(ref_cfg),
                                      is_leaf=RP.is_spec)[0]
    got = {"/".join(path): p for path, p in spec_leaves(params_spec(cfg))}
    assert len(got) == len(want)
    for path, p in want:
        g = got["/".join(k.key for k in path)]
        assert (tuple(g.shape), g.axes, g.init, g.dtype) == (
            tuple(p.shape), tuple(p.axes), p.init, p.dtype)
    assert got["layers/moe/router"].dtype == "float32"


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_moe_block(name):
    ref_cfg, rp, cfg, tp = _both(name)
    rmoe, tmoe = _layer0(rp, tp)
    xj, xt = _x((2, 40, cfg.d_model), seed=21)
    _close(TL.moe_block(cfg, tmoe, xt), RL.moe_block(ref_cfg, rmoe, xj))


def test_top_k_keeps_the_lower_expert_on_ties():
    """Equal gates: the lower expert first, as ``jax.lax.top_k``."""
    gates = np.array([[0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.2, 0.2],
                      [0.25, 0.25, 0.25, 0.25], [0.2, 0.2, 0.3, 0.3]],
                     np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(gates), 2)
    gv, gi = TL.top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), [[1, 2], [0, 1], [0, 1],
                                               [2, 3]])


def test_tied_router_rows_choose_the_reference_experts():
    """Router rows 0 and 2 equal, so their gates tie at every token; at
    the tokens where the tie straddles the second choice the lower
    expert must win, and the two experts' weights differ, so a wrong
    choice moves the output."""
    ref_cfg, rp, cfg, tp = _both("mixtral_8x22b")
    rmoe, tmoe = _layer0(rp, tp)
    router = np.array(rmoe["router"])
    router[2] = router[0]
    rmoe, tmoe = _with_router(rmoe, tmoe, router)
    xj, xt = _x((2, 40, cfg.d_model), seed=22)
    gates = _ref_gates(np.asarray(xj), router)
    assert (gates[..., 0] == gates[..., 2]).all()
    rank = np.argsort(-gates, axis=-1, kind="stable")
    assert ((rank[..., 1] == 0) & (rank[..., 2] == 2)).sum() > 0
    _close(TL.moe_block(cfg, tmoe, xt), RL.moe_block(ref_cfg, rmoe, xj))


def test_capacity_overflow_drops_the_reference_tokens():
    """Every token's first choice is expert 1 (a shared offset in x
    against a router row along it): 40 tokens for cap slots, so the
    later tokens lose that choice, exactly as in the reference."""
    ref_cfg, rp, cfg, tp = _both("mixtral_8x22b")
    rmoe, tmoe = _layer0(rp, tp)
    router = np.array(rmoe["router"])
    router[1] = 0.5
    rmoe, tmoe = _with_router(rmoe, tmoe, router)
    x = np.random.default_rng(23).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32) + 3.0
    gates = _ref_gates(x, router)
    assert (gates.argmax(-1) == 1).all()
    cap = math.ceil(40 * cfg.experts_per_tok / cfg.num_experts
                    * cfg.capacity_factor)
    assert cap < 40          # 40 - cap tokens a group are dropped there
    got = TL.moe_block(cfg, tmoe, torch.from_numpy(x))
    want = RL.moe_block(ref_cfg, rmoe, jnp.asarray(x))
    _close(got, want)
    # the dropped tokens' output is their second expert's share alone:
    # without the drop it would differ
    full = dataclasses.replace(cfg, capacity_factor=cfg.num_experts)
    assert not torch.allclose(TL.moe_block(full, tmoe, torch.from_numpy(x)),
                              got, atol=1e-3)


def test_one_token_a_group_decodes_as_the_reference():
    """The decode step's shape: B groups of one token, cap 1."""
    ref_cfg, rp, cfg, tp = _both("grok_1_314b")
    rmoe, tmoe = _layer0(rp, tp)
    xj, xt = _x((3, 1, cfg.d_model), seed=24)
    _close(TL.moe_block(cfg, tmoe, xt), RL.moe_block(ref_cfg, rmoe, xj))


def test_more_than_two_experts_a_token_raise():
    """The combine sums k terms in the model dtype; only k <= 2 sums the
    same bits in any order."""
    _, rp, cfg, tp = _both("mixtral_8x22b")
    _, tmoe = _layer0(rp, tp)
    cfg = dataclasses.replace(cfg, experts_per_tok=3)
    with pytest.raises(ValueError, match="experts_per_tok 3"):
        TL.moe_block(cfg, tmoe, torch.zeros((1, 4, cfg.d_model)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla_flash"])
@pytest.mark.parametrize("name", MOE)
def test_logits_fn(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl, port_impl="hopper")
    toks = _tokens(cfg, s=300)
    want = RT.logits_fn(ref_cfg, rp, {"tokens": jnp.asarray(toks)})
    got = logits_fn(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 300, cfg.vocab_size)
    _close(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_step(name):
    ref_cfg, rp, cfg, tp = _both(name, "pallas", port_impl="hopper")
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
@pytest.mark.parametrize("name", MOE)
def test_serve_engine_generates_the_reference_tokens(name, impl):
    ref_cfg, rp, cfg, tp = _both(name, impl, port_impl="hopper")
    toks = _tokens(cfg, s=40)
    want = RefServeEngine(ref_cfg, rp, max_seq=48, batch=2).generate(
        toks, max_new_tokens=8)
    n0 = fa_ops.launch_count
    got = ServeEngine(cfg, tp, max_seq=48, batch=2, device="cpu").generate(
        toks, max_new_tokens=8)
    assert fa_ops.launch_count == n0   # CPU tensors: the plain version
    np.testing.assert_array_equal(got, want)


def test_capacity_makes_a_token_depend_on_its_neighbours():
    """By design, not a fault: the same token's moe output changes with
    the sequence it is dispatched in (cap is per sequence), so a decode
    step is not one row of a longer forward; the reference's too."""
    ref_cfg, rp, cfg, tp = _both("mixtral_8x22b")
    rmoe, tmoe = _layer0(rp, tp)
    router = np.array(rmoe["router"])
    router[1] = 0.5
    rmoe, tmoe = _with_router(rmoe, tmoe, router)
    x = np.random.default_rng(25).standard_normal(
        (1, 40, cfg.d_model)).astype(np.float32) + 3.0
    whole = TL.moe_block(cfg, tmoe, torch.from_numpy(x))[0, -1]
    alone = TL.moe_block(cfg, tmoe, torch.from_numpy(x[:, -1:]))[0, 0]
    want_whole = RL.moe_block(ref_cfg, rmoe, jnp.asarray(x))[0, -1]
    want_alone = RL.moe_block(ref_cfg, rmoe, jnp.asarray(x[:, -1:]))[0, 0]
    _close(whole, want_whole)
    _close(alone, want_alone)
    assert not torch.allclose(whole, alone, atol=1e-3)
