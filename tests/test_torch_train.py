"""The port's training path (loss and gradients, AdamW, synthetic data,
the train step, the training loop) against the reference package.

Weights, batches and gradients are made with numpy from a seed and
handed to both packages (``params_from_numpy`` carries a tree across),
float32 and reduced size, on the CPU: the port's kernel wrappers run
their plain versions here and autograd follows them (their backward on
the card is held by ``chip_smoke.py`` phase ``train``).  Tolerances are
stated per test.
"""

import dataclasses
import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCHS
from repro.models import ModelConfig as RefModelConfig
from repro.models import config as RC
from repro.models import params as RP
from repro.models import transformer as RT
from repro.train import data as rdata
from repro.train import optimizer as ropt
from repro.train import step as rstep
from repro_torch import compat
from repro_torch.models import (ModelConfig, ShapeDtype, loss_fn,
                                params_from_numpy)
from repro_torch.models.config import ShapeConfig
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.driver import (JobConfig, StragglerMonitor, train,
                                      train_with_restarts)
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.train.tree import tree_items, tree_map

LOSS_RTOL = 1e-5      # one float32 loss, summation order only
GRAD_TOL = 1e-4       # |g_port - g_ref| <= GRAD_TOL * max|g_ref|, per leaf

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
            head_dim=8, remat="none", loss_chunk=0, dtype="float32")
REF_TINY, PORT_TINY = RefModelConfig(**TINY), ModelConfig(**TINY)
SHAPE = (16, 4)   # (seq_len, global_batch), tests/test_train.py's


def _ref_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def _numpy_params(ref_cfg, seed=0):
    """A numpy tree shaped by the reference's ``params_spec``, every
    block matrix at one layer's fan-in (so every layer moves the
    residual stream and its gradient is not negligible)."""
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


def _np_batch(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _both(name, seed=0, **overrides):
    """(reference cfg, its params, port cfg, its params) holding the same
    values; the port runs its default attention (the kernel wrapper,
    whose plain version runs on CPU tensors)."""
    ref_cfg = RC.reduced(ref_get_config(name), dtype="float32", **overrides)
    cfg = dataclasses.replace(compat.model_config(ref_cfg),
                              attn_impl="hopper")
    tree = _numpy_params(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def _ref_value_and_grad(ref_cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(ref_cfg, p, b)))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_close(port_tree, ref_tree, tol=GRAD_TOL):
    """Every leaf within ``tol`` of that leaf's max |ref|; returns the
    largest such scaled error."""
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    port = {"/".join(p): v.detach().float().numpy()
            for p, v in tree_items(port_tree)}
    assert sorted(port) == sorted(ref)
    worst = 0.0
    for key, want in ref.items():
        got = port[key]
        assert got.shape == want.shape, key
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol * max(scale, 1e-30), (key, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The counterpart of ``tests/test_archs.py``'s train step: loss and
    every gradient leaf against ``jax.value_and_grad(loss_fn)``."""
    ref_cfg, ref_p, cfg, p = _both(arch)
    batch = _np_batch(cfg)
    want_loss, want_g = _ref_value_and_grad(ref_cfg, ref_p, batch)
    loss, grads = value_and_grad(cfg, p, _port_batch(batch))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _leaves_close(grads, want_g)


@pytest.mark.parametrize("arch", ["yi_6b", "gemma2_27b", "mixtral_8x22b"])
def test_chunked_loss_matches_unchunked_and_reference(arch):
    """loss_chunk 8 over 32 positions (four chunks summed left to right)
    against the whole-sequence loss, and against the reference's
    chunked loss."""
    ref_cfg, ref_p, cfg, p = _both(arch, loss_chunk=8)
    batch = _np_batch(cfg)
    chunked, g_chunked = value_and_grad(cfg, p, _port_batch(batch))
    whole, g_whole = value_and_grad(dataclasses.replace(cfg, loss_chunk=0),
                                    p, _port_batch(batch))
    assert abs(float(chunked) - float(whole)) <= LOSS_RTOL * float(whole)
    for (path, a), (_, b) in zip(tree_items(g_chunked), tree_items(g_whole)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, path
    want_loss, want_g = _ref_value_and_grad(ref_cfg, ref_p, batch)
    assert abs(float(chunked) - want_loss) <= LOSS_RTOL * want_loss
    _leaves_close(g_chunked, want_g)


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x22b", "mamba2_2p7b",
                                  "zamba2_1p2b", "whisper_small",
                                  "internvl2_26b"])
def test_remat_full_gives_the_same_gradients_bit_for_bit(arch):
    """Checkpointing recomputes the same CPU operations in the same
    order, so the gradients are the same bits."""
    _, _, cfg, p = _both(arch)
    batch = _port_batch(_np_batch(cfg))
    loss0, g0 = value_and_grad(cfg, p, batch)
    loss1, g1 = value_and_grad(dataclasses.replace(cfg, remat="full"), p,
                               batch)
    assert torch.equal(loss0, loss1)
    for (path, a), (_, b) in zip(tree_items(g0), tree_items(g1)):
        assert torch.equal(a, b), path


def test_remat_policies_are_the_full_checkpoint_and_unknown_ones_raise():
    _, _, cfg, p = _both("yi_6b")
    batch = _port_batch(_np_batch(cfg))
    _, want = value_and_grad(dataclasses.replace(cfg, remat="full"), p,
                             batch)
    for policy in ("names", "dots", "offload_dots"):
        _, got = value_and_grad(dataclasses.replace(cfg, remat=policy), p,
                                batch)
        for (path, a), (_, b) in zip(tree_items(got), tree_items(want)):
            assert torch.equal(a, b), (policy, path)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(dataclasses.replace(cfg, remat="some"), p, batch)


def test_loss_without_mask_is_the_all_ones_mask():
    _, _, cfg, p = _both("yi_6b")
    batch = _port_batch(_np_batch(cfg))
    ones = dict(batch, mask=torch.ones_like(batch["mask"]))
    del batch["mask"]
    with torch.no_grad():
        assert torch.equal(loss_fn(cfg, p, batch), loss_fn(cfg, p, ones))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_trees(seed=0):
    """A parameter tree with float32 and bfloat16 leaves, and three steps
    of gradients, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32),
                    "h": rng.standard_normal((3, 2)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": 3 * rng.standard_normal(7).astype(np.float32),
                    "h": rng.standard_normal((3, 2)).astype(np.float32)}}
             for _ in range(3)]
    return params, grads


def _as_jax(tree, bf16=()):
    return {k: _as_jax(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _as_torch(tree, bf16=()):
    return {k: _as_torch(v, bf16) if isinstance(v, dict) else
            torch.from_numpy(v.copy()).to(
                torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in tree.items()}


OPT_CASES = {
    "plain": dict(clip_norm=0.0),
    "clipped": dict(clip_norm=0.5),
    "compressed": dict(compress_grads=True),
    "bf16_moments": dict(moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_matches_reference(case):
    """Three AdamW steps on the same trees (float32 and bfloat16 leaves).
    float32 values within 1e-6 relative (pow, cos and the global norm's
    sums may differ by an ulp); the bfloat16 leaves and moments within
    one bfloat16 ulp (2**-8 relative), since an ulp of float32 can flip
    their rounding."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **OPT_CASES[case])
    rcfg, tcfg = ropt.OptConfig(**kw), topt.OptConfig(**kw)
    params, grads = _opt_trees()
    rp, tp = _as_jax(params, bf16=("h",)), _as_torch(params, bf16=("h",))
    rs, ts = ropt.init_state(rcfg, rp), topt.init_state(tcfg, tp)
    for g in grads:
        rp, rs, rm = ropt.apply_updates(rcfg, rp, _as_jax(g), rs)
        tp, ts, tm = topt.apply_updates(tcfg, tp, _as_torch(g), ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                       rtol=1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 3
    assert ts["step"].dtype == torch.int32
    bf16_tol = 2.0 ** -8
    for name in ("params", "m", "v", "err"):
        want = rp if name == "params" else rs.get(name)
        got = tp if name == "params" else ts.get(name)
        if want is None:
            assert got is None
            continue
        for path, t in tree_items(got):
            w = want
            for k in path:
                w = w[k]
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype)
            w = np.asarray(w, np.float32)
            low = t.dtype == torch.bfloat16
            np.testing.assert_allclose(
                t.float().numpy(), w, rtol=bf16_tol if low else 1e-6,
                atol=(bf16_tol if low else 1e-6) * np.abs(w).max(),
                err_msg=f"{case} {name} {path}")


def test_int8_compression_codes_equal_exactly():
    """Same float32 inputs, same elementwise IEEE operations: the
    dequantised gradient and the residual are the same bits, and so are
    the int8 codes behind them."""
    rng = np.random.default_rng(4)
    for shape in ((64,), (8, 33)):
        g = rng.standard_normal(shape).astype(np.float32)
        err = (0.01 * rng.standard_normal(shape)).astype(np.float32)
        rd, rr = ropt._compress_int8(jnp.asarray(g), jnp.asarray(err))
        td, tr = topt._compress_int8(torch.from_numpy(g),
                                     torch.from_numpy(err))
        assert np.array_equal(td.numpy(), np.asarray(rd))
        assert np.array_equal(tr.numpy(), np.asarray(rr))
        scale = np.float32(np.abs(g + err).max() / np.float32(127.0))
        codes = np.round(td.numpy() / scale)
        assert np.array_equal(codes, np.round(np.asarray(rd) / scale))
        assert np.abs(codes).max() <= 127


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in range(0, 121, 3):
        np.testing.assert_allclose(
            float(topt.schedule_lr(topt.OptConfig(**kw),
                                   torch.tensor(step, dtype=torch.int32))),
            float(ropt.schedule_lr(ropt.OptConfig(**kw), jnp.int32(step))),
            rtol=1e-6, atol=1e-12)


def test_abstract_state_describes_init_state():
    """Shapes and dtypes of the state, as the reference's
    ``abstract_state`` gives them."""
    cfg = dict(moment_dtype="bfloat16", compress_grads=True)
    params = _as_torch(_opt_trees()[0], bf16=("h",))
    state = topt.init_state(topt.OptConfig(**cfg), params)
    ab = topt.abstract_state(topt.OptConfig(**cfg), tree_map(
        lambda t: ShapeDtype(tuple(t.shape), t.dtype), params))
    want = ropt.abstract_state(ropt.OptConfig(**cfg), jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        _as_jax(_opt_trees()[0], bf16=("h",))))
    for name in ("m", "v", "err"):
        for (path, t), (_, a) in zip(tree_items(state[name]),
                                     tree_items(ab[name])):
            assert (tuple(t.shape), t.dtype) == (a.shape, a.dtype), path
            w = want[name]
            for k in path:
                w = w[k]
            assert (a.shape, str(a.dtype).removeprefix("torch.")) == \
                (w.shape, str(w.dtype)), path
    assert (ab["step"].shape, ab["step"].dtype) == ((), torch.int32)
    assert state["step"].dtype == torch.int32


# --- the reference's own optimizer tests (tests/test_train.py) ------------

def test_adamw_reduces_quadratic():
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                         weight_decay=0.0, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_state(cfg, params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.2


def test_grad_clipping_bounds_update():
    cfg = topt.OptConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0,
                         schedule="constant", weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = topt.init_state(cfg, params)
    huge = {"w": torch.full((4,), 1e9)}
    p2, _, m = topt.apply_updates(cfg, params, huge, state)
    assert float(m["grad_norm"]) > 1e8
    assert float(p2["w"].abs().max()) < 2.0  # clipped step


def test_lr_schedule_warmup_and_decay():
    cfg = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(topt.schedule_lr(cfg, 1)) < 0.2
    peak = float(topt.schedule_lr(cfg, 10))
    late = float(topt.schedule_lr(cfg, 100))
    assert peak > 0.9 and late < peak


def test_compressed_grads_error_feedback_converges():
    cfg = topt.OptConfig(lr=0.05, warmup_steps=0, schedule="constant",
                         weight_decay=0.0, compress_grads=True)
    params = {"w": torch.tensor([4.0, -2.0, 1.0])}
    state = topt.init_state(cfg, params)
    assert "err" in state
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.3


def test_bf16_moments():
    cfg = topt.OptConfig(moment_dtype="bfloat16")
    state = topt.init_state(cfg, {"w": torch.zeros(4)})
    assert state["m"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 7), (11, 123)])
def test_np_batch_equals_reference(seed, step):
    want = rdata.SyntheticLM(64, 16, 4, seed=seed).np_batch(step)
    got = tdata.SyntheticLM(64, 16, 4, seed=seed).np_batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def test_batch_specs_are_the_reference_shapes_with_torch_dtypes():
    want = rdata.SyntheticLM(64, 16, 4).batch_specs()
    got = tdata.SyntheticLM(64, 16, 4).batch_specs()
    for k, w in want.items():
        assert got[k].shape == w.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)


def test_data_deterministic_and_resumable():
    d = tdata.SyntheticLM(64, 16, 4, seed=3)
    a = d.np_batch(7)
    b = d.np_batch(7)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = d.np_batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["labels"].shape == (4, 16)


def test_data_has_learnable_structure():
    d = tdata.SyntheticLM(64, 128, 8, seed=0, noise=0.1)
    b = d.np_batch(0)
    pred = (d.a * b["tokens"] + d.b) % 64
    assert (pred == b["labels"]).mean() > 0.8


def test_prefetcher_orders_batches():
    d = tdata.SyntheticLM(64, 8, 2, seed=0)
    pf = tdata.Prefetcher(d, start_step=5, depth=2)
    try:
        s1, b1 = pf.next(timeout=30)
        s2, _ = pf.next(timeout=30)
    finally:
        pf.close()
    assert not pf.t.is_alive()
    assert (s1, s2) == (5, 6)
    assert np.array_equal(b1["tokens"], d.np_batch(5)["tokens"])


def test_make_global_array_uploads_to_the_device_asked():
    a = tdata.SyntheticLM(64, 8, 2).np_batch(0)["tokens"]
    t = tdata.make_global_array(a, "cpu")
    assert t.dtype == torch.int32 and t.is_contiguous()
    assert np.array_equal(t.numpy(), a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tdata.make_global_array(a)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(microbatch):
    """Three steps of ``make_train_step`` on tests/test_train.py's TINY
    config from the same weights and SyntheticLM batches: losses within
    1e-5 relative, parameters within 1e-4 of each leaf's max |p|
    (AdamW's first steps move each weight by about lr times the sign of
    its gradient, so agreement is that of the gradients' signs)."""
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=30, weight_decay=0.1)
    data = rdata.SyntheticLM(64, *SHAPE, seed=0)
    tree = _numpy_params(REF_TINY, seed=5)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, PORT_TINY, device="cpu")
    rcfg, tcfg = ropt.OptConfig(**opt), topt.OptConfig(**opt)
    rs, ts = ropt.init_state(rcfg, rp), topt.init_state(tcfg, tp)
    rfn = rstep.make_train_step(REF_TINY, rcfg, _ref_mesh(),
                                microbatch=microbatch)
    tfn = make_train_step(PORT_TINY, tcfg, microbatch=microbatch,
                          device="cpu")
    for step in range(3):
        batch = data.np_batch(step)
        rp, rs, rm = rfn(rp, rs, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tp, ts, tm = tfn(tp, ts, batch)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
            LOSS_RTOL * float(rm["loss"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
    _leaves_close(tp, rp)


def test_train_step_refuses_what_one_card_cannot_do():
    class StandIn:
        axis_names = ("data", "model")
        devices = np.zeros((2, 4))

    opt = topt.OptConfig()
    with pytest.raises(NotImplementedError, match="multi-card"):
        make_train_step(PORT_TINY, opt, StandIn(), device="cpu")
    StandIn.devices = np.zeros((1, 1))
    make_train_step(PORT_TINY, opt, StandIn(), device="cpu")
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(PORT_TINY, opt, microbatch=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_train_step(PORT_TINY, opt)   # device="cuda" by default


# ---------------------------------------------------------------------------
# the training loop: train, train_with_restarts, StragglerMonitor
# ---------------------------------------------------------------------------

def test_failure_restart_bit_identical():
    """The counterpart of tests/test_train.py's: a run that fails at step
    12 and resumes from its step-10 checkpoint ends within 1e-5 of the
    uninterrupted run — on the CPU with the same bits."""
    opt = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=30,
                         weight_decay=0.0)
    shape = ShapeConfig("tiny", "train", *SHAPE)
    with tempfile.TemporaryDirectory() as d:
        job = JobConfig(steps=20, ckpt_dir=os.path.join(d, "ck"),
                        ckpt_every=5, log_every=0, fail_at_step=12)
        logs = []
        h1 = train_with_restarts(PORT_TINY, opt, job, shape=shape,
                                 log=logs.append, device="cpu")
        h2 = train(PORT_TINY, opt, JobConfig(steps=20, log_every=0),
                   shape=shape, log=logs.append, device="cpu")
    assert abs(h1["loss"][-1] - h2["loss"][-1]) < 1e-5
    assert h1["loss"][-1] == h2["loss"][-1]
    assert h1["steps"] == list(range(10, 20))
    assert any("resumed from step 10" in line for line in logs)
    assert h2["loss"][-1] < h2["loss"][0]     # it learns
    for (path, a), (_, b) in zip(tree_items(h1["params"]),
                                 tree_items(h2["params"])):
        assert torch.equal(a, b), path


def test_train_needs_data_or_shape():
    with pytest.raises(ValueError, match="shape"):
        train(PORT_TINY, topt.OptConfig(), JobConfig(steps=1), device="cpu")


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=2.0)
    for i in range(10):
        m.add(i, 0.1)
    assert m.add(10, 0.5)   # 5x median -> flagged
    assert not m.add(11, 0.12)
    assert len(m.flagged) == 1


def test_moe_dropped_pairs_get_no_gradient():
    """At a capacity factor of 0.25 most (token, expert) pairs overflow
    their expert: the MoE block's gradient still matches the reference's
    (1e-4 of each gradient's max |g|), and a token whose every pair was
    dropped — its output the overflow row, cut off — gets exactly zero
    gradient."""
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    from repro_torch.models.transformer import layer_params
    ref_cfg, ref_p, cfg, p = _both("mixtral_8x22b", capacity_factor=0.25)
    rp0 = jax.tree.map(lambda a: a[0], ref_p["layers"]["moe"])
    tp0 = layer_params(p["layers"], 0)["moe"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = jax.grad(lambda xx, pp: jnp.sum(RL.moe_block(ref_cfg, pp, xx) * g),
                    argnums=(0, 1))(jnp.asarray(x), rp0)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp0.items()}
    out = TL.moe_block(cfg, leaves, xt)
    got = torch.autograd.grad(out, [xt, *leaves.values()],
                              torch.from_numpy(g))
    for a, w in zip(got, [want[0], *(want[1][k] for k in leaves)]):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())
    st, _, _, keep, _ = TL.moe_dispatch(cfg, tp0["router"], xt.detach())
    dropped = torch.zeros((2, 32)).scatter_add_(1, st, keep.float()) == 0
    assert int(dropped.sum()) > 0
    assert torch.equal(got[0][dropped], torch.zeros_like(got[0][dropped]))
