"""The sharded train and decode steps against the unsharded ones.

Four ranks of torch's threaded process group (one thread each) form a
(2, 2) ``("data", "model")`` mesh; every rank places the same float32
parameters, batch and cache by the reference's partition specs
(``train.step.place``, ``models.init_cache`` under ``use_mesh``) and
runs the step on its shards.  Loss, every gradient leaf, the gradient
norm AdamW clips by and the decode logits must equal the unsharded
step's within 1e-5 (gradients and logits scaled by their max |value|).
The updated parameters are not compared: AdamW's first step divides a
gradient by its own magnitude plus 1e-8, which magnifies the last bits
of leaves whose gradient is near that epsilon.  The
models: a reduced dense model with grouped-query attention whose one kv
head is fewer than the model axis (each shard's query heads must meet
their own kv head), a reduced mixtral (the MoE dispatch per batch
shard, the experts sharded), the same with 3 experts, which the model
axis does not divide (the experts' products then split over their
hidden width, as mixtral's and grok's 8 experts on a model axis of 16
are), and a reduced mamba2 (the SSD kernel's heads sharded, the conv
per batch shard, the recurrent decode).  Every gradient must come back
on its parameter's placements; a micro-batched step (two micro-batches,
each sharded over the data axis) is held against the unsharded
micro-batched step.
"""

import threading
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.meshmap import MeshLayout
from repro_torch.models import init_cache, init_params, reduced
from repro_torch.sharding.rules import use_mesh
from repro_torch.train.optimizer import OptConfig, init_state
from repro_torch.train.step import (make_serve_step, make_train_step,
                                    model_shardings, place, value_and_grad)
from repro_torch.train.tree import tree_items, tree_map

TOL = 1e-5
WORLD = 4
LAYOUT = MeshLayout(np.arange(WORLD).reshape(2, 2), ("data", "model"))

CONFIGS = {
    "dense-gqa": ("yi_6b", dict(num_heads=4, num_kv_heads=1)),
    "moe": ("mixtral_8x22b", {}),
    "moe-unsplit-experts": ("mixtral_8x22b", dict(num_experts=3)),
    "ssm": ("mamba2_2p7b", {}),
}


def _cfg(name):
    arch, kw = CONFIGS[name]
    return reduced(get_config(arch), dtype="float32", num_layers=2, **kw)


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (b, s))),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (b, s))),
            "mask": torch.from_numpy((rng.random((b, s)) < 0.8)
                                     .astype(np.float32))}


def _on_ranks(fn, world=WORLD):
    """``fn(rank)`` on each of ``world`` threads of a threaded process
    group; the results by rank.  Every thread is joined with a timeout,
    and the first rank's exception is raised here."""
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    store = dist.HashStore()
    results, errors = [None] * world, []

    def worker(rank):
        try:
            dist.init_process_group("threaded", rank=rank,
                                    world_size=world, store=store)
            results[rank] = fn(rank)
        except BaseException:  # noqa: BLE001 - reported below
            errors.append(traceback.format_exc())
        finally:
            dist.destroy_process_group()

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a rank hung"
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    assert not errors, errors[0]
    return results


def _full(tree):
    return {"/".join(k): (v.full_tensor() if hasattr(v, "full_tensor")
                          else v).detach().clone()
            for k, v in tree_items(tree)}


def _close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].float()
        scale = max(float(w.float().abs().max()), 1e-30)
        err = float((g - w.float()).abs().max())
        assert err <= TOL * scale, (key, err, scale)


@pytest.mark.parametrize("name,micro", [
    *(pytest.param(n, 1, id=n) for n in CONFIGS),
    *(pytest.param(n, 2, id=f"{n}-micro2")
      for n in ("dense-gqa", "moe-unsplit-experts"))])
def test_sharded_train_step_equals_the_unsharded_step(name, micro):
    cfg = _cfg(name)
    opt = OptConfig(warmup_steps=1)
    params = init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    loss0, grads0 = value_and_grad(cfg, params, batch)
    _, _, m1 = make_train_step(cfg, opt, microbatch=micro, device="cpu")(
        tree_map(torch.clone, params), init_state(opt, params), dict(batch))

    def rank(r):
        torch.set_num_threads(1)
        mesh = LAYOUT.device_mesh("cpu")
        own = tree_map(torch.clone, params)
        placed = place(own, model_shardings(cfg, mesh)[0], mesh)
        loss, grads = value_and_grad(cfg, placed, place(
            dict(batch), {k: ("data",) for k in batch}, mesh), mesh)
        for (key, g), (_, p) in zip(tree_items(grads), tree_items(placed)):
            assert g.placements == p.placements, (key, g.placements,
                                                  p.placements)
        step = make_train_step(cfg, opt, LAYOUT, microbatch=micro,
                               device="cpu")
        assert step.device_mesh is not None
        new, _, metrics = step(own, init_state(opt, own), dict(batch))
        assert all(hasattr(v, "placements") for v in
                   (new["tok_embed"], metrics["loss"]))
        return (float(loss.full_tensor()), _full(grads),
                float(metrics["loss"].full_tensor()),
                float(metrics["grad_norm"].full_tensor()))

    for loss, grads, step_loss, gnorm in _on_ranks(rank):
        assert abs(loss - float(loss0)) <= TOL * abs(float(loss0))
        assert abs(step_loss - float(m1["loss"])) <= \
            TOL * abs(float(m1["loss"]))
        assert abs(gnorm - float(m1["grad_norm"])) <= \
            TOL * float(m1["grad_norm"])
        _close(grads, _full(grads0))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_decode_step_equals_the_unsharded_step(name):
    """Six decode steps over a cache of 8 positions whose sequence is
    sharded over the model axis (attention caches): the steps cross from
    the first shard of positions into the second."""
    cfg = _cfg(name)
    params = init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 6)))
    serve = make_serve_step(cfg, device="cpu")
    cache = init_cache(cfg, 4, 8, device="cpu")
    want = [serve(params, cache, toks[:, i:i + 1], i)[0].clone()
            for i in range(toks.shape[1])]

    def rank(r):
        torch.set_num_threads(1)
        mesh = LAYOUT.device_mesh("cpu")
        placed = place(tree_map(torch.clone, params),
                       model_shardings(cfg, mesh)[0], mesh)
        with use_mesh(mesh):
            cache = init_cache(cfg, 4, 8, device="cpu")
        if "k" in cache:
            assert "Shard(dim=2)" in str(cache["k"].placements)  # kv_seq
        step = make_serve_step(cfg, LAYOUT, device="cpu")
        return [step(placed, cache, toks[:, i:i + 1], i)[0].full_tensor()
                for i in range(toks.shape[1])]

    for logits in _on_ranks(rank):
        for got, w in zip(logits, want):
            scale = float(w.abs().max())
            assert float((got - w).abs().max()) <= TOL * scale
