"""Train / serve step factories.

The reference package's ``train/step.py``.  The reference returns a
jit'd function with in / out shardings from the logical rules, donated
parameter and optimizer buffers, and gradient accumulation over
micro-batches in a ``lax.scan``.  Here the step runs eagerly on one
device (no ``torch.compile``): the loss and its gradient by autograd
(through the kernels' backward on the card), the AdamW update in place
(the donation), and micro-batch gradients summed in float32 in
micro-batch order, then divided, as the scan sums them.  The sharding
trees are the reference's partition specs; a mesh of more than one
device is refused until a multi-card slice places them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (ModelConfig, ShapeDtype, decode_step,
                                loss_fn, params_spec, tree_abstract,
                                tree_axes)
from repro_torch.models.params import DTYPES
from repro_torch.sharding.rules import (DEFAULT_RULES, PartitionSpec,
                                        mesh_axis_sizes, spec_for_axes,
                                        tree_shardings)

from .data import make_global_array
from .optimizer import OptConfig, abstract_state, apply_updates
from .tree import tree_leaves, tree_map, tree_unflatten


def _one_device(mesh) -> None:
    """Refuse a mesh of more than one device: nothing here places a
    tensor on several cards."""
    if mesh is None:
        return
    n = math.prod(mesh_axis_sizes(mesh).values())
    if n > 1:
        raise NotImplementedError(
            f"a mesh of {n} devices: the port trains on one card; sharded "
            "training waits for the multi-card slice of the port")


def batch_shardings(cfg: ModelConfig, shape, mesh, rules=None) -> dict:
    rules = rules or DEFAULT_RULES
    dp = spec_for_axes(("batch",), rules, mesh, (shape.global_batch,))
    bs = PartitionSpec(*dp, None)
    out = {"tokens": bs, "labels": bs, "mask": bs}
    if cfg.family in ("encdec", "vlm"):
        key = "frames" if cfg.family == "encdec" else "patches"
        out[key] = PartitionSpec(*dp, None, None)
    return out


def batch_specs(cfg: ModelConfig, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": ShapeDtype((b, s), torch.int32),
        "labels": ShapeDtype((b, s), torch.int32),
        "mask": ShapeDtype((b, s), torch.float32),
    }
    if cfg.family == "encdec":
        out["frames"] = ShapeDtype((b, cfg.encoder_seq, cfg.frontend_dim),
                                   DTYPES[cfg.dtype])
    if cfg.family == "vlm":
        out["patches"] = ShapeDtype((b, cfg.num_patches, cfg.frontend_dim),
                                    DTYPES[cfg.dtype])
    return out


def model_shardings(cfg: ModelConfig, mesh, rules=None):
    """(partition-spec tree, abstract tree, logical-axes tree) of the
    parameters."""
    rules = rules or DEFAULT_RULES
    spec = params_spec(cfg)
    axes = tree_axes(spec)
    ab = tree_abstract(spec, cfg.dtype)
    return tree_shardings(axes, ab, rules, mesh), ab, axes


def opt_shardings(opt_cfg: OptConfig, cfg: ModelConfig, mesh, rules=None):
    """(partition-spec tree, abstract tree) of the optimizer state: the
    moments shard exactly like the parameters, the step is replicated."""
    rules = rules or DEFAULT_RULES
    param_sh, ab, axes = model_shardings(cfg, mesh, rules)
    moment_sh = {"step": PartitionSpec(), "m": param_sh, "v": param_sh}
    if opt_cfg.compress_grads:
        moment_sh["err"] = param_sh
    return moment_sh, abstract_state(opt_cfg, ab)


def _split_micro(batch, n):
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, gradient tree) of :func:`loss_fn` at ``params``; the
    gradients have the parameters' dtypes (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def _upload(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return make_global_array(v, dev)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh=None, *,
                    rules=None, microbatch: int = 1, device="cuda"):
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device``; ``batch`` values may be numpy arrays or
    tensors (uploaded to ``device``).  ``params`` and the moments are
    updated in place; ``metrics`` holds the float32 tensors ``loss``,
    ``grad_norm`` and ``lr``."""
    _one_device(mesh)
    dev = resolve_device(device)
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")

    def step_fn(params, opt_state, batch):
        batch = {k: _upload(v, dev) for k, v in batch.items()}
        if microbatch > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in _split_micro(batch, microbatch):
                lval, g = value_and_grad(cfg, params, mb)
                loss = loss + lval
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        else:
            loss, grads = value_and_grad(cfg, params, batch)
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return step_fn


def make_serve_step(cfg: ModelConfig, mesh=None, *, rules=None):
    """``decode_step`` as the reference's serve step: one token against
    the cache, which is written in place (the reference donates it)."""
    _one_device(mesh)

    def fn(params, cache, tokens, pos):
        with torch.inference_mode():
            return decode_step(cfg, params, cache, tokens, pos)

    return fn
