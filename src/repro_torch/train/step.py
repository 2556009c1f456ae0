"""Train / serve step factories.

The reference package's ``train/step.py``.  The reference returns a
jit'd function with in / out shardings from the logical rules, donated
parameter and optimizer buffers, and gradient accumulation over
micro-batches in a ``lax.scan``.  Here the step runs eagerly on one
device (no ``torch.compile``): the loss and its gradient by autograd
(through the kernels' backward on the card), the AdamW update in place
(the donation), and micro-batch gradients summed in float32 in
micro-batch order, then divided, as the scan sums them.

On a mesh (a ``torch.distributed`` ``DeviceMesh``, or a
:class:`~repro_torch.meshmap.MeshLayout` of more than one device over an
initialised process group) the trees are DTensors placed by the
reference's partition specs (:func:`model_shardings`,
:func:`opt_shardings`, :func:`batch_shardings`, :func:`place`), the step
runs under :func:`~repro_torch.sharding.rules.use_mesh`, and before AdamW
every gradient is redistributed to its parameter's placements and the
loss to ``Replicate()``: the reference's out-shardings, and what sums
the data-parallel gradients (DTensor leaves them ``Partial`` until
something redistributes them).
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (ModelConfig, ShapeConfig, ShapeDtype,
                                decode_step,
                                loss_fn, params_spec, tree_abstract,
                                tree_axes)
from repro_torch.models.params import DTYPES
from repro_torch.sharding.rules import (DEFAULT_RULES, PartitionSpec,
                                        is_dtensor, mesh_axis_sizes,
                                        placements_for, spec_for_axes,
                                        tree_shardings, use_mesh)

from .data import make_global_array
from .optimizer import OptConfig, abstract_state, apply_updates
from .tree import tree_leaves, tree_map, tree_unflatten


def device_mesh_of(mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` a step places its tensors on: ``mesh`` itself
    when it is one, None for no mesh or a mesh of one device, else
    ``mesh.device_mesh(device_type)``.  A mesh of several devices with
    no process group behind it raises ``NotImplementedError``."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    n = math.prod(mesh_axis_sizes(mesh).values())
    if n == 1:
        return None
    import torch.distributed as dist
    if not (hasattr(mesh, "device_mesh") and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() == n):
        raise NotImplementedError(
            f"a mesh of {n} devices with no process group of {n} ranks: "
            "the port places tensors on a multi-card mesh only through a "
            "torch.distributed DeviceMesh (MeshLayout.device_mesh)")
    return mesh.device_mesh(device_type)


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


def place(tree, spec_tree, device_mesh):
    """``tree`` with every plain leaf distributed on ``device_mesh`` by
    its partition spec (each rank keeps its shard of its own full copy:
    nothing is communicated); DTensor leaves are kept as they are."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, spec):
        if is_dtensor(x):
            return x
        return distribute_tensor(x, device_mesh,
                                 placements_for(spec, device_mesh),
                                 src_data_rank=None)
    return tree_map(one, tree, spec_tree)


def _split_micro(batch, n):
    """``n`` micro-batches of contiguous rows, as the reference's reshape
    splits the batch.  A DTensor is gathered once and each micro-batch
    placed back on its batch placements (a local slice): DTensor would
    gather every slice of a batch-sharded dim and leave it replicated."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        m = v.shape[0] // n
        full = _replicated(v) if is_dtensor(v) else v
        for i in range(n):
            part = full[i * m:(i + 1) * m]
            out[i][k] = part.redistribute(v.device_mesh, v.placements) \
                if is_dtensor(v) else part
    return out


def value_and_grad(cfg: ModelConfig, params, batch, device_mesh=None,
                   rules=None):
    """(loss, gradient tree) of :func:`loss_fn` at ``params``; the
    gradients have the parameters' dtypes (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives).  With a ``device_mesh`` the
    DTensor trees run under ``use_mesh`` and the gradients come back on
    their parameters' placements, the loss replicated."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), _on(device_mesh, rules):
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    grads = tree_unflatten(params, grads)
    if device_mesh is not None:
        # the reference's out-shardings: reduce the pending sums
        grads = tree_map(lambda g, p: g.redistribute(device_mesh,
                                                     p.placements),
                         grads, params)
        loss = _replicated(loss)
    return loss.detach(), grads


def _on(device_mesh, rules):
    """``use_mesh`` on a mesh, nothing on one card."""
    if device_mesh is None:
        return contextlib.nullcontext()
    return use_mesh(device_mesh, rules)


def _replicated(x):
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


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
    ``grad_norm`` and ``lr``.  On a mesh (:func:`device_mesh_of`) plain
    leaves of the three trees are placed first (:func:`place`), and the
    trees returned are DTensors."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    dev = resolve_device(device)
    dmesh = device_mesh_of(mesh, dev.type)
    rules = rules or DEFAULT_RULES

    def step_fn(params, opt_state, batch):
        batch = {k: _upload(v, dev) for k, v in batch.items()}
        if dmesh is not None:
            b, s = batch["tokens"].shape
            shape = ShapeConfig("batch", "train", s, b)
            params = place(params, model_shardings(cfg, dmesh, rules)[0],
                           dmesh)
            opt_state = place(opt_state,
                              opt_shardings(opt_cfg, cfg, dmesh, rules)[0],
                              dmesh)
            batch = place(batch, batch_shardings(cfg, shape, dmesh, rules),
                          dmesh)
        if microbatch > 1:
            loss = None
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for mb in _split_micro(batch, microbatch):
                lval, g = value_and_grad(cfg, params, mb, dmesh, rules)
                loss = lval if loss is None else loss + lval
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        else:
            loss, grads = value_and_grad(cfg, params, batch, dmesh, rules)
        with _on(dmesh, rules):
            params, opt_state, metrics = apply_updates(opt_cfg, params,
                                                       grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    step_fn.device_mesh = dmesh
    return step_fn


def make_serve_step(cfg: ModelConfig, mesh=None, *, rules=None,
                    device="cuda"):
    """``decode_step`` as the reference's serve step: one token against
    the cache, which is written in place (the reference donates it).  On
    a mesh (:func:`device_mesh_of`) the step runs under
    :func:`~repro_torch.sharding.rules.use_mesh`; ``params`` and the
    cache are then DTensors the caller placed (:func:`place`,
    ``models.init_cache`` under ``use_mesh``)."""
    dmesh = device_mesh_of(mesh, torch.device(device).type)
    rules = rules or DEFAULT_RULES

    # no inference_mode on a mesh: DTensor's views of tensors made
    # outside it cannot be taken inside it
    grad_off = torch.inference_mode if dmesh is None else torch.no_grad

    def fn(params, cache, tokens, pos):
        with grad_off(), _on(dmesh, rules):
            return decode_step(cfg, params, cache, tokens, pos)

    fn.device_mesh = dmesh
    return fn
