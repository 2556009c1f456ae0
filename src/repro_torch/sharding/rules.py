"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

The reference package's ``sharding/rules.py``.  Rules map logical names
("embed", "heads", "vocab", ...) to mesh axes ("pod", "data", "model").
A mapping is dropped (replicated) when the tensor dim is not divisible
by the mesh-axis product or when the mesh axis was already consumed by
an earlier dim of the same tensor — this is what lets one rule set
serve configs whose kv_heads / experts are smaller than the model axis.

A mesh is any object with ``axis_names`` and ``devices``, an array whose
shape is the axis sizes: the port's
:class:`~repro_torch.meshmap.device_mesh.MeshLayout` (its ranks), or a
stand-in.  :func:`spec_for_axes` returns the reference's partition
specs as :class:`PartitionSpec`, a tuple of the port's own, and
:func:`tree_shardings` a tree of them: one card places nothing, so
there is no ``NamedSharding`` here and :func:`logical` is the identity.
"""

from __future__ import annotations

# The baseline parallelism recipe: DP+FSDP over (pod, data); TP/SP/EP over
# model.
DEFAULT_RULES: dict = {
    # --- parameters ---
    "embed": ("data",),          # FSDP (ZeRO-3) shards the embed dim
    "embed_no_fsdp": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "conv": (),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "frontend": (),
    # --- activations ---
    "batch": ("pod", "data"),
    "act_seq": (),               # attention-region sequence: unsharded
    "sp_seq": ("model",),        # megatron-SP residual sequence sharding
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    # --- kv cache / decode ---
    "kv_batch": ("pod", "data"),
    "kv_seq": ("model",),        # flash-decoding style seq sharding
    # --- optimizer ---
    "opt": (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh-axis name, or a
    tuple of them — the entries of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for_axes(axes, rules: dict, mesh, shape=None) -> PartitionSpec:
    """PartitionSpec for one tensor's logical axes.

    Drops mappings that don't divide the dim size or reuse a mesh axis.
    """
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    entries = []
    for i, name in enumerate(axes):
        want = rules.get(name) if name else None
        if want is None:
            entries.append(None)
            continue
        if isinstance(want, str):
            want = (want,)
        chosen = [ax for ax in want if ax in sizes and ax not in used]
        prod = 1
        for ax in chosen:
            prod *= sizes[ax]
        if chosen and shape is not None and shape[i] % prod != 0:
            # try a prefix of the requested axes that divides
            kept, prod = [], 1
            for ax in chosen:
                if shape[i] % (prod * sizes[ax]) == 0:
                    kept.append(ax)
                    prod *= sizes[ax]
            chosen = kept
        if not chosen:
            entries.append(None)
            continue
        used.update(chosen)
        entries.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
    # trim trailing Nones for tidiness
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def tree_shardings(axes_tree, abstract_tree, rules: dict, mesh):
    """PartitionSpec tree matching the params tree (the reference's
    NamedSharding tree, without the placement)."""
    return {k: tree_shardings(v, abstract_tree[k], rules, mesh)
            if isinstance(v, dict)
            else spec_for_axes(v, rules, mesh, abstract_tree[k].shape)
            for k, v in axes_tree.items()}


def logical(x, axes, rules: dict | None = None, mesh=None):
    """The reference's ``with_sharding_constraint`` by logical names: on
    one card there is nothing to constrain, so ``x`` itself."""
    return x
