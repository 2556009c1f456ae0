"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

The reference package's ``sharding/rules.py``.  Rules map logical names
("embed", "heads", "vocab", ...) to mesh axes ("pod", "data", "model").
A mapping is dropped (replicated) when the tensor dim is not divisible
by the mesh-axis product or when the mesh axis was already consumed by
an earlier dim of the same tensor — this is what lets one rule set
serve configs whose kv_heads / experts are smaller than the model axis.

A mesh is any object with ``axis_names`` and ``devices``, an array whose
shape is the axis sizes (the port's
:class:`~repro_torch.meshmap.device_mesh.MeshLayout`, or a stand-in), or
a ``torch.distributed.device_mesh.DeviceMesh``.  :func:`spec_for_axes`
returns the reference's partition specs as :class:`PartitionSpec`, a
tuple of the port's own, and :func:`tree_shardings` a tree of them.

A spec becomes a placement by :func:`placements_for`: one DTensor
placement a mesh dim, ``Shard(i)`` on each mesh dim that tensor dim
``i`` names (``("pod", "data")`` shards one dim over two mesh dims, pod
major, as the reference's spec does).  :func:`use_mesh` is the
reference's ``with mesh:``; under it :func:`logical` redistributes a
DTensor to its logical axes' placements, the reference's
``with_sharding_constraint``.  A plain tensor passes through
:func:`logical` untouched, so a one-card step keeps its bits.

:func:`shard_slices` is the arithmetic of the checkpoints: this rank's
slice of a global shape under its placements, and whether it is that
slice's first holder (which writes the shard in a sharded save; each
rank reads its own slice in the elastic restore).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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
    if hasattr(mesh, "mesh_dim_names"):  # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
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


def placements_for(spec: PartitionSpec, device_mesh) -> list:
    """The DTensor placements of ``spec`` on ``device_mesh``: one a mesh
    dim, ``Replicate()`` where no tensor dim names it.  A tensor dim
    that names several mesh axes must name them in the mesh's order."""
    names = list(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(ax) for ax in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for d in dims:
            out[d] = Shard(i)
    return out


_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(device_mesh, rules: dict | None = None):
    """The reference's ``with mesh:``: :func:`logical` and the layers'
    kernel calls read ``device_mesh`` and ``rules`` (the defaults when
    None) inside the block.  Plain tensors that meet a DTensor are taken
    as replicated (``implicit_replication``; the flag is restored on
    exit, so blocks nest), as constants are under ``jit``."""
    dispatcher = DTensor._op_dispatcher   # what implicit_replication sets
    token = _MESH.set((device_mesh, rules or DEFAULT_RULES))
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield device_mesh
    finally:
        dispatcher._allow_implicit_replication = before
        _MESH.reset(token)


def current_mesh():
    """``(device_mesh, rules)`` of the innermost :func:`use_mesh`, or
    None outside one."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def logical_placements(axes, shape, rules: dict | None = None,
                       device_mesh=None) -> list:
    """The placements of a tensor of ``shape`` with logical ``axes``
    under :func:`use_mesh` (or the ``device_mesh`` / ``rules`` given)."""
    if device_mesh is None or rules is None:
        cur_mesh, cur_rules = current_mesh() or (None, DEFAULT_RULES)
        device_mesh = device_mesh or cur_mesh
        rules = rules or cur_rules
    return placements_for(spec_for_axes(axes, rules, device_mesh, shape),
                          device_mesh)


def zeros(shape, dtype, axes, device=None):
    """``torch.zeros(shape)``, or under :func:`use_mesh` a DTensor of
    zeros placed by the logical ``axes`` (each rank allocates its own
    shard only)."""
    if current_mesh() is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    mesh, rules = current_mesh()
    pl = logical_placements(axes, shape, rules, mesh)
    return placed(torch.zeros(local_shape(shape, pl, mesh), dtype=dtype,
                              device=device), shape, pl, mesh)


def local_shape(shape, placements, device_mesh) -> tuple:
    """The shard shape of a tensor of ``shape`` under ``placements``
    (every sharded dim divides evenly: :func:`spec_for_axes` keeps only
    such mappings)."""
    out = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out[pl.dim] //= device_mesh.size(m)
    return tuple(out)


def shard_slices(shape, placements, device_mesh, name: str = "") -> tuple:
    """``(slices, first)``: this rank's slice of a tensor of global
    ``shape`` under ``placements`` (one ``slice`` a tensor dim; where
    several mesh dims shard one tensor dim, the earlier mesh dim is the
    major one, as :func:`placements_for` orders them), and whether this
    rank is the slice's first holder — at coordinate 0 on every mesh dim
    that does not shard the tensor.  A mesh dim that does not divide its
    tensor dim raises ``ValueError`` naming ``name`` and the dim, as the
    reference's ``jax.make_array_from_callback`` refuses it."""
    coord = device_mesh.get_coordinate()
    start, size, first = [0] * len(shape), list(shape), True
    for m, pl in enumerate(placements):
        n = device_mesh.size(m)
        if not isinstance(pl, Shard):
            first = first and coord[m] == 0
            continue
        d = pl.dim
        if size[d] % n:
            raise ValueError(f"{name or 'tensor'} of shape {tuple(shape)}: "
                             f"dim {d} ({size[d]}) does not divide into "
                             f"{n} shards of mesh dim {m}")
        size[d] //= n
        start[d] += coord[m] * size[d]
    return tuple(slice(a, a + k) for a, k in zip(start, size)), first


def placed(local, shape, placements, device_mesh):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local``; nothing is communicated."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def logical(x, axes, rules: dict | None = None, mesh=None):
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor is redistributed to ``spec_for_axes(axes, ...)`` on its mesh
    (a pending ``Partial`` sum is reduced there); anything else is
    returned as it is."""
    if not is_dtensor(x):
        return x
    want = logical_placements(axes, x.shape, rules, mesh or x.device_mesh)
    if list(x.placements) == want:
        return x
    # a shard cut from a replica is a strided view; ops that view their
    # input (einsum) need it dense
    return x.redistribute(x.device_mesh, want).contiguous()
