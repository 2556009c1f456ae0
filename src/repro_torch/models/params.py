"""Parameter trees: declarations, random initialisation, and carrying the
reference package's parameters across.

A model's parameters are declared once as a nested dict of :class:`P`
specs (shape + logical axis names + init), as in the reference; the
stacked per-layer tensors keep their leading ``(L, ...)`` axis.  From
that declaration come :func:`init_params` (random weights on a device,
drawn leaf by leaf from one explicit ``torch.Generator``),
:func:`params_from_numpy` (the reference's weights, checked leaf by leaf
against the declaration), and the trees of logical axes
(:func:`tree_axes`) and of shapes and dtypes (:func:`tree_abstract`)
that the sharding rules read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter tensor."""

    shape: tuple
    axes: tuple          # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 0.0    # stddev override (0 -> fan-in)
    dtype: str = ""       # override model dtype (e.g. "float32" for norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype without its data (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _map_specs(fn, spec_tree):
    return {k: fn(v) if isinstance(v, P) else _map_specs(fn, v)
            for k, v in spec_tree.items()}


def tree_axes(spec_tree):
    """Tree of logical-axis tuples, same structure as the params."""
    return _map_specs(lambda p: tuple(p.axes), spec_tree)


def tree_abstract(spec_tree, dtype: str):
    """Tree of :class:`ShapeDtype`, same structure as the params."""
    return _map_specs(lambda p: ShapeDtype(
        tuple(int(s) for s in p.shape), DTYPES[p.dtype or dtype]), spec_tree)


def spec_leaves(spec_tree, prefix: tuple = ()):
    """``(path, P)`` for every leaf, keys sorted at each level (the order
    ``jax.tree`` flattens a dict in)."""
    for key in sorted(spec_tree):
        node = spec_tree[key]
        if isinstance(node, P):
            yield prefix + (key,), node
        else:
            yield from spec_leaves(node, prefix + (key,))


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def count_params(spec_tree) -> int:
    return int(sum(math.prod(int(s) for s in p.shape)
                   for _, p in spec_leaves(spec_tree)))


def _std(p: P) -> float:
    """Standard deviation of a normal init, as the reference's
    ``tree_init`` draws it: the fan-in is the product of every axis but
    the last, the stacked ``(L, ...)`` layer axis included."""
    if p.scale:
        return p.scale
    if p.init == "embed":
        return 1.0
    shape = [int(s) for s in p.shape]
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    return 1.0 / math.sqrt(max(fan_in, 1))


def draw_leaves(cfg, seed: int = 0, device="cuda"):
    """``(path, P, float32 tensor)`` for every leaf of ``cfg``'s
    declaration in sorted key order: normal draws from one
    ``torch.Generator`` seeded with ``seed`` (the constant leaves take
    no draw).  One leaf at a time, so a caller that casts each before the
    next holds at most one leaf in float32."""
    from .transformer import params_spec
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for path, p in spec_leaves(params_spec(cfg)):
        shape = tuple(int(s) for s in p.shape)
        if p.init == "zeros":
            val = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif p.init == "ones":
            val = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            val = torch.randn(shape, generator=gen, dtype=torch.float32,
                              device=dev).mul_(_std(p))
        yield path, p, val


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random parameters of ``cfg`` on ``device``: :func:`draw_leaves`,
    each cast to its leaf's dtype — so a bfloat16 model is the rounding
    of the float32 model of the same seed."""
    out: dict = {}
    for path, p, val in draw_leaves(cfg, seed, device):
        _set(out, path, val.to(DTYPES[p.dtype or cfg.dtype]))
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` (arrays from jax are read-only)."""
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """The reference's parameters as the port's.

    ``tree`` is the nested dict ``jax.tree.map(np.asarray, params)``
    gives: the same names, the stacked ``(L, ...)`` layer tensors.
    Every leaf of ``params_spec(cfg)`` must be there with its declared
    shape and dtype, and nothing else may be; the result holds the same
    values on ``device``.
    """
    from .transformer import params_spec
    dev = resolve_device(device)
    spec = params_spec(cfg)
    out: dict = {}
    want = set()
    for path, p in spec_leaves(spec):
        want.add(path)
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"parameter {'/'.join(path)} is missing")
            node = node[key]
        a = np.asarray(node)
        shape = tuple(int(s) for s in p.shape)
        dtype = p.dtype or cfg.dtype
        if a.shape != shape or a.dtype.name != dtype:
            raise ValueError(
                f"parameter {'/'.join(path)}: got {a.shape} {a.dtype.name},"
                f" declared {shape} {dtype}")
        _set(out, path, _tensor(a).to(dev))

    def leaves(node, prefix=()):
        for key, val in node.items():
            if isinstance(val, dict):
                yield from leaves(val, prefix + (key,))
            else:
                yield prefix + (key,)

    extra = sorted("/".join(p) for p in set(leaves(tree)) - want)
    if extra:
        raise ValueError(f"parameters not declared for {cfg.name}: {extra}")
    return out
