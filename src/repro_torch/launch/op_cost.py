"""Op-level cost counter: the per-device FLOPs, HBM bytes and collective
bytes of an eager step, counted op by op as it runs.

The reference package's ``launch/hlo_cost.py`` parses the optimized,
per-device HLO text of a compiled step.  Here nothing is compiled: a
:class:`CostCounter` (a ``TorchDispatchMode``) sees every aten op the
step dispatches on this rank — under DTensor the local ops of rank 0's
shards, because the counter hands an op on DTensors back to DTensor
(``NotImplemented``) and counts the local ops and the collectives that
DTensor runs for it — and :meth:`CostCounter.result` returns what
``hlo_cost.analyze`` returns:

- ``flops``: matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``;
  ``einsum``, ``tensordot`` and ``linear`` reach these) count 2·M·N·K a
  batch entry from the operand shapes, ``addmm`` / ``baddbmm`` one more
  a result element for the add.  Elementwise ops (:data:`ELTWISE_1`,
  the aten counterparts of ``hlo_cost``'s ``_ELTWISE_1``) count 1 a
  result element, transcendentals (:data:`ELTWISE_T`, ``_ELTWISE_T``'s)
  4.  Reductions (:data:`REDUCTIONS`) count 1 an input element;
  ``logsumexp`` 6 (max, subtract, exp, sum); ``softmax`` /
  ``log_softmax`` 7 an element (max, subtract, exp, sum, then divide /
  log-subtract); their backward 3.  Every other op (copies, gathers,
  scatters, sorts, concatenations, index arithmetic) counts 0.
- ``bytes_hbm``: every op's tensor operands plus its results, since eager
  torch fuses nothing.  Views and aliases (:data:`FREE`: ``view``,
  ``detach``, ``t``, ``expand``, ``permute``, slices, ``prim.device``,
  ``empty``…) count 0, as ``bitcast`` and ``get-tuple-element`` do in
  ``hlo_cost``, and are left out of ``op_counts``: a real tensor may
  replay a view as ``as_strided`` where a fake one slices.
- ``collective_bytes`` / ``collective_counts`` by the reference's five
  types and ``collective_total_bytes``: the ``_c10d_functional`` ops,
  by their local operand bytes (as ``hlo_cost.py`` counts a
  collective's operands), and ``collective_bytes_by_group`` by process
  group name (a mesh dim's group: ``DeviceMesh.get_group(dim)``).
  ``wait_tensor`` is not a collective.  DTensor runs no
  ``collective-permute``; the type is kept at 0.
- the two kernels, ``repro_torch::flash_attention`` and
  ``repro_torch::ssd``, count as one op each, with the FLOPs and bytes
  of their ``kernel.work`` — the formulas ``chip_smoke.py``'s bounds
  read.
- ``temp_peak_bytes``: the peak, over the step, of the bytes of the
  storages the step allocated and still holds (a storage counts until
  its last tensor, saved ones included, is freed).

Everything is per device.  ``hlo_cost``'s ``xla_cost_analysis`` and the
dry run's ``cost_xla_raw`` have no counterpart: there is no compiled
program to ask.  Also no while-loop trip counts: an eager loop runs its
body as many times as it runs, and each run is counted.
"""

from __future__ import annotations

import collections
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

ELTWISE_1 = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "neg", "abs", "floor", "ceil",
    "round", "sign", "clamp", "clamp_min", "clamp_max", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_not", "square", "reciprocal", "masked_fill",
    "threshold_backward", "fmod", "remainder", "lerp",
})
ELTWISE_T = frozenset({
    "exp", "tanh", "log", "rsqrt", "sqrt", "sigmoid", "pow", "sin", "cos",
    "erf", "expm1", "log1p", "atan2", "silu", "gelu", "softplus",
    "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "exp2", "log2",
})
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
    "var", "std", "norm", "linalg_vector_norm", "any", "all", "argmax",
    "argmin",
})
FREE = frozenset({
    "view", "_unsafe_view", "reshape", "alias", "detach", "t", "expand",
    "permute", "transpose", "unsqueeze", "squeeze", "select", "slice",
    "as_strided", "split", "split_with_sizes", "chunk", "unbind",
    "narrow", "diagonal", "unfold", "view_as_real", "view_as_complex",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "device", "_to_copy_meta", "wait_tensor",
    "is_same_size", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "dim", "size", "stride",
})
MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm"})


def _name(func) -> str:
    """``aten.add.Tensor`` -> ``add``; in-place ``add_`` -> ``add``."""
    name = func._schema.name.split("::")[-1]
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    k = a.shape[-1]
    batch = a.shape[0] if a.dim() == 3 else 1
    m, n = a.shape[-2], b.shape[-1]
    flops = 2.0 * batch * m * n * k
    if name in ("addmm", "baddbmm"):
        flops += batch * m * n
    return flops


def _group_name(func, args, kwargs) -> str:
    """The process group a ``_c10d_functional`` op runs on (its
    ``group_name`` argument)."""
    names = [a.name for a in func._schema.arguments]
    i = names.index("group_name")
    return str(kwargs["group_name"] if "group_name" in kwargs else args[i])


def _kernel_cost(name: str, args) -> tuple:
    """(flops, bytes) of one call of a repro_torch kernel op."""
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention.kernel import work
        q, k = args[0], args[1]
        causal, window = args[3], args[4]
        b, s, h, d = q.shape
        return work(b, s, h, k.shape[2], d, q.element_size(), window,
                    k.shape[1], causal)
    from repro_torch.kernels.ssd.kernel import work
    x, B = args[0], args[3]
    b, l, h, p = x.shape
    return work(b, l, h, p, B.shape[-1], x.element_size())


# DTensor's sharding propagator runs an op on fake tensors of the global
# shape to learn its output's shape, in one of these functions (by torch
# release; each of them that the propagator has is flagged)
_SHAPE_INFERENCE = ("_propagate_tensor_meta_non_cached",
                    "_propagate_tensor_meta_cached",
                    "_propagate_tensor_meta")


def _hook_shape_inference(counter):
    """Flag ``counter`` while DTensor infers an op's output shape on fake
    tensors of the global shape: no rank runs those ops, so they are not
    counted (and whether they reach the counter at all depends on the
    fake mode around it, so a real and a fake run would otherwise count
    differently).  Raises where this torch's propagator has none of
    :data:`_SHAPE_INFERENCE`, so that a renamed function fails here and
    does not count global-shape ops as the step's.  Returns the undo."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _SHAPE_INFERENCE if hasattr(prop, n)]
    if not names:
        raise RuntimeError(
            "DTensor's sharding propagator has none of "
            f"{_SHAPE_INFERENCE}: the counter cannot tell its shape "
            "inference from the step's ops in this torch")
    own = {n: prop.__dict__.get(n) for n in names}

    def flagged(inner):
        def inferring(*args, **kwargs):
            counter.shape_inference_calls += 1
            counter._inferring += 1
            try:
                return inner(*args, **kwargs)
            finally:
                counter._inferring -= 1
        return inferring
    for n in names:
        setattr(prop, n, flagged(getattr(prop, n)))

    def undo():
        for n, f in own.items():
            if f is None:
                delattr(prop, n)
            else:
                setattr(prop, n, f)
    return undo


class CostCounter(TorchDispatchMode):
    """Counts what the ops dispatched under it cost (see the module
    docstring); ``with CostCounter() as c: step(...)`` then
    ``c.result()``.  Enter it inside ``FakeTensorMode`` to count a step
    that allocates nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_hbm = 0.0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.coll_groups = collections.Counter()
        self.ops = collections.Counter()
        self.warnings: list = []
        self._live: dict = {}
        self._live_bytes = 0
        self.temp_peak_bytes = 0
        self.shape_inference_calls = 0
        self._inferring = 0
        self._undo = None

    def __enter__(self):
        self._undo = _hook_shape_inference(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._undo()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # count DTensor's local ops instead
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inferring:
            self._count(func, args, kwargs, out)
        return out

    # -- counting -------------------------------------------------------

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        if ns == "prim":    # device and shape queries: FakeTensorMode
            return          # makes them, a real run need not
        name = _name(func)
        if name in FREE:
            return
        self.ops[f"{ns}.{name}"] += 1
        outs = _tensors(out)
        self._track(outs, _tensors((args, kwargs)))
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if name != "wait_tensor":
                if kind is None:
                    self.warnings.append(f"uncounted collective {name}")
                else:
                    nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                    self.coll_bytes[kind] += nbytes
                    self.coll_counts[kind] += 1
                    self.coll_groups[_group_name(func, args, kwargs)] += \
                        nbytes
        if ns == "repro_torch":
            flops, nbytes = _kernel_cost(name, args)
            self.flops += flops
            self.bytes_hbm += nbytes
            return
        ins = _tensors((args, kwargs))
        self.bytes_hbm += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        res = sum(t.numel() for t in outs)
        if name in MATMULS:
            self.flops += _matmul_flops(name, args)
        elif name in ELTWISE_1:
            self.flops += res
        elif name in ELTWISE_T:
            self.flops += 4 * res
        elif name in REDUCTIONS:
            self.flops += ins[0].numel() if ins else 0
        elif name == "logsumexp":
            self.flops += 6 * ins[0].numel()
        elif name in ("_softmax", "_log_softmax"):
            self.flops += 7 * res
        elif name in ("_softmax_backward_data", "_log_softmax_backward_data"):
            self.flops += 3 * res

    def _track(self, outs, ins) -> None:
        """Add each storage of ``outs`` that is not one of ``ins``' (an
        in-place op's result) to the live bytes until it is freed; keep
        the peak."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or key in seen:
                continue
            nbytes = st.nbytes()
            self._live[key] = weakref.ref(st, self._freer(key, nbytes))
            self._live_bytes += nbytes
        self.temp_peak_bytes = max(self.temp_peak_bytes, self._live_bytes)

    def _freer(self, key, nbytes):
        def freed(_):
            self._live.pop(key, None)
            self._live_bytes -= nbytes
        return freed

    def result(self) -> dict:
        """The counts, by ``hlo_cost.analyze``'s keys, plus
        ``temp_peak_bytes`` and ``op_counts`` (op name -> calls of every
        op but the free ones)."""
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "collective_bytes": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "collective_total_bytes": int(sum(self.coll_bytes.values())),
            "collective_bytes_by_group": dict(self.coll_groups),
            "temp_peak_bytes": int(self.temp_peak_bytes),
            "op_counts": dict(self.ops),
            "warnings": list(self.warnings),
        }


def tree_nbytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``tree``
    (nested dicts, lists and tuples): a DTensor counts its local tensor."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += math.prod(local.shape) * local.element_size()
    return total
