"""Content-addressed signatures for mapping inputs (the serve layer's
cache keys).

A *signature* is a short hex digest that identifies a mapping problem by
CONTENT, not by object identity: two ``TaskGraph``s built independently
from the same arrays hash to the same signature, so a request cache keyed
by signatures (``repro_torch.serve``) deduplicates repeat and concurrent
requests across processes, restarts and callers.

Canonicalisation rules (what is — and is not — part of the identity):

- arrays hash their dtype, shape and raw bytes (C-contiguous);
- ``TaskGraph.meta`` is EXCLUDED — it is free-form provenance that never
  affects the mapping;
- ``Machine.name`` is EXCLUDED — it is a report label; two machines with
  the same dims/wrap/bandwidths/core-dims are the same network;
- dataclass configs (``PipelineConfig`` & co) hash a canonical-JSON
  field-by-field form (nested dataclasses such as ``HierarchySpec``
  keep their own type tag), so tuple/list spelling differences or the
  construction path of an equal spec do not split the cache; a field
  declared with ``metadata={"signature": False}`` (``PipelineConfig.device``)
  is EXCLUDED — where a problem is scored does not change the problem.

The digest is SHA-1 truncated to 128 bits.  Signatures are CACHE KEYS,
not a security boundary — SHA-1 is a fast (hardware-accelerated)
primitive of hashlib, the warm-path request latency is dominated by
exactly this hash, and 128
bits keeps accidental collisions out of reach for any realistic request
volume.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

DIGEST_BYTES = 16  # 128-bit keys (truncated SHA-1)


def _hasher():
    return hashlib.sha1(usedforsecurity=False)


def _hexdigest(h) -> str:
    return h.hexdigest()[: 2 * DIGEST_BYTES]


def _update_array(h, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    # feed the array's buffer directly (no tobytes() copy); writeable
    # arrays export a buffer fine, and C-contiguity is guaranteed above
    h.update(arr.view(np.uint8).reshape(-1).data)


def array_digest(arr: np.ndarray) -> str:
    """Digest of one array (dtype + shape + bytes)."""
    h = _hasher()
    _update_array(h, np.asarray(arr))
    return _hexdigest(h)


def _canonical(obj):
    """JSON-encodable canonical form: tuples -> lists, arrays -> digests,
    numpy scalars -> python scalars, non-finite floats -> strings."""
    if isinstance(obj, np.ndarray):
        return {"__array__": array_digest(obj)}
    if isinstance(obj, (tuple, list)):
        return [_canonical(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else repr(f)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # recurse FIELD BY FIELD (not dataclasses.asdict, which
        # deep-converts nested dataclasses to anonymous dicts): a
        # nested config value — e.g. PipelineConfig.hierarchy holding a
        # HierarchySpec — keeps its own ``__dataclass__`` tag, so two
        # structurally-different specs can never canonicalise to the
        # same key by field coincidence
        return {"__dataclass__": type(obj).__name__,
                **_canonical({f.name: getattr(obj, f.name)
                              for f in dataclasses.fields(obj)
                              if f.metadata.get("signature", True)})}
    return obj


def config_signature(cfg) -> str:
    """Signature of a config dataclass (or any JSON-able structure)."""
    h = _hasher()
    h.update(json.dumps(_canonical(cfg), sort_keys=True).encode())
    return _hexdigest(h)


def taskgraph_signature(graph) -> str:
    """Signature of a :class:`repro_torch.core.TaskGraph` (coords + edges +
    weights; ``meta`` excluded — provenance only)."""
    h = _hasher()
    h.update(b"taskgraph")
    _update_array(h, np.asarray(graph.coords))
    _update_array(h, np.asarray(graph.edges))
    _update_array(h, np.asarray(graph.weights))
    return _hexdigest(h)


def machine_signature(machine) -> str:
    """Signature of a :class:`repro_torch.core.Machine` (dims + wrap + per-dim
    bandwidth patterns + core-dim count; ``name`` excluded)."""
    h = _hasher()
    h.update(b"machine")
    h.update(repr(tuple(machine.dims)).encode())
    h.update(repr(tuple(bool(w) for w in machine.wrap)).encode())
    h.update(str(int(machine.core_dims)).encode())
    for pat in machine.link_bw:
        _update_array(h, np.asarray(pat, dtype=np.float64))
    return _hexdigest(h)


def allocation_signature(alloc) -> str:
    """Signature of an :class:`repro_torch.core.Allocation` (machine + the
    exact set AND order of allocated coordinate rows — allocation order
    is the identity-mapping baseline, so it is part of the problem)."""
    h = _hasher()
    h.update(b"allocation")
    h.update(machine_signature(alloc.machine).encode())
    _update_array(h, np.asarray(alloc.coords))
    return _hexdigest(h)


def mapping_signature(graph, alloc, config=None,
                      extra: dict | None = None) -> str:
    """Signature of a full mapping problem: task graph + allocation +
    pipeline config (+ optional extra fields, e.g. per-request task
    coordinate overrides)."""
    h = _hasher()
    h.update(b"mapping")
    h.update(taskgraph_signature(graph).encode())
    h.update(allocation_signature(alloc).encode())
    if config is not None:
        h.update(config_signature(config).encode())
    if extra:
        h.update(json.dumps(_canonical(extra), sort_keys=True).encode())
    return _hexdigest(h)
