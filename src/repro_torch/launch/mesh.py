"""Production meshes: single-pod 16x16 or 2-pod 2x16x16.

``make_production_mesh`` lays the global ranks out in enumeration order.
``make_topology_mesh`` is the same geometry built through the unified
``repro_torch.mapping`` pipeline (via
:func:`repro_torch.meshmap.topology_mesh`): candidate device orders come
from the Multi-Jagged partitioner and are scored in one batched
(Latency(M), WeightedHops) pass, so the order is never worse than the
enumeration.  Both return a :class:`repro_torch.meshmap.MeshLayout`;
nothing here touches a process group or a device until
``MeshLayout.device_mesh`` is called.
"""

from __future__ import annotations

import numpy as np


def _shape(multi_pod: bool):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    from repro_torch.meshmap.device_mesh import MeshLayout
    shape, axes = _shape(multi_pod)
    return MeshLayout(np.arange(int(np.prod(shape)),
                                dtype=np.int64).reshape(shape), axes)


def make_topology_mesh(*, multi_pod: bool = False, return_report=False,
                       axis_bytes=None, rotations: int = 8, **kw):
    """:func:`repro_torch.meshmap.topology_mesh` over the production
    shape; ``kw`` are its keyword arguments (``device``,
    ``score_backend``, ``partition_backend``, ``service``, ...)."""
    from repro_torch.meshmap.device_mesh import topology_mesh
    shape, axes = _shape(multi_pod)
    return topology_mesh(shape, axes, return_report=return_report,
                         axis_bytes=axis_bytes, rotations=rotations, **kw)
