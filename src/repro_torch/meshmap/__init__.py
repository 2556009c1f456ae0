"""repro_torch.meshmap — the paper's mapper applied to a device mesh.

- :mod:`repro_torch.meshmap.device_mesh` — :func:`select_mapping` (the
  candidate search over device orders of a logical mesh) and
  :func:`topology_mesh`, which turns its winner into a
  :class:`MeshLayout` of global ranks for
  ``torch.distributed.device_mesh.DeviceMesh``.
- :mod:`repro_torch.meshmap.collective_model` — the mapping-aware
  collective term: one step's per-axis collective bytes routed over the
  physical network through a device order.
"""

from .collective_model import (collective_term, compare_mappings,
                               split_axis_bytes)
from .device_mesh import (DEFAULT_AXIS_BYTES, MeshLayout, device_coords,
                          machine_for, select_mapping, topology_mesh)

__all__ = [
    "DEFAULT_AXIS_BYTES", "MeshLayout", "collective_term",
    "compare_mappings", "device_coords", "machine_for", "select_mapping",
    "split_axis_bytes", "topology_mesh",
]
