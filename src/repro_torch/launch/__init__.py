"""repro_torch.launch — production device meshes (:mod:`.mesh`)."""

from .mesh import make_production_mesh, make_topology_mesh

__all__ = ["make_production_mesh", "make_topology_mesh"]
