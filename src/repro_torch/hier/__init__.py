"""repro_torch.hier — the hierarchical mapping subsystem.

Only the structured description of the hierarchy (:mod:`.spec`) is part
of this package so far: ``PipelineConfig`` validates and carries it, and
``MappingPipeline.map`` maps the flat spec.  Aggregation, level grouping
and refinement arrive with a later slice of the port.
"""

from .spec import HierarchySpec, Level, normalize_config_hierarchy

__all__ = ["HierarchySpec", "Level", "normalize_config_hierarchy"]
