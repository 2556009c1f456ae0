"""repro_torch.hier — the recursive hierarchical mapping subsystem.

The paper maps multicore machines at *node* granularity: intra-node
communication is free (§2), so partitioning one point per core only
multiplies the partitioner's work by cores_per_node without improving
the mapping.  This package runs an N-level recursive coarsen* -> map ->
refine/expand* stack over the mapping pipeline:

1. :mod:`.spec` — :class:`HierarchySpec`, the structured description of
   the hierarchy: ordered :class:`Level` entries (name, arity,
   per-level refinement budgets and mode), with ``flat()`` / ``node()``
   / ``with_depth(n)`` / ``from_machine()`` / ``from_string()``
   constructors;
2. :mod:`.aggregate` — contract the task graph one level at a time into
   geometric clusters (labels from the pipeline's partition engine,
   weighted centroids + summed message volumes as host segment sums);
3. :mod:`.levels` — group the machine side to match (routers, then
   medoid-represented groups of routers), run the pipeline's batched
   rotation sweep ONCE at the top granularity (the one-pass device
   sweep, which also refines a ``swap`` top level, when the backends
   allow it), and expand downward level by level;
4. :mod:`.refine` — per-level refinement (``refine_swaps``: the bounded
   monotone greedy pass; ``refine_qap``: sparse-QAP local search with
   gain-bucket ordering), ``assign_cores`` expansion in intra-group SFC
   order, and ``polish_groups``: the exact-delta intra-group polish
   every group expansion runs before the level's bounded refinement.

Every entry point defaults to the card (``device="cuda"``, the device
partitioner, the mapscore kernel for a latency objective); a CPU caller
asks for the CPU (``device="cpu"`` with ``score_backend="torch"`` or
``"numpy"``).

Select it with ``PipelineConfig(hierarchy=HierarchySpec.node())`` /
``.with_depth(3)`` / ``.from_machine(machine, depth)``; the strings
``"flat"`` / ``"node"`` remain as deprecated aliases and ``"depth<N>"``
as sugar.
"""

from .aggregate import Aggregation, aggregate_tasks
from .levels import group_units, map_hierarchical, router_view
from .refine import (assign_cores, hilbert_key, polish_groups, refine_qap,
                     refine_swaps)
from .spec import HierarchySpec, Level, normalize_config_hierarchy

__all__ = [
    "Aggregation", "HierarchySpec", "Level", "aggregate_tasks",
    "assign_cores", "group_units", "hilbert_key", "map_hierarchical",
    "normalize_config_hierarchy", "polish_groups", "refine_qap",
    "refine_swaps", "router_view",
]
