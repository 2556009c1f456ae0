"""Core: the paper's geometric task-mapping contribution.

Public API re-exports.
"""

from .kmeans import closest_subset
from .machine import (Allocation, Machine, bgq, block_allocation,
                      gemini_xk7, make_machine, random_allocation,
                      sfc_allocation, tpu_v4_cube, tpu_v5e_multipod,
                      tpu_v5e_pod)
from .mapping import (Mapper, MapperConfig, MappingResult, evaluate,
                      geometric_map, identity_mapping)
from .metrics import (Traffic, average_hops, data_metric,
                      evaluate_candidates, evaluate_mapping, latency_metric,
                      pairwise_hops, per_dim_stats, route_traffic,
                      total_hops, weighted_hops)
from .signature import (allocation_signature, array_digest,
                        config_signature, machine_signature,
                        mapping_signature, taskgraph_signature)
from .orderings import (BACKENDS, SFC_KINDS, gray_decode, gray_encode,
                        grid_order, hilbert_index, hilbert_key,
                        order_points, order_points_batched,
                        order_points_recursive)
from .taskgraph import (TaskGraph, cube_coords, cube_sphere_graph,
                        face2d_coords, logical_mesh_graph, stencil_graph)
from .transforms import (apply_permutation, box_lift, drop_dims,
                         normalize_extents, permutations, scale_by_bandwidth,
                         shift_torus)

__all__ = [
    "Allocation", "BACKENDS", "Machine", "Mapper", "MapperConfig",
    "MappingResult", "SFC_KINDS", "TaskGraph", "Traffic",
    "allocation_signature", "array_digest",
    "apply_permutation", "average_hops", "bgq", "block_allocation",
    "box_lift", "closest_subset", "config_signature", "cube_coords",
    "cube_sphere_graph",
    "data_metric", "drop_dims", "evaluate", "evaluate_candidates",
    "evaluate_mapping", "face2d_coords", "gemini_xk7", "geometric_map",
    "gray_decode", "gray_encode", "grid_order", "hilbert_index",
    "hilbert_key", "identity_mapping", "latency_metric",
    "logical_mesh_graph",
    "machine_signature", "mapping_signature",
    "make_machine", "normalize_extents", "order_points",
    "order_points_batched", "order_points_recursive",
    "pairwise_hops", "per_dim_stats",
    "permutations", "random_allocation", "route_traffic",
    "scale_by_bandwidth", "sfc_allocation", "shift_torus",
    "stencil_graph", "taskgraph_signature", "total_hops",
    "tpu_v4_cube", "tpu_v5e_multipod",
    "tpu_v5e_pod", "weighted_hops",
]
