"""Mapping-aware collective cost model.

The plain roofline collective term (bytes / link_bw) assumes every
collective runs at full per-link bandwidth — true only if each mesh
axis's rings map onto disjoint physical links.  This module refines the
term using the paper's machinery: per-device collective bytes are
attributed to logical mesh axes, laid onto the physical network through
a device mapping as ring traffic, routed with the paper's
dimension-ordered model, and the bottleneck link's Latency(M) (Eqn. 7)
becomes the mapping-aware collective term.

The same metric that scores MiniGhost/HOMME mappings scores device
orders for a training step's collectives.  Host numpy throughout.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (Allocation, MappingResult, latency_metric,
                              logical_mesh_graph, route_traffic)


def split_axis_bytes(total_bytes: float, axis_sizes, axis_weights=None):
    """Attribute a step's total collective bytes to mesh axes.

    Without per-op axis attribution, bytes are split proportionally to
    ``axis_weights`` (defaults to equal weights); size-1 axes carry no
    collectives.
    """
    axis_weights = axis_weights or [1.0] * len(axis_sizes)
    w = np.asarray(axis_weights, float)
    w = np.where(np.asarray(axis_sizes) > 1, w, 0.0)
    if w.sum() == 0:
        return [0.0] * len(axis_sizes)
    return list(total_bytes * w / w.sum())


def collective_term(alloc: Allocation, axis_sizes, mapping: MappingResult,
                    axis_bytes) -> float:
    """Seconds for the bottleneck link to carry one step's collectives.

    axis_bytes: bytes each device contributes along each mesh axis's
    ring (per step).  Ring traffic per link of an axis ~ the per-device
    bytes (each device forwards its share around the ring).
    """
    graph = logical_mesh_graph(tuple(axis_sizes), tuple(axis_bytes))
    coords = alloc.coords[mapping.task_to_proc]
    src = coords[graph.edges[:, 0]]
    dst = coords[graph.edges[:, 1]]
    traffic = route_traffic(alloc.machine, src, dst, graph.weights)
    return latency_metric(traffic) / 1e9  # bw in GB/s -> seconds


def compare_mappings(alloc: Allocation, axis_sizes, axis_bytes,
                     mappings: dict) -> dict:
    """Mapping-aware collective term for several device orders."""
    return {name: collective_term(alloc, axis_sizes, m, axis_bytes)
            for name, m in mappings.items()}
