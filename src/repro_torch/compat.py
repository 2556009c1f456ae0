"""Carry a mapping problem over from the reference package.

The system has no weights; its state is the request.  These converters
turn the reference package's objects into this package's by READING
THEIR ATTRIBUTES as numpy arrays and plain Python values — the
reference package is never imported here, so anything with the same
attribute names converts (duck typing).  Tests build every problem once
through the reference's constructors, convert, and run both.

Backend names translate (``"pallas"`` -> ``"hopper"``, ``"jax"`` ->
``"torch"``); ``partition_backend="jax"`` is refused until the device
partitioner is part of this package; ``device`` has no counterpart in
the reference and is supplied by the caller.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.machine import Allocation, Machine
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.hier.spec import HierarchySpec, Level
from repro_torch.mapping.pipeline import PipelineConfig
from repro_torch.serve.engine import MappingRequest

SCORE_BACKEND_NAMES = {"numpy": "numpy", "jax": "torch", "pallas": "hopper"}


def machine(ref) -> Machine:
    return Machine(
        dims=tuple(int(d) for d in ref.dims),
        wrap=tuple(bool(w) for w in ref.wrap),
        link_bw=tuple(np.array(p, dtype=np.float64) for p in ref.link_bw),
        name=str(ref.name),
        core_dims=int(ref.core_dims))


def allocation(ref) -> Allocation:
    return Allocation(machine(ref.machine), np.array(ref.coords))


def taskgraph(ref) -> TaskGraph:
    return TaskGraph(np.array(ref.coords), np.array(ref.edges),
                     np.array(ref.weights), meta=dict(ref.meta))


def level(ref) -> Level:
    return Level(
        name=str(ref.name),
        arity=None if ref.arity is None else int(ref.arity),
        refine_rounds=int(ref.refine_rounds),
        refine_top=int(ref.refine_top),
        refine_degree=int(ref.refine_degree),
        refine_mode=str(ref.refine_mode),
        polish_rounds=int(ref.polish_rounds))


def hierarchy(ref) -> HierarchySpec:
    return HierarchySpec(tuple(level(lv) for lv in ref.levels))


def pipeline_config(ref, *, device: str = "cuda") -> PipelineConfig:
    """Field for field; backend names translated, ``device`` added."""
    if ref.score_backend not in SCORE_BACKEND_NAMES:
        raise ValueError(f"unknown score backend {ref.score_backend!r}")
    if ref.partition_backend != "numpy":
        raise ValueError(
            f"partition_backend={ref.partition_backend!r} has no "
            "counterpart yet: the device partitioner belongs to a later "
            "slice of the PyTorch port")
    objective = ref.objective if isinstance(ref.objective, str) \
        else tuple(ref.objective)
    return PipelineConfig(
        sfc=ref.sfc, mfz=ref.mfz, shift=bool(ref.shift),
        bandwidth_scale=bool(ref.bandwidth_scale),
        box=None if ref.box is None else tuple(ref.box),
        box_outer_weight=float(ref.box_outer_weight),
        drop=tuple(ref.drop), rotations=int(ref.rotations),
        uneven_prime=bool(ref.uneven_prime),
        longest_dim=bool(ref.longest_dim), backend=ref.backend,
        partition_backend="numpy", fused=ref.fused, objective=objective,
        sweep=ref.sweep,
        score_backend=SCORE_BACKEND_NAMES[ref.score_backend],
        hierarchy=hierarchy(ref.hierarchy),
        device=device)


def mapping_request(ref, *, device: str = "cuda") -> MappingRequest:
    return MappingRequest(
        taskgraph(ref.graph), allocation(ref.alloc),
        pipeline_config(ref.config, device=device),
        task_coords=None if ref.task_coords is None
        else np.array(ref.task_coords),
        task_weights=None if ref.task_weights is None
        else np.array(ref.task_weights))
