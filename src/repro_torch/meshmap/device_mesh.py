"""Topology-aware device meshes — the paper's technique as a framework
feature.

The logical mesh (e.g. ("pod", "data", "model")) is the *task graph*:
a training step runs collectives along each axis, with very different
traffic weights (tensor-parallel all-reduces on "model" >> data-parallel
gathers on "data" >> cross-pod traffic on "pod").  The physical devices
form the *machine graph*.  The geometric mapper (MJ + FZ ordering,
Alg. 1) orders both consistently and hands back the device permutation
that puts heavy-traffic logical neighbours on adjacent devices.

A GPU exposes no torus coordinates (the reference's TPU branch reads
``device.coords``), so devices get the machine model's coordinates in
enumeration order, and the mesh is a :class:`MeshLayout` of global
ranks: ``MeshLayout.device_mesh()`` builds the
``torch.distributed.device_mesh.DeviceMesh`` over them once a process
group of that size exists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (Allocation, block_allocation, evaluate,
                              identity_mapping, logical_mesh_graph,
                              tpu_v5e_multipod, tpu_v5e_pod)
from repro_torch.mapping import (CandidateSearch, PipelineConfig,
                                 shared_pipeline)

# Relative per-link traffic of one training step along each logical axis
# (bytes are arbitrary units; only ratios steer the mapper).
DEFAULT_AXIS_BYTES = {"pod": 1.0, "data": 8.0, "model": 64.0}


def machine_for(devices=None, *, pods: int = 1, side: int = 16):
    if pods > 1:
        return tpu_v5e_multipod(npods=pods, side=side)
    return tpu_v5e_pod(side=side)


def device_coords(devices, machine) -> np.ndarray:
    """Physical coordinates per device: the machine model's, in
    enumeration order (a GPU reports no torus coordinates, so the
    reference's ``device.coords`` branch has no counterpart here)."""
    return block_allocation(machine).coords[: len(devices)].astype(float)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A device mesh as global ranks.

    ranks      : int64 array of shape ``axis_sizes``; entry ``i`` is the
                 global rank that holds logical mesh position ``i``.
    axis_names : one name per axis.
    """

    ranks: np.ndarray
    axis_names: tuple

    @property
    def devices(self) -> np.ndarray:
        """The ranks, as ``jax.sharding.Mesh.devices`` holds the devices:
        what the sharding rules read the axis sizes from."""
        return self.ranks

    def device_mesh(self, device_type: str = "cuda"):
        """The ``torch.distributed.device_mesh.DeviceMesh`` over
        :attr:`ranks`.  Raises unless ``torch.distributed`` is
        initialised with a world of exactly ``ranks.size`` processes."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MeshLayout.device_mesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if world != self.ranks.size:
            raise RuntimeError(f"mesh of {self.ranks.size} ranks, process "
                               f"group of {world}")
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh(device_type, torch.as_tensor(self.ranks),
                          mesh_dim_names=tuple(self.axis_names))


def topology_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...],
                  *, devices=None, machine=None, axis_bytes=None,
                  rotations: int = 16, return_report: bool = False,
                  score_backend: str = "hopper",
                  partition_backend: str = "torch",
                  hierarchy="flat", sfc: str = "FZ", service=None,
                  device="cuda"):
    """Build a :class:`MeshLayout` whose device order minimises modeled
    link traffic.

    Candidate selection (the paper's §4.3 rotation search, generalised):
    the default enumeration plus FZ geometric mappings under two
    task-coordinate scalings (raw indices and traffic-weighted 1/bytes
    extents) x dimension rotations, every candidate scored with the
    Latency(M)/WeightedHops model (:func:`select_mapping`; K1 on
    ``device`` by default).  The result is never worse than the
    enumeration order.

    ``devices``: the global ranks to lay out (default ``range(n)``).
    Returns the layout (and optionally a report comparing the winner vs
    the default enumeration).
    """
    n = int(np.prod(axis_sizes))
    devices = list(range(n) if devices is None else devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    if machine is None:
        pods = axis_sizes[axis_names.index("pod")] \
            if "pod" in axis_names else 1
        side = int(round((n // max(pods, 1)) ** 0.5))
        machine = machine_for(pods=pods, side=side)
    ab = axis_bytes or [DEFAULT_AXIS_BYTES.get(a, 8.0) for a in axis_names]
    graph = logical_mesh_graph(axis_sizes, tuple(ab), tuple(axis_names))
    alloc = Allocation(machine, device_coords(devices, machine).astype(int))
    best, best_metrics, base_metrics = select_mapping(
        graph, alloc, ab, rotations=rotations, score_backend=score_backend,
        partition_backend=partition_backend, hierarchy=hierarchy,
        sfc=sfc, service=service, device=device)
    order = best.task_to_proc  # logical flat index -> device index
    ranks = np.asarray(devices, dtype=np.int64)[order].reshape(axis_sizes)
    layout = MeshLayout(ranks, tuple(axis_names))
    if not return_report:
        return layout
    return layout, {"mapped": best_metrics, "default": base_metrics}


def select_mapping(graph, alloc, axis_bytes, *, rotations: int = 16,
                   score_backend: str = "hopper",
                   partition_backend: str = "torch",
                   hierarchy="flat", sfc: str = "FZ",
                   service=None, device="cuda"):
    """Candidate search: default order + SFC-geometric mappings (``sfc``
    picks the part numbering — "FZ" is the paper's winner, "H" the
    Hilbert curve) under raw and traffic-scaled task coordinates x
    rotations; returns (best MappingResult, best metrics, default
    metrics).

    Each (scaling, rotation-budget) entry is one ``MappingPipeline.map``
    call (the device partitioner and, with a "torch"/"hopper" scorer,
    the one-pass fused sweep on ``device``), and the outer selection
    scores every candidate in one batched (Latency(M), WeightedHops)
    pass: ``score_backend="hopper"`` (default) through the CUDA kernel
    of :mod:`repro_torch.kernels.mapscore`, ``"torch"`` through the
    plain tensor scorer, ``"numpy"`` on the host.  Nothing falls back:
    a backend or device that cannot run raises.  The identity/default
    mapping is listed first, so on ties the search is never worse than
    the enumeration order.

    ``hierarchy`` takes a :class:`repro_torch.hier.HierarchySpec` and
    routes each pipeline call through :mod:`repro_torch.hier`.
    Pipelines come from the process-wide :func:`shared_pipeline`
    registry.  Passing a :class:`repro_torch.serve.MappingService` as
    ``service`` serves each candidate pipeline pass through its
    content-addressed result cache, so REPEAT mesh builds skip the
    geometric search entirely.
    """
    candidates = [identity_mapping(graph, alloc)]
    for scaled in (False, True):
        tc = graph.coords.astype(float)
        if scaled:
            tc = tc / np.asarray(axis_bytes, dtype=float)
        for rot in (0, rotations):
            config = PipelineConfig(
                sfc=sfc, shift=True, bandwidth_scale=True, rotations=rot,
                score_backend=score_backend,
                partition_backend=partition_backend, hierarchy=hierarchy,
                device=device)
            if service is not None:
                from repro_torch.serve.engine import MappingRequest
                resp = service.map(MappingRequest(graph, alloc, config,
                                                  task_coords=tc))
                candidates.append(resp.result)
            else:
                candidates.append(shared_pipeline(config).map(
                    graph, alloc, task_coords=tc))
    search = CandidateSearch(objective=("latency_max", "weighted_hops"),
                             backend=score_backend, device=device)
    best, _, _ = search.best(graph, alloc, candidates)
    best_metrics = evaluate(graph, alloc, best)
    base_metrics = evaluate(graph, alloc, candidates[0])
    return best, best_metrics, base_metrics
