"""Mesh mapping (``repro_torch.meshmap``, ``repro_torch.launch.mesh``)
against the reference (``repro.meshmap``) on the CPU.

Every problem is built once with the reference's constructors and
carried over with ``compat``.  Winners (``task_to_proc``) and mesh rank
orders are compared bit for bit — the port with the torch scorer and the
device partitioner on ``device="cpu"``, and with the all-host numpy path,
against the reference's numpy path; the metrics of a winner come from the
same numpy router on both sides and are held to ``rtol=1e-12``, and so is
``collective_term``.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as R
from repro.meshmap import collective_model as RC
from repro.meshmap import device_mesh as RD
from repro.serve import MappingService as RService
from repro_torch import compat
from repro_torch.core import identity_mapping
from repro_torch.core.mapping import MappingResult
from repro_torch.launch import mesh as launch_mesh
from repro_torch.meshmap import (DEFAULT_AXIS_BYTES, MeshLayout,
                                 collective_term, compare_mappings,
                                 device_coords, machine_for, select_mapping,
                                 split_axis_bytes, topology_mesh)
from repro_torch.serve import MappingService

RTOL = 1e-12
PATHS = {"torch": dict(score_backend="torch", partition_backend="torch",
                       device="cpu"),
         "numpy": dict(score_backend="numpy", partition_backend="numpy",
                       device="cpu")}


def _problem(machine, coords, shape, weights, names=None):
    """(reference graph, alloc) and the port's copies."""
    rg = R.logical_mesh_graph(shape, weights, names)
    ra = R.Allocation(machine, coords)
    return (rg, ra), (compat.taskgraph(rg), compat.allocation(ra))


def _metrics_close(a, b):
    """Equal keys; every number (``per_dim``'s nested ones too) within
    ``RTOL``."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _metrics_close(a[k], b[k])
        else:
            assert np.isclose(a[k], b[k], rtol=RTOL, atol=0), (k, a[k], b[k])


# ---------------------------------------------------------------------------
# collective model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,sizes,weights", [
    (100.0, (16, 16), (1.0, 3.0)), (100.0, (1, 16), (1.0, 3.0)),
    (64.0, (2, 16, 16), None), (5.0, (1, 1), (2.0, 2.0))])
def test_split_axis_bytes_equals_reference(total, sizes, weights):
    got = split_axis_bytes(total, sizes, axis_weights=weights)
    assert got == RC.split_axis_bytes(total, sizes, axis_weights=weights)


def test_split_axis_bytes_proportional():
    assert split_axis_bytes(100.0, (16, 16), axis_weights=(1.0, 3.0)) == \
        [25.0, 75.0]
    # size-1 axes carry no collectives
    assert split_axis_bytes(100.0, (1, 16), axis_weights=(1.0, 3.0)) == \
        [0.0, 100.0]


def _collective_cases():
    axis_bytes = (1e9, 8e9)
    m = R.tpu_v5e_pod(8)
    yield "contiguous", R.Allocation(m, m.all_coords()), axis_bytes
    ms = R.make_machine((16, 16), wrap=True, bw=50.0)
    for seed in (1, 3):
        yield (f"fragmented{seed}",
               R.sfc_allocation(ms, 64, nfragments=4, seed=seed), axis_bytes)


@pytest.mark.parametrize("case", [c[0] for c in _collective_cases()])
def test_collective_term_equals_reference(case):
    _, ra, axis_bytes = next(c for c in _collective_cases() if c[0] == case)
    rg = R.logical_mesh_graph((8, 8), axis_bytes)
    a = compat.allocation(ra)
    g = compat.taskgraph(rg)
    want = RC.collective_term(ra, (8, 8), R.identity_mapping(rg, ra),
                              axis_bytes)
    got = collective_term(a, (8, 8), identity_mapping(g, a), axis_bytes)
    assert np.isclose(got, want, rtol=RTOL, atol=0)
    # a scrambled order: the term follows the mapping
    perm = np.random.default_rng(0).permutation(64)
    want = RC.collective_term(ra, (8, 8), R.MappingResult(perm), axis_bytes)
    got = collective_term(a, (8, 8), MappingResult(perm), axis_bytes)
    assert np.isclose(got, want, rtol=RTOL, atol=0)


def test_fragmented_allocation_dilates_term():
    cases = {c[0]: c for c in _collective_cases()}
    terms = {}
    for name in ("contiguous", "fragmented3"):
        _, ra, axis_bytes = cases[name]
        a = compat.allocation(ra)
        g = compat.taskgraph(R.logical_mesh_graph((8, 8), axis_bytes))
        terms[name] = collective_term(a, (8, 8), identity_mapping(g, a),
                                      axis_bytes)
    assert terms["fragmented3"] > terms["contiguous"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_compare_mappings_equals_reference(path):
    axis_bytes = (1e9, 8e9)
    ms = R.make_machine((16, 16), wrap=True, bw=50.0)
    ra = R.sfc_allocation(ms, 64, nfragments=4, seed=1)
    (rg, ra), (g, a) = _problem(ms, ra.coords, (8, 8), axis_bytes)
    rbest, _, _ = RD.select_mapping(rg, ra, axis_bytes, rotations=2)
    best, _, _ = select_mapping(g, a, axis_bytes, rotations=2, **PATHS[path])
    np.testing.assert_array_equal(best.task_to_proc, rbest.task_to_proc)
    want = RC.compare_mappings(ra, (8, 8), axis_bytes,
                               {"default": R.identity_mapping(rg, ra),
                                "mapped": rbest})
    got = compare_mappings(a, (8, 8), axis_bytes,
                           {"default": identity_mapping(g, a),
                            "mapped": best})
    assert list(got) == ["default", "mapped"]
    for k in want:
        assert np.isclose(got[k], want[k], rtol=RTOL, atol=0)
    assert got["mapped"] <= got["default"] * 1.001


# ---------------------------------------------------------------------------
# select_mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shape", [(8, 8), (4, 16), (16, 4)])
def test_select_mapping_equals_reference(shape, path):
    m = R.tpu_v5e_pod(8)
    w = (8.0, 64.0)
    (rg, ra), (g, a) = _problem(m, m.all_coords(), shape, w)
    rbest, rours, rbase = RD.select_mapping(rg, ra, w, rotations=4)
    best, ours, base = select_mapping(g, a, w, rotations=4, **PATHS[path])
    np.testing.assert_array_equal(best.task_to_proc, rbest.task_to_proc)
    assert best.rotation == rbest.rotation
    _metrics_close(ours, rours)
    _metrics_close(base, rbase)
    assert ours["latency_max"] <= base["latency_max"] + 1e-9


@pytest.mark.parametrize("path", sorted(PATHS))
def test_select_mapping_through_the_service_cache(path):
    machine = R.tpu_v5e_pod(side=4)
    (rg, ra), (g, a) = _problem(machine, machine.all_coords(), (4, 4),
                                (8.0, 64.0), ("data", "model"))
    rbest, rm, _ = RD.select_mapping(rg, ra, [8.0, 64.0], rotations=4,
                                     service=RService(capacity=32))
    svc = MappingService(capacity=32)
    best1, m1, _ = select_mapping(g, a, [8.0, 64.0], rotations=4,
                                  service=svc, **PATHS[path])
    s1 = svc.stats()
    assert s1["cold"] == 4 and s1["warm"] == 0
    best2, m2, _ = select_mapping(g, a, [8.0, 64.0], rotations=4,
                                  service=svc, **PATHS[path])
    s2 = svc.stats()
    assert s2["cold"] == 4 and s2["warm"] == 4  # the repeat is all warm
    np.testing.assert_array_equal(best1.task_to_proc, best2.task_to_proc)
    np.testing.assert_array_equal(best1.task_to_proc, rbest.task_to_proc)
    assert m1 == m2
    _metrics_close(m1, rm)
    assert s2["degraded"] == s2["rung_failures"] == 0


def test_select_mapping_refuses_the_kernel_on_the_cpu():
    machine = R.tpu_v5e_pod(side=4)
    _, (g, a) = _problem(machine, machine.all_coords(), (4, 4), (8.0, 64.0))
    with pytest.raises(ValueError, match="hopper"):
        select_mapping(g, a, [8.0, 64.0], rotations=2, device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (select_mapping, topology_mesh):
        params = inspect.signature(fn).parameters
        assert params["score_backend"].default == "hopper", fn.__name__
        assert params["partition_backend"].default == "torch", fn.__name__
        assert params["device"].default == "cuda", fn.__name__


# ---------------------------------------------------------------------------
# topology_mesh and the production meshes
# ---------------------------------------------------------------------------

def test_machine_for_and_device_coords_equal_reference():
    for pods, side in ((1, 16), (2, 16), (1, 4)):
        m = machine_for(pods=pods, side=side)
        rm = RD.machine_for(pods=pods, side=side)
        assert m == compat.machine(rm)
        n = 2 * side
        np.testing.assert_array_equal(
            device_coords(range(n), m),
            RD.device_coords([object()] * n, rm))
    assert DEFAULT_AXIS_BYTES == RD.DEFAULT_AXIS_BYTES


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_topology_mesh_ranks_are_the_reference_winner(multi_pod, path):
    layout, report = launch_mesh.make_topology_mesh(
        multi_pod=multi_pod, return_report=True, **PATHS[path])
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert layout.ranks.shape == shape and layout.ranks.dtype == np.int64
    assert layout.axis_names == names
    # the reference's search on the same graph and allocation
    rm = RD.machine_for(pods=2 if multi_pod else 1, side=16)
    ab = [RD.DEFAULT_AXIS_BYTES[a] for a in names]
    n = int(np.prod(shape))
    rg = R.logical_mesh_graph(shape, tuple(ab), names)
    ra = R.Allocation(rm, RD.device_coords([object()] * n, rm).astype(int))
    rbest, rours, rbase = RD.select_mapping(rg, ra, ab, rotations=8)
    np.testing.assert_array_equal(layout.ranks,
                                  rbest.task_to_proc.reshape(shape))
    _metrics_close(report["mapped"], rours)
    _metrics_close(report["default"], rbase)
    assert report["mapped"]["latency_max"] <= \
        report["default"]["latency_max"] + 1e-9


def test_topology_mesh_lays_out_the_ranks_given():
    ranks = list(range(100, 116))
    layout = topology_mesh((4, 4), ("data", "model"), devices=ranks,
                           rotations=4, **PATHS["torch"])
    plain = topology_mesh((4, 4), ("data", "model"), rotations=4,
                          **PATHS["torch"])
    np.testing.assert_array_equal(layout.ranks, plain.ranks + 100)
    with pytest.raises(ValueError, match="need 16 devices"):
        topology_mesh((4, 4), ("data", "model"), devices=range(8),
                      **PATHS["torch"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_enumeration(multi_pod):
    layout = launch_mesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    np.testing.assert_array_equal(
        layout.ranks, np.arange(np.prod(shape)).reshape(shape))
    assert len(layout.axis_names) == len(shape)


def test_device_mesh_on_a_gloo_group_of_one():
    layout = MeshLayout(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        layout.device_mesh("cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = layout.device_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.tolist() == [[0]]
        wide = MeshLayout(np.arange(2, dtype=np.int64).reshape(1, 2),
                          ("data", "model"))
        with pytest.raises(RuntimeError, match="2 ranks"):
            wide.device_mesh("cpu")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    assert torch.as_tensor(layout.ranks).dtype == torch.int64
