"""The port's host data model against the reference package.

Machines, allocations, task graphs, transforms, ``closest_subset`` and
the content signatures: every problem is built with numpy from a seed
through BOTH packages' constructors (or built once through the
reference's and carried over with ``repro_torch.compat``) and must come
out equal — arrays bit for bit, signatures string for string.
"""

import numpy as np
import pytest

import repro.core as R
import repro.core.signature as RS
import repro.core.transforms as RT
import repro_torch.core as P
import repro_torch.core.signature as PS
import repro_torch.core.transforms as PT
from repro.mapping import HierarchySpec as RSpec
from repro.mapping import PipelineConfig as RConfig
from repro_torch import compat

MACHINE_CTORS = [
    ("make_machine", dict(dims=(4, 5, 3), wrap=(True, False, True),
                          bw=(2.0, 1.0, 4.0))),
    ("gemini_xk7", dict(dims=(4, 4, 8), cores_per_node=2)),
    ("bgq", dict(dims=(2, 2, 2, 4, 2), cores_per_node=4)),
    ("tpu_v5e_pod", dict(side=8)),
    ("tpu_v5e_multipod", dict(npods=2, side=4)),
    ("tpu_v4_cube", dict(dims=(4, 4, 4))),
]


def _same_machine(a, b):
    assert tuple(a.dims) == tuple(b.dims)
    assert tuple(a.wrap) == tuple(b.wrap)
    assert a.core_dims == b.core_dims and a.name == b.name
    assert len(a.link_bw) == len(b.link_bw)
    for x, y in zip(a.link_bw, b.link_bw):
        assert np.array_equal(x, y)
    for k in range(a.ndim):
        assert np.array_equal(a.bw_field(k), b.bw_field(k))
    assert np.array_equal(a.all_coords(), b.all_coords())


@pytest.mark.parametrize("ctor,kw", MACHINE_CTORS,
                         ids=[c for c, _ in MACHINE_CTORS])
def test_machine_constructors_and_compat(ctor, kw):
    ref = getattr(R, ctor)(**kw)
    port = getattr(P, ctor)(**kw)
    _same_machine(ref, port)
    _same_machine(ref, compat.machine(ref))
    assert RS.machine_signature(ref) == PS.machine_signature(port)
    assert PS.machine_signature(compat.machine(ref)) == \
        PS.machine_signature(port)
    assert port.cores_per_node == ref.cores_per_node
    assert port.network_ndim == ref.network_ndim


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["sfc1", "sfc8", "random", "block"])
def test_allocations_equal(kind, seed):
    kw = dict(dims=(4, 4, 8), cores_per_node=4)
    rm, pm = R.gemini_xk7(**kw), P.gemini_xk7(**kw)
    if kind == "sfc1":
        ra = R.sfc_allocation(rm, 100, seed=seed)
        pa = P.sfc_allocation(pm, 100, seed=seed)
    elif kind == "sfc8":
        ra = R.sfc_allocation(rm, 200, nfragments=8, seed=seed)
        pa = P.sfc_allocation(pm, 200, nfragments=8, seed=seed)
    elif kind == "random":
        ra = R.random_allocation(rm, 77, seed=seed)
        pa = P.random_allocation(pm, 77, seed=seed)
    else:
        ra = R.block_allocation(rm, (2, 3 + seed, 4))
        pa = P.block_allocation(pm, (2, 3 + seed, 4))
    assert np.array_equal(ra.coords, pa.coords)
    assert ra.n == pa.n
    conv = compat.allocation(ra)
    assert np.array_equal(conv.coords, pa.coords)
    assert RS.allocation_signature(ra) == PS.allocation_signature(pa) \
        == PS.allocation_signature(conv)


GRAPHS = [
    ("stencil_graph", ((4, 6, 5),), dict(torus=False)),
    ("stencil_graph", ((8, 8),), dict(torus=True)),
    ("cube_sphere_graph", (4,), {}),
    ("logical_mesh_graph", ((2, 4, 4), (1.0, 8.0, 2.0)), {}),
]


@pytest.mark.parametrize("ctor,args,kw", GRAPHS,
                         ids=[f"{c}{i}" for i, (c, _, _) in enumerate(GRAPHS)])
def test_taskgraphs_equal(ctor, args, kw):
    rg = getattr(R, ctor)(*args, **kw)
    pg = getattr(P, ctor)(*args, **kw)
    conv = compat.taskgraph(rg)
    for g in (pg, conv):
        assert np.array_equal(rg.coords, g.coords)
        assert np.array_equal(rg.edges, g.edges)
        assert np.array_equal(rg.weights, g.weights)
        assert rg.n == g.n
    assert RS.taskgraph_signature(rg) == PS.taskgraph_signature(pg) \
        == PS.taskgraph_signature(conv)


def test_cube_sphere_coordinate_transforms_equal():
    assert np.array_equal(R.cube_coords(3), P.cube_coords(3))
    assert np.array_equal(R.face2d_coords(3), P.face2d_coords(3))


@pytest.mark.parametrize("seed", range(3))
def test_machine_transforms_equal(seed):
    kw = dict(dims=(4, 6, 8), cores_per_node=2)
    rm, pm = R.gemini_xk7(**kw), P.gemini_xk7(**kw)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.integers(0, d, size=50) for d in (4, 6, 8)],
                   axis=1).astype(np.float64)
    assert np.array_equal(RT.shift_torus(pts, rm), PT.shift_torus(pts, pm))
    assert np.array_equal(RT.scale_by_bandwidth(pts, rm),
                          PT.scale_by_bandwidth(pts, pm))
    assert np.array_equal(RT.box_lift(pts, (2, 2, 4), outer_weight=16.0),
                          PT.box_lift(pts, (2, 2, 4), outer_weight=16.0))
    assert np.array_equal(RT.drop_dims(pts, (1,)), PT.drop_dims(pts, (1,)))
    assert np.array_equal(RT.apply_permutation(pts, (2, 0, 1)),
                          PT.apply_permutation(pts, (2, 0, 1)))
    assert np.array_equal(RT.normalize_extents(pts),
                          PT.normalize_extents(pts))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_permutations_equal(d):
    assert RT.permutations(d) == PT.permutations(d)


@pytest.mark.parametrize("seed", range(4))
def test_closest_subset_equal(seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((200, 3)) * 10
    k = int(rng.integers(5, 150))
    assert np.array_equal(R.closest_subset(pts, k), P.closest_subset(pts, k))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
def test_array_digest_equal(dtype):
    arr = np.arange(24, dtype=dtype).reshape(4, 6)
    assert RS.array_digest(arr) == PS.array_digest(arr)
    assert PS.array_digest(arr) != PS.array_digest(arr.T)


@pytest.mark.parametrize("hier", ["flat", "node", "depth3"])
@pytest.mark.parametrize("objective", ["weighted_hops",
                                       ("latency_max", "weighted_hops")],
                         ids=["wh", "latency"])
def test_config_signature_equal_after_compat(hier, objective):
    ref = RConfig(rotations=6, objective=objective, uneven_prime=True,
                  box=(2, 2), drop=(1,), score_backend="numpy",
                  hierarchy=RSpec.from_string(hier))
    port = compat.pipeline_config(ref, device="cpu")
    assert RS.config_signature(ref) == PS.config_signature(port)
    # the device is no part of the problem's identity
    assert PS.config_signature(port) == PS.config_signature(
        compat.pipeline_config(ref, device="cuda"))
    assert port.hierarchy.kind == ref.hierarchy.kind
    assert port.hierarchy.depth == ref.hierarchy.depth


def test_compat_translates_backend_names_and_rejects_device_partitioner():
    assert compat.pipeline_config(
        RConfig(score_backend="pallas"), device="cpu"
    ).score_backend == "hopper"
    assert compat.pipeline_config(
        RConfig(score_backend="jax"), device="cpu").score_backend == "torch"
    # the device partitioner has its counterpart now: "jax" -> "torch"
    assert compat.pipeline_config(
        RConfig(partition_backend="jax"), device="cpu"
    ).partition_backend == "torch"
    assert compat.pipeline_config(
        RConfig(), device="cpu").partition_backend == "numpy"


def test_mapping_signature_equal_after_compat():
    from repro.serve import make_request
    g = R.stencil_graph((4, 4, 4))
    a = R.sfc_allocation(R.gemini_xk7(dims=(4, 4, 4), cores_per_node=2),
                         64, nfragments=2, seed=1)
    w = np.linspace(1.0, 2.0, g.n)
    ref = make_request(g, a, "latency", rotations=4, task_weights=w)
    port = compat.mapping_request(ref, device="cpu")
    assert port.signature() == ref.signature()
    assert port.config.device == "cpu"
