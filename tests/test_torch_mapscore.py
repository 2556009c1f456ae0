"""The port's scorers against the reference package, on the CPU.

The module that holds the CUDA kernel (``repro_torch.kernels.mapscore``)
runs its plain-torch version for CPU tensors; that version, the torch
scorer and the numpy evaluator of the port are held against the
reference's numpy evaluator AND against the reference's Pallas kernel in
interpret mode, on inputs made with numpy from a seed.

Tolerances: ``total_hops`` exact (integer sums); float metrics
``rtol=1e-4, atol=1e-4`` (the reference kernel sums in float32);
winners identical under both objectives.
"""

import importlib
import shutil

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.metrics as RM
import repro_torch.core.metrics as PM
from repro.kernels.mapscore.ops import evaluate_candidates_pallas
from repro_torch import compat, faults
from repro_torch.core.metrics_torch import (evaluate_candidates_torch,
                                            scoring_inputs)
from repro_torch.kernels.mapscore import kernel as ms_kernel
from repro_torch.kernels.mapscore import ops as ms_ops
from repro_torch.kernels.mapscore import ref as ms_ref
from repro_torch.mapping import CandidateSearch

RTOL = ATOL = 1e-4

# the five machine models of tests/test_batched.py::MACHINES
MACHINES = [
    R.make_machine((6,), wrap=True),
    R.make_machine((5, 4), wrap=False),
    R.make_machine((4, 5, 3), wrap=(True, False, True), bw=(2.0, 1.0, 4.0)),
    R.gemini_xk7(dims=(4, 4, 8), cores_per_node=2),
    R.tpu_v5e_multipod(2, 4),
]
OBJECTIVES = {"wh": ("weighted_hops",),
              "latency": ("latency_max", "weighted_hops")}


def _random_problem(machine, seed, ntasks=40, ne=120, nb=4):
    rng = np.random.default_rng(seed)
    stack = np.stack([
        np.stack([rng.integers(0, machine.dims[j], size=ntasks)
                  for j in range(machine.ndim)], axis=1)
        for _ in range(nb)])
    edges = rng.integers(0, ntasks, size=(ne, 2))
    w = rng.uniform(0.5, 2.0, size=ne)
    return stack, edges, w


def _winner(ev, keys):
    cols = [np.asarray(ev[k]) for k in keys]
    return int(np.lexsort(tuple(reversed(cols)))[0])


def _assert_scores_match(ref, got):
    assert set(ref) == set(got)
    assert np.array_equal(ref["total_hops"], got["total_hops"])
    assert got["total_hops"].dtype == np.int64
    assert np.array_equal(ref["average_hops"], got["average_hops"])
    for key in ref:
        assert np.allclose(ref[key], got[key], rtol=RTOL, atol=ATOL), key


def _port_scorers(machine):
    pm = compat.machine(machine)
    return {
        "numpy": lambda e, w, s, t: PM.evaluate_candidates(
            pm, e, w, s, traffic=t, backend="numpy", device="cpu"),
        "torch": lambda e, w, s, t: PM.evaluate_candidates(
            pm, e, w, s, traffic=t, backend="torch", device="cpu"),
        "torch-direct": lambda e, w, s, t: evaluate_candidates_torch(
            pm, e, w, s, traffic=t, device="cpu"),
        "hopper-on-cpu": lambda e, w, s, t: ms_ops.
        evaluate_candidates_hopper(pm, e, w, s, traffic=t, device="cpu"),
    }


@pytest.mark.parametrize("scorer", ["numpy", "torch", "torch-direct",
                                    "hopper-on-cpu"])
@pytest.mark.parametrize("traffic", [False, True], ids=["hops", "traffic"])
@pytest.mark.parametrize("mi", range(len(MACHINES)))
def test_scorers_match_reference_numpy(mi, traffic, scorer):
    machine = MACHINES[mi]
    stack, edges, w = _random_problem(machine, mi)
    ref = RM.evaluate_candidates_numpy(machine, edges, w, stack,
                                       traffic=traffic)
    got = _port_scorers(machine)[scorer](edges, w, stack, traffic)
    _assert_scores_match(ref, got)
    for keys in OBJECTIVES.values():
        if all(k in ref for k in keys):
            assert _winner(ref, keys) == _winner(got, keys)


@pytest.mark.parametrize("scorer", ["torch", "hopper-on-cpu"])
@pytest.mark.parametrize("mi", range(len(MACHINES)))
def test_scorers_match_reference_pallas_interpret(mi, scorer):
    machine = MACHINES[mi]
    stack, edges, w = _random_problem(machine, 31 * mi + 7)
    ref = evaluate_candidates_pallas(machine, edges, w, stack,
                                     traffic=True, interpret=True)
    got = _port_scorers(machine)[scorer](edges, w, stack, True)
    _assert_scores_match(ref, got)
    for keys in OBJECTIVES.values():
        assert _winner(ref, keys) == _winner(got, keys)


@pytest.mark.parametrize("scorer", ["torch", "hopper-on-cpu"])
def test_wrapped_torus_seams(scorer):
    """Messages crossing the wrap-around seam in both directions."""
    machine = R.make_machine((6, 5), wrap=(True, True))
    coords = np.array([[5, 4], [0, 0], [1, 1], [4, 3]])
    edges = np.array([[0, 1], [1, 0], [3, 2], [0, 3]])
    w = np.array([2.0, 3.0, 1.5, 2.5])
    ref = RM.evaluate_candidates_numpy(machine, edges, w, coords[None],
                                       traffic=True)
    got = _port_scorers(machine)[scorer](edges, w, coords[None], True)
    _assert_scores_match(ref, got)


@pytest.mark.parametrize("scorer", ["torch", "hopper-on-cpu"])
def test_zero_length_and_zero_weight_messages_are_exact(scorer):
    machine = R.make_machine((8, 8), wrap=True)
    rng = np.random.default_rng(3)
    stack = rng.integers(0, 8, size=(3, 30, 2))
    edges = np.array([[2, 5], [9, 4], [7, 21]])
    w = np.array([3.0, 2.0, 1.25])
    score = _port_scorers(machine)[scorer]
    base = score(edges, w, stack, True)
    # self-edges and zero-weight messages must change no output bit
    edges_p = np.concatenate([edges, [[0, 0], [1, 1], [3, 8], [6, 6]]])
    w_p = np.concatenate([w, [5.0, 0.0, 0.0, 0.0]])
    padded = score(edges_p, w_p, stack, True)
    for key in ("weighted_hops", "data_max", "latency_max"):
        assert np.array_equal(base[key], padded[key]), key
    # total_hops counts messages, not volume: only self-edges leave it
    selfpad = score(np.concatenate([edges, [[0, 0], [6, 6]]]),
                    np.concatenate([w, [5.0, 0.0]]), stack, True)
    for key in base:
        if key != "average_hops":
            assert np.array_equal(base[key], selfpad[key]), key


@pytest.mark.parametrize("scorer", ["numpy", "torch", "hopper-on-cpu"])
def test_hop_only_stack_may_omit_core_columns(scorer):
    machine = MACHINES[3]  # gemini: one core dim
    stack, edges, w = _random_problem(machine, 5)
    nd = machine.ndim - machine.core_dims
    score = _port_scorers(machine)[scorer]
    full = score(edges, w, stack, False)
    cut = score(edges, w, stack[..., :nd], False)
    for key in full:
        assert np.array_equal(full[key], cut[key]), key


@pytest.mark.parametrize("scorer", ["numpy", "torch", "hopper-on-cpu"])
def test_empty_inputs_score_zero(scorer):
    machine = MACHINES[2]
    stack, edges, w = _random_problem(machine, 1)
    score = _port_scorers(machine)[scorer]
    ev = score(edges[:0], w[:0], stack, True)
    assert all(np.array_equal(v, np.zeros(len(stack))) for v in ev.values())
    assert all(len(v) == 0 for v in score(edges, w, stack[:0], True).values())


def test_candidate_chunking_changes_nothing():
    machine = MACHINES[3]
    pm = compat.machine(machine)
    stack, edges, w = _random_problem(machine, 8, nb=5)
    whole = evaluate_candidates_torch(pm, edges, w, stack, traffic=True,
                                      device="cpu")
    for fn in (evaluate_candidates_torch,
               ms_ops.evaluate_candidates_hopper):
        parts = fn(pm, edges, w, stack, traffic=True, chunk_elems=1,
                   device="cpu")
        for key in whole:
            assert np.array_equal(whole[key], parts[key]), key
    assert ms_ops.candidate_chunk(pm, True, chunk_elems=1) == 1
    assert ms_ops.candidate_chunk(pm, False) == 0


def test_kernel_wrapper_on_cpu_tensors_is_the_plain_version():
    machine = compat.machine(MACHINES[3])
    stack, edges, w = _random_problem(machine, 2)
    cs, e, wt, inv_bw = scoring_inputs(machine, edges, w, stack, True, "cpu")
    kw = dict(dims=machine.dims, wrap=machine.wrap,
              core_dims=machine.core_dims, traffic=True)
    before = ms_ops.launch_count
    got = ms_ops.mapscore(cs, e, wt, inv_bw, **kw)
    want = ms_ref.mapscore_ref(cs, e, wt, inv_bw, **kw)
    assert ms_ops.launch_count == before  # the plain version never counts
    assert got["total_hops"].dtype == torch.int64
    assert got["weighted_hops"].dtype == torch.float64
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_workspace_layout_and_fixed_point_scale():
    dims, core = (32, 32, 32, 16), 1
    rows, off, total = ms_kernel.workspace_layout(dims, core)
    assert rows == [32 * 32 * 16] * 3
    assert off == [0, 2 * 33 * rows[0], 4 * 33 * rows[0]]
    assert total == 6 * 33 * rows[0]
    assert total * 8 > 232448  # far past one block's shared memory
    # no sum can reach 2**62: every message at the largest hop count
    for wsum in (1e-3, 1.0, 3.7e6, 2.0 ** 40):
        shift = ms_kernel.fixed_point_shift(wsum, dims, core)
        assert wsum * 96 * 2.0 ** shift < 2.0 ** 62
        assert wsum * 96 * 2.0 ** (shift + 2) >= 2.0 ** 62
    assert ms_kernel.fixed_point_shift(0.0, dims, core) == 0
    with pytest.raises(ValueError, match="finite"):
        ms_kernel.fixed_point_shift(float("inf"), dims, core)


@pytest.mark.parametrize("objective", ["weighted_hops",
                                       ("latency_max", "weighted_hops")],
                         ids=["wh", "latency"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_candidate_search_winner_identical_to_reference(objective, backend):
    from repro.mapping import CandidateSearch as RSearch
    from repro.mapping import MappingPipeline as RPipe
    from repro.mapping import PipelineConfig as RConfig
    from repro.mapping.candidates import rotation_candidates
    machine = R.tpu_v5e_multipod(2, 4)
    alloc = R.block_allocation(machine)
    g = R.stencil_graph((4, 8))
    pipe = RPipe(RConfig(sfc="FZ", rotations=10))
    pc = pipe.machine_coords(alloc)
    cands = rotation_candidates(2, pc.shape[1], 10)
    results = pipe.map_candidates(g.coords.astype(float), pc, cands)
    _, i_ref, s_ref = RSearch(objective, backend="numpy").best(
        g, alloc, results)
    _, i_port, s_port = CandidateSearch(
        objective, backend=backend, device="cpu").best(
        compat.taskgraph(g), compat.allocation(alloc), results)
    assert i_port == i_ref
    assert np.allclose(s_ref, s_port, rtol=RTOL, atol=ATOL)


def test_backend_resolution_has_no_fallback():
    with pytest.raises(ValueError, match="cannot.*run on device 'cpu'"):
        PM.get_evaluator("hopper", "cpu")
    with pytest.raises(ValueError, match="unknown scoring backend"):
        PM.get_evaluator("pallas", "cpu")
    with pytest.raises(ValueError, match="unknown scoring backend"):
        PM.get_evaluator("jax", "cpu")
    with pytest.raises(ValueError, match="unknown scoring backend"):
        PM.evaluate_candidates(None, None, None, None, backend="cupy",
                               device="cpu")
    assert PM.get_evaluator("torch", "cpu")[0] == "torch"
    assert PM.get_evaluator("numpy", "cpu")[0] == "numpy"


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal cannot be shown")
    for backend in PM.SCORE_BACKENDS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.get_evaluator(backend, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CandidateSearch("weighted_hops")  # the defaults ask for the card


def test_score_fault_sites_fire():
    machine = compat.machine(MACHINES[1])
    stack, edges, w = _random_problem(machine, 0)
    for site, call in (
            ("score.torch", lambda: PM.evaluate_candidates(
                machine, edges, w, stack, backend="torch", device="cpu")),
            ("score.numpy", lambda: PM.evaluate_candidates(
                machine, edges, w, stack, backend="numpy", device="cpu")),
            ("kernel.mapscore", lambda: ms_ops.evaluate_candidates_hopper(
                machine, edges, w, stack, device="cpu"))):
        with faults.injected(site, "error", count=1) as spec:
            with pytest.raises(faults.InjectedFault):
                call()
            assert spec.fired == 1
        call()  # dormant again


def test_kernel_modules_import_without_toolchain():
    """Importing binds nothing: no nvcc, no GPU, no triton needed."""
    for name in ("repro_torch.kernels", "repro_torch.kernels._build",
                 "repro_torch.kernels.mapscore",
                 "repro_torch.kernels.mapscore.kernel",
                 "repro_torch.kernels.mapscore.ops",
                 "repro_torch.kernels.mapscore.ref",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.ref"):
        importlib.import_module(name)
    from repro_torch.kernels import _build
    srcs = [p.name for p in _build.sources()]
    assert srcs == ["flash_attention.cu", "mapscore.cu"]
    assert _build.build_info() == {} or "path" in _build.build_info()
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        with pytest.raises(_build.KernelBuildFailure, match="nvcc not found"):
            _build.find_nvcc()
