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
    # (s_k, rows_k) per direction: no dump column
    assert off == [0, 2 * 32 * rows[0], 4 * 32 * rows[0]]
    assert total == 6 * 32 * rows[0]
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
                 "repro_torch.kernels.contract",
                 "repro_torch.kernels.contract.kernel",
                 "repro_torch.kernels.contract.ops",
                 "repro_torch.kernels.contract.ref",
                 "repro_torch.kernels.mapscore",
                 "repro_torch.kernels.mapscore.kernel",
                 "repro_torch.kernels.mapscore.ops",
                 "repro_torch.kernels.mapscore.ref",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.ssd",
                 "repro_torch.kernels.ssd.kernel",
                 "repro_torch.kernels.ssd.ops",
                 "repro_torch.kernels.ssd.ref",
                 "repro_torch.kernels.segscan",
                 "repro_torch.kernels.segscan.kernel",
                 "repro_torch.kernels.segscan.ops",
                 "repro_torch.kernels.segscan.ref",
                 "repro_torch.kernels.mjfinish",
                 "repro_torch.kernels.mjfinish.kernel",
                 "repro_torch.kernels.mjfinish.ops",
                 "repro_torch.kernels.mjfinish.ref",
                 "repro_torch.kernels.coredeal",
                 "repro_torch.kernels.coredeal.kernel",
                 "repro_torch.kernels.coredeal.ops",
                 "repro_torch.kernels.coredeal.ref"):
        importlib.import_module(name)
    from repro_torch.kernels import _build
    srcs = [p.name for p in _build.sources()]
    assert srcs == ["contract.cu", "coredeal.cu", "flash_attention.cu",
                    "mapscore.cu", "mjfinish.cu", "segscan.cu", "ssd.cu"]
    assert _build.build_info() == {} or "path" in _build.build_info()
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        with pytest.raises(_build.KernelBuildFailure, match="nvcc not found"):
            _build.find_nvcc()


# --- the kernel's host side: shift, status word, candidate groups -------

L2_BYTES = 50 << 20  # the H100's L2 cache
FULL_SIZE_MACHINES = {  # (dims, core_dims) of the registry at 2^18 tasks
    "xk7_sparse": ((32, 32, 32, 16), 1),
    "bgq_block": ((16, 8, 8, 8, 2, 16), 1),
    "tpu_mesh": ((512, 512), 0),
}


@pytest.mark.parametrize("weights", ["seeded", "none", "tiny", "huge"])
def test_wrapper_shift_is_fixed_point_shift_of_the_abs_weight_sum(weights):
    machine = compat.machine(MACHINES[3])
    stack, edges, w = _random_problem(machine, 4, ne=500)
    w = {"seeded": w, "none": None, "tiny": w * 1e-30,
         "huge": w * 1e30}[weights]
    cs, e, wt, inv_bw = scoring_inputs(machine, edges, w, stack, True, "cpu")
    got = ms_ops.mapscore(cs, e, wt, inv_bw, dims=machine.dims,
                          wrap=machine.wrap, core_dims=machine.core_dims,
                          traffic=True)
    w32 = (np.ones(len(edges)) if w is None else w).astype(np.float32)
    want = ms_kernel.fixed_point_shift(
        np.abs(w32).sum(dtype=np.float64), machine.dims, machine.core_dims)
    assert got["shift"].dtype == torch.int64 and got["shift"].dim() == 0
    assert int(got["shift"]) == want
    assert int(got["status"]) == 0
    if w is None:  # every weight 1: the sum is the message count
        assert want == ms_kernel.fixed_point_shift(
            float(len(edges)), machine.dims, machine.core_dims)


@pytest.mark.parametrize("abs_sum", [0.0, 1e-30, 1.0, 3.7e6, 2.0 ** 40,
                                     1e300, float("inf"), float("nan")])
def test_plain_shift_agrees_with_fixed_point_shift(abs_sum):
    """The plain version's shift (its own frexp of the float64 |w| sum
    times the hop span) is the kernel module's ``fixed_point_shift``."""
    dims, core = (32, 32, 32, 16), 1
    got = ms_ref.shift_of(abs_sum, ms_kernel.hop_span(dims, core))
    if not np.isfinite(abs_sum):
        assert got == ms_kernel.SHIFT_NONE
        with pytest.raises(ValueError, match="finite"):
            ms_kernel.fixed_point_shift(abs_sum, dims, core)
    else:
        assert got == ms_kernel.fixed_point_shift(abs_sum, dims, core)


@pytest.mark.parametrize("empty", ["no-messages", "no-candidates"])
def test_empty_calls_score_zero_and_check_nothing(empty):
    """With no messages or no candidates the wrapper launches nothing on
    the card, so the plain version checks nothing either: every output,
    the status and the shift are zero, a bad coordinate included."""
    machine = compat.machine(MACHINES[2])
    stack, edges, w = _random_problem(machine, 6)
    stack = stack.copy()
    stack[0, 0, 0] = machine.dims[0]  # out of range
    if empty == "no-messages":
        edges, w = edges[:0], w[:0]
    else:
        stack = stack[:0]
    cs, e, wt, inv_bw = scoring_inputs(machine, edges, w, stack, True, "cpu")
    kw = dict(dims=machine.dims, wrap=machine.wrap,
              core_dims=machine.core_dims, traffic=True)
    for ev in (ms_ops.mapscore(cs, e, wt, inv_bw, **kw),
               ms_ref.mapscore_ref(cs, e, wt, inv_bw, **kw)):
        assert int(ev["status"]) == 0 and int(ev["shift"]) == 0
        assert ev["total_hops"].dtype == torch.int64
        for key in ("weighted_hops", "total_hops", "data_max",
                    "latency_max"):
            assert ev[key].shape == (len(stack),) and not ev[key].any()


def test_status_word_decodes_to_the_wrappers_messages():
    dims = (4, 5, 3, 2)
    assert ms_kernel.status_error(0, dims) is None
    assert (ms_kernel.status_error(ms_kernel.ST_EDGE, dims)
            == "edges index outside the task range")
    for j, d in enumerate(dims):
        assert (ms_kernel.status_error(ms_kernel.ST_COL0 << j, dims)
                == f"coord_stack column {j} leaves [0, {d})")
    assert (ms_kernel.status_error(ms_kernel.ST_WEIGHT, dims)
            == "message weights must be finite")
    # several faults: the first in the order the inputs are checked
    every = ms_kernel.ST_EDGE | (ms_kernel.ST_COL0 << 2) | ms_kernel.ST_WEIGHT
    assert ms_kernel.status_error(every, dims).startswith("edges index")
    assert ms_kernel.status_error((ms_kernel.ST_COL0 << 3)
                                  | ms_kernel.ST_WEIGHT,
                                  dims) == "coord_stack column 3 leaves [0, 2)"
    with pytest.raises(ValueError, match="column 1 leaves"):
        ms_ops.raise_for_status(torch.tensor(ms_kernel.ST_COL0 << 1), dims)
    ms_ops.raise_for_status(torch.tensor(0), dims)


@pytest.mark.parametrize("fault", ["edge-high", "edge-negative",
                                   "coord-at-dim", "coord-negative",
                                   "weight-inf"])
def test_faulty_inputs_raise_the_status_error(fault):
    machine = compat.machine(MACHINES[2])  # (4, 5, 3)
    stack, edges, w = _random_problem(machine, 6)
    stack, edges, w = stack.copy(), edges.copy(), w.copy()
    if fault == "edge-high":
        edges[7, 1] = stack.shape[1]
        msg, bit = "edges index outside the task range", ms_kernel.ST_EDGE
    elif fault == "edge-negative":
        edges[3, 0] = -1
        msg, bit = "edges index outside the task range", ms_kernel.ST_EDGE
    elif fault == "coord-at-dim":
        stack[2, edges[5, 0], 1] = machine.dims[1]
        msg = r"coord_stack column 1 leaves \[0, 5\)"
        bit = ms_kernel.ST_COL0 << 1
    elif fault == "coord-negative":
        stack[0, edges[9, 1], 2] = -1
        msg = r"coord_stack column 2 leaves \[0, 3\)"
        bit = ms_kernel.ST_COL0 << 2
    else:
        w[4] = np.inf
        msg, bit = "message weights must be finite", ms_kernel.ST_WEIGHT
    cs, e, wt, inv_bw = scoring_inputs(machine, edges, w, stack, True, "cpu")
    ev = ms_ops.mapscore(cs, e, wt, inv_bw, dims=machine.dims,
                         wrap=machine.wrap, core_dims=machine.core_dims,
                         traffic=True)
    assert int(ev["status"]) == bit
    with pytest.raises(ValueError, match=msg):
        ms_ops.evaluate_candidates_hopper(machine, edges, w, stack,
                                          traffic=True, device="cpu")


def test_every_coordinate_is_checked_not_only_gathered_ones():
    """The kernel's first pass checks the whole coordinate stack, as the
    wrapper's host-side check did: a task that no message touches
    raises too."""
    machine = compat.machine(MACHINES[2])
    stack, edges, w = _random_problem(machine, 6, ne=20)
    idle = np.setdiff1d(np.arange(stack.shape[1]), edges)
    assert len(idle)
    bad = stack.copy()
    bad[3, idle[0], 0] = machine.dims[0]
    with pytest.raises(ValueError, match=r"column 0 leaves \[0, 4\)"):
        ms_ops.evaluate_candidates_hopper(machine, edges, w, bad,
                                          traffic=True, device="cpu")


@pytest.mark.parametrize("name", sorted(FULL_SIZE_MACHINES))
@pytest.mark.parametrize("traffic", [False, True], ids=["hops", "traffic"])
def test_candidate_groups_fit_l2_and_cover_each_candidate_once(name,
                                                               traffic):
    """The kernel's groups cover every candidate once, in order; with
    traffic a group's link accumulators fit the L2 cache, and a stack of
    8 splits into at least four groups (so that most reduces run beside
    the next group's accumulate)."""
    dims, core = FULL_SIZE_MACHINES[name]
    machine = compat.machine(R.make_machine(dims, wrap=True,
                                            core_dims=core))
    _, _, per_cand = ms_kernel.workspace_layout(dims, core)
    for nb in (1, 3, 8, 13):
        per_group = ms_kernel.group_size(per_cand if traffic else 0, nb,
                                         ms_ops.GROUP_ELEMS)
        groups = ms_kernel.candidate_groups(nb, per_group)
        seen = [c for g in groups for c in g]
        assert seen == list(range(nb))  # each once, in order
        assert all(1 <= len(g) <= ms_kernel.GROUP_MAX for g in groups)
        if not traffic:
            assert len(groups) == -(-nb // ms_kernel.GROUP_MAX)
            continue
        assert per_group * per_cand * 8 <= L2_BYTES
        if nb >= ms_kernel.PIPELINE_GROUPS:
            assert len(groups) >= ms_kernel.PIPELINE_GROUPS
    if traffic:  # two of a stack of 8 on every full-size machine
        assert ms_ops.candidate_chunk(machine, True, nb=8) == 2
        assert ms_ops.candidate_chunk(machine, True, nb=32) == {
            "xk7_sparse": 2, "bgq_block": 2, "tpu_mesh": 6}[name]


def test_pack_and_unpack_round_trip_the_plain_results():
    machine = compat.machine(MACHINES[4])
    stack, edges, w = _random_problem(machine, 9)
    cs, e, wt, inv_bw = scoring_inputs(machine, edges, w, stack, True, "cpu")
    kw = dict(dims=machine.dims, wrap=machine.wrap,
              core_dims=machine.core_dims, traffic=True)
    want = ms_ref.mapscore_ref(cs, e, wt, inv_bw, **kw)
    got = ms_ops.unpack(ms_ops.pack(want, len(stack)), len(stack), True)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # the group bound is the kernel's: the plain version ignores it
    before = ms_ops.launch_count
    other = ms_ops.unpack(ms_ops._scores(cs, e, wt, inv_bw, **kw,
                                         group_elems=1), len(stack), True)
    assert ms_ops.launch_count == before
    for key in want:
        assert torch.equal(other[key], want[key]), key


@pytest.mark.parametrize("name", sorted(FULL_SIZE_MACHINES))
def test_row_strides_give_the_plain_row_key(name):
    """The kernel's row key (sum of coordinate times stride) is the
    mixed-radix key the plain router folds over the other dims."""
    dims, core = FULL_SIZE_MACHINES[name]
    rng = np.random.default_rng(11)
    src = np.stack([rng.integers(0, d, 64) for d in dims], axis=1)
    dst = np.stack([rng.integers(0, d, 64) for d in dims], axis=1)
    rows, _, _ = ms_kernel.workspace_layout(dims, core)
    for k, st in enumerate(ms_kernel.row_strides(dims, core)):
        assert st[k] == 0
        want = np.zeros(64, dtype=np.int64)
        for j in range(len(dims)):
            if j != k:
                want = want * dims[j] + (dst[:, j] if j < k else src[:, j])
        got = sum((dst[:, j] if j < k else src[:, j]) * st[j]
                  for j in range(len(dims)))
        assert np.array_equal(got, want)
        assert want.max() < rows[k]
