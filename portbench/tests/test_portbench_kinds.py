"""A configuration of a new kind is new files only: in a copy of the
benchmark folder, a 5D torus machine kind, a contiguous allocation kind
and a configuration whose pool mixes two job sizes run to ``correct`` on
the CPU, as do per-task weights from a graph kind; and K1's roofline
sizes each launch by its own request's job."""

import json

import numpy as np
import pytest

from pbench import cell as pcell
from pbench import cost, gen, judge, trace
from pbench.cell import Run
from pbench.ref import engine
from pbench.spec import Spec
from pbench_tiny import BENCH_DIR, REPO, bench_copy, tiny_config

SEED = 2 ** 31 + 2807

# an IBM BlueGene/Q partition: a 5D torus of nodes (A, B, C, D, E), every
# dim wrapped, uniform links, a core dim
BGQ_TORUS = '''
from pbench.ref.engine import Machine


def build(spec):
    dims = tuple(spec["node_dims"]) + (int(spec["cores_per_node"]),)
    return Machine(dims, (True,) * len(spec["node_dims"]) + (False,),
                   tuple((float(spec["link_gb_s"]),)
                         for _ in spec["node_dims"]))
'''

# every core of the partition, ranks in row-major A, B, C, D, E order and
# then the core
CONTIGUOUS = '''
import numpy as np


class Contiguous:
    def __init__(self, machine, spec):
        grid = np.indices(machine.dims)
        self.coords = np.stack([g.ravel() for g in grid], axis=1)
        if len(self.coords) != int(spec["tasks"]):
            raise ValueError("a contiguous allocation is every core")

    def draw(self, rng):
        return self.coords.astype(np.int64)


def build(spec, machine):
    return Contiguous(machine, spec)
'''

# the stencil with per-task weights 1, 2, 3, 1, 2, 3, ...
WEIGHTED_STENCIL = '''
import numpy as np

from pbench.gen import kind


def build(spec):
    graph = kind("graph", {"kind": "stencil"}).build(spec)
    return (*graph, 1.0 + np.arange(len(graph[0])) % 3)
'''


def bgq_variant(node_dims, grid, cores=4):
    return {"graph": {"kind": "stencil", "dims": grid, "periodic": False,
                      "volume": 1.0},
            "machine": {"kind": "bgq-torus", "node_dims": node_dims,
                        "cores_per_node": cores, "link_gb_s": 2.0},
            "allocation": {"kind": "contiguous",
                           "tasks": int(np.prod(node_dims)) * cores}}


# 8K and 16K ranks, cut for the CPU by the configuration's own "tiny"
BGQ_CONFIG = tiny_config({
    "name": "bgq-two-sizes",
    "variants": [bgq_variant([4, 4, 4, 4, 2], [16, 16, 32]),
                 bgq_variant([4, 4, 4, 8, 2], [32, 16, 32])],
    "pipeline": {"sfc": "FZ", "shift": True, "rotations": 36,
                 "objective": "wh", "score_backend": "hopper",
                 "partition_backend": "torch"},
    "tiny": {"variants": [bgq_variant([2, 2, 2, 4, 2], [8, 8, 4]),
                          bgq_variant([2, 2, 4, 4, 2], [8, 8, 8])]}})

# two distinct jobs alternate past a one-entry LRU: every request misses
TWO_SIZES = {"pool": 4, "warmup_jobs": 2, "cache_entries": 1, "block": 1,
             "repeat_share": 0.0, "recent": 0, "hierarchy": "flat"}


def counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_a_new_machine_allocation_and_variants_are_only_files(
        tmp_path, monkeypatch):
    import repro_torch.core as core
    spec = bench_copy(tmp_path, {("machine", "bgq-torus"): BGQ_TORUS,
                                 ("allocation", "contiguous"): CONTIGUOUS},
                      {"bgq-two-sizes": BGQ_CONFIG}, TWO_SIZES)
    # the real folder has none of these kinds
    with pytest.raises(ValueError, match="bgq-torus"):
        gen.job_pool(BGQ_CONFIG, SEED, 2)
    jobs = gen.job_pool(BGQ_CONFIG, SEED, 4, spec.bench_dir)
    assert [j.variant for j in jobs] == [0, 1, 0, 1]
    assert [len(j.task_coords) for j in jobs] == [256, 512, 256, 512]
    assert jobs[0].machine.dims == (2, 2, 2, 4, 2, 4)
    assert jobs[0].task_coords is jobs[2].task_coords   # built once
    assert jobs[1].machine is jobs[3].machine
    # row-major A, B, C, D, E, then the core
    assert np.array_equal(jobs[1].alloc[:5], [[0, 0, 0, 0, 0, c]
                                              for c in range(4)]
                          + [[0, 0, 0, 0, 1, 0]])
    graphs = counting(monkeypatch, core, "TaskGraph")
    machines = counting(monkeypatch, core, "make_machine")
    res = pcell.run_cell(spec, "bgq-two-sizes.new", SEED, 0.3, False,
                         t_start=0.0, device="cpu", score_backend="torch")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert len(graphs) == 2 and len(machines) == 2
    assert sorted(len(g[0]) for g in graphs) == [256, 512]


def test_a_one_variant_pool_gets_one_graph_and_one_machine():
    cfg = tiny_config(json.loads(
        (BENCH_DIR / "configs" / "minighost-xk7.json").read_text()))
    jobs = gen.job_pool(cfg, SEED, 5)
    port = pcell.Port(cfg, {"hierarchy": "flat", "cache_entries": 8}, jobs,
                      "cpu", "torch")
    assert list(port.graphs) == [0]
    assert len({id(a.machine) for a in port.allocs}) == 1


def test_task_weights_reach_the_program_and_the_reference(
        tmp_path, monkeypatch):
    from repro_torch.serve import MappingService
    cfg = tiny_config(json.loads(
        (BENCH_DIR / "configs" / "minighost-xk7.json").read_text()))
    cfg["graph"]["kind"] = "weighted-stencil"
    spec = bench_copy(tmp_path, {("graph", "weighted-stencil"):
                                 WEIGHTED_STENCIL},
                      {"weighted": cfg}, json.loads(
                          (BENCH_DIR / "traffic" / "cold.json").read_text()))
    jobs = gen.job_pool(cfg, SEED, 2, spec.bench_dir)
    assert np.array_equal(jobs[0].task_weights[:4], [1.0, 2.0, 3.0, 1.0])
    # the weights move the reference's answer
    opts = {"rotations": 36, "objective": "wh"}
    weighted = judge.reference_answers(
        {0: jobs[0]}, opts, "flat", spec.bench_dir)[0]
    plain = engine.map_flat(jobs[0], **opts)
    assert not np.array_equal(weighted["task_to_proc"], plain["task_to_proc"])
    sent = []
    mapped = MappingService.map

    def recorded(self, request):
        sent.append(request.task_weights)
        return mapped(self, request)

    monkeypatch.setattr(MappingService, "map", recorded)
    res = pcell.run_cell(spec, "weighted.new", SEED, 0.3, False,
                         t_start=0.0, device="cpu", score_backend="torch")
    assert res["correct"], res["checks"]
    assert sent and all(w is not None and len(w) == 2048 for w in sent)


def shaped_job(tasks, edges, variant):
    return gen.Job(np.zeros((tasks, 3)), np.zeros((edges, 2), dtype=np.int64),
                   np.ones(edges), np.zeros((tasks, 4), dtype=np.int64),
                   engine.Machine((2, 2, 2, 2), (True, True, True, False),
                                  ((1.0,), (1.0,), (1.0,))), variant=variant)


def roofline_run(jobs, device_s):
    """One cold request a job, each a sweep of 8 candidates with one K1
    launch of ``device_s[i]`` seconds."""
    from repro_torch.kernels.mapscore import ops as k1_ops
    spans = [trace.SpanRec("pipeline.fused", 10 + i, None, f"t{i}", i,
                           i + 0.5, {"candidates": 8})
             for i in range(len(jobs))]
    ops = [("mapscore_step", i + 0.1, d) for i, d in enumerate(device_s)]
    return Run([{"job": i, "trace_id": f"t{i}"} for i in range(len(jobs))],
               trace.Tree(spans), ops, (0.0, 10.0),
               {"pipeline": {"objective": "wh", "sfc": "FZ"}},
               {"hierarchy": "flat"}, jobs,
               {"mapscore_roofline": k1_ops.launch_count - len(jobs)})


def least_s(job):
    return cost.scoring_work(candidates=8, tasks=len(job.task_coords),
                             edges=len(job.edges), dims=job.machine.dims,
                             network_dims=job.machine.nd,
                             traffic=False)["least_s"]


def test_mapscore_roofline_sizes_each_launch_by_its_own_job():
    read = Spec(REPO, BENCH_DIR).reader("mapscore_roofline")
    small, large = shaped_job(4, 6, 0), shaped_job(64, 300, 1)
    # one shape: the old formula, the least time over the mean launch's
    one = read(roofline_run([small, small], [0.5, 1.5]))
    assert one == pytest.approx(100 * least_s(small) / (2.0 / 2))
    # two shapes: each launch's least time, over the launches' time
    two = read(roofline_run([small, large], [0.5, 1.5]))
    assert two == pytest.approx(
        100 * (least_s(small) + least_s(large)) / 2.0)
    assert two > one
    # a sweep whose request is not among the window's answers: nothing
    run = roofline_run([small, large], [0.5, 1.5])
    run.requests.pop()
    assert read(run) is None


def test_mapscore_roofline_sizes_a_launch_by_tasks_not_cores():
    """A job with 24 tasks on 4 cores: K1 scores every task's core, so
    the launch is sized by the 24 tasks."""
    job = shaped_job(24, 40, 0)
    job.alloc = job.alloc[:4]
    module = Spec(REPO, BENCH_DIR).reader_module("mapscore_roofline")
    shapes = module.sweep_shapes({"pipeline": {"objective": "wh"}},
                                 {"hierarchy": "flat"}, job)
    assert shapes["tasks"] == 24 and shapes["edges"] == 40
    assert module.read(roofline_run([job], [1.0])) == pytest.approx(
        100 * least_s(job) / 1.0)
