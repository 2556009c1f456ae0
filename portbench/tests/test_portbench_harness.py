"""The harness's pieces on the CPU: traffic, the work count, the span
arithmetic, the data-driven lookup, and the reference against the
program's host engine."""

import json
import shutil
import textwrap

import numpy as np
import pytest

from pbench import cost, gen, judge, trace
from pbench import traffic as tr
from pbench import cell as pcell
from pbench.cell import Run
from pbench.ref import engine, hier
from pbench.spec import Spec
from pbench_tiny import BENCH_DIR, REPO, tiny_config, tiny_root

MIXES = {p.stem: json.loads(p.read_text())
         for p in (BENCH_DIR / "traffic").glob("*.json")}
# relaunches of recent jobs: no cell sends them yet, the generator can
REPEATS = {"pool": 16, "warmup_jobs": 2, "cache_entries": 8, "block": 20,
           "repeat_share": 0.95, "recent": 4, "hierarchy": "flat"}
ALL_MIXES = MIXES | {"repeats": REPEATS}


def first(gen_, n):
    return [next(gen_) for _ in range(n)]


@pytest.mark.parametrize("mix", sorted(ALL_MIXES))
def test_schedule_is_deterministic_per_seed(mix):
    m = ALL_MIXES[mix]
    # enough requests for every job of the pool to be sent new
    n = max(400, m["pool"] * m["block"])
    a = first(tr.schedule(m, 2 ** 31 + 5), n)
    b = first(tr.schedule(m, 2 ** 31 + 5), n)
    assert a == b
    assert set(a) == set(range(m["pool"]))


def test_job_pool_is_deterministic_per_seed():
    cfg = tiny_config(json.loads(
        (BENCH_DIR / "configs" / "minighost-xk7.json").read_text()))
    a, b = gen.job_pool(cfg, 3 * 10 ** 9, 3), gen.job_pool(cfg, 3 * 10 ** 9, 3)
    c = gen.job_pool(cfg, 3 * 10 ** 9 + 1, 3)
    for x, y in zip(a, b):
        assert np.array_equal(x.alloc, y.alloc)
    assert not np.array_equal(a[0].alloc, c[0].alloc)
    # distinct jobs: each its own allocation, one core a task
    for j in a:
        assert len(np.unique(j.alloc, axis=0)) == len(j.alloc)
    assert not np.array_equal(a[0].alloc, a[1].alloc)


def test_job_pool_refuses_more_cores_than_tasks():
    cfg = tiny_config(json.loads(
        (BENCH_DIR / "configs" / "minighost-xk7.json").read_text()))
    cfg["allocation"]["tasks"] = 2049
    with pytest.raises(ValueError, match="2049 cores for 2048 tasks"):
        gen.job_pool(cfg, 1, 1)


@pytest.mark.parametrize("part", ["graph", "machine", "allocation",
                                  "hierarchy"])
def test_an_unknown_kind_is_refused(part):
    cfg = tiny_config(json.loads(
        (BENCH_DIR / "configs" / "minighost-xk7.json").read_text()))
    if part == "hierarchy":
        searched = BENCH_DIR / "refs"
        with pytest.raises(ValueError, match="bgq-contiguous-block") as e:
            judge.reference_answers({}, {}, "bgq-contiguous-block")
    else:
        searched = BENCH_DIR / "kinds" / part
        cfg[part]["kind"] = "bgq-contiguous-block"
        with pytest.raises(ValueError, match="bgq-contiguous-block") as e:
            gen.job_pool(cfg, 1, 1)
    assert str(searched) in str(e.value)


def test_an_unknown_hierarchy_is_refused_before_the_window(
        tmp_path, monkeypatch):
    """``depth3`` is a hierarchy the program serves and no file of
    ``refs/`` judges: the run stops before it serves a request."""
    from pbench import cell as pcell
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    root = tiny_root(tmp_path)
    mix = json.loads((bench_dir / "traffic" / "cold.json").read_text())
    (bench_dir / "traffic" / "cold.json").write_text(
        json.dumps(mix | {"hierarchy": "depth3"}))

    def no_window(*a, **k):
        raise AssertionError("the window opened")

    monkeypatch.setattr(pcell, "drive", no_window)
    monkeypatch.setattr(pcell.Port, "serve", no_window)
    with pytest.raises(ValueError, match="depth3"):
        pcell.run_cell(Spec(root, bench_dir), "minighost-xk7.cold", 1, 0.3,
                       False, t_start=0.0, device="cpu",
                       score_backend="torch")


def test_relaunch_draws_its_repeats_from_the_seed():
    mix = REPEATS
    assert first(tr.schedule(mix, 1), 200) != first(tr.schedule(mix, 2), 200)


@pytest.mark.parametrize("mix", ["cold", "cold-node"])
def test_cold_schedule_never_hits_the_lru(mix):
    m = MIXES[mix]
    jobs = first(tr.schedule(m, 12345), 50 * m["pool"])
    assert not any(tr.lru_hits(jobs, m["cache_entries"]))


def test_relaunch_hits_exactly_95_percent():
    m = REPEATS
    for seed in (0, 7, 2 ** 33 + 1):
        jobs = first(tr.schedule(m, seed), 40 * m["block"])
        hits = tr.lru_hits(jobs, m["cache_entries"])
        assert sum(hits) / len(hits) == 0.95
        # the misses are exactly each block's new job
        assert [i for i, h in enumerate(hits) if not h] == list(
            range(0, len(jobs), m["block"]))


def test_scoring_work_by_hand():
    # 2 candidates, 3 tasks, 4 messages on a (4, 2, 3) torus + 5 cores
    w = cost.scoring_work(candidates=2, tasks=3, edges=4, dims=(4, 2, 3, 5),
                          network_dims=3, traffic=False)
    assert w["bytes"] == 2 * 3 * 3 * 4 + 4 * 2 * 4 + 4 * 4 + 2 * 8 * 8
    assert w["ops"] == 2 * 4 * 3 * 4
    t = cost.scoring_work(candidates=2, tasks=3, edges=4, dims=(4, 2, 3, 5),
                          network_dims=3, traffic=True)
    assert t["bytes"] == (2 * 3 * 4 * 4 + 4 * 2 * 4 + 4 * 4 + 2 * 8 * 8
                          + (4 + 2 + 3) * 4)
    assert t["ops"] == 2 * 4 * 3 * 7 + 2 * (2 * 3 * 4 * 2 * 3 * 5) * 3
    assert t["bound_by"] == "bytes"
    assert t["least_s"] == t["bytes"] / cost.PEAKS["hbm_bytes_per_s"]


def span(name, i, parent, t0, t1, **attrs):
    return trace.SpanRec(name, i, parent, "t", t0, t1, attrs)


SYNTHETIC = [
    span("serve.request", 1, None, 0.0, 10.0),
    span("serve.rung", 2, 1, 1.0, 9.0),
    span("pipeline.map", 3, 2, 2.0, 8.0, hierarchy="flat"),
    span("pipeline.fused", 4, 3, 3.0, 6.0, candidates=8),
    span("partition.torch", 5, 4, 3.5, 4.0),
    span("serve.request", 6, None, 10.0, 11.0),       # a warm answer
]


SHAPES = {"tasks": 4, "edges": 6, "dims": (2, 2, 2, 2), "network_dims": 3,
          "traffic": False}


def synthetic_run(ops=(), launches=0):
    from repro_torch.kernels.mapscore import ops as k1_ops
    job = gen.Job(np.zeros((4, 3)), np.zeros((6, 2), dtype=np.int64),
                  np.ones(6), np.zeros((4, 4), dtype=np.int64),
                  engine.Machine((2, 2, 2, 2), (True, True, True, False),
                                 ((1.0,), (1.0,), (1.0,))))
    return Run([{"job": 0, "trace_id": "t"}], trace.Tree(SYNTHETIC),
               list(ops), (0.0, 11.0),
               {"pipeline": {"objective": "wh", "sfc": "FZ"}},
               {"hierarchy": "flat"}, [job],
               {"mapscore_roofline": k1_ops.launch_count - launches})


def test_self_time_arithmetic():
    t = trace.Tree(SYNTHETIC)
    req, rung, pmap, fused = t.spans[:4]
    assert t.self_s(req) == 2.0                       # 10 - rung's 8
    assert t.self_s(pmap) == 3.0                      # 6 - fused's 3
    assert t.self_s(req, t.descendants(req, "pipeline.map")) == 4.0
    assert trace.covered(0, 10, [(1, 3), (2, 4), (8, 12)]) == 5.0
    assert trace.covered(5, 6, [(0, 1)]) == 0.0


def test_metric_readers_on_synthetic_spans():
    spec = Spec(REPO, BENCH_DIR)
    run = synthetic_run(ops=[("mapscore_step", 3.0, 0.5),
                             ("mapscore_prep", 4.0, 0.5),
                             ("sort", 7.0, 1.0)], launches=1)
    assert spec.reader("service.self_ms")(run) == pytest.approx(
        (4.0 + 1.0) / 2 * 1e3)
    assert spec.reader("pipeline.self_ms")(run) == pytest.approx(3e3)
    assert spec.reader("sweep.fused_ms")(run) == pytest.approx(3e3)
    assert spec.reader("hier.host_ms")(run) is None    # no hierarchy
    assert spec.reader("device.idle")(run) == pytest.approx(
        100 * (1 - 2.0 / 11.0))
    least = cost.scoring_work(candidates=8, **SHAPES)["least_s"]
    assert spec.reader("mapscore_roofline")(run) == pytest.approx(
        100 * least / 1.0)
    # nothing to read: no launch, or launches that are not all sweeps'
    assert spec.reader("mapscore_roofline")(synthetic_run()) is None
    assert spec.reader("mapscore_roofline")(synthetic_run(launches=2)) is None


def test_request_p90_reader_counts_a_failed_request_as_slowest():
    read = Spec(REPO, BENCH_DIR).reader("service.request_ms_p90")
    reqs = [{"t0": 0.0, "t1": 0.001 * (i + 1), "failed": False}
            for i in range(10)]
    assert read(Run(reqs, trace.Tree([]), [], (0, 1), {}, {}, [])
                ) == pytest.approx(9.0)         # the 9th of 10
    for r in reqs[-2:]:
        r["failed"] = True
    assert read(Run(reqs, trace.Tree([]), [], (0, 1), {}, {}, [])
                ) == float("inf")
    assert read(Run([], trace.Tree([]), [], (0, 1), {}, {}, [])) is None


def test_slices_split_the_window_by_send_time():
    answers = [{"t0": t, "t1": t + 0.01, "failed": False}
               for t in (0.0, 0.5, 2.9, 3.0, 5.99)]
    answers.append({"t0": 1.0, "t1": 9.0, "failed": True})
    parts = pcell.slice_latencies(answers, 0.0, 6.0, 3)
    assert [len(p) for p in parts] == [2, 2, 1]


def test_breakdown_labels_idle_gaps_by_host_span():
    ops = [("a", 0.5, 1.0), ("b", 5.0, 0.5), ("a", 10.2, 0.3)]
    b = trace.breakdown(ops, SYNTHETIC, 0.0, 11.0)
    assert b["device_ops"] == [["a", 1.3], ["b", 0.5]]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # gaps: [0, .5] (request), [1.5, 5] (fused), [5.5, 10.2] (map,
    # by its middle), [10.5, 11] (warm request)
    assert gaps["serve.request"] == pytest.approx(0.5 + 0.5)
    assert gaps["pipeline.fused"] == pytest.approx(3.5)
    assert gaps["pipeline.map"] == pytest.approx(4.7)
    assert trace.innermost(SYNTHETIC, [3.7, 11.5]) == [
        "partition.torch", "harness"]


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "homme-xk7.json").read_text())
    cfg["pipeline"]["objective"] = "wh"
    (bench_dir / "configs" / "homme-wh.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "one-job.json").write_text(json.dumps(
        {"pool": 1, "warmup_jobs": 1, "cache_entries": 4, "block": 1,
         "repeat_share": 0.0, "recent": 0, "hierarchy": "flat"}))
    (bench_dir / "metrics" / "requests.count.py").write_text(
        textwrap.dedent('''
        def start():
            return "opened"

        def read(run):
            if run.started["requests.count"] != "opened":
                return None
            assert run.mix["pool"] == 1 and len(run.jobs) == 2
            return float(len(run.requests))
        '''))
    bench["configs"].append({"name": "homme-wh", "source": "test",
                             "file": "portbench/configs/homme-wh.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "homme-wh.one-job",
                               "config": "homme-wh", "traffic": "one-job",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests.count", "unit": "1",
                               "better": "higher", "source":
                               "program_counter", "layer": "test",
                               "moves": "requests_per_s",
                               "workloads": ["homme-wh.one-job"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root, bench_dir)
    assert spec.config("homme-wh")["pipeline"]["objective"] == "wh"
    assert spec.traffic("one-job")["pool"] == 1
    assert [m["name"] for m in spec.metrics("per_layer", "homme-wh.one-job")
            if m["name"] == "requests.count"] == ["requests.count"]
    from pbench.cell import run_cell
    res = run_cell(spec, "homme-wh.one-job", 11, 0.3, True, t_start=0.0,
                   device="cpu", score_backend="torch")
    assert res["correct"]
    assert res["metrics"]["requests.count"]["value"] == res["attempted"]


def port_map(job, hierarchy, objective, rotations):
    import math

    from repro_torch.core import Allocation, TaskGraph, make_machine
    from repro_torch.mapping import (HierarchySpec, MappingPipeline,
                                     PipelineConfig)
    m = job.machine
    machine = make_machine(m.dims, wrap=m.wrap, core_dims=1,
                           bw_patterns=[np.array(p) for p in m.link_bw]
                           + [np.array([math.inf])])
    obj = engine.OBJECTIVES[objective]
    cfg = PipelineConfig(sfc="FZ", shift=True, rotations=rotations,
                         objective=obj[0] if len(obj) == 1 else obj,
                         hierarchy=HierarchySpec.from_string(hierarchy),
                         partition_backend="numpy", score_backend="numpy",
                         device="cpu")
    return MappingPipeline(cfg).map(
        TaskGraph(job.task_coords, job.edges, job.weights),
        Allocation(machine, job.alloc))


def bgq_job(cores_per_node: int) -> gen.Job:
    """HOMME's elements at ne = 16 in Cube coordinates (the sphere's
    points over their largest absolute component) onto every core of a
    (2, 2, 2, 4, 2) BG/Q torus: 1,536 tasks on 64 nodes."""
    coords, edges, w = gen.kind("graph", {"kind": "cube_sphere"}).build(
        {"ne": 16, "volume": 1.0})
    dims = (2, 2, 2, 4, 2, cores_per_node)
    alloc = np.stack([g.ravel() for g in np.indices(dims)], axis=1)
    return gen.Job(coords / np.abs(coords).max(axis=1, keepdims=True),
                   edges, w, alloc,
                   engine.Machine(dims, (True,) * 5 + (False,),
                                  ((2.0,),) * 5))


# more tasks than cores: 6 (4 cores a node) or 3 (8) tasks a core
BGQ = {f"bgq-x{c}-{o}": (c, o) for c in (4, 8) for o in ("latency", "wh")}


@pytest.mark.parametrize("config,hierarchy", [
    ("minighost-xk7", "flat"), ("homme-xk7", "flat"),
    ("minighost-xk7", "node")] + [(c, "flat") for c in BGQ])
def test_reference_agrees_with_the_host_engine(config, hierarchy):
    if config in BGQ:
        cores, objective = BGQ[config]
        jobs, rotations = [bgq_job(cores)], 36
    else:
        cfg = tiny_config(json.loads(
            (BENCH_DIR / "configs" / f"{config}.json").read_text()))
        objective = cfg["pipeline"]["objective"]
        rotations = cfg["pipeline"]["rotations"]
        jobs = gen.job_pool(cfg, 2 ** 32 + 3, 3)
    ref = engine.map_flat if hierarchy == "flat" else hier.map_node
    for job in jobs:
        want = port_map(job, hierarchy, objective, rotations)
        got = ref(job, objective=objective, rotations=rotations)
        assert np.array_equal(got["task_to_proc"], want.task_to_proc)
        assert got["rotation"] == want.rotation
        assert got["score"] == want.score
        if config in BGQ:     # every core holds 1536 / cores tasks
            assert set(np.bincount(got["task_to_proc"])) == {
                len(job.task_coords) // len(job.alloc)}


def test_node_reference_refuses_more_tasks_than_cores():
    with pytest.raises(ValueError, match="1536 tasks, 256 cores"):
        hier.map_node(bgq_job(4), rotations=36)


def test_compare_counts_tasks_moved_between_shared_cores():
    ref = {0: {"task_to_proc": np.array([0, 0, 0, 1, 1, 1]),
               "rotation": ((0, 1, 2), (0, 1, 2)), "score": 3.0}}

    def answer(t2p):
        return {"job": 0, "task_to_proc": np.array(t2p),
                "rotation": ((0, 1, 2), (0, 1, 2)), "score": 3.0}

    # one task moved to the other core, then two swapped
    for t2p, wrong in (([0, 0, 1, 1, 1, 1], 1), ([0, 0, 1, 1, 1, 0], 2),
                       ([0, 0, 0, 1, 1, 1], 0)):
        numbers = judge.compare([answer(t2p)], ref)
        assert numbers["wrong_tasks"] == wrong
        assert judge.verdict(numbers) == (wrong == 0)


def test_latency_routes_like_a_message_walk():
    """Latency(M) of the reference against a walk of each message, link
    by link, on a small torus with a wrap and a core dim."""
    m = engine.Machine((4, 3, 2), (True, False, False),
                       ((2.0, 1.0), (4.0,)))
    rng = np.random.default_rng(0)
    alloc = np.stack(np.indices((4, 3, 2)).reshape(3, -1), axis=1)
    edges = rng.integers(0, len(alloc), size=(30, 2))
    w = rng.random(30)
    loads = {}
    for (a, b), v in zip(edges, w):
        cur = list(alloc[a])
        for k in range(2):
            s = m.dims[k]
            while cur[k] != alloc[b][k]:
                fwd = (alloc[b][k] - cur[k]) % s if m.wrap[k] else None
                step = 1 if (fwd is not None and fwd <= s - fwd) or (
                    fwd is None and alloc[b][k] > cur[k]) else -1
                nxt = (cur[k] + step) % s
                link = cur[k] if step == 1 else nxt
                key = (k, step, *cur[:k], link, *cur[k + 1:])
                loads[key] = loads.get(key, 0.0) + v
                cur[k] = nxt
    want = max(v / m.link_bw[key[0]][key[2 + key[0]] % len(
        m.link_bw[key[0]])] for key, v in loads.items())
    got = engine.score(m, alloc, edges, w, np.arange(len(alloc)), True)
    assert got["latency_max"] == pytest.approx(want, rel=1e-12)
