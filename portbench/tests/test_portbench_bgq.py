"""Jobs with more tasks than cores, as a later cell adds them: new files
and entries only, in a copy of the benchmark folder.  HOMME's
cubed-sphere elements in Cube coordinates are cut straight onto every
core of an IBM BlueGene/Q partition (a 5D torus of nodes), both sides
into one part a core, several elements to a core.  The cell's run is
``correct``, its control and an altered answer are not, a traced run
reads the one metric the cell lists, and K1's roofline sizes each launch
by the job's tasks, as the program's sweep does."""

import numpy as np
import percell
import pytest

from pbench import cell as pcell
from pbench import gen, trace
from pbench.spec import Spec
from pbench_tiny import BENCH_DIR, REPO, bench_copy, tiny_config
from test_portbench_kinds import BGQ_TORUS

SEED = 2 ** 31 + 2901

# every core of the partition, in A, B, C, D, E, then core order
WHOLE_PARTITION = '''
import numpy as np


class WholePartition:
    def __init__(self, machine):
        grid = np.indices(machine.dims)
        self.coords = np.stack([g.ravel() for g in grid], axis=1)

    def draw(self, rng):
        return self.coords.astype(np.int64)


def build(spec, machine):
    return WholePartition(machine)
'''

# HOMME's elements, the sphere's points over their largest absolute
# component: coordinates on the cube's faces
CUBE_COORDS = '''
import numpy as np

from pbench.gen import kind


def build(spec):
    coords, edges, weights = kind("graph", {"kind": "cube_sphere"}).build(
        spec)
    return coords / np.abs(coords).max(axis=1, keepdims=True), edges, weights
'''

KINDS = {("machine", "bgq-torus"): BGQ_TORUS,
         ("allocation", "whole-partition"): WHOLE_PARTITION,
         ("graph", "cube-coords"): CUBE_COORDS}


def variant(ne, node_dims, cores):
    return {"graph": {"kind": "cube-coords", "ne": ne, "volume": 1.0},
            "machine": {"kind": "bgq-torus", "node_dims": node_dims,
                        "cores_per_node": cores, "link_gb_s": 2.0},
            "allocation": {"kind": "whole-partition"}}


# ne = 128 (98,304 elements) onto 8K and 32K cores; for the CPU ne = 16
# (1,536) onto 256 and 512 cores: 6 and 3 elements a core
CONFIG = tiny_config({
    "name": "homme-bgq",
    "variants": [variant(128, [4, 4, 4, 4, 2], 16),
                 variant(128, [4, 4, 4, 16, 2], 16)],
    "pipeline": {"sfc": "FZ", "shift": True, "rotations": 36,
                 "objective": "latency", "score_backend": "hopper",
                 "partition_backend": "torch"},
    "tiny": {"variants": [variant(16, [2, 2, 2, 4, 2], 4),
                          variant(16, [2, 2, 2, 4, 2], 8)]}})

# the two sizes alternate past a one-entry LRU: every request misses
MIX = {"pool": 4, "warmup_jobs": 2, "cache_entries": 1, "block": 1,
       "repeat_share": 0.0, "recent": 0, "hierarchy": "flat"}
CELL = "homme-bgq.one-step"
# the cell's own metric: a copy of sweep.fused_ms's reader
METRIC = "bgq.sweep_ms"


@pytest.fixture
def spec(tmp_path):
    reader = (BENCH_DIR / "metrics" / "sweep.fused_ms.py").read_text()
    entry = {"unit": "ms", "better": "lower", "source": "program_span",
             "layer": "test", "moves": "requests_per_s"}
    return bench_copy(tmp_path, KINDS, {"homme-bgq": CONFIG}, MIX,
                      traffic="one-step", metrics={METRIC: (reader, entry)})


def test_jobs_have_more_tasks_than_cores(spec):
    jobs = gen.job_pool(CONFIG, SEED, 4, spec.bench_dir)
    assert [j.variant for j in jobs] == [0, 1, 0, 1]
    assert [(len(j.task_coords), len(j.alloc)) for j in jobs] == [
        (1536, 256), (1536, 512)] * 2
    assert np.allclose(np.abs(jobs[0].task_coords).max(axis=1), 1.0)


def test_the_cell_lists_no_metric_of_the_benchmark(spec):
    assert [m["name"] for m in spec.metrics("per_layer", CELL)] == [METRIC]
    assert not Spec(REPO, BENCH_DIR).metrics("per_layer", CELL)


def test_program_answers_are_correct(spec):
    percell.program_answers_are_correct(spec, CELL, SEED)


def test_control_is_not_correct(spec):
    percell.control_is_not_correct(spec, CELL, SEED)


def test_an_answer_altered_where_it_is_made_is_not_correct(
        spec, monkeypatch):
    percell.altered_answer_is_not_correct(spec, CELL, SEED, monkeypatch)


def test_traced_run_reads_the_cells_own_metric(spec):
    m = percell.span_metrics_are_read(spec, CELL, SEED)
    assert set(m) == {METRIC} and m[METRIC]["value"] > 0


def test_roofline_sizes_each_launch_by_the_jobs_tasks(spec):
    """The tasks K1's roofline counts for each sweep are those the
    program's ``sweep.score`` span records it scored."""
    from repro_torch import obs
    shapes = spec.reader_module("mapscore_roofline").sweep_shapes
    jobs = gen.job_pool(CONFIG, SEED, 2, spec.bench_dir)
    port = pcell.Port(CONFIG, MIX, jobs, "cpu", "torch")
    spans = []
    obs.add_sink(spans.append)
    try:
        answers = [port.serve(j) for j in range(len(jobs))]
    finally:
        obs.remove_sink(spans.append)
    job_of = {a["trace_id"]: a["job"] for a in answers}
    scored = [s for s in map(trace.from_span, spans)
              if s.name == "sweep.score"]
    assert len(scored) == len(jobs)
    for s in scored:
        job = jobs[job_of[s.trace_id]]
        assert s.attrs["tasks"] == len(job.task_coords) > len(job.alloc)
        assert shapes(CONFIG, MIX, job)["tasks"] == s.attrs["tasks"]
