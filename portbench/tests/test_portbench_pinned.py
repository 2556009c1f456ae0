"""What the benchmark's cells read stays byte for byte what it was: the
job pool of each cell at full size, and the reference's answers for a
tiny copy of each cell, against SHA-256 digests pinned when the kinds
and references moved into files of their own."""

import hashlib
import json

import numpy as np
import pytest

from pbench import gen, judge
from pbench_tiny import BENCH_DIR, REPO, tiny_config

SEED = 2 ** 31 + 2801
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
POOLS = {
    "minighost-xk7.cold":
        "be338b812e97b52f9dff7746933a56990eff9c5a700a1784927a13941965cfa9",
    "homme-xk7.cold":
        "86b7c687c9a3ec2bc9c2d72acc873f2af1ad88a5858a0c7a278f7962c3f50ef7",
    "minighost-xk7.node":
        "be338b812e97b52f9dff7746933a56990eff9c5a700a1784927a13941965cfa9",
}
ANSWERS = {
    "minighost-xk7.cold":
        "82313ce8f7ca8270db96619e886822a3b5439e22afe4bfb23d69b43de6505ffa",
    "homme-xk7.cold":
        "93a7446d69a4c89a947af2a390e780b817865314dfba974fd146b028f2af1cb0",
    "minighost-xk7.node":
        "3257f4ec09d988cd2b18fec120a27b4c7e5f3af29b7def967c8b7d0c77e24333",
}


def feed(h, a):
    a = np.ascontiguousarray(a)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())


def config_of(cell: str) -> dict:
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == CELLS[cell]["config"])
    return json.loads((REPO / entry["file"]).read_text())


@pytest.mark.parametrize("cell", sorted(POOLS))
def test_job_pool_is_the_pinned_one(cell):
    h = hashlib.sha256()
    for j in gen.job_pool(config_of(cell), SEED, 3):
        for a in (j.task_coords, j.edges, j.weights, j.alloc):
            feed(h, a)
        m = j.machine
        h.update(repr((m.dims, m.wrap, m.link_bw, m.core_dims)).encode())
        assert j.task_weights is None
    assert h.hexdigest() == POOLS[cell]


@pytest.mark.parametrize("cell", sorted(ANSWERS))
def test_reference_answers_are_the_pinned_ones(cell):
    cfg = tiny_config(config_of(cell))
    mix = json.loads((BENCH_DIR / "traffic"
                      / f"{CELLS[cell]['traffic']}.json").read_text())
    p = cfg["pipeline"]
    options = {k: p[k] for k in ("sfc", "shift", "rotations", "objective")}
    jobs = dict(enumerate(gen.job_pool(cfg, SEED, 2)))
    refs = judge.reference_answers(jobs, options, mix["hierarchy"])
    h = hashlib.sha256()
    for i in sorted(refs):
        feed(h, refs[i]["task_to_proc"])
        h.update(repr((refs[i]["rotation"], refs[i]["score"])).encode())
    assert h.hexdigest() == ANSWERS[cell]
