"""Whole runs of every cell, past the harness's look for a card: on the
CPU at tiny sizes the program's answers are correct, and the control and
a planted fault come out not correct (:mod:`percell`, from each cell's
own lists).  One run at full size needs the card (marked ``chip``)."""

import json
import subprocess
import sys

import percell
import pytest

from pbench import cell as pcell
from pbench.spec import Spec
from pbench_tiny import BENCH_DIR, REPO, tiny_root

WORKLOADS = [w["name"] for w in
             json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 101


@pytest.fixture
def spec(tmp_path):
    return Spec(tiny_root(tmp_path), BENCH_DIR)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_answers_are_correct(spec, workload):
    percell.program_answers_are_correct(spec, workload, SEED)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(spec, workload):
    percell.control_is_not_correct(spec, workload, SEED)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_made_is_not_correct(
        spec, workload, monkeypatch):
    percell.altered_answer_is_not_correct(spec, workload, SEED, monkeypatch)


def test_traced_run_reads_the_per_layer_metrics(spec):
    res = pcell.run_cell(spec, "minighost-xk7.cold", SEED, 0.3, True,
                         t_start=0.0, device="cpu", score_backend="torch")
    assert res["correct"]
    # no device on the CPU: the device's metrics have nothing to read
    assert {"service.self_ms", "pipeline.self_ms",
            "sweep.fused_ms"} <= set(res["metrics"])
    assert "device.idle" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
def test_full_size_cell_on_the_card(card):
    res = pcell.run_cell(Spec(REPO, BENCH_DIR), WORKLOADS[0], SEED, 3.0,
                         False, t_start=0.0)
    assert res["correct"], res["checks"]
