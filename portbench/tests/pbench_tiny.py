"""A tiny copy of the benchmark for the CPU tests: every configuration of
``BENCHMARK.json`` with its graph and machine shrunk, in a temporary
root beside the real folder's files."""

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent

TINY = {
    "stencil": ({"dims": [16, 16, 8]}, 2048),
    "cube_sphere": ({"ne": 12}, 864),
}


def tiny_config(cfg: dict) -> dict:
    graph, tasks = TINY[cfg["graph"]["kind"]]
    cfg = json.loads(json.dumps(cfg))
    cfg["graph"].update(graph)
    cfg["allocation"]["tasks"] = tasks
    cfg["machine"]["router_dims"] = [5, 4, 6]
    return cfg


def tiny_root(tmp: Path) -> Path:
    """A root whose ``BENCHMARK.json`` names tiny copies of the
    configurations (traffic and metrics stay the real folder's)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        c["file"] = f"{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(tiny_config(cfg)))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
