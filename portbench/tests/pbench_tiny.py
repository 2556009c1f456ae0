"""A tiny copy of the benchmark for the CPU tests: every configuration of
``BENCHMARK.json`` shrunk, in a temporary root beside the real folder's
files.

A configuration gives its own CPU-test sizes under the key ``tiny``: an
object laid out as the configuration, whose values replace the
configuration's (objects merged key by key, lists of objects as long
as the configuration's, such as ``variants``, entry by entry; anything
else replaced).  The two configurations from before that key keep the sizes
below, by their graph's kind.
"""

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent

TINY = {
    "stencil": ({"dims": [16, 16, 8]}, 2048),
    "cube_sphere": ({"ne": 12}, 864),
}


def merged(base, over):
    """``base`` with ``over``'s values in its place."""
    if isinstance(base, dict) and isinstance(over, dict):
        return {**base, **{k: merged(base.get(k), v)
                           for k, v in over.items()}}
    if (isinstance(base, list) and isinstance(over, list)
            and len(base) == len(over)
            and all(isinstance(o, dict) for o in over)):
        return [merged(b, o) for b, o in zip(base, over)]
    return over


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    if "tiny" in cfg:
        return merged(cfg, cfg.pop("tiny"))
    if cfg.get("graph", {}).get("kind") not in TINY:
        raise ValueError(f"configuration {cfg.get('name')!r} gives no "
                         "sizes for the CPU tests under the key 'tiny'")
    graph, tasks = TINY[cfg["graph"]["kind"]]
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
