"""A tiny copy of the benchmark for the CPU tests: every configuration of
``BENCHMARK.json`` shrunk, in a temporary root beside the real folder's
files; and a copy of the benchmark folder with new files and entries
beside it, as a later cell would add them.

A configuration gives its own CPU-test sizes under the key ``tiny``: an
object laid out as the configuration, whose values replace the
configuration's (objects merged key by key, lists of objects as long
as the configuration's, such as ``variants``, entry by entry; anything
else replaced).  The two configurations from before that key keep the sizes
below, by their graph's kind.
"""

import json
import shutil
import textwrap
from pathlib import Path

from pbench.spec import Spec

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


def bench_copy(tmp_path: Path, kinds: dict, configs: dict, mix: dict, *,
               traffic: str = "new", metrics: dict | None = None) -> Spec:
    """A copy of the benchmark folder with ``kinds`` ({(part, kind):
    source}) added, ``configs`` ({name: config}) beside the tiny copies
    of the real ones, one cell ``<config>.<traffic>`` each on ``mix``,
    and ``metrics`` ({name: (reader source, per_layer entry)}) whose
    entries list those cells."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for (part, name), text in kinds.items():
        (bench_dir / "kinds" / part / f"{name}.py").write_text(
            textwrap.dedent(text))
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (bench_dir / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    cells = []
    for name, cfg in configs.items():
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        cells.append(f"{name}.{traffic}")
        bench["workloads"].append({"name": cells[-1], "config": name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for name, (text, entry) in (metrics or {}).items():
        (bench_dir / "metrics" / f"{name}.py").write_text(
            textwrap.dedent(text))
        bench["per_layer"].append({"name": name, **entry,
                                   "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root, bench_dir)
