"""Find a cell's configuration, traffic mix and per-layer metrics by the
names ``BENCHMARK.json`` gives them.

A configuration is the file its entry names; a mix is
``traffic/<name>.json`` and a per-layer metric is the reader
``metrics/<name>.py`` beside this package, whose ``read(run)`` returns
the metric's value or ``None`` where the run holds nothing to read (and
whose ``start()``, if it has one, a traced run calls as its window
opens, to read a counter of the program before the window).
Adding a cell, a mix or a metric is adding files and entries: nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from . import traffic as _traffic

BENCH_DIR = Path(__file__).resolve().parents[1]


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it leads to."""

    def __init__(self, root: Path | str | None = None,
                 bench_dir: Path | str | None = None):
        self.bench_dir = Path(bench_dir) if bench_dir else BENCH_DIR
        self.root = Path(root) if root else self.bench_dir.parent
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.bench[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {kind} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return _traffic.check(json.load(f))

    def metrics(self, kind: str, workload: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self.reader_module(metric).read

    def reader_module(self, metric: str):
        """``metrics/<metric>.py``: its ``read(run)``, and an optional
        ``start()`` that a traced run calls as its window opens."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        mod_name = "pbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
