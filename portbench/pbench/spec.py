"""Find a cell's configuration, traffic mix, per-layer metrics, the
kinds its configuration names and its hierarchy's reference, by the
names ``BENCHMARK.json`` and those files give them.

A configuration is the file its entry names; a mix is
``traffic/<name>.json`` and a per-layer metric is the reader
``metrics/<name>.py`` beside this package, whose ``read(run)`` returns
the metric's value or ``None`` where the run holds nothing to read (and
whose ``start()``, if it has one, a traced run calls as its window
opens, to read a counter of the program before the window).  A
configuration's graph, machine and allocation are built by
``kinds/<part>/<kind>.py`` (:mod:`pbench.gen`), and a mix's hierarchy is
judged by ``refs/<hierarchy>.py`` (:mod:`pbench.judge`), each found by
:func:`load_named`.  Adding a cell, a mix, a metric, a kind or a
reference is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

from . import traffic as _traffic

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def load_named(directory: Path | str, name, what: str):
    """The module ``<directory>/<name>.py``.  A name that is not a
    benchmark name, or that has no file there, is refused with a
    ``ValueError`` naming ``what`` it was, the name and the directory
    searched."""
    path = Path(directory) / f"{name}.py"
    if not (isinstance(name, str) and NAME.match(name) and path.is_file()):
        raise ValueError(f"no {what} {name!r}: no file {name}.py in "
                         f"{directory}")
    mod_name = "pbench_" + "".join(c if c.isalnum() else "_"
                                   for c in f"{what}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod       # so a dataclass in it resolves
    spec.loader.exec_module(mod)
    return mod


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
        return load_named(self.bench_dir / "metrics", metric, "metric")
