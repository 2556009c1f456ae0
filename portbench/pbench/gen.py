"""The jobs a launcher sends, made from a configuration file and a seed
in plain numpy.

A configuration's ``graph``, ``machine`` and ``allocation`` each name a
``kind``, built by the file ``kinds/<part>/<kind>.py`` beside this
package, whose ``build`` returns:

- graph: ``build(spec)`` -> ``(coords, edges, weights)``, or those and
  per-task weights (``None`` for none);
- machine: ``build(spec)`` -> a :class:`pbench.ref.engine.Machine`;
- allocation: ``build(spec, machine)`` -> an object whose
  ``draw(rng)`` returns one job's ``(tasks, ndim)`` core coordinates.

A configuration may hold ``variants``, a list of objects that each give
their own ``graph``, ``machine`` and ``allocation``; one without them is
one variant, itself.  Job ``i`` of a pool takes variant
``i mod len(variants)`` and draws its allocation from its own stream of
the seed; jobs of one variant share its graph and machine.  The same seed gives the same
pool, and both the program and the reference get the same arrays.

A job holds at least as many tasks as its allocation holds cores, so
several tasks may share a core; an allocation with more cores than
tasks is refused.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .ref.engine import Machine
from .spec import BENCH_DIR, load_named

PARTS = ("graph", "machine", "allocation")


@dataclasses.dataclass
class Job:
    """One mapping problem as plain arrays."""

    task_coords: np.ndarray   # (n, td) float64
    edges: np.ndarray         # (E, 2) int64, both directions listed
    weights: np.ndarray       # (E,) float64 message volumes
    alloc: np.ndarray         # (cores, ndim) int64, cores <= n
    machine: Machine
    task_weights: np.ndarray | None = None   # (n,) float64, or none
    variant: int = 0          # the configuration's variant it was made of


def kind(part: str, spec: dict, bench_dir=None):
    """``kinds/<part>/<kind>.py`` of the benchmark folder ``bench_dir``."""
    return load_named(Path(bench_dir or BENCH_DIR) / "kinds" / part,
                      spec.get("kind"), f"{part} kind")


def variants(config: dict) -> list[dict]:
    """The configuration's variants, each with all three parts."""
    out = config.get("variants") or [config]
    for i, v in enumerate(out):
        missing = [p for p in PARTS if not isinstance(v.get(p), dict)]
        if missing:
            raise ValueError(f"variant {i} of the configuration has no "
                             f"{missing}")
    return out


def job_pool(config: dict, seed: int, count: int, bench_dir=None
             ) -> list[Job]:
    """``count`` jobs of ``config``; job ``i`` takes variant
    ``i mod len(variants)`` and draws its allocation from its own
    stream of ``seed``."""
    made = []
    for i, v in enumerate(variants(config)):
        graph = kind("graph", v["graph"], bench_dir).build(v["graph"])
        coords, edges, weights, task_weights = (*graph, None)[:4]
        machine = kind("machine", v["machine"], bench_dir).build(
            v["machine"])
        alloc = kind("allocation", v["allocation"], bench_dir).build(
            v["allocation"], machine)
        made.append((dict(task_coords=coords, edges=edges, weights=weights,
                          machine=machine, task_weights=task_weights,
                          variant=i), alloc))
    streams = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(count)
    jobs = []
    for i, stream in enumerate(streams):
        shared, alloc = made[i % len(made)]
        cores = alloc.draw(np.random.default_rng(stream))
        if len(cores) > len(shared["task_coords"]):
            raise ValueError(
                f"job {i}'s allocation holds {len(cores)} cores for "
                f"{len(shared['task_coords'])} tasks: a job may have more "
                "tasks than cores, never fewer")
        jobs.append(Job(alloc=cores, **shared))
    return jobs
