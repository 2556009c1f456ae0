"""The comparison that decides ``correct``.

Once the window has closed, a sample of the jobs served in it, drawn
from the seed, is mapped again by the plain reference of the mix's
hierarchy, ``refs/<hierarchy>.py`` beside this package (its
``answer(job, **options)``, built on :mod:`pbench.ref`), and every
answer the window served for those jobs is held against it:

- ``wrong_tasks``: the most tasks of one answer placed on another core
  than the reference places them;
- ``wrong_rotations``: answers whose winning rotation is not the
  reference's;
- ``score_gap``: the largest gap of an answer's score to the
  reference's, relative to the reference's;
- ``unanswered``: judged requests that failed, or that the service
  answered from a lower rung than the one asked for.

The first, second and last are exact (limit 0).  The score's limit is
set from the program's and the control's readings (see ``PERF.md``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .spec import BENCH_DIR, load_named

LIMITS = {"wrong_tasks": 0, "wrong_rotations": 0, "score_gap": 1e-4,
          "unanswered": 0}


def sample_jobs(served: list[int], seed: int, k: int) -> list[int]:
    """``k`` of the distinct jobs in ``served``, drawn from the seed."""
    jobs = sorted(set(served))
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), 0x1d6e]))
    return sorted(rng.choice(jobs, size=min(k, len(jobs)),
                             replace=False).tolist())


def reference(hierarchy: str, bench_dir=None):
    """The ``answer`` of ``refs/<hierarchy>.py`` in the benchmark folder
    ``bench_dir``; a hierarchy with no file is refused (``ValueError``)."""
    return load_named(Path(bench_dir or BENCH_DIR) / "refs", hierarchy,
                      "hierarchy reference").answer


def reference_answers(jobs: dict, options: dict, hierarchy: str,
                      bench_dir=None) -> dict:
    """The reference's answer for each ``{index: Job}``."""
    answer = reference(hierarchy, bench_dir)
    return {i: answer(job, **options) for i, job in jobs.items()}


def compare(answers: list[dict], refs: dict) -> dict:
    """The compared numbers of ``answers`` (one dict a judged request:
    ``job``, and ``task_to_proc``, ``rotation``, ``score`` or
    ``failed``) against ``refs``."""
    out = {"wrong_tasks": 0, "wrong_rotations": 0, "score_gap": 0.0,
           "unanswered": 0}
    for a in answers:
        ref = refs[a["job"]]
        if a.get("failed"):
            out["unanswered"] += 1
            continue
        t2p = np.asarray(a["task_to_proc"])
        want = ref["task_to_proc"]
        wrong = (len(want) if t2p.shape != want.shape
                 else int((t2p != want).sum()))
        out["wrong_tasks"] = max(out["wrong_tasks"], wrong)
        if tuple(map(tuple, a["rotation"])) != tuple(map(tuple,
                                                         ref["rotation"])):
            out["wrong_rotations"] += 1
        gap = abs(float(a["score"]) - ref["score"]) / max(
            abs(ref["score"]), 1e-300)
        out["score_gap"] = max(out["score_gap"], gap)
    return out


def verdict(numbers: dict, limits: dict = LIMITS) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
