"""sweep.host_ms: mean over cold requests of the host's work in the
one-pass sweep before its first read: the ``sweep.plan``,
``sweep.upload``, ``sweep.partition`` and ``sweep.score`` spans
(planning, and enqueueing the uploads, both partitions and the scoring).
Host clock, milliseconds."""

STEPS = ("sweep.plan", "sweep.upload", "sweep.partition", "sweep.score")


def read(run):
    maps = run.tree.named("pipeline.map")
    steps = [s for name in STEPS for s in run.tree.named(name)]
    if not maps or not steps:
        return None
    return sum(s.dur for s in steps) / len(maps) * 1e3
