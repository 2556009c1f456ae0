"""hier.host_ms: mean over cold requests of the hierarchy's host stages,
``pipeline.coarsen`` + ``pipeline.refine`` + ``pipeline.polish``
(contractions, refinement, ``assign_cores``).  Host clock,
milliseconds."""

STAGES = ("pipeline.coarsen", "pipeline.refine", "pipeline.polish")


def read(run):
    maps = run.tree.named("pipeline.map")
    stages = [s for name in STAGES for s in run.tree.named(name)]
    if not maps or not stages:
        return None
    return sum(s.dur for s in stages) / len(maps) * 1e3
