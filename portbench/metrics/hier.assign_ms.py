"""hier.assign_ms: mean over cold requests of the ``hier.assign_cores``
spans: dealing each cluster's tasks onto its router's cores (and, in a
deeper hierarchy, each group's children onto its units).  Host clock,
milliseconds."""


def read(run):
    maps = run.tree.named("pipeline.map")
    spans = run.tree.named("hier.assign_cores")
    if not maps or not spans:
        return None
    return sum(s.dur for s in spans) / len(maps) * 1e3
