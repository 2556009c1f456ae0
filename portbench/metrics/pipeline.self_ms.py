"""pipeline.self_ms: mean over cold requests of the ``pipeline.map`` span
less its direct children: the machine transforms, the rotation
candidates and the pipeline's own bookkeeping on the host.  Host clock,
milliseconds."""


def read(run):
    maps = run.tree.named("pipeline.map")
    if not maps:
        return None
    return sum(run.tree.self_s(m) for m in maps) / len(maps) * 1e3
