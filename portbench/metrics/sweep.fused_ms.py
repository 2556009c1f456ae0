"""sweep.fused_ms: mean ``pipeline.fused`` span per cold request: the
one-pass device sweep (uploads, both partitions, part matching, the
scoring kernel, the winner's copy back, which waits for the device).  In
a hierarchical request, the router-level sweep.  Host clock,
milliseconds."""


def read(run):
    maps = run.tree.named("pipeline.map")
    fused = run.tree.named("pipeline.fused")
    if not maps or not fused:
        return None
    return sum(f.dur for f in fused) / len(maps) * 1e3
