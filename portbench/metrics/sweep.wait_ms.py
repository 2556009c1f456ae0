"""sweep.wait_ms: mean over cold requests of the ``sweep.select`` span:
the first copy back of the sweep's scores, which waits for the card to
finish both partitions and the scoring, then the winner's pick.  Host
clock, milliseconds."""


def read(run):
    maps = run.tree.named("pipeline.map")
    sel = run.tree.named("sweep.select")
    if not maps or not sel:
        return None
    return sum(s.dur for s in sel) / len(maps) * 1e3
