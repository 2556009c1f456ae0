"""sweep.device_ms: mean over the window's sweeps (one a cold request) of
the card's time from the start of the sweep's partitions to the end of
its scoring: ``sweep.score``'s ``device_t1_s`` less
``sweep.partition``'s ``device_t0_s``, both read from the program's CUDA
timing events (armed by ``start()``), not from the profiler.
Milliseconds."""


def start():
    from repro_torch import obs
    arm = getattr(obs, "device_time", None)
    return bool(arm and arm(True))


def read(run):
    total, sweeps = 0.0, 0
    for fused in run.tree.named("pipeline.fused"):
        part = [s for s in run.tree.children(fused)
                if s.name == "sweep.partition"]
        score = [s for s in run.tree.children(fused)
                 if s.name == "sweep.score"]
        if len(part) != 1 or len(score) != 1:
            continue
        t0 = part[0].attrs.get("device_t0_s")
        t1 = score[0].attrs.get("device_t1_s")
        if t0 is None or t1 is None:
            continue
        total += t1 - t0
        sweeps += 1
    return total / sweeps * 1e3 if sweeps else None
