"""sweep.partition_ops: mean over the window's sweeps of the profiler's
device operations that start inside a ``sweep.partition`` span's device
interval (``device_t0_s`` .. ``device_t1_s``, from the program's CUDA
timing events, armed by ``start()``): the operations both partitions
and the part matching put on the card.  Operations."""

from bisect import bisect_left, bisect_right


def start():
    from repro_torch import obs
    arm = getattr(obs, "device_time", None)
    return bool(arm and arm(True))


def read(run):
    spans = [s for s in run.tree.named("sweep.partition")
             if "device_t0_s" in s.attrs]
    if not spans or not run.ops:
        return None
    starts = sorted(s for _, s, _ in run.ops)
    count = sum(bisect_right(starts, s.attrs["device_t1_s"])
                - bisect_left(starts, s.attrs["device_t0_s"])
                for s in spans)
    return count / len(spans)
