"""service.request_ms_p90: the 90th percentile (nearest rank) of every
request's latency in the traced window, from just before
``MappingService.map`` to its return; a failed or degraded request counts
as infinitely slow.  The same quantity as the end-to-end
``request_ms_p90``, read per layer in the cells whose host drifts too
far from run to run for that metric's bound.  Host clock, milliseconds."""

import math

from pbench.cell import p90


def read(run):
    if not run.requests:
        return None
    return p90([math.inf if a["failed"] else a["t1"] - a["t0"]
                for a in run.requests]) * 1e3
