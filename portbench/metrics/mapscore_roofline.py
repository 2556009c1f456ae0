"""mapscore_roofline: the scoring kernel's (K1's) share of its roofline,
in percent.

The least time of one launch's work (``pbench.cost.scoring_work``: the
bytes of each input read once and each output written once at the HBM
rate, or the operations at the float32 rate if that is longer, counted
from the request's shapes) over the profiler's device time of the
kernel's launches, per launch.  A launch is counted by the program's
``launch_count``, read as the window opens (``start``) and after it; its
kernels are the device operations whose names match ``PATTERNS``.  The
metric is read only where every launch is a rotation sweep's (one a
``pipeline.fused`` span), each scoring the request's whole candidate
stack: the tasks and cores of a flat request, the clusters and routers
of a node-hierarchy one."""

from pbench.cost import scoring_work
from pbench.ref.engine import OBJECTIVES

NAME = "mapscore_roofline"
PATTERNS = ("mapscore_",)


def launch_count() -> int:
    from repro_torch.kernels.mapscore import ops
    return ops.launch_count


def start():
    return launch_count()


def sweep_shapes(config: dict, mix: dict, job) -> dict:
    """The shapes of the stack a request's rotation sweep scores: tasks
    and cores one a task (flat), or the clusters and their contracted
    edges (node; the clusters depend on the task graph alone)."""
    m = job.machine
    tasks, edges = len(job.task_coords), len(job.edges)
    if mix["hierarchy"] == "node":
        from pbench.ref.hier import aggregate, router_view
        nrouters = len(router_view(job.alloc, m.nd)[0])
        arity = -(-len(job.alloc) // nrouters)      # cores a router
        tasks = min(nrouters, -(-tasks // arity))
        edges = len(aggregate(job.task_coords, job.edges, job.weights,
                              tasks, config["pipeline"]["sfc"])[3])
    elif mix["hierarchy"] != "flat":
        return None
    return {"tasks": tasks, "edges": edges, "dims": tuple(m.dims),
            "network_dims": m.nd,
            "traffic": "latency_max" in OBJECTIVES[
                config["pipeline"]["objective"]]}


def read(run):
    if NAME not in run.started:
        return None
    launches = launch_count() - run.started[NAME]
    fused = run.tree.named("pipeline.fused")
    if not launches or launches != len(fused):
        return None
    device_s = sum(d for name, _, d in run.ops
                   if any(p in name for p in PATTERNS))
    if device_s <= 0:
        return None
    cands = {f.attrs.get("candidates") for f in fused}
    if len(cands) != 1 or None in cands:
        return None
    shapes = sweep_shapes(run.config, run.mix, run.jobs[0])
    if shapes is None:
        return None
    work = scoring_work(candidates=cands.pop(), **shapes)
    return 100.0 * work["least_s"] / (device_s / launches)
