"""mapscore_roofline: the scoring kernel's (K1's) share of its roofline,
in percent.

The least time of the window's launches' work (``pbench.cost.
scoring_work``: the bytes of each input read once and each output
written once at the HBM rate, or the operations at the float32 rate if
that is longer, counted from each launch's own request's shapes) over
the profiler's device time of the kernel's launches.  A launch is
counted by the program's ``launch_count``, read as the window opens
(``start``) and after it; its kernels are the device operations whose
names match ``PATTERNS``.  The metric is read only where every launch
is a rotation sweep's (one a ``pipeline.fused`` span), each scoring the
request's whole candidate stack: the tasks and cores of a flat request,
the clusters and routers of a node-hierarchy one, sized by the job that
request sent (its span's ``trace_id``), so that a pool mixing job shapes
weighs each launch by its own work."""

from pbench.cost import scoring_work
from pbench.ref.engine import OBJECTIVES

NAME = "mapscore_roofline"
PATTERNS = ("mapscore_",)


def launch_count() -> int:
    from repro_torch.kernels.mapscore import ops
    return ops.launch_count


def start():
    return launch_count()


def sweep_shapes(config: dict, mix: dict, job, contracted=None) -> dict:
    """The shapes of the stack a request's rotation sweep scores: tasks
    and cores one a task (flat), or the clusters and their contracted
    edges (node; the clusters depend on the task graph and their count
    alone, so ``contracted`` may keep the count of contracted edges by
    ``(job.variant, clusters)``)."""
    m = job.machine
    tasks, edges = len(job.task_coords), len(job.edges)
    if mix["hierarchy"] == "node":
        from pbench.ref.hier import aggregate, router_view
        nrouters = len(router_view(job.alloc, m.nd)[0])
        arity = -(-len(job.alloc) // nrouters)      # cores a router
        tasks = min(nrouters, -(-tasks // arity))
        memo = {} if contracted is None else contracted
        key = (job.variant, tasks)
        if key not in memo:
            memo[key] = len(aggregate(job.task_coords, job.edges,
                                      job.weights, tasks,
                                      config["pipeline"]["sfc"])[3])
        edges = memo[key]
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
    candidates = cands.pop()
    job_of = {a.get("trace_id"): a["job"] for a in run.requests}
    if any(f.trace_id not in job_of for f in fused):
        return None
    least, by_job, contracted = 0.0, {}, {}
    for f in fused:
        j = job_of[f.trace_id]
        if j not in by_job:
            shapes = sweep_shapes(run.config, run.mix, run.jobs[j],
                                  contracted)
            if shapes is None:
                return None
            by_job[j] = scoring_work(candidates=candidates,
                                     **shapes)["least_s"]
        least += by_job[j]
    return 100.0 * least / device_s
