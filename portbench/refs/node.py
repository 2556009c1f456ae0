"""Reference of the ``node`` hierarchy: tasks coarsened to one cluster
a router, swept, refined and dealt onto cores
(:func:`pbench.ref.hier.map_node`)."""

from pbench.ref.hier import map_node


def answer(job, **options) -> dict:
    if job.task_weights is not None:
        raise ValueError("the node reference takes no per-task weights")
    return map_node(job, **options)
