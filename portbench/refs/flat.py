"""Reference of the ``flat`` hierarchy: one rotation sweep of tasks onto
cores (:func:`pbench.ref.engine.map_flat`), the job's per-task weights,
if it has any, passed to the task side's partitioner."""

from pbench.ref.engine import map_flat


def answer(job, **options) -> dict:
    return map_flat(job, task_weights=job.task_weights, **options)
