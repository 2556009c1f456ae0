"""service.self_ms: mean over the window's requests of the ``serve.request``
span less the ``pipeline.map`` span beneath it (inside a ``serve.rung``):
signature hashing, the LRU, the ladder's bookkeeping.  A warm answer is
all service.  Host clock, milliseconds."""


def read(run):
    reqs = run.tree.named("serve.request")
    if not reqs:
        return None
    total = sum(run.tree.self_s(r, run.tree.descendants(r, "pipeline.map"))
                for r in reqs)
    return total / len(reqs) * 1e3
