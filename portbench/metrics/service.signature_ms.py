"""service.signature_ms: mean over the window's requests of the
``serve.signature`` span, the hashing of the request's arrays into its
cache key (nothing once the request has memoised it).  Host clock,
milliseconds."""


def read(run):
    reqs = run.tree.named("serve.request")
    sigs = run.tree.named("serve.signature")
    if not reqs or not sigs:
        return None
    return sum(s.dur for s in sigs) / len(reqs) * 1e3
