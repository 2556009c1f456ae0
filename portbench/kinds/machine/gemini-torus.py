"""Machine kind ``gemini-torus``: a torus of routers (``router_dims``,
``wrap``), each holding ``cores_per_router`` cores, with a repeating
pattern of link rates along each dim (``link_gbit_s``; any unit: only
their ratios move a mapping, and Latency(M) is read in its own)."""

from pbench.ref.engine import Machine


def build(spec: dict) -> Machine:
    dims = tuple(spec["router_dims"]) + (int(spec["cores_per_router"]),)
    return Machine(dims, tuple(spec["wrap"]) + (False,),
                   tuple(tuple(float(x) for x in p)
                         for p in spec["link_gbit_s"]))
