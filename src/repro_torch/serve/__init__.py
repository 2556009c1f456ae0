"""repro_torch.serve — mapping-as-a-service over the unified pipeline.

- :mod:`repro_torch.serve.engine` — the mapping request server
  (:class:`MappingService`): content-addressed request signatures, a
  bounded LRU of mapping results, in-flight request coalescing, and a
  process-wide shared pipeline pool behind cache misses.
- :mod:`repro_torch.serve.scenarios` — the scenario registry: the full
  workload x allocation x hierarchy x objective cross-product that
  tests and the server draw problems from.

- :mod:`repro_torch.serve.decode` — the token-decode model server
  (:class:`ServeEngine`, prompt ingestion + greedy decode over a KV or
  SSM cache; the dense, ssm and hybrid families).

The degradation ladder and circuit breakers of the reference package are
not part of this package yet: a cold request is one pipeline pass.
"""

from .cache import LRUCache
from .engine import (OBJECTIVES, MappingRequest, MappingResponse,
                     MappingService, ServiceOverloaded, default_service,
                     make_request)
from .scenarios import (ALLOCATIONS, HIERARCHIES, OBJECTIVE_KEYS,
                        WORKLOADS, Scenario, all_scenarios, get_scenario,
                        scenario_names)


def __getattr__(name):
    # lazy re-export: ServeEngine pulls in the model stack, which the
    # mapping service itself never needs (PEP 562)
    if name == "ServeEngine":
        from .decode import ServeEngine
        return ServeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ALLOCATIONS", "HIERARCHIES", "LRUCache", "MappingRequest",
    "MappingResponse", "MappingService", "OBJECTIVES", "OBJECTIVE_KEYS",
    "Scenario", "ServeEngine", "ServiceOverloaded", "WORKLOADS",
    "all_scenarios",
    "default_service", "get_scenario", "make_request", "scenario_names",
]
