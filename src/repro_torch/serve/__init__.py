"""repro_torch.serve — mapping-as-a-service over the unified pipeline.

- :mod:`repro_torch.serve.engine` — the mapping request server
  (:class:`MappingService`): content-addressed request signatures, a
  bounded LRU of mapping results, in-flight request coalescing, and a
  process-wide shared pipeline pool behind cache misses.
- :mod:`repro_torch.serve.scenarios` — the scenario registry: the full
  workload x allocation x hierarchy x objective cross-product that
  tests and the server draw problems from.
- :mod:`repro_torch.serve.resilience` — circuit breakers and the
  graceful-degradation ladder the service walks when a resolved rung
  fails at run time (fault injection lives in :mod:`repro_torch.faults`).
- :mod:`repro_torch.serve.decode` — the token-decode model server
  (:class:`ServeEngine`, prompt ingestion + greedy decode over a KV or
  SSM cache; every family of the model zoo).
"""

from .cache import LRUCache
from .engine import (OBJECTIVES, MappingRequest, MappingResponse,
                     MappingService, default_service, make_request)
from .resilience import (BreakerBoard, CircuitBreaker, DeadlineExceeded,
                         ServiceOverloaded, degradation_ladder, rung_key)
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
    "ALLOCATIONS", "BreakerBoard", "CircuitBreaker", "DeadlineExceeded",
    "HIERARCHIES", "LRUCache", "MappingRequest", "MappingResponse",
    "MappingService", "OBJECTIVES", "OBJECTIVE_KEYS", "Scenario",
    "ServeEngine", "ServiceOverloaded", "WORKLOADS", "all_scenarios",
    "default_service", "degradation_ladder", "get_scenario",
    "make_request", "rung_key", "scenario_names",
]
