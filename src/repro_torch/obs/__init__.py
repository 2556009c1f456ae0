"""repro_torch.obs — unified tracing + metrics for the whole mapping stack.

One dependency-free observability substrate, two parts:

- :mod:`repro_torch.obs.trace` — request-scoped SPANS: thread-safe context
  managers over monotonic clocks, nested parent/child structure, one
  trace id per service request, propagated through every degradation
  rung, pipeline stage and backend call site.
- :mod:`repro_torch.obs.metrics` — the process-wide telemetry REGISTRY:
  bounded named counters/gauges/histograms plus adapters absorbing the
  stack's scattered counters (compile caches, LRUs, services,
  breakers, faults) into one :func:`snapshot`.

The exporters (JSONL span logs, Chrome trace-event JSON, Prometheus
text) are not part of this package yet; spans stay in the in-process
ring buffer (:func:`finished`) and sinks attach through :func:`add_sink`.

This package imports only the stdlib; the instrumented modules import
it, never the reverse, so it is safe at the bottom of every layer.
"""

from .metrics import (REGISTRY, counter, gauge, instrument_compile_cache,
                      observe, register_cache, register_object,
                      register_provider, snapshot, span_rollup)
from .trace import (TRACER, Span, Tracer, add_sink, annotate, attach,
                    current_span, finished, format_tree, remove_sink,
                    reset, span, span_tree)

__all__ = [
    "REGISTRY", "Span", "TRACER", "Tracer", "add_sink", "annotate",
    "attach", "counter", "current_span", "finished", "format_tree",
    "gauge", "instrument_compile_cache", "observe", "register_cache",
    "register_object", "register_provider", "remove_sink", "reset",
    "snapshot", "span", "span_rollup", "span_tree",
]
