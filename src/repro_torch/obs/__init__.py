"""repro_torch.obs — unified tracing + metrics for the whole mapping stack.

One dependency-free observability substrate, three parts:

- :mod:`repro_torch.obs.trace` — request-scoped SPANS: thread-safe context
  managers over monotonic clocks, nested parent/child structure, one
  trace id per service request, propagated through every degradation
  rung, pipeline stage and backend call site; device spans carry when
  the card ran their work once :func:`device_time` arms timing.
- :mod:`repro_torch.obs.metrics` — the process-wide telemetry REGISTRY:
  bounded named counters/gauges/histograms plus adapters absorbing the
  stack's scattered counters (LRUs, services, breakers, faults, kernel
  launches) into one :func:`snapshot`.
- :mod:`repro_torch.obs.export` — JSONL span logs (``REPRO_TRACE=path``),
  Chrome trace-event JSON for Perfetto, Prometheus text exposition,
  and a ``torch.profiler`` bridge (``REPRO_TORCH_PROFILE=dir``).

This package imports only the stdlib (the profiler bridge imports torch
when armed); the instrumented modules import it, never the reverse, so
it is safe at the bottom of every layer.
"""

from .export import (JsonlSink, chrome_trace, install_env_sink,
                     prometheus_text, read_jsonl, torch_profile,
                     write_chrome_trace)
from .metrics import (REGISTRY, counter, gauge, observe, register_object,
                      register_provider, snapshot)
from .trace import (TRACER, Span, Tracer, add_sink, annotate, attach,
                    current_span, device_time, finished, format_tree,
                    remove_sink, reset, span, span_tree)

# arm the process-wide JSONL event log when REPRO_TRACE names a path
_ENV_SINK = install_env_sink()

__all__ = [
    "JsonlSink", "REGISTRY", "Span", "TRACER", "Tracer", "add_sink",
    "annotate", "attach", "chrome_trace", "counter", "current_span",
    "device_time", "finished", "format_tree", "gauge",
    "install_env_sink", "observe", "prometheus_text", "read_jsonl",
    "register_object", "register_provider", "remove_sink", "reset",
    "snapshot", "span", "span_tree", "torch_profile",
    "write_chrome_trace",
]
