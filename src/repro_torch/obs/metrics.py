"""One process-wide telemetry registry for the whole mapping stack.

The stack's counters are scattered by nature: per-instance
``LRUCache.stats()`` and ``MappingService.stats()``, the kernel
wrapper's launch count, ``faults.stats()``.  :func:`snapshot` is the one
call that answers "what is this process doing".  Three provider groups
feed it:

- **caches** — compile caches; the port compiles nothing, so the
  section is always empty, kept so that a snapshot (and its Prometheus
  text) has the reference's shape.
- **objects** — live ``.stats()``-bearing instances
  (:class:`repro_torch.serve.MappingService`, ``LRUCache``) held by WEAK
  reference in bounded most-recent-first groups, so the registry never
  keeps test fixtures alive and never grows without bound.
- **providers** — named singletons (``faults.stats``).

On top of the adapters sits a plain named-series store: bounded,
lock-guarded :func:`counter` / :func:`gauge` / :func:`observe`
primitives for code that has no stats object to adapt (response
status counts, breaker trips, latency histograms).

Everything here is stdlib-only and import-light: the instrumented
modules import ``repro_torch.obs``, never the reverse — :func:`snapshot`
lazily imports the known cache/fault modules so one call returns every
counter family even in a process that has not touched them yet.
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import OrderedDict

# hard bounds: series/providers beyond these are dropped (counted in
# the snapshot's meta) rather than growing without limit
MAX_SERIES = 1024
MAX_OBJECTS_PER_GROUP = 64

# log2 histogram bucket upper bounds, seconds-flavoured: 1us .. ~64s
_BUCKET_BOUNDS = tuple(2.0 ** e for e in range(-20, 7))


class Histogram:
    """Fixed-bound log2 histogram: count/sum/min/max + bucket counts."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * (len(_BUCKET_BOUNDS) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        for i, bound in enumerate(_BUCKET_BOUNDS):
            if v <= bound:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def to_dict(self) -> dict:
        out = {"count": self.count, "sum": self.total}
        if self.count:
            out["min"] = self.vmin
            out["max"] = self.vmax
            out["mean"] = self.total / self.count
        return out


class MetricsRegistry:
    """Bounded, lock-guarded named counters/gauges/histograms plus the
    three adapter groups (see module docstring)."""

    def __init__(self, max_series: int = MAX_SERIES,
                 max_objects: int = MAX_OBJECTS_PER_GROUP):
        self._lock = threading.Lock()
        self.max_series = max_series
        self.max_objects = max_objects
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        self._dropped = 0
        # group -> OrderedDict[id(obj) -> weakref]: most recent last
        self._objects: dict[str, OrderedDict] = {}
        self._providers: dict[str, object] = {}

    # -- primitive series -------------------------------------------------

    def _slot(self, table: dict, name: str, factory):
        """Existing series or a new one; None when over the cap."""
        got = table.get(name)
        if got is None:
            if (len(self._counters) + len(self._gauges)
                    + len(self._hists)) >= self.max_series:
                self._dropped += 1
                return None
            got = table[name] = factory()
        return got

    def counter(self, name: str, inc: float = 1) -> None:
        with self._lock:
            if self._slot(self._counters, name, float) is not None:
                self._counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            if self._slot(self._gauges, name, float) is not None:
                self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._slot(self._hists, name, Histogram)
            if h is not None:
                h.observe(value)

    # -- adapter groups ---------------------------------------------------

    def register_object(self, group: str, obj) -> None:
        """Track ``obj`` (has ``.stats()``) weakly under ``group``."""
        with self._lock:
            od = self._objects.setdefault(group, OrderedDict())
            od[id(obj)] = weakref.ref(obj)
            self._prune_locked(od)

    def register_provider(self, name: str, fn) -> None:
        with self._lock:
            self._providers.setdefault(name, fn)

    def _prune_locked(self, od: OrderedDict) -> None:
        dead = [k for k, r in od.items() if r() is None]
        for k in dead:
            del od[k]
        while len(od) > self.max_objects:
            od.popitem(last=False)

    # -- snapshot ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Everything, in one dict — see :func:`snapshot` below."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.to_dict() for k, h in self._hists.items()}
            groups = {}
            for group, od in self._objects.items():
                self._prune_locked(od)
                groups[group] = [r() for r in od.values()]
            providers = dict(self._providers)
            dropped = self._dropped
        out = {
            "counters": counters, "gauges": gauges,
            "histograms": hists,
            "caches": {}, "meta": {"dropped_series": dropped},
        }
        for group, objs in groups.items():
            section = {}
            for i, obj in enumerate(objs):
                if obj is None:
                    continue
                try:
                    section[f"{group[:-1] if group.endswith('s') else group}"
                            f"#{i}"] = obj.stats()
                except Exception as e:
                    section[f"{group}#{i}"] = {"error": type(e).__name__}
            out[group] = section
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": type(e).__name__}
        out["derived"] = _derived(out)
        return out

    def reset_series(self) -> None:
        """Zero the primitive series (adapters keep their own state)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._dropped = 0


def _rate(hit: float, total: float) -> float | None:
    return (hit / total) if total > 0 else None


def _derived(snap: dict) -> dict:
    """Cross-family rates: one place that answers "is the process
    healthy" without the caller summing counters by hand."""
    caches = snap.get("caches", {})
    chits = sum(c.get("hits", 0) for c in caches.values())
    cmiss = sum(c.get("misses", 0) for c in caches.values())
    lrus = snap.get("lrus", {}).values()
    lhits = sum(c.get("hits", 0) for c in lrus)
    lmiss = sum(c.get("misses", 0) for c in lrus)
    out = {
        "compile_cache_hit_rate": _rate(chits, chits + cmiss),
        "compiles": cmiss,
        "result_cache_hit_rate": _rate(lhits, lhits + lmiss),
    }
    services = snap.get("services", {}).values()
    if services:
        requests = sum(s.get("requests", 0) for s in services)
        shed = sum(s.get("shed", 0) for s in services)
        degraded = sum(s.get("degraded", 0) for s in services)
        cold = sum(s.get("cold", 0) for s in services)
        misses = sum(s.get("deadline_misses", 0) for s in services)
        out.update(
            requests=requests,
            availability=_rate(requests, requests + shed),
            degraded_ratio=_rate(degraded, max(cold, 1)),
            deadline_miss_ratio=_rate(misses, max(requests, 1)),
        )
    faults = snap.get("faults")
    if isinstance(faults, list):
        out["faults_fired"] = sum(s.get("fired", 0) for s in faults)
    return out


# -- module-level singleton API -------------------------------------------

REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
observe = REGISTRY.observe
register_object = REGISTRY.register_object
register_provider = REGISTRY.register_provider


_ENSURED = False
_ENSURE_LOCK = threading.Lock()

# modules whose import registers a counter family at module level (the
# kernel wrapper registers its launch counter)
_CACHE_MODULES = (
    "repro_torch.kernels.mapscore.ops",
)


def _ensure_providers() -> None:
    """Best-effort import of every known counter-family module, so ONE
    :func:`snapshot` call covers the whole stack even in a process that
    has not exercised it yet.  Import failures leave
    that family absent rather than erroring the snapshot."""
    global _ENSURED
    with _ENSURE_LOCK:
        if _ENSURED:
            return
        import importlib
        for mod in _CACHE_MODULES:
            try:
                importlib.import_module(mod)
            except Exception:
                pass
        try:
            from repro_torch import faults
            REGISTRY.register_provider("faults", faults.stats)
        except Exception:  # pragma: no cover - faults is stdlib-only
            pass
        _ENSURED = True


def snapshot() -> dict:
    """The whole process's telemetry, one call:

    ``counters`` / ``gauges`` / ``histograms``
        the primitive series (response statuses, breaker trips,
        latency distributions).
    ``caches``
        compile caches: none in the port (nothing compiles), kept for
        the reference's shape.
    ``services`` / ``lrus``
        ``.stats()`` of the live (weakly-tracked) service and
        result-cache instances.
    ``faults``
        the armed fault specs' ``calls``/``fired`` counters.
    ``derived``
        cross-family rates: compile/result cache hit-rates,
        availability, degraded and deadline-miss ratios.
    """
    _ensure_providers()
    return REGISTRY.snapshot()

