"""Mapping-as-a-service: a batching request server over the unified
mapping pipeline.

The paper's mapper is cheap enough to run at job-launch time for every
allocation shape it meets — so this module serves mapping decisions as
REQUESTS instead of one-shot scripts.  A :class:`MappingRequest` (task
graph + machine/allocation + objective/config) is canonicalised to a
content-addressed signature (:mod:`repro_torch.core.signature`);
:class:`MappingService` then

- serves repeat requests from a bounded LRU of mapping results
  (``warm`` responses — no partitioning, no scoring, no backend
  compiles);
- coalesces duplicate in-flight requests: concurrent submissions of the
  same problem share ONE pipeline pass and receive bit-identical
  results (``coalesced`` responses);
- routes misses through the process-wide shared
  :class:`repro_torch.mapping.MappingPipeline` registry
  (:func:`repro_torch.mapping.shared_pipeline`), so the evaluator is
  resolved once per process, not once per request (``cold`` responses).

Response schema: ``result`` (the :class:`repro_torch.core.MappingResult`
— treat as read-only, it is shared with the cache), ``signature``,
``status`` (cold/warm/coalesced) and ``latency_s``.

The cold path is ONE pipeline pass and an error propagates to the
caller: the degradation ladder, circuit breakers and deadlines of the
reference's ``serve/resilience.py`` are not part of this package yet,
so a failing kernel or device is never papered over by a slower rung.
A bounded admission queue sheds overload (:class:`ServiceOverloaded`).
Errors never enter the result LRU, and a failed in-flight computation
is recomputed by its waiters rather than replayed to them.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch import faults, obs
from repro_torch.core.signature import array_digest, mapping_signature
from repro_torch.mapping import PipelineConfig, shared_pipeline
from repro_torch.serve.cache import LRUCache


class ServiceOverloaded(RuntimeError):
    """Admission control refused the request (queue full)."""


# Short objective aliases accepted by make_request / the scenario
# registry ("wh" is the paper's WeightedHops rotation-search objective;
# "latency" is the TPU mesh constructor's lexicographic pair).
OBJECTIVES = {
    "wh": "weighted_hops",
    "latency": ("latency_max", "weighted_hops"),
}


@dataclasses.dataclass
class MappingRequest:
    """One mapping problem: what to map, onto what, optimising what.

    graph        : :class:`repro_torch.core.TaskGraph`.
    alloc        : :class:`repro_torch.core.Allocation` (machine + node rows).
    config       : :class:`repro_torch.mapping.PipelineConfig` — the full
                   pipeline knob set, including ``objective``.
    task_coords  : optional task-coordinate override (traffic-scaled
                   coordinates of a mesh constructor).
    task_weights : optional per-task weights for the partitioner.

    The request's identity is its CONTENT — two independently-built
    requests with equal arrays/config share a signature and therefore a
    cache entry.  The signature is computed once and memoised on the
    instance (requests are cheap handles; reuse them for hot paths).
    """

    graph: object
    alloc: object
    config: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)
    task_coords: np.ndarray | None = None
    task_weights: np.ndarray | None = None
    _signature: str | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def signature(self) -> str:
        if self._signature is None:
            extra = {}
            if self.task_coords is not None:
                extra["task_coords"] = array_digest(self.task_coords)
            if self.task_weights is not None:
                extra["task_weights"] = array_digest(self.task_weights)
            self._signature = mapping_signature(
                self.graph, self.alloc, self.config, extra or None)
        return self._signature


def make_request(graph, alloc, objective="wh", *, config=None,
                 task_coords=None, task_weights=None,
                 **overrides) -> MappingRequest:
    """Build a :class:`MappingRequest`.

    ``objective`` accepts an alias from :data:`OBJECTIVES`, a metric
    key, or a tuple of keys (lexicographic).  ``overrides`` are
    :class:`PipelineConfig` fields (``rotations=8``,
    ``hierarchy=HierarchySpec.node()``, ...); pass ``config`` to supply
    a full config instead (mutually exclusive with
    ``objective``/``overrides``).  Config validation happens at
    CONSTRUCTION — an unknown hierarchy raises a 4xx-style
    ``ValueError`` (listing the accepted values) here, before the
    request is ever admitted to the service.
    """
    if config is None:
        config = PipelineConfig(
            objective=OBJECTIVES.get(objective, objective), **overrides)
    elif overrides:
        raise ValueError("pass either config= or config-field overrides,"
                         " not both")
    return MappingRequest(graph, alloc, config,
                          task_coords=task_coords,
                          task_weights=task_weights)


@dataclasses.dataclass
class MappingResponse:
    """What the service returns for one request.

    result    : the mapping (shared with the cache — read-only).
    signature : the request's content signature (the cache key).
    status    : "cold" (pipeline ran), "warm" (LRU hit) or "coalesced"
                (shared an in-flight computation or a batch duplicate).
    latency_s : wall-clock seconds this request spent in the service.
    trace_id  : this request's trace (repro_torch.obs) — per-REQUEST, unlike
                ``result.stats["trace_id"]`` which names the trace that
                COMPUTED the (possibly cached, shared) result.
    """

    result: object
    signature: str
    status: str
    latency_s: float
    trace_id: str | None = None


class _InFlight:
    """One in-progress computation; duplicate requests wait on it."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class MappingService:
    """The request server: canonicalise, coalesce, cache, compute.

    capacity   : bound of the result LRU (entries, not bytes — a result
                 is one int array per request).
    max_inflight / max_queue : bounded admission (None = unlimited,
                 the default).  At most ``max_inflight`` cold
                 computations run concurrently; up to ``max_queue``
                 more block waiting; beyond that requests are SHED with
                 :class:`ServiceOverloaded` (counted in ``stats()``).
                 Warm hits and coalesced waiters are never queued.
    """

    def __init__(self, capacity: int = 256, *,
                 max_inflight: int | None = None,
                 max_queue: int = 8):
        self.results = LRUCache(capacity)
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self._inflight: dict[str, _InFlight] = {}
        self._lock = threading.Lock()
        self._counts = {"cold": 0, "warm": 0, "coalesced": 0}
        self._res_counts = {"shed": 0}
        self._adm = threading.Condition(threading.Lock())
        self._active = 0
        self._queued = 0
        # weakly tracked: this instance's stats() joins obs.snapshot()
        obs.register_object("services", self)

    # -- the miss path ---------------------------------------------------

    def _compute(self, request: MappingRequest):
        """Run the pipeline for a cache miss (test seam: override to
        instrument/block the cold path)."""
        faults.fire("serve.compute")
        pipe = shared_pipeline(request.config)
        return pipe.map(request.graph, request.alloc,
                        task_coords=request.task_coords,
                        task_weights=request.task_weights)

    def _execute(self, request: MappingRequest, t0: float):
        """Serve a cache miss: one ``_compute`` call.  There is no
        ladder below it — an error propagates."""
        return self._compute(request)

    # -- bounded admission ------------------------------------------------

    def _admit(self) -> None:
        if self.max_inflight is None:
            return
        with self._adm:
            if self._active < self.max_inflight:
                self._active += 1
                return
            if self._queued >= self.max_queue:
                self._bump("shed")
                raise ServiceOverloaded(
                    f"admission queue full ({self._active} active, "
                    f"{self._queued} queued)")
            self._queued += 1
            try:
                while self._active >= self.max_inflight:
                    self._adm.wait()
            finally:
                self._queued -= 1
            self._active += 1

    def _release(self) -> None:
        if self.max_inflight is None:
            return
        with self._adm:
            self._active -= 1
            self._adm.notify()

    def _bump(self, key: str) -> None:
        with self._lock:
            self._res_counts[key] += 1

    # -- public API ------------------------------------------------------

    def map(self, request: MappingRequest) -> MappingResponse:
        """Serve one request (thread-safe).

        Warm path: signature + one LRU lookup.  Concurrent duplicates
        of an uncached signature share one compute pass; exactly one
        caller is the owner, the rest block until it publishes.  A
        FAILED flight is never replayed to its waiters: each waiter
        retries the full lookup once (recomputing if it becomes the new
        owner) so a transient fault poisons nothing — only a repeated
        failure propagates.

        The whole walk runs inside one ``serve.request`` span: the root
        of the request's trace (``MappingResponse.trace_id``), covering
        the pipeline and backend spans below it.
        """
        with obs.span("serve.request") as root:
            resp = self._serve(request)
            root.annotate(status=resp.status,
                          signature=resp.signature[:16])
        return resp

    def _serve(self, request: MappingRequest) -> MappingResponse:
        t0 = time.perf_counter()
        faults.fire("serve.cache", on_evict=self.results.storm)
        sig = request.signature()
        waited = False
        while True:
            result = self.results.get(sig, count=not waited)
            if result is not None:
                return self._respond(result, sig, "warm", t0)
            with self._lock:
                # recheck under the lock: the owner may have published
                # between the miss above and here (uncounted — one
                # logical lookup must not book two misses)
                result = self.results.get(sig, count=False)
                if result is not None:
                    return self._respond(result, sig, "warm", t0)
                entry = self._inflight.get(sig)
                owner = entry is None
                if owner:
                    entry = self._inflight[sig] = _InFlight()
            if owner:
                break
            entry.event.wait()
            if entry.result is not None:
                return self._respond(entry.result, sig, "coalesced", t0)
            # the flight failed (or aborted) without publishing
            if waited:
                if entry.error is not None:
                    raise entry.error
                raise RuntimeError(
                    "in-flight mapping computation was aborted")
            waited = True  # retry once: recompute, don't replay errors

        try:
            self._admit()
            try:
                entry.result = self._execute(request, t0)
            finally:
                self._release()
            self.results.put(sig, entry.result)
        except BaseException as e:  # record aborts for waiters too
            entry.error = e
            raise
        finally:
            with self._lock:
                del self._inflight[sig]
            entry.event.set()
        return self._respond(entry.result, sig, "cold", t0)

    def map_many(self, requests, max_workers: int = 0) -> list:
        """Serve a batch, coalescing duplicates WITHIN the batch.

        Unique signatures are computed once (in submission order, or
        concurrently when ``max_workers > 1``); every later duplicate
        receives the first occurrence's result as a ``coalesced``
        response.  Responses line up with ``requests``.
        """
        first: dict[str, MappingRequest] = {}
        for req in requests:
            first.setdefault(req.signature(), req)
        unique = list(first.values())
        if max_workers > 1 and len(unique) > 1:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
                primary = list(pool.map(self.map, unique))
        else:
            primary = [self.map(r) for r in unique]
        by_sig = {r.signature: r for r in primary}
        out = []
        seen: set[str] = set()
        for req in requests:
            sig = req.signature()
            resp = by_sig[sig]
            if sig in seen:
                with self._lock:
                    self._counts["coalesced"] += 1
                obs.counter("serve.responses.coalesced")
                resp = dataclasses.replace(resp, status="coalesced",
                                           latency_s=0.0)
            seen.add(sig)
            out.append(resp)
        return out

    def stats(self) -> dict:
        """Cumulative service counters + the result-cache stats.

        ``cold``/``warm``/``coalesced``/``requests``/``inflight``/
        ``cache``, plus ``shed`` (requests refused by admission
        control).
        """
        with self._lock:
            counts = dict(self._counts)
            res = dict(self._res_counts)
        return {**counts, **res,
                "requests": (counts["cold"] + counts["warm"]
                             + counts["coalesced"]),
                "inflight": len(self._inflight),
                "cache": self.results.stats()}

    def _respond(self, result, sig, status, t0) -> MappingResponse:
        with self._lock:
            self._counts[status] += 1
        latency = time.perf_counter() - t0
        obs.counter(f"serve.responses.{status}")
        obs.observe("serve.latency_s", latency)
        sp = obs.current_span()
        return MappingResponse(result, sig, status, latency,
                               trace_id=(sp.trace_id if sp is not None
                                         else None))


# Process-wide convenience instance for ad-hoc callers that want one
# shared cache without owning a service object.
_DEFAULT: MappingService | None = None
_DEFAULT_LOCK = threading.Lock()


def default_service(capacity: int = 256) -> MappingService:
    """The lazily-created process-wide :class:`MappingService`.

    ``capacity`` only applies to the first call (it sizes the
    singleton's LRU); later calls return the existing instance.
    """
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MappingService(capacity)
        return _DEFAULT
