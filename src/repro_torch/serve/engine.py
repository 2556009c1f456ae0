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

The cold path is RESILIENT (:mod:`repro_torch.serve.resilience`): the
request's device and its first rung's score and partition backends are
resolved before anything runs — an unreachable device, an unknown
backend, ``"hopper"`` on a CPU device or a kernel library that does not
build raises to the caller, and no rung is counted.  A rung that then
fails at run time (a failed launch, a device OOM) or overruns the
deadline walks the degradation ladder one rung down (fused -> unfused,
hierarchy depth -> 2, refine rounds -> 0; on a CPU device also torch ->
numpy scoring and partitioning) instead of surfacing the error.  On a
CUDA device the ladder never leaves the card's kernels: the error of
its last rung goes to the caller.  Per-rung circuit breakers skip
known-bad backends outright, a bounded admission queue sheds overload
(:class:`ServiceOverloaded`), and the served rung lands in
``MappingResult.stats["degraded"]`` plus the service counters
(:meth:`MappingService.stats`).  Errors never enter the result LRU, and
a failed in-flight computation is recomputed by its waiters rather than
replayed to them.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch import faults, obs
from repro_torch.core.signature import (array_digest, config_signature,
                                        mapping_signature)
from repro_torch.mapping import PipelineConfig, shared_pipeline
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.resilience import (
    BreakerBoard, DeadlineExceeded, ServiceOverloaded, degradation_ladder,
    rung_key)

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

    def hashed_bytes(self) -> int:
        """The array bytes :meth:`signature` hashes (0 once memoised)."""
        if self._signature is not None:
            return 0
        arrays = [self.graph.coords, self.graph.edges, self.graph.weights,
                  self.alloc.coords, self.task_coords, self.task_weights]
        return sum(np.asarray(a).nbytes for a in arrays if a is not None)


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
    """The request server: canonicalise, coalesce, cache, compute —
    and degrade gracefully instead of failing.

    capacity   : bound of the result LRU (entries, not bytes — a result
                 is one int array per request).
    deadline_s : optional per-request compute deadline.  A NON-terminal
                 ladder rung that overruns the remaining budget is
                 abandoned (its worker finishes off-thread, and device
                 work it has queued still runs ahead of the next rung's
                 on the same stream) and the request drops a rung; the
                 terminal rung always runs to completion so a slow
                 stage degrades latency class, never availability.
    max_inflight / max_queue : bounded admission (None = unlimited,
                 the default).  At most ``max_inflight`` cold
                 computations run concurrently; up to ``max_queue``
                 more block waiting; beyond that requests are SHED with
                 :class:`ServiceOverloaded` (counted in ``stats()``).
                 Warm hits and coalesced waiters are never queued.
    breaker_threshold / breaker_cooldown_s : per-rung circuit breakers
                 (:class:`repro_torch.serve.resilience.CircuitBreaker`)
                 keyed by RESOLVED backend combination and device type;
                 an open breaker skips its rung without paying the
                 failure latency.
    clock      : injectable monotonic clock for the breakers (tests).
    """

    def __init__(self, capacity: int = 256, *,
                 deadline_s: float | None = None,
                 max_inflight: int | None = None,
                 max_queue: int = 8,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.results = LRUCache(capacity)
        self.deadline_s = deadline_s
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self._inflight: dict[str, _InFlight] = {}
        self._lock = threading.Lock()
        self._counts = {"cold": 0, "warm": 0, "coalesced": 0}
        self._res_counts = {"degraded": 0, "shed": 0, "rung_failures": 0,
                            "deadline_misses": 0, "deadline_skips": 0,
                            "breaker_skips": 0}
        self._rung_counts: dict[str, int] = {}
        self._ladders: dict[tuple, list] = {}
        self._breakers = BreakerBoard(breaker_threshold,
                                      breaker_cooldown_s, clock)
        self._adm = threading.Condition(threading.Lock())
        self._active = 0
        self._queued = 0
        # weakly tracked: this instance's stats() joins obs.snapshot()
        obs.register_object("services", self)

    # -- the miss path ---------------------------------------------------

    def _compute(self, request: MappingRequest):
        """Run the pipeline for a cache miss (test seam: override to
        instrument/block the cold path).  Every ladder rung routes
        through here, so overrides see degraded configs too."""
        faults.fire("serve.compute")
        pipe = shared_pipeline(request.config)
        return pipe.map(request.graph, request.alloc,
                        task_coords=request.task_coords,
                        task_weights=request.task_weights)

    def _ladder_for(self, config: PipelineConfig) -> list:
        """The config's ``(rung_name, config, breaker_key)`` ladder,
        built once per config signature and device (the signature leaves
        the device out, and a scorer on ``cpu`` and one on ``cuda`` are
        different rungs).  Building it resolves every rung's backends on
        its device (:func:`rung_key`), so an unreachable device, an
        unknown backend, ``"hopper"`` on a CPU device or a kernel library
        that does not build raises HERE, to the caller, before any rung
        runs or is counted."""
        key = (config_signature(config), str(config.device))
        with self._lock:
            ladder = self._ladders.get(key)
        if ladder is None:
            ladder = [(name, cfg, rung_key(cfg))
                      for name, cfg in degradation_ladder(config)]
            with self._lock:
                ladder = self._ladders.setdefault(key, ladder)
        return ladder

    def _call_rung(self, request: MappingRequest,
                   budget_s: float | None):
        """One `_compute` attempt, bounded by ``budget_s`` when set.

        The deadline run executes on a daemon worker so an overrun can
        be abandoned; the worker's eventual result is discarded (the
        ladder has already moved on).
        """
        if budget_s is None:
            return self._compute(request)
        box: dict = {}
        # contextvars do not cross thread starts: re-parent the worker
        # under the submitting thread's span so the rung's pipeline and
        # backend spans stay inside the request's trace
        parent = obs.current_span()

        def worker():
            try:
                with obs.attach(parent):
                    box["result"] = self._compute(request)
            except BaseException as e:
                box["error"] = e

        th = threading.Thread(target=worker, daemon=True,
                              name="mapping-rung")
        th.start()
        th.join(budget_s)
        if th.is_alive():
            raise DeadlineExceeded(
                f"rung exceeded remaining deadline ({budget_s:.3f}s)")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _execute(self, request: MappingRequest, t0: float):
        """Walk the degradation ladder until a rung serves the request.

        Rung failures trip the rung's breaker and drop one rung; open
        breakers and an exhausted deadline budget skip rungs outright.
        The terminal rung runs unconditionally (no breaker gate, no
        deadline) — availability beats latency at the floor.  Only a
        terminal-rung failure propagates to the caller, and so does a
        config that does not resolve (:meth:`_ladder_for`).
        """
        ladder = self._ladder_for(request.config)
        last_err = None
        for i, (name, cfg, key) in enumerate(ladder):
            breaker = self._breakers.get(key)
            terminal = i == len(ladder) - 1
            # one span per rung CONSIDERED: skips close instantly with
            # a ``skipped`` attr, failures get ``error`` (span __exit__),
            # so a degraded request's trace shows the whole walk
            with obs.span("serve.rung", rung=name, index=i,
                          backend_key=key, terminal=terminal) as sp:
                if not terminal and not breaker.allow():
                    self._bump("breaker_skips")
                    obs.counter("serve.breaker_skips")
                    sp.annotate(skipped="breaker")
                    continue
                budget = None
                if self.deadline_s is not None and not terminal:
                    budget = self.deadline_s - (time.perf_counter() - t0)
                    if budget <= 0:
                        self._bump("deadline_skips")
                        obs.counter("serve.deadline_skips")
                        sp.annotate(skipped="deadline")
                        continue
                req = request if i == 0 else dataclasses.replace(
                    request, config=cfg, _signature=None)
                try:
                    result = self._call_rung(req, budget)
                except Exception as e:
                    last_err = e
                    breaker.record_failure()
                    self._bump("rung_failures")
                    obs.counter("serve.rung_failures")
                    sp.annotate(error=type(e).__name__)
                    if isinstance(e, DeadlineExceeded):
                        self._bump("deadline_misses")
                        obs.counter("serve.deadline_misses")
                    if terminal:
                        raise
                    continue
                breaker.record_success()
                if i > 0:
                    result.stats["degraded"] = name
                    self._bump("degraded")
                    obs.counter("serve.degraded")
                    sp.annotate(degraded=name)
                    with self._lock:
                        self._rung_counts[name] = \
                            self._rung_counts.get(name, 0) + 1
                return result
        raise last_err if last_err is not None else RuntimeError(
            "degradation ladder exhausted")  # pragma: no cover

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
        every ladder rung attempted and the pipeline/backend spans
        below them.
        """
        with obs.span("serve.request") as root:
            resp = self._serve(request)
            root.annotate(status=resp.status,
                          signature=resp.signature[:16])
        return resp

    def _serve(self, request: MappingRequest) -> MappingResponse:
        t0 = time.perf_counter()
        faults.fire("serve.cache", on_evict=self.results.storm)
        with obs.span("serve.signature", bytes=request.hashed_bytes()):
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
        ``cache``, plus ``degraded`` (requests served below their full
        rung) with the per-rung breakdown in ``rungs``,
        ``rung_failures`` (individual rung attempts that failed),
        ``deadline_misses`` (rungs abandoned at the deadline),
        ``deadline_skips`` (rungs never tried — budget already gone),
        ``breaker_skips`` (rungs skipped on an open breaker), ``shed``
        (requests refused by admission control), and ``breakers`` (the
        per-rung-key breaker states).
        """
        with self._lock:
            counts = dict(self._counts)
            res = dict(self._res_counts)
            rungs = dict(self._rung_counts)
        return {**counts, **res,
                "requests": (counts["cold"] + counts["warm"]
                             + counts["coalesced"]),
                "inflight": len(self._inflight),
                "rungs": rungs,
                "breakers": self._breakers.states(),
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
# shared cache without owning a service object — e.g. pass it to
# ``topology_mesh(..., service=default_service())`` so REPEAT mesh builds
# in one process hit the same cache.
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
