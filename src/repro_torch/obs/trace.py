"""Request-scoped tracing: thread-safe, context-manager spans.

The mapping stack's wall-clock story used to live in ad-hoc ``timings``
dicts (duplicated between ``mapping/pipeline.py`` and
``hier/levels.py``) with no nesting, no identity and no export.  This
module replaces them with SPANS:

- :func:`span` opens a named span as a context manager.  Spans nest:
  the innermost open span of the calling context is the parent, tracked
  through a :class:`contextvars.ContextVar` so concurrent requests on
  different threads never share a lineage.
- A span opened with no parent becomes a ROOT and mints a fresh
  **trace id**; every descendant inherits it.  One service request =
  one trace, covering the ladder rungs it attempted, the pipeline
  stages that ran and the backend call sites they resolved to.
- Clocks are monotonic (``time.perf_counter``); ``wall`` records the
  epoch start time for export alignment only and never feeds a
  duration.
- Finished spans land in a bounded ring (:func:`finished`) and are
  offered to registered SINKS (:func:`add_sink`) — an exporter is one.
  A sink that raises is dropped
  from the hot path silently: observability must never fail a request.
- ``contextvars`` do not cross thread boundaries; code that hops
  threads (the serve layer's deadline worker) re-parents explicitly
  with :func:`attach`.
- A span opened with ``device=`` is a DEVICE span: while
  :func:`device_time` has armed device timing on a process with CUDA,
  it records a timing event on the current stream as it opens and as
  it closes.  When its trace's root closes, the events are resolved
  against an anchor taken as the root opened, or at arming where the
  root opened before (``device_t0_s`` / ``device_t1_s``:
  when the card reached each event, on the spans' own ``perf_counter``
  clock; ``device_s``, their difference) and the span goes to the
  ring and the sinks then, before its root.  Disarmed, a device span is
  a host span.  Events are not kernels: nothing here shows on the
  profiler's device timeline.

The module is stdlib-only at import (torch is imported when device
timing is armed) and allocation-light: an unsampled process pays one
contextvar read per span plus a deque append on exit.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

# bounded ring of finished spans kept for snapshot/export (old spans
# fall off; exporters that need everything attach a sink instead)
MAX_FINISHED = 4096

_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_span", default=None)


class Span:
    """One timed, attributed node of a trace tree.

    name      : dotted stage/site name ("serve.request", "score.hopper").
    trace_id  : shared by every span of one request's tree.
    span_id   : unique within the process.
    parent_id : ``None`` for a root span.
    attrs     : flat str -> scalar annotations (backend resolved,
                degraded rung, cache outcome, candidate/point counts).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0", "t1", "wall", "thread", "dev")

    def __init__(self, name: str, trace_id: str,
                 parent_id: int | None = None, **attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_IDS)
        self.parent_id = parent_id
        self.attrs = dict(attrs)
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        self.wall = time.time()
        self.thread = threading.get_ident()
        # [clock, open event, close event] of a device span until its
        # trace's root resolves them; None for a host span
        self.dev: list | None = None

    @property
    def duration_s(self) -> float:
        """Monotonic seconds; measured up to now while still open."""
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return end - self.t0

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t0_s": self.t0, "duration_s": self.duration_s,
            "wall": self.wall, "thread": self.thread,
            "attrs": dict(self.attrs),
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, "
                f"dur={self.duration_s * 1e3:.3f}ms, {self.attrs})")


class DeviceClock:
    """The anchor between the card's timing events and ``perf_counter``:
    a timing event recorded with the card idle, and the host's clock read
    as soon as a poll sees it completed; of a few tries, the one whose
    record-to-completion took least (a try the host thread was
    descheduled in reads late)."""

    TRIES = 3

    def __init__(self, torch):
        self._torch = torch
        self._event = torch.cuda.Event
        torch.cuda.synchronize()
        best = None
        for _ in range(self.TRIES):
            ev = self._event(enable_timing=True)
            before = time.perf_counter()
            ev.record()
            while not ev.query():
                pass
            after = time.perf_counter()
            if best is None or after - before < best[0]:
                best = (after - before, ev, after)
        _, self.anchor, self.host_s = best

    def renewed(self) -> "DeviceClock":
        """A fresh anchor: the card's timer drifts against
        ``perf_counter``, so one anchor serves one trace."""
        return DeviceClock(self._torch)

    def mark(self):
        """A timing event recorded on the current stream."""
        ev = self._event(enable_timing=True)
        ev.record()
        return ev

    def at(self, ev) -> float:
        """When the card reached ``ev``, on the ``perf_counter`` clock
        (``ev`` must have completed)."""
        return self.host_s + self.anchor.elapsed_time(ev) * 1e-3


def _on_cuda(device) -> bool:
    return device is True or str(device).startswith("cuda")


class Tracer:
    """Span factory + finished-span ring + sink fan-out (thread-safe).

    Normally used through the module-level singleton (:data:`TRACER`)
    and the module functions below; tests construct private tracers.
    """

    def __init__(self, max_finished: int = MAX_FINISHED):
        self._lock = threading.Lock()
        self._finished: deque = deque(maxlen=max_finished)
        self._sinks: list = []
        # armed device timing (None: off), and the device spans held
        # back by trace id, one entry a root opened while armed
        self._clock: DeviceClock | None = None
        self._held: dict = {}

    # -- span lifecycle ---------------------------------------------------

    @contextmanager
    def span(self, name: str, device=False, **attrs):
        """Open a child of the context's current span (or a new root).

        The span closes on block exit; an escaping exception is recorded
        as ``attrs["error"]`` (exception type name) before propagating,
        so failed backend calls and ladder rungs are visible in the
        trace without any per-site boilerplate.

        ``device``: ``False`` for a host span; ``True`` (the current
        CUDA device) or the device the span's work runs on for a device
        span (see the module docstring), which on a device other than
        CUDA is a host span.  A device given by value is also kept as the
        ``device`` attribute.
        """
        if device is not False and device is not True:
            attrs["device"] = str(device)
        parent: Span | None = _CURRENT.get()
        if parent is None:
            sp = Span(name, uuid.uuid4().hex[:16], None, **attrs)
        else:
            sp = Span(name, parent.trace_id, parent.span_id, **attrs)
        clock = self._clock
        if clock is not None:
            if parent is None:
                # each trace resolves against an anchor of its own
                clock = self._clock = clock.renewed()
                with self._lock:
                    self._held[sp.trace_id] = []
            if device is not False and _on_cuda(device):
                sp.dev = [clock, clock.mark()]
        token = _CURRENT.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            if sp.dev is not None:
                sp.dev.append(sp.dev[0].mark())
            sp.t1 = time.perf_counter()
            _CURRENT.reset(token)
            self._finish(sp)

    @contextmanager
    def attach(self, parent: Span | None):
        """Adopt ``parent`` as the current span for this block.

        Contextvars never cross a ``threading.Thread`` start, so worker
        threads (the serve layer's deadline rung runner) re-parent with
        the span captured on the submitting thread — their descendants
        then join the request's trace instead of rooting new ones.
        ``attach(None)`` is a no-op passthrough.
        """
        if parent is None:
            yield None
            return
        token = _CURRENT.set(parent)
        try:
            yield parent
        finally:
            _CURRENT.reset(token)

    def current(self) -> Span | None:
        return _CURRENT.get()

    def _finish(self, sp: Span) -> None:
        ready = [sp]
        if sp.dev is not None or self._held:
            with self._lock:
                if sp.parent_id is None:
                    ready = self._held.pop(sp.trace_id, []) + ready
                elif sp.dev is not None and sp.trace_id in self._held:
                    self._held[sp.trace_id].append(sp)
                    return
            # the root has closed (or closed before this span did); in
            # a served request the answer is on the host, so every event
            # has completed and resolving waits on nothing
            for s in ready:
                if s.dev is not None:
                    clock, e0, e1 = s.dev
                    s.dev = None
                    e1.synchronize()
                    t0, t1 = clock.at(e0), clock.at(e1)
                    s.attrs.update(device_t0_s=t0, device_t1_s=t1,
                                   device_s=t1 - t0)
        with self._lock:
            self._finished.extend(ready)
            sinks = list(self._sinks)
        for s in ready:
            for sink in sinks:
                try:
                    sink(s)
                except Exception:
                    self.remove_sink(sink)

    # -- device timing ----------------------------------------------------

    def device_time(self, enabled: bool) -> bool:
        """Arm (with a fresh anchor) or disarm device timing; whether it
        is armed now.  Arming does nothing in a process without CUDA."""
        clock = None
        if enabled:
            import torch
            if torch.cuda.is_available():
                clock = DeviceClock(torch)
        self._clock = clock
        return clock is not None

    # -- finished spans ---------------------------------------------------

    def finished(self, trace_id: str | None = None) -> list:
        """Snapshot of the ring, oldest first; optionally one trace."""
        with self._lock:
            spans = list(self._finished)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()

    # -- sinks ------------------------------------------------------------

    def add_sink(self, sink) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)


def span_tree(spans) -> list:
    """Nest a flat span list into ``(span, children)`` root tuples.

    Children keep finish order.  Spans whose parent is not in ``spans``
    (e.g. fell off the ring) surface as roots rather than vanishing.
    """
    by_id = {s.span_id: s for s in spans}
    children: dict = {s.span_id: [] for s in spans}
    roots = []
    for s in spans:
        if s.parent_id in by_id:
            children[s.parent_id].append(s)
        else:
            roots.append(s)

    def build(s):
        return (s, [build(c) for c in children[s.span_id]])

    return [build(r) for r in roots]


def format_tree(spans, indent: str = "  ") -> str:
    """Human-readable span tree (the tracing demo's output)."""
    lines = []

    def walk(node, depth):
        s, kids = node
        attrs = " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
        lines.append(f"{indent * depth}{s.name}  "
                     f"{s.duration_s * 1e3:8.3f}ms"
                     f"{('  ' + attrs) if attrs else ''}")
        for kid in kids:
            walk(kid, depth + 1)

    for root in span_tree(spans):
        walk(root, 0)
    return "\n".join(lines)


# -- module-level singleton API -------------------------------------------

TRACER = Tracer()


def span(name: str, device=False, **attrs):
    """Open a span on the process tracer (see :meth:`Tracer.span`)."""
    return TRACER.span(name, device, **attrs)


def device_time(enabled: bool) -> bool:
    """Arm or disarm device timing for the process (see
    :meth:`Tracer.device_time`)."""
    return TRACER.device_time(enabled)


def attach(parent: Span | None):
    """Re-parent this context under ``parent`` (cross-thread traces)."""
    return TRACER.attach(parent)


def current_span() -> Span | None:
    """The innermost open span of the calling context (or ``None``)."""
    return TRACER.current()


def annotate(**attrs) -> None:
    """Attach attributes to the current span; no-op without one."""
    sp = TRACER.current()
    if sp is not None:
        sp.attrs.update(attrs)


def finished(trace_id: str | None = None) -> list:
    return TRACER.finished(trace_id)


def add_sink(sink) -> None:
    TRACER.add_sink(sink)


def remove_sink(sink) -> None:
    TRACER.remove_sink(sink)


def reset() -> None:
    TRACER.reset()
