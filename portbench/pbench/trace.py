"""What a traced run reads: the program's spans, the profiler's device
operations, and the arithmetic that turns them into per-layer numbers.

Spans are plain records (:class:`SpanRec`), so the arithmetic is tested
on synthetic spans.  Device operations are ``(name, start_s, dur_s)`` on
the host's ``perf_counter`` clock, converted from the profiler's epoch
stamps; a marker operation enqueued as the traced window opens shows how
closely the two clocks agree (within about 0.2 ms on the card).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SpanRec:
    name: str
    span_id: int
    parent_id: int | None
    trace_id: str
    t0: float
    t1: float
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def from_span(sp) -> SpanRec:
    """A record of one of the program's finished spans."""
    return SpanRec(sp.name, sp.span_id, sp.parent_id, sp.trace_id, sp.t0,
                   sp.t1, dict(sp.attrs))


class Tree:
    """Finished spans with their children."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.kids: dict = {s.span_id: [] for s in self.spans}
        for s in self.spans:
            if s.parent_id in self.kids:
                self.kids[s.parent_id].append(s)

    def named(self, name: str) -> list[SpanRec]:
        return [s for s in self.spans if s.name == name]

    def children(self, sp: SpanRec) -> list[SpanRec]:
        return self.kids.get(sp.span_id, [])

    def descendants(self, sp: SpanRec, name: str) -> list[SpanRec]:
        out, todo = [], list(self.children(sp))
        while todo:
            s = todo.pop()
            if s.name == name:
                out.append(s)
            todo.extend(self.children(s))
        return out

    def self_s(self, sp: SpanRec, under: list[SpanRec] | None = None) -> float:
        """``sp``'s duration less the part of it that ``under`` (its
        direct children by default) covers."""
        kids = self.children(sp) if under is None else under
        return sp.dur - covered(sp.t0, sp.t1, [(k.t0, k.t1) for k in kids])


def covered(lo: float, hi: float, intervals) -> float:
    """Length of ``[lo, hi]`` that the union of ``intervals`` covers."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def busy_s(ops, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some device operation ran."""
    return covered(lo, hi, [(s, s + d) for _, s, d in ops])


def idle_gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of ``[lo, hi]`` in which no device operation ran."""
    gaps, end = [], lo
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, s + d)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans, times) -> list[str]:
    """For each of the ascending ``times``, the name of the innermost
    span open then (spans nest, so the open one that started last), or
    ``harness`` between the program's calls."""
    ordered = sorted(spans, key=lambda s: s.t0)
    out, active, i = [], [], 0
    for t in times:
        while i < len(ordered) and ordered[i].t0 <= t:
            active.append(ordered[i])
            i += 1
        active = [s for s in active if s.t1 >= t]
        out.append(active[-1].name if active else "harness")
    return out


def breakdown(ops, spans, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (the innermost span open at each gap's
    middle), each list the ``top`` largest."""
    by_op: dict = {}
    for name, _, d in ops:
        by_op[name] = by_op.get(name, 0.0) + d
    gaps = idle_gaps(ops, lo, hi)
    by_host: dict = {}
    for (a, b), key in zip(gaps, innermost(spans, [(a + b) / 2
                                                   for a, b in gaps])):
        by_host[key] = by_host.get(key, 0.0) + (b - a)

    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": largest(by_op), "idle_gaps": largest(by_host)}
