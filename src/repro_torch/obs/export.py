"""Exporters: JSONL span log, Chrome trace events, Prometheus text.

Three consumption paths for the spans/snapshot the rest of
:mod:`repro_torch.obs` collects, all dependency-free:

- :class:`JsonlSink` — an append-only JSON-lines event log, one object
  per finished span.  Armed process-wide by the ``REPRO_TRACE=path``
  environment variable (checked once at ``repro_torch.obs`` import).
- :func:`chrome_trace` — the Chrome trace-event JSON format
  (``"X"``-phase complete events), loadable in Perfetto / DevTools
  for a flame view of a request.
- :func:`prometheus_text` — text exposition of :func:`obs.snapshot`
  for scrape-style collection.

Plus a device bridge: :func:`torch_profile` wraps a block in
``torch.profiler.profile`` when ``REPRO_TORCH_PROFILE=dir`` is set and
writes the profiler's Chrome trace (host operations and, on a CUDA
device, the card's kernels and copies) into ``dir``, so device-level
traces land next to the host spans; with the variable unset it does
nothing and imports nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading

from . import metrics as _metrics
from . import trace as _trace

TRACE_ENV = "REPRO_TRACE"
# the Chrome trace's row of the card's intervals (no thread has id 0)
DEVICE_TID = 0
TORCH_PROFILE_ENV = "REPRO_TORCH_PROFILE"


class JsonlSink:
    """Span sink appending one JSON object per line to ``path``.

    Thread-safe; the file opens lazily on the first span and flushes
    per write so a crashed process still leaves a parseable log.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def __call__(self, span) -> None:
        line = json.dumps(span.to_dict(), sort_keys=True,
                          default=str)
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def install_env_sink(tracer=None) -> JsonlSink | None:
    """Arm a :class:`JsonlSink` from ``REPRO_TRACE`` (None when unset).

    Called once by ``repro_torch.obs`` at import; callers wanting a second
    log (or a log after changing the env) call it again themselves.
    """
    path = os.environ.get(TRACE_ENV)
    if not path:
        return None
    sink = JsonlSink(path)
    (tracer or _trace.TRACER).add_sink(sink)
    return sink


def read_jsonl(path: str) -> list:
    """Parse a JSONL span log back into dicts (the CI validation)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# -- Chrome trace-event format --------------------------------------------

def chrome_trace(spans=None) -> dict:
    """Spans as a Chrome trace-event document (Perfetto-viewable).

    ``spans`` defaults to the tracer's finished ring.  Timestamps are
    the spans' monotonic starts in microseconds (one shared origin per
    process); each trace id becomes a distinct ``pid`` row so requests
    separate visually, threads map to ``tid``.  A device span's interval
    on the card (``device_t0_s`` .. ``device_t1_s``, the same clock) is
    one more event on its trace's ``device`` row (``tid`` 0).
    """
    spans = _trace.finished() if spans is None else list(spans)
    pids: dict = {}
    device_rows: set = set()
    events = []
    for s in spans:
        pid = pids.setdefault(s.trace_id, len(pids))
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                "parent_id": s.parent_id, **s.attrs}
        events.append({
            "ph": "X", "name": s.name,
            "ts": s.t0 * 1e6, "dur": s.duration_s * 1e6,
            "pid": pid, "tid": s.thread, "args": args,
        })
        if "device_t0_s" in s.attrs:
            if pid not in device_rows:
                device_rows.add(pid)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": DEVICE_TID,
                               "args": {"name": "device"}})
            events.append({
                "ph": "X", "name": s.name,
                "ts": s.attrs["device_t0_s"] * 1e6,
                "dur": s.attrs["device_s"] * 1e6,
                "pid": pid, "tid": DEVICE_TID, "args": args,
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "repro_torch.obs",
            "traces": {tid: pid for tid, pid in pids.items()},
        },
    }


def write_chrome_trace(path: str, spans=None) -> dict:
    doc = chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc


# -- Prometheus text exposition -------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    # the reference's family names, so one dashboard reads both packages
    return "repro_" + _NAME_RE.sub("_", name)


def _fmt(value) -> str:
    if value is None:
        return "NaN"
    if isinstance(value, bool):
        return str(int(value))
    return repr(float(value))


def prometheus_text(snap: dict | None = None) -> str:
    """The snapshot in Prometheus text exposition format (0.0.4).

    Scalar counters/gauges become plain series, histograms expose
    ``_count``/``_sum``, compile caches and LRUs become labelled
    families (``repro_compile_cache_hits{cache="fused"}``), service
    stats flatten to labelled scalars, and every derived rate is a
    gauge.  Nested non-scalar stats (breaker states, rung breakdowns)
    are skipped — traces, not scrapes, carry structure.
    """
    snap = _metrics.snapshot() if snap is None else snap
    # one (kind, samples) family per metric name: the exposition format
    # allows each name exactly one TYPE line
    families: dict = {}

    def add(name, kind, labels, value):
        fam = families.setdefault(name, (kind, []))
        fam[1].append((labels, value))

    for key, val in sorted(snap.get("counters", {}).items()):
        add(_metric_name(key + "_total"), "counter", {}, val)
    for key, val in sorted(snap.get("gauges", {}).items()):
        add(_metric_name(key), "gauge", {}, val)
    for key, h in sorted(snap.get("histograms", {}).items()):
        base = _metric_name(key)
        add(base + "_count", "counter", {}, h.get("count", 0))
        add(base + "_sum", "counter", {}, h.get("sum", 0.0))
    for name, stats in sorted(snap.get("caches", {}).items()):
        for field in ("hits", "misses", "entries"):
            add(f"repro_compile_cache_{field}", "counter",
                {"cache": name}, stats.get(field, 0))
    for group in ("lrus", "services"):
        for name, stats in sorted(snap.get(group, {}).items()):
            for field, value in sorted(stats.items()):
                if isinstance(value, (bool, int, float)):
                    add(_metric_name(f"{group}_{field}"), "gauge",
                        {"instance": name}, value)
    for key, val in sorted(snap.get("derived", {}).items()):
        if isinstance(val, (bool, int, float)) or val is None:
            add(_metric_name("derived_" + key), "gauge", {}, val)

    lines = []
    for name, (kind, samples) in families.items():
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lab = ("{" + ",".join(f'{k}="{v}"'
                                  for k, v in labels.items()) + "}"
                   if labels else "")
            lines.append(f"{name}{lab} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# -- torch profiler bridge ------------------------------------------------

_PROFILES = itertools.count()


@contextlib.contextmanager
def torch_profile(label: str = "repro_torch", device="cuda"):
    """``torch.profiler.profile`` around a block when
    ``REPRO_TORCH_PROFILE`` names a directory (created if missing); a
    no-op otherwise.

    The block runs inside a ``torch.profile`` span; on exit the
    profiler's Chrome trace is written to
    ``<dir>/<label>.<pid>.<n>.json`` and the span annotated with its
    ``path``.  The CUDA activity is recorded exactly when ``device`` is
    a CUDA device, which must then be reachable (it raises otherwise),
    so a profile of card work cannot quietly hold host events only.
    Yields the directory, or ``None`` when disarmed.
    """
    outdir = os.environ.get(TORCH_PROFILE_ENV)
    if not outdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir,
                        f"{label}.{os.getpid()}.{next(_PROFILES)}.json")
    with _trace.span("torch.profile", label=label, outdir=outdir,
                     device=str(device)) as sp:
        with profile(activities=activities) as prof:
            yield outdir
        prof.export_chrome_trace(path)
        sp.annotate(path=path)
