"""Deterministic, seedable fault injection for the serving stack.

The serving stack needs accelerator failures ON DEMAND: kernel build
failures, ``torch.cuda.OutOfMemoryError``-style device OOMs, hung/slow
stages and cache-eviction storms, injected at the exact call sites where
the real ones would surface.  This module is the registry those sites
consult.  It is dependency-free and dormant by default: with no specs
installed, :func:`fire` is one attribute read and a falsy check.

Instrumented sites (grep for ``faults.fire``):

==================  =====================================================
site                where it fires
==================  =====================================================
``score.numpy``     every scoring call resolved to the numpy evaluator
``score.torch``     every scoring call resolved to the torch evaluator
``score.hopper``    every scoring call resolved to the CUDA kernel
``kernel.mapscore`` inside the kernel wrapper, before the launch
``serve.compute``   the service's cold path, before the pipeline runs
``serve.cache``     every service request, before the LRU lookup (the
                    ``evict`` kind storms the result cache here)
==================  =====================================================

Faults are configured programmatically (:func:`install`,
:func:`injected`) or via the environment::

    REPRO_FAULTS="score.torch:error:count=1,score.hopper:slow:delay=0.2"

Each comma-separated spec is ``site:kind[:key=value]*``.  ``site`` is an
``fnmatch`` pattern (``score.*`` matches every scoring backend).  Kinds:

``error``    raise :class:`InjectedFault` (a generic backend failure).
``compile``  raise :class:`InjectedCompileError` (lowering/compile
             failure — the kind a first kernel build can trigger).
``oom``      raise :class:`InjectedDeviceOOM` with a
             ``RESOURCE_EXHAUSTED``-style message.
``slow``     sleep ``delay`` seconds (default 0.05), then continue —
             models a hung kernel / pathological recompile; pair with a
             service deadline to exercise timeout-driven degradation.
``evict``    invoke the site's eviction callback (the serve layer passes
             ``LRUCache.storm``) — a cache-eviction storm.

Options (all optional, integers/floats parsed from the env string):

``count``  fire at most N times, then stay dormant (default: unlimited).
``after``  skip the first N matching calls before arming.
``delay``  sleep seconds for ``slow``.
``prob``   per-call fire probability in [0, 1] (default 1).
``seed``   seeds the spec's private RNG stream, so a probabilistic
           schedule replays IDENTICALLY across runs — chaos testing
           stays deterministic.

Every spec keeps ``calls``/``fired`` counters (:func:`stats`), so tests
and benchmarks can assert a fault actually hit its site.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import threading
import time
from contextlib import contextmanager

ENV_VAR = "REPRO_FAULTS"
KINDS = ("error", "compile", "oom", "slow", "evict")


class InjectedFault(RuntimeError):
    """A fault raised by the injection registry (generic backend error)."""


class InjectedCompileError(InjectedFault):
    """Injected compilation/lowering failure."""


class InjectedDeviceOOM(InjectedFault):
    """Injected device allocator OOM (``RESOURCE_EXHAUSTED`` style)."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: where, what, and the deterministic firing rule."""

    site: str                 # fnmatch pattern over site names
    kind: str                 # one of KINDS
    count: int | None = None  # max fires; None = unlimited
    after: int = 0            # skip the first N matching calls
    delay: float = 0.05       # sleep seconds (kind == "slow")
    prob: float = 1.0         # per-call fire probability
    seed: int = 0             # RNG stream for prob < 1 (deterministic)
    calls: int = 0            # matching calls seen (read-only)
    fired: int = 0            # times actually fired (read-only)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; options: {KINDS}")
        self._rng = random.Random(self.seed) if self.prob < 1.0 else None

    def _should_fire(self) -> bool:
        """Advance the spec's counters/RNG; True when the fault fires.

        The RNG draw happens on EVERY armed call (even ones vetoed by
        ``count``), so a spec's firing pattern depends only on its own
        call sequence — replayable under ``seed``.
        """
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self._rng is not None and self._rng.random() >= self.prob:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        self.fired += 1
        return True


class FaultRegistry:
    """Thread-safe spec store; normally used via the module singleton."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []

    # -- configuration ---------------------------------------------------

    def install(self, site: str, kind: str, **opts) -> FaultSpec:
        spec = FaultSpec(site, kind, **opts)
        with self._lock:
            self._specs.append(spec)
        return spec

    def remove(self, spec: FaultSpec) -> None:
        with self._lock:
            if spec in self._specs:
                self._specs.remove(spec)

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()

    def load_env(self, value: str | None = None) -> list[FaultSpec]:
        """(Re)install specs from ``REPRO_FAULTS`` (or ``value``)."""
        raw = os.environ.get(ENV_VAR, "") if value is None else value
        return [self.install(site, kind, **opts)
                for site, kind, opts in parse_schedule(raw)]

    # -- the hot hook ----------------------------------------------------

    def fire(self, site: str, on_evict=None) -> None:
        """Consult every armed spec matching ``site`` (cheap when none).

        Non-raising kinds (``slow``/``evict``) act and fall through so a
        later matching spec still gets its turn; raising kinds propagate
        immediately.
        """
        if not self._specs:
            return
        actions = []
        with self._lock:
            for spec in self._specs:
                if fnmatch.fnmatchcase(site, spec.site) \
                        and spec._should_fire():
                    actions.append(spec)
        for spec in actions:
            if spec.kind == "slow":
                time.sleep(spec.delay)
            elif spec.kind == "evict":
                if on_evict is not None:
                    on_evict()
            elif spec.kind == "compile":
                raise InjectedCompileError(
                    f"injected compile failure at {site!r}")
            elif spec.kind == "oom":
                raise InjectedDeviceOOM(
                    "RESOURCE_EXHAUSTED: injected out-of-memory while "
                    f"allocating device buffer at {site!r}")
            else:
                raise InjectedFault(f"injected fault at {site!r}")

    # -- observability ---------------------------------------------------

    def stats(self) -> list[dict]:
        with self._lock:
            return [{"site": s.site, "kind": s.kind, "calls": s.calls,
                     "fired": s.fired} for s in self._specs]

    @property
    def active(self) -> bool:
        return bool(self._specs)


def parse_schedule(raw: str) -> list[tuple]:
    """Parse a ``REPRO_FAULTS`` string into ``(site, kind, opts)`` rows."""
    out = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        fields = item.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"bad fault spec {item!r}: want site:kind[:key=value]*")
        site, kind = fields[0], fields[1]
        opts: dict = {}
        for f in fields[2:]:
            key, sep, val = f.partition("=")
            if not sep:
                raise ValueError(f"bad fault option {f!r} in {item!r}")
            if key in ("count", "after", "seed"):
                opts[key] = int(val)
            elif key in ("delay", "prob"):
                opts[key] = float(val)
            else:
                raise ValueError(f"unknown fault option {key!r} in"
                                 f" {item!r}")
        out.append((site, kind, opts))
    return out


# -- module-level singleton API ------------------------------------------

_REGISTRY = FaultRegistry()
_REGISTRY.load_env()


def fire(site: str, on_evict=None) -> None:
    """The site hook: no-op unless a matching spec is armed."""
    if _REGISTRY._specs:
        _REGISTRY.fire(site, on_evict=on_evict)


def install(site: str, kind: str, **opts) -> FaultSpec:
    """Arm one fault programmatically; returns the spec (see
    :func:`remove`)."""
    return _REGISTRY.install(site, kind, **opts)


def remove(spec: FaultSpec) -> None:
    _REGISTRY.remove(spec)


def clear() -> None:
    """Drop every armed spec (including env-installed ones)."""
    _REGISTRY.clear()


def reload_env(value: str | None = None) -> list[FaultSpec]:
    """Install specs from ``REPRO_FAULTS`` (or an explicit string)."""
    return _REGISTRY.load_env(value)


def stats() -> list[dict]:
    """Per-spec ``calls``/``fired`` counters."""
    return _REGISTRY.stats()


def active() -> bool:
    return _REGISTRY.active


# the registry's per-spec counters join the process-wide telemetry
# snapshot (repro_torch.obs is stdlib-only; no import cycle)
from repro_torch import obs as _obs  # noqa: E402

_obs.register_provider("faults", stats)


@contextmanager
def injected(site: str, kind: str, **opts):
    """Arm one fault for the duration of a ``with`` block."""
    spec = install(site, kind, **opts)
    try:
        yield spec
    finally:
        remove(spec)


@contextmanager
def isolated():
    """Suspend every armed spec (env schedules included) for a block.

    Tests that assert EXACT failure counts use this so an ambient chaos
    schedule (the CI chaos job's ``REPRO_FAULTS``) cannot perturb them;
    the suspended specs are restored, counters intact, on exit.
    """
    with _REGISTRY._lock:
        saved, _REGISTRY._specs = _REGISTRY._specs, []
    try:
        yield
    finally:
        with _REGISTRY._lock:
            _REGISTRY._specs = saved
