"""Circuit breakers and the graceful-degradation ladder of the service.

The port resolves every backend by the name it is given, or raises
(:func:`repro_torch.core.metrics.get_evaluator`,
:func:`repro_torch.core.orderings.resolve_partition_backend`): an
unknown name, a CUDA device the process cannot reach, or ``"hopper"``
on a CPU device never gets as far as a rung, and nor does a kernel
library that does not build (:func:`rung_key`).  What a resolved config
can still meet at run time (a failed launch, a device OOM, a hung
stage) is what this module turns into a slower answer on the same
device instead of an error:

- :class:`CircuitBreaker` — one per resolved backend rung
  (:func:`rung_key`), the classic closed / open / half-open machine.
  ``threshold`` consecutive failures open the breaker; after
  ``cooldown_s`` one probe request is let through (half-open) and its
  outcome closes or re-opens it.  While open, the service skips the
  rung WITHOUT paying its failure latency.

- :func:`degradation_ladder` — the ordered list of
  ``(rung_name, PipelineConfig)`` a failed request walks, each rung a
  cumulative downgrade of the one above:

  1. ``full``            : the request's own config (the one-pass fused
                           sweep when eligible).
  2. ``unfused``         : same backends, staged pipeline
                           (``fused="off"``) — skips the fused sweep but
                           keeps the device partitioner and scorer.
  3. ``score_torch``     : the CUDA kernel -> the plain torch scorer.
  4. ``score_numpy``     : device scoring -> the numpy reference.
  5. ``partition_numpy`` : the device partition sweep -> the host
                           vectorized engine.
  6. ``depth_2``         : deep hierarchies (``HierarchySpec`` depth
                           > 2) truncate to the two-level node scheme.
  7. ``refine_0``        : every level's refine AND polish rounds -> 0.

  The score rungs come from :data:`SCORE_RUNGS`.  Rungs that do not
  change a config are elided, and the FIRST rung is always the
  unmodified config.  Rungs 2-5 only move WHERE the same algorithm runs
  (bit-identical permutations); only the depth rungs change the result.

  The backend rungs (3-5) exist for CPU-device configs only.  On a CUDA
  device no rung changes a backend: a request the card cannot serve
  with its hand-written kernels is not moved to a plain version or to
  the host, and the error of its last rung goes to the caller.  A CPU
  config's last rung runs entirely on host numpy.

:class:`MappingService` (:mod:`repro_torch.serve.engine`) resolves the
first rung before any rung runs, walks the ladder on failure or
deadline expiry, and records the rung that served the request in
``MappingResult.stats["degraded"]``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch import obs
from repro_torch.core.metrics import get_evaluator
from repro_torch.core.orderings import resolve_partition_backend
from repro_torch.kernels import _build
from repro_torch.mapping.pipeline import PipelineConfig, fused_eligible

# The score backends a rung may drop to, fastest first (the reference's
# ``pallas -> jax -> numpy`` chain under the port's names).  It feeds
# the ladder of a CPU-device config only: ``get_evaluator`` itself never
# falls back, and a card config's ladder never changes a backend.
SCORE_RUNGS = {"hopper": ("hopper", "torch", "numpy"),
               "torch": ("torch", "numpy"),
               "numpy": ("numpy",)}


class ServiceOverloaded(RuntimeError):
    """Admission queue full: the request was shed, not executed."""


class DeadlineExceeded(TimeoutError):
    """A ladder rung exceeded the request deadline (internal signal —
    the service degrades instead of surfacing this to callers)."""


# -- circuit breaker ------------------------------------------------------

class CircuitBreaker:
    """Closed / open / half-open breaker with probe-based recovery.

    closed    : requests flow; ``threshold`` CONSECUTIVE failures trip
                the breaker.
    open      : requests are refused (the ladder skips this rung) until
                ``cooldown_s`` has elapsed.
    half_open : exactly ONE probe request is admitted; success closes
                the breaker, failure re-opens it for another cooldown.

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opens = 0      # cumulative trips (observability)
        self.failures = 0   # cumulative recorded failures

    def _state_locked(self) -> str:
        if (self._state == "open"
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = "half_open"
            self._probing = False
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """May a request use this rung right now?"""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half_open" and not self._probing:
                self._probing = True  # one probe per cooldown window
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            st = self._state_locked()
            if st == "half_open":
                self._trip_locked()  # failed probe: straight back open
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._trip_locked()

    def _trip_locked(self) -> None:
        self._state = "open"
        self._opened_at = self._clock()
        self._failures = 0
        self._probing = False
        self.opens += 1
        obs.counter("serve.breaker_trips")

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(), "opens": self.opens,
                    "failures": self.failures}


class BreakerBoard:
    """One :class:`CircuitBreaker` per rung key, created on demand.

    Keys come from :func:`rung_key`, so health is tracked per RESOLVED
    backend combination and device type, shared across every
    scenario/config that lands on the same backends.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    self.threshold, self.cooldown_s, self._clock)
            return br

    def states(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
        return {k: br.stats() for k, br in items}


# -- the degradation ladder ----------------------------------------------

# Would this config take the one-pass fused sweep?  The pipeline's own
# gate under the reference's name: a pure function of the config.
fused_candidate = fused_eligible


def rung_key(config: PipelineConfig) -> str:
    """The breaker key: which RESOLVED backends, on which device type,
    serve this config.  Resolving raises for an unknown backend, an
    unreachable device or ``"hopper"`` on a CPU device; on a CUDA device
    it also builds and loads the kernel library that K1 and the device
    partitioner launch, so that a kernel that does not build raises
    here, before any rung runs."""
    score = get_evaluator(config.score_backend, config.device)[0]
    part = resolve_partition_backend(config.partition_backend,
                                     config.device)
    device = torch.device(config.device).type
    if device == "cuda" and (score == "hopper" or part == "torch"):
        _build.load_library()
    parts = ["fused" if fused_candidate(config) else "staged",
             f"score={score}", f"partition={part}",
             f"device={device}"]
    spec = config.hierarchy
    if not spec.is_flat:
        # depth + total refine budget: a depth-degraded or refine-
        # stripped config is a DIFFERENT rung with its own breaker
        parts.append(f"depth={spec.depth}")
        parts.append(f"refine={spec.refine_rounds_total}")
    return "/".join(parts)


def degradation_ladder(config: PipelineConfig) -> list:
    """Ordered ``(rung_name, PipelineConfig)`` downgrades for ``config``.

    The first entry is always ``("full", config)`` unchanged; each
    later rung is a cumulative ``dataclasses.replace`` of the previous
    one (see the module docstring for the rung semantics).  Rungs that
    would not change the config are elided, so a host-only config gets
    a single-rung ladder, and on a CUDA device the rungs that change a
    backend are left out.  A pure function of the config: it resolves
    nothing, so any ladder can be built on any machine.
    """
    rungs = [("full", config)]
    cur = config

    def push(name, **changes):
        nonlocal cur
        new = dataclasses.replace(cur, **changes)
        if new != cur:
            cur = new
            rungs.append((name, new))

    if fused_candidate(config):
        push("unfused", fused="off")
    if torch.device(config.device).type != "cuda":
        for backend in SCORE_RUNGS.get(config.score_backend, ())[1:]:
            push(f"score_{backend}", score_backend=backend)
        if config.partition_backend != "numpy":
            push("partition_numpy", partition_backend="numpy")
    spec = cur.hierarchy
    if spec.depth > 2:
        push("depth_2", hierarchy=spec.truncated(2))
    spec = cur.hierarchy
    if not spec.is_flat and (spec.refine_rounds_total > 0
                             or spec.polish_rounds_total > 0):
        push("refine_0", hierarchy=spec.with_refine(rounds=0, polish=0))
    return rungs
