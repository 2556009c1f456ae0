"""Bounded, thread-safe LRU for mapping responses (the serve layer's
result store).

Keys are content-addressed request signatures
(:mod:`repro_torch.core.signature`); values are whatever the service caches
(a :class:`repro_torch.core.MappingResult` in practice).  The cache is a
plain ``OrderedDict`` under one lock — mapping results are small (one
int array per request) so capacity bounds entry COUNT, and every
operation is O(1).

Counters (``hits`` / ``misses`` / ``evictions``) are cumulative for the
cache's lifetime; :meth:`LRUCache.stats` snapshots them for benchmark
records and tests (the serve benchmark's warm-path accounting).
"""

from __future__ import annotations

import collections
import threading

from repro_torch import obs


class LRUCache:
    """Least-recently-used cache with a hard entry-count bound."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.storms = 0
        # weakly tracked: this instance's stats() joins obs.snapshot()
        obs.register_object("lrus", self)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key, default=None, *, count: bool = True):
        """Value for ``key`` (refreshing its recency), else ``default``.

        ``count=False`` skips the hit/miss counters — for internal
        rechecks (e.g. the service's under-lock recheck) that would
        otherwise double-count one logical lookup.
        """
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                if count:
                    self.hits += 1
                return self._data[key]
            if count:
                self.misses += 1
            return default

    def put(self, key, value) -> None:
        """Insert/refresh ``key``; evicts the LRU entry when full."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        """Drop every entry (counters keep accumulating)."""
        with self._lock:
            self._data.clear()

    def storm(self) -> None:
        """An eviction storm: drop every entry, booking each as an
        eviction.  This is the ``evict``-kind fault-injection callback
        (:mod:`repro_torch.faults`, site ``serve.cache``) — the service keeps
        answering, every post-storm request recomputing cold."""
        with self._lock:
            self.evictions += len(self._data)
            self.storms += 1
            self._data.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "storms": self.storms,
                    "size": len(self._data),
                    "capacity": self.capacity}
