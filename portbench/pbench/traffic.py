"""The one traffic generator: which job each request of a closed loop
sends, from a mix's parameters and a seed.

A mix file holds ``pool`` (timed jobs, sent in round robin),
``warmup_jobs`` (jobs outside the rotation, sent once in set-up),
``cache_entries`` (the service's LRU bound), ``block`` and
``repeat_share`` (in each block of ``block`` requests the first
``block * (1 - repeat_share)`` send the next new job, the rest relaunch
one of the ``recent`` newest jobs, drawn from the seed) and
``hierarchy`` (``flat`` or ``node``).
"""

from __future__ import annotations

import collections
import itertools

import numpy as np

KEYS = ("pool", "warmup_jobs", "cache_entries", "block", "repeat_share",
        "recent", "hierarchy")


def check(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if new_per_block(mix) < 1:
        raise ValueError("a block must send at least one new job")
    if new_per_block(mix) < mix["block"] and mix["recent"] < 1:
        raise ValueError("relaunches need recent >= 1")
    return mix


def new_per_block(mix: dict) -> int:
    return int(mix["block"]) - int(round(mix["block"] * mix["repeat_share"]))


def schedule(mix: dict, seed: int):
    """The endless sequence of timed job indices (``0 .. pool - 1``)."""
    check(mix)
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), 0x5eed]))
    pool, block, new = int(mix["pool"]), int(mix["block"]), new_per_block(mix)
    recent = collections.deque(maxlen=max(1, int(mix["recent"])))
    for n in itertools.count():
        for i in range(block):
            if i < new:
                job = (n * new + i) % pool
                recent.append(job)
            else:
                job = recent[int(rng.integers(len(recent)))]
            yield job


def lru_hits(jobs, capacity: int) -> list[bool]:
    """Whether each request of ``jobs`` hits an LRU of ``capacity``
    entries that holds every job it served (the service's cache)."""
    lru = collections.OrderedDict()
    out = []
    for j in jobs:
        hit = j in lru
        out.append(hit)
        lru[j] = True
        lru.move_to_end(j)
        if len(lru) > capacity:
            lru.popitem(last=False)
    return out
