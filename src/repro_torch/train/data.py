"""Deterministic synthetic LM data pipeline.

The reference package's ``train/data.py``; :meth:`SyntheticLM.np_batch`
is its code verbatim, so the port's batches are the reference's, bit for
bit.  Properties a real pipeline needs and this one has:

- *Deterministic & resumable*: batch(step) is a pure function of
  (seed, step), so restart-from-checkpoint replays the exact stream with
  no state files.
- *Learnable structure*: tokens follow a noisy affine bigram process so
  small models show real loss decrease in examples/tests (pure uniform
  noise would pin loss at log V).
- *Prefetch*: a background thread keeps ``prefetch`` batches ready.

The reference builds a (possibly multi-host) ``jax.Array`` from
per-shard callbacks; on one card :func:`make_global_array` is an upload
to the step's device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import ShapeDtype


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, noise: float = 0.1):
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.batch = int(global_batch)
        self.seed = seed
        self.noise = noise
        # fixed random affine bigram map
        rng = np.random.default_rng(seed)
        self.a = int(rng.integers(1, vocab_size - 1) | 1)
        self.b = int(rng.integers(0, vocab_size))

    def np_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch, self.seq, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = (self.a * toks[:, t] + self.b) % v
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32),
        }

    def batch_specs(self) -> dict:
        b, s = self.batch, self.seq
        return {
            "tokens": ShapeDtype((b, s), torch.int32),
            "labels": ShapeDtype((b, s), torch.int32),
            "mask": ShapeDtype((b, s), torch.float32),
        }


def make_global_array(np_arr: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy batch array as a tensor on ``device`` (one card holds the
    whole batch)."""
    return torch.as_tensor(np.ascontiguousarray(np_arr),
                           device=resolve_device(device))


class Prefetcher:
    """Background-thread prefetch of pipeline batches."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.source.np_batch(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self, timeout: float | None = None):
        """The next ``(step, batch)``; raises ``queue.Empty`` after
        ``timeout`` seconds without one."""
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2)
