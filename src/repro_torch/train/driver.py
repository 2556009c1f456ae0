"""Training driver: checkpoint / restart and straggler monitoring.

The reference package's ``train/driver.py``.  The loop is written so
that *any* crash (or simulated failure) resumes exactly: data is a pure
function of the step index, checkpoints are atomic, and the optimizer
state rides along.

Fresh parameters are :func:`repro_torch.models.init_params` of
``job.seed`` on the step's device: the port cannot draw jax's PRNG, so
a fresh run here starts from other weights than the reference's run of
the same seed — the one place where the two packages' numbers differ by
construction.  Tests that compare the two carry one set of weights
across with ``params_from_numpy``.

On a mesh (a :class:`~repro_torch.meshmap.MeshLayout` or a
``DeviceMesh``, as :func:`~repro_torch.train.step.make_train_step`
takes it) every rank runs :func:`train`: the checkpoints are saved
shard by shard (:func:`~repro_torch.train.checkpoint.save`), and a
resume restores them onto the resuming job's own mesh — which need not
be the mesh that saved, nor a mesh at all — by the step's partition
specs (the elastic restore), so its next step places nothing.  Every
rank logs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.models import (ModelConfig, init_params, params_spec,
                                tree_abstract)

from . import checkpoint as ckpt
from .data import SyntheticLM
from .optimizer import OptConfig, abstract_state, init_state
from .step import make_train_step, model_shardings, opt_shardings


class StragglerMonitor:
    """Flags steps (or, fed per-host durations, hosts) that exceed
    ``threshold`` x the running median — the signal a production job uses
    to evict/replace slow hosts before they stall the collective."""

    def __init__(self, threshold: float = 2.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.durations: list = []
        self.flagged: list = []

    def add(self, step: int, duration: float):
        self.durations.append(duration)
        hist = self.durations[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 5 and duration > self.threshold * med:
            self.flagged.append((step, duration, med))
            return True
        return False


@dataclasses.dataclass
class JobConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    microbatch: int = 1
    fail_at_step: int = -1     # simulate a crash (tests)
    seed: int = 0


def train(cfg: ModelConfig, opt_cfg: OptConfig, job: JobConfig, mesh=None,
          *, data: SyntheticLM | None = None, shape=None, rules=None,
          log=print, device="cuda") -> dict:
    """Run (or resume) a training job on ``device``, or on ``mesh``
    (every rank calls it).  Returns the history dict: per-step ``loss``
    (floats), ``steps`` and wall seconds ``step_s``, the ``stragglers``
    flagged, and the final ``params`` (DTensors on a mesh)."""
    dev = resolve_device(device)
    if data is None:
        if shape is None:
            raise ValueError("train needs data= or shape=")
        data = SyntheticLM(cfg.vocab_size, shape.seq_len,
                           shape.global_batch, seed=job.seed)
    step_fn = make_train_step(cfg, opt_cfg, mesh, rules=rules,
                              microbatch=job.microbatch, device=dev)
    dmesh = step_fn.device_mesh
    last = ckpt.latest_step(job.ckpt_dir) if job.ckpt_dir else None
    if last is None:
        start = 0
        params = init_params(cfg, job.seed, dev)
        opt_state = init_state(opt_cfg, params)
    else:
        pab = tree_abstract(params_spec(cfg), cfg.dtype)
        like = {"params": pab, "opt": abstract_state(opt_cfg, pab)}
        shardings = None if dmesh is None else {
            "params": model_shardings(cfg, dmesh, rules)[0],
            "opt": opt_shardings(opt_cfg, cfg, dmesh, rules)[0]}
        restored = ckpt.restore(job.ckpt_dir, last, like,
                                shardings=shardings, device_mesh=dmesh,
                                device=dev)
        params, opt_state = restored["params"], restored["opt"]
        start = last
        log(f"[train] resumed from step {last}")

    monitor = StragglerMonitor()
    history = {"loss": [], "steps": [], "stragglers": monitor.flagged,
               "step_s": monitor.durations}
    for step in range(start, job.steps):
        if step == job.fail_at_step:
            raise RuntimeError(f"simulated failure at step {step}")
        batch = data.np_batch(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])    # waits for the step
        dt = time.perf_counter() - t0
        monitor.add(step, dt)
        history["loss"].append(loss)
        history["steps"].append(step)
        if job.log_every and step % job.log_every == 0:
            log(f"[train] step {step} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms)")
        if job.ckpt_dir and (step + 1) % job.ckpt_every == 0:
            ckpt.save(job.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state}, keep=job.keep)
    if job.ckpt_dir:
        ckpt.save(job.ckpt_dir, job.steps,
                  {"params": params, "opt": opt_state}, keep=job.keep)
    history["params"] = params
    return history


def train_with_restarts(cfg, opt_cfg, job: JobConfig, mesh=None, *,
                        max_restarts: int = 3, shape=None, log=print,
                        device="cuda"):
    """Supervisor loop: restart from the latest checkpoint on failure —
    the single-process analogue of a cluster-level job controller."""
    attempts = 0
    while True:
        try:
            return train(cfg, opt_cfg, job, mesh, shape=shape, log=log,
                         device=device)
        except RuntimeError as e:
            attempts += 1
            log(f"[train] failure: {e}; restart {attempts}")
            if attempts > max_restarts:
                raise
            job = dataclasses.replace(job, fail_at_step=-1)
