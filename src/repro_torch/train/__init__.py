"""repro_torch.train — training on one card: AdamW (:mod:`.optimizer`),
synthetic data (:mod:`.data`), checkpoints in the reference's format
(:mod:`.checkpoint`), the train step (:mod:`.step`) and the training
loop with restarts (:mod:`.driver`)."""

from .driver import JobConfig, StragglerMonitor, train, train_with_restarts
from .optimizer import OptConfig, apply_updates, init_state, schedule_lr
from .step import make_serve_step, make_train_step

__all__ = ["JobConfig", "OptConfig", "StragglerMonitor", "apply_updates",
           "init_state", "make_serve_step", "make_train_step",
           "schedule_lr", "train", "train_with_restarts"]
