"""repro_torch.models — the model zoo's six families (dense, moe, ssm,
hybrid, encdec, vlm) in plain torch, with prefill attention and the
full-sequence SSD scan through hand-written kernels on the card, and the
training loss (:func:`loss_fn`), whose gradient runs through the same
kernels' backward."""

from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .decode import (cache_axes, cache_spec, decode_step, init_cache,
                     prefill)
from .params import (P, ShapeDtype, count_params, init_params,
                     params_from_numpy, tree_abstract, tree_axes)
from .transformer import (forward_hidden, lm_loss_from_hidden, logits_fn,
                          loss_fn, params_spec, unembed)

__all__ = [
    "SHAPES", "ModelConfig", "P", "ShapeConfig", "ShapeDtype",
    "cache_axes", "cache_spec", "count_params", "decode_step", "forward_hidden", "init_cache",
    "init_params", "lm_loss_from_hidden", "logits_fn", "loss_fn",
    "params_from_numpy", "params_spec", "prefill", "reduced",
    "tree_abstract", "tree_axes", "unembed",
]
