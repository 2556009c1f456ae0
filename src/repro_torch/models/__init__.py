"""repro_torch.models — the model zoo's dense, ssm and hybrid families in
plain torch, with prefill attention and the full-sequence SSD scan
through hand-written kernels on the card."""

from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .decode import decode_step, init_cache, prefill
from .params import P, count_params, init_params, params_from_numpy
from .transformer import forward_hidden, logits_fn, params_spec, unembed

__all__ = [
    "SHAPES", "ModelConfig", "P", "ShapeConfig", "count_params",
    "decode_step", "forward_hidden", "init_cache", "init_params",
    "logits_fn", "params_from_numpy", "params_spec", "prefill", "reduced",
    "unembed",
]
