"""grok-1-314b [moe]: 8 experts top-2.  [hf:xai-org/grok-1; unverified]

64L, d_model=6144, 48H (kv=8), d_ff=32768 per expert, vocab=131072.
Full attention -> long_500k skipped.  Optimizer moments run in bf16 at
this scale (DESIGN.md §6).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    experts_per_tok=2,
    supports_long_context=False,
)
