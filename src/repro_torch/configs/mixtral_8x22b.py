"""mixtral-8x22b [moe]: 8 experts top-2 + sliding-window attention.
[arXiv:2401.04088; hf]

56L, d_model=6144, 48H (kv=8), d_ff=16384 per expert, vocab=32768,
SWA window 4096 on all layers (global_every=0) -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    num_experts=8,
    experts_per_tok=2,
    window_size=4096,
    global_every=0,            # pure SWA
    supports_long_context=True,
)
