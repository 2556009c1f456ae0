"""gemma3-27b [dense]: 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

62L, d_model=5376, 32H (kv=16), d_ff=21504, vocab=262144.  Every 6th
layer is global; local layers use a 1024-token sliding window.
Sliding-window locals make long_500k decode tractable -> run it.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    window_size=1024,
    global_every=6,            # 5 local : 1 global
    rope_theta=1e6,
    act="gelu",
    supports_long_context=True,
)
