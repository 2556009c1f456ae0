"""gemma2-27b [dense]: alternating local/global attention with logit
softcaps.  [arXiv:2408.00118; hf]

46L, d_model=4608, 32H (kv=16), d_ff=36864, vocab=256000.  Every 2nd
layer global; locals use a 4096 sliding window; attn softcap 50, final
logit softcap 30.  Sliding windows -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    window_size=4096,
    global_every=2,            # 1 local : 1 global alternating
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    supports_long_context=True,
)
