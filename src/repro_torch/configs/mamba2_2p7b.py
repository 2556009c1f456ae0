"""mamba2-2.7b [ssm]: attention-free SSD.  [arXiv:2405.21060; unverified]

64L, d_model=2560, vocab=50280, ssm_state=128, expand=2 (inner 5120,
80 heads x head_dim 64).  O(1)-state decode -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    supports_long_context=True,
)
