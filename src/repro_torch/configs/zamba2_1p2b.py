"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

38 mamba2 layers, d_model=2048, d_ff=8192, vocab=32000, ssm_state=64;
one shared transformer block (32H, kv=32) applied every 6 layers (the
paper's two alternating shared blocks are modelled as one; DESIGN.md).
State-space decode -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
    supports_long_context=True,
)
