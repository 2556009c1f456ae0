"""internvl2-26b [vlm]: InternViT + InternLM2 backbone; the vision tower
is a stub feeding precomputed patch embeddings.  [arXiv:2404.16821; hf]

48L, d_model=6144, 48H (kv=8), d_ff=16384, vocab=92553.  The first
num_patches positions of each sequence are patch embeddings projected
into the LM.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    frontend="patch_stub",
    frontend_dim=3200,         # InternViT-6B hidden size (stubbed)
    num_patches=1024,
    supports_long_context=False,
)
