"""whisper-small [audio]: enc-dec transformer backbone, conv frontend
stubbed as precomputed frame embeddings.  [arXiv:2212.04356; unverified]

12L decoder + 12L encoder, d_model=768, 12H (GQA kv=12 == MHA),
d_ff=3072, vocab=51865.  Decoder-side sequence shapes per cell; encoder
fixed at 1500 frames (30 s).  long_500k skipped: full attention + 448-
token decoder makes a 500k decode meaningless (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    encoder_seq=1500,
    frontend="audio_stub",
    frontend_dim=128,          # precomputed mel-frame embedding dim (stub)
    act="gelu",
    supports_long_context=False,
)
