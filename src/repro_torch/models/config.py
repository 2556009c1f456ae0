"""Model and shape configuration for all assigned architectures.

Field for field the reference package's ``ModelConfig``, with one
difference: ``attn_impl`` names the port's attention paths.  "hopper"
(the default) is the hand-written CUDA flash-attention kernel of
:mod:`repro_torch.kernels.flash_attention` and takes the place of the
reference's "pallas"; "xla_flash" (query-chunked) and "quadratic" keep
their names and are plain torch.  ``loss_chunk``, ``remat`` and
``scan_layers`` are kept for parity and read by nothing yet: serving
needs none of them.
"""

from __future__ import annotations

import dataclasses

ATTN_IMPLS = ("hopper", "xla_flash", "quadratic")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned family via feature flags.

    family: dense | moe | ssm | hybrid | encdec | vlm
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention pattern ---
    window_size: int = 0          # sliding-window size (0 = full attention)
    global_every: int = 0         # >0: layer i is GLOBAL iff (i+1) % N == 0
                                  #  (gemma3 5:1 -> 6; gemma2 1:1 -> 2)
    attn_softcap: float = 0.0     # gemma2 attention logit soft-capping
    final_softcap: float = 0.0    # gemma2 final logit soft-capping
    rope_theta: float = 1e4

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4

    # --- hybrid (zamba2) ---
    attn_every: int = 0           # shared attention block every N ssm layers

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper 30 s of audio frames

    # --- modality frontends (stubs per spec) ---
    frontend: str = ""            # "" | "audio_stub" | "patch_stub"
    frontend_dim: int = 0         # precomputed embedding dim fed by stub
    num_patches: int = 0          # vlm: patch positions at seq start

    # --- numerics / misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"             # mlp activation: silu | gelu
    dtype: str = "bfloat16"
    loss_chunk: int = 2048        # ce-loss seq chunking (0 = unchunked)
    remat: str = "full"           # none | full | dots
    scan_layers: bool = True
    attn_impl: str = "hopper"     # hopper | xla_flash | quadratic

    # long-context capability (drives long_500k cell skips)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def layer_is_global(self, i: int) -> bool:
        if self.window_size == 0:
            return True
        if self.global_every == 0:
            return False  # pure SWA (mixtral-style)
        return (i + 1) % self.global_every == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: training or serving geometry."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads and 2 or 0)) or 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        window_size=16 if cfg.window_size else 0,
        num_experts=4 if cfg.num_experts else 0,
        experts_per_tok=2 if cfg.num_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_layers else 1500,
        attn_every=2 if cfg.attn_every else 0,
        frontend_dim=32 if cfg.frontend else 0,
        num_patches=8 if cfg.num_patches else 0,
        loss_chunk=0,
        remat="none",
        name=cfg.name + "-smoke",
    )
    if cfg.num_heads == 0:  # attention-free
        small.update(num_heads=0, num_kv_heads=0, head_dim=0)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
