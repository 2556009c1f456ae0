"""Flash attention forward as a hand-written CUDA kernel.

:func:`flash_attention` is the model-layout wrapper that launches the
kernel (what ``attn_impl="hopper"`` runs in :mod:`repro_torch.models`),
:func:`attention_ref` its plain-torch version in the kernel layout.
"""

from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention"]
