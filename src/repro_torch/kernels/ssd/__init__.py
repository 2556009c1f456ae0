"""Mamba2 SSD chunked scan as a hand-written CUDA kernel.

:func:`ssd` is the model-layout wrapper that launches the kernel (what
the full-sequence branch of ``models.layers.mamba_block`` runs),
:func:`ssd_ref` its plain-torch version in the kernel layout and
:func:`ssd_model_ref` the same fed the model layout.
"""

from .ops import ssd
from .ref import ssd_model_ref, ssd_ref

__all__ = ["ssd", "ssd_model_ref", "ssd_ref"]
