"""Candidate-mapping scoring as a hand-written CUDA kernel (``mapscore``).

:func:`evaluate_candidates_hopper` is what
``repro_torch.core.metrics.evaluate_candidates(backend="hopper")``
resolves to; :func:`mapscore` is the tensor-level wrapper that launches
the kernel, and :func:`mapscore_ref` its plain-torch version.
"""

from .ops import evaluate_candidates_hopper, mapscore
from .ref import mapscore_ref

__all__ = ["evaluate_candidates_hopper", "mapscore", "mapscore_ref"]
