"""The device partitioner's lower Multi-Jagged levels in one launch, as a
hand-written CUDA kernel (``mjfinish``).

:func:`mjfinish` is the wrapper the device partitioner
(:mod:`repro_torch.core.partition_torch`) calls once a side when an
unweighted sweep's segments fit one block; :func:`mjfinish_ref` is its
plain-torch version.
"""

from .kernel import max_tile
from .ops import mjfinish
from .ref import mjfinish_ref

__all__ = ["max_tile", "mjfinish", "mjfinish_ref"]
