"""Segmented float64 prefix sums, left to right, as a hand-written CUDA
kernel (``segscan``).

:func:`segscan` is the wrapper the device partitioner
(:mod:`repro_torch.core.partition_torch`) calls for weighted cuts;
:func:`segscan_ref` is its plain-torch version.
"""

from .ops import segscan
from .ref import segscan_ref

__all__ = ["segscan", "segscan_ref"]
