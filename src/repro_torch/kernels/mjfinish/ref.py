"""Plain-torch version of the mjfinish kernel: the device partitioner's
own level loop (:func:`repro_torch.core.partition_torch.mj_levels`) run
from the handoff level to the end on the inputs' device, then the part
numbers put back in point order.

It is the loop the kernel replaces, operation for operation, so it is
exact by construction; it queues about 120 torch operations a level, so
it is for the CPU tests and for holding the kernel to, not for the
card's hot path.
"""

from __future__ import annotations

import torch


def mjfinish_ref(pts: torch.Tensor, cols: torch.Tensor, mu: torch.Tensor,
                 seg_start: torch.Tensor, seg_size: torch.Tensor,
                 seg_np: torch.Tensor, sdo: torch.Tensor, tab: torch.Tensor,
                 *, level: int, levels: int, sfc: str,
                 longest_dim: bool) -> torch.Tensor:
    """Levels ``level .. levels - 1`` of an unweighted sweep from its
    positional state; returns the (nb, n) int64 part numbers in point
    order (the layout of ``mjfinish``'s arguments is its docstring's)."""
    # imported here: the partitioner imports this package
    from repro_torch.core.partition_torch import (SweepState, mj_levels,
                                                  part_numbers)
    st = SweepState(pts, cols, mu, seg_start, seg_size, seg_np)
    st = mj_levels(st, sdo, tab, sfc=sfc, longest_dim=longest_dim,
                   lo=level, hi=levels)
    return part_numbers(st, sdo.shape[0])
