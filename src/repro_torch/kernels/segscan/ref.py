"""Plain-torch version of the segscan kernel: each segment's inclusive
prefix sum, added left to right as ``np.cumsum`` adds (``c = w[start]``,
then ``c = c + w[j]``), on the inputs' device.

The adds are the kernel's, one float64 add per step, so the result is
exact by construction; the walk runs every segment side by side, one step
of torch operations per position of the longest segment.  It reads the
segment table back to the host, so it is for the CPU tests and for
holding the kernel to, not for the card's hot path.
"""

from __future__ import annotations

import numpy as np
import torch


def segscan_ref(w: torch.Tensor, seg_start: torch.Tensor,
                seg_size: torch.Tensor) -> torch.Tensor:
    """w: (n,) float64; seg_start, seg_size: (n,) int64, each position's
    segment (contiguous segments covering [0, n)).  Returns the (n,)
    float64 inclusive prefix sums within the segments."""
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    pos = torch.arange(n, dtype=torch.int64, device=w.device)
    heads = pos[seg_start == pos]
    sizes = torch.minimum(seg_size[heads], n - heads)
    # longest first: the segments still walking at step j are a prefix
    sizes, order = torch.sort(sizes, descending=True, stable=True)
    heads = heads[order]
    live = np.asarray(sizes.cpu())
    c = w[heads]
    out[heads] = c
    for j in range(1, int(live[0]) if len(live) else 0):
        m = int(np.count_nonzero(live > j))
        idx = heads[:m] + j
        c = c[:m] + w[idx]
        out[idx] = c
    return out
