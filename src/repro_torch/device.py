"""The port's one device rule.

Entry points take ``device`` (default ``"cuda"``) and resolve it here: a
CUDA device that the process cannot reach raises instead of quietly
running elsewhere; the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that the process
    cannot reach raises instead of quietly running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the host")
    return dev
