#!/usr/bin/env python3
"""Phase ``train`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

Run from the repository root::

    python3 tools/probe_train.py [--profile]

Builds the two kernels the training path launches (flash attention, K2,
and the SSD scan, K3), then runs ``chip_smoke.train_phase``: K2 and K3
as custom ops at yi-6b's and mamba2-2.7b's training shapes
(forward against the plain version, gradients bit for bit against
autograd of the plain function, forward + backward timed), five steps
of yi-6b and of mamba2-2.7b at full width and four layers in float32
and bfloat16 (step 0 against the plain path and a rerun; step time,
tokens/s, peak memory, launches a step; with ``--profile`` the device
time by class and the idle share of one more step), and the restart and
checkpoint checks on a small model.  One JSON line a part, as
``chip_smoke.py`` prints them; any failed check raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("probe_train: torch finds no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    fa_kernel._launch_fn()
    ssd_kernel._launch_fn()
    cs.emit("device", nvidia_smi=cs.nvidia_smi_line(),
            kind=torch.cuda.get_device_name(0), torch=torch.__version__,
            build_seconds=_build.build_info()["seconds"])
    cs.train_phase(args.profile)
    cs.emit("done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
