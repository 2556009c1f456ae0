#!/usr/bin/env python3
"""Phase ``dryrun`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

Run from the repository root::

    python3 tools/probe_dryrun.py [--kernels]

Builds the flash-attention kernel (K2), then runs
``chip_smoke.dryrun_phase``: one yi-6b training step (4 layers at full
width, 4 x 2048, bfloat16) counted by ``launch/op_cost.CostCounter`` for
real on the card and under ``FakeTensorMode`` on a 1x1 mesh (op counts,
FLOPs, bytes and K2's 8 calls equal), then ``launch/dryrun.run_cell`` for
yi_6b x train_4k and mamba2_2p7b x prefill_32k on the 16x16 mesh and
mixtral_8x22b x decode_32k on the 2x16x16 mesh, as rank 0 of a fake
world of 256 / 512 (each ``ok``, argument bytes equal to the spec
arithmetic).  With ``--kernels`` first phase ``attention``'s and phase
``ssd``'s checks of K2 and K3 against their plain versions (through the
custom ops).  One JSON line a part, as ``chip_smoke.py`` prints them;
any failed check raises.
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
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("probe_dryrun: torch finds no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    fa_kernel._launch_fn()
    if args.kernels:
        ssd_kernel._launch_fn()
    cs.emit("device", nvidia_smi=cs.nvidia_smi_line(),
            kind=torch.cuda.get_device_name(0), torch=torch.__version__,
            build_seconds=_build.build_info()["seconds"])
    if args.kernels:
        attn = [cs.attention_case(*c, seed=i)
                for i, c in enumerate(cs.ATTN_CASES)]
        attn += cs.family_attention_cases()
        cs.emit("attention", cases=attn)
        ssd = [cs.ssd_case(*c, dtype=dt, seed=i)
               for i, c in enumerate(cs.SSD_CASES)
               for dt in ("float32", "bfloat16")]
        cs.emit("ssd", cases=ssd)
    cs.dryrun_phase()
    cs.emit("done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
