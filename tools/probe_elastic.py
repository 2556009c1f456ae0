#!/usr/bin/env python3
"""Phase ``elastic`` of ``chip_smoke.py`` alone, on one NVIDIA GPU, and
what it rests on: torch's threaded process group running a CUDA
``DeviceMesh`` on one card, and the checkpoint directory's disk.

Run from the repository root::

    python3 tools/probe_elastic.py [--threads] [--disk-gb N] [--no-phase]

Prints one JSON line a part: ``env`` (torch, CUDA, numpy, the card's name
and power limit, free space under ``build/``, host memory); with ``--threads``, ``threaded`` (four threads of torch's
threaded process group, a (2, 2) ``("data", "model")``
``DeviceMesh("cuda")`` on card 0: a sharded tensor redistributed and
gathered, a barrier, and two training steps of a reduced dense model with
grouped-query attention through the flash-attention kernel, the loss
against the one-card step's); with ``--disk-gb N``, ``disk`` (N GB
written through ``numpy.lib.format.open_memmap`` and read back by
``numpy.load(mmap_mode="r")``, in seconds and GB/s); then, unless
``--no-phase``, ``chip_smoke.elastic_phase`` (yi-6b at full width, 2
layers, saved on (2, 2), resumed on (4, 1) and on the card alone).  Any
failed check raises.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe_elastic")


def threaded_part() -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.configs import get_config
    from repro_torch.meshmap import MeshLayout
    from repro_torch.models import init_params, reduced
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import tree_map
    layout = MeshLayout(np.arange(4).reshape(2, 2), ("data", "model"))
    cfg = reduced(get_config("yi_6b"), dtype="float32", num_layers=2,
                  num_heads=4, num_kv_heads=1)
    opt = OptConfig(warmup_steps=1)
    params = init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16)),
             "mask": np.ones((4, 16), np.float32)}
    step = make_train_step(cfg, opt)
    p1 = tree_map(torch.clone, params)
    s1 = init_state(opt, p1)
    want = []
    for _ in range(2):
        p1, s1, m = step(p1, s1, dict(batch))
        want.append(float(m["loss"]))
    x = torch.arange(64, dtype=torch.float32, device="cuda").reshape(8, 8)

    def rank(r):
        mesh = layout.device_mesh("cuda")
        d = distribute_tensor(x, mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        local = d.to_local()
        back = d.redistribute(mesh, [Replicate(), Shard(0)]).full_tensor()
        dist.barrier()
        cs.kernel_counts(reset=True) if r == 0 else None
        dist.barrier()
        own = tree_map(torch.clone, params)
        st = init_state(opt, own)
        fn = make_train_step(cfg, opt, layout, device="cuda")
        losses, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            own, st, m = fn(own, st, dict(batch))
            losses.append(float(m["loss"].full_tensor()))
            secs.append(time.perf_counter() - t0)
        dist.barrier()
        return {"local": list(local.shape), "device": str(local.device),
                "gather_equal": bool(torch.equal(back, x)),
                "coordinate": mesh.get_coordinate(),
                "losses": losses, "step_s": secs}

    t0 = time.perf_counter()
    ranks = cs.on_threads(4, rank)
    return {"ranks": ranks, "want_losses": want,
            "launches": cs.kernel_counts(),
            "seconds": time.perf_counter() - t0}


def disk_part(gb: float) -> dict:
    import numpy as np
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    path = os.path.join(OUT, "leaf.npy")
    n = int(gb * 1e9) // 4
    src = np.random.default_rng(0).random(2 ** 24, dtype=np.float32)
    t0 = time.perf_counter()
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(n,))
    for i in range(0, n, src.size):
        k = min(src.size, n - i)
        mm[i:i + k] = src[:k]
    mm.flush()
    del mm
    os.sync()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = np.load(path, mmap_mode="r")
    total = 0.0
    for i in range(0, n, src.size):
        total += float(np.asarray(arr[i:i + src.size]).sum(dtype=np.float64))
    read_s = time.perf_counter() - t0
    del arr
    shutil.rmtree(OUT, ignore_errors=True)
    return {"bytes": n * 4, "write_s": write_s, "read_s": read_s,
            "write_gb_per_s": n * 4 / write_s / 1e9,
            "read_gb_per_s": n * 4 / read_s / 1e9,
            "note": "read right after the write: the page cache may hold it"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", action="store_true")
    ap.add_argument("--disk-gb", type=float, default=0.0)
    ap.add_argument("--no-phase", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_elastic: torch finds no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    cs.emit("env", nvidia_smi=cs.nvidia_smi_line(), torch=torch.__version__,
            cuda=torch.version.cuda, numpy=np.__version__,
            build_free_bytes=shutil.disk_usage(
                os.path.join(ROOT, "build")).free, host_memory_bytes=mem)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    fa_kernel._launch_fn()
    cs.emit("build", seconds=_build.build_info()["seconds"])
    if args.threads:
        cs.emit("threaded", **threaded_part())
    if args.disk_gb:
        cs.emit("disk", **disk_part(args.disk_gb))
    if not args.no_phase:
        cs.elastic_phase()
    cs.emit("done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
