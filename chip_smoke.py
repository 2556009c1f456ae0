#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``); without a GPU it
exits non-zero and prints no result.  Phases, each printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; builds the kernels from ``src/repro_torch/kernels/*/csrc``.
2. ``kernels`` — the mapscore kernel against its plain-torch version on the
   card, both objectives, on small machines, a wrapped seam, zero-length and
   zero-weight messages, a hop-only stack without core columns, and the
   full-size shapes of phase 3; a second launch must be bit-identical; the
   kernel, the plain version and (at full size) the bound are timed.
3. ``serve``   — a ``MappingService`` on ``device="cuda"`` answers four flat
   scenarios of the registry at ``--scale`` tasks (default 2**18) cold, then
   warm, then a batch with a duplicate; every assignment is checked, every
   cold winner is compared with the numpy evaluator's winner on the same
   candidate stack, and the kernel's launch count must have risen.
4. ``attention`` — the flash-attention kernel against its plain-torch
   version on the card: MHA, GQA 4:1 and MQA, ragged S (80; 4000), head
   dims 16 to 128, windows 16 / 48 with caps 0 / 30, gemma2-27b's local
   layer (S=8192, window 4096, cap 50) and yi-6b's prefill (B=4, S=4000,
   H=32, KH=4, D=128), float32 at 2e-5 and bfloat16 at 4e-3 + 8e-3·|o|
   (two ulp); a second launch must be bit-identical; at yi-6b's shape the
   kernel, the plain version, the bound and ``scaled_dot_product_attention``
   are timed.
5. ``model``   — yi-6b at full width and depth, random weights of seed 0
   (``init_params``, block matrices widened to one layer's fan-in),
   serves 4 prompts of 4000 tokens (numpy, seed 0) for 16 new tokens:
   (a) float32: prefill + decode steps driven as ``ServeEngine.generate``
   drives them give its tokens, and every served position's logits agree
   with one plain full forward (``attn_impl="xla_flash"``) to 1e-4 of
   their largest magnitude; (b) bfloat16, the config's dtype: the served
   run, timed, with the kernel's launches (one per layer) and peak
   memory, and the same comparison at 3e-2.
6. ``ssd``     — the SSD kernel against its plain version (the sequential
   recurrence) on the card, float32 and bfloat16: L below, at and above
   the chunk, one head, x / B / C cut from one conv-output tensor with a
   transposed dt, instant decay (A = -100), and zamba2-1.2b's and
   mamba2-2.7b's prefill shapes (B=4, L=4096); a second launch must be
   bit-identical; at mamba2-2.7b's shape the kernel, the plain version
   and the bound are timed.
7. ``ssm_model`` — mamba2-2.7b at full width and depth (64 layers),
   random weights of seed 0 widened as in phase 5, 4 prompts of 256
   tokens (numpy, seed 0; two chunks) and 16 new tokens: the last-position
   logits of ``prefill`` (the SSD kernel, one launch per layer) agree with
   those of the token-by-token ingest ``ServeEngine.generate`` runs
   (``ssd_step``), and the greedy tokens driven as ``generate`` drives
   them are its tokens — (a) in float32 to 1e-4 of the largest |logit|,
   (b) in bfloat16, timed, to 3e-2; (c) one bfloat16 ``prefill`` of
   4 x 4096 tokens, timed, with its 64 kernel launches.
8. ``hybrid_model`` — zamba2-1.2b (38 mamba layers, the shared attention
   block at 6 sites) in bfloat16, the same checks: per prefill 38 SSD and
   6 flash-attention launches.

With ``--profile`` three more ``profile`` lines give the device time by
kernel and copy name (``torch.profiler``) with the device's idle share:
of one mapscore launch at the largest shape and one more cold request,
and of one bfloat16 prefill and one decode step of yi-6b and of
mamba2-2.7b.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script then
exits non-zero without the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

SCENARIOS = ("minighost-xk7_sparse-flat-wh",
             "minighost-xk7_sparse-flat-latency",
             "homme-bgq_block-flat-latency",
             "random-tpu_mesh-flat-wh")
RTOL = ATOL = 1e-4          # float metrics, kernel vs plain / numpy
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
# flash attention vs its plain version, (atol, rtol) per element.
# float32: tests/test_kernels.py's.  bfloat16: both sides round one
# float32 result, so they differ by an ulp where the two sums straddle a
# rounding boundary: 1.95e-3 at most at every case (one ulp at
# |o| in [0.25, 0.5); H100 run recorded in PERF.md).  atol is two such
# ulp, rtol one ulp (2**-7) of larger outputs — against a typical |o|
# of 0.03-0.05 at S = 4000, where CPU tests' 2e-2 would let a wrong
# kernel pass.
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 8e-3)}
# served logits vs one plain full forward, as a fraction of the largest
# |logit|.  float32: summation order only (2.7e-7 on a 32-layer reduced
# yi on the CPU), while a bfloat16 computation is ~1e-2 away, which the
# model phase checks.  bfloat16: both sides round to bfloat16 at every
# layer, each ~1e-2 from the exact value.
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MODEL = "yi-6b"
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 4000, 16
# SSD kernel vs its plain version, per element: |k - p| <= a * max|p| +
# r * |p| for (a, r).  float32: tests/test_kernels.py's 2e-5, its absolute
# part taken at the output's own scale — both sum the same float32 terms
# in another order, the terms reach max|y| (~400 at L = 4096) and cancel
# to small outputs, so an absolute 2e-5 holds at that file's L <= 128
# only.  bfloat16: both sides round one float32 result, so they differ by
# one ulp where the two straddle a rounding boundary, and one ulp is at
# most 2**-7 |y| at the output's own magnitude; plus the float32 part.
SSD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2 ** -7)}
SSM_MODEL, HYBRID_MODEL = "mamba2-2.7b", "zamba2-1.2b"
SSM_PROMPT_LEN, SSM_LONG_LEN = 256, 4096
# prefill (SSD kernel) vs the recurrent ingest (ssd_step), last-position
# logits, as a fraction of the largest |logit|.  float32: order of sums
# only (1e-5 is the CPU tests' limit at reduced size), and a bfloat16
# computation lies ~1e-2 away, which the phase checks.  bfloat16: the
# ingest rounds the state to bfloat16 for every readout and carries the
# conv context in bfloat16, the kernel keeps both in float32; 64 layers
# of bfloat16 roundings on either side: 8.9e-3 (mamba2-2.7b) and 7.0e-3
# (zamba2-1.2b) on the H100 (PERF.md), so the dense phase's 3e-2.
SSM_LOGITS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
OBJECTIVES = {"wh": ("weighted_hops",),
              "latency": ("latency_max", "weighted_hops")}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def winner(scores: dict, keys) -> int:
    """First-of-ties lexicographic argmin, as ``CandidateSearch.best``."""
    import numpy as np
    cols = [np.asarray(scores[k]) for k in keys]
    return int(np.lexsort(tuple(reversed(cols)))[0])


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn`` over ``reps`` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def small_cases():
    """(name, machine, edges, weights, coord_stack) at small sizes."""
    import numpy as np
    from repro_torch.core import (gemini_xk7, make_machine,
                                  tpu_v5e_multipod)
    machines = [
        make_machine((6,), wrap=True),
        make_machine((5, 4), wrap=False),
        make_machine((4, 5, 3), wrap=(True, False, True),
                     bw=(2.0, 1.0, 4.0)),
        gemini_xk7(dims=(4, 4, 8), cores_per_node=2),
        tpu_v5e_multipod(2, 4),
    ]
    cases = []
    for mi, m in enumerate(machines):
        rng = np.random.default_rng(mi)
        nb, ntasks, ne = 4, 40, 120
        stack = np.stack([
            np.stack([rng.integers(0, m.dims[j], size=ntasks)
                      for j in range(m.ndim)], axis=1) for _ in range(nb)])
        edges = rng.integers(0, ntasks, size=(ne, 2))
        w = rng.uniform(0.5, 2.0, size=ne)
        cases.append((f"machine{mi}-{m.name}", m, edges, w, stack))
    # messages crossing the wrap-around seam in both directions
    m = make_machine((6, 5), wrap=True)
    coords = np.array([[5, 4], [0, 0], [1, 1], [4, 3]])
    cases.append(("wrapped-seam", m,
                  np.array([[0, 1], [1, 0], [3, 2], [0, 3]]),
                  np.array([2.0, 3.0, 1.5, 2.5]), coords[None]))
    # zero-length and zero-weight messages
    m = make_machine((8, 8), wrap=True)
    rng = np.random.default_rng(3)
    cases.append(("zero-length-zero-weight", m,
                  np.array([[0, 0], [1, 1], [2, 5], [7, 7]]),
                  np.array([3.0, 0.0, 2.0, 0.0]),
                  rng.integers(0, 8, size=(3, 30, 2))))
    return cases


def compare_case(name, machine, edges_np, w_np, stack_np, *, timed=False,
                 hop_only_cols=None):
    """Kernel against plain version on the card for both objectives.
    Returns a dict of what was measured (times only when ``timed``)."""
    import numpy as np
    import torch
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import ops, ref

    rec = {"case": name, "dims": list(machine.dims),
           "nb": int(len(stack_np)), "ne": int(len(edges_np))}
    max_err = 0.0
    for traffic in (False, True):
        stack = stack_np
        if not traffic and hop_only_cols is not None:
            stack = stack_np[..., :hop_only_cols]
        cs, edges, w, inv_bw = scoring_inputs(
            machine, edges_np, w_np, stack, traffic, "cuda")
        kw = dict(dims=machine.dims, wrap=machine.wrap,
                  core_dims=machine.core_dims, traffic=traffic)
        n0 = ops.launch_count
        got = ops.mapscore(cs, edges, w, inv_bw, **kw)
        again = ops.mapscore(cs, edges, w, inv_bw, **kw)
        torch.cuda.synchronize()
        check(ops.launch_count == n0 + 2, f"{name}: kernel did not launch")
        want = ref.mapscore_ref(cs, edges, w, inv_bw, **kw)
        torch.cuda.synchronize()
        check(set(got) == set(want), f"{name}: keys differ")
        for key in got:
            check(torch.equal(got[key], again[key]),
                  f"{name}/{key}: second launch differs from the first")
            g, r = got[key].cpu().numpy(), want[key].cpu().numpy()
            if key == "total_hops":
                check(np.array_equal(g, r), f"{name}: total_hops {g} != {r}")
            else:
                check(np.allclose(g, r, rtol=RTOL, atol=ATOL),
                      f"{name}/{key}: kernel {g} vs plain {r}")
                max_err = max(max_err, float(np.max(np.abs(g - r))))
        gn = {k: v.cpu().numpy() for k, v in got.items()}
        wn = {k: v.cpu().numpy() for k, v in want.items()}
        keys = OBJECTIVES["latency" if traffic else "wh"]
        check(winner(gn, keys) == winner(wn, keys),
              f"{name}: winner differs under {keys}")
        if timed:
            tag = "traffic" if traffic else "hops"
            rec[f"ms_{tag}"] = cuda_ms(
                lambda: ops.mapscore(cs, edges, w, inv_bw, **kw), 20)
            rec[f"plain_ms_{tag}"] = cuda_ms(
                lambda: ref.mapscore_ref(cs, edges, w, inv_bw, **kw), 5, 1)
            rec.update(bound(machine, cs, edges, w, inv_bw, traffic, tag))
    rec["max_abs_err"] = max_err
    return rec


def bound(machine, cs, edges, w, inv_bw, traffic, tag) -> dict:
    """Least time the card could take for this call.  Bytes: every input
    read once, every output written once, over the memory rate.
    Operations: the integer work these inputs need (hop arithmetic per
    message and network dim; direction, row key and four adds per
    (message, dim) pair that actually moves; one add and two compares per
    link-accumulator entry) over the fp32 non-tensor rate."""
    nb, ne = cs.shape[0], edges.shape[0]
    nd = machine.ndim - machine.core_dims
    nbytes = (cs.numel() * 4 + edges.numel() * 8 + w.numel() * 4
              + nb * (3 * 8 + 8))
    ops_n = nb * ne * (4 * nd + 2)
    if traffic:
        nbytes += inv_bw.numel() * 4
        src = cs[:, edges[:, 0], :nd]
        dst = cs[:, edges[:, 1], :nd]
        moved = int((src != dst).sum())
        links = 2 * nd * machine.nnodes * nb
        ops_n += moved * (8 + 2 * machine.ndim + 4) + 3 * links
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / FP32_OPS_PER_S * 1e3
    return {f"bound_ms_{tag}": max(t_bytes, t_ops),
            f"bound_by_{tag}": "bytes" if t_bytes >= t_ops else "operations",
            f"bound_bytes_{tag}": int(nbytes),
            f"bound_ops_{tag}": int(ops_n)}


def full_size_problem(name, scale, rotations):
    """The candidate stack the serve phase's request ``name`` scores:
    (request, pipeline, results, numpy coordinate stack)."""
    import numpy as np
    from repro_torch.mapping import rotation_candidates, shared_pipeline
    from repro_torch.serve import get_scenario
    req = get_scenario(name, scale=scale, rotations=rotations).request()
    pipe = shared_pipeline(req.config)
    pc = pipe.machine_coords(req.alloc)
    tc = np.asarray(req.graph.coords, dtype=np.float64)
    cands = rotation_candidates(tc.shape[1], pc.shape[1],
                                req.config.rotations)
    t0 = time.perf_counter()
    results = pipe.map_candidates(tc, pc, cands)
    part_s = time.perf_counter() - t0
    stack = np.stack([req.alloc.coords[r.task_to_proc] for r in results])
    return req, pipe, results, stack, part_s


# ---------------------------------------------------------------------------
# phase 4: flash attention vs plain version
# ---------------------------------------------------------------------------

# (name, B, S, H, KH, D, dtype, window, cap); all causal
ATTN_CASES = [
    ("mha", 1, 64, 4, 4, 32, "float32", 0, 0.0),
    ("gqa4-ragged80", 2, 80, 8, 2, 64, "float32", 0, 0.0),
    ("mqa", 1, 96, 4, 1, 16, "bfloat16", 0, 0.0),
    ("d128", 2, 64, 2, 2, 128, "float32", 0, 0.0),
    ("d128", 2, 64, 2, 2, 128, "bfloat16", 0, 0.0),
    *[(f"window{w}-cap{c:g}", 2, 128, 4, 2, 32, "float32", w, c)
      for w in (16, 48) for c in (0.0, 30.0)],
    ("window48-cap30", 1, 300, 8, 2, 128, "bfloat16", 48, 30.0),
    ("gemma2-27b-local", 1, 8192, 32, 16, 128, "bfloat16", 4096, 50.0),
    ("yi-6b-prefill", 4, 4000, 32, 4, 128, "float32", 0, 0.0),
    ("yi-6b-prefill", 4, 4000, 32, 4, 128, "bfloat16", 0, 0.0),
]
ATTN_TIMED = ("yi-6b-prefill", "bfloat16")


def live_entries(s: int, window: int) -> int:
    """Score entries a causal (windowed) self-attention of one head over
    ``s`` positions needs."""
    import numpy as np
    q = np.arange(s, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int((q - lo + 1).sum())


def attention_bound(b, s, h, kh, d, dtype, window) -> dict:
    """Least time for one call: every input read and the output written
    once over the memory rate, or 4*D flops (q.k and p.v) per live score
    entry over the peak rate of the type (bf16 tensor cores; float32 must
    stay float32, so the CUDA cores' rate)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elt
    flops = b * h * live_entries(s, window) * 4 * d
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def attention_case(name, b, s, h, kh, d, dtype, window, cap, seed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    kw = dict(causal=True, window=window, cap=cap)

    def plain():
        return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), **kw).transpose(1, 2)

    n0 = ops.launch_count
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(ops.launch_count == n0 + 2, f"{name}: kernel did not launch")
    want = plain()
    atol, rtol = ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    rec = {"case": name, "shape": [b, s, h, kh, d], "dtype": dtype,
           "window": window, "cap": cap, "max_abs_err": err,
           "mean_abs_out": float(want.float().abs().mean()),
           "atol": atol, "rtol": rtol}
    check(torch.equal(got, again), f"{name}/{dtype}: second launch differs")
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"{name}/{dtype}: kernel vs plain max abs err {err}")
    if (name, dtype) == ATTN_TIMED:
        rec["ms"] = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
        rec["plain_ms"] = cuda_ms(plain, 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True), 10)
        rec.update(attention_bound(b, s, h, kh, d, dtype, window))
    del q, k, v, got, again, want
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 5: the model path — yi-6b served at full width
# ---------------------------------------------------------------------------

def model_params(cfg) -> dict:
    """``init_params`` of seed 0, drawn in float32, with every stacked
    block matrix widened by sqrt(L) to one layer's fan-in, then rounded
    leaf by leaf to ``cfg``'s dtypes (so the bfloat16 model is the
    rounding of the float32 one).  The reference's init counts the layer
    axis in the fan-in; its random yi-6b's blocks barely move the
    residual stream, and the logits compared below would hardly see
    attention."""
    import dataclasses
    import math
    from repro_torch.models import init_params, params_spec
    from repro_torch.models.params import DTYPES, spec_leaves
    params = init_params(dataclasses.replace(cfg, dtype="float32"), seed=0,
                         device="cuda")
    for path, p in spec_leaves(params_spec(cfg)):
        node = params
        for key in path[:-1]:
            node = node[key]
        val = node[path[-1]]
        if p.init == "normal" and not p.scale and "layers" in p.axes:
            val.mul_(math.sqrt(p.shape[p.axes.index("layers")]))
        node[path[-1]] = val.to(DTYPES[p.dtype or cfg.dtype])
    return params


def drive(cfg, params, prompts, max_seq: int):
    """prefill + greedy decode steps, as ``ServeEngine.generate`` runs
    them, keeping every served position's logits.  Returns (logits
    (B, NEW, V) float32 numpy, tokens (B, NEW) int32, prefill s, decode
    s)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, prefill
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cache = prefill(cfg, params, {"tokens": tokens}, max_seq=max_seq)
        logits = [lg[:, -1].float().cpu()]
        t1 = time.perf_counter()
        nxt = lg[:, -1].argmax(-1)
        out = [nxt]
        for i in range(NEW_TOKENS - 1):
            lg, cache = decode_step(cfg, params, cache, nxt[:, None],
                                    prompts.shape[1] + i)
            logits.append(lg[:, 0].float().cpu())
            nxt = lg[:, 0].argmax(-1)
            out.append(nxt)
        toks = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    t2 = time.perf_counter()
    return torch.stack(logits, 1).numpy(), toks, t1 - t0, t2 - t1


def full_forward_logits(cfg, params, prompts, served):
    """The plain path's logits at the served positions, from one forward
    pass over prompt + served tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import logits_fn
    seq = torch.as_tensor(np.concatenate([prompts, served[:, :-1]], axis=1),
                          device="cuda")
    plain = dataclasses.replace(cfg, attn_impl="xla_flash")
    with torch.inference_mode():
        lg = logits_fn(plain, params, {"tokens": seq})
        return lg[:, prompts.shape[1] - 1:].float().cpu().numpy()


def scaled_err(got, want) -> float:
    import numpy as np
    return float(np.abs(got - want).max() / np.abs(want).max())


def model_phase(profile: bool) -> dict:
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import ops as ms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import count_params, params_spec
    from repro_torch.serve import ServeEngine

    base = get_config(MODEL)
    check(base.attn_impl == "hopper" and base.family == "dense",
          f"{MODEL}: not served through the kernel")
    prompts = np.random.default_rng(0).integers(
        0, base.vocab_size, size=(PROMPTS, PROMPT_LEN))
    max_seq = PROMPT_LEN + NEW_TOKENS
    rec = {"model": MODEL, "params": count_params(params_spec(base)),
           "layers": base.num_layers, "d_model": base.d_model,
           "prompts": PROMPTS, "prompt_len": PROMPT_LEN,
           "new_tokens": NEW_TOKENS, "max_seq": max_seq, "seed": 0,
           "logits_tol": LOGITS_TOL}

    # (a) float32: the served path against the plain full forward
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 would not be float32")
    cfg = dataclasses.replace(base, dtype="float32")
    params = model_params(cfg)
    engine = ServeEngine(cfg, params, max_seq=max_seq, batch=PROMPTS)
    served = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    logits, toks, pre_s, dec_s = drive(cfg, params, prompts, max_seq)
    check(np.array_equal(toks, served),
          "float32: prefill + decode_step tokens differ from generate's")
    want32 = full_forward_logits(cfg, params, prompts, served)
    err = scaled_err(logits, want32)
    rec["float32"] = {"scaled_err": err, "max_abs_logit":
                      float(np.abs(want32).max()), "prefill_s": pre_s,
                      "decode_s": dec_s, "tokens": served[0].tolist()}
    emit("model", part="float32", **{k: v for k, v in rec.items()
                                      if k != "float32"}, **rec["float32"])
    check(np.isfinite(logits).all(), "float32: non-finite logits")
    check(err <= LOGITS_TOL["float32"],
          f"float32: served logits {err} from the plain forward")
    del params, engine
    torch.cuda.empty_cache()

    # (b) bfloat16: the served run
    cfg = base
    params = model_params(cfg)
    engine = ServeEngine(cfg, params, max_seq=max_seq, batch=PROMPTS)
    logits, toks, pre_s, dec_s = drive(cfg, params, prompts, max_seq)
    torch.cuda.reset_peak_memory_stats()
    # the model path only
    fa_ops.launch_count = ms_ops.launch_count = ssd_ops.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    gen_s = time.perf_counter() - t0
    launches = fa_ops.launch_count
    peak = torch.cuda.max_memory_allocated()
    check(ms_ops.launch_count == ssd_ops.launch_count == 0,
          "the dense model path launched another kernel")
    check(launches == cfg.num_layers,
          f"generate launched the kernel {launches} times, expected one "
          f"per layer ({cfg.num_layers})")
    check(np.array_equal(toks, served),
          "bfloat16: prefill + decode_step tokens differ from generate's")
    want = full_forward_logits(cfg, params, prompts, served)
    err = scaled_err(logits, want)
    # how far a bfloat16 computation lies from float32: the float32
    # tolerance must be tighter (same prompt, so position 0 compares)
    gap = scaled_err(logits[:, 0], want32[:, 0])
    rec["bfloat16"] = {
        "scaled_err": err, "max_abs_logit": float(np.abs(want).max()),
        "vs_float32_at_prefill": gap, "generate_s": gen_s,
        "prefill_s": pre_s, "decode_ms_per_token":
            dec_s / (NEW_TOKENS - 1) * 1e3,
        "tokens_per_s": PROMPTS * NEW_TOKENS / gen_s,
        "prefill_tokens_per_s": PROMPTS * PROMPT_LEN / pre_s,
        "flash_launches": launches,
        "peak_mem_gib": peak / 2 ** 30,
        "tokens": served[0].tolist()}
    emit("model", part="bfloat16", **rec["bfloat16"])
    check(np.isfinite(logits).all(), "bfloat16: non-finite logits")
    check(err <= LOGITS_TOL["bfloat16"],
          f"bfloat16: served logits {err} from the plain forward")
    check(gap > LOGITS_TOL["float32"],
          f"bfloat16 lies only {gap} from float32: the float32 tolerance "
          "would not catch it")
    if profile:
        model_profile(cfg, params, prompts, max_seq)
    del params, engine
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 6: the SSD kernel vs its plain version
# ---------------------------------------------------------------------------

# (name, B, L, H, P, N, chunk, A or None (drawn), x/B/C cut from one tensor)
SSD_CASES = [
    ("l-below-chunk", 1, 48, 2, 16, 16, 128, None, False),
    ("l-at-chunk", 2, 128, 2, 32, 32, 128, None, False),
    ("three-chunks", 2, 384, 4, 64, 64, 128, None, False),
    ("one-head", 1, 256, 1, 64, 128, 128, None, False),
    ("conv-out-views", 2, 256, 4, 64, 128, 128, None, True),
    ("decay-100", 1, 64, 2, 16, 16, 32, -100.0, False),
    ("zamba2-1.2b-prefill", 4, 4096, 64, 64, 64, 128, None, False),
    ("mamba2-2.7b-prefill", 4, 4096, 80, 64, 128, 128, None, False),
]
SSD_TIMED = ("mamba2-2.7b-prefill", "bfloat16")
SSD_QT = 32                 # the kernel's own chunk (csrc/ssd.cu)


def ssd_inputs(b, l, h, p, n, dtype, a_value, views, seed):
    """x, dt, A, B, C on the card as ``tests/test_kernels.py`` draws them
    (dt = softplus(normal) float32, A = -exp(0.5 normal), or ``a_value``
    with dt moved up by 0.5); with ``views``
    x, B and C are column slices of one (B, L, H*P + 2N) tensor and dt a
    transposed view, the layout ``mamba_block`` hands the kernel."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if views:
        conv = randn(b, l, h * p + 2 * n).to(tdt)
        x = conv[..., :h * p].reshape(b, l, h, p)
        B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        dt = F.softplus(randn(b, h, l)).transpose(1, 2)
    else:
        x = randn(b, l, h, p).to(tdt)
        B, C = randn(b, l, n).to(tdt), randn(b, l, n).to(tdt)
        dt = F.softplus(randn(b, l, h))
    if a_value is None:
        A = -torch.exp(randn(h) * 0.5)
    else:  # dt >= 0.5: every step's decay exp(dt * A) is below exp(-50)
        A = torch.full((h,), a_value, device="cuda")
        dt = dt + 0.5
    return x, dt, A, B, C


def ssd_bound(b, l, h, p, n, dtype) -> dict:
    """Least time for one call.  Bytes: x, dt, A, B and C read once, y
    written once.  Operations: what the kernel's chunked form needs per
    (b, h) row and chunk of 32 steps — 2(N + P) flops per live (j <= i)
    score entry (C.B and the score-weighted x), 2NP per step for the
    carried state's readout and 2NP per step for its update — over the
    peak rate of the type (bf16 tensor cores; float32 must stay float32,
    so the CUDA cores' rate)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * l * h * p + 2 * b * l * n) * elt + b * l * h * 4 \
        + h * 4
    chunks = -(-l // SSD_QT)
    live = SSD_QT * (SSD_QT + 1) // 2
    flops = b * h * chunks * (live * 2 * (n + p) + 2 * 2 * SSD_QT * n * p)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def ssd_case(name, b, l, h, p, n, chunk, a_value, views, dtype, seed):
    import torch
    from repro_torch.kernels.ssd import ops, ref
    x, dt, A, B, C = ssd_inputs(b, l, h, p, n, dtype, a_value, views, seed)
    n0 = ops.launch_count
    got = ops.ssd(x, dt, A, B, C, chunk=chunk)
    again = ops.ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    check(ops.launch_count == n0 + 2, f"{name}: kernel did not launch")
    want = ref.ssd_model_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    a_frac, rtol = SSD_TOL[dtype]
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    rec = {"case": name, "shape": [b, l, h, p, n], "chunk": chunk,
           "dtype": dtype, "max_abs_err": err, "max_abs_out": scale,
           "mean_abs_out": float(w.abs().mean()),
           "atol": a_frac * scale, "rtol": rtol}
    check(torch.equal(got, again), f"{name}/{dtype}: second launch differs")
    check(bool(torch.isfinite(g).all()), f"{name}/{dtype}: non-finite y")
    check(torch.allclose(g, w, atol=a_frac * scale, rtol=rtol),
          f"{name}/{dtype}: kernel vs plain max abs err {err}")
    if a_value is not None and dtype == "float32":
        # instant decay leaves the local term y_t = (C_t . B_t) dt_t x_t
        local = torch.einsum("bln,bln->bl", C, B)[..., None, None] * (
            x * dt[..., None])
        check(torch.allclose(g, local, atol=1e-4, rtol=1e-4),
              f"{name}: history did not vanish")
    if (name, dtype) == SSD_TIMED:
        rec["ms"] = cuda_ms(lambda: ops.ssd(x, dt, A, B, C, chunk=chunk), 10)
        rec["plain_ms"] = cuda_ms(lambda: ref.ssd_model_ref(x, dt, A, B, C),
                                  2, 1)
        rec.update(ssd_bound(b, l, h, p, n, dtype))
    del x, dt, A, B, C, got, again, want, g, w
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 7 and 8: mamba2-2.7b and zamba2-1.2b served at full width
# ---------------------------------------------------------------------------

def drive_recurrent(cfg, params, prompts, max_seq):
    """The token-by-token ingest and the greedy decode steps, as
    ``ServeEngine.generate`` runs them for ssm / hybrid prompts.  Returns
    (last ingest logits (B, V) float32 numpy, tokens (B, NEW) int32,
    ingest s, decode s)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_cache
    tokens = torch.as_tensor(prompts, device="cuda")
    plen = prompts.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = init_cache(cfg, prompts.shape[0], max_seq, device="cuda")
        for t in range(plen):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t)
        last = lg[:, 0].float().cpu().numpy()
        t1 = time.perf_counter()
        nxt = lg[:, 0].argmax(-1)
        out = [nxt]
        for i in range(NEW_TOKENS - 1):
            lg, cache = decode_step(cfg, params, cache, nxt[:, None],
                                    plen + i)
            nxt = lg[:, 0].argmax(-1)
            out.append(nxt)
        toks = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    t2 = time.perf_counter()
    return last, toks, t1 - t0, t2 - t1


def counted_prefill(cfg, params, prompts) -> tuple:
    """One ``prefill`` with every kernel count set to 0 just before and
    read just after: (last logits float32 numpy, seconds, counts)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import ops as ms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import prefill
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    ms_ops.launch_count = fa_ops.launch_count = ssd_ops.launch_count = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, _ = prefill(cfg, params, {"tokens": tokens})
        last = lg[:, -1].float().cpu().numpy()
    seconds = time.perf_counter() - t0
    counts = {"ssd": ssd_ops.launch_count,
              "flash_attention": fa_ops.launch_count,
              "mapscore": ms_ops.launch_count}
    return last, seconds, counts


def recurrent_model(name: str, dtype: str, *, long_len: int = 0,
                    profile: bool = False) -> dict:
    """Prefill (the SSD kernel) against the recurrent ingest on 4 prompts
    of ``SSM_PROMPT_LEN`` tokens, ``generate`` against the driven steps,
    timed; with ``long_len`` one more timed prefill of 4 x ``long_len``
    tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, params_spec
    from repro_torch.models.transformer import is_attn_site
    from repro_torch.serve import ServeEngine

    base = get_config(name)
    check(base.family in ("ssm", "hybrid"), f"{name}: not an ssm model")
    cfg = dataclasses.replace(base, dtype=dtype)
    sites = (sum(is_attn_site(cfg, i) for i in range(cfg.num_layers))
             if cfg.family == "hybrid" else 0)
    want_counts = {"ssd": cfg.num_layers, "flash_attention": sites,
                   "mapscore": 0}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(PROMPTS, SSM_PROMPT_LEN))
    max_seq = SSM_PROMPT_LEN + NEW_TOKENS
    params = model_params(cfg)
    rec = {"model": name, "dtype": dtype,
           "params": count_params(params_spec(cfg)),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
           "ssm_state": cfg.ssm_state, "attn_sites": sites,
           "prompts": PROMPTS, "prompt_len": SSM_PROMPT_LEN,
           "new_tokens": NEW_TOKENS, "seed": 0,
           "logits_tol": SSM_LOGITS_TOL[dtype]}

    last_rec, toks, ingest_s, dec_s = drive_recurrent(cfg, params, prompts,
                                                      max_seq)
    last_pre, pre_s, counts = counted_prefill(cfg, params, prompts)
    check(counts == want_counts,
          f"{name}/{dtype}: prefill launched {counts}, expected "
          f"{want_counts}")
    err = scaled_err(last_pre, last_rec)
    engine = ServeEngine(cfg, params, max_seq=max_seq, batch=PROMPTS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec.update({
        "scaled_err": err, "max_abs_logit": float(np.abs(last_rec).max()),
        "prefill_s": pre_s, "ingest_s": ingest_s,
        "decode_ms_per_token": dec_s / (NEW_TOKENS - 1) * 1e3,
        "generate_s": gen_s, "tokens_per_s": PROMPTS * NEW_TOKENS / gen_s,
        "peak_mem_gib": peak / 2 ** 30, "prefill_launches": counts,
        "tokens": served[0].tolist(), "prefill_last": last_pre})
    check(np.isfinite(last_pre).all() and np.isfinite(last_rec).all(),
          f"{name}/{dtype}: non-finite logits")
    check(err <= SSM_LOGITS_TOL[dtype],
          f"{name}/{dtype}: prefill logits {err} from the recurrent ingest")
    check(np.array_equal(toks, served),
          f"{name}/{dtype}: driven tokens differ from generate's")
    if long_len:
        long = rng.integers(0, cfg.vocab_size, size=(PROMPTS, long_len))
        counted_prefill(cfg, params, long[:, :SSD_QT])       # warm-up
        last_long, long_s, long_counts = counted_prefill(cfg, params, long)
        check(long_counts == want_counts,
              f"{name}/{dtype}: long prefill launched {long_counts}")
        check(np.isfinite(last_long).all(), "long prefill: non-finite")
        rec.update({"long_prompt_len": long_len, "long_prefill_s": long_s,
                    "long_prefill_tokens_per_s": PROMPTS * long_len / long_s,
                    "long_prefill_launches": long_counts})
    if profile:
        model_profile(cfg, params, prompts, max_seq, name)
    del params, engine
    torch.cuda.empty_cache()
    return rec


def ssm_phase(profile: bool) -> dict:
    """mamba2-2.7b in float32, then bfloat16 (timed, and a long
    prefill); the bfloat16 prefill logits must lie beyond the float32
    tolerance from the float32 ones, or that tolerance would not tell
    the two apart."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 would not be float32")
    out = {}
    for dtype in ("float32", "bfloat16"):
        rec = recurrent_model(SSM_MODEL, dtype,
                              long_len=SSM_LONG_LEN if dtype == "bfloat16"
                              else 0, profile=profile and dtype == "bfloat16")
        out[dtype] = rec
        emit("ssm_model", **{k: v for k, v in rec.items()
                             if k != "prefill_last"})
    gap = scaled_err(out["bfloat16"]["prefill_last"],
                     out["float32"]["prefill_last"])
    emit("ssm_model", part="bfloat16_vs_float32", scaled_gap=gap)
    check(gap > SSM_LOGITS_TOL["float32"],
          f"bfloat16 lies only {gap} from float32: the float32 tolerance "
          "would not catch it")
    out["bfloat16_vs_float32"] = gap
    return out


# ---------------------------------------------------------------------------
# optional phase: where the device's time goes (--profile)
# ---------------------------------------------------------------------------

def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (device activity only) and
    return the wall seconds, the device-busy microseconds and the device
    time by kernel / copy name.  The busy sum treats the device's
    operations as one after another, which holds here: everything runs
    on one stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            by_name[ev.key] = {"us": ev.self_device_time_total,
                               "calls": ev.count}
    busy_us = sum(v["us"] for v in by_name.values())
    check(busy_us > 0, "the profiler saw no device time")
    return {"wall_s": wall_s, "device_busy_us": busy_us,
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall_s,
            "by_name": by_name}


def model_profile(cfg, params, prompts, max_seq, name=MODEL) -> None:
    """One prefill and one decode step of the served model: device time
    by kernel name, idle share.  (For ssm models the step runs on the
    unfilled cache prefill returns: its cost does not depend on the
    state's values.)"""
    import torch
    from repro_torch.models import decode_step, prefill
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        pre = device_profile(lambda: prefill(cfg, params, {"tokens": tokens},
                                             max_seq=max_seq))
        lg, cache = prefill(cfg, params, {"tokens": tokens}, max_seq=max_seq)
        nxt = lg[:, -1].argmax(-1)[:, None]
        step = device_profile(lambda: decode_step(cfg, params, cache, nxt,
                                                  prompts.shape[1]))
    emit("profile", part="model", model=name, dtype=cfg.dtype,
         prefill=by_class(pre), decode_step=by_class(step))


def by_class(prof: dict, top: int = 8) -> dict:
    """A profile with its device time summed by kernel class (the flash
    and SSD kernels, cuBLAS products, copies, everything else) and only
    the ``top`` longest names kept."""
    classes = {"flash_attention": 0.0, "ssd": 0.0, "matmul": 0.0,
               "copy": 0.0, "other": 0.0}
    for name, v in prof["by_name"].items():
        low = name.lower()
        if "flash_attention" in low:
            key = "flash_attention"
        elif "ssd_chunked_scan" in low:
            key = "ssd"
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "matmul"
        elif "memcpy" in low or "memset" in low:
            key = "copy"
        else:
            key = "other"
        classes[key] += v["us"]
    longest = sorted(prof["by_name"].items(), key=lambda kv: -kv[1]["us"])
    return {**{k: v for k, v in prof.items() if k != "by_name"},
            "us_by_class": classes,
            "top": {name[:100]: v for name, v in longest[:top]}}


def profile_phase(problem, scale, rotations) -> None:
    """One kernel launch at the lead shape, pass by pass, and one cold
    request through a fresh service: device time by name, idle share."""
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import ops
    from repro_torch.serve import MappingService, get_scenario
    req, _, _, stack, _ = problem
    m = req.alloc.machine
    cs, edges, w, inv_bw = scoring_inputs(
        m, req.graph.edges, req.graph.weights, stack, True, "cuda")
    kw = dict(dims=m.dims, wrap=m.wrap, core_dims=m.core_dims, traffic=True)
    ops.mapscore(cs, edges, w, inv_bw, **kw)   # warm-up
    launch = device_profile(lambda: ops.mapscore(cs, edges, w, inv_bw, **kw))
    cold = get_scenario(SCENARIOS[1], scale=scale,
                        rotations=rotations).request()
    svc = MappingService()
    request = device_profile(lambda: svc.map(cold))
    emit("profile", kernel_launch=launch, cold_request=request,
         scenario=SCENARIOS[1], scale=scale)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=2 ** 18,
                    help="tasks per served request (>= 2**16)")
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time by kernel name of one "
                         "mapscore launch, one cold request, and one "
                         "prefill and decode step of yi-6b and of "
                         "mamba2-2.7b (torch.profiler)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script only "
              "runs on a GPU", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.core.metrics import evaluate_candidates_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import kernel as ms_kernel
    from repro_torch.kernels.mapscore import ops
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.serve import MappingService, get_scenario

    # -- phase 1: device + build ------------------------------------------
    smi = nvidia_smi_line()
    ms_kernel._launch_fn()          # builds and loads, or raises
    fa_kernel._launch_fn()
    ssd_kernel._launch_fn()
    info = _build.build_info()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_seconds=info["seconds"], built=info["built"],
         library=os.path.relpath(info["path"]), sources=info["sources"])

    # -- phase 2: kernel vs plain -----------------------------------------
    small = [compare_case(*c) for c in small_cases()]
    # hop-only stack with the core column left out (gemini, 1 core dim)
    c = small_cases()[3]
    small.append(compare_case("hop-only-no-core-cols", *c[1:],
                              hop_only_cols=c[1].ndim - c[1].core_dims))
    full = []
    problems = {}
    for name in dict.fromkeys(n.rsplit("-", 1)[0] for n in SCENARIOS):
        # one stack per (workload, allocation); both objectives run on it
        prob = full_size_problem(name + "-latency", args.scale,
                                 args.rotations)
        problems[name] = prob
        req, _, _, stack, part_s = prob
        rec = compare_case(f"{name}@{args.scale}", req.alloc.machine,
                           req.graph.edges, req.graph.weights, stack,
                           timed=True)
        rec["partition_s"] = part_s
        _, _, per_cand = ms_kernel.workspace_layout(
            req.alloc.machine.dims, req.alloc.machine.core_dims)
        rec["workspace_bytes_per_candidate"] = per_cand * 8
        full.append(rec)
    check(any(r["workspace_bytes_per_candidate"] > 232448 for r in full),
          "no full-size machine exceeds one block's shared memory")
    emit("kernels", rtol=RTOL, atol=ATOL, small=small, full=full,
         timing="median of 20 kernel / 5 plain launches, CUDA events")

    # -- phase 3: serve -----------------------------------------------------
    svc = MappingService()
    reqs = [get_scenario(n, scale=args.scale,
                         rotations=args.rotations).request()
            for n in SCENARIOS]
    # the main path's only
    ops.launch_count = fa_ops.launch_count = ssd_ops.launch_count = 0
    served = []
    expected_launches = 0
    for name, req in zip(SCENARIOS, reqs):
        resp = svc.map(req)
        torch.cuda.synchronize()
        check(resp.status == "cold", f"{name}: first answer {resp.status}")
        res = resp.result
        check("degraded" not in res.stats, f"{name}: degraded answer")
        t2p = np.asarray(res.task_to_proc)
        check(t2p.shape == (req.graph.n,), f"{name}: shape {t2p.shape}")
        check(t2p.min() >= 0 and t2p.max() < req.alloc.n,
              f"{name}: assignment leaves the allocation")
        if req.graph.n == req.alloc.n:
            check(np.bincount(t2p, minlength=req.alloc.n).max() == 1,
                  f"{name}: a processor holds two tasks")
        check(np.isfinite(res.score), f"{name}: score {res.score}")
        traffic = "latency" in name
        chunk = ops.candidate_chunk(req.alloc.machine, traffic) \
            or args.rotations
        expected_launches += -(-args.rotations // chunk)
        served.append({"scenario": name, "tasks": int(req.graph.n),
                       "edges": int(len(req.graph.edges)),
                       "machine_dims": list(req.alloc.machine.dims),
                       "cold_s": resp.latency_s, "score": res.score,
                       "rotation": res.rotation,
                       **{k: v for k, v in res.stats["timings"].items()}})
    launches = ops.launch_count
    check(fa_ops.launch_count == ssd_ops.launch_count == 0,
          "the mapping path launched a model kernel")
    check(launches == expected_launches and launches > 0,
          f"launch count {launches}, expected {expected_launches}")

    # every cold winner against the numpy evaluator on the same stack
    for name, req, rec in zip(SCENARIOS, reqs, served):
        _, pipe, results, stack, _ = problems[name.rsplit("-", 1)[0]]
        obj = OBJECTIVES[name.rsplit("-", 1)[1]]
        t0 = time.perf_counter()
        ev = evaluate_candidates_numpy(
            req.alloc.machine, req.graph.edges, req.graph.weights, stack,
            traffic="latency_max" in obj)
        best = winner(ev, obj)
        rec["numpy_score_s"] = time.perf_counter() - t0
        rec["numpy_winner"] = best
        got = svc.results.get(req.signature(), count=False)
        check(np.array_equal(got.task_to_proc, results[best].task_to_proc)
              and got.rotation == results[best].rotation,
              f"{name}: served winner is not the numpy evaluator's "
              f"(numpy picks candidate {best})")
        check(np.isclose(got.score, ev[obj[0]][best], rtol=RTOL),
              f"{name}: score {got.score} vs numpy {ev[obj[0]][best]}")

    for name, req, rec in zip(SCENARIOS, reqs, served):
        resp = svc.map(req)
        check(resp.status == "warm", f"{name}: repeat answer {resp.status}")
        rec["warm_s"] = resp.latency_s
    batch = svc.map_many([reqs[0], reqs[1], reqs[0]])
    check([r.status for r in batch] == ["warm", "warm", "coalesced"],
          f"batch statuses {[r.status for r in batch]}")
    check(ops.launch_count == launches, "a warm answer launched the kernel")
    stats = svc.stats()
    check(stats["cold"] == len(SCENARIOS), f"service stats {stats}")
    emit("serve", scale=args.scale, rotations=args.rotations,
         requests=served, kernel_launches=launches,
         service={k: stats[k] for k in ("cold", "warm", "coalesced")})
    if args.profile:
        profile_phase(problems[SCENARIOS[1].rsplit("-", 1)[0]], args.scale,
                      args.rotations)

    # -- phase 4: flash attention vs plain ----------------------------------
    attn = [attention_case(*c, seed=i) for i, c in enumerate(ATTN_CASES)]
    emit("attention", cases=attn,
         timing="median of 10 kernel / 10 library / 3 plain launches, "
                "CUDA events")

    # -- phase 5: the model path --------------------------------------------
    model = model_phase(args.profile)

    # -- phase 6: the SSD kernel vs plain -----------------------------------
    ssd = [ssd_case(*c, dtype=dt, seed=i) for i, c in enumerate(SSD_CASES)
           for dt in ("float32", "bfloat16")]
    emit("ssd", cases=ssd, timing="median of 10 kernel / 2 plain launches, "
                                  "CUDA events")

    # -- phases 7 and 8: the ssm and hybrid model paths ---------------------
    ssm = ssm_phase(args.profile)
    hybrid = recurrent_model(HYBRID_MODEL, "bfloat16")
    emit("hybrid_model", **{k: v for k, v in hybrid.items()
                            if k != "prefill_last"})

    # -- the kernels line ---------------------------------------------------
    fa = next(r for r in attn if (r["case"], r["dtype"]) == ATTN_TIMED)
    sd = next(r for r in ssd if (r["case"], r["dtype"]) == SSD_TIMED)
    lead = full[0]  # minighost on xk7_sparse: the largest accumulators
    kernels = [{
        "name": "mapscore", "route": "cuda",
        "source": "src/repro_torch/kernels/mapscore/csrc/mapscore.cu",
        "replaces": "src/repro/kernels/mapscore/kernel.py:204",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in small + full),
        "ms": lead["ms_traffic"], "plain_ms": lead["plain_ms_traffic"],
        "bound_ms": lead["bound_ms_traffic"],
        "bound_by": lead["bound_by_traffic"],
        "library_ms": None,
        "shape": {"case": lead["case"], "nb": lead["nb"], "ne": lead["ne"],
                  "dims": lead["dims"], "traffic": True},
        "tolerance": {"rtol": RTOL, "atol": ATOL, "total_hops": "exact"},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": model["bfloat16"]["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in attn),
        "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "shape": {"case": fa["case"], "bshkd": fa["shape"],
                  "dtype": fa["dtype"], "causal": True},
        "tolerance": {k: {"atol": a, "rtol": r}
                      for k, (a, r) in ATTN_TOL.items()},
    }, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:68",
        "launches": ssm["bfloat16"]["long_prefill_launches"]["ssd"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None,
        "shape": {"case": sd["case"], "blhpn": sd["shape"],
                  "dtype": sd["dtype"]},
        "tolerance": {k: {"atol": f"{a:g} * max|y|", "rtol": r}
                      for k, (a, r) in SSD_TOL.items()},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
