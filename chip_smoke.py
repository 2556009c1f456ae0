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
   full-size shapes of ``serve``; a second launch must be bit-identical and
   the status word clear; an out-of-range edge and a coordinate equal to
   its dimension must each raise ValueError, and a valid call after them
   must equal the one before bit for bit; the kernel (under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync), the plain
   version and (at full size) the bound are timed.  Then the contract
   kernels (the hierarchy's contraction) against their plain version on
   the host and numpy's ``bincount`` / ``unique`` body, bit for bit, at
   the node cell's shape (131,072 tasks, 770,048 edges, 4,096 clusters:
   timed beside the two sorts, the plain version, numpy's body, the
   uploads and the byte bound), at a depth-3 second level's and on small
   weighted, one-cluster, one-task-a-cluster, repeated-edge and
   self-loop, 1- and 5-dimensional cases: a rerun bit for bit, one
   launch a call, an endpoint or a label out of range raising.
3. ``partition`` — the device partitioner (``core/partition_torch.py``)
   against the host numpy engine, bit for bit, on both sides of the
   rotation sweeps of the four served scenarios at ``--scale`` tasks
   (default 2**18), a weighted sweep (task weights from seed 0: segscan
   once a level), a Hilbert one, an uneven-prime one (10800 parts) and a
   small cloud of mixed -0.0 / 0.0 coordinates under FZ and Gray; a rerun
   must be bit-identical, every sweep after its upload runs under
   ``torch.cuda.set_sync_debug_mode("error")``, and the device and host
   times are kept (an unweighted sweep launches mjfinish once where it
   hands off); then segscan against its plain version, exactly, at
   the weighted sweep's shape (first-level and random segments), timed
   beside ``torch.cumsum`` with its bound; then mjfinish from the loop's
   state at the handoff level against its plain version and the host
   engine, bit for bit, at the main path's shapes (131,072 x 6 grid and
   core clouds, 86,400 x 6, 4,096 x 6 under FZ, Gray, FZlow and strict
   alternation, 131,072 into 4,096 parts x 1): one launch a call, a rerun
   bit for bit, timed beside its byte bound and the whole sweep; and,
   each in a child process, a plan that skips a segment or misplaces
   its heads must make the next synchronising call raise.
   ``serve``   — a ``MappingService`` with the default config (device
   partitioner, one-pass fused sweep, ``device="cuda"``) answers the four
   scenarios and a weighted one cold: each takes the fused path with one
   kernel launch (segscan once a level for the weighted one, mjfinish
   once a side it finishes) and serves
   the host-engine candidate that the numpy evaluator picks; then warm,
   a batch with a duplicate, and each scenario with ``fused="off"`` (the
   staged device path, same answers) for its stage timings.
   ``hier``    — the same service answers four hierarchical requests cold
   at ``--scale`` tasks: ``minighost-xk7_sparse-node-wh`` and
   ``-node-latency`` (16,384 clusters: coarsening on the device
   partitioner, the top sweep through the fused sweep with the swap
   refinement on the card, K1 in its loop for the latency one),
   ``homme-bgq_block-depth3-latency`` and ``minighost-xk7_sparse-depth3-wh``
   (a 4-unit group level on top: staged sweep, then ``refine_qap``,
   ``polish_groups`` and the node level's ``refine_swaps`` on the host,
   K1 scoring the latency objective).  Each answer must be a bijection,
   not degraded, of the hierarchy and depth asked, ``fused_refine``
   exactly where the top level swaps, with monotone histories, K1
   launched once a pipeline evaluator call plus the fused pass's own,
   segscan (the top sweep is weighted by cluster sizes) at least once,
   mjfinish once a sweep that hands off (two a node request: the
   coarsening and the router side), coredeal once an expansion to cores
   or units and contract once a coarsening level, every
   ``hier.assign_cores`` and ``hier.contract`` span's ``path`` ``"cuda"``
   (one of each a node request, two a depth-3 one); and equal, bit for bit, to the all-host path (numpy
   partitioner and scorer, ``fused="off"``) for WeightedHops and to the staged path with
   the same K1 scorer for the latency objective.  Before them: the fused
   refinement against the host pass on the card for tied and zero
   contributions, and K1 on one stack whole, in halves and with the host
   evaluator's group bound, bit for bit; and coredeal against its plain
   version on the card and on the host, bit for bit, at the node cell's
   shape (131,072 tasks, 4,096 routers x 32 cores; timed beside its
   three sorts and its byte bound) and on small uneven,
   spill, tied, 1-, 7- and 20-dimensional and NaN cases; an out-of-range
   cluster or router id raises.  Times
   sit beside the flat request of the same scenario from ``serve``.
   ``resilience`` — the default-config service answers
   ``minighost-xk7_sparse-flat-wh`` at ``--scale`` tasks under injected
   faults (``faults.isolated()``, a fresh service over cleared pipelines a
   case).  On the card the ladder never leaves the card's kernels (full,
   then unfused): K1 failing once is served by ``unfused``, K1 or the
   device partitioner failing on both rungs raises to the caller with two
   failed rungs and nothing cached, and a first rung sleeping past
   ``deadline_s`` is served by ``unfused`` with one deadline miss; every
   fault fires as planned and every answer equals phase ``serve``'s
   healthy one bit for bit.  Before the cases one healthy cold
   request runs under ``obs.torch_profile`` (``REPRO_TORCH_PROFILE`` at
   ``build/chip_smoke/profile``), whose device trace must name the
   mapscore kernel; a ``JsonlSink`` logs the phase, which must read back
   with the degraded and the failed rungs, and its Chrome trace and the Prometheus text
   must parse.
   ``meshmap`` — ``select_mapping`` with its defaults (K1, the device
   partitioner, ``cuda``) and on the all-host path for the logical meshes
   of ``benchmarks/mapping_tpu.py`` (aligned, four mismatched shapes,
   three sparse allocations, two pods): equal winners bit for bit, never
   worse than the enumeration; a repeat build through a service is all
   warm; ``make_topology_mesh(multi_pod=True)`` lays the ranks out in the
   winner's order, and the collective term of both layouts is printed.
   Every service of the mapping phases (outside the injected cases) must
   show no degraded answer, failed or skipped rung or open breaker.
4. ``attention`` — the flash-attention kernel against its plain-torch
   version on the card: MHA, GQA 4:1 and MQA, ragged S (80; 4000), head
   dims 16 to 128, windows 16 / 48 with caps 0 / 30, gemma2-27b's local
   layer (S=8192, window 4096, cap 50), yi-6b's prefill (B=4, S=4000,
   H=32, KH=4, D=128) and zamba2-1.2b's (B=4, S=256, H=KH=32, D=64),
   one rank's shard of phase ``elastic``'s yi-6b step on (2, 2) and on
   (4, 1) (B=2 / 1, S=512, H=16 / 32, KH=2 / 4, D=128),
   float32 at 2e-5 and bfloat16 at 4e-3 + 8e-3·|o| (two ulp); a second
   launch must be bit-identical; at the three bfloat16 model shapes the
   kernel, the plain version, the bound and ``scaled_dot_product_attention``
   (with a window: an explicit boolean mask, and no cap) are timed.
   Then the shapes the moe, encdec and vlm families give it (no cap):
   whisper-small's encoder (B=4, S=T=1500, H=KH=12, D=64, non-causal:
   the ragged last key tile), decoder (S=T=64, causal), cross-attention
   (S=64 and S=1 over T=1500, non-causal), in float32 and bfloat16;
   mixtral-8x22b's prefill (B=4, S=5000, H=48, KH=8, D=128, window
   4096) and internvl2-26b's (S=2048, causal), bfloat16; the same
   tolerances and bit-identical reruns, and the bfloat16 shapes but the
   decoder's timed beside SDPA and the bound.
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
   transposed dt, instant decay (A = -100, which must leave only the
   local term), the bfloat16 tiling's edges (L ragged against its
   64-step chunk, N = 4, 8, 16, 36, 100, P = 16 and 128, views only 8-
   or 2-byte aligned), and zamba2-1.2b's and mamba2-2.7b's prefill
   shapes (B=4, L=4096); a second launch must be bit-identical; at both
   prefill shapes the bfloat16 kernel, the plain version and the bound
   are timed.
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
9. ``moe_model`` — mixtral-8x22b at full width, 4 of its 56 layers (281
   GB of bfloat16 weights do not fit one card; 10.4e9 parameters do),
   random weights of seed 0 widened as in phase 5 (experts to one
   expert's fan-in), 4 prompts of 5000 tokens (numpy, seed 0: past the
   4096 window) and 16 new tokens.  In float32, then bfloat16:
   ``generate`` (timed, peak memory, every kernel count zeroed just
   before: K2 once a layer, nothing else) gives the tokens of the
   driven prefill + decode steps, whose logits agree with the same calls
   on the plain attention (``attn_impl="xla_flash"``, fed the served
   tokens) to ``LOGITS_TOL``, their greedy tokens equal in float32 — not
   with one full forward: capacity is per sequence, so a decode step
   drops other pairs than a longer forward; the share of (token, choice)
   pairs dropped per layer is printed.  bfloat16 must lie beyond the
   float32 tolerance from float32 at the first served position.
10. ``encdec_model`` — whisper-small at full depth (12 + 12 layers),
   frames (4, 1500, 128) and 4 prompts of 64 tokens: the same checks,
   plus prefill's last-position logits against ``logits_fn``'s (plain)
   there; K2 36 times a prefill (12 encoder, 12 causal self, 12 cross)
   and 12 a decode step (the cross-attention, one query a head): 216 a
   ``generate``.
11. ``vlm_model`` — internvl2-26b, patches (4, 1024, 3200) and 4 prompts
   of 2048 tokens: float32 at 12 of its 48 layers (79.6 GB of float32
   weights do not fit), bfloat16 at full depth (39.8 GB), each served
   position's logits against one plain full forward as in phase 5; K2
   48 times a ``generate``.
   Each of 9-11 prints ``prefill_s``, ``decode_ms_per_token``,
   ``peak_mem_gib``, the K2 launches and its wall time.
12. ``train`` — training on the card.  K2 at yi-6b's training attention
   (B=4, S=T=2048, H=32, KH=4, D=128, causal) and K3 at mamba2-2.7b's
   scan (B=4, L=2048, H=80, P=64, N=128, chunk 128), float32 and
   bfloat16, as custom ops (``torch.ops.repro_torch.flash_attention``,
   ``torch.ops.repro_torch.ssd``): the forward within ``ATTN_TOL`` /
   ``SSD_TOL`` of the plain version, one launch, none in the backward;
   every gradient bit for bit autograd's of the function the reference
   differentiates (``attention_xla_flash``, the chunked
   ``ssd_reference``) where that function's own rerun gives the same
   bits; forward + backward timed beside the plain forward + backward.
   Then yi-6b and mamba2-2.7b at full width, 4 of their 32 / 64 layers,
   ``remat="full"``, ``loss_chunk=2048``, float32 and bfloat16, from
   ``init_params(seed=0)``: step 0's loss and every gradient leaf
   against the plain path (``attn_impl="xla_flash"``; the chunked scan
   in place of K3) within ``TRAIN_GRAD_TOL`` of the leaf's max |g|, a
   rerun of step 0 with the same loss bits (the leaves whose gradient
   bits differ between reruns are listed), then 5 steps of
   ``make_train_step`` on ``SyntheticLM`` batches of 4 x 2048: losses
   finite, the kernel 8 times a step (forward and recompute of 4
   layers), nothing else launched; ``step_ms``, ``tokens_per_s``,
   ``peak_mem_gib`` (with ``--profile`` one more step's device time by
   class and idle share).  Last, on a small dense model:
   ``train_with_restarts`` failing at step 7 ends within 1e-5 of the
   uninterrupted run (bit-equality reported), and a bfloat16 checkpoint
   saved and restored is bit-equal.
13. ``dryrun`` — the dry run of ``src/repro_torch/launch/dryrun.py``.
   (a) One yi-6b training step (4 of 32 layers at full width, 4 x 2048,
   bfloat16, ``remat="full"``) on a 1x1 mesh, as rank 0 of a fake
   process group of one, counted by ``launch/op_cost.CostCounter``: for
   real on the card, then under ``FakeTensorMode``.  Op counts, FLOPs
   and HBM bytes must be equal, K2 called 8 times in both (forward and
   recompute of 4 layers) and launched 8 times in the real step;
   ``temp_peak_bytes`` prints beside ``torch.cuda.max_memory_allocated``.
   (b) ``run_cell`` for yi_6b x train_4k and mamba2_2p7b x prefill_32k on
   the 16x16 production mesh and mixtral_8x22b x decode_32k on the
   2x16x16 one, as rank 0 of a fake world of 256 / 512 on card 0: each
   ``ok``, its argument bytes equal to the spec arithmetic
   (``spec_bytes``) and below the card's memory, collectives in the train
   cell; each cell's seconds print.
14. ``elastic`` — sharded checkpoints and the elastic restore: yi-6b at
   full width, 2 of its 32 layers, float32, ``remat="full"``, 4 x 512
   ``SyntheticLM`` tokens a step, default ``OptConfig``, four ranks of
   torch's threaded process group on card 0.  ``train_with_restarts`` on
   a (2, 2) ``("data", "model")`` mesh saves at step 2 (shard by shard)
   and fails at step 3; its files must be byte-equal to an unsharded
   ``save`` of the same state gathered on the card.  The step-2
   checkpoint restored whole onto the card (no mesh) must equal that
   state bit for bit and takes steps 2 and 3; ``train`` resumes the job
   on a (4, 1) mesh (every restored shard bit-equal to its slice of the
   saved state, ``"[train] resumed from step 2"`` logged, K2 16 times a
   step: four ranks, forward and recompute of 2 layers), and the same 4
   steps run uninterrupted on (2, 2): both resumes' final loss within
   ``ELASTIC_TOL`` of it (bit-equality reported).  The checkpoint's
   bytes, write and read seconds and GB/s, step ms on each mesh and the
   wall time print.

With ``--profile`` more ``profile`` lines give the device time by
kernel and copy name (``torch.profiler``) with the device's idle share:
of one mapscore launch at the largest shape, one more cold request
(the fused path), one cold ``minighost-xk7_sparse-node-latency`` request,
of one bfloat16 prefill and one decode step of yi-6b, mamba2-2.7b,
mixtral-8x22b (4 layers) and whisper-small, and of one training step of
each model of phase ``train``.

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
# kernel outputs compared exactly with the plain version
EXACT_KEYS = ("total_hops", "status", "shift")


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
        check(int(got["status"]) == 0, f"{name}: status {int(got['status'])}")
        for key in got:
            check(torch.equal(got[key], again[key]),
                  f"{name}/{key}: second launch differs from the first")
            g, r = got[key].cpu().numpy(), want[key].cpu().numpy()
            if key in EXACT_KEYS:
                check(np.array_equal(g, r), f"{name}: {key} {g} != {r}")
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
                lambda: no_sync(ops.mapscore, cs, edges, w, inv_bw, **kw), 20)
            rec[f"plain_ms_{tag}"] = cuda_ms(
                lambda: ref.mapscore_ref(cs, edges, w, inv_bw, **kw), 5, 1)
            rec.update(bound(machine, cs, edges, w, inv_bw, traffic, tag))
    rec["max_abs_err"] = max_err
    return rec


def no_sync(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with torch's sync debug mode at "error":
    any operation that waits for the card raises."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def range_error_cases() -> dict:
    """An edge index equal to the task count and a coordinate equal to
    its dimension must each raise ValueError, through the tensor-level
    wrapper's status word and through ``evaluate_candidates_hopper``;
    a valid call right after must equal the one before bit for bit
    (the kernel's scratch is zero again)."""
    import torch
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import ops
    _, m, edges_np, w_np, stack_np = small_cases()[2]
    kw = dict(dims=m.dims, wrap=m.wrap, core_dims=m.core_dims, traffic=True)

    def run(edges_np, stack_np):
        cs, edges, w, inv_bw = scoring_inputs(m, edges_np, w_np, stack_np,
                                              True, "cuda")
        return ops.mapscore(cs, edges, w, inv_bw, **kw)

    before = run(edges_np, stack_np)
    bad_edges = edges_np.copy()
    bad_edges[5, 1] = stack_np.shape[1]
    bad_stack = stack_np.copy()
    bad_stack[1, edges_np[3, 0], 1] = m.dims[1]
    raised = {}
    for case, (e, st) in {"edge": (bad_edges, stack_np),
                          "coordinate": (edges_np, bad_stack)}.items():
        status = int(run(e, st)["status"])
        msgs = []
        for call in (lambda: ops.raise_for_status(status, m.dims),
                     lambda: ops.evaluate_candidates_hopper(
                         m, e, w_np, st, traffic=True, device="cuda")):
            try:
                call()
            except ValueError as exc:
                msgs.append(str(exc))
        check(len(msgs) == 2, f"a bad {case} did not raise ValueError")
        raised[case] = {"status": status, "message": msgs[0]}
    after = run(edges_np, stack_np)
    torch.cuda.synchronize()
    for key in before:
        check(torch.equal(before[key], after[key]),
              f"range errors: {key} differs after a faulty launch")
    return raised


def numpy_contraction(labels, edges, ew, tc, w, nclusters) -> dict:
    """The hierarchy's contraction as numpy computes it (the reference's
    ``aggregate_tasks`` body): the arrays the contract kernels must
    equal bit for bit."""
    import numpy as np
    n, d = tc.shape
    wv = np.ones(n) if w is None else w
    cw = np.bincount(labels, weights=wv, minlength=nclusters)
    denom = np.where(cw > 0, cw, 1.0)
    cents = np.stack([np.bincount(labels, weights=tc[:, j] * wv,
                                  minlength=nclusters) / denom
                      for j in range(d)], axis=1)
    ce = labels[edges]
    intra = ce[:, 0] == ce[:, 1]
    inter = ce[~intra]
    out = {"sizes": np.bincount(labels, minlength=nclusters),
           "weights": cw, "centroids": cents,
           "edges": np.zeros((0, 2), dtype=np.int64), "volumes": np.zeros(0),
           "intra_volume": float(ew[intra].sum())}
    if len(inter):
        key = inter[:, 0] * nclusters + inter[:, 1]
        uniq, inv = np.unique(key, return_inverse=True)
        out["edges"] = np.stack([uniq // nclusters, uniq % nclusters],
                                axis=1)
        out["volumes"] = np.bincount(inv, weights=ew[~intra],
                                     minlength=len(uniq))
    return out


def contract_inputs(case: str, rng):
    """(labels, edges, volumes, coords, task weights, nclusters) of a
    contract case: ``node`` the node cell's shape, a (64, 64, 32) stencil
    of 131,072 tasks and 770,048 unit messages in 4,096 boxes of 4 x 4 x
    2 tasks; ``level2`` a depth-3 hierarchy's second contraction, the
    node case's 4,096 boxes in 512 groups of 8 with the boxes' summed
    volumes; the rest small, with lognormal volumes (so that the order of
    the sums shows): lognormal task weights, one cluster, a cluster a
    task, repeated edges and self-loops in a shuffled edge list, 1 and 5
    coordinates."""
    import numpy as np
    from repro_torch.core.taskgraph import stencil_graph
    if case in ("node", "level2"):
        g = stencil_graph((64, 64, 32))
        tc = np.asarray(g.coords, np.float64)
        labels = ((tc[:, 0] // 4) * 256 + (tc[:, 1] // 4) * 16
                  + tc[:, 2] // 2).astype(np.int64)
        ew = np.asarray(g.weights, np.float64)
        if case == "node":
            return labels, g.edges, ew, tc, None, 4096
        c = numpy_contraction(labels, g.edges, ew, tc, None, 4096)
        return (np.arange(4096) // 8, c["edges"], c["volumes"],
                c["centroids"], c["weights"], 512)
    dims = {"d1": (700,), "d5": (4, 4, 4, 2, 4)}.get(case, (16, 8, 8))
    g = stencil_graph(dims)
    tc = np.asarray(g.coords, np.float64)
    n = len(tc)
    edges = g.edges
    if case == "duplicates":
        edges = np.concatenate([edges, edges[rng.integers(0, len(edges),
                                                          300)],
                                np.repeat(rng.integers(0, n, 40), 2)
                                .reshape(-1, 2)])
        edges = edges[rng.permutation(len(edges))]
    ew = rng.lognormal(size=len(edges))
    w = rng.lognormal(size=n) if case in ("weighted", "d5") else None
    nclusters = {"one-cluster": 1, "n-clusters": n}.get(case, 64)
    labels = rng.integers(0, nclusters, n)
    if case == "n-clusters":
        labels = rng.permutation(n)
    elif nclusters > 8:
        labels[labels == 7] = 8  # an empty cluster: centroid 0 / 1
    return labels, np.ascontiguousarray(edges), ew, tc, w, nclusters


CONTRACT_CASES = ("node", "level2", "weighted", "one-cluster", "n-clusters",
                  "duplicates", "d1", "d5")


def contract_cases() -> list:
    """The contract kernels against their plain version on CPU tensors
    and against numpy's body, bit for bit, on every case of
    :func:`contract_inputs` (seed 32), a rerun bit for bit, one wrapper
    launch a call; an endpoint or a label out of range raising
    ``ValueError`` with the card left usable; at the node cell's shape
    the wrapper and its two sorts by CUDA events, the plain version and
    numpy's body by the host clock, and the whole device contraction of
    ``aggregate_tasks`` (uploads, launches, the copy back and the intra
    sum) by the host clock, beside the byte bound; and ``aggregate_tasks``
    on the card, with its own labels, against numpy's body."""
    import numpy as np
    import torch
    from repro_torch.kernels.contract import ops, ref
    out = []
    for case in CONTRACT_CASES:
        rng = np.random.default_rng(32)
        labels, edges, ew, tc, w, nc = contract_inputs(case, rng)
        host = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (labels, edges, ew, tc)]
        host.append(None if w is None else torch.from_numpy(w))
        args = [None if a is None else a.cuda() for a in host]
        n0 = ops.launch_count
        got = ops.contract(*args, nclusters=nc).cpu()
        again = ops.contract(*args, nclusters=nc).cpu()
        check(ops.launch_count == n0 + 2, f"contract/{case}: not one "
              f"launch a call ({ops.launch_count - n0} for 2)")
        check(torch.equal(got.packed, again.packed),
              f"contract/{case}: a rerun differs")
        plain = ref.contract_ref(*host, nclusters=nc)
        check((got.npairs, got.nintra) == (plain.npairs, plain.nintra)
              and torch.equal(got.packed, plain.packed),
              f"contract/{case}: differs from the plain version")
        want = numpy_contraction(labels, edges, ew, tc, w, nc)
        for key in ("sizes", "weights", "centroids", "edges", "volumes"):
            a = getattr(got, key).numpy()
            check(a.dtype == want[key].dtype and a.shape == want[key].shape
                  and np.array_equal(a, want[key]),
                  f"contract/{case}: {key} differs from numpy's")
        intra = float(got.intra.numpy().sum())
        check(intra == want["intra_volume"],
              f"contract/{case}: intra volume {intra!r} vs numpy's "
              f"{want['intra_volume']!r}")
        n, d = tc.shape
        rec = {"case": case, "n": int(n), "d": int(d), "edges": len(edges),
               "clusters": int(nc), "pairs": got.npairs,
               "intra_edges": got.nintra, "weighted": w is not None}
        if case == "node":
            from repro_torch.core.taskgraph import TaskGraph
            from repro_torch.hier import aggregate_tasks

            def host_ms(fn, reps):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(times)

            def device_contraction():
                # aggregate_tasks' span: uploads, launches, copy back, sum
                up = [torch.from_numpy(a).cuda() for a in (labels, edges,
                                                           ew, tc)]
                c = ops.contract(*up, nclusters=nc).cpu()
                return float(c.intra.numpy().sum())

            def uploads():
                for a in (labels, edges, ew, tc):
                    torch.from_numpy(a).cuda()
                torch.cuda.synchronize()

            key = ref.pair_keys(args[0], args[1], nc)
            nbytes = len(edges) * 24 + n * (8 * d + 8)
            rec.update(
                ms=cuda_ms(lambda: ops.contract(*args, nclusters=nc), 20),
                sort_ms=cuda_ms(lambda: (torch.sort(key, stable=True),
                                         torch.sort(args[0], stable=True)),
                                20),
                plain_ms=host_ms(lambda: ref.contract_ref(
                    *host, nclusters=nc), 5),
                numpy_ms=host_ms(lambda: numpy_contraction(
                    labels, edges, ew, tc, w, nc), 5),
                device_contraction_ms=host_ms(device_contraction, 20),
                upload_ms=host_ms(uploads, 20),
                bytes=nbytes, bound_ms=nbytes / 3.35e12 * 1e3,
                bound_by="bytes")
            # aggregate_tasks on the card, its own labels: numpy's arrays
            whole = aggregate_tasks(TaskGraph(tc, edges, ew), nc,
                                    device="cuda")
            want = numpy_contraction(whole.labels, edges, ew, tc, None, nc)
            for key, got_a in (("sizes", whole.sizes),
                               ("weights", whole.weights),
                               ("centroids", whole.coarse.coords),
                               ("edges", whole.coarse.edges),
                               ("volumes", whole.coarse.weights)):
                check(np.array_equal(got_a, want[key]), "contract/node: "
                      f"aggregate_tasks' {key} differ from numpy's")
            check(whole.intra_volume == want["intra_volume"],
                  "contract/node: aggregate_tasks' intra volume differs")
        if case == "weighted":
            for what, bad in (("endpoint", [args[0], args[1] - 1]),
                              ("label", [args[0] + 1, args[1]])):
                try:
                    ops.contract(*bad, *args[2:], nclusters=nc)
                    raised = ""
                except ValueError as e:
                    raised = str(e)
                check(what in raised, f"contract/{case}: an {what} out of "
                      f"range gave {raised or 'an answer'}")
            check(torch.equal(ops.contract(*args, nclusters=nc).cpu().packed,
                              got.packed),
                  f"contract/{case}: differs after the refused calls")
        out.append(rec)
    return out


def bound(machine, cs, edges, w, inv_bw, traffic, tag) -> dict:
    """Least time the card could take for this call.  Bytes: every input
    read once (at its element size), every output written once, over the
    memory rate.
    Operations: the integer work these inputs need (hop arithmetic per
    message and network dim; direction, row key and four adds per
    (message, dim) pair that actually moves; one add and two compares per
    link-accumulator entry) over the fp32 non-tensor rate."""
    nb, ne = cs.shape[0], edges.shape[0]
    nd = machine.ndim - machine.core_dims
    nbytes = (cs.numel() * cs.element_size()
              + edges.numel() * edges.element_size()
              + w.numel() * w.element_size() + nb * (3 * 8 + 8) + 2 * 8)
    ops_n = nb * ne * (4 * nd + 2)
    if traffic:
        nbytes += inv_bw.numel() * inv_bw.element_size()
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


def full_size_problem(name, scale, rotations, weights_seed=None) -> dict:
    """The candidate stack the serve phase's request ``name`` scores,
    from the host engine (``partition_backend="numpy"``): the request,
    the pipeline, the candidates' results and numpy coordinate stack,
    the seconds the host sweep took, and per side the partitioner call
    with its host part numbers and seconds.  ``weights_seed``: the
    request carries task weights, uniform in [0.5, 2) from that seed."""
    import numpy as np
    from repro_torch.core.orderings import order_points_batched
    from repro_torch.mapping import rotation_candidates, shared_pipeline
    from repro_torch.serve import get_scenario
    from repro_torch.serve.engine import MappingRequest
    req = get_scenario(name, scale=scale, rotations=rotations,
                       partition_backend="numpy").request()
    weights = None
    if weights_seed is not None:
        weights = np.random.default_rng(weights_seed).uniform(
            0.5, 2.0, size=req.graph.n)
        req = MappingRequest(req.graph, req.alloc, req.config,
                             task_weights=weights)
    pipe = shared_pipeline(req.config)
    pc = pipe.machine_coords(req.alloc)
    tc = np.asarray(req.graph.coords, dtype=np.float64)
    cands = rotation_candidates(tc.shape[1], pc.shape[1],
                                req.config.rotations)
    plan = pipe.sweep_plan(tc, pc, cands, weights)
    sides = {"task": plan.task, "proc": plan.proc}
    host = {}
    for side, kw in sides.items():
        t0 = time.perf_counter()
        mu = order_points_batched(**kw, backend="vectorized")
        host[side] = (mu, time.perf_counter() - t0)
    t0 = time.perf_counter()
    results = pipe.map_candidates(tc, pc, cands, task_weights=weights)
    part_s = time.perf_counter() - t0
    stack = np.stack([req.alloc.coords[r.task_to_proc] for r in results])
    return {"req": req, "pipe": pipe, "results": results, "stack": stack,
            "part_s": part_s, "sides": sides, "host": host}


# ---------------------------------------------------------------------------
# phase 3: the device partitioner vs the host engine
# ---------------------------------------------------------------------------

FP64_OPS_PER_S = 34e12      # H100 SXM data sheet, float64 outside the
                            # tensor cores (the guide's table has no fp64)


def partition_case(name, kw, host=None) -> dict:
    """The device engine on the card against the host engine on one
    partitioner call: bit for bit, a rerun bit for bit, and the whole
    sweep after the upload under ``set_sync_debug_mode("error")``.
    ``host``: the host engine's (part numbers, seconds) if already run."""
    import torch
    from repro_torch.core.orderings import order_points_batched
    from repro_torch.core.partition_torch import finish_level, run, upload
    from repro_torch.kernels.mjfinish import ops as mj_ops
    from repro_torch.kernels.segscan import ops as seg_ops
    if host is None:
        t0 = time.perf_counter()
        host = (order_points_batched(**kw, backend="vectorized"),
                time.perf_counter() - t0)
    want, host_s = host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inp = upload(**kw, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n0, m0 = seg_ops.launch_count, mj_ops.launch_count
    t0 = time.perf_counter()
    got = no_sync(run, inp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = seg_ops.launch_count - n0
    finish_from = finish_level(inp, inp.levels)
    check(mj_ops.launch_count - m0 == int(finish_from >= 0),
          f"{name}: {mj_ops.launch_count - m0} mjfinish launches, finish "
          f"level {finish_from}")
    again = no_sync(run, inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_h = got.cpu().numpy()
    copy_s = time.perf_counter() - t0
    nb, n = inp.shape
    rec = {"case": name, "sfc": kw["sfc"], "n": n, "candidates": nb,
           "dims": int(inp.cols.shape[0]), "nparts": int(kw["nparts"]),
           "weighted": kw.get("weights") is not None,
           "uneven_prime": bool(kw.get("uneven_prime")),
           "levels": inp.levels if kw["sfc"] != "H" else 0,
           "host_s": host_s, "upload_s": upload_s, "first_s": first_s,
           "copy_s": copy_s, "segscan_launches": launches,
           "finish_from": finish_from}
    check(torch.equal(got, again), f"{name}: a rerun differs")
    ndiff = int((got_h != want).sum())
    check(got_h.shape == want.shape and ndiff == 0,
          f"{name}: {ndiff} part numbers differ from the host engine")
    rec["device_ms"] = cuda_ms(lambda: run(inp), 5, 1)
    return rec


def signed_zero_cloud():
    """A small cloud of integer coordinates in [-2, 2] where half of the
    zeros are -0.0: under FZ and Gray flips the sort keys mix -0.0 and
    0.0, which a radix sort on the card orders unless the engine adds
    0.0 (the CPU's comparison sort ties them whatever the key)."""
    import numpy as np
    rng = np.random.default_rng(7)
    pts = rng.integers(-2, 3, size=(4096, 3)).astype(np.float64)
    flip = rng.random(pts.shape) < 0.5
    pts[flip] = -pts[flip]
    zeros = pts[pts == 0]
    check(np.signbit(zeros).any() and (~np.signbit(zeros)).any(),
          "the signed-zero cloud lacks -0.0 or 0.0")
    return pts


def segscan_bound(n: int, segments: int, longest: int) -> dict:
    """Least time of one call: w and seg_start read once, seg_size read
    at each segment's first position and the sums written once (24 bytes
    a position and 8 a segment) over the memory rate, or one float64 add
    per position after each segment's first over the float64 rate.
    Beside it, not folded in: ``chain_adds``, the dependent adds of the
    longest segment, which no order-preserving scheme runs in parallel."""
    nbytes = 24 * n + 8 * segments
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n - segments) / FP64_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": n - segments,
            "chain_adds": longest - 1}


def segscan_cases(nb: int, n: int) -> list:
    """The kernel against its plain version, exactly, at the weighted
    sweep's shape (``nb`` candidates of ``n`` points): the first level's
    segments (one a candidate; timed, with ``torch.cumsum`` over the
    rows, the one call computing the same sums in another order) and a
    deeper level's (random lengths 1..200).  Weights spread over twelve
    decades, so any other order of the adds changes last bits."""
    import numpy as np
    import torch
    from repro_torch.kernels.segscan import ops, ref
    rng = np.random.default_rng(0)
    N = nb * n
    w = torch.from_numpy(rng.random(N) * 10.0 ** rng.uniform(-6, 6, N)
                         ).to("cuda")
    pos = np.arange(N, dtype=np.int64)
    lens = rng.integers(1, 201, size=N // 100 + 1)
    ends = np.minimum(np.cumsum(lens), N)
    starts = np.concatenate([[0], ends[:-1]])
    keep = starts < N
    starts, ends = starts[keep], ends[keep]
    ends[-1] = N
    mixed = (np.repeat(starts, ends - starts), np.repeat(ends - starts,
                                                          ends - starts))
    layouts = {"first-level": ((pos // n) * n, np.full(N, n)),
               "random-1..200": mixed}
    out = []
    for name, (st, sz) in layouts.items():
        st = torch.from_numpy(np.ascontiguousarray(st, dtype=np.int64)
                              ).to("cuda")
        sz = torch.from_numpy(np.ascontiguousarray(sz, dtype=np.int64)
                              ).to("cuda")
        n0 = ops.launch_count
        got = no_sync(ops.segscan, w, st, sz)
        again = no_sync(ops.segscan, w, st, sz)
        torch.cuda.synchronize()
        check(ops.launch_count == n0 + 2, f"segscan/{name}: no launch")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = ref.segscan_ref(w, st, sz)
        t1.record()
        t1.synchronize()
        segments = int((st == torch.arange(N, device="cuda")).sum())
        rec = {"case": name, "n": N, "segments": segments,
               "max_abs_err": float((got - want).abs().max()),
               "plain_ms": t0.elapsed_time(t1)}
        check(torch.equal(got, again), f"segscan/{name}: a rerun differs")
        check(torch.equal(got, want),
              f"segscan/{name}: kernel differs from its plain version")
        if name == "first-level":
            rows = w.view(nb, n)
            rec["cumsum_differs"] = int(
                (torch.cumsum(rows, 1).reshape(-1) != got).sum())
            rec["ms"] = cuda_ms(lambda: ops.segscan(w, st, sz), 10)
            rec["library_ms"] = cuda_ms(lambda: torch.cumsum(rows, 1), 10)
            rec["library"] = "torch.cumsum over the (nb, n) rows"
            rec.update(segscan_bound(N, segments, int(sz.max())))
            rec["ns_per_chain_add"] = rec["ms"] * 1e6 / rec["chain_adds"]
        out.append(rec)
        del st, sz, got, again, want
    return out


def mjfinish_clouds() -> list:
    """The main path's mjfinish shapes, from seed 27: (name, coords,
    nparts, dim orders).  Both sides of a cold minighost sweep (a
    (64, 64, 32) task grid; 4,096 routers of a (25, 16, 24) torus, 32
    cores each), a homme-sized sphere (86,400 points), the node cell's
    4,096 routers, and its coarsening of the grid into 4,096 clusters;
    six dimension orders a side, one for the coarsening."""
    import itertools
    import numpy as np
    rng = np.random.default_rng(27)
    perms = np.array(list(itertools.permutations(range(3))))
    grid = np.stack([c.ravel() for c in np.indices((64, 64, 32))],
                    axis=1).astype(np.float64)
    torus = np.stack([c.ravel() for c in np.indices((25, 16, 24))], axis=1)
    routers = torus[np.sort(rng.choice(len(torus), 4096, replace=False))
                    ].astype(np.float64)
    sphere = rng.normal(size=(86400, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    return [("minighost-tasks", grid, 131072, perms),
            ("minighost-cores", np.repeat(routers, 32, axis=0), 131072,
             perms),
            ("homme-sphere", sphere, 86400, perms),
            ("node-routers", routers, 4096, perms),
            ("node-coarsening", grid, 4096, perms[:1])]


def mjfinish_bound(N: int, d: int, segments: int, nb: int) -> dict:
    """Least time of one launch: the state at the handoff read once (pts
    and d coordinate rows by position; mu, seg_start, seg_size and
    seg_np at each segment's first position; the heads and the priority
    rows) and the part numbers written once, over the memory rate."""
    nbytes = 8 * N * (d + 2) + 32 * segments + 8 * (segments // nb + nb * d)
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": nbytes}


def mjfinish_case(name, coords, nparts, dos, sfc="FZ",
                  longest_dim=True) -> dict:
    """mjfinish from the loop's state at the handoff level against its
    plain version on the card and against the host engine, bit for bit;
    a rerun bit for bit, one launch a call, no host sync; timed with CUDA
    events beside its byte bound."""
    import torch
    from repro_torch.core import partition_torch as PT
    from repro_torch.core.orderings import order_points_batched
    from repro_torch.kernels.mjfinish import ops, ref
    kw = dict(coords=coords, nparts=nparts, sfc=sfc, dim_orders=dos,
              longest_dim=longest_dim)
    inp = PT.upload(**kw, device="cuda")
    nb, n = inp.shape
    l0, heads, cap = PT._finish_plan(inp, inp.levels)
    check(l0 >= 0, f"mjfinish/{name}: no handoff level")
    st = PT.mj_levels(PT.initial_state(inp), inp.sdo, inp.tab, sfc=sfc,
                      longest_dim=inp.longest_dim, lo=0, hi=l0)
    args = (*st, inp.sdo, inp.tab, heads)
    fkw = dict(level=l0, levels=inp.levels, cap=cap, sfc=sfc,
               longest_dim=inp.longest_dim)
    torch.cuda.synchronize()
    n0 = ops.launch_count
    got = no_sync(ops.mjfinish, *args, **fkw)
    again = no_sync(ops.mjfinish, *args, **fkw)
    torch.cuda.synchronize()
    check(ops.launch_count == n0 + 2, f"mjfinish/{name}: not one launch a "
                                      f"call")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = ref.mjfinish_ref(*st, inp.sdo, inp.tab, level=l0,
                            levels=inp.levels, sfc=sfc,
                            longest_dim=inp.longest_dim)
    t1.record()
    t1.synchronize()
    t = time.perf_counter()
    host = order_points_batched(**kw, backend="vectorized")
    host_s = time.perf_counter() - t
    check(torch.equal(got, again), f"mjfinish/{name}: a rerun differs")
    ndiff = int((got != want).sum())
    check(ndiff == 0, f"mjfinish/{name}: {ndiff} part numbers differ from "
                      f"the plain version")
    ndiff = int((got.cpu().numpy() != host).sum())
    check(ndiff == 0, f"mjfinish/{name}: {ndiff} part numbers differ from "
                      f"the host engine")
    rec = {"case": name, "sfc": sfc, "longest_dim": inp.longest_dim,
           "n": n, "candidates": nb, "nparts": nparts, "levels": inp.levels,
           "finish_from": l0, "segments": int(heads.numel()) * nb,
           "cap": cap, "plain_ms": t0.elapsed_time(t1), "host_s": host_s,
           "ms": cuda_ms(lambda: ops.mjfinish(*args, **fkw), 10),
           "sweep_ms": cuda_ms(lambda: PT.run(inp), 5, 1)}
    rec.update(mjfinish_bound(nb * n, int(inp.cols.shape[0]),
                              rec["segments"], nb))
    return rec


# a child process's mjfinish call from a plan that disagrees with the
# state: a 16,384-point sweep hands off at level 2 (4 segments of 4,096)
MJFINISH_MISMATCH = """
import os
import sys
import numpy as np
import torch
sys.path.insert(0, "src")
from repro_torch.core import partition_torch as PT
from repro_torch.kernels.mjfinish import mjfinish
inp = PT.upload(np.random.default_rng(0).normal(size=(16384, 3)), 16384,
                "FZ", dim_orders=[[0, 1, 2]], device="cuda")
l0, heads, cap = PT._finish_plan(inp, inp.levels)
assert l0 == 2 and heads.numel() == 4, (l0, heads)
st = PT.mj_levels(PT.initial_state(inp), inp.sdo, inp.tab, sfc="FZ",
                  longest_dim=True, lo=0, hi=l0)
heads = {"skip": heads[:-1], "shift": heads + (heads > 0)}[sys.argv[1]]
try:
    out = mjfinish(*st, inp.sdo, inp.tab, heads, level=l0,
                   levels=inp.levels, cap=cap, sfc="FZ", longest_dim=True)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
else:
    print("answered")
sys.stdout.flush()
os._exit(0)   # a lost context may fail torch's own teardown
"""


def mjfinish_mismatch_cases() -> dict:
    """A plan that disagrees with the state fails loudly: heads that skip
    the last segment, or put every head but the first one position late,
    make the next synchronising call raise.  Each in a child process,
    since the trap loses the CUDA context."""
    out = {}
    for case in ("skip", "shift"):
        r = subprocess.run([sys.executable, "-c", MJFINISH_MISMATCH, case],
                           capture_output=True, text=True, timeout=300,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        said = (r.stdout.strip().splitlines() or [""])[-1]
        check(r.returncode == 0 and said.startswith("raised:"),
              f"mjfinish/{case}: exit {r.returncode}, {said!r}, "
              f"{r.stderr[-2000:]}")
        out[case] = said
    return out


def mjfinish_cases() -> list:
    """:func:`mjfinish_case` at the main path's shapes under FZ, and the
    routers under Gray, FZlow and strict alternation."""
    out = []
    for name, coords, nparts, dos in mjfinish_clouds():
        out.append(mjfinish_case(name, coords, nparts, dos))
        if name == "node-routers":
            for sfc, longest in (("Gray", True), ("FZlow", True),
                                 ("FZ", False)):
                out.append(mjfinish_case(name, coords, nparts, dos, sfc,
                                         longest))
    return out


def partition_phase(problems, weighted, scale) -> dict:
    """Every partitioner call of the four served scenarios, both sides,
    plus a weighted sweep (segscan), a Hilbert one, an uneven-prime one
    and the signed-zero cloud under FZ and Gray, on the card against the
    host engine; then segscan against its plain version, and mjfinish
    against its plain version and the host engine."""
    import numpy as np
    from repro_torch.kernels.segscan import ops as seg_ops
    cases = []
    seg_ops.launch_count = 0
    for name, prob in problems.items():
        for side, kw in prob["sides"].items():
            cases.append(partition_case(f"{name}@{scale}/{side}", kw,
                                        prob["host"][side]))
    check(seg_ops.launch_count == 0, "an unweighted sweep launched segscan")
    wkw = weighted["sides"]["task"]
    cases.append(partition_case(f"weighted@{scale}/task", wkw,
                                weighted["host"]["task"]))
    got = cases[-1]["segscan_launches"]
    check(got == cases[-1]["levels"] > 0,
          f"the weighted sweep launched segscan {got} times, expected one "
          f"a level ({cases[-1]['levels']})")
    tkw = next(iter(problems.values()))["sides"]["task"]
    cases.append(partition_case(f"hilbert@{scale}/task",
                                {**tkw, "sfc": "H"}))
    cases.append(partition_case(f"uneven-prime-10800@{scale}/task",
                                {**tkw, "nparts": 10800,
                                 "uneven_prime": True}))
    pts = signed_zero_cloud()
    perms = np.array([[0, 1, 2], [2, 0, 1], [1, 2, 0]])
    for sfc in ("FZ", "Gray"):
        for weights in (None, np.linspace(0.5, 2.0, len(pts))):
            cases.append(partition_case(
                f"signed-zeros/{sfc}" + ("/weighted" if weights is not None
                                         else ""),
                dict(coords=pts, nparts=64, sfc=sfc, dim_orders=perms,
                     weights=weights, longest_dim=True,
                     uneven_prime=False)))
    seg = segscan_cases(len(wkw["dim_orders"]), len(wkw["coords"]))
    return {"cases": cases, "segscan": seg, "mjfinish": mjfinish_cases(),
            "mjfinish_mismatch": mjfinish_mismatch_cases()}


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
    ("zamba2-1.2b-prefill", 4, 256, 32, 32, 64, "bfloat16", 0, 0.0),
    # one rank's shard of phase elastic's yi-6b step (4 x 512 tokens):
    # the batch split over data, the heads over model
    ("yi-6b-elastic-2x2-shard", 2, 512, 16, 2, 128, "float32", 0, 0.0),
    ("yi-6b-elastic-4x1-shard", 1, 512, 32, 4, 128, "float32", 0, 0.0),
]
ATTN_TIMED = ("yi-6b-prefill", "bfloat16")   # the kernels line's shape
# every timed shape: yi-6b's prefill, gemma2-27b's local layer (the
# window's tile skip) and zamba2-1.2b's shared block (D = 64, MHA)
ATTN_TIMED_CASES = (ATTN_TIMED, ("gemma2-27b-local", "bfloat16"),
                    ("zamba2-1.2b-prefill", "bfloat16"))


# the shapes the moe, encdec and vlm families give the kernel: (name, B,
# S, T, H, KH, D, dtype, window, causal); no cap.  whisper-small's
# encoder and cross-attention are non-causal over T = 1500 keys (a ragged
# last key tile), its decode step's cross-attention one query a head;
# mixtral-8x22b's window cuts a 5000-position prefill, GQA 6:1
ATTN_FAMILY_CASES = [
    ("whisper-small-encoder", 4, 1500, 1500, 12, 12, 64, "float32", 0,
     False),
    ("whisper-small-encoder", 4, 1500, 1500, 12, 12, 64, "bfloat16", 0,
     False),
    ("whisper-small-decoder", 4, 64, 64, 12, 12, 64, "bfloat16", 0, True),
    ("whisper-small-cross", 4, 64, 1500, 12, 12, 64, "float32", 0, False),
    ("whisper-small-cross", 4, 64, 1500, 12, 12, 64, "bfloat16", 0, False),
    ("whisper-small-cross-decode", 4, 1, 1500, 12, 12, 64, "float32", 0,
     False),
    ("whisper-small-cross-decode", 4, 1, 1500, 12, 12, 64, "bfloat16", 0,
     False),
    ("mixtral-8x22b-prefill", 4, 5000, 5000, 48, 8, 128, "bfloat16", 4096,
     True),
    ("internvl2-26b-prefill", 4, 2048, 2048, 48, 8, 128, "bfloat16", 0,
     True),
]
ATTN_FAMILY_TIMED = tuple(
    (c[0], "bfloat16") for c in ATTN_FAMILY_CASES
    if c[7] == "bfloat16" and c[0] != "whisper-small-decoder")
# the plain version's float32 score tensor above this many bytes is
# computed a batch row at a time (mixtral's is 19.2 GB)
PLAIN_SCORE_BYTES = 2 ** 33


def attention_bound(b, s, h, kh, d, dtype, window, t=None,
                    causal=True) -> dict:
    """Least time for one call: the kernel's work (``kernel.work``: every
    input read and the output written once, 4*D flops per live score
    entry) over the memory rate or the peak rate of the type (bf16
    tensor cores; float32 must stay float32, so the CUDA cores' rate)."""
    from repro_torch.kernels.flash_attention import kernel
    flops, nbytes = kernel.work(b, s, h, kh, d,
                                2 if dtype == "bfloat16" else 4, window, t,
                                causal)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def attention_inputs(b, s, h, kh, d, dtype, seed, t=None):
    """q (b, s, h, d), k and v (b, t, kh, d) (t defaults to s), standard
    normal on the card."""
    import torch
    t = s if t is None else t
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(tdt)
                 for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))


def library_attention(q, k, v, window: int, causal: bool = True):
    """One ``scaled_dot_product_attention`` call on the kernel's inputs
    (causal or not; with a window, an explicit boolean mask of the causal
    window, which takes SDPA off its flash path).  It applies no
    soft-cap: no PyTorch call does."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def attention_case(name, b, s, h, kh, d, dtype, window, cap, seed, *,
                   t=None, causal=True, timed=None):
    """The kernel against its plain version on one shape, a rerun
    bit-identical; timed beside the plain version, SDPA and the bound
    when ``(name, dtype)`` is in ``timed`` (default
    ``ATTN_TIMED_CASES``)."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    t = s if t is None else t
    q, k, v = attention_inputs(b, s, h, kh, d, dtype, seed, t)
    kw = dict(causal=causal, window=window, cap=cap)
    rows = (1 if b * h * s * t * 4 > PLAIN_SCORE_BYTES else b)

    def plain():
        return torch.cat([
            ref.attention_ref(q[i:i + rows].transpose(1, 2),
                              k[i:i + rows].transpose(1, 2),
                              v[i:i + rows].transpose(1, 2),
                              **kw).transpose(1, 2)
            for i in range(0, b, rows)])

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
    if t != s or not causal:
        rec.update(t=t, causal=causal)
    check(torch.equal(got, again), f"{name}/{dtype}: second launch differs")
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"{name}/{dtype}: kernel vs plain max abs err {err}")
    if (name, dtype) in (ATTN_TIMED_CASES if timed is None else timed):
        rec["ms"] = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
        rec["plain_ms"] = cuda_ms(plain, 3, 1)
        rec["library_ms"] = cuda_ms(library_attention(q, k, v, window,
                                                      causal), 10)
        rec["library"] = ("scaled_dot_product_attention, "
                          + ("boolean window mask, no cap" if window
                             else "is_causal" if causal else "no mask"))
        rec.update(attention_bound(b, s, h, kh, d, dtype, window, t,
                                   causal))
    del q, k, v, got, again, want
    torch.cuda.empty_cache()
    return rec


def family_attention_cases() -> list:
    """``ATTN_FAMILY_CASES`` through ``attention_case``; the bf16 model
    shapes timed."""
    return [attention_case(name, b, s, h, kh, d, dtype, window, 0.0,
                           seed=100 + i, t=t, causal=causal,
                           timed=ATTN_FAMILY_TIMED)
            for i, (name, b, s, t, h, kh, d, dtype, window, causal)
            in enumerate(ATTN_FAMILY_CASES)]


# ---------------------------------------------------------------------------
# phase 5: the model path — yi-6b served at full width
# ---------------------------------------------------------------------------

def model_params(cfg) -> dict:
    """Random weights of seed 0 (``draw_leaves``: float32 normal draws,
    leaf by leaf, in ``init_params``' order), every stacked block matrix
    widened by the square root of its ``layers`` and ``experts`` axes to
    one layer's (one expert's) fan-in, then rounded leaf by leaf to
    ``cfg``'s dtypes before the next is drawn — so the bfloat16 model is
    the rounding of the float32 one, and at most one leaf is ever held
    in float32.  The reference's init counts the layer axis in the
    fan-in; its random yi-6b's blocks barely move the residual stream,
    and the logits compared below would hardly see attention."""
    import math
    from repro_torch.models.params import DTYPES, draw_leaves
    params: dict = {}
    for path, p, val in draw_leaves(cfg, seed=0, device="cuda"):
        if p.init == "normal" and not p.scale:
            for axis in ("layers", "experts"):
                if axis in p.axes:
                    val.mul_(math.sqrt(p.shape[p.axes.index(axis)]))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val.to(DTYPES[p.dtype or cfg.dtype])
        del val
    return params


def model_inputs(prompts, extras=None) -> dict:
    """The prefill's batch on the card: the prompts and the family's
    frontend inputs (numpy)."""
    import torch
    return {"tokens": torch.as_tensor(prompts, device="cuda"),
            **{k: torch.as_tensor(v, device="cuda")
               for k, v in (extras or {}).items()}}


def drive(cfg, params, prompts, max_seq: int, extras=None, forced=None):
    """prefill + greedy decode steps, as ``ServeEngine.generate`` runs
    them, keeping every served position's logits; with ``forced``
    (B, NEW) each step is fed those tokens instead of its own choice.
    Returns (logits (B, NEW, V) float32 numpy, greedy tokens (B, NEW)
    int32, prefill s, decode s)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, prefill
    batch = model_inputs(prompts, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cache = prefill(cfg, params, batch, max_seq=max_seq)
        logits = [lg[:, -1].float().cpu()]
        t1 = time.perf_counter()
        out = [lg[:, -1].argmax(-1)]
        feed = (out if forced is None else
                list(torch.as_tensor(forced, dtype=torch.int64,
                                     device="cuda").T))
        for i in range(NEW_TOKENS - 1):
            lg, cache = decode_step(cfg, params, cache, feed[i][:, None],
                                    prompts.shape[1] + i)
            logits.append(lg[:, 0].float().cpu())
            out.append(lg[:, 0].argmax(-1))
        toks = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    t2 = time.perf_counter()
    return torch.stack(logits, 1).numpy(), toks, t1 - t0, t2 - t1


def full_forward_logits(cfg, params, prompts, served, extras=None):
    """The plain path's logits at the served positions, from one forward
    pass over prompt + served tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import logits_fn
    batch = model_inputs(np.concatenate([prompts, served[:, :-1]], axis=1),
                         extras)
    plain = dataclasses.replace(cfg, attn_impl="xla_flash")
    with torch.inference_mode():
        lg = logits_fn(plain, params, batch)
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

# (name, B, L, H, P, N, chunk, A or None (drawn), x/B/C cut from one
# tensor: False, True, or "odd" one element off its start)
SSD_CASES = [
    ("l-below-chunk", 1, 48, 2, 16, 16, 128, None, False),
    ("l-at-chunk", 2, 128, 2, 32, 32, 128, None, False),
    ("three-chunks", 2, 384, 4, 64, 64, 128, None, False),
    ("one-head", 1, 256, 1, 64, 128, 128, None, False),
    ("conv-out-views", 2, 256, 4, 64, 128, 128, None, True),
    ("decay-100", 1, 64, 2, 16, 16, 32, -100.0, False),
    # the bfloat16 tiling's edges: L ragged against its 64-step chunk, N
    # zero-padded to 16 (4, 36, 100), P = 16 and 128 (one and four
    # 32-column slices), B and C views only 8-byte aligned, and views
    # only 2-byte aligned
    ("p16-n4-ragged", 1, 96, 2, 16, 4, 32, None, False),
    ("n16-ragged", 2, 160, 3, 32, 16, 32, None, False),
    ("p128-n100", 1, 200, 2, 128, 100, 8, None, False),
    ("n36-views", 2, 96, 4, 64, 36, 32, None, True),
    ("odd-views", 1, 80, 2, 32, 8, 16, None, "odd"),
    ("zamba2-1.2b-prefill", 4, 4096, 64, 64, 64, 128, None, False),
    ("mamba2-2.7b-prefill", 4, 4096, 80, 64, 128, 128, None, False),
]
# timed cases; the first is the kernels line's
SSD_TIMED = (("mamba2-2.7b-prefill", "bfloat16"),
             ("zamba2-1.2b-prefill", "bfloat16"))


def ssd_inputs(b, l, h, p, n, dtype, a_value, views, seed):
    """x, dt, A, B, C on the card as ``tests/test_kernels.py`` draws them
    (dt = softplus(normal) float32, A = -exp(0.5 normal), or ``a_value``
    with dt moved up by 0.5); with ``views``
    x, B and C are column slices of one (B, L, H*P + 2N) tensor and dt a
    transposed view, the layout ``mamba_block`` hands the kernel; with
    ``views == "odd"`` the tensor has one more column, before the slices,
    so that every base address and row stride is odd in elements."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if views:
        off = int(views == "odd")
        conv = randn(b, l, off + h * p + 2 * n).to(tdt)[..., off:]
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
    """Least time for one call: the kernel's work (``kernel.work``: its
    inputs read and y written once, the chunked form's operations at the
    reference's chunk) over the memory rate or the peak rate of the type
    (bf16 tensor cores; float32 must stay float32, so the CUDA cores'
    rate)."""
    from repro_torch.kernels.ssd import kernel
    flops, nbytes = kernel.work(b, l, h, p, n, 2 if dtype == "bfloat16"
                                else 4)
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
    if a_value is not None:
        # instant decay leaves the local term y_t = (C_t . B_t) dt_t x_t
        local = torch.einsum("bln,bln->bl", C.float(), B.float())[
            ..., None, None] * (x.float() * dt[..., None])
        tol = (dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else
               dict(atol=a_frac * float(local.abs().max()), rtol=rtol))
        check(torch.allclose(g, local, **tol),
              f"{name}/{dtype}: history did not vanish")
    if (name, dtype) in SSD_TIMED:
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
        from repro_torch.kernels.ssd import kernel as ssd_kernel
        qt = ssd_kernel.CHUNK[getattr(torch, dtype)]   # the kernel's chunk
        counted_prefill(cfg, params, long[:, :qt])           # warm-up
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
# phases 9-11: the moe, encdec and vlm families at full width
# ---------------------------------------------------------------------------

MOE_MODEL, ENCDEC_MODEL, VLM_MODEL = ("mixtral-8x22b", "whisper-small",
                                      "internvl2-26b")
# depth cuts: mixtral-8x22b's 56 layers are 281 GB of bfloat16 weights, 4
# are 10.4e9 parameters (20.8 GB; 41.6 GB in float32); internvl2-26b's 48
# layers are 39.8 GB in bfloat16 and 79.6 GB in float32, so its float32
# check runs 12
MOE_LAYERS, VLM_F32_LAYERS = 4, 12
# mixtral's prompts outrun its 4096-position window
FAMILY_PROMPT_LEN = {MOE_MODEL: 5000, ENCDEC_MODEL: 64, VLM_MODEL: 2048}


def family_inputs(cfg, prompt_len: int):
    """``PROMPTS`` prompts (numpy, seed 0) and, drawn after them from the
    same generator, the family's frontend inputs: ``frames`` (encdec) or
    ``patches`` (vlm), standard normal float32."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(PROMPTS, prompt_len))
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (PROMPTS, cfg.encoder_seq, cfg.frontend_dim), dtype=np.float32)
    elif cfg.family == "vlm":
        extras["patches"] = rng.standard_normal(
            (PROMPTS, cfg.num_patches, cfg.frontend_dim), dtype=np.float32)
    return prompts, extras


def k2_launches_per_generate(cfg) -> int:
    """K2 launches of one ``generate`` of ``NEW_TOKENS``: one per
    attention site of the prefill; for encdec (12 encoder, 12 causal
    self, 12 cross) plus one per layer a decode step, its
    cross-attention (the self-attention over the cache is the plain
    ``attention_decode``)."""
    if cfg.family == "encdec":
        return (cfg.encoder_layers + 2 * cfg.num_layers
                + (NEW_TOKENS - 1) * cfg.num_layers)
    return cfg.num_layers


def moe_drop_shares(cfg, params, prompts) -> list:
    """The share of (token, choice) pairs capacity drops in each layer
    of one prefill of ``prompts``: ``layers.moe_block`` wrapped for that
    call to read ``moe_dispatch``'s keep mask (a measurement pass of its
    own, outside every counted run)."""
    import torch
    from repro_torch.models import layers, prefill
    inner, shares = layers.moe_block, []

    def counted(cfg_, p, x):
        keep = layers.moe_dispatch(cfg_, p["router"], x)[3]
        shares.append(1.0 - float(keep.float().mean()))
        return inner(cfg_, p, x)

    layers.moe_block = counted
    try:
        with torch.inference_mode():
            prefill(cfg, params, model_inputs(prompts))
    finally:
        layers.moe_block = inner
    return shares


def family_model(name: str, dtype: str, *, layers: int = 0,
                 reference: str, profile: bool = False) -> tuple:
    """One of the moe / encdec / vlm families at its published width in
    ``dtype`` (``layers`` cuts the depth): random weights of seed 0
    widened as in phase 5, ``family_inputs``, ``NEW_TOKENS`` new tokens.
    ``ServeEngine.generate``, timed, with every kernel count set to 0
    just before and read just after, gives the tokens of prefill + decode
    steps driven as it drives them; the driven logits are then held to
    ``reference`` within ``LOGITS_TOL``:

    * ``"plain_drive"`` — the same prefill / decode calls with
      ``attn_impl="xla_flash"``, tokens equal too in float32 (moe:
      capacity is per sequence, so a decode step is not one row of a
      longer forward; encdec: the decode steps attend over the unfilled
      self-attention cache prefill leaves, as in the reference);
    * ``"full_forward"`` — one plain full forward over prompt + served
      tokens (phase 5's check).

    encdec also holds prefill's last-position logits against
    ``logits_fn``'s (plain) at that position: the same function.
    Returns (record, driven logits)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, logits_fn, params_spec
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    base = get_config(name)
    cfg = dataclasses.replace(base, dtype=dtype,
                              num_layers=layers or base.num_layers)
    check(cfg.attn_impl == "hopper", f"{name}: not served through K2")
    plen = FAMILY_PROMPT_LEN[name]
    prompts, extras = family_inputs(cfg, plen)
    max_seq = plen + NEW_TOKENS
    tol = LOGITS_TOL[dtype]
    plain = dataclasses.replace(cfg, attn_impl="xla_flash")
    params = model_params(cfg)
    rec = {"model": name, "dtype": dtype,
           "params": count_params(params_spec(cfg)),
           "layers": cfg.num_layers, "published_layers": base.num_layers,
           "d_model": cfg.d_model, "prompts": PROMPTS, "prompt_len": plen,
           "new_tokens": NEW_TOKENS, "max_seq": max_seq, "seed": 0,
           "extras": {k: list(v.shape) for k, v in extras.items()},
           "logits_tol": tol, "reference": reference}
    if cfg.family == "encdec":
        rec["encoder_layers"] = cfg.encoder_layers

    logits, toks, pre_s, dec_s = drive(cfg, params, prompts, max_seq,
                                       extras)
    engine = ServeEngine(cfg, params, max_seq=max_seq, batch=PROMPTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)       # the model path only
    t0 = time.perf_counter()
    served = engine.generate(prompts, max_new_tokens=NEW_TOKENS,
                             extras=extras)
    gen_s = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    want_k2 = k2_launches_per_generate(cfg)
    check(counts == {"mapscore": 0, "flash_attention": want_k2, "ssd": 0,
                     "segscan": 0},
          f"{name}/{dtype}: generate launched {counts}, expected K2 "
          f"{want_k2} times and nothing else")
    check(np.array_equal(toks, served),
          f"{name}/{dtype}: prefill + decode_step tokens differ from "
          "generate's")
    check(np.isfinite(logits).all(), f"{name}/{dtype}: non-finite logits")
    if reference == "plain_drive":
        # fed the served tokens, so that one near tie cannot move every
        # later position; its own choices are compared
        want, want_toks, _, _ = drive(plain, params, prompts, max_seq,
                                      extras, forced=served)
        if dtype == "float32":
            check(np.array_equal(want_toks, served),
                  f"{name}/{dtype}: the plain drive's tokens differ")
        rec["plain_tokens_equal"] = bool(np.array_equal(want_toks, served))
    else:
        want = full_forward_logits(cfg, params, prompts, served, extras)
    err = scaled_err(logits, want)
    rec.update({
        "scaled_err": err, "max_abs_logit": float(np.abs(want).max()),
        "generate_s": gen_s, "prefill_s": pre_s,
        "decode_ms_per_token": dec_s / (NEW_TOKENS - 1) * 1e3,
        "tokens_per_s": PROMPTS * NEW_TOKENS / gen_s,
        "prefill_tokens_per_s": PROMPTS * plen / pre_s,
        "generate_launches": counts, "peak_mem_gib": peak / 2 ** 30,
        "tokens": served[0].tolist()})
    if cfg.family == "encdec":
        with torch.inference_mode():
            full = logits_fn(plain, params, model_inputs(prompts, extras))
            last = full[:, -1].float().cpu().numpy()
        del full
        rec["prefill_vs_logits_fn"] = scaled_err(logits[:, 0], last)
        check(rec["prefill_vs_logits_fn"] <= tol,
              f"{name}/{dtype}: prefill's last logits "
              f"{rec['prefill_vs_logits_fn']} from logits_fn's")
    if cfg.family == "moe":
        rec["dropped_share_by_layer"] = moe_drop_shares(cfg, params,
                                                        prompts)
    check(err <= tol, f"{name}/{dtype}: served logits {err} from the "
                      f"{reference}")
    if profile:
        model_profile(cfg, params, prompts, max_seq, name, extras)
    del params, engine
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(FAMILY_PHASES[name], **rec)
    return rec, logits


FAMILY_PHASES = {MOE_MODEL: "moe_model", ENCDEC_MODEL: "encdec_model",
                 VLM_MODEL: "vlm_model"}


def family_phases(profile: bool) -> dict:
    """Phases 9-11.  mixtral and whisper: float32, then bfloat16, the
    same model, whose first served position must lie beyond the float32
    tolerance from the float32 one (else that tolerance could not tell
    them apart); internvl2: float32 at ``VLM_F32_LAYERS``, bfloat16 at
    full depth."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 would not be float32")
    out = {}
    for name, layers, reference in (
            (MOE_MODEL, MOE_LAYERS, "plain_drive"),
            (ENCDEC_MODEL, 0, "plain_drive"),
            (VLM_MODEL, 0, "full_forward")):
        t0 = time.perf_counter()
        f32, logits32 = family_model(
            name, "float32", reference=reference,
            layers=VLM_F32_LAYERS if name == VLM_MODEL else layers)
        bf16, logits16 = family_model(name, "bfloat16", layers=layers,
                                      reference=reference,
                                      profile=profile and name != VLM_MODEL)
        rec = {"float32": f32, "bfloat16": bf16,
               "wall_s": time.perf_counter() - t0}
        if name != VLM_MODEL:
            gap = scaled_err(logits16[:, 0], logits32[:, 0])
            rec["bfloat16_vs_float32_at_prefill"] = gap
            check(gap > LOGITS_TOL["float32"],
                  f"{name}: bfloat16 lies only {gap} from float32: the "
                  "float32 tolerance would not catch it")
        emit(FAMILY_PHASES[name], part="summary", wall_s=rec["wall_s"],
             **{k: v for k, v in rec.items()
                if k.startswith("bfloat16_vs")})
        out[FAMILY_PHASES[name]] = rec
    return out


# ---------------------------------------------------------------------------
# phase 12: training on the card
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 2048, 5
# the kernels' gradients at the training shapes: K2 at yi-6b's attention
# (B, S = T, H, KH, D; causal), K3 at mamba2-2.7b's scan (B, L, H, P, N,
# chunk)
TRAIN_ATTN = ("yi-6b-train", 4, 2048, 32, 4, 128)
TRAIN_SSD = ("mamba2-2.7b-train", 4, 2048, 80, 64, 128, 128)
# step 0's gradients through the kernels' forward against those of the
# plain path (attn_impl="xla_flash"; the chunked SSD scan), per leaf as
# a fraction of that leaf's max |g|, and step 0's loss, relative.
# float32: the same function with sums in another order — the CPU tests
# allow 1e-4 (1.6e-6 measured at reduced size), and so does this: the
# H100 gave 1.6e-6 (yi-6b) and 1.2e-5 (mamba2-2.7b's A_log), PERF.md.
# bfloat16: the kernels round P (K2) and the scan's output once where the
# plain path rounds elsewhere, ~1 bf16 ulp of a layer's output carried
# back through every layer: 6.3e-3 and 7.0e-3 on the H100; the limit
# is the bfloat16 logits' of the model phases, 3e-2.
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# a small dense model for the restart and checkpoint checks (head dim
# 32: the kernel's)
TRAIN_SMALL = dict(name="train-smoke", family="dense", num_layers=2,
                   d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                   vocab_size=512, head_dim=32, dtype="float32",
                   loss_chunk=0)
TRAIN_SMALL_SHAPE = (128, 4)     # seq_len, global_batch


def grad_compare(name, got, want, again, tol) -> dict:
    """Kernel-path gradients ``got`` against the plain function's
    ``want``: bit for bit where the plain path gives the same bits on a
    rerun (``again``), else within ``tol`` of the leaf's max |g|."""
    import torch
    out = {}
    for key, g, w, w2 in zip(got, got.values(), want.values(),
                             again.values()):
        same = torch.equal(w, w2)
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        out[key] = {"plain_rerun_bit_identical": same,
                    "bit_identical": torch.equal(g, w),
                    "max_abs_err": err, "max_abs_grad": scale}
        check(bool(torch.isfinite(g).all()), f"{name}: d{key} not finite")
        if same:
            check(torch.equal(g, w), f"{name}: d{key} differs from autograd "
                  f"of the plain function (max abs err {err})")
        else:
            check(err <= tol * scale, f"{name}: d{key} {err} from the "
                  f"plain function's, whose reruns differ (limit "
                  f"{tol} x {scale})")
    return out


def kernel_grad_cases() -> list:
    """K2 and K3 as custom ops at the training shapes, float32 and
    bfloat16: the forward within ``ATTN_TOL`` / ``SSD_TOL``
    of the plain version, the gradients bit for bit autograd's of the
    function the reference differentiates (``attention_xla_flash``, the
    chunked ``ssd_reference``), forward + backward timed beside the plain
    forward + backward."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    out = []
    name, b, s, h, kh, d = TRAIN_ATTN
    pos = torch.arange(s, device="cuda")
    for i, dtype in enumerate(("float32", "bfloat16")):
        xs = [x.requires_grad_()
              for x in attention_inputs(b, s, h, kh, d, dtype, 100 + i)]
        g = torch.randn((b, s, h, d), device="cuda").to(xs[0].dtype)

        def plain_grads():
            ys = [x.detach().clone().requires_grad_() for x in xs]
            o = fa_ref.attention_xla_flash(*ys, q_pos=pos, k_pos=pos)
            return o, torch.autograd.grad(o, ys, g)

        n0 = fa_ops.launch_count
        o = fa_ops.flash_attention(*xs)
        check(o.grad_fn is not None, f"{name}: no grad_fn on the output")
        got = torch.autograd.grad(o, xs, g)
        check(fa_ops.launch_count == n0 + 1,
              f"{name}: one forward launch expected, the backward none")
        with torch.no_grad():
            ref_out = fa_ref.attention_ref(
                *(x.transpose(1, 2) for x in xs)).transpose(1, 2)
        atol, rtol = ATTN_TOL[dtype]
        o_f, ref_f = o.detach().float(), ref_out.float()
        err = float((o_f - ref_f).abs().max())
        check(torch.allclose(o_f, ref_f, atol=atol, rtol=rtol),
              f"{name}/{dtype}: forward {err}")
        plain_out, want = plain_grads()
        _, again = plain_grads()
        rec = {"case": name, "kernel": "flash_attention", "dtype": dtype,
               "shape": [b, s, h, kh, d], "max_abs_err": err,
               "grads": grad_compare(f"{name}/{dtype}", dict(zip("qkv", got)),
                                     dict(zip("qkv", want)),
                                     dict(zip("qkv", again)),
                                     TRAIN_GRAD_TOL[dtype])}
        del o, o_f, ref_f, got, want, again, plain_out, ref_out
        rec["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            fa_ops.flash_attention(*xs), xs, g), 5)
        rec["plain_fwd_bwd_ms"] = cuda_ms(plain_grads, 3, 1)
        rec["fwd_ms"] = cuda_ms(lambda: fa_ops.flash_attention(
            *(x.detach() for x in xs)), 5)
        out.append(rec)
        emit("train", part="kernel_grads", **rec)
        del xs, g
        torch.cuda.empty_cache()

    name, b, l, h, p, n, chunk = TRAIN_SSD
    for i, dtype in enumerate(("float32", "bfloat16")):
        xs = [x.requires_grad_() for x in ssd_inputs(
            b, l, h, p, n, dtype, None, False, 200 + i)]
        g = torch.randn((b, l, h, p), device="cuda").to(xs[0].dtype)

        def plain_grads():
            ys = [x.detach().clone().requires_grad_() for x in xs]
            y, _ = ssd_ref.ssd_reference(*ys, chunk=chunk)
            return y, torch.autograd.grad(y, ys, g)

        n0 = ssd_ops.launch_count
        y = ssd_ops.ssd(*xs, chunk=chunk)
        check(y.grad_fn is not None, f"{name}: no grad_fn on the output")
        got = torch.autograd.grad(y, xs, g)
        check(ssd_ops.launch_count == n0 + 1,
              f"{name}: one forward launch expected, the backward none")
        with torch.no_grad():
            want_y = ssd_ref.ssd_model_ref(*xs)
        a_frac, rtol = SSD_TOL[dtype]
        y_f, want_f = y.detach().float(), want_y.float()
        scale = float(want_f.abs().max())
        err = float((y_f - want_f).abs().max())
        check(torch.allclose(y_f, want_f, atol=a_frac * scale, rtol=rtol),
              f"{name}/{dtype}: forward {err}")
        _, want = plain_grads()
        _, again = plain_grads()
        keys = ("x", "dt", "A", "B", "C")
        rec = {"case": name, "kernel": "ssd", "dtype": dtype,
               "shape": [b, l, h, p, n], "chunk": chunk,
               "max_abs_err": err,
               "grads": grad_compare(f"{name}/{dtype}", dict(zip(keys, got)),
                                     dict(zip(keys, want)),
                                     dict(zip(keys, again)),
                                     TRAIN_GRAD_TOL[dtype])}
        del y, y_f, want_f, got, want, again, want_y
        rec["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            ssd_ops.ssd(*xs, chunk=chunk), xs, g), 5)
        rec["plain_fwd_bwd_ms"] = cuda_ms(plain_grads, 3, 1)
        rec["fwd_ms"] = cuda_ms(lambda: ssd_ops.ssd(
            *(x.detach() for x in xs), chunk=chunk), 5)
        out.append(rec)
        emit("train", part="kernel_grads", **rec)
        del xs, g
        torch.cuda.empty_cache()
    return out


class plain_ssd_path:
    """Within the block the Mamba2 block's scan is the plain chunked
    ``ssd_reference`` instead of the kernel: the plain path that phase
    ``train`` holds mamba2's step against (its config has no switch)."""

    def __enter__(self):
        from repro_torch.kernels.ssd import ops, ref
        self.ops, self.kernel = ops, ops.ssd

        def plain(x, dt, A, B, C, *, chunk=128):
            return ref.ssd_reference(x, dt, A, B, C,
                                     chunk=min(chunk, x.shape[1]))[0]
        ops.ssd = plain

    def __exit__(self, *exc):
        self.ops.ssd = self.kernel


def leaf_report(got, want, tol, what) -> dict:
    """Per gradient leaf |got - want| as a fraction of max |want|,
    checked against ``tol``; returns the worst leaf and the count."""
    import torch
    from repro_torch.train.tree import tree_items
    worst, worst_key = 0.0, None
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        check(bool(torch.isfinite(g).all()), f"{what}: {path} not finite")
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_key = err, "/".join(path)
    check(worst <= tol, f"{what}: leaf {worst_key} {worst} of its max |g| "
          f"(limit {tol})")
    return {"worst_scaled_err": worst, "worst_leaf": worst_key}


def train_model(name: str, dtype: str, profile: bool) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` on ``name`` at full
    width, ``TRAIN_LAYERS`` layers, ``remat="full"``, batches of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` from ``SyntheticLM``, from
    ``init_params(seed=0)``; before them step 0's loss and gradients
    (kernel path) against the plain path's and against a rerun."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params, params_spec
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.train.tree import tree_items
    base = get_config(name)
    cfg = dataclasses.replace(base, num_layers=TRAIN_LAYERS, dtype=dtype,
                              remat="full", loss_chunk=2048)
    check(cfg.attn_impl == "hopper", f"{name}: not through the kernel")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    params = init_params(cfg, 0, "cuda")
    rec = {"model": name, "dtype": dtype, "layers": cfg.num_layers,
           "of_layers": base.num_layers, "d_model": cfg.d_model,
           "params": count_params(params_spec(cfg)), "remat": cfg.remat,
           "loss_chunk": cfg.loss_chunk, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "grad_tol": TRAIN_GRAD_TOL[dtype]}
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.np_batch(0).items()}
    loss0, g0 = value_and_grad(cfg, params, batch)
    loss1, g1 = value_and_grad(cfg, params, batch)
    check(bool(torch.isfinite(loss0)), f"{name}/{dtype}: step 0 loss")
    check(torch.equal(loss0, loss1),
          f"{name}/{dtype}: a rerun of step 0 gives another loss")
    rec["step0_loss"] = float(loss0)
    rec["step0_rerun_bit_identical_leaves"] = [
        "/".join(p) for (p, a), (_, b) in zip(tree_items(g0), tree_items(g1))
        if torch.equal(a, b)]
    rec["step0_rerun_differing_leaves"] = [
        "/".join(p) for (p, a), (_, b) in zip(tree_items(g0), tree_items(g1))
        if not torch.equal(a, b)]
    del g1
    if cfg.family == "ssm":
        with plain_ssd_path():
            loss_p, g_p = value_and_grad(cfg, params, batch)
        rec["plain_path"] = "ssd_reference (chunked), no kernel"
    else:
        loss_p, g_p = value_and_grad(
            dataclasses.replace(cfg, attn_impl="xla_flash"), params, batch)
        rec["plain_path"] = "attn_impl=xla_flash, no kernel"
    rec["step0_plain_loss"] = float(loss_p)
    rec["step0_loss_rel_err"] = abs(float(loss0) - float(loss_p)) / abs(
        float(loss_p))
    rec["step0_grads_vs_plain"] = leaf_report(
        g0, g_p, TRAIN_GRAD_TOL[dtype], f"{name}/{dtype} step 0")
    check(rec["step0_loss_rel_err"] <= TRAIN_GRAD_TOL[dtype],
          f"{name}/{dtype}: step 0 loss {rec['step0_loss_rel_err']} from "
          "the plain path's")
    del g0, g_p, batch
    torch.cuda.empty_cache()

    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    state = init_state(opt, params)
    step_fn = make_train_step(cfg, opt)
    batches = [data.np_batch(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    losses, step_s = [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batches[s])
        losses.append(float(metrics["loss"]))     # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"{name}/{dtype}: non-finite loss {losses}")
    check(losses[0] == rec["step0_loss"],
          f"{name}/{dtype}: the step's loss is not step 0's")
    kernel = "ssd" if cfg.family == "ssm" else "flash_attention"
    per_step = 2 * cfg.num_layers   # remat: the forward and its recompute
    check(launches[kernel] == per_step * TRAIN_STEPS,
          f"{name}/{dtype}: {launches[kernel]} {kernel} launches in "
          f"{TRAIN_STEPS} steps, expected {per_step} a step")
    check(sum(launches.values()) == launches[kernel],
          f"{name}/{dtype}: another kernel launched: {launches}")
    steady = statistics.median(step_s[1:])
    rec.update(losses=losses, step_s=step_s, step_ms=steady * 1e3,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady,
               peak_mem_gib=peak / 2 ** 30, launches=launches,
               launches_per_step={kernel: launches[kernel] / TRAIN_STEPS},
               final_grad_norm=float(metrics["grad_norm"]))
    if profile:
        batch = data.np_batch(TRAIN_STEPS)
        prof = device_profile(lambda: step_fn(params, state, batch))
        rec["profile"] = by_class(prof)
    emit("train", part="model", **rec)
    del params, state, step_fn
    torch.cuda.empty_cache()
    return rec


def train_restarts() -> dict:
    """A small dense model on the card: ``train_with_restarts`` failing at
    step 7 and resuming from its step-4 checkpoint against the
    uninterrupted run (within 1e-5; bit-equality reported), and a
    bfloat16 checkpoint saved and restored bit for bit."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.driver import (JobConfig, train,
                                          train_with_restarts)
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import tree_items
    cfg = ModelConfig(**TRAIN_SMALL)
    shape = ShapeConfig("train-smoke", "train", *TRAIN_SMALL_SHAPE)
    opt = OptConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                    weight_decay=0.0)
    root = os.path.join(OUT_DIR, "train")
    shutil.rmtree(root, ignore_errors=True)
    logs = []
    job = JobConfig(steps=12, ckpt_dir=os.path.join(root, "restart"),
                    ckpt_every=4, log_every=0, fail_at_step=7)
    h1 = train_with_restarts(cfg, opt, job, shape=shape, log=logs.append)
    h2 = train(cfg, opt, JobConfig(steps=12, log_every=0), shape=shape,
               log=logs.append)
    gap = abs(h1["loss"][-1] - h2["loss"][-1])
    rec = {"config": TRAIN_SMALL, "shape": TRAIN_SMALL_SHAPE,
           "resumed": [x for x in logs if "resumed" in x],
           "final_loss": h1["loss"][-1], "uninterrupted_final_loss":
               h2["loss"][-1], "abs_gap": gap,
           "bit_equal": h1["loss"][-1] == h2["loss"][-1],
           "params_bit_equal": all(
               torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(h1["params"]), tree_items(h2["params"])))}
    check(rec["resumed"] == ["[train] resumed from step 4"],
          f"restart: {logs}")
    check(gap < 1e-5, f"restart: final loss {gap} from the uninterrupted run")
    bf16 = init_params(dataclasses.replace(cfg, dtype="bfloat16"), 1, "cuda")
    path = os.path.join(root, "bf16")
    ckpt.save(path, 1, {"params": bf16})
    back = ckpt.restore(path, 1, {"params": bf16})
    rec["bf16_checkpoint_bit_equal"] = all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for (_, a), (_, b) in zip(tree_items(back["params"]),
                                  tree_items(bf16)))
    check(rec["bf16_checkpoint_bit_equal"], "bf16 checkpoint roundtrip")
    emit("train", part="restart", **rec)
    shutil.rmtree(root, ignore_errors=True)
    return rec


def train_phase(profile: bool) -> dict:
    """Phase 12: the kernels' gradients, then yi-6b and mamba2-2.7b
    trained at full width (float32, bfloat16), then restarts and
    checkpoints."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 would not be float32")
    t0 = time.perf_counter()
    out = {"kernel_grads": kernel_grad_cases()}
    for name in (MODEL, SSM_MODEL):
        for dtype in ("float32", "bfloat16"):
            out[f"{name}/{dtype}"] = train_model(name, dtype, profile)
    out["restart"] = train_restarts()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {
        k: sum(out[f"{m}/{dt}"]["launches"][k] for m in (MODEL, SSM_MODEL)
               for dt in ("float32", "bfloat16"))
        for k in ("flash_attention", "ssd")}
    emit("train", part="summary", wall_s=out["wall_s"],
         launches=out["launches"])
    return out


# ---------------------------------------------------------------------------
# phase 13: the dry run on the production meshes
# ---------------------------------------------------------------------------

# (arch, shape, two pods): one cell of each step kind
DRY_CELLS = (("yi_6b", "train_4k", False),
             ("mamba2_2p7b", "prefill_32k", False),
             ("mixtral_8x22b", "decode_32k", True))


def dry_step_counts() -> dict:
    """(a) One yi-6b training step (``TRAIN_LAYERS`` layers at full
    width, ``TRAIN_BATCH`` x ``TRAIN_SEQ``, bfloat16, ``remat="full"``)
    on a 1x1 mesh as rank 0 of a fake world of one, counted by
    ``CostCounter``: once for real on the card, once under
    ``FakeTensorMode``.  Op counts, FLOPs, bytes and the K2 calls must be
    equal, and K2 must have launched 8 times in the real step."""
    import dataclasses
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_cost import CostCounter
    from repro_torch.meshmap import MeshLayout
    from repro_torch.models import init_params, params_spec, tree_abstract
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import tree_map
    cfg = dataclasses.replace(get_config(MODEL), num_layers=TRAIN_LAYERS,
                              dtype="bfloat16", remat="full",
                              loss_chunk=2048)
    opt = OptConfig()
    np_batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                           seed=0).np_batch(0)
    layout = MeshLayout(np.zeros((1, 1), np.int64), ("data", "model"))
    with dryrun.fake_world(1):
        mesh = dryrun.device_mesh(layout, "cuda")
        params = init_params(cfg, 0, "cuda")
        state = init_state(opt, params)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in np_batch.items()}
        step = make_train_step(cfg, opt, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        with CostCounter() as real:
            _, _, metrics = step(params, state, batch)
        loss = float(metrics["loss"].to_local())     # waits for the step
        real_s = time.perf_counter() - t0
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() - base
        del params, state, batch, step, metrics
        torch.cuda.empty_cache()
        with FakeTensorMode():
            fparams = tree_map(lambda a: torch.empty(
                a.shape, dtype=a.dtype, device="cuda"),
                tree_abstract(params_spec(cfg), cfg.dtype))
            fstate = init_state(opt, fparams)
            fbatch = {k: torch.empty(v.shape, dtype=torch.from_numpy(
                v[:0]).dtype, device="cuda") for k, v in np_batch.items()}
            fstep = make_train_step(cfg, opt, mesh)
            t0 = time.perf_counter()
            with CostCounter() as fake:
                fstep(fparams, fstate, fbatch)
            fake_s = time.perf_counter() - t0
    r, f = real.result(), fake.result()
    diff = {k: (r["op_counts"].get(k), f["op_counts"].get(k))
            for k in set(r["op_counts"]) | set(f["op_counts"])
            if r["op_counts"].get(k) != f["op_counts"].get(k)}
    rec = {"model": MODEL, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "loss": loss,
           "ops": sum(r["op_counts"].values()),
           "flops": r["flops"], "bytes_hbm": r["bytes_hbm"],
           "fake_flops": f["flops"], "fake_bytes_hbm": f["bytes_hbm"],
           "op_count_differences": diff,
           "k2_calls": r["op_counts"].get("repro_torch.flash_attention"),
           "fake_k2_calls": f["op_counts"].get(
               "repro_torch.flash_attention"),
           "k2_launches": launches["flash_attention"],
           "temp_peak_bytes": r["temp_peak_bytes"],
           "fake_temp_peak_bytes": f["temp_peak_bytes"],
           "cuda_peak_bytes_above_start": peak,
           "real_s": real_s, "fake_s": fake_s}
    check(not diff, f"dryrun: real and fake op counts differ: {diff}")
    check(r["flops"] == f["flops"] and r["bytes_hbm"] == f["bytes_hbm"],
          f"dryrun: real {r['flops']} / {r['bytes_hbm']} vs fake "
          f"{f['flops']} / {f['bytes_hbm']}")
    check(rec["k2_calls"] == rec["fake_k2_calls"] == rec["k2_launches"]
          == 2 * TRAIN_LAYERS, f"dryrun: K2 {rec['k2_calls']} calls, "
          f"{rec['fake_k2_calls']} fake, {rec['k2_launches']} launches")
    check(sum(launches.values()) == launches["flash_attention"],
          f"dryrun: another kernel launched: {launches}")
    return rec


def spec_bytes(spec_tree, abstract_tree, sizes: dict) -> int:
    """Bytes of one device's shards of ``abstract_tree`` under the
    partition specs ``spec_tree``: each dim divided by the product of
    the mesh axes its spec entry names."""
    import math
    total = 0
    for key, ab in abstract_tree.items():
        spec = spec_tree[key]
        if isinstance(ab, dict):
            total += spec_bytes(spec, ab, sizes)
            continue
        dims = list(ab.shape)
        for i, entry in enumerate(spec):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                dims[i] //= sizes[ax]
        total += math.prod(dims) * ab.dtype.itemsize
    return total


def dry_argument_bytes(arch: str, shape_name: str, layout) -> int:
    """The dry run's arguments of a cell by spec arithmetic: the
    parameters, and the optimizer state and batch (train), the batch
    (prefill) or the cache, tokens and the int32 position (decode)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import SHAPES, cache_axes, cache_spec
    from repro_torch.sharding.rules import PartitionSpec, spec_for_axes
    from repro_torch.train.step import (batch_shardings, batch_specs,
                                        model_shardings, opt_shardings)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rules = dryrun.rules_for(cfg, shape)
    sizes = dict(zip(layout.axis_names, layout.ranks.shape))
    psh, pab, _ = model_shardings(cfg, layout, rules)
    total = spec_bytes(psh, pab, sizes)
    dp = spec_for_axes(("batch",), rules, layout, (shape.global_batch,))
    if shape.kind == "train":
        osh, oab = opt_shardings(dryrun.opt_for(cfg), cfg, layout, rules)
        total += spec_bytes(osh, oab, sizes)
        total += spec_bytes(batch_shardings(cfg, shape, layout, rules),
                            batch_specs(cfg, shape), sizes)
    elif shape.kind == "prefill":
        specs = dryrun.input_specs(arch, shape_name)
        total += spec_bytes({k: PartitionSpec(*dp) for k in specs}, specs,
                            sizes)
    else:
        cab = cache_spec(cfg, shape.global_batch, shape.seq_len)
        cax = cache_axes(cfg)
        total += spec_bytes({k: spec_for_axes(cax[k], rules, layout, v.shape)
                             for k, v in cab.items()}, cab, sizes)
        specs = dryrun.input_specs(arch, shape_name)
        total += spec_bytes({"t": PartitionSpec(*dp)},
                            {"t": specs["tokens"]}, sizes) + 4
    return total


def dry_cells() -> list:
    """(b) ``run_cell`` on the production meshes as rank 0 of a fake world
    of 256 or 512: each cell ``ok``, its argument bytes the spec
    arithmetic's and below the card's memory, collectives in the train
    cell, rank 0 on card 0."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    out_dir = os.path.join(OUT_DIR, "dryrun")
    card = torch.cuda.get_device_properties(0).total_memory
    recs = []
    for arch, shape, multi in DRY_CELLS:
        layout = make_production_mesh(multi_pod=multi)
        tag = "pod2" if multi else "pod1"
        t0 = time.perf_counter()
        with dryrun.fake_world(layout.ranks.size):
            mesh = dryrun.device_mesh(layout, "cuda")
            check(torch.cuda.current_device() == 0,
                  f"dryrun: rank 0 is on card {torch.cuda.current_device()}")
            rec = dryrun.run_cell(arch, shape, mesh,
                                  os.path.join(out_dir, tag), tag)
        secs = time.perf_counter() - t0
        check(rec["status"] == "ok", f"dryrun {arch} x {shape} on {tag}: "
                                     f"{rec.get('error')}\n{rec.get('trace')}")
        want = dry_argument_bytes(arch, shape, layout)
        got = rec["memory"]["argument_size_in_bytes"]
        out = {"arch": arch, "shape": shape, "mesh": tag,
               "mesh_shape": rec["mesh_shape"], "seconds": secs,
               "memory": rec["memory"], "spec_argument_bytes": want,
               "cost": rec["cost"], "collectives": rec["collectives"],
               "k2_calls": rec["op_counts"].get(
                   "repro_torch.flash_attention", 0),
               "k3_calls": rec["op_counts"].get("repro_torch.ssd", 0)}
        check(got == want, f"dryrun {arch} x {shape}: argument bytes {got},"
                           f" spec arithmetic {want}")
        check(got < card, f"dryrun {arch} x {shape}: {got} argument bytes "
                          f"do not fit the card's {card}")
        check(rec["cost"]["flops"] > 0 and rec["cost"]["bytes_hbm"] > 0,
              f"dryrun {arch} x {shape}: no cost counted")
        if shape.startswith("train"):
            check(rec["collectives"]["total_bytes"] > 0,
                  f"dryrun {arch} x {shape}: a train step without "
                  "collectives")
        recs.append(out)
    return recs


def dryrun_phase() -> dict:
    """Phase 13: (a) real against fake counts of one training step, (b)
    three dry-run cells on the production meshes."""
    t0 = time.perf_counter()
    step = dry_step_counts()
    emit("dryrun", part="step", **step)
    cells = dry_cells()
    emit("dryrun", part="cells", cells=cells)
    out = {"step": step, "cells": cells,
           "wall_s": time.perf_counter() - t0}
    emit("dryrun", part="summary", wall_s=out["wall_s"])
    return out


# ---------------------------------------------------------------------------
# phase 14: sharded checkpoints and the elastic restore
# ---------------------------------------------------------------------------

# yi-6b at full width, cut to 2 of 32 layers (float32, remat="full"),
# global batch 4 x 512 SyntheticLM tokens, default OptConfig; the job
# saves at step 2 on (2, 2) and fails at step 3
ELASTIC_LAYERS, ELASTIC_BATCH, ELASTIC_SEQ = 2, 4, 512
ELASTIC_STEPS, ELASTIC_SAVE, ELASTIC_FAIL = 4, 2, 3
ELASTIC_TOL = 1e-5      # final loss, relative, against the uninterrupted run
ELASTIC_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def on_threads(world: int, fn, timeout: float = 600) -> list:
    """``fn(rank)`` on ``world`` threads of torch's threaded process
    group (every rank on card 0); the results by rank.  The first rank's
    exception is raised here, as is a rank still running after
    ``timeout`` seconds."""
    import threading
    import traceback
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world_state = _install_threaded_pg()
    store = dist.HashStore()
    results, errors = [None] * world, []

    def worker(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            results[rank] = fn(rank)
        except BaseException:  # noqa: BLE001 - raised below
            errors.append(traceback.format_exc())
        finally:
            # torch 2.11's threaded world has no ``comms`` and cannot be
            # destroyed; its groups are the thread's own and end with it
            if hasattr(world_state, "comms"):
                dist.destroy_process_group()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        check(not any(t.is_alive() for t in threads),
              f"a threaded rank still runs after {timeout} s")
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    check(not errors, f"a threaded rank failed:\n{errors[:1]}")
    return results


def same_bytes(a: str, b: str, chunk: int = 1 << 26) -> bool:
    """Whether the two directories hold the same file names and bytes."""
    if sorted(os.listdir(a)) != sorted(os.listdir(b)):
        return False
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            while True:
                x, y = fa.read(chunk), fb.read(chunk)
                if x != y:
                    return False
                if not x:
                    break
    return True


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def elastic_phase() -> dict:
    """Phase 14: a yi-6b job (full width, ``ELASTIC_LAYERS`` layers) on a
    (2, 2) mesh of four threaded ranks on card 0 saves at step 2 and
    fails at step 3; it resumes on (4, 1) and, restored whole, on the
    card alone; the same steps run uninterrupted on (2, 2)."""
    import dataclasses
    import shutil
    from unittest import mock
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.meshmap import MeshLayout
    from repro_torch.models import count_params, params_spec, tree_abstract
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.rules import shard_slices
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.driver import (JobConfig, train,
                                          train_with_restarts)
    from repro_torch.train.optimizer import OptConfig, abstract_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import tree_items
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MODEL), num_layers=ELASTIC_LAYERS,
                              dtype="float32", remat="full")
    check(cfg.attn_impl == "hopper", "elastic: not through the kernel")
    opt = OptConfig()
    shape = ShapeConfig("elastic", "train", ELASTIC_SEQ, ELASTIC_BATCH)
    layouts = {k: MeshLayout(np.arange(4).reshape(v), ("data", "model"))
               for k, v in ELASTIC_MESHES.items()}
    root = os.path.join(OUT_DIR, "elastic")
    shutil.rmtree(root, ignore_errors=True)
    ck, whole = os.path.join(root, "ckpt"), os.path.join(root, "unsharded")
    step_dir = os.path.join(ck, f"step_{ELASTIC_SAVE:09d}")
    rec = {"model": MODEL, "layers": cfg.num_layers,
           "of_layers": get_config(MODEL).num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": count_params(params_spec(cfg)), "dtype": cfg.dtype,
           "remat": cfg.remat, "batch": [ELASTIC_BATCH, ELASTIC_SEQ],
           "ranks": "4 threads of torch's threaded process group, card 0",
           "reduced": [f"layers {ELASTIC_LAYERS} of 32 (width uncut)"]}

    # (1) the (2, 2) job: saves at step 2 (the state gathered beside the
    # save), fails at step 3
    saved, secs = {}, {}

    def gathering(real):
        def save(ckpt_dir, step, tree, **kw):
            for key, v in tree_items(tree):
                # a copy: a replicated leaf's full_tensor() is its local
                # tensor, which the next step updates in place
                full = v.full_tensor()
                if dist.get_rank() == 0:
                    saved["/".join(key)] = full.clone()
                del full
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(ckpt_dir, step, tree, **kw)
            if dist.get_rank() == 0:
                secs["sharded_write_s"] = time.perf_counter() - t0
            return out
        return save

    def failing(rank):
        logs = []
        try:
            train_with_restarts(
                cfg, opt, JobConfig(steps=ELASTIC_STEPS, ckpt_dir=ck,
                                    ckpt_every=ELASTIC_SAVE, log_every=1,
                                    fail_at_step=ELASTIC_FAIL),
                layouts["2x2"], max_restarts=0, shape=shape,
                log=logs.append, device="cuda")
        except RuntimeError as e:
            if str(e) != f"simulated failure at step {ELASTIC_FAIL}":
                raise
            return logs
        check(False, "elastic: the (2, 2) job did not fail")

    with mock.patch.object(ckpt, "save", gathering(ckpt.save)):
        logs = on_threads(4, failing)[0]
    check(ckpt.all_steps(ck) == [ELASTIC_SAVE],
          f"elastic: checkpoints {ckpt.all_steps(ck)}")
    rec["failed_run_log"] = logs
    rec["checkpoint_bytes"] = dir_bytes(step_dir)
    rec["sharded_write_s"] = secs["sharded_write_s"]
    rec["sharded_write_gb_per_s"] = (rec["checkpoint_bytes"]
                                     / secs["sharded_write_s"] / 1e9)

    # the files against an unsharded save of the same state on the card
    t0 = time.perf_counter()
    ckpt.save(whole, ELASTIC_SAVE, saved)
    rec["unsharded_write_s"] = time.perf_counter() - t0
    rec["files_byte_equal"] = same_bytes(
        step_dir, os.path.join(whole, f"step_{ELASTIC_SAVE:09d}"))
    check(rec["files_byte_equal"],
          "elastic: the sharded save's files differ from the unsharded "
          "save's")
    shutil.rmtree(whole)

    # (4) the step-2 checkpoint restored whole onto the card (mesh=None),
    # as train() restores it without a mesh, then steps 2 and 3 there
    pab = tree_abstract(params_spec(cfg), cfg.dtype)
    like = {"params": pab, "opt": abstract_state(opt, pab)}
    t0 = time.perf_counter()
    one = ckpt.restore(ck, ELASTIC_SAVE, like, device="cuda")
    torch.cuda.synchronize()
    rec["one_card_read_s"] = time.perf_counter() - t0
    check(all(torch.equal(v, saved["/".join(k)]) for k, v in
              tree_items(one)), "elastic: the one-card restore differs "
                                "from the saved state")
    data = SyntheticLM(cfg.vocab_size, ELASTIC_SEQ, ELASTIC_BATCH, seed=0)
    step_fn = make_train_step(cfg, opt, device="cuda")
    params, state, one_loss, one_s = one["params"], one["opt"], [], []
    for s in range(ELASTIC_SAVE, ELASTIC_STEPS):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, data.np_batch(s))
        one_loss.append(float(m["loss"]))
        one_s.append(time.perf_counter() - t0)
    del one, params, state, step_fn, m
    torch.cuda.empty_cache()

    # (2) the same job resumed on (4, 1): every restored shard against
    # the same slice of the saved state; K2 counted in the resumed steps
    shards = []

    def comparing(real):
        def restore(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            equal = True
            for key, v in tree_items(out):
                idx, _ = shard_slices(tuple(v.shape), v.placements,
                                      v.device_mesh)
                equal &= torch.equal(v.to_local(), saved["/".join(key)][idx])
            shards.append((dist.get_rank(), equal, dt))
            return out
        return restore

    def resumed(rank):
        logs = []
        h = train(cfg, opt, JobConfig(
            steps=ELASTIC_STEPS, ckpt_dir=ck, log_every=1,
            ckpt_every=ELASTIC_STEPS + 1), layouts["4x1"], shape=shape,
            log=logs.append, device="cuda")
        return logs, h["loss"], h["step_s"]

    kernel_counts(reset=True)
    t0 = time.perf_counter()
    with mock.patch.object(ckpt, "restore", comparing(ckpt.restore)):
        logs, resumed_loss, resumed_s = on_threads(4, resumed)[0]
    rec["resume_4x1_s"] = time.perf_counter() - t0
    launches = kernel_counts()
    saved.clear()
    torch.cuda.empty_cache()
    check(logs[0] == f"[train] resumed from step {ELASTIC_SAVE}",
          f"elastic: the (4, 1) job did not resume: {logs[:2]}")
    check(len(shards) == 4 and all(eq for _, eq, _ in shards),
          f"elastic: restored shards against the saved state: {shards}")
    per_step = 2 * cfg.num_layers      # remat: the forward and its recompute
    want = 4 * per_step * (ELASTIC_STEPS - ELASTIC_SAVE)
    check(launches["flash_attention"] == want,
          f"elastic: {launches['flash_attention']} K2 launches in the "
          f"resumed steps, expected {want}")
    check(sum(launches.values()) == launches["flash_attention"],
          f"elastic: another kernel launched: {launches}")
    rec["resumed_log"] = logs[:1]
    rec["restored_shards_bit_equal"] = True
    rec["read_4x1_s"] = max(dt for _, _, dt in shards)
    rec["final_checkpoint_bytes"] = dir_bytes(
        os.path.join(ck, f"step_{ELASTIC_STEPS:09d}"))
    rec["launches"] = launches

    # (3) the same steps uninterrupted on (2, 2)
    def uninterrupted(rank):
        h = train(cfg, opt, JobConfig(steps=ELASTIC_STEPS, log_every=0),
                  layouts["2x2"], shape=shape, log=lambda *a: None,
                  device="cuda")
        return h["loss"], h["step_s"]

    ref_loss, ref_s = on_threads(4, uninterrupted)[0]
    final = ref_loss[-1]
    for name, got in (("4x1", resumed_loss[-1]), ("one_card", one_loss[-1])):
        gap = abs(got - final) / abs(final)
        rec[f"{name}_final_loss"] = got
        rec[f"{name}_rel_gap"] = gap
        rec[f"{name}_bit_equal"] = got == final
        check(gap <= ELASTIC_TOL, f"elastic: {name} resume's final loss "
                                  f"{gap} from the uninterrupted run's")
    rec.update(uninterrupted_losses=ref_loss, resumed_4x1_losses=resumed_loss,
               one_card_losses=one_loss, tol=ELASTIC_TOL,
               step_ms={"2x2": [s * 1e3 for s in ref_s],
                        "4x1": [s * 1e3 for s in resumed_s],
                        "one_card": [s * 1e3 for s in one_s]})
    rec["read_gb_per_s"] = rec["checkpoint_bytes"] / rec["read_4x1_s"] / 1e9
    shutil.rmtree(root, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    emit("elastic", **rec)
    return rec


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


def model_profile(cfg, params, prompts, max_seq, name=MODEL,
                  extras=None) -> None:
    """One prefill and one decode step of the served model: device time
    by kernel name, idle share.  (For ssm models the step runs on the
    unfilled cache prefill returns: its cost does not depend on the
    state's values.)"""
    import torch
    from repro_torch.models import decode_step, prefill
    batch = model_inputs(prompts, extras)
    with torch.inference_mode():
        pre = device_profile(lambda: prefill(cfg, params, batch,
                                             max_seq=max_seq))
        lg, cache = prefill(cfg, params, batch, max_seq=max_seq)
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
    request through a fresh service (the default config: the device
    partitioner and the one-pass fused sweep): device time by name, idle
    share."""
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import ops
    from repro_torch.serve import MappingService, get_scenario
    req, stack = problem["req"], problem["stack"]
    m = req.alloc.machine
    cs, edges, w, inv_bw = scoring_inputs(
        m, req.graph.edges, req.graph.weights, stack, True, "cuda")
    kw = dict(dims=m.dims, wrap=m.wrap, core_dims=m.core_dims, traffic=True)
    ops.mapscore(cs, edges, w, inv_bw, **kw)   # warm-up
    launch = device_profile(lambda: ops.mapscore(cs, edges, w, inv_bw, **kw))
    # the profiler slows every launch on the host; against an unprofiled
    # call's CUDA-event time the busy share shows what the device waits
    ms = cuda_ms(lambda: ops.mapscore(cs, edges, w, inv_bw, **kw), 20)
    launch["events_ms"] = ms
    launch["idle_share_vs_events"] = 1.0 - launch["device_busy_us"] * 1e-3 / ms
    cold = get_scenario(SCENARIOS[1], scale=scale,
                        rotations=rotations).request()
    svc = MappingService()
    request = device_profile(lambda: svc.map(cold))
    emit("profile", kernel_launch=launch, cold_request=request,
         scenario=SCENARIOS[1], scale=scale)
    hier_profile(scale, rotations)


def hier_profile(scale, rotations) -> None:
    """One cold node-latency request (the fused sweep and the refinement
    on the card) through a fresh service: device time by name, idle
    share."""
    from repro_torch.serve import MappingService, get_scenario
    node = get_scenario(HIER_SCENARIOS[1], scale=scale,
                        rotations=rotations).request()
    svc = MappingService()
    emit("profile", cold_request=device_profile(lambda: svc.map(node)),
         scenario=HIER_SCENARIOS[1], scale=scale)


# ---------------------------------------------------------------------------
# phase 4 (serve): MappingService on the device partitioner, fused
# ---------------------------------------------------------------------------

def check_answer(name, req, res) -> None:
    """A served assignment is a valid one (with task weights a part may
    hold several tasks or none, so only then may a processor hold two)."""
    import numpy as np
    check("degraded" not in res.stats, f"{name}: degraded answer")
    t2p = np.asarray(res.task_to_proc)
    check(t2p.shape == (req.graph.n,), f"{name}: shape {t2p.shape}")
    check(t2p.min() >= 0 and t2p.max() < req.alloc.n,
          f"{name}: assignment leaves the allocation")
    if req.graph.n == req.alloc.n and req.task_weights is None:
        check(np.bincount(t2p, minlength=req.alloc.n).max() == 1,
              f"{name}: a processor holds two tasks")
    check(np.isfinite(res.score), f"{name}: score {res.score}")


def check_service(svc, what: str) -> None:
    """No hidden degradation: a service outside its injected cases shows
    no degraded answer, no failed or skipped rung and no open breaker."""
    st = svc.stats()
    bad = {k: st[k] for k in ("degraded", "rung_failures", "breaker_skips",
                              "deadline_misses", "deadline_skips") if st[k]}
    check(not bad and not st["rungs"],
          f"{what}: the service degraded: {bad} {st['rungs']}")
    check(all(b["state"] == "closed" for b in st["breakers"].values()),
          f"{what}: breakers {st['breakers']}")


def serve_phase(problems, weighted, scale, rotations) -> dict:
    """Cold requests of the four scenarios and a weighted one through a
    ``MappingService`` with the default config (device partitioner, the
    one-pass fused sweep, K1): each must take the fused path, launch K1
    once (and segscan once a level for the weighted one) and serve the
    host-engine candidate the numpy evaluator picks.  Then warm answers,
    a batch with a duplicate, and each scenario once more with
    ``fused="off"`` (the staged device path) for its stage timings."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import partition_torch as PT
    from repro_torch.core.metrics import evaluate_candidates_numpy
    from repro_torch.core.signature import array_digest, mapping_signature
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import ops
    from repro_torch.kernels.mjfinish import ops as mj_ops
    from repro_torch.kernels.segscan import ops as seg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.serve import MappingService, get_scenario
    from repro_torch.serve.engine import MappingRequest

    def handoffs(ref) -> int:
        """The sides of a sweep that mjfinish finishes: the unweighted
        ones with a handoff level."""
        out = 0
        for kw in ref["sides"].values():
            n, d = np.shape(kw["coords"])
            up = bool(kw.get("uneven_prime"))
            levels = PT.split_depth(kw["nparts"], up)
            out += kw.get("weights") is None and PT._handoff_plan(
                n, kw["nparts"], up, d, levels, "cpu")[0] >= 0
        return out

    svc = MappingService()
    reqs = [get_scenario(n, scale=scale, rotations=rotations).request()
            for n in SCENARIOS]
    wname = SCENARIOS[0] + "+weights"
    wreq = MappingRequest(reqs[0].graph, reqs[0].alloc, reqs[0].config,
                          task_weights=weighted["req"].task_weights)
    names = list(SCENARIOS) + [wname]
    refs = [problems[n.rsplit("-", 1)[0]] for n in SCENARIOS] + [weighted]
    objs = [OBJECTIVES[n.rsplit("-", 1)[1]] for n in SCENARIOS] + \
        [OBJECTIVES["wh"]]
    # the main path's only
    ops.launch_count = fa_ops.launch_count = ssd_ops.launch_count = 0
    seg_ops.launch_count = mj_ops.launch_count = 0
    served = []
    for name, req, ref in zip(names, reqs + [wreq], refs):
        k1, seg = ops.launch_count, seg_ops.launch_count
        mj = mj_ops.launch_count
        resp = svc.map(req)
        torch.cuda.synchronize()
        check(resp.status == "cold", f"{name}: first answer {resp.status}")
        res = resp.result
        check_answer(name, req, res)
        check(res.stats.get("fused") is True, f"{name}: not fused")
        check(res.stats["partition_backend"] == "torch",
              f"{name}: partitioned by {res.stats['partition_backend']}")
        check(res.stats["fused_score_backend"] == "hopper",
              f"{name}: scored by {res.stats['fused_score_backend']}")
        check(ops.launch_count == k1 + 1,
              f"{name}: {ops.launch_count - k1} K1 launches, expected 1")
        check(mj_ops.launch_count - mj == handoffs(ref),
              f"{name}: {mj_ops.launch_count - mj} mjfinish launches, "
              f"expected {handoffs(ref)} (one a side it finishes)")
        served.append({"scenario": name, "tasks": int(req.graph.n),
                       "edges": int(len(req.graph.edges)),
                       "machine_dims": list(req.alloc.machine.dims),
                       "weighted": req.task_weights is not None,
                       "cold_s": resp.latency_s, "score": res.score,
                       "rotation": res.rotation,
                       "winner_index": res.stats["winner_index"],
                       "segscan_launches": seg_ops.launch_count - seg,
                       "mjfinish_launches": mj_ops.launch_count - mj,
                       **res.stats["timings"]})
    launches = ops.launch_count
    seg_launches = seg_ops.launch_count
    mj_launches = mj_ops.launch_count
    check(fa_ops.launch_count == ssd_ops.launch_count == 0,
          "the mapping path launched a model kernel")
    check(served[-1]["segscan_launches"] == weighted["levels"] > 0
          and seg_launches == served[-1]["segscan_launches"],
          f"segscan launches {[r['segscan_launches'] for r in served]}, "
          f"expected {weighted['levels']} for the weighted request only")

    # every cold winner: the host-engine candidate the numpy evaluator
    # picks on the same stack
    for name, req, rec, ref, obj in zip(names, reqs + [wreq], served, refs,
                                        objs):
        t0 = time.perf_counter()
        ev = evaluate_candidates_numpy(
            req.alloc.machine, req.graph.edges, req.graph.weights,
            ref["stack"], traffic="latency_max" in obj)
        best = winner(ev, obj)
        rec["numpy_score_s"] = time.perf_counter() - t0
        rec["numpy_winner"] = best
        rec["host_partition_s"] = ref["part_s"]
        rec["host_side_s"] = {k: v[1] for k, v in ref["host"].items()}
        # the service's content signature, recomputed (the request keeps
        # its own): what a cold request spends hashing its arrays
        t0 = time.perf_counter()
        sig = mapping_signature(
            req.graph, req.alloc, req.config,
            None if req.task_weights is None else
            {"task_weights": array_digest(req.task_weights)})
        rec["signature_s"] = time.perf_counter() - t0
        check(sig == req.signature(), f"{name}: signature recomputed differs")
        got = svc.results.get(req.signature(), count=False)
        want = ref["results"][best]
        check(np.array_equal(got.task_to_proc, want.task_to_proc)
              and got.rotation == want.rotation
              and rec["winner_index"] == best,
              f"{name}: served winner is not the host-engine candidate the "
              f"numpy evaluator picks ({best})")
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
    check(stats["cold"] == len(names), f"service stats {stats}")
    answers = {name: (req, svc.results.get(req.signature(), count=False))
               for name, req in zip(SCENARIOS, reqs)}

    # the staged device path: partition, then score, same answers
    for name, req, rec in zip(SCENARIOS, reqs, served):
        staged = MappingRequest(req.graph, req.alloc,
                                dataclasses.replace(req.config, fused="off"))
        k1 = ops.launch_count
        resp = svc.map(staged)
        torch.cuda.synchronize()
        res = resp.result
        check(resp.status == "cold" and not res.stats.get("fused"),
              f"{name}: fused='off' answer {resp.status}, {res.stats}")
        check_answer(name + " fused='off'", req, res)
        check(ops.launch_count == k1 + 1, f"{name}: staged K1 launches")
        fused = svc.results.get(req.signature(), count=False)
        check(np.array_equal(res.task_to_proc, fused.task_to_proc)
              and res.rotation == fused.rotation,
              f"{name}: the staged answer differs from the fused one")
        rec["staged"] = {"cold_s": resp.latency_s, **res.stats["timings"]}
    check_service(svc, "serve")
    return {"requests": served, "kernel_launches": launches,
            "segscan_launches": seg_launches,
            "mjfinish_launches": mj_launches,
            "service": {k: stats[k] for k in ("cold", "warm", "coalesced")},
            "_answers": answers}


# ---------------------------------------------------------------------------
# phase hier: node and depth-3 requests through the hierarchy
# ---------------------------------------------------------------------------

HIER_SCENARIOS = ("minighost-xk7_sparse-node-wh",
                  "minighost-xk7_sparse-node-latency",
                  "homme-bgq_block-depth3-latency",
                  "minighost-xk7_sparse-depth3-wh")
# the flat request of the same workload, allocation and objective (phase
# serve) each hierarchical one is set beside
HIER_FLAT = {n: n.replace("-node-", "-flat-").replace("-depth3-", "-flat-")
             for n in HIER_SCENARIOS}
# a served latency history against the all-numpy one: K1 sums float32
# volumes, the numpy router float64 ones (tests/test_torch_hier.py's
# LAT_RTOL)
HIER_LAT_RTOL = 1e-6
REFINE_KEYS = ("refine_rounds_run", "refine_accepted", "refine_evaluated",
               "refine_history", "refine_initial", "refine_final")


def refine_trap_cases() -> list:
    """The fused refinement on the card against the host ``refine_swaps``
    from the same scrambled start, on 16 clusters of a 4x4 torus: a ring
    of equal volumes (every contribution and many hop distances tie) and
    a 4-cluster ring (twelve contributions 0, -0.0 once negated, which
    only the card's radix sort tells from 0.0), both objectives (K1 for
    the latency one), bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import TaskGraph, make_machine
    from repro_torch.core.metrics_torch import message_inputs
    from repro_torch.hier import refine_swaps
    from repro_torch.mapping import MappingPipeline, PipelineConfig
    from repro_torch.mapping.fused import _Refinement
    m = make_machine((4, 4), wrap=True)
    rc = np.stack(np.unravel_index(np.arange(16), (4, 4)), axis=1)
    start = np.random.default_rng(5).permutation(16)
    out = []
    for case, n in (("ties", 16), ("zeros", 4)):
        src = np.arange(n)
        edges = np.concatenate([np.stack([src, (src + 1) % n], 1),
                                np.stack([(src + 1) % n, src], 1)])
        g = TaskGraph(np.zeros((16, 2)), edges, np.full(len(edges), 3.0))
        for obj in OBJECTIVES.values():
            want_c, want = refine_swaps(m, g, rc, start, objective=obj,
                                        rounds=4, top=8, degree=3,
                                        score_backend="hopper",
                                        device="cuda")
            pipe = MappingPipeline(PipelineConfig(objective=obj))
            traffic = pipe.search.needs_traffic
            edges_t, w, inv_bw = message_inputs(m, g.edges, g.weights,
                                                traffic, "cuda")
            ref = _Refinement(pipe._fused, m, torch.from_numpy(
                rc.astype(np.int32)).cuda(), edges_t, w, inv_bw, g, traffic,
                pipe.search.objective)
            row, got, reads = ref.run(torch.from_numpy(start).cuda(),
                                      rounds=4, top=8, degree=3)
            check(np.array_equal(row, want_c) and got == want,
                  f"refine trap {case} {obj}: device {got} vs host {want}")
            out.append({"case": case, "objective": list(obj),
                        "rounds_run": got["refine_rounds_run"],
                        "accepted": got["refine_accepted"], "reads": reads})
    return out


def k1_split_case(problem) -> dict:
    """K1's result for a candidate must not depend on the launch or the
    group it shares: the full-size xk7 stack scored whole, in two halves,
    and whole with the host evaluator's group bound, bit for bit (the
    fused refinement scores its proposals in other launches than the
    host pass it is held to)."""
    import torch
    from repro_torch.core.metrics_torch import scoring_inputs
    from repro_torch.kernels.mapscore import ops
    req, stack = problem["req"], problem["stack"]
    m = req.alloc.machine
    cs, edges, w, inv_bw = scoring_inputs(
        m, req.graph.edges, req.graph.weights, stack, True, "cuda")
    kw = dict(dims=m.dims, wrap=m.wrap, core_dims=m.core_dims, traffic=True)
    whole = ops.mapscore(cs, edges, w, inv_bw, **kw)
    h = len(cs) // 2
    parts = [ops.mapscore(cs[:h].contiguous(), edges, w, inv_bw, **kw),
             ops.mapscore(cs[h:].contiguous(), edges, w, inv_bw, **kw)]
    bound = ops.unpack(ops._scores(cs, edges, w, inv_bw, group_elems=1 << 24,
                                   **kw), len(cs), True)
    keys = ("weighted_hops", "total_hops", "data_max", "latency_max")
    for key in keys:
        split = torch.cat([p[key] for p in parts])
        check(torch.equal(whole[key], split)
              and torch.equal(whole[key], bound[key]),
              f"K1 {key}: a candidate's result depends on its launch")
    return {"case": f"{req.graph.n} tasks, nb {len(cs)}", "halves": h,
            "group_elems": [ops.GROUP_ELEMS, 1 << 24], "bit_equal": True}


def k1_proposal_case(name, scale, rotations) -> dict:
    """K1 against its plain version (``ref.mapscore_ref``) on the card at
    the shapes the fused refinement gives it: one round's proposal stack
    of a node-latency request (the coarse graph's messages, P = top *
    degree edited stacks of every router), from a seeded start, with
    ``compare_case``'s tolerance."""
    import numpy as np
    import torch
    from repro_torch.core.metrics_torch import message_inputs
    from repro_torch.hier import aggregate_tasks, router_view
    from repro_torch.mapping import MappingPipeline
    from repro_torch.mapping.fused import _Refinement
    from repro_torch.serve import get_scenario
    req = get_scenario(name, scale=scale, rotations=rotations).request()
    rc, _, router_alloc = router_view(req.alloc)
    n = len(rc)
    coarse = aggregate_tasks(req.graph, n, sfc=req.config.sfc,
                             device="cuda").coarse
    m = router_alloc.machine
    pipe = MappingPipeline(req.config)
    lvl = req.config.hierarchy.levels[-1]
    edges, w, inv_bw = message_inputs(m, coarse.edges, coarse.weights, True,
                                      "cuda")
    acoords = torch.from_numpy(np.ascontiguousarray(
        router_alloc.coords, dtype=np.int32)).cuda()
    ref = _Refinement(pipe._fused, m, acoords, edges, w, inv_bw, coarse,
                      True, pipe.search.objective)
    c2r = torch.from_numpy(np.random.default_rng(0).permutation(n)).cuda()
    r2c = torch.empty_like(c2r)
    r2c[c2r] = torch.arange(n, device="cuda")
    a, ra, b, rb, _, _ = ref.proposal_pairs(
        c2r, r2c, min(lvl.refine_top, n), min(lvl.refine_degree, n - 1))
    stack = ref._edit(acoords[c2r], a, b, ra, rb).cpu().numpy()
    return compare_case(f"{name} round proposals", m, coarse.edges,
                        coarse.weights, stack)


def coredeal_inputs(case: str, rng):
    """(labels, c2r, core_router, coords, nrouters) of a coredeal case:
    ``node`` the node cell's shape, a (64, 64, 32) grid in 4,096 boxes of
    32 tasks on 4,096 routers of 32 cores; the rest small: a trimmed
    allocation, a spill (more tasks than cores, clusters of uneven
    sizes), tied points, 1, 7 and 20 coordinates (20: a 60-bit Hilbert
    index), a NaN coordinate."""
    import numpy as np
    if case == "node":
        g = np.indices((64, 64, 32)).reshape(3, -1).T.astype(np.float64)
        labels = ((g[:, 0] // 4) * 256 + (g[:, 1] // 4) * 16
                  + g[:, 2] // 2).astype(np.int64)
        return (labels, rng.permutation(4096),
                np.repeat(np.arange(4096), 32), g, 4096)
    nrouters = 64
    core_router = np.repeat(np.arange(nrouters), 8)
    if case in ("uneven", "spill"):
        core_router = np.sort(core_router[rng.random(len(core_router))
                                          < 0.8])
    n = len(core_router) + (37 if case == "spill" else 0)
    d = {"d1": 1, "d7": 7, "d20": 20}.get(case, 3)
    coords = rng.random((n, d)) * 100
    if case == "ties":
        coords = rng.integers(0, 3, (n, d)).astype(np.float64)
    if case == "nan":
        coords[5, 1] = np.nan
    nclusters = 80 if case == "spill" else nrouters
    labels = rng.integers(0, nclusters, n)
    return labels, rng.integers(0, nrouters, nclusters), core_router, \
        coords, nrouters


COREDEAL_CASES = ("node", "uneven", "spill", "ties", "d1", "d7", "d20",
                  "nan")


def coredeal_cases() -> list:
    """coredeal against its plain version on the card and on the host
    (CPU tensors), bit for bit, on every case of :func:`coredeal_inputs`
    (seed 30), a rerun bit for bit, one wrapper launch a call, and a
    cluster or router id out of range raising ``ValueError`` with the
    card left usable; at the node cell's shape the wrapper, its three
    sorts and the plain version by CUDA events, and ``assign_cores``
    (uploads and the copy back) by the host clock, beside the byte
    bound."""
    import numpy as np
    import torch
    from repro_torch.core.orderings import hilbert_bits
    from repro_torch.hier import assign_cores
    from repro_torch.kernels.coredeal import ops, ref
    out = []
    for case in COREDEAL_CASES:
        rng = np.random.default_rng(30)
        labels, c2r, core_router, coords, nrouters = coredeal_inputs(case,
                                                                     rng)
        host = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (labels, c2r, core_router, coords)]
        want = ref.coredeal_ref(*host, nrouters=nrouters).numpy()
        args = [a.cuda() for a in host]
        n0 = ops.launch_count
        got = ops.coredeal(*args, nrouters=nrouters)
        again = ops.coredeal(*args, nrouters=nrouters)
        torch.cuda.synchronize()
        check(ops.launch_count == n0 + 2, f"coredeal/{case}: not one launch "
              f"a call ({ops.launch_count - n0} for 2)")
        plain = ref.coredeal_ref(*args, nrouters=nrouters)
        torch.cuda.synchronize()
        n, d = coords.shape
        check(torch.equal(got, again), f"coredeal/{case}: a rerun differs")
        ndiff = int((got != plain).sum())
        check(ndiff == 0, f"coredeal/{case}: {ndiff} cores differ from the "
              "plain version")
        ndiff = int((got.cpu().numpy() != want).sum())
        check(ndiff == 0, f"coredeal/{case}: {ndiff} cores differ from the "
              "plain version on the host")
        # tasks beyond their router's budget of q a core: the spill pass
        q = -(-n // len(core_router))
        over = (np.bincount(c2r[labels], minlength=nrouters)
                - q * np.bincount(core_router, minlength=nrouters))
        rec = {"case": case, "n": int(n), "d": int(d),
               "clusters": int(len(c2r)), "routers": int(nrouters),
               "cores": int(len(core_router)), "bits": hilbert_bits(n, d),
               "spilled": int(np.maximum(over, 0).sum())}
        check((rec["spilled"] > 0) == (case != "node"),
              f"coredeal/{case}: {rec['spilled']} tasks spilled")
        if case == "node":
            def host_ms(fn, reps):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(times)

            h = ref.hilbert_keys(args[3], rec["bits"])
            r = args[1][args[0]]
            nbytes = n * (8 * d + 24) + 8 * len(c2r)
            rec.update(
                ms=cuda_ms(lambda: ops.coredeal(*args, nrouters=nrouters),
                           20),
                sort_ms=cuda_ms(lambda: ref.sort_three(h, args[0], r), 20),
                plain_ms=cuda_ms(lambda: ref.coredeal_ref(
                    *args, nrouters=nrouters), 5),
                device_assign_ms=host_ms(lambda: assign_cores(
                    labels, c2r, core_router, coords, nrouters,
                    device="cuda"), 20),
                bytes=nbytes, bound_ms=nbytes / 3.35e12 * 1e3,
                bound_by="bytes")
        if case == "uneven":
            # ids out of range: counted on the card, raised after the read
            lab, c2r_t = args[0], args[1]
            for what, bad in (("cluster id", [lab + len(c2r), c2r_t]),
                              ("router id", [lab, c2r_t + nrouters])):
                try:
                    ops.coredeal(*bad, *args[2:], nrouters=nrouters)
                    raised = ""
                except ValueError as e:
                    raised = str(e)
                check(what in raised, f"coredeal/{case}: a {what} out of "
                      f"range gave {raised or 'an answer'}")
            check(torch.equal(ops.coredeal(*args, nrouters=nrouters), got),
                  f"coredeal/{case}: differs after the refused calls")
        out.append(rec)
    return out


def coarsen_split(req) -> dict:
    """Where a node request's host-side time goes, by part, at full size
    (median of 3, host clock; every device call synchronised): the
    coarsening's cluster labels (the device partitioner), the whole
    ``aggregate_tasks`` (labels plus the host contractions), and the
    expansion to cores (``assign_cores`` on the card)."""
    import numpy as np
    import torch
    from repro_torch.core.orderings import order_points
    from repro_torch.hier import aggregate_tasks, assign_cores, router_view
    rc, core_router, _ = router_view(req.alloc)
    tc = np.asarray(req.graph.coords, dtype=np.float64)
    n = len(rc)

    def labels():
        out = order_points(tc, n, req.config.sfc, backend="torch",
                           device="cuda")
        torch.cuda.synchronize()
        return out

    def timed(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), out

    labels_s, _ = timed(labels)
    agg_s, agg = timed(lambda: aggregate_tasks(req.graph, n, device="cuda",
                                               backend="torch"))
    c2r = np.arange(n)
    device_s, _ = timed(lambda: assign_cores(agg.labels, c2r, core_router,
                                             tc, n, device="cuda"))
    return {"labels_s": labels_s, "aggregate_s": agg_s,
            "contraction_s": agg_s - labels_s,
            "assign_cores_device_s": device_s,
            "coarse_edges": int(len(agg.coarse.edges))}


def hier_spans(trace_id) -> dict:
    """What the refinement of one request read back from the card: the
    fused pass's own count, or the device scorer's copies
    (``score.hopper`` spans) of the host passes under ``pipeline.refine``
    / ``pipeline.polish`` (the numpy scorer reads nothing back); and
    the K1 launches the pipeline's evaluator made (every ``score.hopper``
    span); the ``path`` of every expansion (``hier.assign_cores``) and
    of every contraction (``hier.contract``)."""
    from repro_torch import obs
    spans = obs.finished(trace_id)
    by_id = {s.span_id: s for s in spans}

    def under_refine(s):
        p = by_id.get(s.parent_id)
        while p is not None:
            if p.name in ("pipeline.refine", "pipeline.polish"):
                return True
            p = by_id.get(p.parent_id)
        return False

    fused = [s for s in spans if s.name == "pipeline.fused"]
    host_reads = sum(1 for s in spans if s.name == "score.hopper"
                     and under_refine(s))
    return {"fused_reads": (fused[0].attrs.get("refine_host_reads", 0)
                            if fused else 0),
            "host_reads": host_reads,
            "evaluator_k1": sum(1 for s in spans if s.name == "score.hopper"),
            "assign_paths": [s.attrs.get("path") for s in spans
                             if s.name == "hier.assign_cores"],
            "contract_paths": [s.attrs.get("path") for s in spans
                               if s.name == "hier.contract"]}


def finish_levels(trace_id) -> list:
    """The handoff level of every device partitioner sweep of one
    request (``finish_from`` of its spans; -1: no handoff)."""
    from repro_torch import obs
    return [level for s in obs.finished(trace_id)
            for level in s.attrs.get("finish_from", ())]


def hier_answer(name, req, res) -> dict:
    """The served hierarchical answer's checks: a valid assignment, the
    hierarchy and depth asked, ``fused_refine`` exactly where the top
    level swaps (scored by K1), monotone histories."""
    spec = req.config.hierarchy
    st = res.stats
    check_answer(name, req, res)
    check(st["hierarchy"] == name.split("-")[2] and st["depth"] == spec.depth
          and len(st["levels"]) == spec.depth - 1,
          f"{name}: hierarchy {st['hierarchy']} depth {st['depth']}")
    top_swap = spec.levels[-1].refine_mode == "swap"
    check(bool(st.get("fused_refine")) == top_swap,
          f"{name}: fused_refine {st.get('fused_refine')}, top level "
          f"{spec.levels[-1].refine_mode}")
    if top_swap:
        check(st["fused_score_backend"] == "hopper",
              f"{name}: refined with {st['fused_score_backend']}")
    hists = [st["refine_history"]] + [lv["refine_history"]
                                      for lv in st["levels"]]
    for hist in hists:
        check(all(tuple(b) <= tuple(a) for a, b in zip(hist, hist[1:])),
              f"{name}: refine history not monotone: {hist}")
    for lv in st["levels"]:
        if "polish_initial" in lv:
            check(lv["polish_final"] <= lv["polish_initial"],
                  f"{name}: polish went up: {lv}")
    return {"polish_s": sum(lv.get("polish_s", 0.0) for lv in st["levels"]),
            "fused_refine": bool(st.get("fused_refine")),
            "levels": [{k: v for k, v in lv.items()
                        if not k.endswith("history")} for lv in st["levels"]]}


def same_refinement(name, what, got, want) -> None:
    import numpy as np
    check(np.array_equal(got.task_to_proc, want.task_to_proc)
          and got.rotation == want.rotation,
          f"{name}: the {what} assignment differs")
    for k in REFINE_KEYS:
        check(got.stats[k] == want.stats[k],
              f"{name}: {k} {got.stats[k]} vs the {what} {want.stats[k]}")
    for a, b in zip(got.stats["levels"], want.stats["levels"]):
        for k in ("refine_history", "polish_final", "polish_accepted"):
            check(a.get(k) == b.get(k),
                  f"{name}: level {a['level']} {k} vs the {what}")


def numpy_oracle(name, scale, rotations) -> dict:
    """The all-numpy path's answer to a hierarchical request (host
    partitioner and scorer, ``fused="off"``; the numpy router scores
    every latency proposal, about a minute a request on one core): its
    history and seconds.  Runs in a worker process of its own."""
    import dataclasses
    from repro_torch.mapping import MappingPipeline
    from repro_torch.serve import get_scenario
    req = get_scenario(name, scale=scale, rotations=rotations, device="cpu",
                       partition_backend="numpy",
                       score_backend="numpy").request()
    t0 = time.perf_counter()
    res = MappingPipeline(dataclasses.replace(req.config, fused="off")).map(
        req.graph, req.alloc)
    return {"refine_history": res.stats["refine_history"],
            "refine_final": res.stats["refine_final"],
            "seconds": time.perf_counter() - t0}


def numpy_oracles(served, scale, rotations) -> list:
    """The all-numpy path's answers to the latency requests of phase
    ``hier``, one spawned worker each, all at once, run after the last
    timed phase so that no host-clock time is taken beside them.  The
    served answer (K1, float32 volumes) must match each history within
    ``HIER_LAT_RTOL``, entry by entry: the one answer on this path that
    no kernel computed."""
    import concurrent.futures
    import multiprocessing
    import numpy as np
    served = {r["scenario"]: r for r in served}
    names = [n for n in HIER_SCENARIOS if n.endswith("-latency")]
    with concurrent.futures.ProcessPoolExecutor(
            len(names), mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        pending = {n: pool.submit(numpy_oracle, n, scale, rotations)
                   for n in names}
        got = {n: f.result(timeout=600) for n, f in pending.items()}
    out = []
    for name in names:
        want, hist = got[name], served[name]["refine_history"]
        whist = want["refine_history"]
        gap = (hist[-1][0] - want["refine_final"]) / want["refine_final"]
        check(abs(gap) <= HIER_LAT_RTOL and len(hist) == len(whist)
              and all(np.allclose(a, b, rtol=HIER_LAT_RTOL, atol=0)
                      for a, b in zip(hist, whist)),
              f"{name}: served history {hist} vs all-numpy {whist} "
              f"(rtol {HIER_LAT_RTOL})")
        out.append({"scenario": name, "served_final": hist[-1][0],
                    "numpy_final": want["refine_final"],
                    "relative_gap": gap, "rtol": HIER_LAT_RTOL,
                    "numpy_history": whist, "numpy_s": want["seconds"]})
    return out


def hier_phase(serve, problems, scale, rotations) -> dict:
    """Cold node and depth-3 requests through a ``MappingService`` with
    the default config: coarsening on the device partitioner, the top
    sweep through the one-pass fused sweep with the refinement of a
    ``swap`` top level on the card (K1 in its loop for the latency
    objective), or staged with the host passes scoring through K1.  Each
    answer is held to its oracle: the all-host path (numpy partitioner
    and scorer, ``fused="off"``) for WeightedHops, the staged path with
    the same K1 scorer for the latency objective, bit for bit.  K1 is
    held to its plain version on a node-latency round's proposal stack
    here, and the latency answers to the all-numpy path by
    :func:`numpy_oracles` after the last timed phase."""
    import dataclasses
    import torch
    from repro_torch.core.signature import mapping_signature
    from repro_torch.kernels.contract import ops as ct_ops
    from repro_torch.kernels.coredeal import ops as cd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import ops
    from repro_torch.kernels.mjfinish import ops as mj_ops
    from repro_torch.kernels.segscan import ops as seg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.mapping import CandidateSearch, MappingPipeline
    from repro_torch.serve import MappingService, get_scenario

    traps = refine_trap_cases()
    coredeal = coredeal_cases()
    k1_proposals = k1_proposal_case(HIER_SCENARIOS[1], scale, rotations)
    k1_split = k1_split_case(problems[SCENARIOS[0].rsplit("-", 1)[0]])
    flat = {r["scenario"]: r for r in serve["requests"]} if serve else {}
    svc = MappingService()
    reqs = [get_scenario(n, scale=scale, rotations=rotations).request()
            for n in HIER_SCENARIOS]
    # the main path's only
    ops.launch_count = seg_ops.launch_count = mj_ops.launch_count = 0
    fa_ops.launch_count = ssd_ops.launch_count = cd_ops.launch_count = 0
    ct_ops.launch_count = 0
    served = []
    for name, req in zip(HIER_SCENARIOS, reqs):
        k1, seg = ops.launch_count, seg_ops.launch_count
        mj, cd = mj_ops.launch_count, cd_ops.launch_count
        ct = ct_ops.launch_count
        resp = svc.map(req)
        torch.cuda.synchronize()
        check(resp.status == "cold", f"{name}: first answer {resp.status}")
        res = resp.result
        rec = {"scenario": name, "tasks": int(req.graph.n),
               "edges": int(len(req.graph.edges)),
               "hierarchy": res.stats["hierarchy"],
               "depth": res.stats["depth"],
               "cold_s": resp.latency_s, "score": res.score,
               "refine_rounds_run": res.stats["refine_rounds_run"],
               "refine_accepted": res.stats["refine_accepted"],
               "refine_evaluated": res.stats["refine_evaluated"],
               "refine_history": res.stats["refine_history"],
               "nclusters": res.stats["nclusters"],
               "sweep_points": res.stats["sweep_points"],
               "k1_launches": ops.launch_count - k1,
               "segscan_launches": seg_ops.launch_count - seg,
               "mjfinish_launches": mj_ops.launch_count - mj,
               "coredeal_launches": cd_ops.launch_count - cd,
               "contract_launches": ct_ops.launch_count - ct,
               "finish_from": finish_levels(res.stats["trace_id"]),
               **hier_answer(name, req, res), **res.stats["timings"],
               **hier_spans(res.stats["trace_id"])}
        rec["refine_reads"] = (rec["fused_reads"] if rec["fused_refine"]
                               else rec["host_reads"])
        # what the cold answer spent hashing the request (recomputed)
        t0 = time.perf_counter()
        check(mapping_signature(req.graph, req.alloc, req.config)
              == req.signature(), f"{name}: signature recomputed differs")
        rec["signature_s"] = time.perf_counter() - t0
        # K1: one launch a pipeline evaluator call; the fused pass adds
        # the sweep's and, for the latency objective, its refinement's
        # (the base, each round's proposals, each accepted round's
        # rescoring) — none for WeightedHops, summed exactly in float64
        want_k1 = rec["evaluator_k1"]
        if rec["fused_refine"]:
            want_k1 += 1
            if name.endswith("-latency"):
                want_k1 += rec["fused_reads"] + rec["refine_rounds_run"]
        check(rec["k1_launches"] == want_k1 > 0,
              f"{name}: {rec['k1_launches']} K1 launches, expected "
              f"{want_k1}")
        # the top sweep is weighted by the cluster sizes: segscan runs
        check(rec["segscan_launches"] > 0, f"{name}: segscan never ran")
        # mjfinish: one launch a sweep with a handoff level (each sweep
        # annotates its span), none for the weighted task side; a node
        # request's coarsening and router side both hand off
        handed = sum(level >= 0 for level in rec["finish_from"])
        check(rec["mjfinish_launches"] == handed
              and (handed == 2 or "-node-" not in name),
              f"{name}: {rec['mjfinish_launches']} mjfinish launches, "
              f"finish_from {rec['finish_from']}")
        # coredeal: one launch an expansion (one a node request, two a
        # depth-3 one), every one on the card
        paths = rec["assign_paths"]
        check(rec["coredeal_launches"] == len(paths)
              == req.config.hierarchy.depth - 1
              and set(paths) == {"cuda"},
              f"{name}: {rec['coredeal_launches']} coredeal launches, "
              f"expansion paths {paths}")
        # contract: one launch a coarsening level, every one on the card
        paths = rec["contract_paths"]
        check(rec["contract_launches"] == len(paths)
              == req.config.hierarchy.depth - 1
              and set(paths) == {"cuda"},
              f"{name}: {rec['contract_launches']} contract launches, "
              f"contraction paths {paths}")
        served.append(rec)
    launches = ops.launch_count
    seg_launches = seg_ops.launch_count
    mj_launches = mj_ops.launch_count
    cd_launches = cd_ops.launch_count
    ct_launches = ct_ops.launch_count
    check(fa_ops.launch_count == ssd_ops.launch_count == 0,
          "the hierarchical path launched a model kernel")
    split = coarsen_split(reqs[0])

    # -- oracles -------------------------------------------------------
    for name, req, rec in zip(HIER_SCENARIOS, reqs, served):
        got = svc.results.get(req.signature(), count=False)
        # the answer scored as the flat request scores its candidates
        # (fine graph, K1): a latency objective's refine_final is the
        # coarse graph's, whose messages all sit on core row 0 of the
        # router's link tables, so it is not the fine mapping's
        search = CandidateSearch(req.config.objective, backend="hopper",
                                 device="cuda")
        rec["fine_score"] = float(search.score_assignments(
            req.graph, req.alloc, got.task_to_proc[None])[0][0])
        f = flat.get(HIER_FLAT[name])
        if f is not None:
            rec["flat"] = {"scenario": HIER_FLAT[name],
                           "cold_s": f["cold_s"], "score": f["score"],
                           "fine_score_ratio": rec["fine_score"] / f["score"],
                           "cold_ratio": rec["cold_s"] / f["cold_s"]}
        if name.endswith("-wh"):
            host = dataclasses.replace(req.config, partition_backend="numpy",
                                       score_backend="numpy", fused="off")
            t0 = time.perf_counter()
            want = MappingPipeline(host).map(req.graph, req.alloc)
            rec["oracle"] = "all-host"
            rec["oracle_s"] = time.perf_counter() - t0
            same_refinement(name, "all-host", got, want)
        else:
            staged = dataclasses.replace(req.config, fused="off")
            t0 = time.perf_counter()
            want = MappingPipeline(staged).map(req.graph, req.alloc)
            torch.cuda.synchronize()
            rec["oracle"] = "staged K1"
            rec["oracle_s"] = time.perf_counter() - t0
            same_refinement(name, "staged K1", got, want)
            if rec["fused_refine"]:
                rec["staged"] = dict(want.stats["timings"])
    check_service(svc, "hier")
    return {"requests": served, "kernel_launches": launches,
            "segscan_launches": seg_launches,
            "mjfinish_launches": mj_launches,
            "coredeal_launches": cd_launches, "coredeal": coredeal,
            "contract_launches": ct_launches,
            "refine_traps": traps,
            "k1_split": k1_split, "k1_proposals": k1_proposals,
            "node_split": split}


# ---------------------------------------------------------------------------
# phase resilience: the degradation ladder under injected faults
# ---------------------------------------------------------------------------

RESILIENCE_SCENARIO = SCENARIOS[0]       # minighost-xk7_sparse-flat-wh
# (case, faults as (site, kind, options), service options, serving rung
#  or None where the error goes to the caller, failed rungs).  On the
# card the default config's ladder is full (the fused sweep), unfused:
# no rung leaves the card's kernels.  The fused sweep launches K1 and
# runs the device partitioner itself, so it passes ``kernel.mapscore``
# and ``partition.torch`` as the staged rung does; a fault that fails
# both rungs reaches the caller.  The deadline case's first rung sleeps
# past the deadline and the last rung, which has none, serves.
RESILIENCE_CASES = (
    ("k1_fails_once", (("kernel.mapscore", "error", {"count": 1}),), {},
     "unfused", 1),
    ("k1_fails_twice", (("kernel.mapscore", "error", {"count": 2}),), {},
     None, 2),
    ("device_partitioner_fails",
     (("partition.torch", "error", {"count": 2}),), {}, None, 2),
    ("slow_past_deadline",
     (("serve.compute", "slow", {"delay": 1.0, "count": 1}),),
     {"deadline_s": 0.5}, "unfused", 1),
)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")


def kernel_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (zeroed first with
    ``reset``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mapscore import ops as ms_ops
    from repro_torch.kernels.segscan import ops as seg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    mods = {"mapscore": ms_ops, "flash_attention": fa_ops, "ssd": ssd_ops,
            "segscan": seg_ops}
    if reset:
        for m in mods.values():
            m.launch_count = 0
    return {k: m.launch_count for k, m in mods.items()}


def rung_walk(trace_id) -> list:
    """The ``serve.rung`` spans of one request: each rung considered,
    with its seconds, what happened there, and the seconds of the
    pipeline pass it started (an abandoned rung's pass runs on after
    the rung is given up)."""
    from repro_torch import obs
    spans = obs.finished(trace_id)
    walk = []
    for sp in spans:
        if sp.name != "serve.rung":
            continue
        runs = [c.duration_s for c in spans if c.name == "pipeline.map"
                and c.parent_id == sp.span_id]
        walk.append({"rung": sp.attrs["rung"], "s": sp.duration_s,
                     "pipeline_s": runs[0] if runs else None,
                     **{k: sp.attrs[k] for k in ("skipped", "error",
                                                 "degraded")
                        if k in sp.attrs}})
    return walk


def fresh_service(**options):
    """A new service over cleared pipelines: no case reads another's
    state."""
    from repro_torch.mapping import pipeline
    from repro_torch.serve import MappingService
    with pipeline._SHARED_LOCK:
        pipeline._SHARED_PIPELINES.clear()
    return MappingService(**options)


def profiled_request(req, healthy) -> dict:
    """One cold healthy request under ``obs.torch_profile``: the device
    trace it writes must name the mapscore kernel."""
    import glob
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.kernels.mapscore import ops
    outdir = os.path.join(OUT_DIR, "profile")
    for old in glob.glob(os.path.join(outdir, "*.json")):
        os.remove(old)
    svc = fresh_service()
    os.environ["REPRO_TORCH_PROFILE"] = outdir
    try:
        k1 = ops.launch_count
        with obs.torch_profile("cold-request") as armed:
            resp = svc.map(req)
            torch.cuda.synchronize()
    finally:
        del os.environ["REPRO_TORCH_PROFILE"]
    check(armed == outdir, "torch_profile did not arm")
    check_answer("profiled request", req, resp.result)
    check(resp.status == "cold" and ops.launch_count == k1 + 1,
          f"profiled request: {resp.status}, "
          f"{ops.launch_count - k1} K1 launches")
    check(np.array_equal(resp.result.task_to_proc, healthy.task_to_proc),
          "profiled request: answer differs from phase serve's")
    check_service(svc, "profiled request")
    # the request's root span is a child of the profile's span
    [sp] = [s for s in obs.finished(resp.trace_id)
            if s.name == "torch.profile"]
    with open(sp.attrs["path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    k1_names = [k for k in kernels if "mapscore" in k]
    check(k1_names, f"the device trace names no mapscore kernel: "
                    f"{kernels[:20]}")
    return {"path": os.path.relpath(sp.attrs["path"]),
            "cold_s": resp.latency_s, "events": len(events),
            "device_kernels": len(kernels), "mapscore_kernels": k1_names}


def resilience_phase(served) -> dict:
    """The default-config service answers ``RESILIENCE_SCENARIO`` under
    each of ``RESILIENCE_CASES`` inside ``faults.isolated()``: every
    planned fault fires as planned, the expected rung serves with an
    answer equal to phase ``serve``'s healthy one bit for bit, or the
    error reaches the caller where no card rung is left.  Before the
    cases, one cold healthy request under ``obs.torch_profile``; a
    ``JsonlSink`` logs the phase's spans, which must read back with the
    degraded and the failed rungs, and the phase's Chrome trace and the
    process's Prometheus text must parse."""
    import threading
    import numpy as np
    import torch
    from repro_torch import faults, obs
    req, healthy = served
    os.makedirs(OUT_DIR, exist_ok=True)
    log = os.path.join(OUT_DIR, "resilience.jsonl")
    if os.path.exists(log):
        os.remove(log)
    sink = obs.JsonlSink(log)
    obs.add_sink(sink)
    kernel_counts(reset=True)
    cases, trace_ids = [], []
    try:
        profiled = profiled_request(req, healthy)
        for case, specs, options, rung, failed in RESILIENCE_CASES:
            svc = fresh_service(**options)
            error = None
            with faults.isolated():
                installed = [faults.install(site, kind, **opts)
                             for site, kind, opts in specs]
                t0 = time.perf_counter()
                with obs.span("chip_smoke.case", case=case) as case_span:
                    try:
                        resp = svc.map(req)
                    except faults.InjectedFault as e:
                        error = e
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                fired = [sp.fired for sp in installed]
            # an abandoned rung's worker finishes off-thread: wait for it
            # so that no later case meets its device work or its fires
            t0 = time.perf_counter()
            for th in threading.enumerate():
                if th.name == "mapping-rung":
                    th.join(120)
                    check(not th.is_alive(), f"{case}: worker still runs")
            torch.cuda.synchronize()
            waited_s = time.perf_counter() - t0
            st = svc.stats()
            planned = [opts["count"] for _, _, opts in specs]
            check(fired == planned, f"{case}: fired {fired}, planned "
                                    f"{planned}")
            if rung is None:
                check(error is not None,
                      f"{case}: served, expected the error")
                check(st["cold"] == st["degraded"] == 0
                      and len(svc.results) == 0
                      and st["rung_failures"] == failed,
                      f"{case}: service stats {st}")
            else:
                check(error is None, f"{case}: raised {error!r}")
                res = resp.result
                check(resp.status == "cold"
                      and res.stats.get("degraded") == rung,
                      f"{case}: served by {res.stats.get('degraded')}, "
                      f"expected {rung}")
                check(np.array_equal(res.task_to_proc,
                                     healthy.task_to_proc),
                      f"{case}: the {rung} answer differs from the "
                      "healthy one")
                check(st["degraded"] == 1 and st["rungs"] == {rung: 1}
                      and st["rung_failures"] == failed,
                      f"{case}: service stats {st}")
            if "deadline_s" in options:
                check(st["deadline_misses"] == 1,
                      f"{case}: deadline misses {st['deadline_misses']}")
            walk = rung_walk(case_span.trace_id)
            trace_ids.append(case_span.trace_id)
            cases.append({"case": case, "faults": [list(x) for x in specs],
                          "fired": fired, "rung": rung,
                          "error": None if error is None else repr(error),
                          "cold_s": seconds, "walk": walk,
                          "worker_wait_s": waited_s,
                          **{k: st[k] for k in (
                              "rung_failures", "deadline_misses",
                              "deadline_skips", "breaker_skips")}})
    finally:
        obs.remove_sink(sink)
        sink.close()
    counts = kernel_counts()
    launches = counts.pop("mapscore")
    check(not any(counts.values()), f"resilience launched {counts}")

    # -- the exporters over the phase ----------------------------------
    logged = obs.read_jsonl(log)
    rungs = [s["attrs"] for s in logged if s["name"] == "serve.rung"]
    degraded = sorted(a["degraded"] for a in rungs if "degraded" in a)
    check(degraded == sorted(c[3] for c in RESILIENCE_CASES if c[3]),
          f"the span log's degraded rungs: {degraded}")
    failed = sum("error" in a for a in rungs)
    check(failed == sum(c[4] for c in RESILIENCE_CASES),
          f"the span log's failed rungs: {failed}")
    spans = [sp for sp in obs.finished() if sp.trace_id in set(trace_ids)]
    chrome = os.path.join(OUT_DIR, "resilience.trace.json")
    obs.write_chrome_trace(chrome, spans)
    with open(chrome) as f:
        doc = json.load(f)
    check(len(doc["traceEvents"]) == len(spans) > 0,
          "the Chrome trace is empty")
    prom = obs.prometheus_text()
    samples = [ln for ln in prom.splitlines() if not ln.startswith("#")]
    for ln in samples:
        float(ln.rsplit(" ", 1)[1])
    check(samples and "repro_serve_degraded_total" in prom,
          "the Prometheus text has no degraded counter")
    return {"scenario": RESILIENCE_SCENARIO, "cases": cases,
            "profiled_request": profiled, "kernel_launches": launches,
            "exporters": {"jsonl_spans": len(logged),
                          "chrome_events": len(doc["traceEvents"]),
                          "prometheus_samples": len(samples)}}


# ---------------------------------------------------------------------------
# phase meshmap: select_mapping and the topology mesh
# ---------------------------------------------------------------------------

def mesh_scenarios():
    """The logical meshes of ``benchmarks/mapping_tpu.py``: (tag, graph,
    allocation, axis bytes)."""
    from repro_torch.core import (Allocation, logical_mesh_graph,
                                  make_machine, sfc_allocation,
                                  tpu_v5e_multipod, tpu_v5e_pod)
    from repro_torch.meshmap import DEFAULT_AXIS_BYTES as B
    m1 = tpu_v5e_pod(16)
    a1 = Allocation(m1, m1.all_coords())
    dm = (B["data"], B["model"])
    pdm = (B["pod"],) + dm
    out = [("aligned_16x16", (16, 16), dm, a1),
           ("mismatch_64x4", (64, 4), dm, a1),
           ("mismatch_4x64", (4, 64), dm, a1),
           ("mismatch_8x32", (8, 32), dm, a1),
           ("mismatch_2x8x16", (2, 8, 16), pdm, a1)]
    ms = make_machine((32, 32), wrap=True, bw=50.0, name="supertorus")
    for seed in (0, 1, 2):
        out.append((f"sparse_16x16_seed{seed}", (16, 16), dm,
                    sfc_allocation(ms, 256, nfragments=4, seed=seed)))
    m2 = tpu_v5e_multipod(2, 16)
    out.append(("two_pod_2x16x16", (2, 16, 16), pdm,
                Allocation(m2, m2.all_coords())))
    return [(tag, logical_mesh_graph(shape, w, None), alloc, w)
            for tag, shape, w, alloc in out]


def meshmap_phase() -> dict:
    """``select_mapping`` with its defaults (K1, the device partitioner,
    ``cuda``) against the all-host path on every scenario of
    ``mesh_scenarios``: equal winners bit for bit, never worse than the
    enumeration.  Then a repeat build through a service (all warm), and
    ``make_topology_mesh(multi_pod=True)``, whose ranks must be the
    winner's order, with the collective term of the mapped and the
    default layout."""
    import numpy as np
    import torch
    from repro_torch.core import (Allocation, identity_mapping,
                                  logical_mesh_graph)
    from repro_torch.kernels.mapscore import ops
    from repro_torch.launch.mesh import make_topology_mesh
    from repro_torch.meshmap import (DEFAULT_AXIS_BYTES, collective_term,
                                     compare_mappings, device_coords,
                                     machine_for, select_mapping,
                                     split_axis_bytes)
    host = dict(score_backend="numpy", partition_backend="numpy")
    kernel_counts(reset=True)
    rows = []
    for tag, g, a, w in mesh_scenarios():
        k1 = ops.launch_count
        t0 = time.perf_counter()
        best, ours, base = select_mapping(g, a, w)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - t0
        launches = ops.launch_count - k1
        t0 = time.perf_counter()
        hbest, hours, _ = select_mapping(g, a, w, **host)
        host_s = time.perf_counter() - t0
        check("degraded" not in best.stats, f"{tag}: degraded")
        check(np.array_equal(best.task_to_proc, hbest.task_to_proc)
              and best.rotation == hbest.rotation,
              f"{tag}: the K1 winner differs from the all-host one")
        check(launches > 0, f"{tag}: K1 never launched")
        lat = ours["latency_max"] / max(base["latency_max"], 1e-9)
        wh = ours["weighted_hops"] / max(base["weighted_hops"], 1e-9)
        check(lat <= 1 + 1e-9, f"{tag}: lat_ratio {lat}")
        rows.append({"scenario": tag, "tasks": int(g.n),
                     "lat_ratio": lat, "wh_ratio": wh, "device_s": device_s,
                     "host_s": host_s, "k1_launches": launches})
    search_launches = ops.launch_count

    # -- a repeat mesh build through the service ------------------------
    shape, axes = (2, 16, 16), ("pod", "data", "model")
    ab = [DEFAULT_AXIS_BYTES[x] for x in axes]
    m2 = machine_for(pods=2, side=16)
    n = int(np.prod(shape))
    g = logical_mesh_graph(shape, tuple(ab), axes)
    a = Allocation(m2, device_coords(range(n), m2).astype(int))
    svc = fresh_service()
    t0 = time.perf_counter()
    best, _, _ = select_mapping(g, a, ab, rotations=8, service=svc)
    cold_s = time.perf_counter() - t0
    first = svc.stats()
    t0 = time.perf_counter()
    again, _, _ = select_mapping(g, a, ab, rotations=8, service=svc)
    warm_s = time.perf_counter() - t0
    second = svc.stats()
    check(second["warm"] - first["warm"] == first["cold"] == 4
          and second["cold"] == first["cold"],
          f"the repeat build was not all warm: {first} then {second}")
    check(np.array_equal(best.task_to_proc, again.task_to_proc),
          "the repeat build's winner differs")
    check_service(svc, "meshmap")

    # -- the topology mesh: the winner's order -----------------------------
    t0 = time.perf_counter()
    layout, report = make_topology_mesh(multi_pod=True, return_report=True)
    mesh_s = time.perf_counter() - t0
    check(layout.ranks.shape == shape and layout.axis_names == axes
          and np.array_equal(layout.ranks, best.task_to_proc.reshape(shape)),
          "make_topology_mesh's ranks are not the winner's order")
    step_bytes = split_axis_bytes(1e9, shape, ab)
    terms = compare_mappings(a, shape, step_bytes,
                             {"mapped": best,
                              "default": identity_mapping(g, a)})
    check(terms["mapped"] <= terms["default"] * (1 + 1e-9),
          f"collective term {terms}")
    check(np.isclose(collective_term(a, shape, best, step_bytes),
                     terms["mapped"], rtol=1e-12), "collective_term")
    counts = kernel_counts()
    check(not any(v for k, v in counts.items() if k != "mapscore"),
          f"meshmap launched {counts}")
    return {"scenarios": rows, "kernel_launches": counts["mapscore"],
            "search_launches": search_launches,
            "service": {"cold_s": cold_s, "warm_s": warm_s,
                        "cold": first["cold"],
                        "warm_repeat": second["warm"] - first["warm"]},
            "topology_mesh": {"shape": list(shape), "s": mesh_s,
                              "lat_ratio": report["mapped"]["latency_max"]
                              / report["default"]["latency_max"],
                              "collective_s": terms,
                              "step_bytes": step_bytes}}


def mapping_phases(scale, rotations, profile) -> dict:
    """Phases ``kernels``, ``partition`` and ``serve``: the mapping paths
    (K1, the device partitioner with segscan, the served requests)."""
    from repro_torch.kernels.mapscore import kernel as ms_kernel
    from repro_torch.kernels.mapscore import ops

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
        prob = full_size_problem(name + "-latency", scale, rotations)
        problems[name] = prob
        req, stack = prob["req"], prob["stack"]
        rec = compare_case(f"{name}@{scale}", req.alloc.machine,
                           req.graph.edges, req.graph.weights, stack,
                           timed=True)
        rec["partition_s"] = prob["part_s"]
        _, _, per_cand = ms_kernel.workspace_layout(
            req.alloc.machine.dims, req.alloc.machine.core_dims)
        rec["workspace_bytes_per_candidate"] = per_cand * 8
        rec["candidates_per_group"] = ops.candidate_chunk(
            req.alloc.machine, True, nb=len(stack))
        full.append(rec)
    check(any(r["workspace_bytes_per_candidate"] > 232448 for r in full),
          "no full-size machine exceeds one block's shared memory")
    range_errors = range_error_cases()
    contract = contract_cases()
    emit("kernels", rtol=RTOL, atol=ATOL, small=small, full=full,
         range_errors=range_errors, design=ms_kernel.DESIGN,
         contract=contract,
         timing="median of 20 kernel / 5 plain launches, CUDA events; "
                "kernel calls under set_sync_debug_mode('error'); "
                "contract: median of 20 launches by CUDA events, its plain "
                "version and numpy's body median of 5 by the host clock")

    # -- phase 3: the device partitioner vs the host engine ---------------
    weighted = full_size_problem(SCENARIOS[0], scale, rotations,
                                 weights_seed=0)
    part = partition_phase(problems, weighted, scale)
    weighted["levels"] = next(r["levels"] for r in part["cases"]
                              if r["case"].startswith("weighted@"))
    emit("partition", scale=scale, rotations=rotations, **part,
         timing="device_ms: median of 5 sweeps after the upload, CUDA "
                "events; host_s: the numpy engine, host clock; every "
                "sweep under set_sync_debug_mode('error')")

    # -- phase 4: serve -----------------------------------------------------
    serve = serve_phase(problems, weighted, scale, rotations)
    emit("serve", scale=scale, rotations=rotations,
         **{k: v for k, v in serve.items() if k != "_answers"})

    # -- phase hier: node and depth-3 requests -------------------------------
    hier = hier_phase(serve, problems, scale, rotations)
    emit("hier", scale=scale, rotations=rotations, **hier)

    # -- phase resilience: the degradation ladder under injected faults ----
    res = resilience_phase(serve["_answers"][RESILIENCE_SCENARIO])
    emit("resilience", scale=scale, rotations=rotations, **res)

    # -- phase meshmap: select_mapping and the topology mesh ----------------
    mesh = meshmap_phase()
    emit("meshmap", **mesh)
    if profile:
        profile_phase(problems[SCENARIOS[1].rsplit("-", 1)[0]], scale,
                      rotations)
    return {"small": small, "full": full, "partition": part,
            "serve": serve, "hier": hier, "resilience": res,
            "meshmap": mesh, "contract": contract}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# the paths that launch K1, each read with the counts set to 0 just
# before it
K1_PATHS = ("serve", "hier", "resilience", "meshmap")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=2 ** 18,
                    help="tasks per served request (>= 2**16)")
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time by kernel name of one "
                         "mapscore launch, one cold request, and one "
                         "prefill and decode step of yi-6b, mamba2-2.7b, "
                         "mixtral-8x22b and whisper-small "
                         "(torch.profiler)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script only "
              "runs on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.contract import kernel as ct_kernel
    from repro_torch.kernels.coredeal import kernel as cd_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mapscore import kernel as ms_kernel
    from repro_torch.kernels.mjfinish import kernel as mj_kernel
    from repro_torch.kernels.segscan import kernel as seg_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    # -- phase 1: device + build ------------------------------------------
    smi = nvidia_smi_line()
    ms_kernel._launch_fn()          # builds and loads, or raises
    fa_kernel._launch_fn()
    ssd_kernel._launch_fn()
    seg_kernel._launch_fn()
    mj_kernel._launch_fn()
    cd_kernel._launch_fns()
    ct_kernel._launch_fns()
    info = _build.build_info()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_seconds=info["seconds"], built=info["built"],
         library=os.path.relpath(info["path"]), sources=info["sources"])

    # -- phases 2 and 3, serve: the mapping paths ------------------------
    mapping = mapping_phases(args.scale, args.rotations, args.profile)

    # -- phase 4: flash attention vs plain ----------------------------------
    attn = [attention_case(*c, seed=i) for i, c in enumerate(ATTN_CASES)]
    attn += family_attention_cases()
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

    # -- phases 9-11: the moe, encdec and vlm families ----------------------
    families = family_phases(args.profile)

    # -- phase 12: training -------------------------------------------------
    train = train_phase(args.profile)

    # -- phase 13: the dry run ------------------------------------------------
    dry = dryrun_phase()

    # -- phase 14: sharded checkpoints and the elastic restore ----------------
    elastic = elastic_phase()

    # -- the hier phase's all-numpy latency answers, after every timed phase
    emit("hier_numpy", requests=numpy_oracles(
        mapping["hier"]["requests"], args.scale, args.rotations),
         note="all-numpy path (numpy partitioner, scorer and router), "
              "fused='off', one worker process a request, after the last "
              "timed phase; the served answer's latency comes from "
              "float32 volumes (K1)")

    # -- the kernels line ---------------------------------------------------
    k2_paths = {"model": model["bfloat16"]["flash_launches"],
                "hybrid_model_prefill":
                    hybrid["prefill_launches"]["flash_attention"],
                **{p: families[p]["bfloat16"]["generate_launches"]
                   ["flash_attention"] for p in families},
                "train": train["launches"]["flash_attention"],
                "dryrun": dry["step"]["k2_launches"],
                "elastic": elastic["launches"]["flash_attention"]}
    k3_paths = {"ssm_model_long_prefill":
                    ssm["bfloat16"]["long_prefill_launches"]["ssd"],
                "train": train["launches"]["ssd"]}
    grads = {(r["kernel"], r["dtype"]): {
        k: r[k] for k in ("case", "shape", "fwd_ms", "fwd_bwd_ms",
                          "plain_fwd_bwd_ms")}
        for r in train["kernel_grads"]}
    fa = next(r for r in attn if (r["case"], r["dtype"]) == ATTN_TIMED)
    sd = next(r for r in ssd if (r["case"], r["dtype"]) == SSD_TIMED[0])
    full, small = mapping["full"], mapping["small"]
    lead = full[0]  # minighost on xk7_sparse: the largest accumulators
    seg = mapping["partition"]["segscan"]
    seg_lead = seg[0]  # the first level's layout: the longest walks
    mjf = mapping["partition"]["mjfinish"]
    mj_lead = mjf[0]   # minighost's task side: the cold cells' shape
    cd_lead = mapping["hier"]["coredeal"][0]  # the node cell's shape
    ct_lead = mapping["contract"][0]  # the node cell's shape
    kernels = [{
        "name": "mapscore", "route": "cuda", "design": ms_kernel.DESIGN,
        "source": "src/repro_torch/kernels/mapscore/csrc/mapscore.cu",
        "replaces": "src/repro/kernels/mapscore/kernel.py:204",
        "launches": sum(mapping[p]["kernel_launches"] for p in K1_PATHS),
        "launches_by_path": {p: mapping[p]["kernel_launches"]
                             for p in K1_PATHS},
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
        "design": fa_kernel.DESIGN[torch.bfloat16],
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": max(r["max_abs_err"] for r in attn),
        "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "shape": {"case": fa["case"], "bshkd": fa["shape"],
                  "dtype": fa["dtype"], "causal": True},
        "tolerance": {k: {"atol": a, "rtol": r}
                      for k, (a, r) in ATTN_TOL.items()},
        "backward": "VJP of attention_xla_flash (plain torch), bit for bit",
        "train_grads": {dt: grads[("flash_attention", dt)]
                        for dt in ("float32", "bfloat16")},
    }, {
        "name": "ssd", "route": "cuda",
        "design": ssd_kernel.DESIGN[torch.bfloat16],
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:68",
        "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths,
        "max_abs_err": max(r["max_abs_err"] for r in ssd),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None,
        "shape": {"case": sd["case"], "blhpn": sd["shape"],
                  "dtype": sd["dtype"]},
        "tolerance": {k: {"atol": f"{a:g} * max|y|", "rtol": r}
                      for k, (a, r) in SSD_TOL.items()},
        "backward": "VJP of the chunked ssd_reference (plain torch), bit "
                    "for bit",
        "train_grads": {dt: grads[("ssd", dt)]
                        for dt in ("float32", "bfloat16")},
    }, {
        "name": "segscan", "route": "cuda", "design": seg_kernel.DESIGN,
        "source": "src/repro_torch/kernels/segscan/csrc/segscan.cu",
        "replaces": "src/repro/core/partition_jax.py:212",
        "note": "no Pallas counterpart: the sequential lax.scan of the "
                "reference's device partitioner, kept sequential for "
                "bit-identity",
        "launches": (mapping["serve"]["segscan_launches"]
                     + mapping["hier"]["segscan_launches"]),
        "launches_by_path": {
            "serve": mapping["serve"]["segscan_launches"],
            "hier": mapping["hier"]["segscan_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in seg),
        "ms": seg_lead["ms"], "plain_ms": seg_lead["plain_ms"],
        "bound_ms": seg_lead["bound_ms"], "bound_by": seg_lead["bound_by"],
        "library_ms": seg_lead["library_ms"],
        "chain_adds": seg_lead["chain_adds"],
        "shape": {"case": seg_lead["case"], "n": seg_lead["n"],
                  "segments": seg_lead["segments"]},
        "tolerance": "exact",
    }, {
        "name": "mjfinish", "route": "cuda", "design": mj_kernel.DESIGN,
        "source": "src/repro_torch/kernels/mjfinish/csrc/mjfinish.cu",
        "replaces": "src/repro/core/partition_jax.py:_sweep",
        "note": "no Pallas counterpart: the reference's level while_loop "
                "from the handoff level on, one launch a side",
        "launches": (mapping["serve"]["mjfinish_launches"]
                     + mapping["hier"]["mjfinish_launches"]),
        "launches_by_path": {
            "serve": mapping["serve"]["mjfinish_launches"],
            "hier": mapping["hier"]["mjfinish_launches"]},
        "max_abs_err": 0,
        "ms": mj_lead["ms"], "plain_ms": mj_lead["plain_ms"],
        "bound_ms": mj_lead["bound_ms"], "bound_by": mj_lead["bound_by"],
        "library_ms": None,
        "shape": {k: mj_lead[k] for k in ("case", "n", "candidates",
                                          "finish_from", "segments")},
        "tolerance": "exact",
    }, {
        "name": "coredeal", "route": "cuda", "design": cd_kernel.DESIGN,
        "source": "src/repro_torch/kernels/coredeal/csrc/coredeal.cu",
        "replaces": "src/repro/hier/refine.py:assign_cores",
        "note": "no Pallas counterpart: the host hilbert_key + lexsort + "
                "deal of the hierarchy's expansion to cores",
        "launches": mapping["hier"]["coredeal_launches"],
        "launches_by_path": {"hier": mapping["hier"]["coredeal_launches"]},
        "max_abs_err": 0,
        "ms": cd_lead["ms"], "plain_ms": cd_lead["plain_ms"],
        "bound_ms": cd_lead["bound_ms"], "bound_by": cd_lead["bound_by"],
        "library_ms": None, "sort_ms": cd_lead["sort_ms"],
        "shape": {k: cd_lead[k] for k in ("case", "n", "d", "clusters",
                                          "routers", "cores")},
        "tolerance": "exact",
    }, {
        "name": "contract", "route": "cuda", "design": ct_kernel.DESIGN,
        "source": "src/repro_torch/kernels/contract/csrc/contract.cu",
        "replaces": "src/repro/hier/aggregate.py:aggregate_tasks",
        "note": "no Pallas counterpart: the host np.bincount / np.unique "
                "contraction of the hierarchy's coarsening",
        "launches": mapping["hier"]["contract_launches"],
        "launches_by_path": {"hier": mapping["hier"]["contract_launches"]},
        "max_abs_err": 0,
        "ms": ct_lead["ms"], "plain_ms": ct_lead["plain_ms"],
        "bound_ms": ct_lead["bound_ms"], "bound_by": ct_lead["bound_by"],
        "library_ms": None, "sort_ms": ct_lead["sort_ms"],
        "numpy_ms": ct_lead["numpy_ms"],
        "device_contraction_ms": ct_lead["device_contraction_ms"],
        "shape": {k: ct_lead[k] for k in ("case", "n", "d", "edges",
                                          "clusters", "pairs")},
        "tolerance": "exact",
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
