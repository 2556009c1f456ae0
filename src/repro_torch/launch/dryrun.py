"""Multi-pod dry run: every (architecture x input shape) step on the
production mesh (16x16 single pod, 2x16x16 two pods), as rank 0 of a
fake process group, with nothing allocated.

The reference package's ``launch/dryrun.py`` lowers and compiles each
step on 512 fake XLA host devices.  Here the step runs eagerly as rank 0
of torch.distributed's ``"fake"`` backend (a world of the mesh's size;
its collectives move nothing), on a ``DeviceMesh`` built from
:func:`~repro_torch.launch.mesh.make_production_mesh` or
:func:`~repro_torch.launch.mesh.make_topology_mesh` (the mapping
pipeline, with K1 on the card), under ``FakeTensorMode`` (every op sees
its real shapes, no byte is allocated) and a
:class:`~repro_torch.launch.op_cost.CostCounter`.  Parameters, optimizer
state, batch and cache are DTensors placed by the reference's partition
specs (``train.step.model_shardings`` / ``opt_shardings`` /
``batch_shardings``, ``models.cache_axes``); the steps are the port's own
(``make_train_step``, ``prefill``, ``make_serve_step``).  Each record
has the reference's fields:

- ``memory``: ``argument_size_in_bytes`` (rank 0's shards of the step's
  arguments), ``output_size_in_bytes`` (of its results) and
  ``temp_size_in_bytes`` (the counter's ``temp_peak_bytes``);
- ``cost`` (``flops``, ``bytes_hbm``) and ``collectives`` (bytes and
  counts by type, total bytes, bytes by mesh axis) per device, from the
  counter, and ``op_counts`` (aten op -> calls);
- ``time_lower_s``: the seconds of the fake run.

There is no ``cost_xla_raw``, ``time_compile_s``, ``time_analyze_s`` or
``hlo_lines``: nothing is compiled.  Records land in
``build/dryrun_torch/<mesh>/<arch>__<shape>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--topology]
  (add --device cpu on a machine without a GPU)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.op_cost import CostCounter, tree_nbytes
from repro_torch.models import (cache_axes, cache_spec, count_params,
                                params_spec, prefill)
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.params import DTYPES, ShapeDtype
from repro_torch.sharding.rules import (DEFAULT_RULES, PartitionSpec,
                                        local_shape, mesh_axis_sizes,
                                        placed, placements_for,
                                        spec_for_axes, use_mesh)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (batch_shardings, batch_specs,
                                    make_serve_step, make_train_step,
                                    model_shardings, opt_shardings)
from repro_torch.train.tree import tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")


# ---------------------------------------------------------------------------
# input_specs: ShapeDtype stand-ins, no allocation
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return batch_specs(cfg, shape)
    if shape.kind == "prefill":
        b, s = shape.global_batch, shape.seq_len
        out = {"tokens": ShapeDtype((b, s), torch.int32)}
        if cfg.family == "encdec":
            out["frames"] = ShapeDtype(
                (b, cfg.encoder_seq, cfg.frontend_dim), DTYPES[cfg.dtype])
        if cfg.family == "vlm":
            out["patches"] = ShapeDtype(
                (b, cfg.num_patches, cfg.frontend_dim), DTYPES[cfg.dtype])
        return out
    # decode: one token against a cache of seq_len
    b = shape.global_batch
    return {
        "cache": cache_spec(cfg, b, shape.seq_len),
        "tokens": ShapeDtype((b, 1), torch.int32),
        "pos": ShapeDtype((), torch.int32),
    }


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")
    return ""


def rules_for(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    rules = dict(DEFAULT_RULES)
    if shape.name == "long_500k":
        # batch=1: the data axis is idle for batch sharding; spend it on
        # sequence-sharding the KV cache
        rules["kv_seq"] = ("data", "model")
    return rules


def opt_for(cfg: ModelConfig) -> OptConfig:
    big = count_params(params_spec(cfg)) > 1e11
    return OptConfig(moment_dtype="bfloat16" if big else "float32")


def micro_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation factor for training cells: the MoE giants
    need microbatching to fit activations."""
    if shape.kind != "train":
        return 1
    if count_params(params_spec(cfg)) > 1e11:
        # largest micro count that keeps the batch shardable over data
        sizes = mesh_axis_sizes(mesh)
        dp = sizes.get("data", 1) * sizes.get("pod", 1)
        return max(1, min(16, shape.global_batch // dp))
    return 1


# ---------------------------------------------------------------------------
# The fake world and the placed stand-ins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a ``"fake"`` process group of ``world_size`` ranks for
    the block (its collectives move nothing); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh, device: str):
    """The ``DeviceMesh`` of a :class:`MeshLayout` (``mesh`` itself when
    it is one already) over the current process group."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return mesh
    return mesh.device_mesh(torch.device(device).type)


def _placed_tree(spec_tree, abstract_tree, dmesh, device):
    """Fake DTensors of ``abstract_tree``'s shapes placed by
    ``spec_tree`` (call under ``FakeTensorMode``)."""
    def one(spec, ab):
        pl = placements_for(spec, dmesh)
        local = torch.empty(local_shape(ab.shape, pl, dmesh),
                            dtype=ab.dtype, device=device)
        return placed(local, ab.shape, pl, dmesh)
    return tree_map(one, spec_tree, abstract_tree)


def _batch_spec_tree(cfg, shape, dmesh, rules, specs):
    dp = spec_for_axes(("batch",), rules, dmesh, (shape.global_batch,))
    return {k: PartitionSpec(*dp, *([None] * (len(v.shape) - 1)))
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, mesh, *, rules=None,
               device="cuda"):
    """Run the cell's step as rank 0 under ``FakeTensorMode`` and the
    counter; returns (counts, memory, meta).  ``mesh``: a ``DeviceMesh``
    or a :class:`MeshLayout` over the current (fake) process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = rules or rules_for(cfg, shape)
    dmesh = device_mesh(mesh, device)
    dev = torch.device(device)
    param_sh, params_ab, _ = model_shardings(cfg, dmesh, rules)
    specs = input_specs(arch, shape_name)
    counter = CostCounter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _placed_tree(param_sh, params_ab, dmesh, dev)
        if shape.kind == "train":
            opt_cfg = opt_for(cfg)
            opt_sh, opt_ab = opt_shardings(opt_cfg, cfg, dmesh, rules)
            opt_state = _placed_tree(opt_sh, opt_ab, dmesh, dev)
            batch = _placed_tree(batch_shardings(cfg, shape, dmesh, rules),
                                 specs, dmesh, dev)
            args = (params, opt_state, batch)
            step = make_train_step(cfg, opt_cfg, dmesh, rules=rules,
                                   microbatch=micro_for(cfg, shape, dmesh),
                                   device=dev)
            with counter:
                out = step(params, opt_state, batch)
        elif shape.kind == "prefill":
            batch = _placed_tree(
                _batch_spec_tree(cfg, shape, dmesh, rules, specs), specs,
                dmesh, dev)
            args = (params, batch)
            with counter, torch.no_grad(), use_mesh(dmesh, rules):
                out = prefill(cfg, params, batch)
        else:  # decode
            cax = cache_axes(cfg)
            cache = _placed_tree(
                {k: spec_for_axes(cax[k], rules, dmesh, v.shape)
                 for k, v in specs["cache"].items()},
                specs["cache"], dmesh, dev)
            tokens = _placed_tree(
                _batch_spec_tree(cfg, shape, dmesh, rules,
                                 {"t": specs["tokens"]}),
                {"t": specs["tokens"]}, dmesh, dev)["t"]
            # the position rank 0's shard of the cache holds, so that its
            # write is counted; the attention reads the whole cache
            pos = 0
            args = (params, cache, tokens, specs["pos"])
            step = make_serve_step(cfg, dmesh, rules=rules, device=dev)
            with counter:
                out = step(params, cache, tokens, pos)
        memory = {
            "argument_size_in_bytes": _nbytes(args),
            "output_size_in_bytes": _nbytes(out),
            "temp_size_in_bytes": counter.temp_peak_bytes,
        }
    groups = {dmesh.get_group(d).group_name: name
              for d, name in enumerate(dmesh.mesh_dim_names)}
    counts = counter.result()
    counts["collective_bytes_by_axis"] = {
        groups.get(g, g): b
        for g, b in counts.pop("collective_bytes_by_group").items()}
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "params": count_params(params_spec(cfg)),
            "mesh_shape": list(dmesh.shape),
            "mesh_axes": list(dmesh.mesh_dim_names)}
    return counts, memory, meta


def _nbytes(tree) -> int:
    """Rank 0's bytes of ``tree``'s tensors and :class:`ShapeDtype`
    stand-ins (the decode step's scalar position)."""
    if isinstance(tree, ShapeDtype):
        return math.prod(tree.shape) * tree.dtype.itemsize
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(x) for x in tree.values())
    return tree_nbytes(tree)


def run_cell(arch: str, shape_name: str, mesh, out_dir: str,
             mesh_tag: str, *, device="cuda") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": mesh_tag, "status": "ok"}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        _write(out_dir, arch, shape_name, rec)
        return rec
    try:
        t0 = time.perf_counter()
        model, memory, meta = lower_cell(arch, shape_name, mesh,
                                         device=device)
        rec.update(meta)
        rec["time_lower_s"] = round(time.perf_counter() - t0, 2)
        rec["memory"] = memory
        rec["cost"] = {"flops": model["flops"],
                       "bytes_hbm": model["bytes_hbm"]}
        rec["collectives"] = {
            "bytes": model["collective_bytes"],
            "counts": model["collective_counts"],
            "total_bytes": model["collective_total_bytes"],
            "bytes_by_axis": model["collective_bytes_by_axis"]}
        rec["op_counts"] = model["op_counts"]
        if model["warnings"]:
            rec["warnings"] = model["warnings"]
    except Exception as e:  # noqa: BLE001 - record and continue
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _write(out_dir, arch, shape_name, rec)
    return rec


def _write(out_dir, arch, shape_name, rec):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    slim = {k: v for k, v in rec.items() if k != "trace"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--topology", action="store_true",
                    help="use the paper-mapped device order")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors and of the mapping "
                         "pipeline (--topology): cuda or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_topology_mesh)
    mesh_tag = ("pod2" if args.multi_pod else "pod1") + (
        "-topo" if args.topology else "")
    if args.topology:
        backend = "hopper" if args.device == "cuda" else "torch"
        layout = make_topology_mesh(multi_pod=args.multi_pod,
                                    device=args.device,
                                    score_backend=backend)
    else:
        layout = make_production_mesh(multi_pod=args.multi_pod)
    out_dir = args.out or os.path.abspath(os.path.join(OUT_DIR, mesh_tag))

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    with fake_world(layout.ranks.size):
        if args.device == "cuda":
            torch.cuda.set_device(0)   # rank 0 of the world on card 0
        mesh = device_mesh(layout, args.device)
        for a in archs:
            for s in shapes:
                t0 = time.perf_counter()
                rec = run_cell(a, s, mesh, out_dir, mesh_tag,
                               device=args.device)
                dt = time.perf_counter() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    gb = rec["memory"]["argument_size_in_bytes"] / 2**30
                    coll = rec["collectives"]["total_bytes"] / 2**30
                    extra = (f" args/dev={gb:.2f}GiB coll={coll:.3f}GiB "
                             f"flops={rec['cost']['flops']:.3g}")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                elif status == "skipped":
                    extra = " (" + rec["reason"][:60] + ")"
                print(f"[dryrun {mesh_tag}] {a} x {s}: {status} "
                      f"({dt:.0f}s){extra}", flush=True)
                results.append(rec)
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    er = sum(r["status"] == "error" for r in results)
    print(f"[dryrun {mesh_tag}] done: {ok} ok, {sk} skipped, {er} errors")
    return 1 if er else 0


if __name__ == "__main__":
    raise SystemExit(main())
