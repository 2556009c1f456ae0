"""The port's sharded checkpoints and elastic restore against the
reference package.

Ranks are threads of torch's threaded process group
(``test_torch_sharded_step._on_ranks``), on meshes of ``("data",
"model")``.  The reference's own elastic case (an 8 x 8 ``arange``
sharded on both axes, saved on (2, 4) and restored on (4, 2)) runs in
the port; checkpoints cross between the packages across meshes, the
reference's side in a subprocess of eight fake XLA devices as
``tests/test_train.py``'s ``ELASTIC_SCRIPT`` runs it.  A sharded save
writes the files an unsharded save of the same values writes, each shard
once by one rank; a restore maps each file and copies only its own
slice.  The driver: a job on a (2, 2) mesh that fails after its step-2
checkpoint resumes on (2, 2) bit for bit, and on (4, 1) and on one
device within ``TOL`` of the uninterrupted run.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.meshmap import MeshLayout
from repro_torch.models import init_params
from repro_torch.models.config import ShapeConfig
from repro_torch.models.params import ShapeDtype
from repro_torch.sharding.rules import (PartitionSpec, placements_for,
                                        shard_slices)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.driver import JobConfig, train, train_with_restarts
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import model_shardings, place
from repro_torch.train.tree import tree_items, tree_map
from test_torch_checkpoint_rules import _same_files
from test_torch_sharded_step import LAYOUT, _cfg, _on_ranks
from test_train import ELASTIC_SCRIPT

TOL = 1e-5
ARANGE = np.arange(64, dtype=np.float32).reshape(8, 8)
BOTH = PartitionSpec("data", "model")
STEP2 = "step_000000002"
ENV = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__),
                                               "..", "src"))


def _layout(rows, cols):
    return MeshLayout(np.arange(rows * cols).reshape(rows, cols),
                      ("data", "model"))


def _reference(script, *args):
    """stdout of a reference-package script in a subprocess of eight fake
    XLA devices."""
    r = subprocess.run([sys.executable, "-c", script, *args], env=ENV,
                       capture_output=True, text=True, timeout=240)
    return r.stdout + r.stderr[-2000:]


def _flat(tree):
    """``{"a/b": tensor}``, DTensors gathered."""
    return {"/".join(k): (v.full_tensor() if isinstance(v, DTensor)
                          else v).detach().clone()
            for k, v in tree_items(tree)}


def _arange_on(rows, cols):
    """The reference's elastic leaf, sharded on both axes of a
    (rows, cols) mesh, as every rank's ``{"x": DTensor}``."""
    mesh = _layout(rows, cols).device_mesh("cpu")
    return {"x": distribute_tensor(torch.from_numpy(ARANGE), mesh,
                                   placements_for(BOTH, mesh),
                                   src_data_rank=None)}


def _restore_arange(d, rows, cols):
    """Restore the 8 x 8 leaf of ``d`` onto (rows, cols); per rank
    (local shard, its slice of the array, the gathered tensor)."""
    def rank(r):
        mesh = _layout(rows, cols).device_mesh("cpu")
        out = tckpt.restore(d, 1, {"x": ShapeDtype((8, 8), torch.float32)},
                            shardings={"x": BOTH}, device_mesh=mesh)["x"]
        i, j = mesh.get_coordinate()
        h, w = 8 // rows, 8 // cols
        return (out.to_local().clone(),
                ARANGE[i * h:(i + 1) * h, j * w:(j + 1) * w],
                out.full_tensor())
    return _on_ranks(rank, world=rows * cols)


def _check_arange(results):
    for local, want, full in results:
        assert np.array_equal(local.numpy(), want)
        assert np.array_equal(full.numpy(), ARANGE)


# ---------------------------------------------------------------------------
# (a) the reference's own case, in the port
# ---------------------------------------------------------------------------

def test_reference_elastic_case_in_the_port(tmp_path):
    d = str(tmp_path)
    paths = _on_ranks(lambda r: tckpt.save(d, 1, _arange_on(2, 4)), world=8)
    assert set(paths) == {os.path.join(d, "step_000000001")}
    _check_arange(_restore_arange(d, 4, 2))


def test_dtensor_like_leaves_stand_in_for_shardings(tmp_path):
    """A like-tree of DTensors gives the mesh and the placements (a
    ``Partial`` one taken as replicated)."""
    d = str(tmp_path)
    _on_ranks(lambda r: tckpt.save(d, 1, _arange_on(2, 2)))

    def rank(r):
        mesh = _layout(2, 4).device_mesh("cpu")
        like = DTensor.from_local(torch.zeros(2, 8), mesh,
                                  [Partial(), Shard(0)], run_check=False)
        out = tckpt.restore(d, 1, {"x": like})["x"]
        assert list(out.placements) == [Replicate(), Shard(0)]
        j = mesh.get_coordinate()[1]
        assert np.array_equal(out.to_local().numpy(),
                              ARANGE[2 * j:2 * (j + 1)])
        return out.full_tensor()
    for full in _on_ranks(rank, world=8):
        assert np.array_equal(full.numpy(), ARANGE)


@pytest.mark.parametrize("spec", [
    PartitionSpec(("pod", "data"), "model"), PartitionSpec(None, "data"),
    PartitionSpec("model", ("pod", "data")), PartitionSpec()],
    ids=["pod-major", "one-axis", "two-axes-second-dim", "replicated"])
def test_shard_slices_are_dtensors_own_shards(spec):
    """On a (2, 2, 2) mesh of ``("pod", "data", "model")``: each rank's
    slice is the shard ``distribute_tensor`` keeps, and exactly one rank
    of each distinct shard is its first holder."""
    value = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    layout = MeshLayout(np.arange(8).reshape(2, 2, 2),
                        ("pod", "data", "model"))

    def rank(r):
        mesh = layout.device_mesh("cpu")
        pl = placements_for(spec, mesh)
        idx, first = shard_slices(tuple(value.shape), pl, mesh, "v")
        local = distribute_tensor(value, mesh, pl,
                                  src_data_rank=None).to_local()
        assert torch.equal(value[idx], local)
        return repr(idx), first

    out = _on_ranks(rank, world=8)
    shards = {i for i, _ in out}
    assert sorted(i for i, first in out if first) == sorted(shards)


# ---------------------------------------------------------------------------
# (b) both directions across the packages, across meshes
# ---------------------------------------------------------------------------

def test_port_save_on_2x2_restores_in_the_reference_on_4x2(tmp_path):
    d = str(tmp_path)
    _on_ranks(lambda r: tckpt.save(d, 1, _arange_on(2, 2)))
    assert "RESTORED-ELASTIC" in _reference(ELASTIC_SCRIPT, d, "restore")


@pytest.fixture(scope="module")
def reference_save(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("reference_elastic"))
    assert "SAVED" in _reference(ELASTIC_SCRIPT, d, "save")
    return d


@pytest.mark.parametrize("rows,cols", [(4, 2), (2, 2)])
def test_reference_save_on_2x4_restores_in_the_port(reference_save, rows,
                                                    cols):
    _check_arange(_restore_arange(reference_save, rows, cols))


# ---------------------------------------------------------------------------
# (c) a sharded save writes the unsharded save's bytes, each shard once
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps ``np.lib.format.open_memmap`` (writes) or ``np.load``
    (reads): every file opened, as ``(rank, file, mmap_mode)`` in
    ``opened``, and every slice a rank copies, as ``(rank, file,
    mmap_mode or "write", index, shape)`` in ``calls``."""

    def __init__(self, fn):
        self.fn, self.lock = fn, threading.Lock()
        self.opened, self.calls = [], []

    def _note(self, to, *entry):
        rank = dist.get_rank() if dist.is_initialized() else None
        with self.lock:
            to.append((rank, *entry))

    def __call__(self, file, *args, **kwargs):
        rec, name = self, os.path.basename(str(file))
        self._note(self.opened, name, kwargs.get("mmap_mode"))
        out = self.fn(file, *args, **kwargs)
        if kwargs.get("mode") == "w+":
            return out   # rank 0 creating the file

        class Proxy:
            shape, dtype = out.shape, out.dtype

            def __getitem__(self, idx):
                part = out[idx]
                rec._note(rec.calls, name, kwargs.get("mmap_mode"), idx,
                          part.shape)
                return part

            def __setitem__(self, idx, value):
                rec._note(rec.calls, name, "write", idx, np.shape(value))
                out[idx] = value

            def flush(self):
                out.flush()
        return Proxy()


def _placed_tree(name, dtype, mesh):
    """Every rank's (params placed on ``mesh``, a 0-d step, a plain
    leaf): the parameters of a reduced config cast to ``dtype``."""
    cfg = _cfg(name)
    params = tree_map(lambda p: p.to(getattr(torch, dtype)),
                      init_params(cfg, 3, device="cpu"))
    return {"params": place(params, model_shardings(cfg, mesh)[0], mesh),
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "plain": torch.linspace(-1, 1, 12).reshape(3, 4)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["dense-gqa", "moe-unsplit-experts"])
def test_sharded_save_is_the_unsharded_save(tmp_path, monkeypatch, name,
                                            dtype):
    writes = _Recorder(np.lib.format.open_memmap)
    monkeypatch.setattr(np.lib.format, "open_memmap", writes)
    sharded, whole = str(tmp_path / "sharded"), str(tmp_path / "whole")

    def rank(r):
        mesh = LAYOUT.device_mesh("cpu")
        tree = _placed_tree(name, dtype, mesh)
        tckpt.save(sharded, 5, tree)
        return {"/".join(k): (list(v.placements), tuple(v.shape),
                              tuple(v.to_local().shape))
                for k, v in tree_items(tree) if isinstance(v, DTensor)}, \
            _flat(tree)

    (leaves, values), *_ = _on_ranks(rank)
    tckpt.save(whole, 5, values)
    _same_files(os.path.join(sharded, "step_000000005"),
                os.path.join(whole, "step_000000005"))
    if dtype == "bfloat16":
        with open(os.path.join(whole, "step_000000005",
                               "manifest.json")) as f:
            assert all(leaf["raw"] for leaf in json.load(f)["leaves"]
                       if leaf["key"].startswith("params/"))
    files = {k: f"leaf_{i:05d}.npy" for i, k in enumerate(values)}
    by_file: dict = {}
    for rank_, fname, mode, idx, shape in writes.calls:
        assert mode == "write"
        by_file.setdefault(fname, []).append((rank_, idx, shape))
    split = 0
    for key, (pl, shape, local) in leaves.items():
        got = by_file.pop(files[key])
        shards = int(np.prod([LAYOUT.ranks.shape[m] for m, p in enumerate(pl)
                              if isinstance(p, Shard)]))
        split += shards > 1
        assert len(got) == shards, key              # each shard once
        assert len({repr(i) for _, i, _ in got}) == shards, key
        assert len({r for r, _, _ in got}) == shards, key
        for _, _, s in got:                          # no more than a shard
            assert tuple(s[:len(local)]) == local, (key, s, local)
    assert split >= 3
    assert sorted(by_file) == [files["opt/plain"], files["opt/step"]]
    assert all(r == 0 for w in by_file.values() for r, _, _ in w)


def test_partial_leaf_is_reduced_before_it_is_written(tmp_path):
    d = str(tmp_path)
    value = torch.arange(16, dtype=torch.float32).reshape(4, 4)

    def rank(r):
        mesh = LAYOUT.device_mesh("cpu")
        i, j = mesh.get_coordinate()
        # the data ranks' parts sum to the value; the model axis splits
        # its rows
        part = value[j * 2:(j + 1) * 2] * (0.25 if i == 0 else 0.75)
        x = DTensor.from_local(part, mesh, [Partial(), Shard(0)],
                               run_check=False)
        tckpt.save(d, 1, {"x": x})
    _on_ranks(rank)
    back = tckpt.restore(d, 1, {"x": value}, device="cpu")["x"]
    assert torch.equal(back, value)


# ---------------------------------------------------------------------------
# (d) a restore maps each file and copies only its own slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_reads_only_its_slice(tmp_path, monkeypatch, dtype):
    d = str(tmp_path)
    cfg = _cfg("dense-gqa")
    want = tree_map(lambda p: p.to(getattr(torch, dtype)),
                    init_params(cfg, 3, device="cpu"))
    tckpt.save(d, 2, {"params": want})
    reads = _Recorder(np.load)
    monkeypatch.setattr(np, "load", reads)
    layout = _layout(4, 1)

    def rank(r):
        mesh = layout.device_mesh("cpu")
        specs = model_shardings(cfg, mesh)[0]
        like = {"params": tree_map(lambda p: ShapeDtype(tuple(p.shape),
                                                        p.dtype), want)}
        out = tckpt.restore(d, 2, like, shardings={"params": specs},
                            device_mesh=mesh)
        for (k, v), (_, w) in zip(tree_items(out), tree_items(
                {"params": want})):
            idx, _ = shard_slices(tuple(w.shape), v.placements, mesh)
            assert v.dtype == w.dtype and torch.equal(v.to_local(), w[idx])
        return {"/".join(k[1:]): (list(v.placements), tuple(v.shape))
                for k, v in tree_items(out)}

    placements = _on_ranks(rank)[0]
    names = {f"leaf_{i:05d}.npy": k for i, k in enumerate(placements)}
    # one map a rank a leaf, one slice copied from each
    assert sorted(reads.opened) == sorted(
        (r, f, "r") for r in range(4) for f in names)
    assert sorted((r, f) for r, f, *_ in reads.calls) == sorted(
        (r, f) for r in range(4) for f in names)
    item = 2 if dtype == "bfloat16" else 1     # the raw bytes' axis
    sharded = 0
    for r, fname, mode, idx, shape in reads.calls:
        assert mode == "r"
        pl, full = placements[names[fname]]
        shards = int(np.prod([layout.ranks.shape[m] for m, p in
                              enumerate(pl) if isinstance(p, Shard)]))
        sharded += shards > 1
        assert int(np.prod(shape)) * shards == int(np.prod(full)) * item, \
            (names[fname], shape)
    assert sharded >= 4 * 3


# ---------------------------------------------------------------------------
# (e) the driver: fail on (2, 2), resume on (2, 2), (4, 1), one device
# ---------------------------------------------------------------------------

OPT = OptConfig(warmup_steps=1)
SHAPE = ShapeConfig("t", "train", 16, 4)


def _job(d="", **kw):
    return JobConfig(steps=4, ckpt_dir=d, ckpt_every=2, log_every=1, **kw)


def _run(fn, layout):
    """``fn(mesh, log)`` on every rank of ``layout`` (or once, with no
    mesh); rank 0's (history with gathered params, log lines)."""
    def one(r=0):
        torch.set_num_threads(1)
        logs = []
        h = fn(layout, logs.append)
        return dict(h, params=_flat(h["params"])), logs
    if layout is None:
        return one()
    return _on_ranks(one, world=layout.ranks.size)[0]


@pytest.fixture(scope="module")
def uninterrupted():
    return _run(lambda m, log: train(_cfg("dense-gqa"), OPT, _job(), m,
                                     shape=SHAPE, log=log, device="cpu"),
                LAYOUT)[0]


@pytest.fixture(scope="module")
def failed_on_2x2(tmp_path_factory):
    """A (2, 2) job that fails at step 3 after its step-2 checkpoint and
    restarts from it; the directory then holds steps 2 and 4."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    h, logs = _run(lambda m, log: train_with_restarts(
        _cfg("dense-gqa"), OPT, _job(d, fail_at_step=3), m, shape=SHAPE,
        log=log, device="cpu"), LAYOUT)
    assert tckpt.all_steps(d) == [2, 4]
    return h, logs, d


def test_job_fails_and_resumes_on_the_same_mesh_bit_for_bit(
        uninterrupted, failed_on_2x2):
    h, logs, _ = failed_on_2x2
    assert "[train] failure: simulated failure at step 3; restart 1" in logs
    assert "[train] resumed from step 2" in logs
    assert h["steps"] == [2, 3]
    assert h["loss"] == uninterrupted["loss"][2:]
    for k, w in uninterrupted["params"].items():
        assert torch.equal(h["params"][k], w), k


@pytest.mark.parametrize("mesh", ["4x1", "one-device"])
def test_job_saved_on_2x2_resumes_on_another_mesh(uninterrupted,
                                                  failed_on_2x2, tmp_path,
                                                  mesh):
    d = str(tmp_path)
    shutil.copytree(os.path.join(failed_on_2x2[2], STEP2),
                    os.path.join(d, STEP2))
    layout = _layout(4, 1) if mesh == "4x1" else None
    h, logs = _run(lambda m, log: train(_cfg("dense-gqa"), OPT, _job(d), m,
                                        shape=SHAPE, log=log, device="cpu"),
                   layout)
    assert logs[0] == "[train] resumed from step 2"
    assert h["steps"] == [2, 3]
    for got, want in zip(h["loss"], uninterrupted["loss"][2:]):
        assert abs(got - want) <= TOL * abs(want)
    for k, w in uninterrupted["params"].items():
        scale = float(w.abs().max())
        err = float((h["params"][k] - w).abs().max())
        assert err <= TOL * scale, (k, err, scale)
    assert tckpt.latest_step(d) == 4


def test_train_on_a_mesh_checkpoints(tmp_path):
    """A sharded job with a checkpoint directory: before the sharded save
    its first checkpoint raised (``.numpy()`` of a DTensor)."""
    d = str(tmp_path)
    h, _ = _run(lambda m, log: train(
        _cfg("dense-gqa"), OPT, JobConfig(steps=2, ckpt_every=1,
                                          ckpt_dir=d, log_every=0),
        m, shape=SHAPE, log=log, device="cpu"), LAYOUT)
    assert tckpt.all_steps(d) == [1, 2]
    like = {k: ShapeDtype(tuple(v.shape), v.dtype)
            for k, v in h["params"].items()}
    back = tckpt.restore(d, 2, {"params": like, "opt": {}}, device="cpu")
    for k, v in h["params"].items():
        assert torch.equal(back["params"][k], v), k


# ---------------------------------------------------------------------------
# (f) errors
# ---------------------------------------------------------------------------

NOT_DIVIDING = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
a = np.arange(30, dtype=np.float32).reshape(6, 5)
try:
    jax.make_array_from_callback(
        a.shape, NamedSharding(mesh, PartitionSpec("data", "model")),
        lambda idx: a[idx])
except ValueError as e:
    print("VALUE-ERROR", e)
"""


def test_a_placement_that_does_not_divide_raises_as_in_the_reference(
        tmp_path):
    assert "VALUE-ERROR" in _reference(NOT_DIVIDING)
    d = str(tmp_path)
    tckpt.save(d, 1, {"a": torch.arange(30.0).reshape(6, 5)})

    def rank(r):
        mesh = _layout(4, 2).device_mesh("cpu")
        with pytest.raises(ValueError, match="a of shape .6, 5.: dim 0"):
            tckpt.restore(d, 1, {"a": ShapeDtype((6, 5), torch.float32)},
                          shardings={"a": BOTH}, device_mesh=mesh)
        with pytest.raises(ValueError, match="dim 1 .5. does not divide"):
            shard_slices((8, 5), [Replicate(), Shard(1)], mesh, "b")
    _on_ranks(rank, world=8)


def test_missing_leaf_raises_before_any_rank_reads(tmp_path, monkeypatch):
    d = str(tmp_path)
    tckpt.save(d, 1, {"a": torch.arange(8.0)})
    reads = _Recorder(np.load)
    monkeypatch.setattr(np, "load", reads)

    def rank(r):
        mesh = LAYOUT.device_mesh("cpu")
        like = {"a": ShapeDtype((8,), torch.float32),
                "b": ShapeDtype((4,), torch.float32)}
        with pytest.raises(KeyError, match="b"):
            tckpt.restore(d, 1, like, device_mesh=mesh,
                          shardings={"a": PartitionSpec("data"),
                                     "b": PartitionSpec()})
    _on_ranks(rank)
    assert reads.opened == []


def test_shardings_without_a_mesh_raise(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 1, {"a": torch.arange(8.0), "b": torch.arange(8.0)})
    with pytest.raises(ValueError, match="a: restore.shardings=. needs"):
        tckpt.restore(d, 1, {"a": ShapeDtype((8,), torch.float32)},
                      shardings={"a": PartitionSpec()})
    with pytest.raises(ValueError, match="1 shardings for 2 leaves"):
        tckpt.restore(d, 1, {"a": ShapeDtype((8,), torch.float32),
                             "b": ShapeDtype((8,), torch.float32)},
                      shardings={"a": PartitionSpec()})
