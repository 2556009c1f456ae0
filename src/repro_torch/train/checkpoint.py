"""Fault-tolerant checkpointing in the reference package's format, saved
shard by shard from a mesh and restored onto any other (elastic).

The on-disk layout is the reference's ``train/checkpoint.py``, byte for
byte, so either package restores what the other saved:

- One ``.npy`` file per leaf under ``step_<N>.tmp/``, plus a
  ``manifest.json`` recording the flattened key paths (``"/"``-joined,
  keys sorted at every level: jax's order for a dict), shapes, dtypes
  and the saving step.  The directory is atomically renamed to
  ``step_<N>`` when complete — a crash mid-save never corrupts the
  latest checkpoint.
- A leaf whose dtype numpy lacks (bfloat16, the float8 types) is stored
  as its raw bytes, ``uint8`` with a trailing axis of the element size
  and ``"raw": true``; the manifest's dtype restores the view on load.
  The port reads and writes those bytes through ``Tensor.view``, not
  through ``ml_dtypes``.
- ``keep`` old checkpoints are pruned after a successful save.

On a mesh — a tree with ``DTensor`` leaves, or a default process group
of more than one rank — every rank of the default group calls
:func:`save`, and no rank holds a leaf whole.  Rank 0 creates each
leaf's file at the leaf's global shape (``open_memmap``, which writes
the header ``np.save`` writes); after a barrier each rank that is the
first holder of its shard (:func:`~repro_torch.sharding.rules.shard_slices`)
copies that shard into its slice of the file (a ``Partial`` placement
is reduced first; plain leaves are written by rank 0); after another,
rank 0 writes the manifest, renames and prunes.  The files are those an
unsharded save of the same values writes.  The directory must lie on a
filesystem every rank sees, as the reference's single controller
assumes.

:func:`restore` with ``shardings=`` (partition specs, the trees of
``train.step.model_shardings`` / ``opt_shardings``) on a
``device_mesh``, or into a like-tree of DTensors, is the reference's
elastic restore: each rank maps each leaf's file
(``np.load(mmap_mode="r")``), reads only its own slice and builds its
DTensor from it, with nothing communicated — onto any mesh, whichever
mesh saved.  Otherwise every leaf is placed whole on one ``device``.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
from torch.distributed.tensor import Partial, Replicate

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import (is_dtensor, placed, placements_for,
                                        shard_slices)

from .tree import tree_items, tree_unflatten


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


# dtypes numpy holds natively; any other (bfloat16, the float8 types) is
# stored raw, as the reference stores what numpy lacks without ml_dtypes
NUMPY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
                torch.int32, torch.int64, torch.float16, torch.float32,
                torch.float64, torch.complex64, torch.complex128)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The array stored for ``t`` (raw bytes where numpy lacks its
    dtype)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in NUMPY_DTYPES:
        return t.numpy()
    size = t.element_size()
    return t.reshape(-1).view(torch.uint8).reshape(
        tuple(t.shape) + (size,)).numpy()


def _entry(key: str, fname: str, t: torch.Tensor) -> dict:
    """The manifest's record of leaf ``t`` (global shape for a
    DTensor)."""
    return {"key": key, "file": fname, "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
            "raw": t.dtype not in NUMPY_DTYPES}


def _process_group():
    """``torch.distributed`` when its default group has more than one
    rank, else None."""
    import torch.distributed as dist
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return dist
    return None


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` as ``ckpt_dir/step_<step>`` and prune to ``keep``;
    returns the directory.  On a mesh every rank calls it (module
    docstring) and every rank gets the same path."""
    items = list(tree_items(tree))
    dist = _process_group()
    sharded = dist is not None or any(is_dtensor(v) for _, v in items)
    rank = 0 if dist is None else dist.get_rank()
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    files = [os.path.join(tmp, f"leaf_{i:05d}.npy")
             for i in range(len(items))]
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for f, (_, v) in zip(files, items):
            if not sharded:
                np.save(f, _to_numpy(v))
                continue
            dtype, tail = _stored_as(v.dtype)
            np.lib.format.open_memmap(f, mode="w+", dtype=dtype,
                                      shape=tuple(v.shape) + tail).flush()
    if sharded:
        _barrier(dist)
        for f, (path, v) in zip(files, items):
            _write_shard(f, _key(path), v, rank)
        _barrier(dist)
    if rank == 0:
        manifest = {"step": step, "leaves": [
            _entry(_key(path), os.path.basename(f), v)
            for f, (path, v) in zip(files, items)]}
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _prune(ckpt_dir, keep)
    _barrier(dist)
    return final


def _write_shard(file: str, key: str, v, rank: int) -> None:
    """Copy this rank's shard of leaf ``v`` into its slice of ``file``
    where this rank is the shard's first holder (rank 0 for a plain
    leaf)."""
    if is_dtensor(v):
        v = _reduce_partial(v)
        idx, first = shard_slices(v.shape, v.placements, v.device_mesh, key)
        if not first:
            return
        v = v.to_local()
    elif rank == 0:
        idx = ()
    else:
        return
    store = _to_numpy(v)
    if store.size:
        out = np.lib.format.open_memmap(file, mode="r+")
        out[idx] = store
        out.flush()
        del out


def _stored_as(dtype: torch.dtype) -> tuple:
    """(numpy dtype, trailing axis) of a leaf of ``dtype`` on disk."""
    if dtype in NUMPY_DTYPES:
        return torch.empty(0, dtype=dtype).numpy().dtype, ()
    return np.dtype(np.uint8), (dtype.itemsize,)


def _reduce_partial(x):
    """``x`` with each ``Partial`` mesh dim reduced to ``Replicate``."""
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def _barrier(dist) -> None:
    if dist is not None:
        dist.barrier()


def _prune(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, leaf: dict) -> torch.Tensor:
    """A tensor of the values of ``arr``, viewed as the manifest's dtype
    where raw; a slice of a memory map is copied out of the map."""
    if not (isinstance(arr, np.ndarray) and arr.flags.owndata
            and arr.flags.writeable):
        arr = np.array(arr)
    if not leaf.get("raw"):
        return torch.from_numpy(arr)
    dtype = getattr(torch, leaf["dtype"])
    return torch.from_numpy(arr).view(dtype).reshape(arr.shape[:-1])


def restore(ckpt_dir: str, step: int, like_tree, *, shardings=None,
            device_mesh=None, device="cuda"):
    """Restore into the structure of ``like_tree`` (tensors, DTensors or
    ``ShapeDtype``s), every leaf in its like-leaf's dtype.

    ``shardings``: a matching tree of partition specs; each leaf is built
    shard by shard as a DTensor on ``device_mesh`` (or the mesh of its
    DTensor like-leaf), each rank reading only its own slice — the
    elastic restore, onto any mesh.  Without ``shardings``, a DTensor
    like-leaf gives its mesh and placements (a ``Partial`` one taken as
    replicated), and any other leaf is placed whole on ``device``.
    Every rank of the mesh calls it.  A leaf missing from the
    checkpoint raises ``KeyError`` before anything is read."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    items = list(tree_items(like_tree))
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    missing = [_key(p) for p, _ in items if _key(p) not in by_key]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    specs = [None] * len(items) if shardings is None else \
        [s for _, s in tree_items(shardings)]
    if len(specs) != len(items):
        raise ValueError(f"{len(specs)} shardings for {len(items)} leaves")
    dev = None
    out = []
    for (keys, ref), spec in zip(items, specs):
        leaf = by_key[_key(keys)]
        file = os.path.join(path, leaf["file"])
        dtype = getattr(ref, "dtype", None)
        if spec is None and not is_dtensor(ref):
            dev = dev or resolve_device(device)
            t = _from_numpy(np.load(file), leaf)
            out.append(t.to(device=dev, dtype=dtype or t.dtype))
            continue
        if spec is None:
            mesh, pl = ref.device_mesh, [
                Replicate() if isinstance(p, Partial) else p
                for p in ref.placements]
        else:
            mesh = device_mesh or getattr(ref, "device_mesh", None)
            if mesh is None:
                raise ValueError(f"{_key(keys)}: restore(shardings=) needs "
                                 "device_mesh= or a DTensor like-leaf")
            pl = placements_for(spec, mesh)
        shape = tuple(leaf["shape"])
        idx, _ = shard_slices(shape, pl, mesh, _key(keys))
        t = _from_numpy(np.load(file, mmap_mode="r")[idx], leaf)
        t = t.to(device=mesh.device_type, dtype=dtype or t.dtype)
        out.append(placed(t, shape, pl, mesh))
    return tree_unflatten(like_tree, out)
