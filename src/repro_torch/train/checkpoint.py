"""Fault-tolerant checkpointing in the reference package's format.

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

``restore`` places every leaf on one ``device``.  The reference's
elastic restore onto another mesh (``shardings=``) needs more than one
card and is not ported.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.device import resolve_device

from .tree import tree_items, tree_unflatten


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


# dtypes numpy holds natively; any other (bfloat16, the float8 types) is
# stored raw, as the reference stores what numpy lacks without ml_dtypes
NUMPY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
                torch.int32, torch.int64, torch.float16, torch.float32,
                torch.float64, torch.complex64, torch.complex128)


def _to_numpy(t: torch.Tensor):
    """(array to store, logical dtype name, raw?) for one leaf."""
    t = t.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in NUMPY_DTYPES:
        return t.numpy(), name, False
    size = t.element_size()
    raw = t.reshape(-1).view(torch.uint8).reshape(tuple(t.shape) + (size,))
    return raw.numpy(), name, True


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, v) in enumerate(tree_items(tree)):
        store, logical_dtype, raw = _to_numpy(v)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), store)
        manifest["leaves"].append(
            {"key": _key(path), "file": fname, "shape": list(v.shape),
             "dtype": logical_dtype, "raw": raw})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep)
    return final


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
    if not leaf.get("raw"):
        return torch.from_numpy(np.array(arr))
    dtype = getattr(torch, leaf["dtype"])
    return torch.from_numpy(np.array(arr).reshape(-1)).view(dtype) \
        .reshape(leaf["shape"])


def restore(ckpt_dir: str, step: int, like_tree, *, device="cuda"):
    """Restore into the structure of ``like_tree`` (tensors or
    ``ShapeDtype``s), every leaf on ``device`` in its like-leaf's dtype."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    items = list(tree_items(like_tree))
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    missing = [_key(p) for p, _ in items if _key(p) not in by_key]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    out = []
    for keys, ref in items:
        leaf = by_key[_key(keys)]
        t = _from_numpy(np.load(os.path.join(path, leaf["file"])), leaf)
        out.append(t.to(device=dev, dtype=getattr(ref, "dtype", t.dtype)))
    return tree_unflatten(like_tree, out)
