"""The port's dry run (``launch/dryrun.py``) against the reference's.

- The zamba2-1.2b cell of ``tests/test_system.py``'s dry-run test (a
  ``tiny_train`` shape on a 1x1 mesh): the port's argument bytes equal
  the reference's ``compiled.memory_analysis()`` to the byte.
- A tiny train, prefill and decode cell of every family (reduced
  configs) on a (2, 2) mesh of a fake world of four: status ``ok``,
  FLOPs, HBM bytes and argument bytes counted, and every train cell
  reducing gradients over the data axis.
- Every one of the ten architectures at full width on a (16, 16) layout,
  shapes only: rank 0's parameter bytes as the DTensor placements give
  them equal the shard shapes of the reference's own ``spec_for_axes``.

Each test initialises the fake process group itself and destroys it on
teardown.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.models.config as ref_mc
from repro.launch import dryrun as ref_dryrun
from repro.models import params_spec as ref_params_spec
from repro.models import tree_abstract as ref_tree_abstract
from repro.models import tree_axes as ref_tree_axes
from repro.sharding.rules import DEFAULT_RULES as REF_RULES
from repro.sharding.rules import spec_for_axes as ref_spec_for_axes
import repro_torch.models.config as mc
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.meshmap import MeshLayout
from repro_torch.models import reduced
from repro_torch.sharding.rules import local_shape, placements_for
from repro_torch.train.step import model_shardings
from repro_torch.train.tree import tree_items


def _layout(*shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return MeshLayout(np.arange(math.prod(shape)).reshape(shape), names)


@pytest.fixture
def world():
    """A fake world of the size the test asks for, destroyed after it."""
    stack = []

    def make(n):
        ctx = dryrun.fake_world(n)
        ctx.__enter__()
        stack.append(ctx)
    yield make
    for ctx in stack:
        ctx.__exit__(None, None, None)


def test_tiny_cell_argument_bytes_equal_the_reference_memory_analysis(
        tmp_path, monkeypatch, world):
    tiny = ("tiny_train", "train", 32, 4)
    monkeypatch.setitem(mc.SHAPES, "tiny_train", mc.ShapeConfig(*tiny))
    monkeypatch.setitem(ref_mc.SHAPES, "tiny_train", ref_mc.ShapeConfig(*tiny))
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    want = ref_dryrun.run_cell("zamba2_1p2b", "tiny_train", ref_mesh,
                               str(tmp_path / "ref"), "test")
    assert want["status"] == "ok", want.get("error")
    world(1)
    got = dryrun.run_cell("zamba2_1p2b", "tiny_train", _layout(1, 1),
                          str(tmp_path / "port"), "test", device="cpu")
    assert got["status"] == "ok", got.get("error")
    assert got["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    assert got["cost"]["flops"] > 0 and got["cost"]["bytes_hbm"] > 0
    assert got["params"] == want["params"]
    assert (tmp_path / "port" / "zamba2_1p2b__tiny_train.json").exists()


FAMILY_ARCHS = ("yi_6b", "mixtral_8x22b", "mamba2_2p7b", "zamba2_1p2b",
                "whisper_small", "internvl2_26b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tiny_cells_of_every_family_on_a_2x2_mesh(arch, tmp_path,
                                                  monkeypatch, world):
    cfg = reduced(get_config(arch), num_layers=2)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    for name, kind in (("tiny_train", "train"), ("tiny_prefill", "prefill"),
                       ("tiny_decode", "decode")):
        monkeypatch.setitem(mc.SHAPES, name,
                            mc.ShapeConfig(name, kind, 32, 4))
    world(4)
    layout = _layout(2, 2)
    for name in ("tiny_train", "tiny_prefill", "tiny_decode"):
        rec = dryrun.run_cell(arch, name, layout, str(tmp_path), "2x2",
                              device="cpu")
        assert rec["status"] == "ok", (name, rec.get("error"))
        assert rec["mesh_shape"] == [2, 2]
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_hbm"] > 0
        assert rec["memory"]["argument_size_in_bytes"] > 0
        if name == "tiny_train":
            by_axis = rec["collectives"]["bytes_by_axis"]
            assert by_axis.get("data", 0) > 0, by_axis
            assert rec["collectives"]["counts"]["reduce-scatter"] + \
                rec["collectives"]["counts"]["all-reduce"] > 0


class _StandIn:
    """What the reference's ``spec_for_axes`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_shards_equal_the_reference_specs(arch, world):
    world(256)
    layout = _layout(16, 16)
    mesh = dryrun.device_mesh(layout, "cpu")
    cfg = get_config(arch)
    spec_tree, abstract, _ = model_shardings(cfg, mesh)
    got = 0
    for (path, spec), (_, ab) in zip(tree_items(spec_tree),
                                     tree_items(abstract)):
        shard = local_shape(ab.shape, placements_for(spec, mesh), mesh)
        got += math.prod(shard) * ab.dtype.itemsize

    ref_cfg = ref_dryrun.get_config(arch)
    stand_in = _StandIn((16, 16), ("data", "model"))
    leaves = jax.tree.leaves(ref_tree_abstract(ref_params_spec(ref_cfg),
                                               ref_cfg.dtype))
    axes = jax.tree.leaves(ref_tree_axes(ref_params_spec(ref_cfg)),
                           is_leaf=lambda x: isinstance(x, tuple))
    want = 0
    for ab, ax in zip(leaves, axes):
        spec = ref_spec_for_axes(ax, REF_RULES, stand_in, ab.shape)
        dims = list(ab.shape)
        for i, entry in enumerate(spec):
            for name in ((entry,) if isinstance(entry, str)
                         else entry or ()):
                dims[i] //= 16
        want += math.prod(dims) * ab.dtype.itemsize
    assert got == want
    assert torch.distributed.get_world_size() == 256


def _active_params(cfg, layers_only=False) -> int:
    """Parameters a token meets: every leaf but the experts' weights, and
    ``experts_per_tok`` of the ``num_experts`` experts' weights (the
    layers' alone with ``layers_only``)."""
    spec = model_shardings(cfg, _StandIn((1, 1), ("data", "model")))[1]
    total = expert = 0
    for path, ab in tree_items(spec):
        if layers_only and path[0] != "layers":
            continue
        n = math.prod(ab.shape)
        total += n
        if path[-1] in ("wi", "wg", "wo") and cfg.num_experts:
            expert += n
    return total - expert + expert * cfg.experts_per_tok // cfg.num_experts


@pytest.mark.parametrize("arch", ("mixtral_8x22b", "grok_1_314b"))
@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_moe_cell_flops_near_the_active_parameter_count(
        arch, kind, tmp_path, monkeypatch, world):
    """Two layers at full width, a batch of 16 sequences of 256 on a
    (16, 16) mesh: 8 experts do not divide the model axis of 16, so the
    experts' products split over their hidden width.  Rank 0's FLOPs
    are held between 1 and 2 times 6 (train) or 2 (prefill, the layers'
    parameters: it unembeds the last position only) times the active
    parameters times tokens / 256: remat's recomputed forward (4/3), the
    capacity factor's spare expert slots (1.25) and attention stay well
    inside it; experts computed whole on every rank of the model axis
    would come to 10 times or more."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    monkeypatch.setitem(mc.SHAPES, "moe_cell",
                        mc.ShapeConfig("moe_cell", kind, 256, 16))
    world(256)
    rec = dryrun.run_cell(arch, "moe_cell", _layout(16, 16), str(tmp_path),
                          "16x16", device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    per_token = 6 if kind == "train" else 2
    model = per_token * _active_params(cfg, kind == "prefill") * 16
    ratio = rec["cost"]["flops"] / model
    assert 1.0 <= ratio <= 2.0, ratio
