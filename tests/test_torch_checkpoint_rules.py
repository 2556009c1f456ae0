"""The port's checkpoints and sharding rules against the reference
package.

Checkpoints: the counterparts of ``tests/test_train.py``'s roundtrip,
prune and atomicity tests, and the on-disk format across the two
packages — a tree of float32, int32 and bfloat16 leaves saved by either
is restored by the other with the same bits, and both write the same
``manifest.json`` and ``.npy`` bytes.  Sharding rules: ``spec_for_axes``
over every leaf of every reduced config's parameters on stand-in meshes
(the reference reads only ``axis_names`` and ``devices.shape``), and the
parameter / optimizer sharding trees on a real one-device mesh.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCHS
from repro.models import config as RC
from repro.models import params as RP
from repro.models import transformer as RT
from repro.sharding import rules as rrules
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro.train import step as rstep
from repro_torch import compat
from repro_torch.meshmap.device_mesh import MeshLayout
from repro_torch.models import params_spec, tree_abstract, tree_axes
from repro_torch.models.params import spec_leaves
from repro_torch.sharding import rules as trules
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.tree import tree_items


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_prune():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
        for s in (1, 2, 3, 4, 5):
            tckpt.save(d, s, tree, keep=2)
        assert tckpt.all_steps(d) == [4, 5]
        back = tckpt.restore(d, 5, tree, device="cpu")
        assert torch.equal(back["a"], tree["a"])
        assert back["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(back["b"]["c"], tree["b"]["c"])


def test_checkpoint_atomic_no_partial():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.zeros(3)})
        # simulate a crashed save: a stale .tmp dir must be ignored
        os.makedirs(os.path.join(d, "step_000000002.tmp"))
        assert tckpt.latest_step(d) == 1
        assert tckpt.all_steps(os.path.join(d, "absent")) == []
        assert tckpt.latest_step(os.path.join(d, "absent")) is None
        # a later save of step 2 replaces the stale directory
        tckpt.save(d, 2, {"a": torch.ones(3)})
        assert tckpt.latest_step(d) == 2
        assert not os.path.exists(os.path.join(d, "step_000000002.tmp"))


def test_restore_raises_on_missing_leaves_and_casts_to_the_like_tree():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.arange(4, dtype=torch.float32)})
        with pytest.raises(KeyError, match="b"):
            tckpt.restore(d, 1, {"a": torch.zeros(4), "b": torch.zeros(1)},
                          device="cpu")
        back = tckpt.restore(d, 1, {"a": torch.zeros(4, dtype=torch.int64)},
                             device="cpu")
        assert back["a"].dtype == torch.int64
        assert back["a"].tolist() == [0, 1, 2, 3]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA"):
                tckpt.restore(d, 1, {"a": torch.zeros(4)})


def _mixed_tree(seed=0):
    """numpy values of a tree with float32, int32 and bfloat16 leaves (the
    bfloat16 values are float32 ones that bfloat16 holds exactly), a 0-d
    int32 step and a float32 scalar (the reference cannot store a 0-d
    bfloat16 leaf: numpy will not view a 0-d array as bytes)."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16), np.float32)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "emb": bf,
                       "norm": np.float32(0.5) * np.ones(5, np.float32)},
            "opt": {"step": np.int32(7),
                    "idx": rng.integers(-9, 9, (2, 3)).astype(np.int32),
                    "s": np.float32(-1.25)}}


BF16 = ("emb",)


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in BF16 else None)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)).to(
                torch.bfloat16 if k in BF16 else None)
            for k, v in tree.items()}


def _same_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_cross_between_packages(direction):
    tree = _mixed_tree()
    jt, tt = _jax_tree(tree), _torch_tree(tree)
    with tempfile.TemporaryDirectory() as d:
        rdir, tdir = os.path.join(d, "ref"), os.path.join(d, "port")
        rckpt.save(rdir, 3, jt)
        tckpt.save(tdir, 3, tt)
        # the same manifest and the same .npy bytes
        _same_files(os.path.join(rdir, "step_000000003"),
                    os.path.join(tdir, "step_000000003"))
        if direction == "reference_to_port":
            back = tckpt.restore(rdir, 3, tt, device="cpu")
            for (path, got), (_, want) in zip(tree_items(back),
                                              tree_items(tt)):
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    path
        else:
            back = rckpt.restore(tdir, 3, jt)
            for path, want in tree_items(jt):
                got = back
                for k in path:
                    got = got[k]
                assert got.dtype == want.dtype, path
                assert np.array_equal(
                    np.asarray(got).reshape(-1).view(np.uint8),
                    np.asarray(want).reshape(-1).view(np.uint8)), path


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class StandIn:
    """A mesh as the reference's rules read it: axis names and a device
    array of the axis sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _ref_leaves(ref_cfg):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        RT.params_spec(ref_cfg), is_leaf=RP.is_spec)
    return {tuple(str(k.key) for k in path): p for path, p in leaves}


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("with_shapes", [True, False])
def test_spec_for_axes_matches_reference_on_every_param(shape, names,
                                                        with_shapes):
    """Every leaf of every reduced config (and of two full configs whose
    dims divide otherwise), with the dims (dropping mappings that do not
    divide) and without."""
    mesh = StandIn(shape, names)
    cfgs = [RC.reduced(ref_get_config(a)) for a in ARCHS]
    cfgs += [ref_get_config("yi_6b"), ref_get_config("mixtral_8x22b")]
    seen_drop = False
    for ref_cfg in cfgs:
        ref_leaves = _ref_leaves(ref_cfg)
        port = dict(spec_leaves(params_spec(compat.model_config(ref_cfg))))
        assert sorted(port) == sorted(ref_leaves)
        for path, p in port.items():
            dims = tuple(int(s) for s in p.shape) if with_shapes else None
            want = rrules.spec_for_axes(p.axes, rrules.DEFAULT_RULES, mesh,
                                        dims)
            got = trules.spec_for_axes(p.axes, trules.DEFAULT_RULES, mesh,
                                       dims)
            assert isinstance(got, trules.PartitionSpec)
            assert tuple(got) == tuple(want), (ref_cfg.name, path)
            if with_shapes and tuple(got) != tuple(
                    trules.spec_for_axes(p.axes, trules.DEFAULT_RULES,
                                         mesh)):
                seen_drop = True
    if with_shapes and shape[-1] > 1:
        assert seen_drop   # some dim did not divide and its mapping went


def test_activation_axes_and_custom_rules_match_reference():
    mesh = StandIn((2, 16, 16), ("pod", "data", "model"))
    cases = [(("batch", "act_seq", "act_embed"), (64, 4096, 4096)),
             (("batch", "sp_seq", "act_embed"), (2, 48, 64)),
             (("kv_batch", "kv_seq", "act_kv_heads", None), (6, 32, 8, 128)),
             (("batch", "act_heads", "sp_seq", None), (4, 24, 512, 64)),
             (("experts", "embed", "mlp"), (8, 6144, 16384)),
             (("", None, "unknown"), (3, 4, 5))]
    custom = dict(rrules.DEFAULT_RULES, embed="model", mlp=None,
                  batch=("data", "pod"))
    for axes, dims in cases:
        for rules in (rrules.DEFAULT_RULES, custom):
            for d in (dims, None):
                assert tuple(trules.spec_for_axes(axes, rules, mesh, d)) == \
                    tuple(rrules.spec_for_axes(axes, rules, mesh, d)), \
                    (axes, d)
    assert trules.DEFAULT_RULES == rrules.DEFAULT_RULES


def test_mesh_layout_is_a_mesh_for_the_rules():
    layout = MeshLayout(np.arange(8).reshape(2, 4), ("data", "model"))
    stand_in = StandIn((2, 4), ("data", "model"))
    for axes, dims in ((("embed", "heads", "head_dim"), (64, 8, 16)),
                       (("vocab", "embed"), (256, 64))):
        assert trules.spec_for_axes(axes, trules.DEFAULT_RULES, layout,
                                    dims) == \
            rrules.spec_for_axes(axes, rrules.DEFAULT_RULES, stand_in, dims)


def test_partition_spec_is_a_tuple_and_logical_is_the_identity():
    spec = trules.PartitionSpec(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model")
    assert repr(spec) == "PartitionSpec(('pod', 'data'), None, 'model')"
    assert trules.PartitionSpec() == ()
    x = torch.ones(2, 3)
    assert trules.logical(x, ("batch", "act_embed")) is x


def _ref_one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x22b", "whisper_small"])
def test_model_and_opt_shardings_match_reference(arch):
    """On a real one-device mesh: the parameter and optimizer sharding
    trees' specs, the abstract trees' shapes and dtypes, and the batch
    specs."""
    ref_cfg = RC.reduced(ref_get_config(arch))
    cfg = compat.model_config(ref_cfg)
    mesh = _ref_one_device_mesh()
    stand_in = StandIn((1, 1), ("data", "model"))
    rsh, rab, raxes = rstep.model_shardings(ref_cfg, mesh)
    tsh, tab, taxes = tstep.model_shardings(cfg, stand_in)
    assert taxes == tree_axes(params_spec(cfg))
    assert tab == tree_abstract(params_spec(cfg), cfg.dtype)
    for path, spec in tree_items(tsh):
        want, ab, ax = rsh, rab, raxes
        for k in path:
            want, ab, ax = want[k], ab[k], ax[k]
        assert tuple(spec) == tuple(want.spec), path
        leaf = tab
        for k in path:
            leaf = leaf[k]
        assert leaf.shape == ab.shape
        assert str(leaf.dtype).removeprefix("torch.") == str(ab.dtype)
    opt = dict(compress_grads=True)
    rosh, roab = rstep.opt_shardings(ropt.OptConfig(**opt), ref_cfg, mesh)
    tosh, toab = tstep.opt_shardings(topt.OptConfig(**opt), cfg, stand_in)
    assert sorted(tosh) == sorted(rosh) == ["err", "m", "step", "v"]
    assert tuple(tosh["step"]) == tuple(rosh["step"].spec)
    for path, spec in tree_items({k: tosh[k] for k in ("m", "v", "err")}):
        want = rosh
        for k in path:
            want = want[k]
        assert tuple(spec) == tuple(want.spec), path
    shape = dataclasses.replace(RC.SHAPES["train_4k"], global_batch=8,
                                seq_len=32)
    rb = rstep.batch_specs(ref_cfg, shape)
    tb = tstep.batch_specs(cfg, shape)
    assert sorted(tb) == sorted(rb)
    for k, w in rb.items():
        assert tb[k].shape == w.shape
        assert str(tb[k].dtype).removeprefix("torch.") == str(w.dtype)
    rbs = rstep.batch_shardings(ref_cfg, shape, mesh)
    tbs = tstep.batch_shardings(cfg, shape, stand_in)
    assert {k: tuple(v) for k, v in tbs.items()} == \
        {k: tuple(v.spec) for k, v in rbs.items()}
    big = StandIn((2, 4), ("data", "model"))
    assert {k: tuple(v) for k, v in tstep.batch_shardings(
        cfg, shape, big).items()} == {
        k: tuple(rrules.spec_for_axes(("batch",), rrules.DEFAULT_RULES, big,
                                      (8,))) + (None,) * (len(v) - 1)
        for k, v in tbs.items()}
