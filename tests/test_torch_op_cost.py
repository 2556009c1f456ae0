"""The port's op-level cost counter (``launch/op_cost.py``), as
``tests/test_hlo_cost.py`` holds the reference's HLO cost model: exact
matrix-product FLOPs, an eager loop counted every time it runs, a
collective by type and bytes on a fake (2, 2) mesh, DTensor's shape
inference left out (and a torch that renames it refused), the two
kernels by
their ``kernel.work`` formulas, and a 2-layer dense model's loss against
the reference's ``analyze`` of the same loss compiled (within 10 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze
from repro.models import ModelConfig as RefConfig
from repro.models import loss_fn as ref_loss_fn
from repro.models import params_spec as ref_params_spec
from repro.models import tree_abstract as ref_tree_abstract
from repro_torch import compat
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.op_cost import COLLECTIVES, CostCounter
from repro_torch.models import init_params, loss_fn


def _randn(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def test_matmul_flops_exact():
    n = 256
    a, b = _randn(n, n), _randn(n, n, seed=1)
    with CostCounter() as c:
        a @ b
    r = c.result()
    assert r["flops"] == 2 * n ** 3
    assert r["bytes_hbm"] == 3 * n * n * 4
    assert r["op_counts"] == {"aten.mm": 1}


def test_batched_einsum_flops_exact():
    a, b = _randn(8, 64, 32), _randn(8, 32, 16, seed=1)
    with CostCounter() as c:
        torch.einsum("bik,bkj->bij", a, b)
    assert c.result()["flops"] == 8 * 2 * 64 * 32 * 16


def test_eager_loop_counts_every_pass():
    """The counterpart of the reference's scan test: an eager loop runs
    its body ten times, and each run is counted."""
    n, t = 128, 10
    x, ws = _randn(n, n), _randn(t, n, n, seed=1)
    with CostCounter() as c:
        for w in ws:
            x = x @ w
    r = c.result()
    assert r["flops"] == t * 2 * n ** 3
    assert r["op_counts"]["aten.mm"] == t


def test_views_are_free_and_temps_are_tracked():
    x = _randn(64, 64)
    with CostCounter() as c:
        y = x.reshape(-1).view(64, 64).t()
        z = torch.exp(y)
        del z
        w = y + 1.0
    r = c.result()
    assert r["flops"] == 4 * 64 * 64 + 64 * 64
    assert r["bytes_hbm"] == 2 * (2 * 64 * 64 * 4)
    assert r["temp_peak_bytes"] == 64 * 64 * 4   # exp freed before add
    del w


@pytest.fixture
def fake_world_of_four():
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        yield


def test_sharded_matmul_counts_its_collective(fake_world_of_four):
    """x (8, 16) sharded over data (rows) and model (the contraction),
    w (16, 32) sharded over model (the contraction): rank 0's product is
    a partial sum over model, reduced by one all-reduce of its (4, 32)
    float32 shard; the data axis moves nothing."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    x = distribute_tensor(_randn(8, 16), mesh, [Shard(0), Shard(1)])
    w = distribute_tensor(_randn(16, 32, seed=1), mesh, [Replicate(),
                                                         Shard(0)])
    with CostCounter() as c:
        y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    r = c.result()
    assert tuple(y.to_local().shape) == (4, 32)
    assert r["flops"] == 2 * 4 * 8 * 32
    assert r["collective_counts"] == {k: int(k == "all-reduce")
                                      for k in COLLECTIVES}
    assert r["collective_bytes"]["all-reduce"] == 4 * 32 * 4
    assert r["collective_total_bytes"] == 4 * 32 * 4
    assert r["collective_bytes_by_group"] == {
        mesh.get_group("model").group_name: 4 * 32 * 4}


def test_shape_inference_is_not_counted(fake_world_of_four):
    """Under ``FakeTensorMode`` DTensor infers a new op's output shape by
    running it on fake tensors of the global shape (here (16, 24) @ (24,
    40), a shape no other test uses, so no cache holds it): the counter
    sees that call and counts only rank 0's local product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(16, 24), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(24, 40), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with CostCounter() as c:
            y = x @ w
    assert tuple(y.to_local().shape) == (8, 20)
    assert c.shape_inference_calls > 0
    assert c.result()["flops"] == 2 * 8 * 20 * 24


def test_a_torch_without_the_shape_inference_hook_fails_loudly(monkeypatch):
    from repro_torch.launch import op_cost
    monkeypatch.setattr(op_cost, "_SHAPE_INFERENCE", ("_no_such_function",))
    with pytest.raises(RuntimeError, match="shape inference"):
        with CostCounter():
            pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,kh,d,causal,window", [
    (48, 48, 4, 2, 32, True, 0), (48, 48, 4, 1, 16, True, 16),
    (1, 40, 4, 4, 32, False, 0)])
def test_flash_attention_counts_its_formula(dtype, s, t, h, kh, d, causal,
                                            window):
    q = _randn(2, s, h, d, dtype=dtype)
    k, v = (_randn(2, t, kh, d, dtype=dtype, seed=i) for i in (1, 2))
    with CostCounter() as c:
        fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    r = c.result()
    flops, nbytes = fa_kernel.work(2, s, h, kh, d, q.element_size(),
                                   window, t, causal)
    assert r["op_counts"] == {"repro_torch.flash_attention": 1}
    assert (r["flops"], r["bytes_hbm"]) == (flops, nbytes)
    assert flops == 2 * h * fa_kernel.live_entries(s, window, t,
                                                   causal) * 4 * d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_counts_its_formula(dtype):
    b, l, h, p, n = 2, 48, 3, 16, 8
    x = _randn(b, l, h, p, dtype=dtype)
    dt = torch.nn.functional.softplus(_randn(b, l, h, seed=1))
    A = -torch.exp(_randn(h, seed=2))
    B, C = (_randn(b, l, n, dtype=dtype, seed=i) for i in (3, 4))
    with CostCounter() as c:
        ssd_ops.ssd(x, dt, A, B, C, chunk=16)
    r = c.result()
    assert r["op_counts"] == {"repro_torch.ssd": 1}
    assert (r["flops"], r["bytes_hbm"]) == ssd_kernel.work(
        b, l, h, p, n, x.element_size())


def test_dense_loss_flops_against_the_reference_analyze():
    """A 2-layer dense model's ``loss_fn`` (d_model 256, S 128, remat
    "none", ``attn_impl="xla_flash"`` on both sides) counted eagerly
    against the reference's ``analyze`` of the compiled loss: total FLOPs
    within 10 %.  The ratio this test measures is 1.0004: the matrix
    products agree exactly, and the two conventions for elementwise work
    and reductions differ by little."""
    ref_cfg = RefConfig(name="t", family="dense", num_layers=2, d_model=256,
                        num_heads=4, num_kv_heads=2, d_ff=512,
                        vocab_size=512, head_dim=64, remat="none",
                        loss_chunk=0, dtype="float32",
                        attn_impl="xla_flash", scan_layers=False)
    b, s = 2, 128
    ab = ref_tree_abstract(ref_params_spec(ref_cfg), ref_cfg.dtype)
    specs = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
             "labels": jax.ShapeDtypeStruct((b, s), jnp.int32),
             "mask": jax.ShapeDtypeStruct((b, s), jnp.float32)}
    compiled = jax.jit(lambda p, bt: ref_loss_fn(ref_cfg, p, bt)).lower(
        ab, specs).compile()
    want = analyze(compiled.as_text())["flops"]

    cfg = compat.model_config(ref_cfg)
    assert cfg.attn_impl == "xla_flash"
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (b, s))),
             "labels": torch.from_numpy(rng.integers(0, 512, (b, s))),
             "mask": torch.ones(b, s)}
    with CostCounter() as c:
        loss_fn(cfg, params, batch)
    ratio = c.result()["flops"] / want
    assert abs(ratio - 1) < 0.10, ratio
