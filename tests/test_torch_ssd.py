"""The port's SSD wrapper and plain version against the reference package's
Pallas kernel (interpret mode) and oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``repro_torch``'s wrapper runs its plain version, the
sequential recurrence (the CUDA kernel is held against that plain version
on the card by ``chip_smoke.py``), so these tests pin the semantics both
must have: the model layout, chunks, a ragged chunk count, instant decay,
strided views of one conv output.  Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as ref_ssd
from repro.kernels.ssd.ref import ssd_ref as ref_oracle
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(
        atol=2e-5, rtol=2e-5)


def _mk(seed, b, l, h, p, n, dtype="float32", a_scale=0.5):
    """(jax x, dt, A, B, C), (torch ...) holding the same values, as
    ``tests/test_kernels.py`` draws them: x, B, C in ``dtype``; dt =
    softplus(normal), rounded to ``dtype`` (the reference takes it so; the
    port's wrapper takes dt as float32, which holds the rounded values
    exactly); A = -exp(a_scale * normal) float32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.asarray(jax.nn.softplus(
        rng.standard_normal((b, l, h), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32) * a_scale)
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    js = [jnp.asarray(x, jdt), jnp.asarray(dt, jdt), jnp.asarray(A),
          jnp.asarray(B, jdt), jnp.asarray(C, jdt)]
    ts = [torch.from_numpy(np.array(js[0], np.float32)).to(tdt),
          torch.from_numpy(np.array(js[1], np.float32)),
          torch.from_numpy(A),
          torch.from_numpy(np.array(js[3], np.float32)).to(tdt),
          torch.from_numpy(np.array(js[4], np.float32)).to(tdt)]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 8, 32),
    (2, 48, 2, 8, 4, 16),       # chunk == 16, l = 48
    (1, 24, 3, 16, 16, 64),     # l < chunk: one chunk of l
])
def test_ssd_matches_reference_kernel(dtype, b, l, h, p, n, chunk):
    js, ts = _mk(l + p, b, l, h, p, n, dtype)
    want = ref_ssd(*js, chunk=chunk, interpret=True)
    n0 = ops.launch_count
    got = ops.ssd(*ts, chunk=chunk)
    assert ops.launch_count == n0  # the plain version never counts
    assert got.shape == ts[0].shape and got.dtype == ts[0].dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("seed", range(6))
def test_ssd_chunk_counts(seed):
    """The reference's property test, as fixed cases: 1-4 chunks of 16,
    one or two heads and batch rows."""
    rng = np.random.default_rng(100 + seed)
    b, nchunk, h = (int(rng.integers(1, 3)), int(rng.integers(1, 5)),
                    int(rng.integers(1, 3)))
    js, ts = _mk(seed, b, nchunk * 16, h, 8, 8)
    want = ref_ssd(*js, chunk=16, interpret=True)
    got = ops.ssd(*ts, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-4, rtol=5e-4)


def test_ssd_decay_kills_history():
    """With a ~ -inf (instant decay), the output reduces to the purely
    local term y_t = C_t . (B_t^T x_t dt_t).  dt is kept >= 0.5, so that
    every step's decay exp(dt * A) is below exp(-50)."""
    js, (x, dt, A, B, C) = _mk(3, 1, 32, 1, 8, 4)
    dt = dt + 0.5
    js[1] = jnp.asarray(dt.numpy())
    A = torch.full((1,), -100.0)
    y = ops.ssd(x, dt, A, B, C, chunk=8)
    local = torch.einsum("bln,bln->bl", C, B)[..., None, None] * (
        x * dt[..., None])
    np.testing.assert_allclose(_np(y), _np(local), atol=1e-4, rtol=1e-4)
    want = ref_ssd(js[0], js[1], jnp.full((1,), -100.0), js[3], js[4],
                   chunk=8, interpret=True)
    np.testing.assert_allclose(_np(y), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunk_changes_only_the_order_of_sums(chunk):
    _, ts = _mk(5, 2, 64, 2, 16, 16)
    np.testing.assert_allclose(_np(ops.ssd(*ts, chunk=chunk)),
                               _np(ops.ssd(*ts, chunk=32)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_reference_oracle(dtype):
    """The plain version against the reference's, in the kernel layout:
    y and the final (BH, N, P) state."""
    rng = np.random.default_rng(7)
    jdt, tdt = DTYPES[dtype]
    bh, l, p, n = 6, 40, 16, 8
    x = rng.standard_normal((bh, l, p), dtype=np.float32)
    a = -rng.uniform(0.01, 1.0, size=(bh, l)).astype(np.float32)
    B = rng.standard_normal((bh, l, n), dtype=np.float32)
    C = rng.standard_normal((bh, l, n), dtype=np.float32)
    jx, jB, jC = (jnp.asarray(v, jdt) for v in (x, B, C))
    wy, ws = ref_oracle(jx, jnp.asarray(a), jB, jC)
    tx, tB, tC = (torch.from_numpy(np.array(v, np.float32)).to(tdt)
                  for v in (jx, jB, jC))
    gy, gs = ref.ssd_ref(tx, torch.from_numpy(a), tB, tC)
    assert gy.dtype == tdt and gs.dtype == torch.float32
    assert gs.shape == (bh, n, p)
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(gs), _np(ws), atol=2e-5, rtol=2e-5)


def test_strided_views_of_one_conv_output():
    """x, B and C cut from one (b, l, h*p + 2n) tensor and dt a
    transposed view give what contiguous copies give — the layout of
    ``mamba_block``, which the kernel reads by strides."""
    b, l, h, p, n = 2, 32, 3, 16, 8
    rng = np.random.default_rng(9)
    conv = torch.from_numpy(rng.standard_normal((b, l, h * p + 2 * n),
                                                dtype=np.float32))
    x = conv[..., :h * p].reshape(b, l, h, p)
    B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, h, l), dtype=np.float32))).transpose(1, 2)
    A = -torch.ones(h)
    assert not x.is_contiguous() and not dt.is_contiguous()
    got = ops.ssd(x, dt, A, B, C, chunk=8)
    want = ops.ssd(*(t.contiguous() for t in (x, dt, A, B, C)), chunk=8)
    assert torch.equal(got, want)


def test_wrapper_refusals():
    _, (x, dt, A, B, C) = _mk(1, 1, 48, 2, 16, 8)
    n0 = ops.launch_count
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd(x, dt, A, B, C, chunk=32)          # 48 % 32
    with pytest.raises(TypeError, match="share one dtype"):
        ops.ssd(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd(x.double(), dt, A, B.double(), C.double())
    with pytest.raises(TypeError, match="dt and A must be float32"):
        ops.ssd(x, dt.to(torch.bfloat16), A, B, C)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd(x, dt[:, :, :1], A, B, C)
    with pytest.raises(ValueError, match="must be"):
        ops.ssd(x[0], dt, A, B, C)
    assert ops.launch_count == n0


def test_params_struct_describes_model_layout_strides():
    b, l, h, p, n = 2, 24, 4, 16, 8
    conv = torch.zeros((b, l, h * p + 2 * n))
    x = conv[..., :h * p].reshape(b, l, h, p)
    B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.zeros((b, h, l)).transpose(1, 2)
    y = torch.empty((b, l, h, p), dtype=torch.bfloat16)
    prm = ssd_kernel.make_params(x, dt, B, C, y)
    cd = h * p + 2 * n
    assert (prm.b, prm.l, prm.h, prm.p, prm.n) == (b, l, h, p, n)
    assert (prm.x_sb, prm.x_sl, prm.x_sh) == (l * cd, cd, p)
    assert (prm.dt_sb, prm.dt_sl, prm.dt_sh) == (h * l, 1, l)
    assert (prm.b_sb, prm.b_sl, prm.c_sb, prm.c_sl) == (l * cd, cd,
                                                         l * cd, cd)
    assert (prm.y_sb, prm.y_sl, prm.y_sh) == (l * h * p, h * p, p)
    assert prm.dtype == 0
