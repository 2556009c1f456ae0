"""The port's flash-attention wrapper and plain version against the
reference package's Pallas kernel (interpret mode) and oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``repro_torch``'s wrapper runs its plain version (the CUDA
kernel is held against that plain version on the card by
``chip_smoke.py``), so these tests pin the semantics both must have:
GQA, causal masks, sliding windows that cut through a tile, soft-capped
logits, ragged sequence lengths.  Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(
        atol=2e-5, rtol=2e-5)


def _mk(seed, b, s, h, kh, d, dtype="float32"):
    """(jax q, k, v), (torch q, k, v) holding the same values, model
    layout (B, S, H, D) / (B, S, KH, D)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out_j, out_t = [], []
    for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)):
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), jdt)
        out_j.append(x)
        out_t.append(torch.from_numpy(np.array(x, np.float32)).to(tdt))
    return out_j, out_t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,bq,bk", [
    (1, 64, 4, 4, 32, 16, 16),     # MHA
    (2, 128, 8, 2, 32, 32, 32),    # GQA 4:1
    (1, 96, 4, 1, 16, 32, 32),     # MQA
    (1, 80, 4, 2, 64, 32, 32),     # ragged S (the reference pads 80 -> 96)
    (2, 64, 2, 2, 128, 64, 64),    # head dim 128
])
def test_flash_matches_reference_kernel(dtype, b, s, h, kh, d, bq, bk):
    (qj, kj, vj), (qt, kt, vt) = _mk(b * s + d, b, s, h, kh, d, dtype)
    want = ref_flash(qj, kj, vj, causal=True, bq=bq, bk=bk, interpret=True)
    n0 = ops.launch_count
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert ops.launch_count == n0  # the plain version never counts
    assert got.shape == qt.shape and got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("window", [16, 48])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_flash_window_softcap(tile, window, cap):
    """A window of 48 cuts through 32- and 64-row tiles: rows of a live
    tile are then fully masked (the finite -1e30 sentinel's case)."""
    (qj, kj, vj), (qt, kt, vt) = _mk(5, 2, 128, 4, 2, 32)
    want = ref_flash(qj, kj, vj, causal=True, window=window, cap=cap,
                     bq=tile, bk=tile, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window,
                              cap=cap)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("s", [40, 100])
def test_flash_ragged_keys_causal(seed, s):
    """S not a multiple of bk: the reference pads keys (safe under the
    causal mask), the port masks them."""
    (qj, kj, vj), (qt, kt, vt) = _mk(seed, 2, s, 4, 2, 16)
    want = ref_flash(qj, kj, vj, causal=True, bq=32, bk=32, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_noncausal_and_its_refusal():
    (qj, kj, vj), (qt, kt, vt) = _mk(7, 1, 64, 4, 4, 32)
    want = ref_flash(qj, kj, vj, causal=False, bq=32, bk=32, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    # at the reference's default blocks (512) both refuse non-causal key
    # padding, with the same message
    (qj, kj, vj), (qt, kt, vt) = _mk(7, 1, 520, 1, 1, 16)
    with pytest.raises(ValueError, match="key padding requires causal") as e:
        ref_flash(qj, kj, vj, causal=False, interpret=True)
    with pytest.raises(ValueError, match="key padding requires causal") as f:
        ops.flash_attention(qt, kt, vt, causal=False)
    assert str(e.value) == str(f.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 8, 0.0), (True, 0, 20.0), (False, 0, 0.0),
    (False, 12, 50.0), (True, 48, 30.0),
])
def test_attention_ref_matches_reference_oracle(dtype, causal, window, cap):
    (qj, kj, vj), (qt, kt, vt) = _mk(11, 2, 72, 6, 3, 16, dtype)
    want = ref_oracle(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=causal,
                      window=window, cap=cap)
    got = ref.attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                            vt.transpose(1, 2), causal=causal,
                            window=window, cap=cap)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_rows_are_convex_combinations():
    """Every output row lies in the convex hull of V's rows."""
    _, (qt, kt, vt) = _mk(9, 1, 64, 4, 2, 32)
    out = ops.flash_attention(qt, kt, vt, causal=True, window=16, cap=5.0)
    assert float(out.abs().max()) <= float(vt.abs().max()) + 1e-5


def test_wrapper_refuses_shapes_that_do_not_fit():
    _, (qt, kt, vt) = _mk(1, 1, 16, 4, 2, 16)
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(qt, kt[:, :, :1].expand(1, 16, 3, 16).contiguous(),
                            vt[:, :, :1].expand(1, 16, 3, 16).contiguous())
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(qt[0], kt, vt)


def test_params_struct_describes_model_layout_strides():
    _, (qt, kt, vt) = _mk(2, 2, 24, 8, 2, 32)
    out = torch.empty_like(qt)
    p = fa_kernel.make_params(qt, kt[:, :20], vt[:, :20], out, causal=True,
                              window=48, cap=50.0)
    assert (p.b, p.s, p.t, p.h, p.kh, p.d) == (2, 24, 20, 8, 2, 32)
    assert (p.q_sb, p.q_ss, p.q_sh) == (24 * 8 * 32, 8 * 32, 32)
    assert (p.k_sb, p.k_st, p.k_sh) == (24 * 2 * 32, 2 * 32, 32)
    assert (p.causal, p.window, p.dtype) == (1, 48, 0)
    assert p.scale == pytest.approx(32 ** -0.5) and p.cap == 50.0
