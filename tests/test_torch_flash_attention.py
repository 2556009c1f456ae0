"""The port's flash-attention wrapper and plain version against the
reference package's Pallas kernel (interpret mode) and oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``repro_torch``'s wrapper runs its plain version (the CUDA
kernel is held against that plain version on the card by
``chip_smoke.py``), so these tests pin the semantics both must have:
GQA, causal masks, sliding windows that cut through a tile, soft-capped
logits, ragged sequence lengths, non-causal keys the reference would
pad (which only the port takes).  Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 2e-2.  The custom
op the card runs is driven here, its CUDA launch stood in for: its
gradients must be autograd's of ``ref.attention_xla_flash`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro.models import layers as RL
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
    # at its default blocks (512) the reference refuses non-causal keys
    # it would pad; the port pads nothing (the kernel masks keys >= T)
    # and computes the reference's attention function there
    (qj, kj, vj), (qt, kt, vt) = _mk(7, 1, 520, 1, 1, 16)
    with pytest.raises(ValueError, match="key padding requires causal"):
        ref_flash(qj, kj, vj, causal=False, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=False)
    pos = jnp.arange(520)
    want = RL.attention_quadratic(qj, kj, vj, q_pos=pos, k_pos=pos,
                                  causal=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    # whisper's decode-step cross-attention: one query over T = 1500
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for shape in (
        (2, 1, 4, 16), (2, 1500, 4, 16), (2, 1500, 4, 16)))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    want = RL.attention_quadratic(*map(jnp.asarray, (q, k, v)),
                                  q_pos=jnp.arange(1),
                                  k_pos=jnp.arange(1500), causal=False)
    assert got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


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


# ---------------------------------------------------------------------------
# the bfloat16 kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.ATTN_TOL["bfloat16"]: the limit the card holds the kernel to
CHIP_BF16_TOL = dict(atol=4e-3, rtol=8e-3)
LOG2E = 1.4426950408889634


def _bf16_kernel_numerics(q, k, v, *, causal, window, cap, tile):
    """Plain-torch emulation of the bfloat16 kernel, model layout: raw
    bf16 q.k summed in float32, then scaled to the log2 domain in float32
    (with a cap, tanh first), masked logits -1e30, the online softmax over
    key tiles of ``tile`` rows, P rounded to bfloat16 before P.V, l summing
    the rounded p, output acc / max(l, 1e-30) rounded to bfloat16."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(h // kh, dim=1)
    scale = d ** -0.5
    qpos = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, t, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        raw = qf @ kt.transpose(-1, -2)
        if cap:
            x = torch.tanh(raw * (scale / cap)) * (cap * LOG2E)
        else:
            x = raw * (scale * LOG2E)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((s, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window:
            ok &= qpos - kpos < window
        x = torch.where(ok, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new).bfloat16().float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16().transpose(1, 2)


BF16_CASES = [  # b, s, h, kh, d, window, cap, the reference's blocks
    pytest.param(1, 64, 4, 4, 32, 0, 0.0, 32, id="mha"),
    pytest.param(2, 128, 8, 2, 32, 0, 0.0, 32, id="gqa4"),
    pytest.param(1, 96, 4, 1, 16, 0, 0.0, 32, id="mqa-d16"),
    pytest.param(1, 80, 4, 2, 64, 0, 0.0, 32, id="ragged80"),
    pytest.param(2, 128, 4, 2, 32, 48, 30.0, 32, id="window48-cap30"),
    pytest.param(1, 1024, 2, 1, 128, 0, 0.0, 512, id="d128-s1024"),
]


@pytest.mark.parametrize("b,s,h,kh,d,window,cap,blk", BF16_CASES)
def test_bf16_kernel_numerics_within_chip_tolerance(b, s, h, kh, d, window,
                                                    cap, blk):
    """The one rounding the tensor-core kernel adds (P to bf16) keeps it
    within the card's bf16 limit of the reference's Pallas kernel and of
    its oracle."""
    (qj, kj, vj), (qt, kt, vt) = _mk(b * s + d + 3, b, s, h, kh, d,
                                     "bfloat16")
    got = _bf16_kernel_numerics(qt, kt, vt, causal=True, window=window,
                                cap=cap, tile=fa_kernel.BF16_KEY_TILE)
    want = ref_flash(qj, kj, vj, causal=True, window=window, cap=cap,
                     bq=blk, bk=blk, interpret=True)
    oracle = ref_oracle(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=True,
                        window=window, cap=cap)
    np.testing.assert_allclose(_np(got), _np(want), **CHIP_BF16_TOL)
    np.testing.assert_allclose(_np(got), _bhsd(_np(oracle)), **CHIP_BF16_TOL)


@pytest.mark.parametrize("b,s,h,kh,d,window,cap,blk", BF16_CASES)
def test_bf16_p_rounding_error_bound(b, s, h, kh, d, window, cap, blk):
    """Against exact (float64) attention the emulated kernel errs by at
    most u * sum_j w_j |v_j - o| for P's rounding plus u * |o| for the
    output's, u = 2**-8 the unit roundoff of bfloat16 (w the softmax
    weights; |v_j - o| <= |v_j| + |o| below), 1 % for second-order terms."""
    del blk
    _, (qt, kt, vt) = _mk(b * s + d + 3, b, s, h, kh, d, "bfloat16")
    got = _bf16_kernel_numerics(qt, kt, vt, causal=True, window=window,
                                cap=cap, tile=fa_kernel.BF16_KEY_TILE)
    qd = qt.double().transpose(1, 2)
    kd = kt.double().transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vd = vt.double().transpose(1, 2).repeat_interleave(h // kh, dim=1)
    sc = qd @ kd.transpose(-1, -2) * d ** -0.5
    if cap:
        sc = torch.tanh(sc / cap) * cap
    i = torch.arange(s)
    ok = (i[:, None] >= i[None, :])
    if window:
        ok &= i[:, None] - i[None, :] < window
    w = torch.softmax(sc.masked_fill(~ok, -torch.inf), dim=-1)
    o = w @ vd
    u = 2.0 ** -8 * 1.01
    bound = u * (w @ vd.abs() + o.abs()) + u * o.abs() + 1e-6
    err = (got.double().transpose(1, 2) - o).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def test_bf16_rows_must_be_16_byte_aligned():
    """The bfloat16 kernel's TMA loads take 16-byte aligned rows: the
    wrapper's check passes the model path's tensors and refuses a view
    that breaks it."""
    x = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    ops.check_rows_aligned("q", x)                     # contiguous
    ops.check_rows_aligned("k", x[:, :, 1:3])          # a head slice
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        ops.check_rows_aligned("q", x.view(-1)[4:4 + 2 * 8 * 4 * 60]
                               .view(2, 8, 4, 60))
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        ops.check_rows_aligned("v", x.view(-1)[1:1 + 2 * 8 * 4 * 63]
                               .view(2, 8, 4, 63))


# ---------------------------------------------------------------------------
# the custom op the card runs: kernel forward, plain backward
# ---------------------------------------------------------------------------

def _fake_launch(calls):
    """A stand-in for the kernel launch that writes the plain version's
    output into ``out`` (there is no card here)."""
    def launch(q, k, v, out, params):
        calls.append(params.causal)
        out.copy_(ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=bool(params.causal), window=params.window,
            cap=params.cap).transpose(1, 2))
    return launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kh,d,causal,window,cap", [
    (40, 40, 4, 2, 32, True, 0, 0.0),       # GQA 2:1
    (600, 600, 4, 1, 16, True, 16, 30.0),   # two query chunks, MQA, cap
    (24, 50, 4, 4, 32, False, 0, 0.0),      # cross-attention, S != T
])
def test_autograd_backward_is_the_vjp_of_the_training_attention(
        monkeypatch, dtype, s, t, h, kh, d, causal, window, cap):
    """The custom op's gradients equal autograd of
    ``ref.attention_xla_flash`` (what the reference differentiates) bit
    for bit, on every device (here its CPU implementation runs the
    forward); its CUDA implementation, with the launch stood in for,
    launches once and gives the plain version's output, and the backward
    launches nothing."""
    calls = []
    monkeypatch.setattr(fa_kernel, "flash_attention_launch",
                        _fake_launch(calls))
    monkeypatch.setattr(ops, "launch_count", 0)
    rng = np.random.default_rng(s + t)
    tdt = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(tdt).requires_grad_()
               for shape in ((2, s, h, d), (2, t, kh, d), (2, t, kh, d)))
    out = ops.flash_attention_op(q, k, v, causal, window, cap)
    assert out.grad_fn is not None and out.dtype == tdt
    with torch.no_grad():
        launched = ops._launch(q, k, v, causal, window, cap)
    assert ops.launch_count == 1 and len(calls) == 1
    assert torch.equal(launched, out)
    g = torch.from_numpy(rng.standard_normal(out.shape, np.float32)).to(tdt)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ops.launch_count == 1
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    plain = ref.attention_xla_flash(q2, k2, v2, q_pos=torch.arange(s),
                                    k_pos=torch.arange(t), causal=causal,
                                    window=window, cap=cap)
    want = torch.autograd.grad(plain, (q2, k2, v2), g)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt and torch.equal(a, b), name


def test_autograd_backward_skips_inputs_without_grad(monkeypatch):
    monkeypatch.setattr(fa_kernel, "flash_attention_launch",
                        _fake_launch([]))
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 16), np.float32))
    v = k.clone().requires_grad_()
    out = ops.flash_attention_op(q, k, v, True, 0, 0.0)
    (dv,) = torch.autograd.grad(out.sum(), (v,))
    v2 = v.detach().clone().requires_grad_()
    pos = torch.arange(16)
    want = ref.attention_xla_flash(q, k, v2, q_pos=pos, k_pos=pos)
    assert torch.equal(dv, torch.autograd.grad(want.sum(), (v2,))[0])


def test_cpu_wrapper_output_carries_the_plain_gradient():
    """On CPU tensors the wrapper runs the plain version, so its output
    has a ``grad_fn`` and no launch is counted."""
    (q, k, v) = _mk(3, 1, 24, 4, 2, 16)[1]
    q.requires_grad_()
    before = ops.launch_count
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None and ops.launch_count == before


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 48, 20.0),
                                               (False, 0, 0.0)])
def test_training_attention_grads_match_reference(causal, window, cap):
    """``ref.attention_xla_flash`` and its gradient against the
    reference's ``attention_xla_flash`` under ``jax.grad`` (600 queries:
    two chunks of 512), float32, 2e-5."""
    (qj, kj, vj), (qt, kt, vt) = _mk(7, 1, 600, 4, 2, 32)
    pos = np.arange(600)
    gj = jnp.asarray(np.random.default_rng(8).standard_normal(
        qj.shape, np.float32))

    def fj(q, k, v):
        return jnp.sum(RL.attention_xla_flash(
            q, k, v, q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
            causal=causal, window=window, cap=cap) * gj)

    want = jax.grad(fj, argnums=(0, 1, 2))(qj, kj, vj)
    xs = [x.requires_grad_() for x in (qt, kt, vt)]
    out = ref.attention_xla_flash(*xs, q_pos=torch.from_numpy(pos),
                                  k_pos=torch.from_numpy(pos), causal=causal,
                                  window=window, cap=cap)
    got = torch.autograd.grad(out, xs, torch.from_numpy(np.array(gj)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **_tol("float32"))
