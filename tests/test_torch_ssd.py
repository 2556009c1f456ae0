"""The port's SSD wrapper and plain version against the reference package's
Pallas kernel (interpret mode) and oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``repro_torch``'s wrapper runs its plain version, the
sequential recurrence (the CUDA kernel is held against that plain version
on the card by ``chip_smoke.py``), so these tests pin the semantics both
must have: the model layout, chunks, a ragged chunk count, instant decay,
strided views of one conv output.  Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 2e-2.  The custom
op the card runs is driven here, its CUDA launch stood in for: its
gradients must be autograd's of the chunked ``ref.ssd_reference`` bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as ref_ssd
from repro.kernels.ssd.ref import ssd_ref as ref_oracle
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro.models import layers as RL
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


# ---------------------------------------------------------------------------
# the bfloat16 kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.SSD_TOL: |k - p| <= a * max|p| + r * |p|, the limit the card
# holds the kernel to
CHIP_SSD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2 ** -7)}


def split3(t: torch.Tensor):
    """float32 -> (hi, mid, lo), each a bfloat16 value held in float32,
    as the kernel splits an operand: hi = bf16(t), mid = bf16(t - hi),
    lo = bf16(t - hi - mid), both differences exact in float32."""
    hi = t.bfloat16().float()
    r = t - hi
    mid = r.bfloat16().float()
    lo = (r - mid).bfloat16().float()
    return hi, mid, lo


def _mm3(a, b, *, split_a: bool):
    """a @ b with the float32 operand (a if ``split_a``, else b) entered
    as its three bfloat16 parts: three products summed in float32."""
    if split_a:
        return sum(part @ b for part in split3(a))
    return sum(a @ part for part in split3(b))


def ssd_split_emulation(x, dt, A, B, C, *, q: int):
    """The bfloat16 kernel's arithmetic in plain torch, model layout: L
    zero-padded to chunks of ``q`` steps and N to a multiple of 16; per
    chunk s = cumsum(dt * A), the scores G = (C B^T) exp(s_i - s_j) dt_j
    (j <= i, exp evaluated there only), y = G.x + exp(s) (C.S) and
    S <- exp(s_last) S + B^T (w o x) with w = exp(s_last - s) dt; G, S and
    w o x enter their products as three bf16 parts (x, B, C are bf16, so
    each product is exact in float32).  Returns y (b, l, h, p) float32."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    lp, npad = -(-l // q) * q, -(-n // 16) * 16
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, lp - l))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, lp - l))
    Bf = torch.nn.functional.pad(B.float(), (0, npad - n, 0, lp - l))
    Cf = torch.nn.functional.pad(C.float(), (0, npad - n, 0, lp - l))
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool))
    S = torch.zeros((b, h, npad, p))
    ys = []
    for c0 in range(0, lp, q):
        xs = xf[:, c0:c0 + q].transpose(1, 2)             # (b, h, q, p)
        d = dtf[:, c0:c0 + q].transpose(1, 2)             # (b, h, q)
        Bc, Cc = Bf[:, None, c0:c0 + q], Cf[:, None, c0:c0 + q]
        s = torch.cumsum(d * A[None, :, None], dim=-1)
        diff = torch.where(tril, s[..., :, None] - s[..., None, :], 0.0)
        G = (Cc @ Bc.transpose(-1, -2)) * torch.where(
            tril, torch.exp(diff), 0.0) * d[..., None, :]
        y = _mm3(G, xs, split_a=True) \
            + torch.exp(s)[..., None] * _mm3(Cc, S, split_a=False)
        ys.append(y)
        last = s[..., -1:]
        wx = (torch.exp(last - s) * d)[..., None] * xs
        S = S * torch.exp(last)[..., None] \
            + _mm3(Bc.transpose(-1, -2), wx, split_a=False)
    return torch.cat(ys, dim=2).transpose(1, 2)[:, :l]


def _within(got, want, dtype):
    a_frac, rtol = CHIP_SSD_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                               atol=a_frac * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("seed", range(3))
def test_split3_is_exact(seed):
    """hi + mid + lo == t exactly, every part a bfloat16 value, on seeded
    float32 values over 60 decades, zeros, and the magnitudes instant
    decay gives (exp(-100 dt) for dt in [0.5, 0.8], times a score).  lo
    holds t's bits down to 2**-23 |t|, so it stays normal while |t| >=
    2**-103; below that it underflows to a bfloat16 subnormal and the sum
    is off by at most half its spacing, 2**-134."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-30, 30, size=4096)
    vals = rng.choice([-1.0, 1.0], size=4096) * mags
    decay = np.exp(-100.0 * rng.uniform(0.5, 0.8, size=512)) \
        * rng.standard_normal(512) * 40
    t = torch.from_numpy(np.concatenate([vals, decay, np.zeros(8)])
                         .astype(np.float32))
    parts = split3(t)
    for part in parts:
        assert torch.equal(part.bfloat16().float(), part)
    total = sum(part.double() for part in parts)
    normal = t.abs() >= 2.0 ** -103
    assert torch.equal(total[normal], t.double()[normal])
    assert (total - t.double()).abs().max() <= 2.0 ** -134
    assert (~normal).sum() > 0 and normal.sum() > 4000
    assert (parts[0].abs() >= parts[1].abs()).all()


@pytest.mark.parametrize("b,l,h,p,n", [
    (1, 64, 2, 16, 16),       # one chunk of the kernel's own length
    (2, 96, 3, 32, 16),       # ragged: 96 against 64
    (1, 160, 2, 16, 36),      # ragged, N zero-padded to 48
    (2, 128, 2, 32, 4),       # N = 4 padded to 16, two full chunks
])
def test_split_emulation_matches_reference(b, l, h, p, n):
    """The chunked, split-operand scan at the bfloat16 kernel's chunk
    against the reference's Pallas kernel (interpret mode, float32 on the
    same bf16 values; its chunk divides l) within SSD_TOL's float32 limit,
    and, rounded to bfloat16, against the plain version on bfloat16
    inputs within SSD_TOL's bfloat16 limit."""
    q = ssd_kernel.CHUNK[torch.bfloat16]
    js, ts = _mk(l + n, b, l, h, p, n, "bfloat16")
    x, dt, A, B, C = ts
    got = ssd_split_emulation(x, dt, A, B, C, q=q)
    assert torch.isfinite(got).all()
    jf = [jnp.asarray(_np(t)) for t in (x, dt, A, B, C)]
    want = ref_ssd(*jf, chunk=32, interpret=True)
    _within(got, want, "float32")
    plain = ref.ssd_model_ref(x, dt, A, B, C)
    _within(got.bfloat16(), plain, "bfloat16")


def test_split_emulation_kernel_layout_oracle():
    """In the kernel layout (one head a row, dt folded in) the emulation
    agrees with the reference's oracle ``ssd_ref`` and the port's
    ``ref.ssd_ref``: y within SSD_TOL's float32 limit."""
    rng = np.random.default_rng(11)
    b, l, h, p, n = 2, 192, 2, 16, 32
    x = torch.from_numpy(rng.standard_normal((b, l, h, p),
                                             dtype=np.float32)).bfloat16()
    B, C = (torch.from_numpy(rng.standard_normal((b, l, n), dtype=np.float32))
            .bfloat16() for _ in range(2))
    dt = torch.ones((b, l, h))            # x * dt stays bf16-exact
    A = -torch.from_numpy(rng.uniform(0.05, 1.0, size=h).astype(np.float32))
    got = ssd_split_emulation(x, dt, A, B, C, q=64)
    xk = x.float().transpose(1, 2).reshape(b * h, l, p)
    ak = (dt * A).transpose(1, 2).reshape(b * h, l)
    Bk = B.float()[:, None].expand(b, h, l, n).reshape(b * h, l, n)
    Ck = C.float()[:, None].expand(b, h, l, n).reshape(b * h, l, n)
    want, _ = ref.ssd_ref(xk, ak, Bk, Ck)
    oracle, _ = ref_oracle(*(jnp.asarray(t.numpy()) for t in (xk, ak, Bk, Ck)))
    gk = got.transpose(1, 2).reshape(b * h, l, p)
    _within(gk, want, "float32")
    _within(gk, oracle, "float32")


def test_split_emulation_instant_decay_keeps_local_term():
    """decay-100: the emulation leaves only y_t = (C_t . B_t) dt_t x_t."""
    _, (x, dt, A, B, C) = _mk(3, 1, 96, 2, 16, 16, "bfloat16")
    dt = dt + 0.5
    A = torch.full((2,), -100.0)
    got = ssd_split_emulation(x, dt, A, B, C, q=64)
    local = torch.einsum("bln,bln->bl", C.float(), B.float())[
        ..., None, None] * (x.float() * dt[..., None])
    np.testing.assert_allclose(_np(got), _np(local), atol=1e-4, rtol=1e-4)


def test_design_names_both_paths():
    assert ssd_kernel.DESIGN == {torch.float32: "fma",
                                 torch.bfloat16: "mma.sync"}
    assert set(ssd_kernel.CHUNK) == set(ssd_kernel.DTYPES)
    assert ssd_kernel.CHUNK[torch.bfloat16] == 64


# ---------------------------------------------------------------------------
# the custom op the card runs: kernel forward, plain backward
# ---------------------------------------------------------------------------

def _fake_launch(calls):
    """A stand-in for the kernel launch that writes the plain version's
    output into ``y`` (there is no card here)."""
    def launch(x, dt, A, B, C, y, params):
        calls.append(1)
        y.copy_(ref.ssd_model_ref(x, dt, A, B, C))
    return launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [(1, 32, 2, 16, 8, 8),
                                             (2, 48, 3, 16, 16, 16),
                                             (1, 24, 2, 16, 4, 64)])
def test_autograd_backward_is_the_vjp_of_the_chunked_scan(
        monkeypatch, dtype, b, l, h, p, n, chunk):
    """The custom op's gradients (x, dt, A, B, C) equal autograd of
    ``ref.ssd_reference`` at the same chunk (what the reference's Mamba2
    block differentiates) bit for bit, on every device (here its CPU
    implementation runs the forward); its CUDA implementation, with the
    launch stood in for, launches once and gives the plain version's y,
    and the backward launches nothing."""
    calls = []
    monkeypatch.setattr(ssd_kernel, "ssd_launch", _fake_launch(calls))
    monkeypatch.setattr(ops, "launch_count", 0)
    _, ts = _mk(b + l, b, l, h, p, n, dtype)
    ts = [t.requires_grad_() for t in ts]
    y = ops.ssd_op(*ts, min(chunk, l))
    assert y.grad_fn is not None and y.dtype == ts[0].dtype
    with torch.no_grad():
        launched = ops._launch(*ts, min(chunk, l))
    assert ops.launch_count == 1 and len(calls) == 1
    assert torch.equal(launched, y)
    g = torch.from_numpy(np.random.default_rng(l).standard_normal(
        y.shape, np.float32)).to(y.dtype)
    got = torch.autograd.grad(y, ts, g)
    assert ops.launch_count == 1
    t2 = [t.detach().clone().requires_grad_() for t in ts]
    plain, _ = ref.ssd_reference(*t2, chunk=min(chunk, l))
    want = torch.autograd.grad(plain, t2, g)
    for name, a, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name


def test_cpu_wrapper_output_carries_the_plain_gradient():
    _, (x, dt, A, B, C) = _mk(0, 1, 16, 2, 16, 8)
    x.requires_grad_()
    before = ops.launch_count
    y = ops.ssd(x, dt, A, B, C, chunk=8)
    assert y.grad_fn is not None and ops.launch_count == before


def test_chunked_scan_grads_match_reference():
    """``ref.ssd_reference`` and its gradient against the reference's
    ``ssd_reference`` under ``jax.grad``, float32: 2e-5 of each
    gradient's largest magnitude."""
    js, ts = _mk(5, 2, 32, 3, 16, 8)
    gj = jnp.asarray(np.random.default_rng(6).standard_normal(
        (2, 32, 3, 16), np.float32))
    want = jax.grad(lambda *a: jnp.sum(
        RL.ssd_reference(*a, chunk=8)[0] * gj), argnums=range(5))(*js)
    ts = [t.requires_grad_() for t in ts]
    y, _ = ref.ssd_reference(*ts, chunk=8)
    got = torch.autograd.grad(y, ts, torch.from_numpy(np.array(gj)))
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(a), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())


def test_chunked_scan_gradient_is_finite_where_the_reference_is_nan():
    """One step of dt = 100 in each chunk of 8 (A = -1) makes the decay
    between its neighbours pass ~88, which overflows the reference's exp
    above the diagonal, and its gradient there is 0 * inf = NaN; the port
    masks the exponent instead, so its outputs are the reference's and
    its gradient the sequential recurrence's (float32, 1e-4 of each
    gradient's largest magnitude)."""
    js, ts = _mk(9, 1, 16, 2, 16, 4)
    dt = np.array(js[1])
    dt[:, [3, 11], :] = 100.0
    js[1], ts[1] = jnp.asarray(dt), torch.from_numpy(dt)
    js[2], ts[2] = -jnp.ones(2, jnp.float32), -torch.ones(2)
    ref_grads = jax.grad(lambda *a: jnp.sum(
        RL.ssd_reference(*a, chunk=8)[0]), argnums=range(5))(*js)
    assert not np.isfinite(np.asarray(ref_grads[1])).all()   # ddt
    ts = [t.requires_grad_() for t in ts]
    y, _ = ref.ssd_reference(*ts, chunk=8)
    np.testing.assert_allclose(_np(y.detach()), np.asarray(
        RL.ssd_reference(*js, chunk=8)[0]), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(y.sum(), ts)
    t2 = [t.detach().clone().requires_grad_() for t in ts]
    want = torch.autograd.grad(ref.ssd_model_ref(*t2).sum(), t2)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(_np(a), _np(w), rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
