"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` takes the model layout (B, S, H, D).  For CUDA
tensors it checks its arguments, allocates the output and launches the
kernel — or raises; for CPU tensors it runs the plain version
(:mod:`.ref`) in the kernel layout.

The call is the custom operator ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``): its CUDA implementation launches the
kernel, its CPU implementation is the plain version, and its fake
implementation gives the output's shape, so the call also passes
through ``FakeTensorMode`` and, under ``local_map``, through DTensors.
Its backward (``register_autograd``), on every device, recomputes the
reference's training attention (:func:`.ref.attention_xla_flash`, what
the reference differentiates: it never differentiates its Pallas
kernel) from the saved q, k, v and returns its vector-Jacobian product.
So gradients are autograd's of that plain function at the same inputs,
bit for bit.

Differences from the reference wrapper, by design: nothing is transposed
or padded (the kernel reads the model layout by strides and masks the
ragged ends of S and T itself), and there are no block-size arguments —
the kernel has its own tiles.  The reference refuses a non-causal call
whose keys its key block (512 by default) would pad: its padded key rows
would take part in the softmax.  This wrapper takes such calls (whisper's
encoder and cross-attention, T = 1500): the kernel pads nothing, it
masks every key position ``>= T`` on both paths, so a ragged non-causal
call computes the reference's attention function
(``attention_quadratic``), which is what the plain version computes.
Where the reference pads keys under the causal mask the padded rows lie
beyond every query when ``S <= T``, so both compute the same function
there too.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import attention_ref, attention_xla_flash

# wrapper calls that launched the kernel (a plain int; the plain version
# never counts)
launch_count = 0


def check_rows_aligned(name: str, x: torch.Tensor) -> None:
    """The bfloat16 kernel loads ``x`` by TMA, which takes a 16-byte
    aligned base address and byte strides that are multiples of 16 (the
    first three dims).  Raises otherwise; the model path's einsum and rope
    outputs always meet it."""
    size = x.element_size()
    if x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:3]):
        raise ValueError(
            f"{name}: the bfloat16 kernel needs 16-byte aligned rows (base "
            f"address {x.data_ptr():#x}, element strides "
            f"{tuple(x.stride())}); pass a contiguous copy")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, KH, D) with KH | H.  Returns
    (B, S, H, D) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,S,H,D) and k, v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and D, kv heads dividing heads)")
    if q.device.type == "cuda":
        if q.dtype not in _kernel.DTYPES:
            raise TypeError(f"the kernel takes float32 or bfloat16, got "
                            f"{q.dtype}")
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
        if k.device != q.device or v.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if d not in _kernel.HEAD_DIMS:
            raise ValueError(f"head dim {d} is not one of the kernel's "
                             f"{_kernel.HEAD_DIMS}")
        if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
            raise ValueError("the head dim of q, k and v must be contiguous")
    return flash_attention_op(q, k, v, causal, window, cap)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, cap: float
                       ) -> torch.Tensor:
    """The plain version, in the model layout (CPU tensors)."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        cap=cap)
    return out.transpose(1, 2).contiguous()


@flash_attention_op.register_kernel("cuda")
def _launch(q, k, v, causal: bool, window: int, cap: float):
    """The kernel's output for checked CUDA tensors q, k, v."""
    global launch_count
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_rows_aligned(name, x)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    params = _kernel.make_params(q, k, v, out, causal=causal, window=window,
                                 cap=cap)
    _kernel.flash_attention_launch(q, k, v, out, params)
    launch_count += 1
    return out


@flash_attention_op.register_fake
def _(q, k, v, causal, window, cap):
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, cap = inputs
    ctx.save_for_backward(q, k, v)
    ctx.mask = (causal, window, cap)


def _backward(ctx, grad_out):
    """The VJP of :func:`.ref.attention_xla_flash`, recomputed from the
    saved inputs."""
    causal, window, cap = ctx.mask
    inputs = [x.detach().requires_grad_(need) for x, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
    wanted = [x for x in inputs if x.requires_grad]
    with torch.enable_grad():
        q = inputs[0]
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(inputs[1].shape[1], device=q.device)
        out = attention_xla_flash(*inputs, q_pos=pos_q, k_pos=pos_k,
                                  causal=causal, window=window, cap=cap)
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if x.requires_grad else None
                 for x in inputs) + (None, None, None)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)
