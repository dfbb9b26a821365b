"""Fused qkv projection + multi-head attention (kernel A), its backward
(kernel #4), and their plain PyTorch versions.

Counterpart of ``orbit_tpu/ops/tiny_attention.py::fused_qkv_attention``
with the same layout contract: x (B, S, D) tokens, kernel (D, 3D) in
(in, out) layout with columns [q | k | v] and heads contiguous inside each,
bias (3D,); the result is the (B, S, D) attention output before the output
projection.

Dispatch: a CPU tensor takes the plain versions
(:func:`qkv_attention_reference`, :func:`qkv_attention_backward_reference`);
a CUDA tensor launches the hand-written kernels
(``csrc/fused_qkv_attention.cu``, ``csrc/fused_qkv_attention_bwd.cu``) or
raises. ``impl="reference"`` forces the plain versions and is meant for the
tests and ``chip_smoke.py`` only.

Gradients: when autograd records (grad enabled and an input requires a
gradient) the op runs as a ``torch.autograd.Function`` that saves
``(x, kernel, bias)``, the residuals of the JAX custom_vjp
(orbit_tpu/ops/tiny_attention.py:484-486), and whose backward recomputes
qkv and the softmax: dx in x.dtype, dW and db summed in f32 and cast to the
parameters' dtype (:476). Under ``inference_mode`` nothing is saved.
"""
from __future__ import annotations

import math

import torch

from orbit_tpu_torch.kernels import build as kbuild

HEAD_DIM = 64      # the kernel's head width (every supported ViT)
MAX_TOKENS = 64    # the kernel's longest sequence (50 tokens at 224 px)
_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(x, kernel, bias, num_heads: int) -> None:
    d = x.shape[-1]
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got shape {tuple(x.shape)}")
    if tuple(kernel.shape) != (d, 3 * d) or tuple(bias.shape) != (3 * d,):
        raise ValueError(f"qkv params {tuple(kernel.shape)}/{tuple(bias.shape)} "
                         f"do not match token dim {d}")
    if d % num_heads:
        raise ValueError(f"dim {d} not divisible by {num_heads} heads")


def _qkv_softmax(x, kernel, bias, num_heads: int):
    """The shared recompute of the forward and backward plain versions:
    q, k, v (n, H, s, hd) as f32 views of their x.dtype values, and the f32
    softmax p (n, H, s, s); scores are scaled after the dot."""
    dt = x.dtype
    n, s, d = x.shape
    hd = d // num_heads
    qkv = (torch.matmul(x.float(), kernel.to(dt).float())
           + bias.to(dt).float()).to(dt)
    q, k, v = qkv.float().view(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return q, k, v, p / p.sum(dim=-1, keepdim=True)


def qkv_attention_reference(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: the
    bias is cast to x.dtype, qkv = (f32 GEMM + b) cast to x.dtype, scores and
    softmax in f32 (scaled after the dot), p cast to x.dtype before the AV
    product, AV accumulated in f32 and cast to x.dtype."""
    _check_shapes(x, kernel, bias, num_heads)
    dt = x.dtype
    n, s, d = x.shape
    _, _, v, p = _qkv_softmax(x, kernel, bias, num_heads)
    out = torch.matmul(p.to(dt).float(), v)            # (n, H, s, hd) f32
    return out.transpose(1, 2).reshape(n, s, d).to(dt)


def qkv_attention_backward_reference(x, kernel, bias, g, num_heads: int):
    """Plain backward with the TPU kernel's rounding points
    (orbit_tpu/ops/tiny_attention.py:226-244, 403-421): the recomputed qkv
    and p as in the forward; in f32 dv = cast(p)ᵀg, dp = g vᵀ,
    ds = p∘(dp − rowsum(dp∘p)), dq = cast(ds·scale) k, dk = cast(ds·scale)ᵀq,
    all into an f32 dqkv; then dx = cast(dqkv)·Wᵀ cast to x.dtype,
    dW = xᵀ·cast(dqkv) and db = colsum(dqkv) in f32. Returns (dx, dW, db)."""
    _check_shapes(x, kernel, bias, num_heads)
    dt = x.dtype
    n, s, d = x.shape
    hd = d // num_heads
    scale = 1.0 / math.sqrt(hd)
    q, k, v, p = _qkv_softmax(x, kernel, bias, num_heads)
    gh = g.to(dt).float().view(n, s, num_heads, hd).transpose(1, 2)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = (ds * scale).to(dt).float()
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    # (3, n, H, s, hd) -> (n, s, 3, H, hd): columns [q heads | k heads | v heads]
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(n * s, 3 * d)
    dqkv_t = dqkv.to(dt).float()
    dx = torch.matmul(dqkv_t, kernel.to(dt).float().T).to(dt).view(n, s, d)
    dw = torch.matmul(x.float().reshape(n * s, d).T, dqkv_t)
    return dx, dw, dqkv.sum(dim=0)


def _check_kernel_args(name: str, x, num_heads: int, *others) -> None:
    n, s, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if d // num_heads != HEAD_DIM or s > MAX_TOKENS or n < 1:
        raise ValueError(f"{name} kernel needs head dim {HEAD_DIM}, "
                         f"1 <= S <= {MAX_TOKENS} and B >= 1; got (B,S,D,H)="
                         f"{(n, s, d, num_heads)}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")


def _launch(x, kernel, bias, num_heads: int) -> torch.Tensor:
    _check_kernel_args("fused_qkv_attention", x, num_heads, kernel, bias)
    n, s, d = x.shape
    x = x.contiguous()
    w = kbuild.aligned(kernel.to(x.dtype))
    b = bias.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    lib = kbuild.library()
    fn = (lib.orbit_fused_qkv_attention_bf16 if x.dtype == torch.bfloat16
          else lib.orbit_fused_qkv_attention_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                  n, s, d, num_heads, stream)
    kbuild.check(code, "fused_qkv_attention")
    kbuild.LAUNCHES["fused_qkv_attention"] += 1
    return out


def _launch_backward(x, kernel, bias, g, num_heads: int):
    _check_kernel_args("fused_qkv_attention_bwd", x, num_heads, kernel, bias, g)
    n, s, d = x.shape
    if tuple(g.shape) != (n, s, d):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(n, s, d)}")
    x = kbuild.aligned(x)
    g = kbuild.aligned(g.to(x.dtype))
    w = kbuild.aligned(kernel.to(x.dtype))
    b = bias.to(x.dtype).contiguous()
    f32 = dict(device=x.device, dtype=torch.float32)
    qkv = torch.empty((n, s, 3 * d), device=x.device, dtype=x.dtype)
    dqkv = torch.empty((n, s, 3 * d), **f32)
    partial = torch.empty((-(-n * s // kbuild.COLSUM_ROWS), 3 * d), **f32)
    dx = torch.empty_like(x)
    dw = torch.empty((d, 3 * d), **f32)
    db = torch.empty((3 * d,), **f32)
    lib = kbuild.library()
    fn = (lib.orbit_fused_qkv_attention_bwd_bf16 if x.dtype == torch.bfloat16
          else lib.orbit_fused_qkv_attention_bwd_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                  qkv.data_ptr(), dqkv.data_ptr(), partial.data_ptr(),
                  dx.data_ptr(), dw.data_ptr(), db.data_ptr(), n, s, d,
                  num_heads, stream)
    kbuild.check(code, "fused_qkv_attention_bwd")
    kbuild.LAUNCHES["fused_qkv_attention_bwd"] += 1
    return dx, dw, db


def _use_reference(x, impl) -> bool:
    if impl is not None and impl != "reference":
        raise ValueError(f"unknown impl {impl!r} (None or 'reference')")
    if impl == "reference" or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention kernel needs a CUDA tensor, "
                         f"got {x.device}")
    return False


def _forward(x, kernel, bias, num_heads, impl):
    if _use_reference(x, impl):
        return qkv_attention_reference(x, kernel, bias, num_heads)
    return _launch(x, kernel, bias, num_heads)


def fused_qkv_attention_backward(x, kernel, bias, g, num_heads: int, *,
                                 impl: str | None = None):
    """(dx, dW, db) of :func:`fused_qkv_attention` for the cotangent g:
    dx in x.dtype, dW and db in f32. impl as for the forward."""
    _check_shapes(x, kernel, bias, num_heads)
    if _use_reference(x, impl):
        return qkv_attention_backward_reference(x, kernel, bias, g, num_heads)
    return _launch_backward(x, kernel, bias, g, num_heads)


class _FusedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, num_heads, impl):
        ctx.save_for_backward(x, kernel, bias)
        ctx.num_heads, ctx.impl = num_heads, impl
        return _forward(x, kernel, bias, num_heads, impl)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias = ctx.saved_tensors
        dx, dw, db = fused_qkv_attention_backward(x, kernel, bias, g, ctx.num_heads,
                                                  impl=ctx.impl)
        return dx, dw.to(kernel.dtype), db.to(bias.dtype), None, None


def fused_qkv_attention(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, num_heads: int, *,
                        impl: str | None = None) -> torch.Tensor:
    """qkv projection + multi-head attention in one op, differentiable in
    x, kernel and bias.

    impl: None (the kernels for a CUDA tensor, the plain versions for a CPU
    tensor) or "reference" (the plain versions on any device)."""
    _check_shapes(x, kernel, bias, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return _FusedQkvAttention.apply(x, kernel, bias, num_heads, impl)
    return _forward(x, kernel, bias, num_heads, impl)
