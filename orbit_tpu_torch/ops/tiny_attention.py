"""Fused qkv projection + multi-head attention (kernel A) and its plain
PyTorch version.

Counterpart of ``orbit_tpu/ops/tiny_attention.py::fused_qkv_attention``
with the same layout contract: x (B, S, D) tokens, kernel (D, 3D) in
(in, out) layout with columns [q | k | v] and heads contiguous inside each,
bias (3D,); the result is the (B, S, D) attention output before the output
projection.

Dispatch: a CPU tensor takes :func:`qkv_attention_reference`; a CUDA tensor
launches the hand-written kernel (``csrc/fused_qkv_attention.cu``) or
raises. ``impl="reference"`` forces the plain version and is meant for the
tests and ``chip_smoke.py`` only. The kernel is forward-only: eval needs no
gradient, and training is not ported.
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


def qkv_attention_reference(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: the
    bias is cast to x.dtype, qkv = (f32 GEMM + b) cast to x.dtype, scores and
    softmax in f32 (scaled after the dot), p cast to x.dtype before the AV
    product, AV accumulated in f32 and cast to x.dtype."""
    _check_shapes(x, kernel, bias, num_heads)
    dt = x.dtype
    n, s, d = x.shape
    hd = d // num_heads
    qkv = (torch.matmul(x.float(), kernel.to(dt).float())
           + bias.to(dt).float()).to(dt)
    q, k, v = qkv.float().view(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dt).float(), v)            # (n, H, s, hd) f32
    return out.transpose(1, 2).reshape(n, s, d).to(dt)


def _launch(x, kernel, bias, num_heads: int) -> torch.Tensor:
    n, s, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_qkv_attention kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if d // num_heads != HEAD_DIM or s > MAX_TOKENS or n < 1:
        raise ValueError(f"fused_qkv_attention kernel needs head dim {HEAD_DIM}, "
                         f"1 <= S <= {MAX_TOKENS} and B >= 1; got (B,S,D,H)="
                         f"{(n, s, d, num_heads)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, kernel, bias)):
        raise RuntimeError("fused_qkv_attention has no backward kernel: call it "
                           "under torch.inference_mode() or torch.no_grad()")
    for t in (kernel, bias):
        if t.device != x.device:
            raise ValueError(f"fused_qkv_attention: tensors on {t.device} and "
                             f"{x.device}")
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


def fused_qkv_attention(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, num_heads: int, *,
                        impl: str | None = None) -> torch.Tensor:
    """qkv projection + multi-head attention in one op.

    impl: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor) or "reference" (the plain version on any device)."""
    _check_shapes(x, kernel, bias, num_heads)
    if impl == "reference" or (impl is None and x.device.type == "cpu"):
        return qkv_attention_reference(x, kernel, bias, num_heads)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r} (None or 'reference')")
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention kernel needs a CUDA tensor, "
                         f"got {x.device}")
    return _launch(x, kernel, bias, num_heads)
