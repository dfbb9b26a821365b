"""Fused transformer MLP half-block (kernel B) and its plain PyTorch
version: ``y = x + fc2(gelu(fc1(LayerNorm(x))))``.

Counterpart of ``orbit_tpu/ops/mlp_block.py::fused_mlp_block`` with the
same contract: x (B, S, D); ln_scale, ln_bias (D,); w1 (D, hidden), b1
(hidden,); w2 (hidden, D), b2 (D,). LayerNorm and bias vectors are used in
f32 and the weights in x.dtype, as the TPU kernel receives them.

Dispatch: a CPU tensor takes :func:`mlp_block_reference`; a CUDA tensor
launches the hand-written kernel (``csrc/mlp_block.cu``) or raises.
``impl="reference"`` forces the plain version and is meant for the tests
and ``chip_smoke.py`` only. The kernel is forward-only.
"""
from __future__ import annotations

import math

import torch

from orbit_tpu_torch.kernels import build as kbuild

KERNEL_DIMS = (64, 128, 384, 768)  # D values the kernel is instantiated for
HIDDEN_CHUNK = 64                  # the kernel walks hidden in these steps
_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(x, w1, w2) -> None:
    d = x.shape[-1]
    if w1.shape[0] != d or w2.shape[1] != d or w1.shape[1] != w2.shape[0]:
        raise ValueError(f"mlp weight shapes {tuple(w1.shape)}/{tuple(w2.shape)} "
                         f"do not chain with token dim {d}")


def mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                        ln_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: f32
    two-pass LayerNorm, LN output cast to x.dtype, f32 fc1 + b1, exact-erf
    GELU in f32 cast to x.dtype, f32 fc2 + b2 + f32 residual, cast to
    x.dtype."""
    _check_shapes(x, w1, w2)
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xn = (xc * torch.rsqrt(var + ln_eps) * ln_scale.float()
          + ln_bias.float()).to(dt)
    h = torch.matmul(xn.float(), w1.to(dt).float()) + b1.float()
    h = (0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))).to(dt)
    y = torch.matmul(h.float(), w2.to(dt).float()) + b2.float() + xf
    return y.to(dt)


def _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps: float):
    d = x.shape[-1]
    hidden = w1.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_block kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if d not in KERNEL_DIMS or hidden % HIDDEN_CHUNK or x.numel() == 0:
        raise ValueError(f"fused_mlp_block kernel needs D in {KERNEL_DIMS}, "
                         f"hidden a multiple of {HIDDEN_CHUNK} and rows >= 1; "
                         f"got D={d}, hidden={hidden}, shape {tuple(x.shape)}")
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError("fused_mlp_block has no backward kernel: call it "
                           "under torch.inference_mode() or torch.no_grad()")
    for t in params:
        if t.device != x.device:
            raise ValueError(f"fused_mlp_block: tensors on {t.device} and {x.device}")
    x = x.contiguous()
    rows = x.numel() // d
    f32 = [t.float().contiguous() for t in (ln_scale, ln_bias, b1, b2)]
    w1c = kbuild.aligned(w1.to(x.dtype))
    w2c = kbuild.aligned(w2.to(x.dtype))
    out = torch.empty_like(x)
    lib = kbuild.library()
    fn = (lib.orbit_fused_mlp_block_bf16 if x.dtype == torch.bfloat16
          else lib.orbit_fused_mlp_block_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
                  w1c.data_ptr(), f32[2].data_ptr(), w2c.data_ptr(),
                  f32[3].data_ptr(), out.data_ptr(), rows, d, hidden,
                  float(ln_eps), stream)
    kbuild.check(code, "fused_mlp_block")
    kbuild.LAUNCHES["fused_mlp_block"] += 1
    return out


def fused_mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
                    ln_eps: float = 1e-6, impl: str | None = None) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LayerNorm(x))))`` in one op.

    impl: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor) or "reference" (the plain version on any device)."""
    _check_shapes(x, w1, w2)
    if impl == "reference" or (impl is None and x.device.type == "cpu"):
        return mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                   ln_eps=ln_eps)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r} (None or 'reference')")
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block kernel needs a CUDA tensor, got {x.device}")
    return _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)
