"""Fused MBConv depthwise tail (TPU kernel #8) and its plain PyTorch version:
``y = act2(a2 * dwconv_SAME(act1(a1 * x + b1), w) + b2)``, stride 1.

Counterpart of ``orbit_tpu/ops/depthwise.py::fused_dw_act`` with the same
contract: x (N, H, W, C) NHWC in the compute dtype; w (K, K, 1, C)
depthwise taps; a1, b1, a2, b2 (C,) folded BatchNorm affines in f32 (ones
and zeros for an identity); act1/act2 apply SiLU after their affine.

Rounding points (``xla_fused_dw``, orbit_tpu/ops/depthwise.py:56-78): the
pre-affine and SiLU in f32, rounded to x.dtype; the conv's operands in
x.dtype, accumulated in f32; the post-affine and SiLU in f32; one cast to
x.dtype. TF-SAME padding (:func:`tf_same_pads`) pads the *activated* input
with zeros.

Dispatch: a CUDA tensor launches the hand-written kernel
(``csrc/depthwise.cu``) or raises; a CPU tensor takes the plain version
(:func:`fused_dw_reference`). ``impl="reference"`` forces the plain version
and is meant for the tests and ``chip_smoke.py`` only. Stride 1 only, as
the kernel: the EfficientNet's stride-2 depthwise layers stay a grouped
convolution between BatchNorms, as the JAX blocks keep them.

Gradients: when autograd records, the op runs as a
``torch.autograd.Function`` that saves its six inputs; its backward
recomputes :func:`fused_dw_reference` from them under autograd and returns
the gradients of x, w, a1, b1, a2 and b2 for the cotangent cast to x's
dtype, as the JAX custom_vjp differentiates its XLA version
(orbit_tpu/ops/depthwise.py:152-173). There is no backward kernel, on the
TPU or here. FiLM meta-training reaches the FiLM values through a1, b1,
a2 and b2, the folded BatchNorm affines.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from orbit_tpu_torch.kernels import build as kbuild

KERNEL_SIZES = (3, 5)   # K values the kernel is instantiated for
CHANNEL_MULTIPLE = 8    # a block's channel slice is 8 to 64 channels that divide C
_DTYPES = (torch.float32, torch.bfloat16)


def tf_same_pads(in_size: int, k: int, s: int):
    """TF SAME padding (lo, hi) for one spatial dim (timm Conv2dSame)."""
    out = -(-in_size // s)
    pad = max((out - 1) * s + k - in_size, 0)
    return pad // 2, pad - pad // 2


def _check_shapes(x, w) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != 1 or w.shape[3] != x.shape[-1] \
            or w.shape[0] != w.shape[1]:
        raise ValueError(f"depthwise taps {tuple(w.shape)} do not match NHWC input "
                         f"{tuple(x.shape)} (expected (K, K, 1, C))")


def fused_dw_reference(x, w, a1, b1, a2, b2, *, act1: bool, act2: bool) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points."""
    _check_shapes(x, w)
    dt = x.dtype
    n, h, wd, c = x.shape
    k = w.shape[0]
    a = x.float() * a1.float() + b1.float()
    if act1:
        a = F.silu(a)
    a = a.to(dt).float().permute(0, 3, 1, 2)          # NCHW view, channels last
    ph, pw = tf_same_pads(h, k, 1), tf_same_pads(wd, k, 1)
    a = F.pad(a, (pw[0], pw[1], ph[0], ph[1]))         # zeros after the activation
    taps = w.to(dt).float().permute(3, 2, 0, 1)       # (C, 1, K, K)
    y = F.conv2d(a, taps, groups=c).permute(0, 2, 3, 1)
    y = y * a2.float() + b2.float()
    if act2:
        y = F.silu(y)
    return y.to(dt).contiguous()


def _launch(x, w, a1, b1, a2, b2, act1: bool, act2: bool) -> torch.Tensor:
    n, h, wd, c = x.shape
    k = w.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_dw_act kernel takes float32 or bfloat16, got {x.dtype}")
    if k not in KERNEL_SIZES or c % CHANNEL_MULTIPLE or x.numel() == 0:
        raise ValueError(f"fused_dw_act kernel needs K in {KERNEL_SIZES}, C a multiple "
                         f"of {CHANNEL_MULTIPLE} and a non-empty input; "
                         f"got K={k}, shape {tuple(x.shape)}")
    for t in (w, a1, b1, a2, b2):
        if t.device != x.device:
            raise ValueError(f"fused_dw_act: tensors on {t.device} and {x.device}")
    x = kbuild.aligned(x, 16)
    taps = w.reshape(k * k, c).to(x.dtype).float().contiguous()
    aff = [t.float().contiguous() for t in (a1, b1, a2, b2)]
    out = torch.empty_like(x)
    lib = kbuild.library()
    fn = lib.orbit_fused_dw_bf16 if x.dtype == torch.bfloat16 else lib.orbit_fused_dw_f32
    pad_top, pad_left = tf_same_pads(h, k, 1)[0], tf_same_pads(wd, k, 1)[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), taps.data_ptr(), *(t.data_ptr() for t in aff),
                  out.data_ptr(), n, h, wd, c, k, pad_top, pad_left, int(act1),
                  int(act2), stream)
    kbuild.check(code, "fused_dw_act")
    kbuild.LAUNCHES["fused_dw_act"] += 1
    return out


def _forward(x, w, a1, b1, a2, b2, act1: bool, act2: bool, impl):
    if impl not in (None, "reference", "autograd"):
        raise ValueError(f"unknown impl {impl!r} (None, 'reference' or 'autograd')")
    if impl is not None or x.device.type == "cpu":
        return fused_dw_reference(x, w, a1, b1, a2, b2, act1=act1, act2=act2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw_act kernel needs a CUDA tensor, got {x.device}")
    return _launch(x, w, a1, b1, a2, b2, act1, act2)


class _FusedDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a1, b1, a2, b2, act1, act2, impl):
        ctx.save_for_backward(x, w, a1, b1, a2, b2)
        ctx.acts = (act1, act2)
        return _forward(x, w, a1, b1, a2, b2, act1, act2, impl)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needed = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needed)]
            y = fused_dw_reference(*inputs, act1=ctx.acts[0], act2=ctx.acts[1])
            wanted = [t for t, n in zip(inputs, needed) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(saved[0].dtype)))
        return (*(next(grads) if n else None for n in needed), None, None, None)


def fused_dw_act(x: torch.Tensor, w, a1, b1, a2, b2, *, act1: bool = True,
                 act2: bool = True, impl: str | None = None) -> torch.Tensor:
    """``act2(a2 * dwconv(act1(a1*x + b1), w, SAME, stride 1) + b2)``,
    differentiable in all six inputs.

    impl: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor), "reference" (the plain version on any device) or "autograd"
    (the plain version as ordinary autograd ops, for the MACs counter)."""
    _check_shapes(x, w)
    inputs = (x, w, a1, b1, a2, b2)
    if impl == "autograd":
        return fused_dw_reference(*inputs, act1=act1, act2=act2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedDw.apply(*inputs, act1, act2, impl)
    return _forward(*inputs, act1, act2, impl)
