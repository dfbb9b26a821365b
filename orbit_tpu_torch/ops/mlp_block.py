"""Fused transformer MLP half-block (kernel B), its backward (kernel #6),
and their plain PyTorch versions: ``y = x + fc2(gelu(fc1(LayerNorm(x))))``.

Counterpart of ``orbit_tpu/ops/mlp_block.py::fused_mlp_block`` with the
same contract: x (B, S, D); ln_scale, ln_bias (D,); w1 (D, hidden), b1
(hidden,); w2 (hidden, D), b2 (D,). LayerNorm and bias vectors are used in
f32 and the weights in x.dtype, as the TPU kernel receives them.

Dispatch: a CPU tensor takes the plain versions (:func:`mlp_block_reference`,
:func:`mlp_block_backward_reference`); a CUDA tensor launches the
hand-written kernels (``csrc/mlp_block.cu``, ``csrc/mlp_block_bwd.cu``) or
raises. ``impl="reference"`` forces the plain versions and is meant for the
tests and ``chip_smoke.py`` only.
``impl="autograd"`` runs the plain version as ordinary autograd ops,
with no custom backward: autograd keeps its intermediates and computes only
the gradients an input needs, as XLA differentiates the JAX package's
plain route. The MACs counter (``utils/ops_counter.py``) counts that
route; nothing else takes it.

Gradients: when autograd records, the op runs as a
``torch.autograd.Function`` that saves the residuals of the JAX custom_vjp
(orbit_tpu/ops/mlp_block.py:289-292) and whose backward recomputes
LayerNorm, fc1 and GELU: dx in x.dtype, and dγ, dβ, dW1, db1, dW2 and
db2 = colsum(g) summed in f32, cast to the parameters' dtypes. When no
weight or weight bias needs a gradient (``ctx.needs_input_grad``, e.g. a
FiLM step with the extractor frozen), the plain backward skips dW1, db1,
dW2 and db2, as XLA drops what no output reads; the kernel still
computes them.
"""
from __future__ import annotations

import math

import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans

KERNEL_DIMS = (64, 128, 384, 768)  # D values the forward kernel is instantiated for
HIDDEN_CHUNK = 64                  # the FMA kernel walks hidden in these steps
WGMMA_TILE_N = 128                 # the wgmma route's tile columns (fc1 and fc2)
_DTYPES = (torch.float32, torch.bfloat16)
_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _check_shapes(x, w1, w2) -> None:
    d = x.shape[-1]
    if w1.shape[0] != d or w2.shape[1] != d or w1.shape[1] != w2.shape[0]:
        raise ValueError(f"mlp weight shapes {tuple(w1.shape)}/{tuple(w2.shape)} "
                         f"do not chain with token dim {d}")


def _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, ln_eps: float):
    """The shared recompute of the forward and backward plain versions:
    (xf, xhat, rstd, xn, hpre, erf, hg), with xn and hg holding x.dtype
    values as f32."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + ln_eps)
    xhat = xc * rstd
    xn = (xhat * ln_scale.float() + ln_bias.float()).to(dt).float()
    hpre = torch.matmul(xn, w1.to(dt).float()) + b1.float()
    erf = torch.erf(hpre * _INV_SQRT_2)
    hg = (0.5 * hpre * (1.0 + erf)).to(dt).float()
    return xf, xhat, rstd, xn, hpre, erf, hg


def mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                        ln_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: f32
    two-pass LayerNorm, LN output cast to x.dtype, f32 fc1 + b1, exact-erf
    GELU in f32 cast to x.dtype, f32 fc2 + b2 + f32 residual, cast to
    x.dtype."""
    _check_shapes(x, w1, w2)
    dt = x.dtype
    xf, _, _, _, _, _, hg = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, ln_eps)
    y = torch.matmul(hg, w2.to(dt).float()) + b2.float() + xf
    return y.to(dt)


def mlp_block_stages(x, ln_scale, ln_bias, w1, b1, w2, b2, *, ln_eps: float = 1e-6):
    """The plain version cut where the kernel's bf16 wgmma route cuts it
    into launches: (xn, h, y), each in x.dtype, the LayerNorm launch's
    output, fc1's (h rounded where the TPU kernel rounds hg) and fc2's. y
    is :func:`mlp_block_reference`'s, bit for bit."""
    _check_shapes(x, w1, w2)
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + ln_eps)
    xn = (xc * rstd * ln_scale.float() + ln_bias.float()).to(dt)
    hpre = torch.matmul(xn.float(), w1.to(dt).float()) + b1.float()
    h = (0.5 * hpre * (1.0 + torch.erf(hpre * _INV_SQRT_2))).to(dt)
    y = (torch.matmul(h.float(), w2.to(dt).float()) + b2.float() + xf).to(dt)
    return xn, h, y


def mlp_block_backward_stages(x, ln_scale, ln_bias, w1, b1, w2, g, *,
                              ln_eps: float = 1e-6):
    """The plain backward cut where the kernel's bf16 route cuts it into
    launches: ((xn, hg, dhb, dxn), grads). xn is the LayerNorm launch's
    output, hg and dhb = cast(dhpre) the hidden launch's (x.dtype), dxn
    (f32) the grads launch's data product, beside which it writes dW1 and
    dW2; grads is :func:`mlp_block_backward_reference`'s tuple, bit for
    bit (the same operations in the same order)."""
    _check_shapes(x, w1, w2)
    dt = x.dtype
    _, xhat, rstd, xn, hpre, erf, hg = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, ln_eps)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    gf = g.to(dt).float()
    dhg = torch.matmul(gf, w2.to(dt).float().T)
    phi = torch.exp(-0.5 * hpre * hpre) * _INV_SQRT_2PI
    dhpre = dhg * (0.5 * (1.0 + erf) + hpre * phi)
    dhb = dhpre.to(dt).float()
    dxn = torch.matmul(dhb, w1.to(dt).float().T)
    dxhat = dxn * ln_scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + gf).to(dt)
    grads = (dx, rows(dxn * xhat).sum(dim=0), rows(dxn).sum(dim=0),
             torch.matmul(rows(xn).T, rows(dhb)), rows(dhpre).sum(dim=0),
             torch.matmul(rows(hg).T, rows(gf)), rows(gf).sum(dim=0))
    return (xn.to(dt), hg.to(dt), dhb.to(dt), dxn), grads


def mlp_block_backward_reference(x, ln_scale, ln_bias, w1, b1, w2, g, *,
                                 ln_eps: float = 1e-6, weight_grads: bool = True):
    """Plain backward with the TPU kernel's rounding points
    (orbit_tpu/ops/mlp_block.py:186-212): in f32, dhg = g·W2ᵀ,
    dhpre = dhg·(½(1+erf) + hpre·φ(hpre)), dxn = cast(dhpre)·W1ᵀ, then the
    LayerNorm backward per row plus the residual g; dW1 = xnᵀ·cast(dhpre),
    dW2 = hgᵀ·g, and column sums for db1 (of f32 dhpre), db2, dγ and dβ.
    Returns (dx in x.dtype, dγ, dβ, dW1, db1, dW2, db2 in f32); without
    ``weight_grads`` the last four are None and their products are not
    computed."""
    _check_shapes(x, w1, w2)
    dt = x.dtype
    _, xhat, rstd, xn, hpre, erf, hg = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1,
                                                    ln_eps)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    gf = g.to(dt).float()
    dhg = torch.matmul(gf, w2.to(dt).float().T)
    phi = torch.exp(-0.5 * hpre * hpre) * _INV_SQRT_2PI
    dhpre = dhg * (0.5 * (1.0 + erf) + hpre * phi)
    dhb = dhpre.to(dt).float()
    dxn = torch.matmul(dhb, w1.to(dt).float().T)
    dxhat = dxn * ln_scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + gf).to(dt)
    vector_grads = (dx, rows(dxn * xhat).sum(dim=0), rows(dxn).sum(dim=0))
    if not weight_grads:
        return (*vector_grads, None, None, None, None)
    return (*vector_grads,
            torch.matmul(rows(xn).T, rows(dhb)), rows(dhpre).sum(dim=0),
            torch.matmul(rows(hg).T, rows(gf)), rows(gf).sum(dim=0))


def _check_kernel_args(name: str, x, *others) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")


def wgmma_route(dtype, d: int, hidden: int) -> bool:
    """Whether the forward kernel takes its bf16 wgmma route (three
    launches: LayerNorm into an xn workspace, fc1 into an h workspace, fc2)
    rather than the FMA kernel: bf16, with D (fc2's columns) and hidden
    (fc1's) multiples of WGMMA_TILE_N (``launch_d`` in ``csrc/mlp_block.cu``).
    The backward takes its wgmma route (five launches, ``launch`` in
    ``csrc/mlp_block_bwd.cu``) at the same shapes, its FMA products at the
    others."""
    return dtype == torch.bfloat16 and d % WGMMA_TILE_N == 0 and hidden % WGMMA_TILE_N == 0


def f32_tiled_route(dtype, d: int, hidden: int) -> bool:
    """Whether the forward kernel takes its f32 tiled route (three
    launches: LayerNorm into an f32 xn workspace, fc1 into an f32 h
    workspace, fc2, the products on ``csrc/sgemm.cuh``'s mainloop in tiles
    of ``plans.sgemm_row_tile`` rows) rather than the FMA kernel: f32, with
    D and hidden multiples of ``plans.SG_TILE_N`` (``launch_d`` in
    ``csrc/mlp_block.cu``)."""
    return (dtype == torch.float32 and d % plans.SG_TILE_N == 0
            and hidden % plans.SG_TILE_N == 0)


def backward_f32_tiled_route(dtype, d: int, hidden: int) -> bool:
    """Whether the backward kernel takes its f32 route on the f32 mainloop
    (five launches: the LayerNorm recompute, the hidden kernel's two
    products and GELU epilogue, dW1, dW2 and dxn in one launch, the
    LayerNorm backward, the second passes; ``launch_f32_tiled`` in
    ``csrc/mlp_block_bwd.cu``) rather than its FMA products: f32 with D and
    hidden multiples of ``plans.TILE``."""
    return dtype == torch.float32 and d % plans.TILE == 0 and hidden % plans.TILE == 0


def _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps: float):
    d = x.shape[-1]
    hidden = w1.shape[1]
    _check_kernel_args("fused_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2)
    if d not in KERNEL_DIMS or hidden % HIDDEN_CHUNK or x.numel() == 0:
        raise ValueError(f"fused_mlp_block kernel needs D in {KERNEL_DIMS}, "
                         f"hidden a multiple of {HIDDEN_CHUNK} and rows >= 1; "
                         f"got D={d}, hidden={hidden}, shape {tuple(x.shape)}")
    x = kbuild.aligned(x)
    rows = x.numel() // d
    f32 = [t.float().contiguous() for t in (ln_scale, ln_bias, b1, b2)]
    w1c = kbuild.aligned(w1.to(x.dtype))
    w2c = kbuild.aligned(w2.to(x.dtype))
    out = torch.empty_like(x)
    args = [x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), w1c.data_ptr(),
            f32[2].data_ptr(), w2c.data_ptr(), f32[3].data_ptr(), out.data_ptr()]
    if wgmma_route(x.dtype, d, hidden) or f32_tiled_route(x.dtype, d, hidden):
        # the tiled routes' workspaces xn (rows, D) and h (rows, hidden), in
        # one allocation freed when the call returns
        work = torch.empty((rows * (d + hidden),), device=x.device, dtype=x.dtype)
        args += [work.data_ptr(), work.data_ptr() + rows * d * work.element_size()]
    else:
        args += [None, None]
    args += [rows, d, hidden, float(ln_eps)]
    lib = kbuild.library()
    if x.dtype == torch.bfloat16:
        fn = lib.orbit_fused_mlp_block_bf16
    else:
        fn = lib.orbit_fused_mlp_block_f32
        sms = kbuild.sm_count(x.device)  # the row tiles of fc1 and fc2
        args += [plans.sgemm_row_tile(rows, hidden, sms), plans.sgemm_row_tile(rows, d, sms)]
    code = kbuild.run_on(x.device, fn, *args)
    kbuild.check(code, "fused_mlp_block")
    kbuild.LAUNCHES["fused_mlp_block"] += 1
    return out


def _launch_backward(x, ln_scale, ln_bias, w1, b1, w2, g, ln_eps: float):
    d = x.shape[-1]
    hidden = w1.shape[1]
    _check_kernel_args("fused_mlp_block_bwd", x, ln_scale, ln_bias, w1, b1, w2, g)
    if x.numel() == 0 or g.shape != x.shape or d % 8 or hidden % 8 or d > 1024:
        raise ValueError(f"fused_mlp_block_bwd kernel needs rows >= 1, D and "
                         f"hidden multiples of 8, D <= 1024 and a cotangent of x's "
                         f"shape; got {tuple(x.shape)}, hidden {hidden}, {tuple(g.shape)}")
    x = kbuild.aligned(x)
    g = kbuild.aligned(g.to(x.dtype))
    rows = x.numel() // d
    gam, bet, b1f = (kbuild.aligned(t.float()) for t in (ln_scale, ln_bias, b1))
    w1c = kbuild.aligned(w1.to(x.dtype))
    w2c = kbuild.aligned(w2.to(x.dtype))
    f32 = dict(device=x.device, dtype=torch.float32)
    f32_tiled = backward_f32_tiled_route(x.dtype, d, hidden)
    tiled = wgmma_route(x.dtype, d, hidden) or f32_tiled
    lib = kbuild.library()
    if x.dtype == torch.bfloat16:
        fn, extra = lib.orbit_fused_mlp_block_bwd_bf16, []
        partials = plans.mlp_bwd_partials(rows, d, hidden, tiled)
    else:
        fn, sms = lib.orbit_fused_mlp_block_bwd_f32, kbuild.sm_count(x.device)
        # the hidden kernel's tile rows, the grads launch's data tile rows
        # and runs of the weight gradients' K; the card's SMs
        extra = [plans.hidden_f32_rows(rows, hidden, sms),
                 *plans.sgemm_grads_plan(rows, [(d, hidden), (hidden, d)], (d, hidden), sms), sms]
        partials = (plans.mlp_bwd_f32_partials(rows, d, hidden, sms) if f32_tiled
                    else plans.mlp_bwd_partials(rows, d, hidden, False))
    work = [torch.empty((rows, 2), **f32),                             # mean, rstd
            torch.empty((rows, d), device=x.device, dtype=x.dtype),   # xn
            torch.empty((rows, hidden), device=x.device, dtype=x.dtype),  # hg
            # cast(dhpre) on the tiled routes; hpre, then dhpre, otherwise
            torch.empty((rows, hidden), device=x.device,
                        dtype=x.dtype if tiled else torch.float32),
            torch.empty((rows, d), **f32),                            # dxn
            torch.empty((partials,), **f32)]
    dx = torch.empty_like(x)
    grads = [torch.empty((d,), **f32), torch.empty((d,), **f32),
             torch.empty((d, hidden), **f32), torch.empty((hidden,), **f32),
             torch.empty((hidden, d), **f32), torch.empty((d,), **f32)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), g.data_ptr(), gam.data_ptr(), bet.data_ptr(),
                  w1c.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
                  *(t.data_ptr() for t in work), dx.data_ptr(),
                  *(t.data_ptr() for t in grads), rows, d, hidden,
                  float(ln_eps), *extra, stream)
    kbuild.check(code, "fused_mlp_block_bwd")
    kbuild.LAUNCHES["fused_mlp_block_bwd"] += 1
    return (dx, *grads)


def _use_reference(x, impl) -> bool:
    if impl not in (None, "reference", "autograd"):
        raise ValueError(f"unknown impl {impl!r} (None, 'reference' or 'autograd')")
    if impl is not None or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block kernel needs a CUDA tensor, got {x.device}")
    return False


def _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps, impl):
    if _use_reference(x, impl):
        return mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                   ln_eps=ln_eps)
    return _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)


def fused_mlp_block_backward(x, ln_scale, ln_bias, w1, b1, w2, g, *,
                             ln_eps: float = 1e-6, impl: str | None = None,
                             weight_grads: bool = True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) of :func:`fused_mlp_block` for the
    cotangent g: dx in x.dtype, the rest in f32. impl as for the forward.
    ``weight_grads=False`` lets the plain version return None for dW1, db1,
    dW2 and db2 (the kernel computes them all the same)."""
    _check_shapes(x, w1, w2)
    if _use_reference(x, impl):
        return mlp_block_backward_reference(x, ln_scale, ln_bias, w1, b1, w2, g,
                                            ln_eps=ln_eps, weight_grads=weight_grads)
    return _launch_backward(x, ln_scale, ln_bias, w1, b1, w2, g, ln_eps)


class _FusedMlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps, impl):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.ln_eps, ctx.impl = ln_eps, impl
        return _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps, impl)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = fused_mlp_block_backward(x, *params[:5], g, ln_eps=ctx.ln_eps,
                                         impl=ctx.impl,
                                         weight_grads=any(ctx.needs_input_grad[3:7]))
        return (grads[0], *(None if d is None else d.to(p.dtype)
                            for d, p in zip(grads[1:], params)), None, None)


def fused_mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
                    ln_eps: float = 1e-6, impl: str | None = None) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LayerNorm(x))))`` in one op, differentiable in x
    and the six parameters.

    impl: None (the kernels for a CUDA tensor, the plain versions for a CPU
    tensor), "reference" (the plain versions on any device) or "autograd"
    (the plain forward differentiated by autograd)."""
    _check_shapes(x, w1, w2)
    tensors = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if impl == "autograd":
        return mlp_block_reference(*tensors, ln_eps=ln_eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedMlpBlock.apply(*tensors, ln_eps, impl)
    return _forward(*tensors, ln_eps, impl)
