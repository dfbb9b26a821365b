"""Fused qkv projection + multi-head attention (kernel A), its backward
(kernel #4), the attention on a raw qkv (TPU kernels #1 and #2, the
``tiny_attention`` op), and their plain PyTorch versions.

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
``impl="autograd"`` runs the plain version as ordinary autograd ops,
with no custom backward: autograd keeps its intermediates and computes only
the gradients an input needs, as XLA differentiates the JAX package's
plain route. The MACs counter (``utils/ops_counter.py``) counts that
route; nothing else takes it.

Gradients: when autograd records (grad enabled and an input requires a
gradient) the op runs as a ``torch.autograd.Function`` that saves
``(x, kernel, bias)``, the residuals of the JAX custom_vjp
(orbit_tpu/ops/tiny_attention.py:484-486), and whose backward recomputes
qkv and the softmax: dx in x.dtype, dW and db summed in f32 and cast to the
parameters' dtype (:476). When neither the kernel nor the bias needs a
gradient (a FiLM step with the extractor frozen), the plain backward skips
dW and db, as XLA drops what no output reads; the kernel still computes
them. Under ``inference_mode`` nothing is saved.

``tiny_attention(qkv, num_heads)`` is the attention alone, on the (B, S,
3D) output of a qkv projection (``orbit_tpu/ops/tiny_attention.py:312``):
its bf16 forward kernel runs kernel A's attention strips on A's packed row
tiles, its bf16 backward #4's, both fed by a ring of ``cp.async`` copies
(``csrc/tiny_attention.cu``, planned by ``kernels/plans.py::attn_fwd_plan``
and ``attn_bwd_plan``); the backward writes dqkv in qkv's dtype.
In f32 at D a multiple of 128 (the ViTs at the CLI's default
``--compute_dtype``) the fused backward runs on the f32 mainloop
(:func:`backward_f32_tiled_route`): kernel A's packed row tiles recompute
qkv on chip and run the attention backward there, then dW and dx share one
launch.
Like its JAX counterpart, which no learner, backbone or script calls, no
path of the port calls it: the ViTs always go through the fused op.
"""
from __future__ import annotations

import math

import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans

HEAD_DIM = 64      # the kernel's head width (every supported ViT)
MAX_TOKENS = 64    # the kernel's longest sequence (50 tokens at 224 px)
ROW_TILE = 128     # rows of x per block of kernel A's bf16 route
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


def _check_qkv(qkv, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, S, 3D) with D divisible "
                         f"into {num_heads} heads")


def _project(x, kernel, bias):
    """The recomputed projection: cast(f32 GEMM + b) in x.dtype, the bias
    cast to x.dtype first."""
    dt = x.dtype
    return (torch.matmul(x.float(), kernel.to(dt).float()) + bias.to(dt).float()).to(dt)


def _head_softmax(qkv, num_heads: int):
    """The shared recompute of the forward and backward plain versions
    (the TPU kernels' ``_head_softmax``): q, k, v (n, H, s, hd) as f32
    views of their qkv.dtype values, and the f32 softmax p (n, H, s, s);
    scores are scaled after the dot."""
    n, s, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    q, k, v = qkv.float().view(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return q, k, v, p / p.sum(dim=-1, keepdim=True)


def attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of TPU kernel #1 (``_attend_blocked``'s rounding
    points): scores and softmax in f32, p cast to qkv.dtype before the AV
    product, AV accumulated in f32 and cast to qkv.dtype."""
    _check_qkv(qkv, num_heads)
    n, s, d3 = qkv.shape
    _, _, v, p = _head_softmax(qkv, num_heads)
    out = torch.matmul(p.to(qkv.dtype).float(), v)      # (n, H, s, hd) f32
    return out.transpose(1, 2).reshape(n, s, d3 // 3).to(qkv.dtype)


def _dqkv_f32(qkv, g, num_heads: int):
    """The attention backward in f32 with the TPU kernels' rounding points
    (``_attend_blocked_bwd``, orbit_tpu/ops/tiny_attention.py:207-244): dv =
    cast(p)ᵀg, dp = g vᵀ, ds = p∘(dp − rowsum(dp∘p)), dq = cast(ds·scale) k,
    dk = cast(ds·scale)ᵀq, as an f32 (n, s, 3D) in qkv's column order."""
    dt = qkv.dtype
    n, s, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    q, k, v, p = _head_softmax(qkv, num_heads)
    gh = g.to(dt).float().view(n, s, num_heads, hd).transpose(1, 2)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = (ds * (1.0 / math.sqrt(hd))).to(dt).float()
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    # (3, n, H, s, hd) -> (n, s, 3, H, hd): columns [q heads | k heads | v heads]
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(n, s, d3)


def attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int) -> torch.Tensor:
    """Plain version of TPU kernel #2: dqkv in qkv.dtype (the f32 sums
    rounded once, as ``out_struct((n, s, d3), qkv.dtype)`` at :273)."""
    _check_qkv(qkv, num_heads)
    return _dqkv_f32(qkv, g, num_heads).to(qkv.dtype)


def qkv_attention_reference(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: the
    bias is cast to x.dtype, qkv = (f32 GEMM + b) cast to x.dtype, then
    :func:`attention_reference`."""
    _check_shapes(x, kernel, bias, num_heads)
    return attention_reference(_project(x, kernel, bias), num_heads)


def qkv_attention_backward_reference(x, kernel, bias, g, num_heads: int,
                                     weight_grads: bool = True):
    """Plain backward with the TPU kernel's rounding points
    (orbit_tpu/ops/tiny_attention.py:403-421): the recomputed qkv, the f32
    dqkv of :func:`attention_backward_reference` before its cast; then dx =
    cast(dqkv)·Wᵀ cast to x.dtype, dW = xᵀ·cast(dqkv) and db = colsum(dqkv)
    in f32. Returns (dx, dW, db); without ``weight_grads`` dW and db are
    None and not computed."""
    _check_shapes(x, kernel, bias, num_heads)
    dt = x.dtype
    n, s, d = x.shape
    dqkv = _dqkv_f32(_project(x, kernel, bias), g, num_heads).reshape(n * s, 3 * d)
    dqkv_t = dqkv.to(dt).float()
    dx = torch.matmul(dqkv_t, kernel.to(dt).float().T).to(dt).view(n, s, d)
    if not weight_grads:
        return dx, None, None
    dw = torch.matmul(x.float().reshape(n * s, d).T, dqkv_t)
    return dx, dw, dqkv.sum(dim=0)


def qkv_attention_backward_stages(x, kernel, bias, g, num_heads: int):
    """The plain backward cut where the kernel's bf16 route cuts it into
    launches: ((qkv, dqkv_t), grads). qkv (x.dtype) is the recompute
    launch's output, dqkv_t = cast(dqkv) (x.dtype, (B·S, 3D)) the attention
    launch's, which also writes db's per-row partials; grads is
    :func:`qkv_attention_backward_reference`'s (dx, dW, db), bit for bit."""
    _check_shapes(x, kernel, bias, num_heads)
    dt = x.dtype
    n, s, d = x.shape
    qkv = _project(x, kernel, bias)
    dqkv = _dqkv_f32(qkv, g, num_heads).reshape(n * s, 3 * d)
    dqkv_t = dqkv.to(dt).float()
    dx = torch.matmul(dqkv_t, kernel.to(dt).float().T).to(dt).view(n, s, d)
    dw = torch.matmul(x.float().reshape(n * s, d).T, dqkv_t)
    return (qkv, dqkv_t.to(dt)), (dx, dw, dqkv.sum(dim=0))


def backward_wgmma_route(dtype, d: int) -> bool:
    """Whether the backward kernel takes its bf16 wgmma route (four
    launches: the qkv recompute, the attention backward on the tensor
    cores, dW and dx in one launch, db's second pass; ``launch`` in
    ``csrc/fused_qkv_attention_bwd.cu``) rather than its FMA stages: bf16
    with D a multiple of the products' tile width."""
    return dtype == torch.bfloat16 and d % plans.TILE == 0


def backward_f32_tiled_route(dtype, d: int) -> bool:
    """Whether the backward kernel takes its f32 route on the f32 mainloop
    (three launches: the qkv recompute and the attention backward on
    kernel A's packed row tiles of ``plans.qkv_bwd_f32_rows`` rows, dW and
    dx in one launch, db's second pass; ``launch_f32_tiled`` in
    ``csrc/fused_qkv_attention_bwd.cu``) rather than its FMA stages: f32
    with D a multiple of the products' tile width."""
    return dtype == torch.float32 and d % plans.TILE == 0


def _check_kernel_args(name: str, x, d: int, num_heads: int, *others) -> None:
    """Refuse what the kernels cannot take; ``d`` is the attention width
    (x's last dimension, or a third of a raw qkv's)."""
    n, s = x.shape[:2]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if d // num_heads != HEAD_DIM or s > MAX_TOKENS or n < 1:
        raise ValueError(f"{name} kernel needs head dim {HEAD_DIM}, "
                         f"1 <= S <= {MAX_TOKENS} and B >= 1; got (B,S,D,H)="
                         f"{(n, s, d, num_heads)}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")


def sequence_tiles(b: int, s: int) -> tuple[int, int]:
    """The bf16 route's row tiles of kernel A (``csrc/fused_qkv_attention.cu``):
    (sequences per tile, tiles). A tile packs floor(ROW_TILE / S) whole
    sequences of B; tile t holds sequences t*n .. min(B, (t+1)*n) - 1."""
    n = ROW_TILE // s
    return n, -(-b // n)


def _launch(x, kernel, bias, num_heads: int) -> torch.Tensor:
    _check_kernel_args("fused_qkv_attention", x, x.shape[-1], num_heads, kernel, bias)
    n, s, d = x.shape
    x = kbuild.aligned(x)
    w = kbuild.aligned(kernel.to(x.dtype))
    b = kbuild.aligned(bias.to(x.dtype))
    out = torch.empty_like(x)
    lib = kbuild.library()
    if x.dtype == torch.bfloat16:
        fn, nseq = lib.orbit_fused_qkv_attention_bf16, sequence_tiles(n, s)[0]
    else:
        fn = lib.orbit_fused_qkv_attention_f32
        nseq = plans.qkv_f32_rows(n, s, num_heads, kbuild.sm_count(x.device)) // s
    code = kbuild.run_on(x.device, fn, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         out.data_ptr(), n, s, d, num_heads, nseq)
    kbuild.check(code, "fused_qkv_attention")
    kbuild.LAUNCHES["fused_qkv_attention"] += 1
    return out


def _launch_backward(x, kernel, bias, g, num_heads: int):
    _check_kernel_args("fused_qkv_attention_bwd", x, x.shape[-1], num_heads, kernel, bias, g)
    n, s, d = x.shape
    _check_cotangent(g, (n, s, d))
    x = kbuild.aligned(x)
    g = kbuild.aligned(g.to(x.dtype))
    w = kbuild.aligned(kernel.to(x.dtype))
    b = bias.to(x.dtype).contiguous()
    f32 = dict(device=x.device, dtype=torch.float32)
    wgmma = backward_wgmma_route(x.dtype, d)
    tiled = backward_f32_tiled_route(x.dtype, d)
    # the f32 route keeps qkv on chip; the others recompute it into memory
    qkv = None if tiled else torch.empty((n, s, 3 * d), device=x.device, dtype=x.dtype)
    # cast(dqkv) on the wgmma route, the f32 sums otherwise
    dqkv = torch.empty((n, s, 3 * d), device=x.device,
                       dtype=x.dtype if wgmma else torch.float32)
    lib = kbuild.library()
    if x.dtype == torch.bfloat16:
        fn, extra = lib.orbit_fused_qkv_attention_bwd_bf16, []
        partials = plans.qkv_bwd_partials(n, s, d, wgmma)
    else:
        fn, sms = lib.orbit_fused_qkv_attention_bwd_f32, kbuild.sm_count(x.device)
        # the f32 route's plan: sequences a row tile, the grads launch's
        # data tile rows and runs of dW's K; the card's SMs
        extra = [plans.qkv_bwd_f32_rows(n, s, num_heads, sms) // s,
                 *plans.sgemm_grads_plan(n * s, [(d, 3 * d)], (d, 3 * d), sms), sms]
        partials = (plans.qkv_bwd_f32_partials(n, s, d, num_heads, sms) if tiled
                    else plans.qkv_bwd_partials(n, s, d, False))
    partial = torch.empty((partials,), **f32)
    dx = torch.empty_like(x)
    dw = torch.empty((d, 3 * d), **f32)
    db = torch.empty((3 * d,), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                  None if qkv is None else qkv.data_ptr(), dqkv.data_ptr(),
                  partial.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), n, s, d,
                  num_heads, *extra, stream)
    kbuild.check(code, "fused_qkv_attention_bwd")
    kbuild.LAUNCHES["fused_qkv_attention_bwd"] += 1
    return dx, dw, db


def _check_cotangent(g, shape) -> None:
    if tuple(g.shape) != shape:
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {shape}")


def _launch_attention(qkv, num_heads: int) -> torch.Tensor:
    """#1 on a CUDA tensor; bf16 with the plan :func:`plans.attn_fwd_plan`."""
    n, s, d3 = qkv.shape
    _check_kernel_args("tiny_attention", qkv, d3 // 3, num_heads)
    qkv = kbuild.aligned(qkv)  # 16-byte copies
    out = torch.empty((n, s, d3 // 3), device=qkv.device, dtype=qkv.dtype)
    lib = kbuild.library()
    args = [qkv.data_ptr(), out.data_ptr(), n, s, d3 // 3, num_heads]
    if qkv.dtype == torch.bfloat16:
        plan = plans.attn_fwd_plan(n, s, num_heads, kbuild.sm_count(qkv.device))
        fn = lib.orbit_tiny_attention_bf16
        args += [plan.nseq, plan.rows, plan.blocks]
    else:
        fn = lib.orbit_tiny_attention_f32
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(*args, stream)
    kbuild.check(code, "tiny_attention")
    kbuild.LAUNCHES["tiny_attention"] += 1
    return out


def _launch_attention_backward(qkv, g, num_heads: int) -> torch.Tensor:
    """#2 on a CUDA tensor; bf16 with the plan :func:`plans.attn_bwd_plan`."""
    n, s, d3 = qkv.shape
    _check_kernel_args("tiny_attention_bwd", qkv, d3 // 3, num_heads, g)
    _check_cotangent(g, (n, s, d3 // 3))
    qkv = kbuild.aligned(qkv)  # 16-byte copies
    g = kbuild.aligned(g.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    lib = kbuild.library()
    args = [qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), n, s, d3 // 3, num_heads]
    if qkv.dtype == torch.bfloat16:
        fn = lib.orbit_tiny_attention_bwd_bf16
        args.append(plans.attn_bwd_plan(n, s, num_heads, kbuild.sm_count(qkv.device)).blocks)
    else:
        fn = lib.orbit_tiny_attention_bwd_f32
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(*args, stream)
    kbuild.check(code, "tiny_attention_bwd")
    kbuild.LAUNCHES["tiny_attention_bwd"] += 1
    return dqkv


def _use_reference(x, impl, name: str = "fused_qkv_attention") -> bool:
    if impl not in (None, "reference", "autograd"):
        raise ValueError(f"unknown impl {impl!r} (None, 'reference' or 'autograd')")
    if impl is not None or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    return False


def _forward(x, kernel, bias, num_heads, impl):
    if _use_reference(x, impl):
        return qkv_attention_reference(x, kernel, bias, num_heads)
    return _launch(x, kernel, bias, num_heads)


def fused_qkv_attention_backward(x, kernel, bias, g, num_heads: int, *,
                                 impl: str | None = None, weight_grads: bool = True):
    """(dx, dW, db) of :func:`fused_qkv_attention` for the cotangent g:
    dx in x.dtype, dW and db in f32. impl as for the forward.
    ``weight_grads=False`` lets the plain version return None for dW and db
    (the kernel computes them all the same)."""
    _check_shapes(x, kernel, bias, num_heads)
    if _use_reference(x, impl):
        return qkv_attention_backward_reference(x, kernel, bias, g, num_heads,
                                                weight_grads=weight_grads)
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
        dx, dw, db = fused_qkv_attention_backward(
            x, kernel, bias, g, ctx.num_heads, impl=ctx.impl,
            weight_grads=any(ctx.needs_input_grad[1:3]))
        return (dx, None if dw is None else dw.to(kernel.dtype),
                None if db is None else db.to(bias.dtype), None, None)


def fused_qkv_attention(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, num_heads: int, *,
                        impl: str | None = None) -> torch.Tensor:
    """qkv projection + multi-head attention in one op, differentiable in
    x, kernel and bias.

    impl: None (the kernels for a CUDA tensor, the plain versions for a CPU
    tensor), "reference" (the plain versions on any device) or "autograd"
    (the plain forward differentiated by autograd)."""
    _check_shapes(x, kernel, bias, num_heads)
    if impl == "autograd":
        return qkv_attention_reference(x, kernel, bias, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return _FusedQkvAttention.apply(x, kernel, bias, num_heads, impl)
    return _forward(x, kernel, bias, num_heads, impl)


# ------------------------------------------- attention on a raw qkv ----
def _attention_forward(qkv, num_heads, impl):
    if _use_reference(qkv, impl, "tiny_attention"):
        return attention_reference(qkv, num_heads)
    return _launch_attention(qkv, num_heads)


def tiny_attention_backward(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, *,
                            impl: str | None = None) -> torch.Tensor:
    """dqkv (B, S, 3D) in qkv.dtype of :func:`tiny_attention` for the
    cotangent g (B, S, D): TPU kernel #2's counterpart on a CUDA tensor.
    impl as for the forward."""
    _check_qkv(qkv, num_heads)
    if _use_reference(qkv, impl, "tiny_attention_bwd"):
        return attention_backward_reference(qkv, g, num_heads)
    return _launch_attention_backward(qkv, g, num_heads)


class _TinyAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, impl):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.impl = num_heads, impl
        return _attention_forward(qkv, num_heads, impl)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return tiny_attention_backward(qkv, g, ctx.num_heads, impl=ctx.impl), None, None


def tiny_attention(qkv: torch.Tensor, num_heads: int, *,
                   impl: str | None = None) -> torch.Tensor:
    """Multi-head self-attention on a raw (B, S, 3D) qkv projection (columns
    [q | k | v], heads contiguous inside each) -> (B, S, D) in qkv.dtype,
    differentiable in qkv (counterpart of
    ``orbit_tpu/ops/tiny_attention.py::tiny_attention``). On a CUDA tensor
    the forward is TPU kernel #1's counterpart and the backward #2's
    (``csrc/tiny_attention.cu``); both need head dim 64 and S <= 64 and
    raise otherwise.

    impl: None (the kernels for a CUDA tensor, the plain versions for a CPU
    tensor), "reference" (the plain versions on any device) or "autograd"
    (the plain forward differentiated by autograd)."""
    _check_qkv(qkv, num_heads)
    if impl == "autograd":
        return attention_reference(qkv, num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _TinyAttention.apply(qkv, num_heads, impl)
    return _attention_forward(qkv, num_heads, impl)
