"""The port's kernel ops (``orbit_tpu_torch.ops``) held against the JAX
package, and the CUDA kernels held against their plain PyTorch versions.

On a host without a card the port's ops take their plain versions, which
are compared with the JAX ops run as the JAX suite runs them on the CPU:
``impl="interpret"`` (the Pallas kernel body in the interpreter) and
``impl="xla"``; the backward through the ops' autograd Functions against
the JAX ops' ``jax.vjp``. Inputs are made with numpy from a seed and fed to
both.
Tests marked ``cuda`` compare each kernel with its plain version on the
card at the path's shapes (the ViTs for kernels A, B, #4 and #6,
EfficientNet-B0 for the depthwise tail #8, SimpleCNAPs for the Mahalanobis
logits #7); they skip without one. JAX is imported only inside
the JAX comparisons, so the ``cuda`` tests also run where JAX is absent:
``python -m pytest --noconftest tests/test_torch_ops.py -m cuda``.

Tolerances:
- f32: the two sides differ only in summation order (and, for the MLP, the
  TPU kernel's polynomial erf, |err| <= 2e-6 in f32), so 1e-5 relative
  plus a small absolute term for values near zero.
- bf16: both sides round at the same points, but a value an f32 sum puts
  on either side of a bf16 rounding boundary rounds one ulp apart, and that
  ulp travels on through the later products. bf16 has 8 significant bits
  (one ulp is 2^-8 to 2^-7 of a value), so two ulps: 2^-6 relative, plus the
  same absolute term scaled to the outputs' O(1) size.
- The depthwise tail (#8) and the Mahalanobis logits (#7), per tensor
  against its largest value. f32: summation order only (the K*K taps; the
  D*D quadratic form, whose terms cancel), 1e-5 for #8 and 1e-5 for #7.
  bf16 (#8 only): both sides round the activated input to bf16, and a value
  an f32 affine puts on either side of a rounding boundary flips one ulp
  (2^-8..2^-7) that the taps carry into each sum, then the output rounds
  once more: 2^-6, as for the other bf16 ops.
- Gradients, per tensor against its largest value (the parameter gradients
  are sums over all B*S rows, with many terms near zero). f32: summation
  order only, 1e-5. bf16: both sides round qkv, p, ds, dqkv, xn, hg and
  dhpre at the same points, and a one-ulp flip of one element feeds the
  later sums: 2^-6, as for the outputs.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.ops import (fused_dw_act, fused_mlp_block, fused_mlp_block_backward,
                                 fused_qkv_attention, fused_qkv_attention_backward,
                                 mahalanobis_logits, mlp_block_reference,
                                 qkv_attention_reference)
from orbit_tpu_torch.ops import depthwise as dw_mod
from orbit_tpu_torch.ops import mahalanobis as maha_mod
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops import tiny_attention as attn_mod

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -6, atol=2.0 ** -6)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# the depthwise tail and the Mahalanobis logits, against the largest value
DW_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
MAHALANOBIS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops. Under a suite that
    loads every core, OpenMP's fork/join on each tiny op stalls on
    descheduled threads (a test ran 30x slower than alone) and its spinning
    threads slow the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv_inputs(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (rng.standard_normal((d, 3 * d)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(3 * d)).astype(np.float32))


def _mlp_inputs(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    hid = 4 * d
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            (rng.standard_normal((d, hid)) / np.sqrt(d)).astype(np.float32),
            (0.02 * rng.standard_normal(hid)).astype(np.float32),
            (rng.standard_normal((hid, d)) / np.sqrt(hid)).astype(np.float32),
            (0.02 * rng.standard_normal(d)).astype(np.float32))


def _torch(arrays, dtype, keep_f32=(), device="cpu"):
    """numpy -> torch; the MLP's LN/bias vectors stay f32 like the TPU
    kernel receives them (indices in keep_f32)."""
    return [torch.from_numpy(a).to(device=device,
                                   dtype=torch.float32 if i in keep_f32 else dtype)
            for i, a in enumerate(arrays)]


def _jax_arrays(arrays, dtype, keep_f32=()):
    jnp = pytest.importorskip("jax.numpy")
    return [jnp.asarray(a).astype("float32" if i in keep_f32 else dtype)
            for i, a in enumerate(arrays)]


def _close(ours: torch.Tensor, ref, dtype: str):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref).astype(np.float32), **TOL[dtype])


# ------------------------------------------------- port vs JAX (CPU) ----
# B = 5 against the Pallas body (interpret) and XLA; a ragged B = 3 (the
# TPU kernel pads the batch to its 8-row block) against the Pallas body
JAX_CASES = [(5, "interpret"), (5, "xla"), (3, "interpret")]

@pytest.mark.parametrize("batch,jax_impl", JAX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_attention_matches_jax(jax_impl, dtype, batch):
    from orbit_tpu.ops.tiny_attention import fused_qkv_attention as jax_op
    arrays = _qkv_inputs(batch, 50, 128)
    ref = jax_op(*_jax_arrays(arrays, dtype), 2, impl=jax_impl)
    ours = fused_qkv_attention(*_torch(arrays, getattr(torch, dtype)), 2)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (batch, 50, 128)
    _close(ours, ref, dtype)


@pytest.mark.parametrize("batch,jax_impl", JAX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_matches_jax(jax_impl, dtype, batch):
    from orbit_tpu.ops.mlp_block import fused_mlp_block as jax_op
    arrays = _mlp_inputs(batch, 50, 128)
    ref = jax_op(*_jax_arrays(arrays, dtype, keep_f32=(1, 2, 4, 6)),
                 ln_eps=1e-6, impl=jax_impl)
    ours = fused_mlp_block(*_torch(arrays, getattr(torch, dtype),
                                   keep_f32=(1, 2, 4, 6)), ln_eps=1e-6)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (batch, 50, 128)
    _close(ours, ref, dtype)


def _grads_close(ours, refs, dtype: str):
    for i, (a, r) in enumerate(zip(ours, refs)):
        r = np.asarray(r).astype(np.float32)
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(r).max(),
                                   err_msg=f"gradient {i}")


def _jax_vjp(op, primals, cotangent):
    """The JAX op's vjp at ``primals``, compiled: one cotangent per primal."""
    import jax
    return jax.jit(lambda p, g: jax.vjp(op, *p)[1](g))(tuple(primals), cotangent)


# the backward: f32 against the Pallas backward body (interpret) and XLA at
# B = 5 and a ragged 3; bf16 against the Pallas body. x and the cotangent
# are in the dtype, the parameters f32, as the train path holds them.
BWD_CASES = [("float32", 5, "interpret"), ("float32", 5, "xla"),
             ("float32", 3, "interpret"), ("bfloat16", 5, "interpret"),
             ("bfloat16", 3, "interpret")]


@pytest.mark.parametrize("dtype,batch,jax_impl", BWD_CASES)
def test_qkv_attention_backward_matches_jax(dtype, batch, jax_impl):
    from orbit_tpu.ops.tiny_attention import fused_qkv_attention as jax_op
    arrays = _qkv_inputs(batch, 50, 128, seed=3)
    cot = np.random.default_rng(4).standard_normal((batch, 50, 128)).astype(np.float32)
    refs = _jax_vjp(lambda x, w, b: jax_op(x, w, b, 2, impl=jax_impl),
                    _jax_arrays(arrays, dtype, keep_f32=(1, 2)),
                    _jax_arrays([cot], dtype)[0])
    x, w, b = (t.requires_grad_() for t in _torch(arrays, getattr(torch, dtype),
                                                   keep_f32=(1, 2)))
    fused_qkv_attention(x, w, b, 2).backward(_torch([cot], getattr(torch, dtype))[0])
    assert x.grad.dtype == x.dtype and w.grad.dtype == b.grad.dtype == torch.float32
    _grads_close((x.grad, w.grad, b.grad), refs, dtype)


@pytest.mark.parametrize("dtype,batch,jax_impl", BWD_CASES)
def test_mlp_block_backward_matches_jax(dtype, batch, jax_impl):
    from orbit_tpu.ops.mlp_block import fused_mlp_block as jax_op
    arrays = _mlp_inputs(batch, 50, 128, seed=5)
    cot = np.random.default_rng(6).standard_normal((batch, 50, 128)).astype(np.float32)
    keep = (1, 2, 3, 4, 5, 6)
    refs = _jax_vjp(lambda *a: jax_op(*a, ln_eps=1e-6, impl=jax_impl),
                    _jax_arrays(arrays, dtype, keep_f32=keep),
                    _jax_arrays([cot], dtype)[0])
    params = [t.requires_grad_() for t in _torch(arrays, getattr(torch, dtype),
                                                  keep_f32=keep)]
    fused_mlp_block(*params, ln_eps=1e-6).backward(_torch([cot], getattr(torch, dtype))[0])
    assert params[0].grad.dtype == params[0].dtype
    _grads_close([p.grad for p in params], refs, dtype)


def _dw_inputs(n, h, c, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, h, c)).astype(np.float32),
            (0.3 * rng.standard_normal((k, k, 1, c))).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32))


def _close_to_max(ours: torch.Tensor, ref, tol: float):
    ref = np.asarray(ref).astype(np.float32)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


# H = W in {8, 9}, K in {3, 5}: TF-SAME pads K // 2 on both sides at stride 1
DW_CASES = [(h, k, act1) for h in (8, 9) for k in (3, 5) for act1 in (True, False)]


@pytest.mark.parametrize("h,k,act1", DW_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dw_matches_jax(dtype, h, k, act1):
    """Stride 1 against the Pallas body (interpret), the TPU kernel's path."""
    from orbit_tpu.ops.depthwise import fused_dw_act as jax_op
    x, *rest = _dw_inputs(2, h, 16, k, seed=h + k)
    jx, *jrest = _jax_arrays([x, *rest], dtype, keep_f32=(1, 2, 3, 4, 5))
    ref = jax_op(jx, *jrest, stride=1, act1=act1, act2=True, impl="interpret")
    ours = fused_dw_act(*_torch([x, *rest], getattr(torch, dtype), keep_f32=(1, 2, 3, 4, 5)),
                        act1=act1, act2=True)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (2, h, h, 16)
    _close_to_max(ours, ref, DW_TOL[dtype])


def _maha_inputs(m, d, c, seed=0, real=None):
    """Features, class means, symmetric positive-definite precisions (the
    inverses of covariances + I, as the head makes them) and a class mask
    whose first ``real`` classes are real (all but the last by default) and
    the rest padding."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, d)).astype(np.float32)
    means = (0.5 * rng.standard_normal((c, d))).astype(np.float32)
    g = rng.standard_normal((c, d, 2 * d)).astype(np.float32) / np.sqrt(2 * d)
    prec = np.linalg.inv(g @ g.transpose(0, 2, 1) + np.eye(d, dtype=np.float32))
    mask = (np.arange(c) < (c - 1 if real is None else real)).astype(np.float32)
    return feats, means, prec.astype(np.float32), mask


@pytest.mark.parametrize("jax_impl", ["interpret", "xla"])
def test_mahalanobis_matches_jax(jax_impl):
    """M = 24, D = 384 (three 128-wide D tiles of the TPU kernel), C = 5
    with one padded class."""
    from orbit_tpu.ops.mahalanobis import mahalanobis_logits as jax_op
    arrays = _maha_inputs(24, 384, 5)
    jf, jm, jp, jmask = _jax_arrays(arrays, "float32")
    ref = np.asarray(jax_op(jf, jm, jp, class_mask=jmask, logit_scale=0.5, force=jax_impl))
    ours = mahalanobis_logits(*_torch(arrays, torch.float32), logit_scale=0.5)
    assert ours.dtype == torch.float32 and ours.shape == (24, 5)
    assert (ours[:, -1] == -1e30).all() and (ref[:, -1] == -1e30).all()
    _close_to_max(ours[:, :-1], ref[:, :-1], MAHALANOBIS_TOL)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel launcher")
    monkeypatch.setattr(attn_mod, "_launch", no_kernel)
    monkeypatch.setattr(mlp_mod, "_launch", no_kernel)
    monkeypatch.setattr(dw_mod, "_launch", no_kernel)
    monkeypatch.setattr(maha_mod, "_launch", no_kernel)
    before = dict(kbuild.LAUNCHES)
    q = _torch(_qkv_inputs(2, 7, 128), torch.float32)
    assert torch.equal(fused_qkv_attention(*q, 2), qkv_attention_reference(*q, 2))
    m = _torch(_mlp_inputs(2, 7, 64), torch.float32)
    assert torch.equal(fused_mlp_block(*m, ln_eps=1e-5),
                       mlp_block_reference(*m, ln_eps=1e-5))
    d = _torch(_dw_inputs(2, 8, 16, 3), torch.float32)
    assert torch.equal(fused_dw_act(*d), dw_mod.fused_dw_reference(*d, act1=True, act2=True))
    h = _torch(_maha_inputs(3, 16, 2), torch.float32)
    assert torch.equal(mahalanobis_logits(*h), maha_mod.mahalanobis_reference(*h))
    assert kbuild.LAUNCHES == before


def test_kernel_impl_needs_a_cuda_tensor():
    # only a CPU tensor takes the plain version by itself; any other
    # non-CUDA tensor (here "meta") must reach the kernel path and raise
    q = _torch(_qkv_inputs(1, 5, 64), torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_qkv_attention(*q, 1)
    m = _torch(_mlp_inputs(1, 5, 64), torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp_block(*m)
    with pytest.raises(ValueError, match="unknown impl"):
        fused_qkv_attention(*q, 1, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        fused_mlp_block(*m, impl="xla")
    d = _torch(_dw_inputs(1, 8, 16, 3), torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_dw_act(*d)
    h = _torch(_maha_inputs(3, 16, 2), torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mahalanobis_logits(*h)
    with pytest.raises(ValueError, match="unknown impl"):
        fused_dw_act(*d, impl="interpret")


def test_shape_errors_raise():
    x, w, b = _torch(_qkv_inputs(2, 5, 64), torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        fused_qkv_attention(x, w[:, :-1], b, 1)
    with pytest.raises(ValueError, match="do not match"):
        fused_qkv_attention(x, w, b[:-1], 1)
    with pytest.raises(ValueError, match="not divisible"):
        fused_qkv_attention(x, w, b, 3)
    x, g, beta, w1, b1, w2, b2 = _torch(_mlp_inputs(2, 5, 64), torch.float32)
    with pytest.raises(ValueError, match="do not chain"):
        fused_mlp_block(x, g, beta, w1[:-1], b1, w2, b2)
    with pytest.raises(ValueError, match="do not chain"):
        fused_mlp_block(x, g, beta, w1, b1, w2[:-1], b2)
    x, w, *aff = _torch(_dw_inputs(1, 8, 16, 3), torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        fused_dw_act(x, w[..., :-8], *aff)
    f, mu, p, mask = _torch(_maha_inputs(3, 16, 2), torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        mahalanobis_logits(f, mu, p[:, :-1], mask)


# ------------------------------------- CUDA kernels vs plain (card) ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


VIT_SHAPES = [(256, 50, 768, 12), (13, 50, 768, 12), (256, 50, 384, 6),
              (13, 50, 384, 6), (3, 5, 384, 6), (5, 50, 128, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_qkv_attention_kernel_matches_plain(cuda_device, dtype, shape):
    b, s, d, h = shape
    args = _torch(_qkv_inputs(b, s, d, seed=1), getattr(torch, dtype),
                  device=cuda_device)
    with torch.inference_mode():
        n0 = kbuild.LAUNCHES["fused_qkv_attention"]
        ours = fused_qkv_attention(*args, h)
        assert kbuild.LAUNCHES["fused_qkv_attention"] == n0 + 1
        ref = fused_qkv_attention(*args, h, impl="reference")
    torch.cuda.synchronize()
    np.testing.assert_allclose(ours.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mlp_block_kernel_matches_plain(cuda_device, dtype, shape):
    b, s, d, _ = shape
    args = _torch(_mlp_inputs(b, s, d, seed=2), getattr(torch, dtype),
                  keep_f32=(1, 2, 4, 6), device=cuda_device)
    with torch.inference_mode():
        n0 = kbuild.LAUNCHES["fused_mlp_block"]
        ours = fused_mlp_block(*args, ln_eps=1e-6)
        assert kbuild.LAUNCHES["fused_mlp_block"] == n0 + 1
        ref = fused_mlp_block(*args, ln_eps=1e-6, impl="reference")
    torch.cuda.synchronize()
    np.testing.assert_allclose(ours.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


# the backward kernels at the ViT-B/32 and ViT-S/32 shapes, B = 256 and 13
BWD_SHAPES = VIT_SHAPES[:4] + [(5, 50, 128, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_qkv_attention_backward_kernel_matches_plain(cuda_device, dtype, shape):
    b, s, d, h = shape
    dt = getattr(torch, dtype)
    args = _torch(_qkv_inputs(b, s, d, seed=7), dt, device=cuda_device)
    cot = torch.randn(b, s, d, device=cuda_device).to(dt)
    n0 = kbuild.LAUNCHES["fused_qkv_attention_bwd"]
    ours = fused_qkv_attention_backward(*args, cot, h)
    assert kbuild.LAUNCHES["fused_qkv_attention_bwd"] == n0 + 1
    again = fused_qkv_attention_backward(*args, cot, h)
    ref = fused_qkv_attention_backward(*args, cot, h, impl="reference")
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(ours, again))  # no atomics
    _grads_close([t.cpu() for t in ours], [t.float().cpu().numpy() for t in ref], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mlp_block_backward_kernel_matches_plain(cuda_device, dtype, shape):
    b, s, d, _ = shape
    dt = getattr(torch, dtype)
    # x, ln_scale, ln_bias, w1, b1, w2 (the backward takes no b2)
    args = _torch(_mlp_inputs(b, s, d, seed=8), dt, keep_f32=(1, 2, 4, 6),
                  device=cuda_device)[:6]
    cot = torch.randn(b, s, d, device=cuda_device).to(dt)
    n0 = kbuild.LAUNCHES["fused_mlp_block_bwd"]
    ours = fused_mlp_block_backward(*args, cot, ln_eps=1e-6)
    assert kbuild.LAUNCHES["fused_mlp_block_bwd"] == n0 + 1
    again = fused_mlp_block_backward(*args, cot, ln_eps=1e-6)
    ref = fused_mlp_block_backward(*args, cot, ln_eps=1e-6, impl="reference")
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(ours, again))  # no atomics
    _grads_close([t.cpu() for t in ours], [t.float().cpu().numpy() for t in ref], dtype)


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels(cuda_device):
    x, w, b = (t.requires_grad_() for t in _torch(_qkv_inputs(2, 5, 128), torch.float32,
                                                   device=cuda_device))
    before = dict(kbuild.LAUNCHES)
    fused_qkv_attention(x, w, b, 2).sum().backward()
    m = [t.requires_grad_() for t in _torch(_mlp_inputs(2, 5, 128), torch.float32,
                                             device=cuda_device)]
    fused_mlp_block(*m).sum().backward()
    torch.cuda.synchronize()
    for name in ("fused_qkv_attention", "fused_mlp_block", "fused_qkv_attention_bwd",
                 "fused_mlp_block_bwd"):
        assert kbuild.LAUNCHES[name] == before[name] + 1, name
    assert all(t.grad is not None for t in (x, w, b, *m))


# the depthwise tail at EfficientNet-B0's 12 stride-1 shapes at 224 px
# (H, C, K, act1), at a ragged batch of 13 and a small one
B0_DW_SHAPES = [(112, 32, 3, False), (56, 144, 3, True), (28, 240, 5, True),
                (14, 480, 3, True), (14, 480, 5, True), (14, 672, 5, True),
                (7, 1152, 5, True), (7, 1152, 3, True), (9, 16, 5, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B0_DW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_dw_kernel_matches_plain(cuda_device, dtype, shape):
    h, c, k, act1 = shape
    args = _torch(_dw_inputs(13, h, c, k, seed=9), getattr(torch, dtype),
                  keep_f32=(1, 2, 3, 4, 5), device=cuda_device)
    n0 = kbuild.LAUNCHES["fused_dw_act"]
    ours = fused_dw_act(*args, act1=act1)
    assert kbuild.LAUNCHES["fused_dw_act"] == n0 + 1
    again = fused_dw_act(*args, act1=act1)
    ref = fused_dw_act(*args, act1=act1, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    _close_to_max(ours.cpu(), ref.float().cpu().numpy(), DW_TOL[dtype])


# (M, C, real classes): the last, the SimpleCNAPs path's batched query of
# 5 videos x 200 frames against a 5-object episode's 16 class slots
@pytest.mark.cuda
@pytest.mark.parametrize("m,c,real", [(256, 5, 4), (13, 5, 4), (256, 10, 9), (3, 2, 1),
                                      (1000, 16, 5)])
def test_mahalanobis_kernel_matches_plain(cuda_device, m, c, real):
    d = 1280 if m != 3 else 40  # D = 40: a ragged last tile of D
    args = _torch(_maha_inputs(m, d, c, seed=m + c, real=real), torch.float32,
                  device=cuda_device)
    n0 = kbuild.LAUNCHES["mahalanobis_logits"]
    ours = mahalanobis_logits(*args, logit_scale=0.5)
    assert kbuild.LAUNCHES["mahalanobis_logits"] == n0 + 1
    again = mahalanobis_logits(*args, logit_scale=0.5)
    ref = mahalanobis_logits(*args, logit_scale=0.5, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(ours, again)  # no atomics
    assert (ours[:, real:] == -1e30).all()
    _close_to_max(ours[:, :real].cpu(), ref[:, :real].cpu().numpy(), MAHALANOBIS_TOL)
