"""The port's kernel ops (``orbit_tpu_torch.ops``) held against the JAX
package, and the CUDA kernels held against their plain PyTorch versions.

On a host without a card the port's ops take their plain versions, which
are compared with the JAX ops run as the JAX suite runs them on the CPU:
``impl="interpret"`` (the Pallas kernel body in the interpreter) and
``impl="xla"``; the backward through the ops' autograd Functions against
the JAX ops' ``jax.vjp``. Inputs are made with numpy from a seed and fed to
both.
Tests marked ``cuda`` compare each kernel with its plain version on the
card at the path's shapes (the ViTs for kernels A, B, #4 and #6, and for
the attention on a raw qkv, #1 and #2; EfficientNet-B0 for the depthwise
tail #8, SimpleCNAPs for the Mahalanobis logits #7); they skip without
one. JAX is imported only inside
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
  later sums: 2^-6, as for the outputs. The same limits hold the
  gradients of the depthwise tail (both sides differentiate the plain
  version with the same casts; bf16 rounds the cotangent of the activated
  input and of the taps where both cast) and of the Mahalanobis logits
  (f32; the port's explicit products against XLA's einsum transpose).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.ops import (attention_reference, fused_dw_act, fused_mlp_block,
                                 fused_mlp_block_backward, fused_qkv_attention,
                                 fused_qkv_attention_backward, mahalanobis_logits,
                                 mlp_block_reference, qkv_attention_reference)
from orbit_tpu_torch.ops import depthwise as dw_mod
from orbit_tpu_torch.ops import mahalanobis as maha_mod
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops import tiny_attention as attn_mod
from orbit_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_backward

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


# the attention on a raw qkv (#1 and #2) at n = 5 (ragged against the TPU
# kernel's 8-row block), s = 50, d = 128 in 2 heads of 64, as
# tests/test_tiny_attention.py runs the JAX op
ATTENTION_CASES = [("float32", "interpret"), ("float32", "xla"), ("bfloat16", "interpret")]


def _raw_qkv(n, s, d, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal((n, s, 3 * d))).astype(np.float32)


@pytest.mark.parametrize("dtype,jax_impl", ATTENTION_CASES)
def test_tiny_attention_matches_jax(dtype, jax_impl):
    from orbit_tpu.ops.tiny_attention import tiny_attention as jax_op
    qkv = _raw_qkv(5, 50, 128)
    ref = jax_op(_jax_arrays([qkv], dtype)[0], 2, impl=jax_impl)
    ours = tiny_attention(_torch([qkv], getattr(torch, dtype))[0], 2)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (5, 50, 128)
    _close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_attention_backward_matches_jax(dtype):
    """dqkv against the TPU backward kernel's body (interpret), in the dtype."""
    from orbit_tpu.ops.tiny_attention import tiny_attention as jax_op
    qkv = _raw_qkv(5, 50, 128, seed=1)
    cot = np.random.default_rng(2).standard_normal((5, 50, 128)).astype(np.float32)
    refs = _jax_vjp(lambda t: jax_op(t, 2, impl="interpret"), _jax_arrays([qkv], dtype),
                    _jax_arrays([cot], dtype)[0])
    t = _torch([qkv], getattr(torch, dtype))[0].requires_grad_()
    tiny_attention(t, 2).backward(_torch([cot], getattr(torch, dtype))[0])
    assert t.grad.dtype == t.dtype
    _grads_close([t.grad], refs, dtype)


@pytest.mark.parametrize("h,k,act1", [(9, 5, True), (8, 3, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dw_backward_matches_jax(dtype, h, k, act1):
    """The gradients of all six inputs against ``jax.vjp`` of the JAX op on
    its TPU kernel's path (interpret), whose custom_vjp differentiates the
    XLA version; x and the cotangent in the dtype, the taps and affines f32."""
    from orbit_tpu.ops.depthwise import fused_dw_act as jax_op
    arrays = _dw_inputs(2, h, 16, k, seed=h + k + 1)
    cot = np.random.default_rng(h).standard_normal((2, h, h, 16)).astype(np.float32)
    keep = (1, 2, 3, 4, 5)
    refs = _jax_vjp(lambda *a: jax_op(*a, stride=1, act1=act1, act2=True, impl="interpret"),
                    _jax_arrays(arrays, dtype, keep_f32=keep), _jax_arrays([cot], dtype)[0])
    inputs = [t.requires_grad_() for t in _torch(arrays, getattr(torch, dtype), keep_f32=keep)]
    fused_dw_act(*inputs, act1=act1, act2=True).backward(_torch([cot], getattr(torch, dtype))[0])
    assert inputs[0].grad.dtype == inputs[0].dtype
    _grads_close([t.grad for t in inputs], refs, dtype)


def test_mahalanobis_backward_matches_jax():
    """The gradients of features, means and precisions (the padded class's
    zero) against ``jax.vjp`` of the JAX op's einsum (the JAX package's
    training path), f32."""
    from orbit_tpu.ops.mahalanobis import mahalanobis_logits as jax_op
    arrays = _maha_inputs(24, 128, 5, seed=3)
    cot = np.random.default_rng(4).standard_normal((24, 5)).astype(np.float32)
    jf, jm, jp, jmask = _jax_arrays(arrays, "float32")
    refs = _jax_vjp(lambda f, m, p: jax_op(f, m, p, class_mask=jmask, logit_scale=0.5,
                                           force="xla"), (jf, jm, jp), _jax_arrays([cot],
                                                                               "float32")[0])
    f, mu, p, mask = _torch(arrays, torch.float32)
    inputs = [t.requires_grad_() for t in (f, mu, p)]
    mahalanobis_logits(*inputs, mask, logit_scale=0.5).backward(torch.from_numpy(cot))
    assert (mu.grad[-1] == 0).all() and (p.grad[-1] == 0).all()
    _grads_close([t.grad for t in inputs], refs, "float32")


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
    monkeypatch.setattr(attn_mod, "_launch_attention", no_kernel)
    monkeypatch.setattr(attn_mod, "_launch_attention_backward", no_kernel)
    r = torch.from_numpy(_raw_qkv(2, 7, 128)).requires_grad_()
    assert torch.equal(tiny_attention(r, 2), attention_reference(r, 2))
    tiny_attention(r, 2).sum().backward()
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
    r = torch.empty((2, 5, 384), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tiny_attention(r, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tiny_attention_backward(r, torch.empty((2, 5, 128), device="meta"), 2)
    with pytest.raises(ValueError, match="unknown impl"):
        tiny_attention(r, 2, impl="xla")


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
    with pytest.raises(ValueError, match="divisible"):
        tiny_attention(torch.zeros(2, 5, 100), 2)
    # the kernels take head dim 64 and S <= 64 only, and refuse the rest
    # before they build or launch anything (a meta tensor reaches the check)
    for shape, heads in (((2, 5, 192), 2), ((2, 65, 384), 2)):
        with pytest.raises(ValueError, match="head dim 64"):
            attn_mod._launch_attention(torch.empty(shape, device="meta"), heads)
    with pytest.raises(ValueError, match="cotangent shape"):
        attn_mod._launch_attention_backward(torch.empty((2, 5, 384), device="meta"),
                                            torch.empty((2, 5, 64), device="meta"), 2)


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
# and #4 at widths that are no multiple of 128, which take its route off the
# wgmma mainloop in bf16 too (attention.cuh's f32 block on bf16 tiles)
QKV_BWD_SHAPES = BWD_SHAPES + [(13, 50, 192, 3), (3, 5, 320, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QKV_BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
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


# the depthwise tail at EfficientNet-B0's 8 and EfficientNetV2-S's 4
# stride-1 tail shapes at 224 px (H, C, K, act1), at a ragged batch of 13,
# and a small one
B0_DW_SHAPES = [(112, 32, 3, False), (56, 144, 3, True), (28, 240, 5, True),
                (14, 480, 3, True), (14, 480, 5, True), (14, 672, 5, True),
                (7, 1152, 5, True), (7, 1152, 3, True), (14, 512, 3, True),
                (14, 768, 3, True), (14, 960, 3, True), (7, 1536, 3, True),
                (9, 16, 5, True)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiny_attention_kernels_match_plain(cuda_device, dtype, shape):
    """#1 and #2 against their plain versions: outputs, launches, and the
    same bits on a repeat."""
    b, s, d, h = shape
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_raw_qkv(b, s, d, seed=5)).to(cuda_device, dt)
    cot = torch.randn(b, s, d, device=cuda_device).to(dt)
    n0 = dict(kbuild.LAUNCHES)
    ours, dqkv = tiny_attention(qkv, h), tiny_attention_backward(qkv, cot, h)
    assert kbuild.LAUNCHES["tiny_attention"] == n0["tiny_attention"] + 1
    assert kbuild.LAUNCHES["tiny_attention_bwd"] == n0["tiny_attention_bwd"] + 1
    again = (tiny_attention(qkv, h), tiny_attention_backward(qkv, cot, h))
    ref = tiny_attention(qkv, h, impl="reference")
    dref = tiny_attention_backward(qkv, cot, h, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(ours, again[0]) and torch.equal(dqkv, again[1])
    assert ours.dtype == dqkv.dtype == dt
    np.testing.assert_allclose(ours.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **TOL[dtype])
    _grads_close([dqkv.cpu()], [dref.float().cpu().numpy()], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_attention_kernels_take_offset_views(cuda_device, dtype):
    """qkv and g as views one element into larger buffers (off every
    16-byte boundary): the wrappers hand the kernels' 16-byte copies
    aligned storage, and the results equal those of aligned inputs."""
    b, s, d, h = 13, 50, 384, 6
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_raw_qkv(b, s, d, seed=6)).to(cuda_device, dt)
    cot = torch.randn(b, s, d, device=cuda_device).to(dt)
    views = []
    for t in (qkv, cot):
        buf = torch.empty(t.numel() + 1, device=cuda_device, dtype=dt)
        views.append(buf[1:].view(t.shape))
        views[-1].copy_(t)
    assert all(v.data_ptr() % 16 for v in views)
    ours, dqkv = tiny_attention(views[0], h), tiny_attention_backward(*views, h)
    ref = tiny_attention(qkv, h, impl="reference")
    dref = tiny_attention_backward(qkv, cot, h, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(ours, tiny_attention(qkv, h))
    assert torch.equal(dqkv, tiny_attention_backward(qkv, cot, h))
    np.testing.assert_allclose(ours.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **TOL[dtype])
    _grads_close([dqkv.cpu()], [dref.float().cpu().numpy()], dtype)


@pytest.mark.cuda
def test_tiny_attention_kernels_refuse_other_shapes(cuda_device):
    for shape, heads in (((2, 5, 192), 2), ((2, 65, 384), 2)):
        with pytest.raises(ValueError, match="head dim 64"):
            tiny_attention(torch.zeros(shape, device=cuda_device), heads)


@pytest.mark.cuda
def test_autograd_through_the_forward_only_kernels(cuda_device):
    """#8 and #7 have no backward kernel: under autograd the forward runs
    the kernel and the backward differentiates the plain version, so the
    gradients equal those of the plain route; #1's op runs #2 backward."""
    d = [t.requires_grad_() for t in _torch(_dw_inputs(3, 14, 32, 5, seed=11), torch.bfloat16,
                                           keep_f32=(1, 2, 3, 4, 5), device=cuda_device)]
    h = [t.requires_grad_() for t in _torch(_maha_inputs(40, 256, 5, seed=12),
                                           torch.float32, device=cuda_device)[:3]]
    mask = (torch.arange(5, device=cuda_device) < 4).float()
    r = torch.from_numpy(_raw_qkv(3, 50, 128)).to(cuda_device).requires_grad_()
    grads = {}
    for impl in (None, "reference"):
        before = dict(kbuild.LAUNCHES)
        loss = (fused_dw_act(*d, impl=impl).float().square().sum()
                + mahalanobis_logits(*h, mask, 0.5, impl=impl)[:, :4].sum()
                + tiny_attention(r, 2, impl=impl).square().sum())
        grads[impl] = torch.autograd.grad(loss, [*d, *h, r])
        launched = {n: kbuild.LAUNCHES[n] - before[n] for n in before}
        expected = 1 if impl is None else 0
        for name in ("fused_dw_act", "mahalanobis_logits", "tiny_attention",
                     "tiny_attention_bwd"):
            assert launched[name] == expected, name
    torch.cuda.synchronize()
    for name, a, b in zip(("dw", "maha", "attention"), (grads[None][:6], grads[None][6:9],
                                                         grads[None][9:]),
                          (grads["reference"][:6], grads["reference"][6:9],
                           grads["reference"][9:])):
        tol = "bfloat16" if name == "dw" else "float32"
        _grads_close([t.cpu() for t in a], [t.float().cpu().numpy() for t in b], tol)
