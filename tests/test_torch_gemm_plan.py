"""The plans of the bf16 wgmma routes (``csrc/wgmma.cuh``) of kernels A
and B and of their backward kernels #4 and #6, held against brute force,
and the split of each kernel into launches held against the plain
version and the JAX op.

Kernel A's row tiles pack whole sequences (``sequence_tiles``); kernel B
runs as three launches (LayerNorm, fc1, fc2) whose plain version is
``mlp_block_stages``; #4 as four (the qkv recompute, the attention
backward, dW and dx, db) cut as ``qkv_attention_backward_stages``; #6 as
five (LayerNorm, the hidden kernel, dW1, dW2 and dxn, the LayerNorm
backward, the vector gradients) cut as ``mlp_block_backward_stages``. The
backward kernels' last products share one launch (``csrc/grads.cuh``,
``plans.grads_schedule``), and their vector gradients are partial column
sums over fixed row runs added in a fixed order (``plans.row_chunks``).
On the CPU the plans and the splits are checked here; the tests marked
``cuda`` run the kernels at the shapes a tiled design can get wrong (one
sequence of 64 tokens, the ragged tail of a query chunk, the ViT-S width)
against their plain versions on the card, and the mainloop alone in
every operand layout against ``torch.matmul``, and skip without one.

Tolerances: the staged plain versions must equal the one-piece plain
versions bit for bit (same operations, same order, same rounding points);
against the JAX op and kernel against plain version, those of
``tests/test_torch_ops.py`` (f32: summation order and the TPU kernel's
polynomial erf, 1e-5; bf16: a one-ulp flip at a rounding point carried
through the later product, 2^-6; gradients per tensor against its largest
value, the same limits). The fixed-order sum of the partials against one
whole column sum: f32 summation order, 1e-5 of the largest. The mainloop
against ``torch.matmul`` on the same bf16 operands: exact products, f32
sums in another order over K = 328, 1e-5 of the largest.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans
from orbit_tpu_torch.ops import (fused_mlp_block, fused_mlp_block_backward, fused_qkv_attention,
                                 fused_qkv_attention_backward, mlp_block_backward_reference,
                                 mlp_block_reference, qkv_attention_backward_reference)
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops import tiny_attention as attn_mod

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -6, atol=2.0 ** -6)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the small CPU ops (as in test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _qkv_inputs(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (rng.standard_normal((d, 3 * d)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(3 * d)).astype(np.float32))


def _torch(arrays, dtype, keep_f32=(), device="cpu"):
    return [torch.from_numpy(a).to(device=device,
                                   dtype=torch.float32 if i in keep_f32 else dtype)
            for i, a in enumerate(arrays)]


# ------------------------------------------- kernel A's row tiles ----
@pytest.mark.parametrize("s", [5, 50, 64])
@pytest.mark.parametrize("b", [1, 3, 13, 256])
def test_sequence_tiles_cover_every_row_once(b, s):
    """Tile t holds sequences t*n .. min(B, (t+1)*n) - 1: every row of x in
    exactly one tile, no sequence across two tiles, no empty tile, a tile
    within the block's 128 rows, and a sequence's 64 key slots within the
    128 + 64 rows of its q, k, v tiles."""
    n, tiles = attn_mod.sequence_tiles(b, s)
    owner = np.full(b * s, -1)
    for t in range(tiles):
        seqs = range(t * n, min(b, (t + 1) * n))
        assert len(seqs) >= 1                       # no empty tile
        assert len(seqs) * s <= attn_mod.ROW_TILE   # fits the block's rows
        first = seqs[0] * s
        for q in seqs:
            rows = np.arange(q * s, (q + 1) * s)
            assert (owner[rows] == -1).all()        # no row in two tiles
            owner[rows] = t
            r0 = q * s - first                      # the sequence's first row in the tile
            assert r0 + attn_mod.MAX_TOKENS <= attn_mod.ROW_TILE + attn_mod.MAX_TOKENS
    assert (owner >= 0).all()                       # every row in a tile
    # brute force: the densest packing of whole sequences into 128 rows
    assert n == max(k for k in range(1, attn_mod.ROW_TILE + 1) if k * s <= attn_mod.ROW_TILE)
    assert tiles == -(-b // n)


# ------------------------------------------- kernel B's launches ----
@pytest.mark.parametrize("dtype,d,hidden,expected", [
    ("bfloat16", 768, 3072, True), ("bfloat16", 384, 1536, True),
    ("bfloat16", 128, 512, True), ("bfloat16", 64, 256, False),
    ("bfloat16", 128, 192, False), ("float32", 768, 3072, False)])
def test_wgmma_route_takes_the_vit_widths(dtype, d, hidden, expected):
    """bf16 at D and hidden multiples of the tile width (every supported
    ViT) takes the wgmma route; D = 64 and f32 keep the FMA kernel."""
    assert mlp_mod.wgmma_route(getattr(torch, dtype), d, hidden) is expected
    if expected:  # the fc1 and fc2 grids tile the outputs exactly
        assert hidden % mlp_mod.WGMMA_TILE_N == 0 and d % mlp_mod.WGMMA_TILE_N == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stages_equal_reference_bit_for_bit(dtype):
    """LayerNorm, then fc1 with h rounded to the compute dtype, then fc2:
    the same bits as the one-piece plain version."""
    args = _torch(_mlp_inputs(3, 50, 128, seed=3), getattr(torch, dtype),
                  keep_f32=(1, 2, 4, 6))
    xn, h, y = mlp_mod.mlp_block_stages(*args, ln_eps=1e-6)
    assert xn.dtype == h.dtype == y.dtype == getattr(torch, dtype)
    assert xn.shape == (3, 50, 128) and h.shape == (3, 50, 512)
    assert torch.equal(y, mlp_block_reference(*args, ln_eps=1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stages_match_jax(dtype):
    """The staged plain version against the JAX op's Pallas body
    (interpret), at a ragged B = 3."""
    jnp = pytest.importorskip("jax.numpy")
    from orbit_tpu.ops.mlp_block import fused_mlp_block as jax_op
    arrays = _mlp_inputs(3, 50, 128, seed=4)
    keep = (1, 2, 4, 6)
    ref = jax_op(*[jnp.asarray(a).astype("float32" if i in keep else dtype)
                   for i, a in enumerate(arrays)], ln_eps=1e-6, impl="interpret")
    _, _, y = mlp_mod.mlp_block_stages(*_torch(arrays, getattr(torch, dtype), keep_f32=keep),
                                       ln_eps=1e-6)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref).astype(np.float32),
                               **TOL[dtype])


def _cot(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _grads_close(ours, refs, dtype: str):
    for i, (a, r) in enumerate(zip(ours, refs)):
        r = np.asarray(r).astype(np.float32)
        np.testing.assert_allclose(np.asarray(a.float().cpu()), r, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(r).max(),
                                   err_msg=f"gradient {i}")


# ----------------------------------- #4's and #6's cut into launches ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_backward_stages_equal_reference_bit_for_bit(dtype):
    """LayerNorm; the hidden launch's hg and cast(dhpre); the grads
    launch's dxn: the same gradients, bit for bit, as the one-piece plain
    backward, with every stage in the dtype the kernel stores it in."""
    dt = getattr(torch, dtype)
    args = _torch(_mlp_inputs(3, 50, 128, seed=5)[:6], dt, keep_f32=(1, 2, 3, 4, 5))
    g = _torch([_cot(3, 50, 128, 6)], dt)[0]
    (xn, hg, dhb, dxn), grads = mlp_mod.mlp_block_backward_stages(*args, g, ln_eps=1e-6)
    assert xn.dtype == hg.dtype == dhb.dtype == dt and dxn.dtype == torch.float32
    assert xn.shape == (3, 50, 128) and hg.shape == dhb.shape == (3, 50, 512)
    ref = mlp_block_backward_reference(*args, g, ln_eps=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_backward_stages_equal_reference_bit_for_bit(dtype):
    """The qkv recompute and the attention launch's cast(dqkv): the same
    (dx, dW, db), bit for bit, as the one-piece plain backward."""
    dt = getattr(torch, dtype)
    args = _torch(_qkv_inputs(3, 50, 128, seed=3), dt, keep_f32=(1, 2))
    g = _torch([_cot(3, 50, 128, 4)], dt)[0]
    (qkv, dqkv_t), grads = attn_mod.qkv_attention_backward_stages(*args, g, 2)
    assert qkv.dtype == dqkv_t.dtype == dt
    assert qkv.shape == (3, 50, 384) and dqkv_t.shape == (150, 384)
    ref = qkv_attention_backward_reference(*args, g, 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))


def _jax_vjp(op, primals, cotangent):
    import jax
    return jax.jit(lambda p, g: jax.vjp(op, *p)[1](g))(tuple(primals), cotangent)


def _jax_arrays(arrays, dtype, keep_f32=()):
    jnp = pytest.importorskip("jax.numpy")
    return [jnp.asarray(a).astype("float32" if i in keep_f32 else dtype)
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_backward_stages_match_jax(dtype):
    """The staged plain backward against the JAX op's Pallas backward
    (interpret) at tests/test_torch_ops.py's ragged B = 3 case."""
    from orbit_tpu.ops.mlp_block import fused_mlp_block as jax_op
    arrays = _mlp_inputs(3, 50, 128, seed=5)
    cot = _cot(3, 50, 128, 6)
    keep = (1, 2, 3, 4, 5, 6)
    refs = _jax_vjp(lambda *a: jax_op(*a, ln_eps=1e-6, impl="interpret"),
                    _jax_arrays(arrays, dtype, keep_f32=keep), _jax_arrays([cot], dtype)[0])
    dt = getattr(torch, dtype)
    _, grads = mlp_mod.mlp_block_backward_stages(*_torch(arrays[:6], dt, keep_f32=keep),
                                                 _torch([cot], dt)[0], ln_eps=1e-6)
    _grads_close(grads, refs, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_backward_stages_match_jax(dtype):
    """The staged plain backward against the JAX op's Pallas backward
    (interpret) at tests/test_torch_ops.py's ragged B = 3 case."""
    from orbit_tpu.ops.tiny_attention import fused_qkv_attention as jax_op
    arrays = _qkv_inputs(3, 50, 128, seed=3)
    cot = _cot(3, 50, 128, 4)
    refs = _jax_vjp(lambda x, w, b: jax_op(x, w, b, 2, impl="interpret"),
                    _jax_arrays(arrays, dtype, keep_f32=(1, 2)), _jax_arrays([cot], dtype)[0])
    dt = getattr(torch, dtype)
    _, grads = attn_mod.qkv_attention_backward_stages(
        *_torch(arrays, dt, keep_f32=(1, 2)), _torch([cot], dt)[0], 2)
    _grads_close(grads, refs, dtype)


# ------------------------------------------- #4's and #6's plans ----
# (rows, D): ViT-B/32 at the train path's batches 256, 44 and 16 (S = 50),
# one 64-token sequence, ViT-S/32 at 256
PLAN_SHAPES = [(12800, 768), (2200, 768), (800, 768), (64, 768), (12800, 384)]


@pytest.mark.parametrize("rows,d", PLAN_SHAPES)
@pytest.mark.parametrize("kernel", ["#4", "#6"])
def test_grads_schedule_owns_every_tile_once(kernel, rows, d):
    """grads.cuh's one launch: every 128 x 128 tile of every product (#4:
    dW (D, 3D) and dx (rows, D); #6: dW1 (D, 4D), dW2 (4D, D) and dxn
    (rows, D)) has exactly one block; the product with the longer K walk
    takes the first blocks."""
    weights = [(d, 3 * d)] if kernel == "#4" else [(d, 4 * d), (4 * d, d)]
    data = (d, 3 * d) if kernel == "#4" else (d, 4 * d)
    blocks = plans.grads_schedule(rows, weights, data)
    shapes = [*weights, (rows, data[0])]
    seen = {}
    for j, m0, n0 in blocks:
        m, n = shapes[j]
        assert 0 <= m0 < m and 0 <= n0 < n and m0 % plans.TILE == 0 and n0 % plans.TILE == 0
        assert (j, m0, n0) not in seen
        seen[j, m0, n0] = True
    for j, (m, n) in enumerate(shapes):  # brute force: every tile of every product
        for m0, n0 in itertools.product(range(0, m, plans.TILE), range(0, n, plans.TILE)):
            assert (j, m0, n0) in seen
    assert len(blocks) == sum(plans.tiles(m, n) for m, n in shapes)
    longest = len(weights) if data[1] > rows else 0   # K: rows for dW, data[1] for the data
    assert blocks[0][0] == longest


@pytest.mark.parametrize("chunk", [50, 64, 128, 256])
@pytest.mark.parametrize("rows", [1, 50, 127, 129, 2200])
def test_row_chunks_cover_every_row_once(rows, chunk):
    """The partial sums' row runs (a sequence for #4's db, a 128-row tile
    for #6's db1, 64 rows for its LayerNorm backward, 256 off the wgmma
    route): every row in exactly one run, in row order, none empty."""
    runs = plans.row_chunks(rows, chunk)
    covered = np.concatenate([np.arange(r0, r1) for r0, r1 in runs])
    assert np.array_equal(covered, np.arange(rows))
    assert all(0 < r1 - r0 <= chunk for r0, r1 in runs) and len(runs) == -(-rows // chunk)


def test_fixed_order_sum_is_the_column_sum_and_repeats_its_bits():
    """The second pass over the partials: the whole column sum within f32
    summation order, and the same bits on every call."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2200, 96)).astype(np.float32))
    for chunk in (50, 64, 128, 256):
        parts = plans.chunk_partials(x, chunk)
        assert parts.shape == (-(-2200 // chunk), 96)
        once = plans.fixed_order_sum(parts)
        np.testing.assert_allclose(once.numpy(), x.double().sum(0).numpy(), rtol=0,
                                   atol=1e-5 * float(x.abs().sum(0).max()))
        assert torch.equal(once, plans.fixed_order_sum(plans.chunk_partials(x, chunk)))


@pytest.mark.parametrize("dtype,d,expected", [
    ("bfloat16", 768, True), ("bfloat16", 384, True), ("bfloat16", 128, True),
    ("bfloat16", 64, False), ("bfloat16", 192, False), ("float32", 768, False)])
def test_backward_route_choice(dtype, d, expected):
    """bf16 at widths that are multiples of the tile (every supported ViT)
    takes the wgmma routes of #4 and #6; f32 and the other widths keep the
    FMA products. The partial-sum workspaces follow the route."""
    dt = getattr(torch, dtype)
    assert attn_mod.backward_wgmma_route(dt, d) is expected
    assert mlp_mod.wgmma_route(dt, d, 4 * d) is expected
    rows = 2200
    assert plans.qkv_bwd_partials(44, 50, d, expected) == (
        44 if expected else -(-rows // kbuild.COLSUM_ROWS)) * 3 * d
    assert plans.mlp_bwd_partials(rows, d, 4 * d, expected) == (
        -(-rows // (128 if expected else kbuild.COLSUM_ROWS)) * 4 * d + 3 * -(-rows // 64) * d)


# ------------------------------------------ the card: ragged tiles ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# one sequence of 64 tokens; the tail query chunk of 232 clips; the ViT-S width
RAGGED_SHAPES = [(1, 64, 768, 12), (232, 50, 768, 12), (256, 50, 384, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ragged_tiles_match_plain(cuda_device, dtype, shape):
    b, s, d, h = shape
    dt = getattr(torch, dtype)
    qkv = _torch(_qkv_inputs(b, s, d, seed=7), dt, device=cuda_device)
    mlp = _torch(_mlp_inputs(b, s, d, seed=8), dt, keep_f32=(1, 2, 4, 6), device=cuda_device)
    with torch.inference_mode():
        n0 = dict(kbuild.LAUNCHES)
        outs = {"fused_qkv_attention": (fused_qkv_attention(*qkv, h),
                                        fused_qkv_attention(*qkv, h, impl="reference")),
                "fused_mlp_block": (fused_mlp_block(*mlp, ln_eps=1e-6),
                                    fused_mlp_block(*mlp, ln_eps=1e-6, impl="reference"))}
        again = fused_qkv_attention(*qkv, h), fused_mlp_block(*mlp, ln_eps=1e-6)
    torch.cuda.synchronize()
    for name, (ours, ref) in outs.items():
        assert kbuild.LAUNCHES[name] == n0[name] + 2  # one a call, the repeat included
        np.testing.assert_allclose(ours.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   err_msg=name, **TOL[dtype])
    assert torch.equal(outs["fused_qkv_attention"][0], again[0])
    assert torch.equal(outs["fused_mlp_block"][0], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_kernels_at_ragged_shapes(cuda_device, dtype, shape):
    b, s, d, h = shape
    dt = getattr(torch, dtype)
    qkv = _torch(_qkv_inputs(b, s, d, seed=7), dt, device=cuda_device)
    mlp = _torch(_mlp_inputs(b, s, d, seed=8)[:6], dt, keep_f32=(1, 2, 4), device=cuda_device)
    g = _torch([_cot(b, s, d, 9)], dt, device=cuda_device)[0]
    runs = {"fused_qkv_attention_bwd": lambda impl: fused_qkv_attention_backward(
                *qkv, g, h, impl=impl),
            "fused_mlp_block_bwd": lambda impl: fused_mlp_block_backward(
                *mlp, g, ln_eps=1e-6, impl=impl)}
    for name, run in runs.items():
        n0 = kbuild.LAUNCHES[name]
        with torch.inference_mode():
            ours, again, ref = run(None), run(None), run("reference")
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES[name] == n0 + 2  # one a call, the repeat included
        assert all(torch.equal(u, v) for u, v in zip(ours, again)), name  # no atomics
        _grads_close(ours, [t.float().cpu().numpy() for t in ref], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 192])
@pytest.mark.parametrize("a_mn,b_k", list(itertools.product([False, True], repeat=2)))
def test_mainloop_layouts_match_matmul(cuda_device, a_mn, b_k, bn):
    """Every (A major, B major, tile width) of the mainloop on a ragged
    M = 200, N = 320, K = 328 against torch.matmul of the same bf16
    operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a = torch.randn(200, 328, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(328, 320, generator=gen, device=cuda_device).bfloat16()
    c = kbuild.mainloop_product(a.t().contiguous() if a_mn else a,
                                b.t().contiguous() if b_k else b, a_mn=a_mn, b_k=b_k, bn=bn)
    ref = a.float() @ b.float()
    torch.cuda.synchronize()
    assert float((c - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
