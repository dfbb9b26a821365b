"""The plans of the bf16 wgmma routes of kernels A and B
(``csrc/wgmma.cuh``), held against brute force, and the split of kernel B
into launches held against the plain version and the JAX op.

Kernel A's row tiles pack whole sequences (``sequence_tiles``); kernel B
runs as three launches (LayerNorm, fc1, fc2) whose plain version is
``mlp_block_stages``. On the CPU the plans and the split are checked here;
the tests marked ``cuda`` run the kernels at the shapes a tiled design can
get wrong (one sequence of 64 tokens, the ragged tail of a query chunk,
the ViT-S width) against their plain versions on the card, and skip
without one.

Tolerances: the staged plain version must equal ``mlp_block_reference``
bit for bit (same operations, same order, same rounding points); against
the JAX op and kernel against plain version, those of
``tests/test_torch_ops.py`` (f32: summation order and the TPU kernel's
polynomial erf, 1e-5; bf16: a one-ulp flip at a rounding point carried
through the later product, 2^-6).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.ops import fused_mlp_block, fused_qkv_attention, mlp_block_reference
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops import tiny_attention as attn_mod

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -6, atol=2.0 ** -6)}


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
