"""The f32 routes of kernels A and B on the f32 mainloop (``csrc/sgemm.cuh``):
their plans held against brute force, the mainloop's order of sums and
kernel A's f32 route emulated on the CPU against the plain versions, and,
on the card, both routes at ragged shapes against their plain versions.

Kernel A's f32 tiles pack whole sequences (``plans.qkv_f32_rows``: 128 or
160 rows, the one whose launch ends first); kernel B's f32 route runs
LayerNorm, fc1 and fc2 as three launches, the products in 128-column
tiles of ``plans.sgemm_row_tile`` rows, one block a tile.

Tolerances: the emulations and the kernels against the plain versions,
f32 1e-5 (rtol and atol, as tests/test_torch_ops.py): the same products
summed in another order (the plain versions' matmul, the emulation's
rounded products where the kernel fuses each into one fmaf).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans
from orbit_tpu_torch.ops import fused_mlp_block, fused_qkv_attention, mlp_block_reference
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops.tiny_attention import qkv_attention_reference

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(__file__).resolve().parents[1] / "orbit_tpu_torch" / "csrc"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the small CPU ops (as in test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, s, d)), rng.standard_normal((d, 3 * d)) / np.sqrt(d),
        0.1 * rng.standard_normal(3 * d))]


def _mlp(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, s, d)), 1.0 + 0.1 * rng.standard_normal(d),
        0.1 * rng.standard_normal(d), rng.standard_normal((d, 4 * d)) / np.sqrt(d),
        0.02 * rng.standard_normal(4 * d), rng.standard_normal((4 * d, d)) / np.sqrt(4 * d),
        0.02 * rng.standard_normal(d))]


def test_qkv_f32_plan_covers_every_real_row_once():
    """Kernel A's f32 blocks, at S 5, 50 and 64 with ragged B: every real
    (row, head) in exactly one block, a block's rows whole sequences from a
    sequence's first row, never more than the tile's rows; the tile is the
    one of the two whose launch (one block an SM) ends first by waves x
    rows, 160 rows at ViT-B/32's S 50, B 256 and 128 at its S 5."""
    heads, sms = 12, 132
    for s in (5, 50, 64):
        for b in (1, 3, 13, 26, 232, 256):
            rows_tile = plans.qkv_f32_rows(b, s, heads, sms)
            assert rows_tile in plans.QKV_F32_TILES and rows_tile >= s
            owner = np.zeros((b * s, heads), dtype=np.int64)
            blocks = plans.qkv_f32_blocks(b, s, heads, sms)
            for hh, row0, rows in blocks:
                assert row0 % s == 0 and rows % s == 0 and 0 < rows <= rows_tile
                assert row0 + rows <= b * s  # no row past B
                owner[row0:row0 + rows, hh] += 1
            assert (owner == 1).all(), (b, s)
            assert len(blocks) == heads * -(-b // (rows_tile // s))
            waves = {t: -(-heads * -(-b // (t // s)) // sms) * t for t in plans.QKV_F32_TILES}
            assert waves[rows_tile] == min(waves.values())
    assert plans.qkv_f32_rows(256, 50, heads, sms) == 160
    assert plans.qkv_f32_rows(256, 5, heads, sms) == 128
    src = (CSRC / "fused_qkv_attention.cu").read_text()  # the tiles the C entry launches
    assert all(f"launch_f32<{t}>" in src for t in plans.QKV_F32_TILES)


def test_sgemm_tiles_have_one_writer_each():
    """B's f32 products (fc1: rows x 4D, fc2: rows x D) at the ViTs' widths
    and the paths' row counts: every output in exactly one block; 128-row
    tiles where they give every SM a block, else 32-row tiles (fc2 at S 5)."""
    for d in (384, 768):
        for rows in (12800, 1280, 650, 130, 50):
            for n in (4 * d, d):
                bm = plans.sgemm_row_tile(rows, n, 132)
                tiles_128 = -(-rows // 128) * (n // plans.SG_TILE_N)
                assert bm == (128 if tiles_128 >= 132 else 32)
                writes = np.zeros((rows, n), dtype=np.int64)
                for m0, n0, r in plans.sgemm_grid(rows, n, bm):
                    assert 0 < r <= bm and m0 % bm == 0 and n0 % plans.SG_TILE_N == 0
                    assert m0 + r <= rows and n0 + plans.SG_TILE_N <= n
                    writes[m0:m0 + r, n0:n0 + plans.SG_TILE_N] += 1
                assert (writes == 1).all(), (d, rows, n)
    assert plans.sgemm_row_tile(1280, 768, 132) == 32      # fc2, ViT-B/32 at S 5
    assert plans.sgemm_row_tile(12800, 768, 132) == 128    # fc2 at S 50
    src = (CSRC / "mlp_block.cu").read_text()  # the tiles launch_sgemm takes
    assert f"constexpr int kSgTileN = {plans.SG_TILE_N};" in src
    assert "if (bm == 128)" in src and "if (bm == 32)" in src


def test_f32_tiled_route_takes_the_vit_widths_in_f32_only():
    """The f32 route: f32 at D and hidden multiples of 128 (ViT-S/32's 384,
    ViT-B/32's 768); no bf16 shape (the wgmma route's, whose predicate keeps
    its meaning) and not D 64 (the FMA kernel)."""
    for d in (128, 384, 768):
        assert mlp_mod.f32_tiled_route(torch.float32, d, 4 * d)
        assert not mlp_mod.f32_tiled_route(torch.bfloat16, d, 4 * d)
        assert mlp_mod.wgmma_route(torch.bfloat16, d, 4 * d)
        assert not mlp_mod.wgmma_route(torch.float32, d, 4 * d)
    assert not mlp_mod.f32_tiled_route(torch.float32, 64, 256)
    assert not mlp_mod.f32_tiled_route(torch.float32, 128, 192)


def test_mainloop_order_matches_plain():
    """The mainloop's sums emulated (ascending k, stage by stage) on fc1 and
    fc2 of kernel B's f32 route, with its epilogues, against the plain
    version at a ragged 3 x 50 rows."""
    x, g, bt, w1, b1, w2, b2 = _mlp(3, 50, 128, seed=1)
    xf = x.reshape(-1, 128)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    xn = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-6) * g + bt
    hp = plans.sgemm_emulate(xn, w1) + b1
    h = 0.5 * hp * (1.0 + torch.erf(hp * 0.7071067811865476))
    y = plans.sgemm_emulate(h, w2) + b2 + xf
    ref = mlp_block_reference(x, g, bt, w1, b1, w2, b2, ln_eps=1e-6)
    np.testing.assert_allclose(y.reshape(ref.shape).numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("b,s,sms", [(26, 5, 132), (7, 50, 1)])
def test_qkv_f32_emulation_matches_plain(b, s, sms):
    """Kernel A's f32 route emulated (its blocks, the mainloop's order of
    sums, the packed attention stage) against the plain version: a 128-row
    tile of 25 sequences and one of 1 at S 5; 160-row tiles of 3 sequences
    and of 1 at S 50 (on one SM, where the 160-row tile ends first). Every
    (row, head) written once."""
    x, w, bias = _qkv(b, s, 128, seed=2)
    assert plans.qkv_f32_rows(b, s, 2, sms) == (128 if s == 5 else 160)
    out, writes = plans.qkv_f32_emulate(x, w, bias, 2, sms)
    assert (writes == 1).all()
    np.testing.assert_allclose(out.numpy(), qkv_attention_reference(x, w, bias, 2).numpy(),
                               **TOL)


# ------------------------------------------ the card: ragged tiles ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, D, heads): one tile of 25 sequences and one of 1 at S 5; the tail
# query chunk of 232 clips at S 50 (160-row tiles, the last of 1 sequence);
# two 64-token sequences; the ViT-S width
CARD_SHAPES = [(26, 5, 768, 12), (232, 50, 768, 12), (3, 64, 768, 12), (44, 50, 384, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_qkv_attention", "fused_mlp_block"])
def test_f32_routes_at_ragged_shapes(cuda_device, kernel):
    for b, s, d, heads in CARD_SHAPES:
        if kernel == "fused_qkv_attention":
            args = [t.to(cuda_device) for t in _qkv(b, s, d, seed=3)]
            run = lambda impl: fused_qkv_attention(*args, heads, impl=impl)
        else:
            args = [t.to(cuda_device) for t in _mlp(b, s, d, seed=4)]
            run = lambda impl: fused_mlp_block(*args, ln_eps=1e-6, impl=impl)
        with torch.inference_mode():
            n0 = kbuild.LAUNCHES[kernel]
            ours, again, ref = run(None), run(None), run("reference")
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES[kernel] == n0 + 2
        assert torch.equal(ours, again), (kernel, b, s, d)  # one writer an output
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(),
                                   err_msg=f"{kernel} {(b, s, d)}", **TOL)
