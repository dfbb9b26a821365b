"""The f32 routes of the backward kernels #4 and #6 on the f32 mainloop
(``csrc/sgemm.cuh``, ``csrc/sgemm_grads.cuh``): their plans held against
brute force, the mainloop's new operand layouts (A MN-major, B K-major)
and ragged K and #4's packed attention backward emulated on the CPU
against the plain versions, and, on the card, both routes at ragged
shapes against their plain versions.

#4's f32 route recomputes qkv on kernel A's packed row tiles and runs the
attention backward there (``plans.qkv_bwd_f32_rows``), then dW = x^T dqkv
and dx = dqkv W^T share one launch; #6's runs its two hidden products in
one kernel and dW1, dW2 and dxn in one launch. Every output tile (or, where
a weight gradient's K is cut into runs, every run's partial tile) has one
writer, the runs are added in order, and the longer walk goes first
(``plans.sgemm_grads_plan``, ``sgemm_grads_schedule``).

Tolerances: f32 1e-5 (as tests/test_torch_f32_tiles.py), the same
products summed in another order. The mainloop's products against
``torch.matmul``: rtol and atol 1e-5. The emulated backwards against the
plain ones: rtol 1e-5 and atol 1e-5 of the tensor's largest value, since a
column sum over hundreds of rows (dγ, dβ, db, the weight gradients) can
cancel to far below the scale its rounding error follows. The kernels
against the plain versions on the card: per tensor against its largest
value (GRAD_TOL, as chip_smoke.py holds them).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans
from orbit_tpu_torch.ops import mlp_block as mlp_mod
from orbit_tpu_torch.ops import tiny_attention as attn_mod
from orbit_tpu_torch.ops.mlp_block import fused_mlp_block_backward, mlp_block_backward_reference
from orbit_tpu_torch.ops.tiny_attention import (fused_qkv_attention_backward,
                                                qkv_attention_backward_reference)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
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
        0.1 * rng.standard_normal(3 * d), rng.standard_normal((b, s, d)))]


def _mlp(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, s, d)), 1.0 + 0.1 * rng.standard_normal(d),
        0.1 * rng.standard_normal(d), rng.standard_normal((d, 4 * d)) / np.sqrt(d),
        0.02 * rng.standard_normal(4 * d), rng.standard_normal((4 * d, d)) / np.sqrt(4 * d),
        rng.standard_normal((b, s, d)))]


def _close(ours, ref, what=""):
    """rtol 1e-5, atol 1e-5 of the reference tensor's largest value."""
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()), err_msg=what)


def _held(ours, ref, what):
    for i, (a, b) in enumerate(zip(ours, ref)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= GRAD_TOL * float(b.abs().max()), (what, i, err)


def test_grads_launch_writes_every_tile_once():
    """``sgemm_grads.cuh``'s one launch at #4's (dW (D, 3D), dx) and #6's
    (dW1 (D, 4D), dW2 (4D, D), dxn) products, ViT-B/32 and ViT-S/32 widths,
    at the paths' row counts (B 256, 64 and 13 at S 50 and 5, ragged ones
    among them): every (output, k) of a weight gradient in exactly one
    block's run, the runs whole stages no longer than the data product's
    walk, none empty; every data output in exactly one tile, of 64 rows
    only where 128-row tiles would leave SMs idle; the longer walk first.
    The tile width and the rule are the header's."""
    sms = 132
    for d in (384, 768):
        for rows in (12800, 3200, 1280, 650, 65):
            for weights, data in (([(d, 3 * d)], (d, 3 * d)),
                                  ([(d, 4 * d), (4 * d, d)], (d, 4 * d))):
                x_rows, wsplit = plans.sgemm_grads_plan(rows, weights, data, sms)
                assert x_rows == (128 if -(-rows // 128) * (data[0] // 128) >= sms else 64)
                order = plans.sgemm_grads_schedule(rows, weights, data, x_rows, wsplit)
                runs = [{} for _ in weights]  # (m0, n0) -> the tile's runs of K
                x_writes = np.zeros((-(-rows // x_rows) * x_rows, data[0]), dtype=np.int64)
                for j, m0, n0, m_rows, k0, k1 in order:
                    if j < len(weights):
                        assert 0 < k1 - k0 <= max(data[1], plans.SG_BK) and k0 % plans.SG_BK == 0
                        assert m_rows == plans.TILE
                        runs[j].setdefault((m0, n0), []).append((k0, k1))
                    else:
                        x_writes[m0:m0 + m_rows, n0:n0 + plans.TILE] += 1
                for (m, n), tile_runs in zip(weights, runs):  # each tile once, K in order
                    assert sorted(tile_runs) == [(m0, n0) for m0 in range(0, m, plans.TILE)
                                                 for n0 in range(0, n, plans.TILE)], (d, rows)
                    for k_runs in tile_runs.values():  # wsplit runs, end to end over all rows
                        assert len(k_runs) == wsplit and k_runs[0][0] == 0
                        assert k_runs[-1][1] == rows
                        assert all(a[1] == b[0] for a, b in zip(k_runs, k_runs[1:]))
                assert (x_writes[:rows] == 1).all()
                per = -(-(-(-rows // plans.SG_BK)) // wsplit) * plans.SG_BK
                assert (order[0][0] < len(weights)) == (per >= data[1])
    assert plans.sgemm_grads_plan(12800, [(768, 2304)], (768, 2304), sms) == (128, 6)
    assert plans.sgemm_grads_plan(1280, [(768, 3072), (3072, 768)], (768, 3072), sms) == (64, 1)
    src = (CSRC / "sgemm_grads.cuh").read_text()
    assert f"constexpr int kTile = {plans.TILE};" in src
    assert "p.weights_first = run_stages(p.rows, p.wsplit) * sg::kBK >= p.x_k;" in src


def test_qkv_bwd_f32_plan_covers_every_real_row_once():
    """#4's f32 attention blocks at every S a ViT reaches (1 to 64 tokens)
    and ragged B: every real (row, head) in exactly one block, a block's
    rows whole sequences, the tile 128 or 160 rows and its shared memory
    within an H100 block's; 160 rows at ViT-B/32's S 50, B 256, 128 at S 5;
    one partial row a tile, then dW's runs of K. The constants are the
    sources'."""
    heads, sms = 12, 132
    for s in range(1, 65):
        for b in (1, 13, 64, 256):
            rows_tile = plans.qkv_bwd_f32_rows(b, s, heads, sms)
            nseq = rows_tile // s
            assert rows_tile in plans.QKV_F32_TILES and nseq >= 1
            assert (rows_tile == 160) == (nseq * s > 128)  # the C entry's choice
            assert plans.qkv_bwd_f32_smem(rows_tile, nseq, s) <= plans.SMEM_LIMIT, (b, s)
            owner = np.zeros((b * s, heads), dtype=np.int64)
            blocks = plans.qkv_bwd_f32_blocks(b, s, heads, sms)
            for hh, tile, row0, rows in blocks:
                assert row0 == tile * nseq * s and rows % s == 0 and 0 < rows <= rows_tile
                owner[row0:row0 + rows, hh] += 1
            assert (owner == 1).all(), (b, s)
            d = 64 * heads
            wsplit = plans.sgemm_grads_plan(b * s, [(d, 3 * d)], (d, 3 * d), sms)[1]
            assert plans.qkv_bwd_f32_partials(b, s, d, heads, sms) == (
                (blocks[-1][1] + 1) * 3 * d + (wsplit * d * 3 * d if wsplit > 1 else 0))
    assert plans.qkv_bwd_f32_rows(256, 50, heads, sms) == 160
    assert plans.qkv_bwd_f32_rows(256, 5, heads, sms) == 128
    assert plans.qkv_bwd_f32_smem(160, 3, 50) == 228800
    src = (CSRC / "fused_qkv_attention_bwd.cu").read_text()
    assert f"constexpr size_t kMaxSmem = {plans.SMEM_LIMIT};" in src
    assert "nseq * S <= 128" in src
    sg = (CSRC / "sgemm.cuh").read_text()
    for name, value in (("kBK", plans.SG_BK), ("kStages", plans.SG_STAGES),
                        ("kAPad", plans.SG_PAD)):
        assert re.search(rf"constexpr int {name} = {value};", sg), name
    mlp_src = (CSRC / "mlp_block_bwd.cu").read_text()
    assert "launch_hidden_f32<kTile>" in mlp_src and "launch_hidden_f32<kTile / 2>" in mlp_src
    assert plans.HIDDEN_F32_TILES == (plans.TILE, plans.TILE // 2)
    # #6's hidden tiles: 64 rows only where 128-row ones give an SM fewer than two blocks
    for rows in (12800, 3200, 2200, 1280, 800, 650):
        bm = plans.hidden_f32_rows(rows, 3072, sms)
        assert bm == (128 if -(-rows // 128) * 24 >= 2 * sms else 64), rows
    assert [plans.hidden_f32_rows(r, 3072, sms) for r in (12800, 650)] == [128, 64]


def test_backward_f32_routes_take_the_vit_widths_in_f32_only():
    """The new f32 routes: f32 at D (and hidden) multiples of 128, the ViTs'
    384 and 768 among them; never bf16 (whose wgmma predicates keep their
    meaning) nor a width off the tile, where the FMA routes stay."""
    for d in (128, 256, 384, 768):
        assert attn_mod.backward_f32_tiled_route(torch.float32, d)
        assert mlp_mod.backward_f32_tiled_route(torch.float32, d, 4 * d)
        assert not attn_mod.backward_f32_tiled_route(torch.bfloat16, d)
        assert not mlp_mod.backward_f32_tiled_route(torch.bfloat16, d, 4 * d)
        assert attn_mod.backward_wgmma_route(torch.bfloat16, d)
        assert not attn_mod.backward_wgmma_route(torch.float32, d)
    for d in (64, 192):
        assert not attn_mod.backward_f32_tiled_route(torch.float32, d)
        assert not mlp_mod.backward_f32_tiled_route(torch.float32, d, 4 * d)
    assert not mlp_mod.backward_f32_tiled_route(torch.float32, 128, 192)


def test_mainloop_layouts_and_ragged_k_match_matmul():
    """The mainloop's stages emulated in every layout the backward routes
    use (A K- or MN-major, B MN- or K-major) at a ragged K of 3 x 50 and
    13 x 5 rows (the last stage's rows past K zero-filled), and a weight
    gradient in 1 to 3 runs of K added in order, against
    ``torch.matmul``."""
    rng = np.random.default_rng(5)
    for k in (150, 65):
        a = torch.from_numpy(rng.standard_normal((72, k)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((k, 40)).astype(np.float32))
        ref = (a.double() @ b.double()).float()
        for a_mn, b_k in ((False, False), (True, False), (False, True), (True, True)):
            ours = plans.sgemm_stage_emulate(a.T.contiguous() if a_mn else a,
                                             b.T.contiguous() if b_k else b,
                                             a_mn=a_mn, b_k=b_k)
            np.testing.assert_allclose(ours.numpy(), ref.numpy(), err_msg=str((k, a_mn, b_k)),
                                       **TOL)
        for wsplit in (1, 2, 3):
            ours = plans.weight_grad_emulate(a.T.contiguous(), b, wsplit)
            np.testing.assert_allclose(ours.numpy(), ref.numpy(), err_msg=str((k, wsplit)), **TOL)


# (B, S, D, heads): 160-row tiles of 3 sequences and a last of 2 at S 50
# (K = 550, ragged, the weight gradients' K in 2 runs), and a 128-row tile
# of 13 sequences at S 5 (K = 65)
SHAPES = [(11, 50, 128, 2), (13, 5, 256, 4)]


@pytest.mark.parametrize("b,s,d,heads", SHAPES)
def test_qkv_bwd_f32_emulation_matches_plain(b, s, d, heads):
    """#4's f32 route emulated (its blocks, the recompute's and the packed
    attention backward's order of sums, db's partials as the blocks add
    them, dx and dW by the mainloop's new layouts) against the plain
    backward; every (row, part, head) of dqkv written once."""
    x, w, bias, g = _qkv(b, s, d, seed=6)
    dx, dw, db, writes = plans.qkv_bwd_f32_emulate(x, w, bias, g, heads)
    assert (writes == 1).all()
    ref = qkv_attention_backward_reference(x, w, bias, g, heads)
    for i, (ours, want) in enumerate(zip((dx, dw, db), ref)):
        _close(ours, want, f"output {i}")


@pytest.mark.parametrize("b,s,d,heads", SHAPES)
def test_mlp_bwd_f32_emulation_matches_plain(b, s, d, heads):
    """#6's f32 route emulated (the hidden kernel's two products and
    epilogue, db1's partials as its blocks add them, dW1, dW2 and dxn by the
    mainloop's new layouts at a ragged K, the LayerNorm backward) against
    the plain backward."""
    x, gam, bet, w1, b1, w2, g = _mlp(b, s, d, seed=7)
    ours = plans.mlp_bwd_f32_emulate(x, gam, bet, w1, b1, w2, g)
    ref = mlp_block_backward_reference(x, gam, bet, w1, b1, w2, g)
    for i, (a, want) in enumerate(zip(ours, ref)):
        _close(a, want, f"output {i}")


# ------------------------------------------ the card: ragged tiles ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, D, heads): the train path's ragged B 13 at S 50 (K = 650) and at
# S 5; the FineTuner's B 64 (K = 3,200); one sequence of 64 tokens; a tile
# of 25 sequences and one of 1 at S 5; ViT-S's width
CARD_SHAPES = [(13, 50, 768, 12), (13, 5, 768, 12), (64, 50, 768, 12), (1, 64, 768, 12),
               (26, 5, 768, 12), (44, 50, 384, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_qkv_attention_bwd", "fused_mlp_block_bwd"])
def test_f32_backward_routes_at_ragged_shapes(cuda_device, kernel):
    for b, s, d, heads in CARD_SHAPES:
        if kernel == "fused_qkv_attention_bwd":
            args = [t.to(cuda_device) for t in _qkv(b, s, d, seed=8)]
            run = lambda impl: fused_qkv_attention_backward(*args, heads, impl=impl)
        else:
            args = [t.to(cuda_device) for t in _mlp(b, s, d, seed=9)]
            run = lambda impl: fused_mlp_block_backward(*args, ln_eps=1e-6, impl=impl)
        with torch.inference_mode():
            n0 = kbuild.LAUNCHES[kernel]
            ours, again, ref = run(None), run(None), run("reference")
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES[kernel] == n0 + 2
        assert all(torch.equal(u, v) for u, v in zip(ours, again)), (kernel, b, s, d)
        _held(ours, ref, f"{kernel} {(b, s, d)}")
