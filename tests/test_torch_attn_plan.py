"""The plans of the bf16 attention on a raw qkv (#1) and its backward (#2),
``csrc/tiny_attention.cu``, held against brute force on the CPU.

#1's tiles pack floor(128 / S) whole sequences of one head, #2's items are
one (batch row, head); persistent blocks walk them through a ring of two
shared-memory stages (``kernels/plans.py::attn_fwd_plan``,
``attn_bwd_plan``, ``attn_walk``, ``attn_ring``). Checked here: every
(batch row, head) is attended once and every output row written once, at
the ViT shapes of ``tests/test_torch_ops.py``'s ``cuda`` tests; no
sequence straddles two tiles and its 64 key slots stay in the stage; the
shared memory of a block and of the blocks an SM holds; the ring reuses a
stage only after its tile is done; the plan's constants and the C entries'
arguments against the CUDA sources; and the emulated schedules
(``attn_emulate``, ``attn_bwd_emulate``: strip by strip, the kernels'
rounding points, the stores of rows below S only) against the plain
versions on small ragged shapes whose blocks walk several tiles. The
plain versions' parity with the JAX package is pinned in
``tests/test_torch_ops.py``; the kernels themselves run in its ``cuda``
tests on the card.

Tolerances: the emulation and the plain version round at the same points
and sum in another order: f32 1e-5 (relative and absolute); bf16 a sum on
either side of a rounding boundary rounds one ulp apart and the ulp
travels through the later products: 2^-6, as ``tests/test_torch_ops.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans
from orbit_tpu_torch.ops.tiny_attention import (attention_backward_reference,
                                                attention_reference, sequence_tiles)

CSRC = Path(kbuild.__file__).resolve().parent.parent / "csrc"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -6, atol=2.0 ** -6)}
H100_SMS = 132
# (B, S, D, H): ViT-B/32 and ViT-S/32 at 224 px (B 256 and a ragged 13),
# ViT-S/32 at 84 px (S = 5), a two-head D = 128
SHAPES = [(256, 50, 768, 12), (13, 50, 768, 12), (256, 50, 384, 6), (3, 5, 384, 6),
          (5, 50, 128, 2)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the small CPU ops (as in test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_forward_plan_covers_each_row_once(shape):
    b, s, _, h = shape
    plan = plans.attn_fwd_plan(b, s, h, H100_SMS)
    assert (plan.nseq, -(-b // plan.nseq)) == sequence_tiles(b, s)  # kernel A's tiles
    seen, rows = {}, {}
    walks = plans.attn_walk(plan)
    assert sorted(t for walk in walks for t in walk) == list(range(plan.tiles))
    for walk in walks:
        for t in walk:
            hh, seq0, here = plans.attn_tile(t, b, h, plan.nseq)
            # whole sequences in one tile, the last one's 64 key slots in the stage
            assert 1 <= here <= plan.nseq and here * s <= plans.TILE
            assert (here - 1) * s + plans.ATTN_KEYS <= plan.rows
            for seq in range(seq0, seq0 + here):
                seen[seq, hh] = seen.get((seq, hh), 0) + 1
            units = plans.attn_units(here, s)
            assert len(units) == plans.ATTN_FWD_WARPS
            for warp_units in units:
                for q, q0 in warp_units:
                    for i in range(q0, min(q0 + 16, s)):  # the rows the strip stores
                        key = (seq0 + q, i, hh)
                        rows[key] = rows.get(key, 0) + 1
    assert seen == {(seq, hh): 1 for seq in range(b) for hh in range(h)}
    assert rows == {(seq, i, hh): 1 for seq in range(b) for i in range(s) for hh in range(h)}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_backward_plan_covers_each_item_once(shape):
    b, s, _, h = shape
    plan = plans.attn_bwd_plan(b, s, h, H100_SMS)
    walks = plans.attn_walk(plan)
    items = sorted(i for walk in walks for i in walk)
    assert items == list(range(b * h)) and plan.blocks == min(b * h, H100_SMS * plan.per_sm)
    # warp w's query strip and key strip 16w cover the rows below S once
    strips = [16 * w for w in range(plans.ATTN_BWD_WARPS) if 16 * w < s]
    assert sorted(i for q0 in strips for i in range(q0, min(q0 + 16, s))) == list(range(s))


@pytest.mark.parametrize("s", range(1, plans.ATTN_KEYS + 1))
def test_shared_memory_fits(s):
    fwd = plans.attn_fwd_plan(256, s, 12, H100_SMS)
    bwd = plans.attn_bwd_plan(256, s, 12, H100_SMS)
    for plan, cap in ((fwd, plans.ATTN_FWD_PER_SM), (bwd, plans.ATTN_BWD_PER_SM)):
        assert plan.smem <= plans.SMEM_LIMIT
        assert 1 <= plan.per_sm <= cap
        assert plan.per_sm * (plan.smem + plans.BLOCK_RESERVED) <= plans.SM_SMEM
    assert bwd.per_sm == 3
    if s in (50, 5):  # 224 px: two blocks an SM; 84 px: one
        assert fwd.per_sm == (2 if s == 50 else 1)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_ring_reuses_a_stage_only_when_its_tile_is_done(shape, sms):
    b, s, _, h = shape
    for plan in (plans.attn_fwd_plan(b, s, h, sms), plans.attn_bwd_plan(b, s, h, sms)):
        for walk in plans.attn_walk(plan):
            steps = plans.attn_ring(walk)  # asserts each slot's tile
            assert [at for _, at in steps] == [n % plans.ATTN_STAGES for n in range(len(walk))]
            assert steps[-1][0] is None and all(into is not None for into, _ in steps[:-1])



def test_a_one_stage_ring_is_refused(monkeypatch):
    """With one stage, the next tile's copies would land in the stage being
    read: the ring's check must see it."""
    monkeypatch.setattr(plans, "ATTN_STAGES", 1)
    with pytest.raises(AssertionError):
        plans.attn_ring([0, 7, 14])


def _constant(text: str, name: str) -> int:
    """The value of ``constexpr int name = <expression>;`` in a source."""
    expr = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);", text).group(1)
    return int(eval(expr, {"__builtins__": {}, "kHeadDim": 64, "kMaxTokens": 64}))


def test_plan_constants_match_the_sources():
    head = (CSRC / "attention.cuh").read_text()
    src = (CSRC / "tiny_attention.cu").read_text()
    assert _constant(head, "kSLd") == plans.ATTN_SLD
    assert _constant(head, "kStripBytes") == plans.ATTN_STRIP_BYTES
    assert _constant(src, "kStages") == plans.ATTN_STAGES
    assert _constant(src, "kFwdWarps") == plans.ATTN_FWD_WARPS
    assert _constant(src, "kBwdWarps") == plans.ATTN_BWD_WARPS
    assert _constant(src, "kRowTile") == plans.TILE
    assert _constant(src, "kSmemLimit") == plans.SMEM_LIMIT
    assert f"__launch_bounds__(kFwdThreads, {plans.ATTN_FWD_PER_SM})" in src
    assert f"__launch_bounds__(kBwdThreads, {plans.ATTN_BWD_PER_SM})" in src


def test_c_entries_take_the_arguments_the_wrappers_pass():
    """Each C entry's parameter count against its ctypes signature (a
    missing argument would pass the stream as an int on the card)."""
    entries = {}
    for path in CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            entries[name] = len(params.split(","))
    attention = {name for name in kbuild._SIGNATURES if name.startswith("orbit_tiny_attention")}
    assert len(attention) == 4 and attention <= set(entries)
    for name, argtypes in kbuild._SIGNATURES.items():
        if name in entries:  # entries a macro declares are left out
            assert len(argtypes) == entries[name], name


def _qkv(b, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((0.5 * rng.standard_normal((b, s, 3 * d))).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    return qkv.to(dtype), cot.to(dtype)


# small ragged shapes: S = 5 (25 sequences a tile, a ragged last tile),
# S = 33 (three strips, the last short), S = 50, S = 64 (every key slot
# real); 3 or 5 SMs so that each block walks several tiles through its ring
EMULATED = [(3, 5, 384, 6, 3), (7, 33, 128, 2, 3), (5, 50, 128, 2, 5), (3, 64, 128, 2, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,h,sms", EMULATED, ids=["x".join(map(str, e)) for e in EMULATED])
def test_emulated_forward_matches_plain(dtype, b, s, d, h, sms):
    qkv, _ = _qkv(b, s, d, getattr(torch, dtype), seed=s)
    out, writes = plans.attn_emulate(qkv, h, sms=sms)
    assert (writes[:b * s] == 1).all() and (writes[b * s:] == 0).all()
    assert torch.isnan(out[b * s:].float()).all()  # no row past the last sequence
    ref = attention_reference(qkv, h)
    np.testing.assert_allclose(out[:b * s].float().numpy(),
                               ref.reshape(b * s, d).float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,h,sms", EMULATED, ids=["x".join(map(str, e)) for e in EMULATED])
def test_emulated_backward_matches_plain(dtype, b, s, d, h, sms):
    qkv, cot = _qkv(b, s, d, getattr(torch, dtype), seed=s + 1)
    dqkv, writes = plans.attn_bwd_emulate(qkv, cot, h, sms=sms)
    assert (writes[:b * s] == 1).all() and (writes[b * s:] == 0).all()
    assert torch.isnan(dqkv[b * s:].float()).all()
    ref = attention_backward_reference(qkv, cot, h).reshape(b * s, 3 * d).float()
    # per part (dq, dk, dv) against its largest value, as the gradients are held
    for part in range(3):
        cols = slice(part * d, (part + 1) * d)
        err = (dqkv[:b * s, cols].float() - ref[:, cols]).abs().max()
        assert float(err) <= TOL[dtype]["rtol"] * float(ref[:, cols].abs().max()), part
