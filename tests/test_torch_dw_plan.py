"""The plans of the fused depthwise tail (#8, ``csrc/depthwise.cu``) and of
the Mahalanobis logits (#7, ``csrc/mahalanobis.cu``), mirrored in
``orbit_tpu_torch/kernels/plans.py``, held against brute force on the CPU.

#8: at every stride-1 tail shape of EfficientNet-B0 and V2-S at 224 px, at
N = 256 and a ragged 13, in f32 and bf16, the plan's blocks and threads
cover each output once; each input element is copied once per strip
(twice only in the 2-column seam between two strips), the ring positions
outside the image are exactly those TF-SAME pads, and a block fits the
H100's 227 KB of shared memory. A CPU emulation of the kernel's schedule
(its ring of activated rows with the slot reuse, the zero mask after the
activation, the (row, column) tap order in f32) is held against the plain
version and against the JAX Pallas body in interpret mode.

#7: the tiles of the real classes and the threads' 8 x 8 outputs cover
every (class, row, column) once; each row's partial sums add the columns
in a fixed order (per thread, per row of 16 threads, per N tile), which an
emulation holds against the plain version.

Tolerances (those of ``tests/test_torch_ops.py``, against the largest
value): #8 f32 1e-5 (summation order only), bf16 2^-6 (a one-ulp flip of an
activated input where an f32 sum lands on either side of a bf16 rounding
boundary, carried by the taps); #7 f32 1e-5 (the D*D terms, which cancel,
in another order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orbit_tpu_torch.kernels import plans
from orbit_tpu_torch.ops.depthwise import fused_dw_reference, tf_same_pads
from orbit_tpu_torch.ops.mahalanobis import mahalanobis_reference

DW_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
MAHALANOBIS_TOL = 1e-5
# (H = W, C, K) of the stride-1 tails: B0's 8 shapes, then V2-S's 4
TAILS = [(112, 32, 3), (56, 144, 3), (28, 240, 5), (14, 480, 3), (14, 480, 5), (14, 672, 5),
         (7, 1152, 5), (7, 1152, 3), (14, 512, 3), (14, 768, 3), (14, 960, 3), (7, 1536, 3)]
tail_ids = ["x".join(map(str, s)) for s in TAILS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the small CPU ops (as in test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exactly_once(counts, what):
    counts = np.asarray(counts)
    assert counts.min() == 1 and counts.max() == 1, (what, counts.min(), counts.max())


@pytest.mark.parametrize("n", [256, 13])
@pytest.mark.parametrize("shape", TAILS, ids=tail_ids)
def test_dw_plan_covers_each_output_once(shape, n):
    """The grid (image groups x strips x slices) and each block's threads
    (image x run of DW_OUT columns x channels) tile (N, W, C) exactly, and
    the phases of ``plan.rows`` rows tile H; in f32 and bf16."""
    h, c, k = shape
    for itemsize in (4, 2):
        plan = plans.dw_plan(n, h, c, k, itemsize)
        assert plan.threads == plan.slice // plan.ch * plan.runs * plan.images <= 256
        # one block's threads: every (image, strip column, slice channel) once
        block = np.zeros((plan.images, plan.runs * plans.DW_OUT, plan.slice), np.int64)
        for tid in range(plan.threads):
            g, cols, ch0 = plans.dw_thread_outputs(plan, tid)
            block[g, cols[0]:cols[-1] + 1, ch0:ch0 + plan.ch] += 1
        _exactly_once(block[:, :plan.strip], "block outputs")
        assert block[:, plan.strip:].sum() == 0
        # the blocks: images, columns and channels each once
        blocks = plans.dw_blocks(plan)
        assert len(blocks) == plan.groups * plan.strips * plan.slices
        images, columns, channels = np.zeros(n), np.zeros(h), np.zeros(c)
        for n0, x0, c0 in {(b[0], 0, 0) for b in blocks}:
            images[n0:n0 + plan.images] += 1
        for _, x0, _ in {(0, b[1], 0) for b in blocks}:
            columns[x0:x0 + plan.strip] += 1
        for _, _, c0 in {(0, 0, b[2]) for b in blocks}:
            channels[c0:c0 + plan.slice] += 1
        for counts, what in ((images, "images"), (columns, "columns"), (channels, "channels")):
            _exactly_once(counts, what)
        assert len(blocks) == len(set(blocks))
        rows = np.zeros(h)
        for r in range(0, h, plan.rows):
            rows[r:r + plan.rows] += 1
        _exactly_once(rows, "rows")


@pytest.mark.parametrize("shape", TAILS, ids=tail_ids)
def test_dw_inputs_staged_once_per_strip(shape):
    """N = 13: every input element is copied (and activated) by one block
    of each strip whose halo holds its column, so once, or twice in a seam
    between strips; the ring positions left zero after the activation are
    exactly the TF-SAME padding and the images past N."""
    h, c, k = shape
    n = 13
    plan = plans.dw_plan(n, h, c, k, 2)
    (top, bottom), (left, right) = tf_same_pads(h, k, 1), tf_same_pads(h, k, 1)
    copies = np.zeros((n, h, h), np.int64)
    for n0, x0, c0 in plans.dw_blocks(plan):
        if c0:
            continue  # every slice stages the same positions
        img, iy, ix, inside = plans.dw_ring_positions(plan, n, h, h, k, n0, x0)
        assert (iy[0] == -top).all() and iy.shape[0] == h + k - 1  # K - 1 zero rows an image
        outside = (img >= n) | (iy < 0) | (iy >= h) | (ix < 0) | (ix >= h)
        assert np.array_equal(~inside, outside)
        assert ((iy < 0).sum(axis=0) == top).all() and ((iy >= h).sum(axis=0) == bottom).all()
        np.add.at(copies, (img[inside], iy[inside], ix[inside]), 1)
    seams = np.zeros(h, np.int64)
    for s in range(1, plan.strips):
        x0 = s * plan.strip
        seams[max(0, x0 - left):x0 + right] += 1
    assert np.array_equal(copies, np.broadcast_to(1 + seams, copies.shape))
    assert (seams.sum() == 0) == (plan.strips == 1)


@pytest.mark.parametrize("shape", TAILS, ids=tail_ids)
def test_dw_shared_memory_fits(shape):
    """A block's rings, at N 256 and 13 in both dtypes, and the most the
    launch allows the variant, stay within 227 KB; the threads are a
    multiple of the 16-byte copies a pixel's slice needs."""
    h, c, k = shape
    for n in (256, 13):
        for itemsize in (4, 2):
            plan = plans.dw_plan(n, h, c, k, itemsize)
            assert plan.smem <= plans.dw_max_smem(plan, k, itemsize) <= plans.SMEM_LIMIT
            assert plan.threads % (plan.slice * itemsize // 16) == 0
            assert plan.pix >= plan.slice


def _dw_inputs(n, h, c, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, h, c)).astype(np.float32),
            (0.3 * rng.standard_normal((k, k, 1, c))).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype if i == 0 else torch.float32)
            for i, a in enumerate(arrays)]


def _close_to_max(ours, ref, tol):
    ref = np.asarray(ref).astype(np.float32)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


# small ragged shapes (N, H, C, K, act1): image groups with a ragged last
# group, one channel and two rows a thread (C <= 32, K = 5), two channels
# and one row (K = 3, C > 32), an odd H, a 2-strip row (H = 60)
EMULATED = [(3, 9, 16, 5, True), (2, 8, 24, 3, False), (5, 7, 64, 5, True),
            (2, 60, 8, 3, True), (4, 14, 48, 3, True), (3, 7, 96, 3, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_dw_schedule_matches_plain(case, dtype):
    n, h, c, k, act1 = case
    args = _torch(_dw_inputs(n, h, c, k, seed=n + h + c), getattr(torch, dtype))
    ours = plans.dw_emulate(*args, act1=act1, act2=True)
    ref = fused_dw_reference(*args, act1=act1, act2=True)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    _close_to_max(ours, ref.float().numpy(), DW_TOL[dtype])


@pytest.mark.parametrize("k,act1", [(3, True), (5, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_schedule_matches_jax(dtype, k, act1):
    """H = W = 9 (ragged against a run of 7), against the Pallas body in
    interpret mode, as ``test_torch_ops.py::test_fused_dw_matches_jax``."""
    jnp = pytest.importorskip("jax.numpy")
    from orbit_tpu.ops.depthwise import fused_dw_act as jax_op
    x, *rest = _dw_inputs(2, 9, 16, k, seed=9 + k)
    jx = jnp.asarray(x).astype(dtype)
    ref = jax_op(jx, *map(jnp.asarray, rest), stride=1, act1=act1, act2=True, impl="interpret")
    ours = plans.dw_emulate(*_torch([x, *rest], getattr(torch, dtype)), act1=act1, act2=True)
    _close_to_max(ours, ref, DW_TOL[dtype])


# (M, D, class slots, real classes): the SimpleCNAPs path's batched query,
# the cuda test's shapes, a ragged D of 40 and a ragged M
MAHA_SHAPES = [(1000, 1280, 16, 5), (256, 1280, 10, 9), (13, 1280, 5, 4), (3, 40, 2, 1),
               (130, 136, 3, 3)]


@pytest.mark.parametrize("shape", MAHA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_maha_tiles_cover_each_output_once(shape):
    """Every (real class, row, column of half) is one thread's output in
    one block of each split of D, and a tile's splits walk D's stages once;
    padded classes have no block."""
    m, d, c, real = shape
    mask = [1.0] * real + [0.0] * (c - real)
    tiles = [plans.maha_thread_tile(tid) for tid in range(256)]
    rows = np.array([r for rs, cs in tiles for r in rs for _ in cs])
    cols = np.array([col for rs, cs in tiles for _ in rs for col in cs])
    counts = np.zeros((c, m, d), np.int64)
    blocks = plans.maha_blocks(m, d, mask)
    assert len(blocks) == real * np.prod(plans.maha_grid(m, d, c)[:2])
    walked = {}
    for k, m0, e0, stages in blocks:
        r, e = m0 + rows, e0 + cols
        keep = (r < m) & (e < d)
        np.add.at(counts[k], (r[keep], e[keep]), 1)
        walked.setdefault((k, m0, e0), []).extend(stages)
    splits = plans.maha_splits(m, d)
    assert np.array_equal(counts[:real], np.full((real, m, d), splits))
    assert counts[real:].sum() == 0
    assert all(w == list(range(-(-d // plans.MAHA_TILE_K))) for w in walked.values())
    assert all(len(stages) >= min(plans.MAHA_SPLIT_STAGES, -(-d // plans.MAHA_TILE_K))
               for *_, stages in blocks)


def test_maha_splits_by_wave():
    """Five splits at the SimpleCNAPs query (8 x 10 tiles a class), ten, of
    8 stages, for the train path's smaller target batches."""
    assert [plans.maha_splits(m, 1280) for m in (1000, 256, 44, 16)] == [5, 10, 10, 10]
    assert plans.maha_splits(3, 40) == 1


def test_maha_partial_order_is_fixed():
    """A row's columns: each once, tile by tile, 16 groups of 8 a tile; the
    same order every time."""
    for d in (1280, 40, 136):
        groups = plans.maha_row_groups(d)
        order = plans.maha_row_order(d)
        assert sorted(order) == list(range(d)) and order == plans.maha_row_order(d)
        assert len(groups) == -(-d // plans.MAHA_TILE_N)
        for t, tile in enumerate(groups):
            assert len(tile) == 16 and all(len(cols) <= 8 for cols in tile)
            assert all(e // plans.MAHA_TILE_N == t for cols in tile for e in cols)
    assert plans.maha_row_groups(1280)[0][0] == [0, 1, 2, 3, 64, 65, 66, 67]


def test_maha_schedule_matches_plain():
    """M = 24, D = 384 (three N tiles), 5 slots with one padded."""
    rng = np.random.default_rng(0)
    m, d, c = 24, 384, 5
    feats = rng.standard_normal((m, d)).astype(np.float32)
    means = (0.5 * rng.standard_normal((c, d))).astype(np.float32)
    g = rng.standard_normal((c, d, 2 * d)).astype(np.float32) / np.sqrt(2 * d)
    prec = np.linalg.inv(g @ g.transpose(0, 2, 1) + np.eye(d, dtype=np.float32))
    mask = (np.arange(c) < c - 1).astype(np.float32)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (feats, means, prec, mask)]
    ours = plans.maha_emulate(*args, logit_scale=0.5)
    ref = mahalanobis_reference(*args, logit_scale=0.5)
    assert (ours[:, -1] == -1e30).all()
    _close_to_max(ours[:, :-1], ref[:, :-1].numpy(), MAHALANOBIS_TOL)
