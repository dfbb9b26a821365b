"""Kernel plans mirrored from the CUDA sources so that the tests can hold
them against brute force on the CPU: which block owns which output tile
of ``csrc/grads.cuh``'s launch, which rows each partial column sum covers,
and the order in which the second pass adds them (the bf16 backward
routes); the geometry, staging and schedule of the fused depthwise tail
(#8, ``csrc/depthwise.cu``); the tiles and partial sums of the Mahalanobis
logits (#7, ``csrc/mahalanobis.cu``); the tiles, walks, rings and strips
of the bf16 attention on a raw qkv and its backward (#1 and #2,
``csrc/tiny_attention.cu``); the row tiles and blocks of the f32 routes of
kernels A and B on the f32 mainloop (``csrc/sgemm.cuh``), with the
mainloop's order of sums and kernel A's f32 route emulated; the tiles,
shared memory and partial sums of the f32 routes of #4 and #6 on that
mainloop, whose operand layouts, ragged K and packed attention backward
are emulated with them.

The backward kernels #4 and #6 never add into a shared sum: every partial
sum has one writer (a block), covers a fixed run of rows, and a second pass
adds the partials of a column in chunk order, so two calls give the same
bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orbit_tpu_torch.kernels.build import COLSUM_ROWS

TILE = 128      # wgmma.cuh's output tile (kBM; kTile in grads.cuh and #6's hidden kernel)
LN_ROWS = 64    # rows a block of #6's LayerNorm backward (kLnRows in mlp_block_bwd.cu)


def tiles(m: int, n: int) -> int:
    """Output tiles of an (m, n) product: ragged rows, n a multiple of TILE
    (``grads.cuh::tiles``)."""
    return -(-m // TILE) * (n // TILE)


def grads_schedule(rows: int, weights, data):
    """The blocks of ``grads.cuh``'s launch, in block order, as (product,
    m0, n0): product j < len(weights) is weight gradient j, (m, n) =
    weights[j], over K = rows; product len(weights) is the data gradient,
    ``data`` = (n, k), over the rows. The weight tiles come first when
    their K (the rows) is at least the data product's, else the data
    tiles; inside a product, tiles row by row."""
    n_w = len(weights)
    shapes = [*weights, (rows, data[0])]
    order = [*range(n_w), n_w] if rows >= data[1] else [n_w, *range(n_w)]
    return [(j, (t // (shapes[j][1] // TILE)) * TILE, (t % (shapes[j][1] // TILE)) * TILE)
            for j in order for t in range(tiles(*shapes[j]))]


def row_chunks(rows: int, chunk: int):
    """The runs of rows the partial sums cover, in the order the second
    pass adds them: [(r0, r1), ...] of ``chunk`` rows, the last ragged."""
    return [(r0, min(rows, r0 + chunk)) for r0 in range(0, rows, chunk)]


def chunk_partials(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(chunks, N) f32 partial column sums of x (rows, N), one row a chunk."""
    return torch.stack([x[r0:r1].float().sum(dim=0) for r0, r1 in row_chunks(x.shape[0], chunk)])


def fixed_order_sum(partials: torch.Tensor) -> torch.Tensor:
    """The second pass: the partials of each column added in chunk order."""
    out = torch.zeros_like(partials[0])
    for p in partials:
        out = out + p
    return out


def mlp_bwd_partials(rows: int, d: int, hidden: int, tiled: bool) -> int:
    """Floats of #6's partial-sum workspace: db1's partials (one row a
    128-row tile of the hidden kernel on the tiled routes, bf16's wgmma and
    f32's sgemm; a 256-row chunk of common.cuh's column sum otherwise) over
    hidden, then the LayerNorm backward's dγ, dβ and db2 partials, one row
    of each per LN_ROWS rows, over D."""
    db1_chunks = -(-rows // (TILE if tiled else COLSUM_ROWS))
    return db1_chunks * hidden + 3 * -(-rows // LN_ROWS) * d


def qkv_bwd_partials(b: int, s: int, d: int, wgmma: bool) -> int:
    """Floats of #4's partial sums of db: one row (3D) a batch row (a
    sequence, one attention block's S tokens) on the wgmma route, one a
    256-row chunk otherwise."""
    return (b if wgmma else -(-b * s // COLSUM_ROWS)) * 3 * d


# ---- #8, the fused depthwise tail (csrc/depthwise.cu) ----
DW_OUT = 7                 # kOut: outputs a thread computes along its row
DW_MAX_THREADS = 256       # kMaxThreads
DW_STRIP_MAX = 56          # kStripMax: widest strip of output columns
DW_GROUP_SMEM = 40 * 1024  # kGroupSmem: rings of a block that groups images
SMEM_LIMIT = 232448        # shared memory one H100 block can use (227 KB)


class DwPlan(NamedTuple):
    """``csrc/depthwise.cu``'s ``Plan``: groups * strips * slices blocks
    (the slice fastest), ``threads`` a block, ``smem`` bytes of its two
    rings."""
    ch: int       # channels a thread computes
    pix: int      # ring elements a column
    rows: int     # output rows a thread computes a phase
    slice: int    # channels a block
    strip: int    # output columns a block
    runs: int     # runs of DW_OUT outputs covering a strip row
    images: int   # images a block
    strips: int
    groups: int
    slices: int
    threads: int
    smem: int


def dw_depth(rows: int) -> int:
    """``depth_of``: raw input rows in flight ahead of the compute."""
    return rows + 2


def dw_ring_rows(k: int, rows: int) -> int:
    """Activated rows a block keeps: a phase's ``rows + K - 1`` and the
    ``rows`` it activates for the next phase."""
    return k + 2 * rows - 1


def dw_ring_bytes(runs: int, pix: int, rows: int, k: int, itemsize: int) -> int:
    """One image's rings: the activated f32 rows and the raw rows in the
    storage type, ``runs * DW_OUT + K - 1`` columns of ``pix``."""
    return (runs * DW_OUT + k - 1) * pix * (dw_ring_rows(k, rows) * 4 + dw_depth(rows) * itemsize)


def dw_plan(n: int, w: int, c: int, k: int, itemsize: int) -> DwPlan:
    """``launch_k`` and ``make_plan``: the widest channel slice that
    divides C, strips of at most DW_STRIP_MAX columns; a 32-element ring
    column, one channel and two output rows a thread for slices up to 32
    channels; else a column of the slice's width, and at K = 5 one channel a thread
    where an image's threads stay within DW_MAX_THREADS (else two) and two
    output rows, at K = 3 two channels and one row; images grouped
    up to DW_MAX_THREADS threads and DW_GROUP_SMEM bytes of rings (at least
    one)."""
    slice_ = next(s for s in (64, 48, 32, 16, 8) if c % s == 0)
    strips = -(-w // DW_STRIP_MAX)
    strip = -(-w // strips)
    runs = -(-strip // DW_OUT)
    pix = max(slice_, 32)
    ch = 1 if slice_ <= 32 or (k == 5 and slice_ * runs <= DW_MAX_THREADS) else 2
    rows = 2 if slice_ <= 32 or k == 5 else 1
    image_threads = slice_ // ch * runs
    image_bytes = dw_ring_bytes(runs, pix, rows, k, itemsize)
    images = max(1, min(n, DW_MAX_THREADS // image_threads, DW_GROUP_SMEM // image_bytes))
    return DwPlan(ch, pix, rows, slice_, strip, runs, images, strips, -(-n // images),
                  c // slice_, image_threads * images, image_bytes * images)


def dw_max_smem(plan: DwPlan, k: int, itemsize: int) -> int:
    """The dynamic shared memory ``launch_ch`` allows the plan's variant:
    one image of 8 runs, or a group of images."""
    return max(dw_ring_bytes(DW_STRIP_MAX // DW_OUT, plan.pix, plan.rows, k, itemsize),
               DW_GROUP_SMEM)


def dw_blocks(plan: DwPlan):
    """(n0, x0, c0) of every block, in blockIdx.x order."""
    return [((b // plan.strips) * plan.images, (b % plan.strips) * plan.strip, s * plan.slice)
            for b in range(plan.groups * plan.strips) for s in range(plan.slices)]


def dw_thread_outputs(plan: DwPlan, tid: int):
    """Block-relative (image, first column, first channel, columns) of the
    outputs thread ``tid`` computes in every row: ``plan.ch`` channels of up
    to DW_OUT neighbouring columns of the strip."""
    lanes = plan.slice // plan.ch
    lane, run, g = tid % lanes, (tid // lanes) % plan.runs, tid // (lanes * plan.runs)
    cols = [run * DW_OUT + o for o in range(DW_OUT) if run * DW_OUT + o < plan.strip]
    return g, cols, plan.ch * lane


def dw_ring_positions(plan: DwPlan, n: int, h: int, w: int, k: int, n0: int, x0: int):
    """The ring positions a block walks: for every input row t (0 .. H+K-2,
    input row t - pad_top), image slot g and ring column, the image, input
    row and column it holds, and whether it is inside the image (copied and
    activated) or zero after the activation. Arrays of shape
    (H + K - 1, images, ring width)."""
    pad_top, pad_left = (k - 1) // 2, (k - 1) // 2
    ring_w = plan.runs * DW_OUT + k - 1
    t, g, col = np.meshgrid(np.arange(h + k - 1), np.arange(plan.images), np.arange(ring_w),
                            indexing="ij")
    img, iy, ix = n0 + g, t - pad_top, x0 - pad_left + col
    inside = (img < n) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return img, iy, ix, inside


def dw_emulate(x, taps, a1, b1, a2, b2, *, act1: bool, act2: bool) -> torch.Tensor:
    """The kernel's schedule on the CPU: per block, its ring of activated
    rows (the pre-affine and SiLU in f32, rounded to x's dtype, zero outside
    the image after the activation); phase by phase, ``plan.rows`` output
    rows from the ring's rows, each output's K*K products added in (row,
    column) order in f32, while the next phase's rows take the slots of
    rows no later output reads; the post-affine and SiLU in f32 and one
    cast. x (N, H, W, C), taps (K, K, 1, C), stride 1, TF-SAME."""
    dt = x.dtype
    n, h, w, c = x.shape
    k = taps.shape[0]
    plan = dw_plan(n, w, c, k, x.element_size())
    tw = taps.to(dt).float().reshape(k, k, c)
    out = torch.empty_like(x)
    ring_w = plan.runs * DW_OUT + k - 1
    n_ring, n_in = dw_ring_rows(k, plan.rows), plan.rows + k - 1
    for n0, x0, c0 in dw_blocks(plan):
        cs = slice(c0, c0 + plan.slice)
        img, iy, ix, inside = dw_ring_positions(plan, n, h, w, k, n0, x0)
        ring, held = [None] * n_ring, [None] * n_ring

        def activate(t):
            vals = torch.zeros(plan.images, ring_w, plan.slice)
            if t < len(inside) and inside[t].any():
                m = inside[t]
                raw = x[img[t][m], iy[t][m], ix[t][m], cs].float()
                a = raw * a1[cs].float() + b1[cs].float()
                vals[torch.from_numpy(m)] = (F.silu(a) if act1 else a).to(dt).float()
            ring[t % n_ring], held[t % n_ring] = vals, t

        for t in range(n_in):
            activate(t)
        for r in range(0, h, plan.rows):
            rows = [ring[(r + i) % n_ring] for i in range(n_in)]
            assert [held[(r + i) % n_ring] for i in range(n_in)] == list(range(r, r + n_in))
            for t in range(r + n_in, r + n_in + plan.rows):
                activate(t)  # the next phase's rows, into slots no later output reads
            for rr in range(min(plan.rows, h - r)):
                acc = torch.zeros(plan.images, plan.runs * DW_OUT, plan.slice)
                for di in range(k):
                    for dj in range(k):
                        acc = acc + rows[rr + di][:, dj:dj + plan.runs * DW_OUT] * tw[di, dj, cs]
                y = acc * a2[cs].float() + b2[cs].float()
                y = (F.silu(y) if act2 else y).to(dt)
                cols, imgs = min(plan.strip, w - x0), min(plan.images, n - n0)
                out[n0:n0 + imgs, r + rr, x0:x0 + cols, cs] = y[:imgs, :cols]
    return out


# ---- #7, the Mahalanobis logits (csrc/mahalanobis.cu) ----
MAHA_TILE_M = 128   # kTM
MAHA_TILE_N = 128   # kTN
MAHA_TILE_K = 16    # kTK
MAHA_STAGES = 4     # kStages
MAHA_SMEM = 4 * (2 * MAHA_TILE_K * (MAHA_TILE_M + 4) + MAHA_STAGES * MAHA_TILE_M * MAHA_TILE_K
                 + MAHA_STAGES * MAHA_TILE_K * MAHA_TILE_N)
# blocks a class aims at: many short blocks fill the last wave. On an H100
# at M = 1000 (16 slots, 5 real), 80 (1.5 waves) read 48.7% of the bound,
# 160 54.8%, 240 56.5%, 400 57.6% (chip_smoke.py's bound).
MAHA_CLASS_BLOCKS = 400
MAHA_SPLIT_STAGES = 8    # the fewest 16-deep stages a split of D keeps


def maha_splits(m: int, d: int) -> int:
    """The ranges D is cut into, each a block and a partial sum of its own:
    enough that a class has about MAHA_CLASS_BLOCKS blocks (the real
    classes are known only on the device), at least MAHA_SPLIT_STAGES
    stages each. 5 at the SimpleCNAPs query's M = 1000, D = 1280 (8 x 10
    tiles), 10 at the train path's target batches of 256, 44 and 16."""
    tiles = -(-m // MAHA_TILE_M) * -(-d // MAHA_TILE_N)
    return max(1, min(-(-MAHA_CLASS_BLOCKS // tiles), -(-d // MAHA_TILE_K) // MAHA_SPLIT_STAGES))


def maha_split_stages(m: int, d: int):
    """The 16-deep stages of D each split walks, in split order."""
    n_stages, splits = -(-d // MAHA_TILE_K), maha_splits(m, d)
    per = -(-n_stages // splits)
    return [range(s * per, min(n_stages, (s + 1) * per)) for s in range(splits)]


def maha_grid(m: int, d: int, c: int):
    """(partial sums a row: N tiles x splits, M tiles, class slots): the
    partial kernel's grid."""
    return -(-d // MAHA_TILE_N) * maha_splits(m, d), -(-m // MAHA_TILE_M), c


def maha_thread_tile(tid: int):
    """Tile-relative (rows, columns) of thread ``tid``'s 8 x 8 outputs, the
    columns in the order its row sums add them; a warp holds 4 row groups
    by 8 column groups."""
    warp, lane = tid // 32, tid % 32
    ty, tx = (warp // 2) * 4 + lane // 8, (warp % 2) * 8 + lane % 8
    rows = [ty * 4 + i for i in range(4)] + [64 + ty * 4 + i for i in range(4)]
    cols = [tx * 4 + j for j in range(4)] + [64 + tx * 4 + j for j in range(4)]
    return rows, cols


def maha_row_groups(d: int):
    """The columns of one row's dot with diff, as a block adds them: per N
    tile, per thread of the row (the 16 column groups, added in order), its
    columns in order (columns past D skipped). The second pass adds the
    blocks' partial sums tile by tile, each tile's splits of D in order."""
    return [[[e for e in (t * MAHA_TILE_N + col
                          for col in maha_thread_tile((tx // 8) * 32 + tx % 8)[1]) if e < d]
             for tx in range(16)] for t in range(-(-d // MAHA_TILE_N))]


def maha_row_order(d: int):
    """``maha_row_groups`` flattened: the order of a row's D columns."""
    return [e for tile in maha_row_groups(d) for cols in tile for e in cols]


def maha_blocks(m: int, d: int, class_mask):
    """(class, m0, e0, stages of D) of every block that computes (a real
    class's), in launch order; the padded classes' blocks leave at once."""
    n_parts, m_tiles, c = maha_grid(m, d, len(class_mask))
    splits = maha_split_stages(m, d)
    return [(k, mt * MAHA_TILE_M, (p // len(splits)) * MAHA_TILE_N, splits[p % len(splits)])
            for k in range(c) if class_mask[k] > 0 for mt in range(m_tiles)
            for p in range(n_parts)]


def maha_emulate(features, means, precisions, class_mask, logit_scale: float = 1.0):
    """The kernel's sums on the CPU: per block, its split of D's share of
    half = diff @ P_c in f32 (a matrix product, in another order than the
    kernel's), each row's dot with diff over the block's N tile as the
    kernel adds it (per thread its 8 columns, the 16 threads of a row in
    order), then the second pass over the blocks' partial sums in order;
    -1e30 on padded classes."""
    f = features.float()
    m, d = f.shape
    out = torch.full((m, means.shape[0]), -1e30)
    for k in range(means.shape[0]):
        if class_mask[k] <= 0:
            continue
        diff = f - means[k].float()
        total = torch.zeros(m)
        for tile in maha_row_groups(d):
            for stages in maha_split_stages(m, d):
                ks = slice(stages.start * MAHA_TILE_K, stages.stop * MAHA_TILE_K)
                half = diff[:, ks] @ precisions[k].float()[ks]
                part = torch.zeros(m)
                for cols in tile:
                    s = torch.zeros(m)
                    for e in cols:
                        s = s + half[:, e] * diff[:, e]
                    part = part + s
                total = total + part
        out[:, k] = -logit_scale * total
    return out


# ---- #1 and #2, the attention on a raw qkv (csrc/tiny_attention.cu), bf16 ----
ATTN_KEYS = 64          # kMaxTokens: key slots a strip attends over (S <= 64)
ATTN_HEAD = 64          # kHeadDim
ATTN_SLD = 72           # kSLd: bf16 row stride of the tiles (144 bytes)
ATTN_STAGES = 2         # kStages: tiles (items) in a block's ring
ATTN_FWD_WARPS = 8      # kFwdWarps
ATTN_BWD_WARPS = 4      # kBwdWarps: a query strip, then a key strip, each
ATTN_STRIP_BYTES = 2048  # kStripBytes: a warp's staging strip
ATTN_FWD_PER_SM = 2     # __launch_bounds__ of the forward's blocks
ATTN_BWD_PER_SM = 3     # and of the backward's
SM_SMEM = 233472        # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024   # of which the system keeps this much a block


class AttnPlan(NamedTuple):
    """A launch of #1's or #2's bf16 kernel: ``blocks`` persistent blocks
    of ``smem`` bytes walk ``tiles`` tiles (the backward's items, one
    (batch row, head) each), ``per_sm`` blocks an SM; a tile packs ``nseq``
    whole sequences of one head, its q, k, v (and g) tiles ``rows`` rows a
    stage."""
    nseq: int
    tiles: int
    rows: int
    smem: int
    per_sm: int
    blocks: int


def attn_per_sm(smem: int, cap: int) -> int:
    """Blocks of ``smem`` bytes one SM holds, at most ``cap``."""
    return min(cap, SM_SMEM // (smem + BLOCK_RESERVED))


def attn_fwd_smem(rows: int) -> int:
    """``fwd_smem``: the ring of q, k, v and the warps' staging strips."""
    return ATTN_STAGES * 3 * rows * ATTN_SLD * 2 + ATTN_FWD_WARPS * ATTN_STRIP_BYTES


def attn_fwd_plan(b: int, s: int, h: int, sms: int) -> AttnPlan:
    """#1's launch: tiles of nseq = floor(TILE / S) whole sequences of one
    head (``ops/tiny_attention.py::sequence_tiles``), H tiles a row of
    tiles; ``rows`` = (nseq - 1) S + 64, so the last sequence's 64 key
    slots stay in the stage; as many blocks as the SMs hold, at most one a
    tile."""
    nseq = TILE // s
    tiles = h * -(-b // nseq)
    rows = (nseq - 1) * s + ATTN_KEYS
    smem = attn_fwd_smem(rows)
    per_sm = attn_per_sm(smem, ATTN_FWD_PER_SM)
    return AttnPlan(nseq, tiles, rows, smem, per_sm, min(tiles, sms * per_sm))


ATTN_BWD_SMEM = ATTN_STAGES * 4 * ATTN_KEYS * ATTN_SLD * 2  # kBwdSmem: q, k, v, g a stage


def attn_bwd_plan(b: int, s: int, h: int, sms: int) -> AttnPlan:
    """#2's launch: items of one (batch row, head), 64-row tiles."""
    per_sm = attn_per_sm(ATTN_BWD_SMEM, ATTN_BWD_PER_SM)
    return AttnPlan(1, b * h, ATTN_KEYS, ATTN_BWD_SMEM, per_sm, min(b * h, sms * per_sm))


def attn_walk(plan: AttnPlan):
    """The tiles each block walks, in order: block k takes k, k + blocks, ..."""
    return [list(range(k, plan.tiles, plan.blocks)) for k in range(plan.blocks)]


def attn_ring(walk):
    """The ring's schedule for one block's walk: per step n, (the stage tile
    n + 1 is copied into or None, the stage tile n is read from). Asserts
    that a copy lands only in a stage whose tile every warp has finished
    (the barrier that ends step n - 1) and that step n reads the stage
    holding tile n."""
    held = [None] * ATTN_STAGES
    if walk:
        held[0] = walk[0]
    done, steps = set(), []
    for n, t in enumerate(walk):
        into = None
        if n + 1 < len(walk):
            into = (n + 1) % ATTN_STAGES
            assert held[into] is None or held[into] in done, (n, held)
            held[into] = walk[n + 1]
        s = n % ATTN_STAGES
        assert held[s] == t, (n, held)
        steps.append((into, s))
        done.add(t)
    return steps


def attn_tile(t: int, b: int, h: int, nseq: int):
    """Tile t's (head, first sequence, sequences)."""
    seq0 = (t // h) * nseq
    return t % h, seq0, min(nseq, b - seq0)


def attn_units(nseq_here: int, s: int, warps: int = ATTN_FWD_WARPS):
    """Each warp's (sequence in the tile, first query row) strips of 16
    rows, in the order it takes them: unit u to warp u % warps."""
    qtiles = -(-s // 16)
    return [[(u // qtiles, (u % qtiles) * 16) for u in range(w, nseq_here * qtiles, warps)]
            for w in range(warps)]


def _attn_stage(boxes, row0: int, live: int, rows: int) -> torch.Tensor:
    """A stage as the copies leave it: for each (tensor, first column) box,
    ``rows`` rows of 64 columns from ``row0``, those past ``live`` zero,
    as f32 values."""
    out = torch.zeros(len(boxes), rows, ATTN_HEAD)
    for i, (src, c) in enumerate(boxes):
        out[i, :live] = src[row0:row0 + live, c:c + ATTN_HEAD].float()
    return out


def _strip_softmax(sc: torch.Tensor, s: int) -> torch.Tensor:
    """p of a strip's f32 scores (16, 64 key slots): scaled after the dot,
    the slots past S masked, softmax in f32."""
    sc = sc * (1.0 / ATTN_HEAD ** 0.5)
    sc[:, s:] = float("-inf")
    e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def attn_emulate(qkv: torch.Tensor, num_heads: int, sms: int = 132):
    """#1's bf16 schedule on the CPU in qkv's dtype: per block its walk
    through the ring (``attn_ring``), per tile each warp's strips, each
    strip the kernel's rounding points (f32 scores over the sequence's 64
    key slots, masked past S, f32 softmax, p rounded to the dtype, p v
    summed in f32 and rounded once) and its stores (the strip's rows q0 + i
    < S, at the sequence's first row + q0 + i of the (B S + 64, D) output
    rows). Returns (out, writes): out (B S + 64, D), NaN where no strip
    wrote, and the writes of each (output row, head)."""
    dt = qkv.dtype
    n, s, d3 = qkv.shape
    d = d3 // 3
    plan = attn_fwd_plan(n, s, num_heads, sms)
    flat = qkv.reshape(n * s, d3)
    out = torch.full((n * s + ATTN_KEYS, d), float("nan"), dtype=dt)
    writes = torch.zeros(n * s + ATTN_KEYS, num_heads, dtype=torch.int64)
    for walk in attn_walk(plan):
        stages = [None] * ATTN_STAGES

        def load(t, into):
            hh, seq0, here = attn_tile(t, n, num_heads, plan.nseq)
            boxes = [(flat, p * d + hh * ATTN_HEAD) for p in range(3)]
            stages[into] = _attn_stage(boxes, seq0 * s, here * s, plan.rows)

        if walk:
            load(walk[0], 0)
        for step, ((into, at), t) in enumerate(zip(attn_ring(walk), walk)):
            if into is not None:
                load(walk[step + 1], into)
            q, k, v = stages[at].to(dt).float()
            hh, seq0, here = attn_tile(t, n, num_heads, plan.nseq)
            for units in attn_units(here, s):
                for qq, q0 in units:
                    r0 = qq * s
                    keys, vals = k[r0:r0 + ATTN_KEYS], v[r0:r0 + ATTN_KEYS]
                    assert keys.shape[0] == ATTN_KEYS  # the slots stay in the stage
                    p = _strip_softmax(q[r0 + q0:r0 + q0 + 16] @ keys.T, s)
                    o = (p.to(dt).float() @ vals).to(dt)
                    live = [i for i in range(16) if q0 + i < s]
                    rows = [(seq0 + qq) * s + q0 + i for i in live]
                    out[rows, hh * ATTN_HEAD:(hh + 1) * ATTN_HEAD] = o[live]
                    writes[rows, hh] += 1
    return out, writes


def attn_bwd_emulate(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, sms: int = 132):
    """#2's bf16 schedule on the CPU in qkv's dtype: per block its walk
    through the ring, per item (batch row, head) the query strips (scores
    and dp over the 64 key slots, f32 softmax and ds with the rows past S
    zero, cast(p) and cast(ds * scale) into [query][key] tiles whose
    unwritten rows are NaN, dq = cast(ds * scale) k), then the key strips
    over the query strips below S (dv = cast(p)^T g, dk = cast(ds *
    scale)^T q), each sum in f32 rounded once, stored as
    :func:`attn_emulate` stores. Returns (dqkv, writes): dqkv (B S + 64,
    3D), writes of each (row, part, head)."""
    dt = qkv.dtype
    n, s, d3 = qkv.shape
    d = d3 // 3
    plan = attn_bwd_plan(n, s, num_heads, sms)
    flat, gflat = qkv.reshape(n * s, d3), g.to(dt).reshape(n * s, d)
    dqkv = torch.full((n * s + ATTN_KEYS, d3), float("nan"), dtype=dt)
    writes = torch.zeros(n * s + ATTN_KEYS, 3, num_heads, dtype=torch.int64)
    scale = 1.0 / ATTN_HEAD ** 0.5
    strips = range(0, 16 * -(-s // 16), 16)  # the strips of rows below S
    for walk in attn_walk(plan):
        stages = [None] * ATTN_STAGES

        def load(i, into):
            b, hh = divmod(i, num_heads)
            boxes = [(flat, p * d + hh * ATTN_HEAD) for p in range(3)]
            stages[into] = _attn_stage(boxes + [(gflat, hh * ATTN_HEAD)], b * s, s, ATTN_KEYS)

        if walk:
            load(walk[0], 0)
        for step, ((into, at), i) in enumerate(zip(attn_ring(walk), walk)):
            if into is not None:
                load(walk[step + 1], into)
            q, k, v, gg = stages[at].to(dt).float()
            b, hh = divmod(i, num_heads)
            ps = torch.full((ATTN_KEYS, ATTN_KEYS), float("nan"))
            dss = torch.full((ATTN_KEYS, ATTN_KEYS), float("nan"))
            dq = torch.zeros(ATTN_KEYS, ATTN_HEAD)
            for q0 in strips:
                rows = slice(q0, q0 + 16)
                p = _strip_softmax(q[rows] @ k.T, s)
                dp = gg[rows] @ v.T
                ds = p * (dp - (dp * p).sum(dim=1, keepdim=True)) * scale
                live = (torch.arange(q0, q0 + 16) < s)[:, None]
                p, ds = torch.where(live, p, 0.0), torch.where(live, ds, 0.0)
                ps[rows], dss[rows] = p.to(dt).float(), ds.to(dt).float()
                dq[rows] = dss[rows] @ k
            dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
            for k0 in strips:
                keys = slice(k0, k0 + 16)
                for q0 in strips:
                    qr = slice(q0, q0 + 16)
                    dv[keys] += ps[qr, keys].T @ gg[qr]
                    dk[keys] += dss[qr, keys].T @ q[qr]
            for part, grad in enumerate((dq, dk, dv)):
                c0 = part * d + hh * ATTN_HEAD
                for r0 in strips:
                    live = [j for j in range(16) if r0 + j < s]
                    out_rows = [b * s + r0 + j for j in live]
                    dqkv[out_rows, c0:c0 + ATTN_HEAD] = grad[[r0 + j for j in live]].to(dt)
                    writes[out_rows, part, hh] += 1
    return dqkv, writes


# ---- the f32 routes of kernels A and B on the f32 mainloop (csrc/sgemm.cuh) ----
SG_TILE_N = 128         # kSgTileN: columns of a tile of B's fc1 and fc2


def sgemm_row_tile(m: int, n: int, sms: int) -> int:
    """Rows of the tiles of B's f32 product (m, n) (fc1: n = hidden, fc2:
    n = D): 128, or 32 where 128-row tiles would number fewer than the
    card's SMs (fc2 at S = 5: 60 tiles of 128 rows on 132 SMs, 240 of 32)."""
    return 128 if -(-m // 128) * (n // SG_TILE_N) >= sms else 32


def sgemm_grid(m: int, n: int, bm: int):
    """The blocks of one of B's f32 products in launch order, as (m0, n0,
    rows): block (x, y) owns rows y bm .. and columns x 128 .., its rows
    below m written."""
    return [(y * bm, x * SG_TILE_N, min(bm, m - y * bm))
            for y in range(-(-m // bm)) for x in range(n // SG_TILE_N)]


QKV_F32_TILES = (128, 160)  # kernel A's f32 tiles (launch_f32<128> and <160>)


def qkv_f32_rows(b: int, s: int, h: int, sms: int) -> int:
    """Rows of kernel A's f32 tile, of which a tile packs floor(rows / S)
    whole sequences: the tile of QKV_F32_TILES whose launch (H x tiles
    blocks, one an SM) ends first, by waves x rows, the smaller on a tie:
    160 at S 50, B 256 (3 sequences, 150 of 160 rows real, 8 waves on 132
    SMs, against 12 waves of 100 of 128 rows), 128 at S 5 (25 sequences, 132
    blocks)."""
    def cost(rows):
        blocks = h * -(-b // (rows // s))
        return -(-blocks // sms) * rows
    return min(QKV_F32_TILES, key=cost)


def qkv_f32_blocks(b: int, s: int, h: int, sms: int = 132):
    """The blocks of kernel A's f32 route in launch order, as (head, first
    row, rows): grid (H, ceil(B / nseq)), nseq = floor(qkv_f32_rows / S),
    block (x, y) head x of the tile of sequences y nseq .. min(B, (y + 1)
    nseq) - 1."""
    nseq = qkv_f32_rows(b, s, h, sms) // s
    return [(x, y * nseq * s, min(nseq, b - y * nseq) * s)
            for y in range(-(-b // nseq)) for x in range(h)]


def sgemm_emulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The mainloop's sums on the CPU in f32: every output adds its K
    products in ascending k, whatever the depth of a stage, each product
    rounded before its sum (the kernel fuses the two in one fmaf)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1].float() * b[k:k + 1].float()
    return acc


def qkv_f32_emulate(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, num_heads: int,
                    sms: int = 132):
    """Kernel A's f32 route on the CPU: per block of
    :func:`qkv_f32_blocks`, the tile's real rows of x against the head's
    q | k | v columns of W by :func:`sgemm_emulate`, +
    b; then ``attend_packed_f32`` for each real query row: the scores a
    64-term dot in ascending order, scaled after it, the softmax over the
    sequence's S keys, p v summed over the keys in order. Returns (out,
    writes): out (B, S, D), NaN where no block wrote, and the writes of each
    (row, head); ``sms`` the card's SMs, which choose the tile."""
    n, s, d = x.shape
    flat = x.reshape(n * s, d).float()
    out = torch.full((n * s, d), float("nan"))
    writes = torch.zeros(n * s, num_heads, dtype=torch.int64)
    for hh, row0, rows in qkv_f32_blocks(n, s, num_heads, sms):
        assert rows % s == 0 and 0 < rows <= max(QKV_F32_TILES)  # whole sequences in a tile
        tile = flat[row0:row0 + rows]
        cols = [p * d + hh * ATTN_HEAD + c for p in range(3) for c in range(ATTN_HEAD)]
        qkv = sgemm_emulate(tile, w.float()[:, cols]) + bias.float()[cols]
        q, k, v = qkv[:, :ATTN_HEAD], qkv[:, ATTN_HEAD:2 * ATTN_HEAD], qkv[:, 2 * ATTN_HEAD:]
        for first in range(0, rows, s):  # a sequence's query rows at once
            seq = slice(first, first + s)
            sc = torch.zeros(s, s)
            for dd in range(ATTN_HEAD):
                sc = sc + q[seq, dd:dd + 1] * k[seq, dd][None, :]
            sc = sc * (1.0 / ATTN_HEAD ** 0.5)
            e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
            p = e / e.sum(dim=1, keepdim=True)
            o = torch.zeros(s, ATTN_HEAD)
            for j in range(s):
                o = o + p[:, j:j + 1] * v[first + j][None, :]
            out[row0 + first:row0 + first + s, hh * ATTN_HEAD:(hh + 1) * ATTN_HEAD] = o
            writes[row0 + first:row0 + first + s, hh] += 1
    return out.reshape(n, s, d), writes


# ---- the f32 routes of the backward kernels #4 and #6 on the f32 mainloop
# (csrc/sgemm.cuh, csrc/sgemm_grads.cuh, csrc/fused_qkv_attention_bwd.cu,
# csrc/mlp_block_bwd.cu) ----
SG_BK = 32        # kBK: depth of a stage
SG_STAGES = 3     # kStages
SG_PAD = 4        # kAPad: floats past a transposed stage row
QKV_BWD_LD = 3 * ATTN_HEAD + 4  # kQkvLd: the q | k | v tile's row stride
HIDDEN_F32_TILES = (128, 64)    # #6's f32 hidden kernel: BM rows, 4 BM threads


def sgemm_smem(bm: int, bn: int, b_k_major: bool = False) -> int:
    """``sgemm.cuh``'s ``Tile::kSmemBytes``: the ring's stages of A [k][m]
    (rows bm + 4 floats apart) and B [k][n] (bn floats apart, bn + 4 when
    B is K-major and its copies transpose)."""
    return 4 * SG_STAGES * SG_BK * (bm + SG_PAD + bn + (SG_PAD if b_k_major else 0))


def packed_ld(s: int) -> int:
    """``attention.cuh::packed_ld``: a row of a sequence's p and ds tiles,
    S rounded up to 4 floats."""
    return (s + 3) & ~3


def qkv_bwd_f32_smem(rows: int, nseq: int, s: int) -> int:
    """Shared memory of #4's f32 attention block (``f32_bwd_smem``): the
    mainloop's ring, or q | k | v (rows x 196), g (rows x 64) and p and ds
    of each of its nseq sequences of S (2 S packed_ld(S)), the larger."""
    attn = 4 * (rows * (QKV_BWD_LD + ATTN_HEAD) + 2 * nseq * s * packed_ld(s))
    return max(sgemm_smem(rows, 3 * ATTN_HEAD), attn)


def qkv_bwd_f32_rows(b: int, s: int, h: int, sms: int) -> int:
    """Rows of the tile #4's f32 route launches: kernel A's f32 tile
    (:func:`qkv_f32_rows`), whose sequences the recompute packs the same
    way, unless the 160-row tile's shared memory would pass SMEM_LIMIT (p
    and ds of three sequences of 53 tokens); 128 wherever the tile's
    sequences fit in 128 rows, as the C entry launches them: 160 at S 50,
    B 256 (3 sequences, 224 KB), 128 at S 5."""
    rows = qkv_f32_rows(b, s, h, sms)
    if qkv_bwd_f32_smem(rows, rows // s, s) > SMEM_LIMIT:
        rows = 128
    return 128 if rows // s * s <= 128 else rows


def qkv_bwd_f32_blocks(b: int, s: int, h: int, sms: int = 132):
    """The blocks of #4's f32 attention launch in launch order, as (head,
    tile, first row, rows): grid (H, ceil(B / nseq)), nseq =
    floor(qkv_bwd_f32_rows / S)."""
    nseq = qkv_bwd_f32_rows(b, s, h, sms) // s
    return [(x, y, y * nseq * s, min(nseq, b - y * nseq) * s)
            for y in range(-(-b // nseq)) for x in range(h)]


def hidden_f32_rows(rows: int, hidden: int, sms: int) -> int:
    """Rows of #6's f32 hidden kernel's tiles (``launch_hidden_f32``): 128
    (512 threads, one block an SM) where 128-row tiles give every SM two
    blocks or more, else 64 (256 threads, two blocks an SM): ViT-B/32 at B
    13 and 16 (S 50) and at S 5, where 128-row tiles would run 144 to 240
    blocks in two waves."""
    return 128 if -(-rows // 128) * (hidden // TILE) >= 2 * sms else 64


def sgemm_grads_plan(rows: int, weights, data, sms: int) -> tuple[int, int]:
    """(x_rows, wsplit) of ``sgemm_grads.cuh``'s launch for the weight
    products ``weights`` [(m, n), ...] over K = rows and the data product
    ``data`` = (n, k): data tiles of TILE rows, or TILE // 2 where TILE-row
    ones would number fewer than the card's SMs (S 5: 60 tiles of 128 rows
    on 132 SMs); the weight products' K cut into the fewest runs of whole
    stages that do no more work than a data block (its k / SG_BK stages of
    x_rows rows: a weight stage is TILE rows), counting only runs that hold
    a stage. ViT-B/32, B 256, S 50: #4's 400 stages in 6 runs against dx's
    72; B 44 (64-row data tiles): 69 stages in 2 runs; none at S 5 for #6
    (chip_smoke.py's phase 3 and 14 shapes, measured against no runs and
    against runs that give every SM a weight block)."""
    x_rows = TILE if -(-rows // TILE) * (data[0] // TILE) >= sms else TILE // 2
    nk = -(-rows // SG_BK)
    split = -(-nk // max(1, data[1] // SG_BK * x_rows // TILE))
    return x_rows, -(-nk // -(-nk // split))


def sgemm_grads_schedule(rows: int, weights, data, x_rows: int, wsplit: int):
    """The blocks of ``sgemm_grads.cuh``'s launch in block order, as
    (product, m0, n0, m_rows, k0, k1): product j < len(weights) is weight
    gradient j, its tiles row by row and each tile's runs of K in order,
    k0 .. k1 the run's rows; product len(weights) is the data product, its
    tiles of x_rows rows over all of its K. The weight blocks come first
    when a run of theirs is at least the data product's K."""
    n_w = len(weights)
    per = -(-(-(-rows // SG_BK)) // wsplit) * SG_BK
    w = [(j, (t // (n // TILE)) * TILE, (t % (n // TILE)) * TILE, TILE,
          min(q * per, rows), min((q + 1) * per, rows))
         for j, (m, n) in enumerate(weights) for t in range(tiles(m, n)) for q in range(wsplit)]
    x = [(n_w, (t // (data[0] // TILE)) * x_rows, (t % (data[0] // TILE)) * TILE, x_rows, 0,
          data[1]) for t in range(-(-rows // x_rows) * (data[0] // TILE))]
    return w + x if per >= data[1] else x + w


def weight_grad_emulate(a: torch.Tensor, b: torch.Tensor, wsplit: int) -> torch.Tensor:
    """A weight gradient a^T . b (a (rows, m), b (rows, n)) as the grads
    launch forms it: each run of K by the mainloop (A MN-major), the runs'
    partials added in run order."""
    rows = a.shape[0]
    per = -(-(-(-rows // SG_BK)) // wsplit) * SG_BK
    return fixed_order_sum(torch.stack([
        sgemm_stage_emulate(a[min(q * per, rows):min((q + 1) * per, rows)],
                            b[min(q * per, rows):min((q + 1) * per, rows)], a_mn=True)
        for q in range(wsplit)]))


def qkv_bwd_f32_partials(b: int, s: int, d: int, h: int, sms: int) -> int:
    """Floats of #4's f32 partial-sum workspace: db's, one row (3D) a row
    tile; then, where the grads launch cuts dW's K into runs, each run's
    dW (D x 3D)."""
    wsplit = sgemm_grads_plan(b * s, [(d, 3 * d)], (d, 3 * d), sms)[1]
    return (-(-b // (qkv_bwd_f32_rows(b, s, h, sms) // s)) * 3 * d
            + (wsplit * d * 3 * d if wsplit > 1 else 0))


def mlp_bwd_f32_partials(rows: int, d: int, hidden: int, sms: int) -> int:
    """Floats of #6's f32 partial-sum workspace: db1's, one row (hidden) a
    tile of the hidden kernel (:func:`hidden_f32_rows`), then the LayerNorm
    backward's dγ, dβ and db2 partials as :func:`mlp_bwd_partials`'s, then,
    where the grads launch cuts the weight gradients' K into runs, each
    run's dW1 and dW2."""
    wsplit = sgemm_grads_plan(rows, [(d, hidden), (hidden, d)], (d, hidden), sms)[1]
    return (-(-rows // hidden_f32_rows(rows, hidden, sms)) * hidden
            + 3 * -(-rows // LN_ROWS) * d + (wsplit * 2 * d * hidden if wsplit > 1 else 0))


def sgemm_stage_emulate(a: torch.Tensor, b: torch.Tensor, *, a_mn: bool = False,
                        b_k: bool = False) -> torch.Tensor:
    """The mainloop on the CPU in f32 for either layout of each operand: A
    (M, K) given as stored, or (``a_mn``) as A^T (K, M); B (K, N), or
    (``b_k``) as B^T (N, K). K is walked in stages of SG_BK, the stage's k
    past K zero-filled (a weight gradient's ragged K), and every output
    adds its products in ascending k as :func:`sgemm_emulate` does."""
    a = (a.T if a_mn else a).float()
    b = (b.T if b_k else b).float()
    m, k = a.shape
    acc = torch.zeros(m, b.shape[1])
    for k0 in range(0, k, SG_BK):
        live = min(k, k0 + SG_BK) - k0
        sa, sb = torch.zeros(m, SG_BK), torch.zeros(SG_BK, b.shape[1])
        sa[:, :live], sb[:live] = a[:, k0:k0 + live], b[k0:k0 + live]
        for kk in range(SG_BK):
            acc = acc + sa[:, kk:kk + 1] * sb[kk:kk + 1]
    return acc


def qkv_bwd_f32_emulate(x, w, bias, g, num_heads: int, sms: int = 132):
    """#4's f32 route on the CPU: per block of :func:`qkv_bwd_f32_blocks`,
    the tile's q | k | v of the head by the mainloop (+ b); then
    ``attention_backward_packed_f32`` per sequence: the scores and dp
    64-term dots in ascending order, the softmax and ds in f32, dq = ds k
    over the keys in order, dk = ds^T q and dv = p^T g over the query rows
    in order; db's partial row of the tile as the block adds it (each
    warp's units of kQRows rows in order, a unit u of warp u mod warps, the
    warps in order). Then dx = dqkv . W^T (B K-major) and dW = x^T . dqkv
    (A MN-major, ragged K) by the mainloop, dW's runs of K
    (:func:`sgemm_grads_plan`) and db's partials each added in order.
    Returns (dx, dW, db, writes of each (row, part, head))."""
    n, s, d = x.shape
    rows_tile = qkv_bwd_f32_rows(n, s, num_heads, sms)
    warps, units_of = rows_tile * 4 // 32, -(-s // 4)
    flat, gflat = x.reshape(n * s, d).float(), g.reshape(n * s, d).float()
    dqkv = torch.full((n * s, 3 * d), float("nan"))
    writes = torch.zeros(n * s, 3, num_heads, dtype=torch.int64)
    part = torch.full((-(-n // (rows_tile // s)), 3 * d), float("nan"))
    scale = 1.0 / ATTN_HEAD ** 0.5
    for hh, tile, row0, rows in qkv_bwd_f32_blocks(n, s, num_heads, sms):
        cols = [p * d + hh * ATTN_HEAD + c for p in range(3) for c in range(ATTN_HEAD)]
        qkv = sgemm_stage_emulate(flat[row0:row0 + rows], w.float()[:, cols]) + bias.float()[cols]
        q, k, v = qkv.split(ATTN_HEAD, dim=1)
        gg = gflat[row0:row0 + rows, hh * ATTN_HEAD:(hh + 1) * ATTN_HEAD]
        out = torch.zeros(rows, 3 * ATTN_HEAD)
        sums = torch.zeros(warps, 3 * ATTN_HEAD)
        for first in range(0, rows, s):
            seq = slice(first, first + s)
            sc, dp = torch.zeros(s, s), torch.zeros(s, s)
            for dd in range(ATTN_HEAD):
                sc = sc + q[seq, dd:dd + 1] * k[seq, dd][None, :]
                dp = dp + gg[seq, dd:dd + 1] * v[seq, dd][None, :]
            e = torch.exp(sc * scale - (sc * scale).amax(dim=1, keepdim=True))
            p = e / e.sum(dim=1, keepdim=True)
            ds = p * (dp - (dp * p).sum(dim=1, keepdim=True)) * scale
            dq, dk, dv = torch.zeros(s, ATTN_HEAD), torch.zeros(s, ATTN_HEAD), torch.zeros(s, ATTN_HEAD)
            for j in range(s):
                dq = dq + ds[:, j:j + 1] * k[first + j][None, :]
                dk = dk + ds[j][:, None] * q[first + j][None, :]
                dv = dv + p[j][:, None] * gg[first + j][None, :]
            out[seq] = torch.cat([dq, dk, dv], dim=1)
            for c in range(units_of):  # the units' rows into their warps' sums, in order
                u = first // s * units_of + c
                r = slice(first + 4 * c, min(first + s, first + 4 * c + 4))
                for i in range(r.start, r.stop):
                    sums[u % warps, :ATTN_HEAD] += out[i, :ATTN_HEAD]
                for i in range(r.start, r.stop):
                    sums[u % warps, ATTN_HEAD:] += out[i, ATTN_HEAD:]
        dqkv[row0:row0 + rows, cols] = out
        writes[row0:row0 + rows, :, hh] += 1
        part[tile, cols] = fixed_order_sum(sums)
    wsplit = sgemm_grads_plan(n * s, [(d, 3 * d)], (d, 3 * d), sms)[1]
    dx = sgemm_stage_emulate(dqkv, w, b_k=True).reshape(n, s, d)
    return dx, weight_grad_emulate(flat, dqkv, wsplit), fixed_order_sum(part), writes


def mlp_bwd_f32_emulate(x, ln_scale, ln_bias, w1, b1, w2, g, ln_eps: float = 1e-6,
                        sms: int = 132):
    """#6's f32 route on the CPU: the LayerNorm recompute; the hidden
    kernel's two products by the mainloop (dhg = g . W2^T with B K-major),
    its epilogue and db1's partial row of each tile (:func:`hidden_f32_rows`
    rows) as the block adds it (a thread's 4 rows in order, the warp's 4
    row groups by a butterfly, the warps of a column half in order); dW1 = xn^T . dhpre
    and dW2 = hg^T . g (A MN-major, ragged K, in the plan's runs of K) and
    dxn = dhpre . W1^T (B K-major) by the mainloop; then the LayerNorm backward and the vector
    gradients' partials (LN_ROWS rows a chunk), every partial buffer added
    in chunk order. Returns (dx, dγ, dβ, dW1, db1, dW2, db2)."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    rows = xf.shape[0]
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + ln_eps)
    xhat = xc * rstd
    xn = xhat * ln_scale.float() + ln_bias.float()
    hpre = sgemm_stage_emulate(xn, w1) + b1.float()
    dhg = sgemm_stage_emulate(gf, w2, b_k=True)
    erf = torch.erf(hpre * 0.7071067811865476)
    phi = torch.exp(-0.5 * hpre * hpre) * 0.3989422804014327
    hg = 0.5 * hpre * (1.0 + erf)
    dh = dhg * (0.5 * (1.0 + erf) + hpre * phi)
    parts = []
    bm = hidden_f32_rows(rows, dh.shape[1], sms)
    for r0 in range(0, rows, bm):
        tile = torch.zeros(bm, dh.shape[1])
        tile[:min(bm, rows - r0)] = dh[r0:r0 + bm]
        # [warp / 2][lane / 16][lane / 8 % 2][row]: rows 4 ty + i, ty = 4 (warp / 2) + lane / 8
        t = tile.view(bm // 16, 2, 2, 4, dh.shape[1])
        thread = t[..., 0, :] + t[..., 1, :] + t[..., 2, :] + t[..., 3, :]
        warp = (thread[:, 0, 0] + thread[:, 0, 1]) + (thread[:, 1, 0] + thread[:, 1, 1])
        parts.append(fixed_order_sum(warp))
    hidden = dh.shape[1]
    wsplit = sgemm_grads_plan(rows, [(d, hidden), (hidden, d)], (d, hidden), sms)[1]
    dw1 = weight_grad_emulate(xn, dh, wsplit)
    dw2 = weight_grad_emulate(hg, gf, wsplit)
    dxn = sgemm_stage_emulate(dh, w1, b_k=True)
    dxhat = dxn * ln_scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + gf).reshape(x.shape)
    return (dx, fixed_order_sum(chunk_partials(dxn * xhat, LN_ROWS)),
            fixed_order_sum(chunk_partials(dxn, LN_ROWS)), dw1,
            fixed_order_sum(torch.stack(parts)), dw2,
            fixed_order_sum(chunk_partials(gf, LN_ROWS)))
