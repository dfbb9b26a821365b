"""The bf16 backward routes' plans, mirrored from the CUDA sources so that
the tests can hold them against brute force on the CPU: which block owns
which output tile of ``csrc/grads.cuh``'s launch, which rows each partial
column sum covers, and the order in which the second pass adds them.

The backward kernels #4 and #6 never add into a shared sum: every partial
sum has one writer (a block), covers a fixed run of rows, and a second pass
adds the partials of a column in chunk order, so two calls give the same
bits.
"""
from __future__ import annotations

import torch

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


def mlp_bwd_partials(rows: int, d: int, hidden: int, wgmma: bool) -> int:
    """Floats of #6's partial-sum workspace: db1's partials (one row a
    128-row tile on the wgmma route, a 256-row chunk of common.cuh's column
    sum otherwise) over hidden, then the LayerNorm backward's dγ, dβ and
    db2 partials, one row of each per LN_ROWS rows, over D."""
    db1_chunks = -(-rows // (TILE if wgmma else COLSUM_ROWS))
    return db1_chunks * hidden + 3 * -(-rows // LN_ROWS) * d


def qkv_bwd_partials(b: int, s: int, d: int, wgmma: bool) -> int:
    """Floats of #4's partial sums of db: one row (3D) a batch row (a
    sequence, one attention block's S tokens) on the wgmma route, one a
    256-row chunk otherwise."""
    return (b if wgmma else -(-b * s // COLSUM_ROWS)) * 3 * d
