"""BatchNorm of the EfficientNets with row-masked batch statistics
(counterpart of ``orbit_tpu/models/backbones/masked_bn.py::MaskedBatchNorm``).

Parameters keep the Flax names: ``scale`` and ``bias`` (f32 parameters),
``mean`` and ``var`` (f32 buffers, the Flax ``batch_stats``).

Eval mode (running statistics):
- :meth:`MaskedBatchNorm.fold` returns the eval affine
  ``a = scale * rsqrt(var + eps)``, ``b = bias - mean * a`` in f32, for
  callers that fuse it into an adjacent op (``ops.depthwise.fused_dw_act``,
  orbit_tpu masked_bn.py:54-61);
- the forward applies it **in the compute dtype**, with ``a`` and ``b``
  rounded to it (masked_bn.py:63-73).

Train mode (batch statistics: the meta-training of ``--learn_extractor``
on an EfficientNet), when the forward is given a :class:`BatchStats`
(masked_bn.py:74-128):
- the moments are weighted by the per-row float ``mask`` by select-then-sum,
  so that an ``inf`` in a pad row cannot poison the real rows;
- the variance is two-pass (the mean of squared deviations), in f32;
- a batch with no real rows normalises with the running statistics and
  leaves them unchanged;
- the running statistics take the torch-style update: the unbiased
  variance goes in, with the Flax momentum 0.9 (timm's 0.1);
- the output is computed in f32, then pad rows are pinned to zero (a chunk
  with one real row at 1x1 has variance 0, and rsqrt(eps) would amplify
  its pad rows about 32x a layer), then it is cast to the compute dtype.
The module never writes its buffers in the forward: it reads the running
statistics it starts from in ``BatchStats.running`` and writes the updated
ones to ``BatchStats.new``, so a forward recomputed under
``torch.utils.checkpoint`` sees the same statistics as the first pass and
updates nothing twice. The caller loads the new statistics
(:func:`load_running_stats`), as the JAX package threads its mutable
``batch_stats`` collection.

``film`` (a dict keyed by the extractor's dotted parameter names, e.g.
``blocks_1_0.bn2.scale``) overrides scale and bias for one call in both
modes; the module never mutates its parameters. FiLM meta-training
differentiates through both eval routes: the f32 fold, and the forward's
rounding of the affine to the compute dtype (autograd's cast rounds the
gradient back the same way, as JAX's transpose of the cast does).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Film = Optional[Mapping[str, torch.Tensor]]
Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

BN_MOMENTUM = 0.9  # Flax momentum of the EfficientNets (timm's decay 0.1)


class BatchStats:
    """The train-mode state of one extractor forward: ``mask``, the per-row
    float validity mask (None: every row is real); ``running``, the running
    (mean, var) each BatchNorm starts from, by path; ``new``, the updated
    (mean, var) each BatchNorm writes, detached."""

    def __init__(self, running: Stats, mask: Optional[torch.Tensor] = None):
        self.running, self.mask = running, mask
        self.new: Stats = {}


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float, path: str):
        super().__init__()
        self.eps = eps
        self.path = path  # dotted name in the extractor: the FiLM key prefix
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, g: torch.Generator = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _affine(self, film: Film):
        scale, bias = self.scale, self.bias
        if film:
            scale = film.get(f"{self.path}.scale", scale)
            bias = film.get(f"{self.path}.bias", bias)
        return scale.float(), bias.float()

    def fold(self, film: Film = None):
        """The eval affine (a, b) in f32, with FiLM overrides applied."""
        scale, bias = self._affine(film)
        a = scale * torch.rsqrt(self.var.float() + self.eps)
        return a, bias - self.mean.float() * a

    def forward(self, x: torch.Tensor, film: Film = None,
                batch: Optional[BatchStats] = None):
        """Eval mode without ``batch``; train mode (batch statistics over
        the rows that ``batch.mask`` marks real) with it."""
        if batch is None:
            a, b = self.fold(film)
            return x * a.to(x.dtype) + b.to(x.dtype)
        return self._train(x, film, batch)

    def _train(self, x: torch.Tensor, film: Film, batch: BatchStats):
        scale, bias = self._affine(film)
        ra_mean, ra_var = batch.running[self.path]
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        row_elems = float(math.prod(x.shape[1:-1]))  # elements a row adds
        if batch.mask is None:
            count = x.shape[0] * row_elems
            mean = xf.mean(dim=dims)
            centered = xf - mean
            var = (centered * centered).mean(dim=dims)
            has_rows = None
        else:
            valid = batch.mask.reshape((-1,) + (1,) * (x.dim() - 1)) > 0
            count = batch.mask.float().sum() * row_elems
            safe = count.clamp(min=1.0)
            # select-then-sum: w * inf would be NaN in the real rows' sums
            mean = torch.where(valid, xf, 0.0).sum(dim=dims) / safe
            centered = torch.where(valid, xf - mean, 0.0)
            var = (centered * centered).sum(dim=dims) / safe
            has_rows = count > 0
            mean = torch.where(has_rows, mean, ra_mean)
            var = torch.where(has_rows, var, ra_var)
        with torch.no_grad():
            if has_rows is None:
                unbiased = var * count / max(count - 1.0, 1.0)
            else:
                unbiased = var * count / (count - 1.0).clamp(min=1.0)
            new_mean = BN_MOMENTUM * ra_mean + (1.0 - BN_MOMENTUM) * mean
            new_var = BN_MOMENTUM * ra_var + (1.0 - BN_MOMENTUM) * unbiased
            if has_rows is not None:
                new_mean = torch.where(has_rows, new_mean, ra_mean)
                new_var = torch.where(has_rows, new_var, ra_var)
        batch.new[self.path] = (new_mean.detach(), new_var.detach())
        # (x - mean) * rsqrt(var + eps) * scale + bias, in f32; only the
        # centred tensor is kept for the backward. With no real rows the
        # centred tensor is zero and every row is pinned below.
        y = centered * (torch.rsqrt(var + self.eps) * scale) + bias
        if has_rows is not None:
            y = torch.where(valid, y, 0.0)  # pad rows are dead: pin them to 0
        return y.to(x.dtype)


def running_stats(module: nn.Module) -> Stats:
    """Copies of the running (mean, var) of every MaskedBatchNorm in
    ``module``, by path: the statistics a train-mode forward starts from."""
    return {m.path: (m.mean.detach().clone(), m.var.detach().clone())
            for m in module.modules() if isinstance(m, MaskedBatchNorm)}


@torch.no_grad()
def load_running_stats(module: nn.Module, stats: Stats) -> None:
    """Copy ``stats`` (by path) into the MaskedBatchNorms of ``module``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            mean, var = stats[m.path]
            m.mean.copy_(mean)
            m.var.copy_(var)
