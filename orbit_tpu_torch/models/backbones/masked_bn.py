"""BatchNorm of the EfficientNets, eval mode (counterpart of
``orbit_tpu/models/backbones/masked_bn.py::MaskedBatchNorm`` with running
statistics).

Parameters keep the Flax names: ``scale`` and ``bias`` (f32 parameters),
``mean`` and ``var`` (f32 buffers, the Flax ``batch_stats``).

- :meth:`MaskedBatchNorm.fold` returns the eval affine
  ``a = scale * rsqrt(var + eps)``, ``b = bias - mean * a`` in f32, for
  callers that fuse it into an adjacent op (``ops.depthwise.fused_dw_act``,
  orbit_tpu masked_bn.py:54-61);
- the forward applies it **in the compute dtype**, with ``a`` and ``b``
  rounded to it (masked_bn.py:63-73).

``film`` (a dict keyed by the extractor's dotted parameter names, e.g.
``blocks_1_0.bn2.scale``) overrides scale and bias for one call; the module
never mutates its parameters. FiLM meta-training differentiates through
both routes: the f32 fold, and the forward's rounding of the affine to the
compute dtype (autograd's cast rounds the gradient back the same way, as
JAX's transpose of the cast does). Batch statistics (``train=True``, the
meta-training of ``--learn_extractor`` on an EfficientNet, with the row mask
of padded episodes) are a later slice and raise.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

Film = Optional[Mapping[str, torch.Tensor]]


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

    def fold(self, film: Film = None):
        """The eval affine (a, b) in f32, with FiLM overrides applied."""
        scale, bias = self.scale, self.bias
        if film:
            scale = film.get(f"{self.path}.scale", scale)
            bias = film.get(f"{self.path}.bias", bias)
        a = scale.float() * torch.rsqrt(self.var.float() + self.eps)
        return a, bias.float() - self.mean.float() * a

    def forward(self, x: torch.Tensor, film: Film = None, train: bool = False):
        if train:
            raise NotImplementedError(
                "EfficientNet BatchNorm batch statistics (meta-training with "
                "--learn_extractor): not ported yet, a later slice of the port")
        a, b = self.fold(film)
        return x * a.to(x.dtype) + b.to(x.dtype)
