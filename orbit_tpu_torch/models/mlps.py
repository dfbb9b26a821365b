"""Small MLP blocks of the hyper-network heads and the FiLM generator
(counterpart of ``orbit_tpu/models/mlps.py``; reference: model/mlps.py:33-63).
Parameters keep the Flax names and layouts (Dense ``kernel`` (in, out),
``bias``; LayerNorm ``scale``, ``bias``); everything computes in f32."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from orbit_tpu_torch.models.backbones.vit import DenseParams, LnParams

FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def _dense(p: DenseParams, x: torch.Tensor) -> torch.Tensor:
    return x @ p.kernel + p.bias


def flax_layer_norm(p: LnParams, x: torch.Tensor, eps: float = FLAX_LN_EPS) -> torch.Tensor:
    """Flax ``nn.LayerNorm``: the one-pass variance E[x^2] - E[x]^2 clipped
    at 0, then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * p.scale) + p.bias


class DenseResidualBlock(nn.Module):
    """3x Linear with ELU, residual added when in/out sizes match
    (reference: model/mlps.py:33-50). The Versa hyper-networks."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.linear1 = DenseParams(in_size, out_size)
        self.linear2 = DenseParams(out_size, out_size)
        self.linear3 = DenseParams(out_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(_dense(self.linear1, x))
        h = F.elu(_dense(self.linear2, h))
        h = _dense(self.linear3, h)
        return h + x if x.shape[-1] == h.shape[-1] else h


class DenseBlock(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Linear (reference: model/mlps.py:52-63).
    The FiLM parameter generators."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.fc1 = DenseParams(in_size, hidden_size)
        self.ln = LnParams(hidden_size)
        self.fc2 = DenseParams(hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(flax_layer_norm(self.ln, _dense(self.fc1, x)))
        return _dense(self.fc2, h)
