"""DeepSets task encoder (counterpart of ``orbit_tpu/models/set_encoder.py``;
reference: model/set_encoders.py:34-134): each context frame -> 64-d with
5x [conv3x3-64 SAME, norm, ReLU, maxpool 2] -> global mean; the caller
takes the masked mean over the set.

The norm is the reference's BatchNorm frozen at its (0, 1) running stats
(the reference keeps this encoder in eval mode), an affine
``x * scale / sqrt(1 + eps) + bias``. The encoder computes in f32 whatever
the backbone dtype: the JAX module's convs (``dtype=None``) promote the
compute-dtype pixels against their f32 parameters, and the precision policy
never casts this encoder.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from orbit_tpu_torch.models.backbones.vit import ConvParams, LnParams

SET_ENCODER_OUTPUT_SIZE = 64
_BN_EPS = 1e-5


class SetEncoder(nn.Module):
    """5x [conv3x3-64, norm, ReLU, maxpool2] -> global avg pool -> 64-d.
    Parameters keep the Flax names: ``conv{i}`` (kernel (3, 3, in, 64),
    bias) and ``norm{i}`` (scale, bias), i = 1..5."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i in range(1, 6):
            self.add_module(f"conv{i}", ConvParams(3, 3, cin, 64))
            self.add_module(f"norm{i}", LnParams(64))
            cin = 64

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for m in self.modules():
            if isinstance(m, (ConvParams, LnParams)):
                m.reset_parameters(g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) frames (any float dtype) -> (N, 64) f32."""
        x = x.float().permute(0, 3, 1, 2)  # NCHW view of the NHWC frames
        for i in range(1, 6):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            x = F.conv2d(x, conv.kernel.permute(3, 2, 0, 1), conv.bias, padding=1)
            scale = (norm.scale / math.sqrt(1.0 + _BN_EPS))[:, None, None]
            x = F.relu(x * scale + norm.bias[:, None, None])
            x = F.max_pool2d(x, 2, 2)
        return x.mean(dim=(2, 3))
