"""Backbone registry (counterpart of ``orbit_tpu/models/backbones/__init__.py``).

``create_feature_extractor(name)`` returns ``(module, output_size,
film_spec)``: ``film_spec`` lists ``(param_path, size)`` for each FiLM-able
norm scale/bias leaf. The EfficientNets carry theirs; FiLM on the ViTs is
not ported yet, so their spec is empty and the recogniser refuses
``adapt_features`` on them.
"""
from __future__ import annotations

import torch

from orbit_tpu_torch.models.backbones.efficientnet import create_efficientnet
from orbit_tpu_torch.models.backbones.vit import create_vit

FEATURE_EXTRACTORS = (
    "efficientnet_b0", "efficientnet_v2_s", "vit_s_32", "vit_b_32", "vit_b_32_clip",
)


def create_feature_extractor(name: str, frame_size: int = 224,
                             dtype=torch.float32):
    if name.startswith("efficientnet"):
        return create_efficientnet(name, dtype=dtype)
    if name.startswith("vit"):
        return (*create_vit(name, frame_size=frame_size, dtype=dtype), [])
    raise ValueError(f"Invalid feature_extractor name: {name} "
                     f"(choices: {FEATURE_EXTRACTORS})")
