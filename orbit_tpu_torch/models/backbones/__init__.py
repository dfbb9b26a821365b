"""Backbone registry (counterpart of ``orbit_tpu/models/backbones/__init__.py``).

``create_feature_extractor(name)`` returns ``(module, output_size)``. Only
the ViTs are ported; the EfficientNets raise until their slice lands.
"""
from __future__ import annotations

import torch

from orbit_tpu_torch.models.backbones.vit import VIT_CONFIGS, create_vit

FEATURE_EXTRACTORS = (
    "efficientnet_b0", "efficientnet_v2_s", "vit_s_32", "vit_b_32", "vit_b_32_clip",
)


def create_feature_extractor(name: str, frame_size: int = 224,
                             dtype=torch.float32):
    if name.startswith("efficientnet"):
        raise NotImplementedError(f"{name}: not ported yet (the PyTorch port "
                                  f"has the ViT backbones {tuple(VIT_CONFIGS)})")
    if name.startswith("vit"):
        return create_vit(name, frame_size=frame_size, dtype=dtype)
    raise ValueError(f"Invalid feature_extractor name: {name} "
                     f"(choices: {FEATURE_EXTRACTORS})")
