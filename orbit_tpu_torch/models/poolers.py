"""Frame-to-clip feature pooling (counterpart of ``orbit_tpu/models/poolers.py``;
reference: model/poolers.py:7-24)."""
from __future__ import annotations

import torch


def mean_pool_clips(frame_features: torch.Tensor, clip_length: int) -> torch.Tensor:
    """(num_clips*T, D) -> (num_clips, D) by averaging each clip's T frames."""
    feat_dim = frame_features.shape[-1]
    return frame_features.reshape(-1, clip_length, feat_dim).mean(dim=1)
