"""ProtoNets heads on padded episodes (counterpart of ``orbit_tpu/models/heads.py``,
``proto`` and ``proto_cosine``; reference: model/classifier_heads.py:182-263).

A ``sample_mask (N,)`` marks valid context rows and a ``class_mask (C,)``
real classes; padded classes get -1e30 logits. All head math is f32
whatever the backbone dtype (CLAUDE.md "Design invariants").
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def masked_class_stats(features: torch.Tensor, labels: torch.Tensor,
                       sample_mask: torch.Tensor, num_classes: int):
    """(one_hot (N, C), counts (C,), means (C, D)), all f32, by one-hot
    matmul over the valid rows."""
    features = features.float()
    one_hot = F.one_hot(labels.long(), num_classes).float()
    one_hot = one_hot * sample_mask.float()[:, None]
    counts = one_hot.sum(dim=0)
    sums = one_hot.T @ features
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return one_hot, counts, means


def _mask_logits(logits: torch.Tensor, class_mask: Optional[torch.Tensor]):
    if class_mask is None:
        return logits
    return torch.where(class_mask.bool()[None, :], logits,
                       torch.full_like(logits, NEG_INF))


def configure_proto(features, labels, sample_mask,
                    num_classes: int) -> Dict[str, torch.Tensor]:
    """Euclidean head: weight = 2*prototype, bias = -|prototype|^2."""
    _, counts, means = masked_class_stats(features, labels, sample_mask, num_classes)
    return {"weight": 2.0 * means, "bias": -(means * means).sum(dim=1),
            "counts": counts}


def predict_proto(head, features, logit_scale: float = 1.0,
                  class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logit_scale * (features.float() @ head["weight"].T + head["bias"])
    return _mask_logits(logits, class_mask)


def configure_proto_cosine(features, labels, sample_mask,
                           num_classes: int) -> Dict[str, torch.Tensor]:
    """Cosine head keeps the prototypes (cosine similarity is scale-free)."""
    _, counts, means = masked_class_stats(features, labels, sample_mask, num_classes)
    return {"weight": means, "counts": counts}


def predict_proto_cosine(head, features, logit_scale: float = 1.0,
                         class_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-8) -> torch.Tensor:
    f = features.float()
    w = head["weight"]
    # the eps clamp sits inside the sqrt: padded classes' prototypes are
    # exactly 0 (orbit_tpu heads.py:109-114)
    f_norm = torch.sqrt(torch.clamp((f * f).sum(dim=1, keepdim=True), min=eps * eps))
    w_norm = torch.sqrt(torch.clamp((w * w).sum(dim=1, keepdim=True), min=eps * eps))
    logits = logit_scale * ((f / f_norm) @ (w / w_norm).T)
    return _mask_logits(logits, class_mask)


CONFIGURE = {"proto": configure_proto, "proto_cosine": configure_proto_cosine}
PREDICT = {"proto": predict_proto, "proto_cosine": predict_proto_cosine}
