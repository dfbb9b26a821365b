"""Few-shot heads on padded episodes (counterpart of ``orbit_tpu/models/heads.py``):
``proto`` and ``proto_cosine`` (reference: model/classifier_heads.py:182-263),
``versa`` (CNAPs, :121-180), ``mahalanobis`` (SimpleCNAPs, :265-368) and
the FineTuner's ``linear`` head (:53-60), which is trained by the
multi-step learner rather than configured (:func:`init_linear_head`,
:func:`predict_linear`).

A ``sample_mask (N,)`` marks valid context rows and a ``class_mask (C,)``
real classes; padded classes get -1e30 logits. Every configure and predict
function also takes a leading lane axis on all of its tensors ((L, N, D)
features, (L, N) labels and masks, (L, C) class masks: L tasks at once,
``parallel/task_dp.py``), and then returns each lane's head and logits as
the function does on that lane alone; the Mahalanobis logits take no lane
axis (#7 runs once per lane). Every configure function
takes ``(features, labels, sample_mask, num_classes, processors)``, where
``processors`` are the recogniser's Versa hyper-networks (None without
them; only ``versa`` reads them). All head math is f32
whatever the backbone dtype (the repository's design invariants). The
Mahalanobis logits go through ``ops.mahalanobis_logits`` (TPU kernel #7 on
the card); its per-class precisions are a batched ``torch.linalg.inv`` in
f32, which the JAX package also leaves to XLA. The JAX head's
``task_mean`` and ``task_precision`` are not computed: nothing reads them.
Meta-training differentiates every head with autograd: through the
Versa processors, the batched inverse and the Mahalanobis op's backward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from orbit_tpu_torch.models.mlps import DenseResidualBlock
from orbit_tpu_torch.ops.mahalanobis import mahalanobis_logits

NEG_INF = -1e30


def masked_class_stats(features: torch.Tensor, labels: torch.Tensor,
                       sample_mask: torch.Tensor, num_classes: int):
    """(one_hot (N, C), counts (C,), means (C, D)), all f32, by one-hot
    matmul over the valid rows (each with the lane axis in front, if any)."""
    features = features.float()
    one_hot = F.one_hot(labels.long(), num_classes).float()
    one_hot = one_hot * sample_mask.float()[..., None]
    counts = one_hot.sum(dim=-2)
    sums = one_hot.transpose(-1, -2) @ features
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return one_hot, counts, means


def _mask_logits(logits: torch.Tensor, class_mask: Optional[torch.Tensor]):
    if class_mask is None:
        return logits
    return torch.where(class_mask.bool()[..., None, :], logits,
                       torch.full_like(logits, NEG_INF))


# ---------------------------------------------------------------- linear ----
def init_linear_head(num_classes: int, feat_dim: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero-initialised per-task linear layer, f32 (reference:
    classifier_heads.py:53-60)."""
    return {"weight": torch.zeros((num_classes, feat_dim), device=device),
            "bias": torch.zeros((num_classes,), device=device)}


def predict_linear(head, features, logit_scale: float = 1.0,
                   class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logit_scale * (features.float() @ head["weight"].transpose(-1, -2)
                            + head["bias"][..., None, :])
    return _mask_logits(logits, class_mask)


def configure_proto(features, labels, sample_mask, num_classes: int,
                    processors=None) -> Dict[str, torch.Tensor]:
    """Euclidean head: weight = 2*prototype, bias = -|prototype|^2."""
    _, counts, means = masked_class_stats(features, labels, sample_mask, num_classes)
    return {"weight": 2.0 * means, "bias": -(means * means).sum(dim=-1),
            "counts": counts}


def predict_proto(head, features, logit_scale: float = 1.0,
                  class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logit_scale * (features.float() @ head["weight"].transpose(-1, -2)
                            + head["bias"][..., None, :])
    return _mask_logits(logits, class_mask)


def configure_proto_cosine(features, labels, sample_mask, num_classes: int,
                           processors=None) -> Dict[str, torch.Tensor]:
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
    f_norm = torch.sqrt(torch.clamp((f * f).sum(dim=-1, keepdim=True), min=eps * eps))
    w_norm = torch.sqrt(torch.clamp((w * w).sum(dim=-1, keepdim=True), min=eps * eps))
    logits = logit_scale * ((f / f_norm) @ (w / w_norm).transpose(-1, -2))
    return _mask_logits(logits, class_mask)


# ----------------------------------------------------------------- versa ----
class VersaProcessors(nn.Module):
    """Meta-trained hyper-networks that generate the linear layer from the
    class means (reference: classifier_heads.py:121-143); Flax names
    ``weight_processor`` and ``bias_processor``."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.weight_processor = DenseResidualBlock(feat_dim, feat_dim)
        self.bias_processor = DenseResidualBlock(feat_dim, 1)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for block in (self.weight_processor, self.bias_processor):
            for lin in (block.linear1, block.linear2, block.linear3):
                lin.reset_parameters(g)

    def forward(self, class_means: torch.Tensor):
        """(C, D) class means -> ((C, D) weight, (C,) bias); a lane axis in
        front passes through."""
        return (self.weight_processor(class_means),
                self.bias_processor(class_means)[..., 0])


def configure_versa(features, labels, sample_mask, num_classes: int,
                    processors: VersaProcessors = None) -> Dict[str, torch.Tensor]:
    _, counts, means = masked_class_stats(features, labels, sample_mask, num_classes)
    weight, bias = processors(means)
    return {"weight": weight, "bias": bias, "counts": counts}


def predict_versa(head, features, logit_scale: float = 1.0,
                  class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The generated linear layer (classifier_heads.py:145-151)."""
    logits = logit_scale * (features.float() @ head["weight"].transpose(-1, -2)
                            + head["bias"][..., None, :])
    return _mask_logits(logits, class_mask)


# ----------------------------------------------------------- mahalanobis ----
def _masked_cov(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unbiased covariance over the masked rows (torch.cov correction=1;
    reference: classifier_heads.py:349-368), (D, D) f32."""
    f = features.float()
    m = mask.float()[..., None]
    n = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = (f * m).sum(dim=-2, keepdim=True) / n
    centered = (f - mean) * m
    return centered.transpose(-1, -2) @ centered / torch.clamp(n - 1.0, min=1.0)


def configure_mahalanobis(features, labels, sample_mask, num_classes: int,
                          processors=None) -> Dict[str, torch.Tensor]:
    """SimpleCNAPs head (reference: classifier_heads.py:284-326): per class
    ``P_k = inv(lambda_k * class_cov + (1 - lambda_k) * task_cov + I)``,
    ``lambda_k = n_k / (n_k + 1)``; a single-sample class takes the
    reference's scalar covariance of its one D-vector (:358-361)."""
    f = features.float()
    d = f.shape[-1]
    one_hot, counts, means = masked_class_stats(f, labels, sample_mask, num_classes)
    task_cov = _masked_cov(f, sample_mask)[..., None, :, :]
    eye = torch.eye(d, device=f.device, dtype=torch.float32)
    one_hot_t = one_hot.transpose(-1, -2)                   # (C, N)
    # every class's rows, centred on its mean, zero elsewhere: (C, N, D)
    centered = (f[..., None, :, :] - means[..., :, None, :]) * one_hot_t[..., None]
    cov_nd = (centered.transpose(-1, -2) @ centered
              / torch.clamp(counts - 1.0, min=1.0)[..., None, None])
    single = one_hot_t @ f                                  # (C, D): the row of an n==1 class
    xc = single - single.mean(dim=-1, keepdim=True)
    cov_1d = (xc * xc).sum(dim=-1) / (d - 1)                # (C,) scalars
    class_cov = torch.where((counts > 1.0)[..., None, None], cov_nd,
                            cov_1d[..., None, None].expand_as(cov_nd))
    n = torch.clamp(counts, min=1.0)
    lam = (n / (n + 1.0))[..., None, None]
    precisions = torch.linalg.inv(lam * class_cov + (1.0 - lam) * task_cov + eye)
    return {"means": means, "precisions": precisions, "counts": counts}


def predict_mahalanobis(head, features, logit_scale: float = 1.0,
                        class_mask: Optional[torch.Tensor] = None,
                        impl: Optional[str] = None) -> torch.Tensor:
    """logits = -Mahalanobis^2(feature, class distribution) (reference:
    classifier_heads.py:328-347), through the kernel op."""
    return mahalanobis_logits(features, head["means"], head["precisions"],
                              class_mask=class_mask, logit_scale=logit_scale, impl=impl)


CONFIGURE = {"proto": configure_proto, "proto_cosine": configure_proto_cosine,
             "versa": configure_versa, "mahalanobis": configure_mahalanobis}
PREDICT = {"proto": predict_proto, "proto_cosine": predict_proto_cosine,
           "versa": predict_versa, "mahalanobis": predict_mahalanobis}
