"""Plain float32 few-shot heads and loss of the reference: ProtoNets
(squared Euclidean distance to the class means, as a linear layer) and
SimpleCNAPs (Mahalanobis distance under a per-class regularised
covariance), over real rows only; padded classes get -1e30 logits."""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def class_means(features, labels, num_classes: int):
    one_hot = F.one_hot(labels.long(), num_classes).float()
    counts = one_hot.sum(dim=0)
    return one_hot.T @ features / torch.clamp(counts, min=1.0)[:, None], counts, one_hot


def proto(features, labels, num_classes: int) -> dict:
    means, counts, _ = class_means(features, labels, num_classes)
    return {"weight": 2.0 * means, "bias": -(means * means).sum(dim=-1), "counts": counts}


def proto_logits(head, features):
    return features @ head["weight"].T + head["bias"]


def _cov(x):
    """Unbiased covariance of the rows of ``x`` (one row: divisor 1)."""
    xc = x - x.mean(dim=0, keepdim=True)
    return xc.T @ xc / max(x.shape[0] - 1, 1)


def mahalanobis(features, labels, num_classes: int) -> dict:
    """Per real class P_k = inv(l_k cov_k + (1 - l_k) cov_task + I) with
    l_k = n_k / (n_k + 1); a class of one row takes the scalar variance of
    that row's D values as its covariance."""
    d = features.shape[1]
    means, counts, _ = class_means(features, labels, num_classes)
    task_cov = _cov(features)
    eye = torch.eye(d, device=features.device)
    precisions = torch.zeros(num_classes, d, d, device=features.device)
    for k in range(num_classes):
        rows = features[labels == k]
        n = rows.shape[0]
        if n == 0:
            continue
        if n == 1:
            v = rows[0]
            cov = ((v - v.mean()) ** 2).sum() / (d - 1) * torch.ones(d, d, device=v.device)
        else:
            cov = _cov(rows)
        lam = n / (n + 1.0)
        precisions[k] = torch.linalg.inv(lam * cov + (1.0 - lam) * task_cov + eye)
    return {"means": means, "precisions": precisions, "counts": counts}


def mahalanobis_logits(head, features, block: int = 1024):
    """-(f - mu_k)^T P_k (f - mu_k), ``block`` rows at a time."""
    out = []
    for i in range(0, features.shape[0], block):
        diff = head["means"][None] - features[i:i + block, None]          # (M, C, D)
        out.append(-torch.einsum("mcd,cde,mce->mc", diff, head["precisions"], diff))
    return torch.cat(out)


HEADS = {"proto": (proto, proto_logits), "mahalanobis": (mahalanobis, mahalanobis_logits)}


def masked_logits(logits, way: int):
    """Logits over ``num_classes`` slots with the slots from ``way`` on
    set to -1e30 (padded classes)."""
    out = logits.clone()
    out[:, way:] = NEG_INF
    return out


def cross_entropy(logits, labels):
    """Mean cross-entropy over the rows given (all real)."""
    return F.cross_entropy(logits, labels.long())
