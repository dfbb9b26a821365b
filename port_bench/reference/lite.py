"""LITE meta-training steps of the reference (ProtoNets, extractor learned):
the same tasks, the same LITE subsets drawn again from the seed, the same
loss and Adam updates as the port's learner, in plain float32 autograd.

Per task: every real context clip embedded without a graph; for each
target batch of ``batch`` rows that holds real rows, ``num_lite`` context
clips drawn (``argsort(uniform - 10 * mask)``, real rows first, from a CPU
generator seeded with the run's seed, one draw of the padded context's
length a batch) are embedded with a graph and put in place of their cached
features; the head is configured on the mixed features and the batch's
loss, ``n_context / (num_lite * tasks_per_batch) * CE``, back-propagated.
Every ``tasks_per_batch`` tasks one Adam update (L2 weight decay folded
into the gradient, as ``torch.optim.Adam`` does) at the first epoch's rate.

``fault`` plants one of the faults the check must catch, for its
readings: ``"half"`` takes each batch's loss over its first half only;
``"answer"`` adds 1 to one logit of each batch where it is produced.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference.heads import cross_entropy, masked_logits, proto, proto_logits


def episodes(tasks: List[dict], buckets) -> List[dict]:
    """Train task dicts -> padded context (to its bucket, zero rows) with
    the real row count, and the real target rows."""
    out = []
    for t in tasks:
        ctx = t["context_clips"][:, 0]
        n = ctx.shape[0]
        nb = next(b for b in buckets if n <= b)
        padded = np.zeros((nb,) + ctx.shape[1:], np.uint8)
        padded[:n] = ctx
        out.append({"context": padded, "n_context": n, "labels": t["context_labels"],
                    "target": t["target_clips"][:, 0], "target_labels": t["target_labels"],
                    "way": int(t["context_labels"].max()) + 1})
    return out


def steps(model, eps: List[dict], seed: int, train: dict, device,
          fault: Optional[str] = None) -> Dict[str, object]:
    """Run ``eps`` as meta-training steps from the model's weights. Returns
    each step's logits (real rows, real classes), the gradient of every
    extractor leaf at the first update, and the leaves after the last
    update that ``eps`` completes."""
    params = dict(model.extractor.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=train["lr"], betas=tuple(train["betas"]),
                           eps=train["eps"], weight_decay=train["weight_decay"])
    g = torch.Generator().manual_seed(seed)
    num_lite, tpb, batch = train["num_lite_samples"], train["tasks_per_batch"], train["batch_size"]
    logits_out, grads, updates = [], None, 0
    for t, ep in enumerate(eps):
        nb, n, way = ep["context"].shape[0], ep["n_context"], ep["way"]
        ctx = torch.from_numpy(ep["context"]).to(device)
        labels = torch.from_numpy(ep["labels"]).to(device)
        tgt = torch.from_numpy(ep["target"]).to(device)
        tgt_labels = torch.from_numpy(ep["target_labels"]).to(device)
        mask = torch.zeros(nb)
        mask[:n] = 1.0
        with torch.no_grad():
            cache = torch.zeros(nb, model.extractor.norm.scale.shape[0], device=device)
            cache[:n] = model.embed(ctx[:n])
        scaling = n / (num_lite * tpb)
        parts = []
        for i in range(math.ceil(tgt.shape[0] / batch)):
            idx = torch.argsort(torch.rand(nb, generator=g) - mask * 10.0)[:min(num_lite, nb)]
            idx = idx.to(device)
            feats = cache.index_copy(0, idx, model.embed(ctx[idx]))
            head = proto(feats[:n], labels, 16)
            rows = slice(i * batch, min((i + 1) * batch, tgt.shape[0]))
            logits = masked_logits(proto_logits(head, model.embed(tgt[rows])), way)
            if fault == "answer":
                logits = logits + torch.nn.functional.pad(torch.ones(1, 1, device=device),
                                                          (0, logits.shape[1] - 1,
                                                           0, logits.shape[0] - 1))
            kept = slice(0, max(1, logits.shape[0] // 2)) if fault == "half" else slice(None)
            (scaling * cross_entropy(logits[kept], tgt_labels[rows][kept])).backward()
            parts.append(logits.detach()[:, :way].cpu())
        logits_out.append(torch.cat(parts).numpy())
        if (t + 1) % tpb == 0:
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if updates == 0:
                grads = {k: p.grad.detach().clone() for k, p in params.items()}
            opt.step()
            opt.zero_grad(set_to_none=True)
            updates += 1
    for p in params.values():
        p.requires_grad_(False)
    return {"logits": logits_out, "grads": grads,
            "params": {k: p.detach() for k, p in params.items()}}


def loss(logits: np.ndarray, labels: np.ndarray, n_context: int, train: dict) -> float:
    """A step's loss from its logits (real rows, real classes), in float64:
    the scaled cross-entropy of each target batch, summed."""
    scaling = n_context / (train["num_lite_samples"] * train["tasks_per_batch"])
    total, batch = 0.0, train["batch_size"]
    for i in range(0, len(labels), batch):
        x = logits[i:i + batch].astype(np.float64)
        x = x - x.max(axis=1, keepdims=True)
        logp = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
        total += scaling * float(-logp[np.arange(len(x)), labels[i:i + batch]].mean())
    return total
