"""Optimisers, learning-rate schedules and the masked loss of the port
(counterpart of ``orbit_tpu/utils/optim.py``; reference: utils/optim.py:8-50).

- ``cross_entropy``: masked cross-entropy over padded rows, select-then-sum
  like the JAX version (a padded row whose logits degenerated to ±inf must
  not turn 0·inf into NaN).
- ``make_lr_schedule``: pure Python, copied from the JAX package.
- ``init_optimizer``: ``torch.optim.Adam`` or ``SGD`` with two parameter
  groups, the extractor's at ``extractor_lr_scale`` times the learning
  rate, and the rest (set encoder, FiLM generator, Versa processors) at
  the rate. Weight decay is L2 folded into the gradient before the moments,
  torch's own Adam semantics, which the JAX package maps onto optax
  (``add_decayed_weights`` then ``scale_by_adam``).
- ``set_learning_rate`` / ``get_curr_learning_rates``: the epoch's rate.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  reduction: str = "mean") -> torch.Tensor:
    """Masked CE over possibly-padded rows (reference: utils/optim.py:8-9).
    Padded-class logits arrive as -1e30 from the heads; padded rows
    (mask == 0) add zero and leave the mean's denominator. With a leading
    lane axis ((L, N, C) logits, (L, N) labels and mask) it returns each
    lane's (L,) loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean(dim=-1) if reduction == "mean" else nll.sum(dim=-1)
    m = mask.float()
    total = torch.where(m > 0, nll, torch.zeros_like(nll)).sum(dim=-1)
    if reduction == "sum":
        return total
    return total / torch.clamp(m.sum(dim=-1), min=1.0)


def make_lr_schedule(args) -> Callable[[int], float]:
    """Epoch -> lr, matching timm's step/multistep/cosine with linear warmup
    (reference: utils/optim.py:34-43; timm create_scheduler semantics).
    A copy of ``orbit_tpu.utils.optim.make_lr_schedule``."""
    base_lr = args.learning_rate
    warmup_t = getattr(args, "warmup_epochs", 0)
    warmup_lr = getattr(args, "warmup_lr", 1e-6)
    min_lr = getattr(args, "min_lr", 0.0)
    decay_epochs = getattr(args, "decay_epochs", 15)
    decay_rate = getattr(args, "decay_rate", 0.5)
    epochs = getattr(args, "epochs", 30)
    sched = getattr(args, "sched", "multistep")
    k_decay = getattr(args, "lr_k_decay", 1.0)
    # cooldown_epochs (timm create_scheduler) only extends the min-lr tail
    # PAST the single cosine cycle; the reference's training loop runs exactly
    # args.epochs epochs (single-step-learner.py:143), so within training it
    # is observable only through the t >= T branch below.

    if sched == "multistep":
        if decay_epochs >= epochs:
            milestones = [epochs + 1]
        else:
            milestones = list(range(decay_epochs, epochs, decay_epochs))
    else:
        milestones = []

    def schedule(epoch: int) -> float:
        if warmup_t and epoch < warmup_t:
            step = (base_lr - warmup_lr) / warmup_t
            return warmup_lr + epoch * step
        if sched == "multistep":
            k = sum(1 for m in milestones if epoch >= m)
            return base_lr * (decay_rate ** k)
        if sched == "step":
            return base_lr * (decay_rate ** (epoch // decay_epochs))
        if sched == "cosine":
            # timm CosineLRScheduler with warmup_prefix=True (reference
            # optim.py:40-43): t counts from the end of warmup, the cycle
            # length stays t_initial=epochs, k_decay bends the curve
            # (cos(pi * t^k / T^k), timm's k_decay), and epochs past the
            # single cycle (cycle_limit=1) — including any cooldown_epochs —
            # sit at min_lr.
            t = epoch - warmup_t
            T = max(epochs, 1)
            if t >= T:
                return min_lr
            return min_lr + 0.5 * (base_lr - min_lr) * (
                1 + math.cos(math.pi * (t ** k_decay) / (T ** k_decay)))
        raise ValueError(f"Unknown scheduler {sched}")

    return schedule


def init_optimizer(recogniser: torch.nn.Module, args, extractor_lr_scale: float = 1.0,
                   optimizer_type: Optional[str] = None,
                   learning_rate: Optional[float] = None) -> torch.optim.Optimizer:
    """The reference's two-group optimiser (reference: utils/optim.py:11-32)
    over every parameter of ``recogniser``: the extractor's in a group at
    ``extractor_lr_scale`` times the rate. Parameters that get no gradient
    are skipped by the step unless the caller fills them with zeros (the
    JAX step returns zeros for a frozen extractor)."""
    optimizer_type = optimizer_type or args.optimizer
    lr0 = learning_rate if learning_rate is not None else args.learning_rate
    weight_decay = getattr(args, "weight_decay", 0.0)
    extractor = list(recogniser.extractor.parameters())
    ids = {id(p) for p in extractor}
    base = [p for p in recogniser.parameters() if id(p) not in ids]
    groups = [{"params": ps, "lr": lr0 * scale, "base_lr": lr0, "lr_scale": scale}
              for ps, scale in ((base, 1.0), (extractor, extractor_lr_scale)) if ps]
    if optimizer_type == "adam":
        betas = tuple(getattr(args, "betas", (0.9, 0.999)))
        return torch.optim.Adam(groups, lr=lr0, betas=betas,
                                eps=getattr(args, "epsilon", 1e-8),
                                weight_decay=weight_decay)
    if optimizer_type == "sgd":
        return torch.optim.SGD(groups, lr=lr0, momentum=getattr(args, "momentum", 0.0),
                               weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer {optimizer_type}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["base_lr"] = lr
        group["lr"] = lr * group["lr_scale"]


def get_curr_learning_rates(optimizer: torch.optim.Optimizer):
    """(base lr, extractor lr) — reference: utils/optim.py:45-50."""
    extractor = optimizer.param_groups[-1]
    return extractor["base_lr"], extractor["lr"]
