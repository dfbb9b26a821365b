"""Per-task step functions for meta-training and evaluation (counterpart of
``orbit_tpu/learners/steps.py``; reference: single-step-learner.py:196-243
and the personalise/predict calls in :245-375).

PyTorch runs eagerly, so there is nothing to compile. A train step runs the
task's forward and backward and adds the task's gradient, already scaled by
``1/tasks_per_batch``, into the parameters' ``.grad``; the learner applies
one optimiser update every ``tasks_per_batch`` tasks
(:func:`build_apply_update`), as the JAX learner accumulates its returned
gradient trees. A step returns ``(loss, target_logits)``.

The loss carries the FiLM generator's L2 term weighted by
``FILM_REG_WEIGHT`` (single-step-learner.py:204,233), zero without FiLM.

LITE (reference: few_shot_recognisers.py:328-437): the context is embedded
once per task without a graph (the caches of
``SingleStepFewShotRecogniser.lite_caches``: with FiLM the set encoder's
reps and the features under the cached FiLM values); per target batch a
fresh random subset of ``num_lite_samples`` context clips, valid rows
first, is re-embedded with gradients and scattered into the caches
(``personalise_with_lite``), and that batch's loss is
``n_ctx/(num_lite·tasks_per_batch)·CE + FILM_REG_WEIGHT·film_l2``. The batch boundaries are
the JAX package's (full ``batch_size`` batches, the remainder last). Eager
torch runs each batch at its real size: the target rows after the last
real one (the episode's bucket padding) are not run, so the tail batch is
ragged; the JAX package's pad-to-8 of the tail
(orbit_tpu/learners/steps.py:296-304) has no counterpart. Those rows add
nothing to the masked loss, so the gradients are the JAX step's, and the
logits returned are those of the rows run. The
subsets come from an explicit ``torch.Generator``; the JAX threefry draw
cannot be reproduced, so tests inject them (``grad_idxs``).

Meta-training the extractor (``--learn_extractor``) on an EfficientNet runs
its BatchNorms on batch statistics and updates their running statistics in
the JAX step's order (orbit_tpu/learners/steps.py:120-150,188-345):
without LITE the context, then the target; with LITE the no-grad cache
pass over the whole context, then for each target batch the grad subset
(masked by ``context_mask[grad_idxs]``), then the target batch. Every
statistic covers the real rows only, so running the target only up to its
last real row equals the JAX step's padding of the tail to a multiple of 8:
a pad row changes no statistic. A target batch of padding only (a bucket
more than ``batch_size`` rows past the last real row) still runs its grad
subset's forward, without a graph, because the JAX step's recompute of that
subset moves the running statistics; without BatchNorm statistics such a
batch is not run. In an all-padding episode the context passes still run.

An all-padding episode contributes zero loss and no gradient. With nothing
trainable (a frozen extractor and the proto heads) no graph is built and no
backward runs; :func:`build_apply_update` then feeds the optimiser the zero
gradients that the JAX step returns, for the trainable parameters only: a
frozen extractor (``requires_grad`` off) is left out of the update and
keeps its bits, as the reference's frozen parameters do. (The JAX step
returns zeros for it, and its optax chain's weight decay then moves it.)
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from orbit_tpu_torch.utils.optim import cross_entropy

FILM_REG_WEIGHT = 0.001  # reference: single-step-learner.py:204,233

Episode = Dict[str, torch.Tensor]


def _trainable(recogniser: torch.nn.Module) -> bool:
    return any(p.requires_grad for p in recogniser.parameters())


def _is_real(target_mask: torch.Tensor) -> bool:
    return bool((target_mask > 0).any())


def _learns_batch_stats(recogniser: SingleStepFewShotRecogniser, args) -> bool:
    """Whether the step runs the extractor's BatchNorms on batch statistics
    (meta-training an EfficientNet with ``--learn_extractor``)."""
    return bool(args.learn_extractor) and recogniser.has_batch_norm


def _rows_to_run(target_mask: torch.Tensor) -> int:
    """The target rows up to the last real one (0 for all padding)."""
    if target_mask.shape[0] < 1:
        raise ValueError("a train task needs target rows (m > 0)")
    real = torch.nonzero(target_mask > 0)
    return int(real.max()) + 1 if real.numel() else 0


def build_train_task(recogniser: SingleStepFewShotRecogniser, args) -> Callable:
    """Non-LITE meta-training step: personalise on the context with
    gradients, predict the target, loss = CE/tasks_per_batch +
    FILM_REG_WEIGHT·film_l2 (single-step-learner.py:196-210). Returns
    fn(episode) -> (loss, logits)."""
    tasks_per_batch = args.tasks_per_batch
    train = _learns_batch_stats(recogniser, args)

    def train_task(episode: Episode, generator: Optional[torch.Generator] = None):
        del generator  # non-LITE draws nothing
        m = _rows_to_run(episode["target_mask"])
        personalise = functools.partial(
            recogniser.personalise, episode["context_clips"], episode["context_labels"],
            episode["context_mask"], episode["class_mask"].shape[0], train=train)
        if m == 0:  # all padding: zero loss, no gradient
            if train:  # the context still moves the running statistics
                with torch.no_grad():
                    personalise()
            return (torch.zeros((), device=episode["target_mask"].device),
                    torch.zeros((0, episode["class_mask"].shape[0])))
        with torch.set_grad_enabled(_trainable(recogniser)):
            state = personalise(with_grad=True)
            logits = recogniser.predict(state, episode["target_clips"][:m],
                                        class_mask=episode["class_mask"],
                                        with_grad=True, train=train,
                                        clip_mask=episode["target_mask"][:m])
            loss = (cross_entropy(logits, episode["target_labels"][:m],
                                  episode["target_mask"][:m]) / tasks_per_batch
                    + FILM_REG_WEIGHT * state["film_l2"])
        if loss.requires_grad:
            loss.backward()
        return loss.detach(), logits.detach()

    return train_task


def lite_grad_subset(generator: torch.Generator, context_mask: torch.Tensor,
                     num_lite: int) -> torch.Tensor:
    """``num_lite`` random context indices, valid rows first (the reference
    permutes real rows only, few_shot_recognisers.py:335-336): the JAX
    package's ``argsort(uniform - 10·mask)[:L]`` with torch's generator."""
    n = context_mask.shape[0]
    noise = torch.rand(n, generator=generator)
    order = torch.argsort(noise - context_mask.detach().float().cpu() * 10.0)
    return order[:min(num_lite, n)]


def lite_runs(m: int, target_rows: int, batch_size: int, train: bool) -> int:
    """The target batches a LITE step runs, one grad subset each: those
    with real rows (``m``: the rows up to the last real one), and with
    BatchNorm statistics (``train``) every batch of the JAX step over the
    ``target_rows`` of the episode."""
    return math.ceil((target_rows if train else m) / batch_size)


def build_train_task_lite(recogniser: SingleStepFewShotRecogniser, args) -> Callable:
    """LITE meta-training step (single-step-learner.py:212-243). Returns
    fn(episode, generator, grad_idxs=None) -> (loss, logits); ``grad_idxs``
    is an optional sequence of one index tensor per target batch run (with
    BatchNorm statistics, per target batch of the JAX step, padding-only
    ones included), in place of the generator's draws."""
    tasks_per_batch = args.tasks_per_batch
    num_lite = args.num_lite_samples
    batch_size = args.batch_size
    train = _learns_batch_stats(recogniser, args)

    def train_task_lite(episode: Episode, generator: Optional[torch.Generator] = None,
                        grad_idxs: Optional[Sequence[torch.Tensor]] = None):
        ctx, ctx_mask = episode["context_clips"], episode["context_mask"]
        labels, class_mask = episode["context_labels"], episode["class_mask"]
        tgt = episode["target_clips"]
        m = _rows_to_run(episode["target_mask"])
        nb = math.ceil(m / batch_size)  # the batches with real rows
        runs = lite_runs(m, tgt.shape[0], batch_size, train)
        if grad_idxs is not None and len(grad_idxs) != runs:
            raise ValueError(f"{len(grad_idxs)} injected subsets for {runs} target batches")
        trainable = _trainable(recogniser)
        caches = recogniser.lite_caches(ctx, ctx_mask, train)  # per task, no graph
        scaling = ctx_mask.float().sum() / (num_lite * tasks_per_batch)

        loss_total = torch.zeros((), device=ctx.device)
        logits_parts = []
        for i in range(runs):
            idx = (grad_idxs[i] if grad_idxs is not None
                   else lite_grad_subset(generator, ctx_mask, num_lite))
            personalise = functools.partial(recogniser.personalise_with_lite, ctx, labels,
                                            ctx_mask, class_mask.shape[0], idx, caches,
                                            train=train)
            if i >= nb:  # padding only: the subset's statistics, no loss
                with torch.no_grad():
                    personalise()
                continue
            rows = slice(i * batch_size, min((i + 1) * batch_size, m))
            tgt_mask = episode["target_mask"][rows]
            real = _is_real(tgt_mask)
            with torch.set_grad_enabled(trainable):
                state = personalise()
                logits = recogniser.predict(state, tgt[rows], class_mask, with_grad=True,
                                            train=train, clip_mask=tgt_mask)
                loss = float(real) * (scaling * cross_entropy(
                    logits, episode["target_labels"][rows], tgt_mask)
                    + FILM_REG_WEIGHT * state["film_l2"])
            if real and loss.requires_grad:
                loss.backward()
            loss_total += loss.detach()
            logits_parts.append(logits.detach())
        if not logits_parts:  # all padding: zero loss, no gradient
            return loss_total, torch.zeros((0, class_mask.shape[0]), device=ctx.device)
        return loss_total, torch.cat(logits_parts)

    return train_task_lite


def build_apply_update(optimizer: torch.optim.Optimizer) -> Callable[[], None]:
    """One optimiser update from the accumulated ``.grad``, then clear it.
    A trainable parameter that received no gradient gets zeros first, as
    the JAX step returns them (so Adam's weight decay and step count
    match); a frozen one (``requires_grad`` off) keeps no gradient, so the
    optimiser skips it and it keeps its bits."""

    def apply_update():
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    return apply_update


def build_eval_fns(recogniser: SingleStepFewShotRecogniser) -> Tuple[Callable, Callable]:
    """(personalise, predict) for the CLU-VE protocol: eval mode, no
    gradients."""

    @torch.inference_mode()
    def personalise(context_clips, context_labels, context_mask, class_mask):
        return recogniser.personalise(context_clips, context_labels,
                                      context_mask, class_mask.shape[0])

    @torch.inference_mode()
    def predict(task_state, clips, class_mask):
        return recogniser.predict(task_state, clips, class_mask=class_mask)

    return personalise, predict
