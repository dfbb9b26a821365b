"""Eval step functions (counterpart of ``orbit_tpu/learners/steps.py``
``build_eval_fns``; reference: the personalise/predict calls in
single-step-learner.py:245-375).

PyTorch runs eagerly, so there is nothing to compile: the functions only
fix the call signature and run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser


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
