"""Single-step few-shot recogniser (counterpart of
``orbit_tpu/models/recognisers.py`` ``SingleStepFewShotRecogniser``;
reference: model/few_shot_recognisers.py:271-473).

    recogniser = SingleStepFewShotRecogniser(...).to(device); recogniser.init(seed)
    task_state = recogniser.personalise(context_clips, labels, mask, num_classes)
    logits     = recogniser.predict(task_state, clips, class_mask)

Episodes arrive padded with validity masks (``orbit_tpu_torch.data.episodes``)
as uint8 pixels; each feature-extraction chunk is normalised on the device
and cast to the compute dtype there, so only the live chunk is ever
expanded. Chunks are a Python loop at ``batch_size`` frames; the tail chunk
runs at its real size (the ViT is per-row, so this equals the JAX package's
padded ``lax.map``). Features come out f32.

Meta-training (``learners/steps.py``) embeds with ``with_grad=True``: above
``batch_size`` frames each chunk runs under ``torch.utils.checkpoint``,
where the JAX package rematerialises its chunks with ``jax.checkpoint``
(orbit_tpu/models/recognisers.py:200-205), so activation memory stays one
chunk's. The ViTs have no BatchNorm, so train mode changes no forward.

Not ported yet: FiLM adaptation (``adapt_features``) and the
``linear``/``versa``/``mahalanobis`` heads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from orbit_tpu_torch.data.index import NORMALIZE_STATS
from orbit_tpu_torch.models import heads as heads_lib
from orbit_tpu_torch.models.backbones import create_feature_extractor
from orbit_tpu_torch.models.poolers import mean_pool_clips
from orbit_tpu_torch.models.precision import configure_matmul_precision

TaskState = Dict[str, Any]


class SingleStepFewShotRecogniser(nn.Module):
    """ProtoNets-style: personalise in one forward pass over the context."""

    def __init__(self, feature_extractor_name: str = "vit_b_32",
                 adapt_features: bool = False, classifier: str = "proto",
                 clip_length: int = 1, batch_size: int = 256,
                 logit_scale: float = 1.0, dtype=torch.float32,
                 frame_norm_method: str = "imagenet", frame_size: int = 224):
        super().__init__()
        if adapt_features:
            raise NotImplementedError("adapt_features (FiLM): not ported yet")
        if classifier not in heads_lib.CONFIGURE:
            raise NotImplementedError(f"classifier {classifier!r}: not ported yet "
                                      f"(ported: {tuple(heads_lib.CONFIGURE)})")
        configure_matmul_precision()
        self.classifier = classifier
        self.clip_length = clip_length
        self.batch_size = batch_size
        self.logit_scale = logit_scale
        self.dtype = dtype
        self.extractor, self.output_size = create_feature_extractor(
            feature_extractor_name, frame_size=frame_size, dtype=dtype)
        stats = NORMALIZE_STATS[frame_norm_method]
        self.register_buffer("pixel_mean", torch.tensor(stats["mean"]), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(stats["std"]), persistent=False)
        super().train(False)

    def init(self, seed: int) -> "SingleStepFewShotRecogniser":
        """Draw the extractor's parameters from a generator seeded with
        ``seed`` (on the CPU, so one seed gives the same weights on every
        device), then move them to the module's device."""
        device = self.pixel_mean.device
        g = torch.Generator().manual_seed(seed)
        self.extractor.to("cpu").reset_parameters(g)
        self.extractor.to(device)
        return self

    # -------------------------------------------------- feature extraction ----
    def _maybe_normalize(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 pixels -> ((x/255 - mean)/std) in the compute dtype, on the
        frames' device; float frames (already normalised) pass through."""
        if frames.dtype != torch.uint8:
            return frames
        x = frames.float() / 255.0
        return ((x - self.pixel_mean) / self.pixel_std).to(self.dtype)

    def _embed_chunk(self, frames: torch.Tensor) -> torch.Tensor:
        return self.extractor(self._maybe_normalize(frames))

    def embed_frames(self, frames: torch.Tensor, with_grad: bool = False) -> torch.Tensor:
        """(N, H, W, 3) -> (N, D) f32 features, ``batch_size`` frames at a
        time. ``with_grad=False`` records no graph; with gradients and more
        than one chunk, each chunk is recomputed in the backward
        (``torch.utils.checkpoint``)."""
        n, b = frames.shape[0], self.batch_size
        chunks = [frames[i:i + b] for i in range(0, n, b)]
        with torch.set_grad_enabled(with_grad and torch.is_grad_enabled()):
            if torch.is_grad_enabled() and len(chunks) > 1:
                feats = [checkpoint(self._embed_chunk, c, use_reentrant=False)
                         for c in chunks]
            else:
                feats = [self._embed_chunk(c) for c in chunks]
            return torch.cat(feats).float()

    def embed_clips(self, clips: torch.Tensor, with_grad: bool = False) -> torch.Tensor:
        """(N, T, H, W, 3) -> (N, D): frame features mean-pooled per clip."""
        n, t = clips.shape[:2]
        feats = self.embed_frames(clips.reshape(n * t, *clips.shape[2:]), with_grad)
        return mean_pool_clips(feats, t)

    # ----------------------------------------------------------- heads ----
    def configure_head(self, context_features, context_labels, sample_mask,
                       num_classes: int) -> Dict[str, torch.Tensor]:
        return heads_lib.CONFIGURE[self.classifier](
            context_features, context_labels, sample_mask, num_classes)

    def head_logits(self, head, features,
                    class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return heads_lib.PREDICT[self.classifier](
            head, features, logit_scale=self.logit_scale, class_mask=class_mask)

    # ----------------------------------------------------- personalise ----
    def personalise(self, context_clips, context_labels, context_mask,
                    num_classes: int, with_grad: bool = False) -> TaskState:
        feats = self.embed_clips(context_clips, with_grad)
        return {"head": self.configure_head(feats, context_labels, context_mask,
                                            num_classes)}

    def predict(self, task_state: TaskState, clips,
                class_mask: Optional[torch.Tensor] = None,
                with_grad: bool = False) -> torch.Tensor:
        feats = self.embed_clips(clips, with_grad)
        return self.head_logits(task_state["head"], feats, class_mask)
