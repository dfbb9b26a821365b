"""Few-shot recognisers (counterpart of ``orbit_tpu/models/recognisers.py``):
``SingleStepFewShotRecogniser`` (reference: model/few_shot_recognisers.py:
271-473) and the FineTuner's ``MultiStepFewShotRecogniser`` (:185-269), on
one base that holds the extractor, the chunked feature extraction, the set
encoder and the FiLM generator.

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
chunk's.

Train mode (``train=True``: meta-training with ``--learn_extractor``)
runs an EfficientNet's BatchNorms on batch statistics (orbit_tpu
recognisers.py:133-232): each chunk's statistics cover that chunk's real
rows only (the clip mask, expanded to frames; the port's ragged tail chunk
then equals the JAX package's zero-padded one), and the running statistics
pass from one chunk to the next in order. As the JAX package's
``run_stateful(stats, chunk, mask)``, the chunk function takes its incoming
running statistics as an argument and returns the new ones, detached; the
loop loads them into the buffers after the chunk's forward, never inside
the region that ``torch.utils.checkpoint`` recomputes, so a recompute
neither updates the statistics twice nor sees later ones than its forward
saw. The depthwise tails are composed in train mode (``efficientnet.py``),
so #8 runs only in the eval forwards. The ViTs have no BatchNorm, so train
mode changes no ViT forward.

FiLM (``adapt_features``, CNAPs and SimpleCNAPs; reference:
few_shot_recognisers.py:313-326,361-386,439-451): ``personalise`` first
embeds every context frame with the DeepSets set encoder (chunked at
``batch_size``, f32), takes the masked mean over the real context frames,
generates the FiLM values from it, and hands them to every extractor call
of the task as per-call overrides; the task state is ``{"film", "head",
"film_l2"}``, the last the generator's L2 term that meta-training weights
into the loss. FiLM runs on the EfficientNets with eval BatchNorm, in the
protocol and in meta-training, where the gradient reaches the set encoder
and the generator through the FiLM values (the extractor itself is frozen
by the learner). ``personalise_with_lite`` is LITE's personalise
(few_shot_recognisers.py:328-343,388-437): the set encoder's reps and the
context features come from per-task no-grad caches
(:meth:`lite_caches`), and only a subset of context clips is recomputed
with gradients and scattered in. FiLM runs on the ViTs too (their
norm1/norm2/final LayerNorms), and the ViTs' overrides reach kernel B and
its backward #6.

The FineTuner (:class:`MultiStepFewShotRecogniser`, orbit_tpu
recognisers.py:390-414) personalises by gradient steps, which
``orbit_tpu_torch.learners.multi_step`` runs: this class supplies the
per-task trainables (a zero linear head, and with ``adapt_features`` an f32
copy of the FiLM leaves' current values, trained directly) and the logits
under them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from orbit_tpu_torch.data.index import NORMALIZE_STATS
from orbit_tpu_torch.models import heads as heads_lib
from orbit_tpu_torch.models.backbones import create_feature_extractor
from orbit_tpu_torch.models.backbones.efficientnet import EfficientNet
from orbit_tpu_torch.models.backbones.masked_bn import load_running_stats, running_stats
from orbit_tpu_torch.models.film import (FilmParameterGenerator, film_values_from_initial,
                                         get_initial_film_values)
from orbit_tpu_torch.models.poolers import mean_pool_clips
from orbit_tpu_torch.models.precision import configure_matmul_precision
from orbit_tpu_torch.models.set_encoder import SetEncoder

TaskState = Dict[str, Any]


class FewShotRecogniser(nn.Module):
    """The extractor, feature extraction, set encoding and FiLM generation
    that both recognisers share; ``HEADS`` names the classifiers a subclass
    takes."""

    HEADS: tuple = ()

    def __init__(self, feature_extractor_name: str = "vit_b_32",
                 adapt_features: bool = False, classifier: str = "proto",
                 clip_length: int = 1, batch_size: int = 256,
                 logit_scale: float = 1.0, dtype=torch.float32,
                 frame_norm_method: str = "imagenet", frame_size: int = 224):
        super().__init__()
        if classifier not in self.HEADS:
            raise NotImplementedError(f"classifier {classifier!r} on "
                                      f"{type(self).__name__} (takes: {self.HEADS})")
        configure_matmul_precision()
        self.feature_extractor_name = feature_extractor_name
        self.adapt_features = adapt_features
        self.classifier = classifier
        self.clip_length = clip_length
        self.batch_size = batch_size
        self.logit_scale = logit_scale
        self.dtype = dtype
        self.extractor, self.output_size, film_spec = create_feature_extractor(
            feature_extractor_name, frame_size=frame_size, dtype=dtype)
        self.film_spec = tuple(film_spec) if adapt_features else ()
        if adapt_features:
            self.set_encoder = SetEncoder()
            self.film_generator = FilmParameterGenerator(self.film_spec)
        if classifier == "versa":
            self.versa = heads_lib.VersaProcessors(self.output_size)
        stats = NORMALIZE_STATS[frame_norm_method]
        self.register_buffer("pixel_mean", torch.tensor(stats["mean"]), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(stats["std"]), persistent=False)
        super().train(False)

    @property
    def impl(self) -> Optional[str]:
        """The route of every op of the model, the extractor's and the
        head's: None (each op's kernel on a CUDA tensor, its plain version
        on a CPU tensor), "reference" (the plain versions on any device) or
        "autograd" (the plain versions as ordinary autograd ops: the MACs
        counter's route)."""
        return self.extractor.impl

    @impl.setter
    def impl(self, value: Optional[str]) -> None:
        self.extractor.impl = value

    def init(self, seed: int) -> "FewShotRecogniser":
        """Draw the parameters (extractor, and set encoder, FiLM generator
        and Versa processors where the model has them) from a generator
        seeded with ``seed`` (on the CPU, so one seed gives the same weights
        on every device), then move them to the module's device."""
        device = self.pixel_mean.device
        g = torch.Generator().manual_seed(seed)
        self.to("cpu")
        self.extractor.reset_parameters(g)
        for name in ("set_encoder", "film_generator", "versa"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(g)
        self.to(device)
        return self

    # -------------------------------------------------- feature extraction ----
    def _maybe_normalize(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 pixels -> ((x/255 - mean)/std) in the compute dtype, on the
        frames' device; float frames (already normalised) pass through."""
        if frames.dtype != torch.uint8:
            return frames
        x = frames.float() / 255.0
        return ((x - self.pixel_mean) / self.pixel_std).to(self.dtype)

    @property
    def has_batch_norm(self) -> bool:
        """Whether train mode changes the extractor's forward (the
        EfficientNets' BatchNorms; the ViTs have none)."""
        return isinstance(self.extractor, EfficientNet)

    def _embed_chunk(self, frames: torch.Tensor, film=None, mask=None, stats=None):
        """One chunk's features; with ``stats`` (train mode), (features,
        updated running statistics) over the chunk's rows that ``mask``
        marks real, starting from ``stats``."""
        x = self._maybe_normalize(frames)
        if stats is not None:
            return self.extractor(x, film, train=True, mask=mask, stats=stats)
        return self.extractor(x) if film is None else self.extractor(x, film)

    def embed_frames(self, frames: torch.Tensor, with_grad: bool = False,
                     film=None, train: bool = False,
                     frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) -> (N, D) f32 features, ``batch_size`` frames at a
        time, under the FiLM values ``film`` if given. ``with_grad=False``
        records no graph; with gradients and more than one chunk, each chunk
        is recomputed in the backward (``torch.utils.checkpoint``).
        ``train`` runs the BatchNorms on the statistics of each chunk's
        frames that ``frame_mask`` marks real (all frames without one) and
        updates the running statistics chunk by chunk."""
        n, b = frames.shape[0], self.batch_size
        train = train and self.has_batch_norm
        stats = running_stats(self.extractor) if train else None
        feats = []
        with torch.set_grad_enabled(with_grad and torch.is_grad_enabled()):
            recompute = torch.is_grad_enabled() and n > b
            for i in range(0, n, b):
                args = (frames[i:i + b], film)
                if train:
                    args += (None if frame_mask is None else frame_mask[i:i + b], stats)
                out = (checkpoint(self._embed_chunk, *args, use_reentrant=False)
                       if recompute else self._embed_chunk(*args))
                if train:  # the next chunk starts from this one's statistics
                    out, stats = out
                feats.append(out)
            if train:
                load_running_stats(self.extractor, stats)
            return torch.cat(feats).float()

    def embed_clips(self, clips: torch.Tensor, with_grad: bool = False,
                    film=None, train: bool = False,
                    clip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, T, H, W, 3) -> (N, D): frame features mean-pooled per clip;
        in train mode ``clip_mask`` marks the real clips for the BatchNorm
        statistics."""
        n, t = clips.shape[:2]
        frame_mask = None if clip_mask is None or not train else clip_mask.repeat_interleave(t)
        feats = self.embed_frames(clips.reshape(n * t, *clips.shape[2:]), with_grad, film,
                                  train, frame_mask)
        return mean_pool_clips(feats, t)

    def embed_lanes(self, clips: torch.Tensor, film=None) -> torch.Tensor:
        """(L, N, T, H, W, 3) clips of L tasks -> (L, N, D), no graph, with
        the lane axis folded into the extractor's batch: chunk i of every
        lane's frames (``batch_size`` frames a lane) goes through one
        extractor call of L x ``batch_size`` frames, as the JAX package's
        vmap over tasks batches the serial chunk loop. Each row's features
        are those of :meth:`embed_clips` on its lane (the extractor is
        per-row in eval mode)."""
        lanes, n, t = clips.shape[:3]
        frames = clips.reshape(lanes, n * t, *clips.shape[3:])
        b, feats = self.batch_size, []
        with torch.set_grad_enabled(False):
            for i in range(0, n * t, b):
                chunk = frames[:, i:i + b]
                out = self._embed_chunk(chunk.reshape(-1, *chunk.shape[2:]), film)
                feats.append(out.reshape(lanes, chunk.shape[1], -1))
            feats = torch.cat(feats, dim=1).float()
        return mean_pool_clips(feats.reshape(lanes * n * t, -1), t).reshape(lanes, n, -1)

    # ------------------------------------------------------ set encoding ----
    def encode_set_clips(self, clips: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, 3) -> (N, T, 64) f32 reps of the DeepSets set
        encoder, one per frame, ``batch_size`` frames at a time; (L, N, T,
        H, W, 3) clips of L tasks -> (L, N, T, 64), L x ``batch_size`` frames
        at a time (the encoder is per-frame)."""
        lead = clips.shape[:-3]  # (N, T) or (L, N, T)
        frames = clips.reshape(-1, *clips.shape[-3:])
        b = self.batch_size * (lead[0] if len(lead) == 3 else 1)
        return torch.cat([self.set_encoder(self._maybe_normalize(frames[i:i + b]))
                          for i in range(0, frames.shape[0], b)]).reshape(*lead, -1)

    @staticmethod
    def masked_set_mean(reps: torch.Tensor, clip_mask: torch.Tensor) -> torch.Tensor:
        """Mean of (N, T, 64) per-frame reps over the real clips' frames; a
        leading lane axis on both gives (L, 64)."""
        frame_mask = clip_mask.float()[..., None, None].expand(*reps.shape[:-1], 1)
        total = torch.clamp(frame_mask.sum(dim=(-3, -2, -1)), min=1.0)
        return (reps * frame_mask).sum(dim=(-3, -2)) / total[..., None]

    def task_embedding(self, context_clips: torch.Tensor,
                       clip_mask: torch.Tensor) -> torch.Tensor:
        """Masked mean of the set encoder's 64-d reps over the real context
        frames (reference: _get_task_embedding_in_batches,
        few_shot_recognisers.py:361-386)."""
        return self.masked_set_mean(self.encode_set_clips(context_clips), clip_mask)

    def generate_film(self, task_embedding: torch.Tensor, lanes: bool = False):
        """Task embedding -> (FiLM values by dotted leaf name, L2 term of
        the regularisers) (reference: _generate_film_params,
        few_shot_recognisers.py:439-451); ``lanes``: (L, 64) embeddings of L
        tasks -> (L, size) values a leaf."""
        generated, l2 = self.film_generator(task_embedding, lanes)
        initial = get_initial_film_values(self.extractor, self.film_spec)
        return film_values_from_initial(initial, generated), l2


class SingleStepFewShotRecogniser(FewShotRecogniser):
    """ProtoNets-style: personalise in one forward pass over the context."""

    HEADS = tuple(heads_lib.CONFIGURE)

    # ----------------------------------------------------------- heads ----
    def configure_head(self, context_features, context_labels, sample_mask,
                       num_classes: int) -> Dict[str, torch.Tensor]:
        return heads_lib.CONFIGURE[self.classifier](
            context_features, context_labels, sample_mask, num_classes,
            getattr(self, "versa", None))

    def head_logits(self, head, features,
                    class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        kwargs = {"impl": self.impl} if self.classifier == "mahalanobis" else {}
        return heads_lib.PREDICT[self.classifier](
            head, features, logit_scale=self.logit_scale, class_mask=class_mask, **kwargs)

    # ----------------------------------------------------- personalise ----
    def personalise(self, context_clips, context_labels, context_mask,
                    num_classes: int, with_grad: bool = False,
                    train: bool = False) -> TaskState:
        """Task embedding -> FiLM (when ``adapt_features``) -> context
        features -> head (reference: personalise,
        few_shot_recognisers.py:313-326). ``with_grad`` records the
        extractor's graph; the set encoder and the generator record one
        whenever autograd does. ``train``: the extractor's BatchNorms on the
        real context clips' batch statistics, updating the running ones."""
        film, film_l2 = None, torch.zeros((), device=context_clips.device)
        if self.adapt_features:
            film, film_l2 = self.generate_film(self.task_embedding(context_clips,
                                                                   context_mask))
        feats = self.embed_clips(context_clips, with_grad, film, train, context_mask)
        return {"film": film, "film_l2": film_l2,
                "head": self.configure_head(feats, context_labels, context_mask,
                                            num_classes)}

    def lite_caches(self, context_clips, context_mask,
                    train: bool = False) -> Dict[str, torch.Tensor]:
        """LITE's per-task caches, computed without a graph (reference:
        few_shot_recognisers.py:404-437): with FiLM, ``reps`` (N, T, 64),
        the set encoder's reps of every context frame; and ``feats`` (N, D),
        every context clip's features under the FiLM values of the cached
        task embedding. ``train``: the cache pass runs the BatchNorms on
        batch statistics and updates the running ones (orbit_tpu
        learners/steps.py:276-285)."""
        caches, film = {}, None
        with torch.no_grad():
            if self.adapt_features:
                caches["reps"] = self.encode_set_clips(context_clips)
                film, _ = self.generate_film(self.masked_set_mean(caches["reps"],
                                                                  context_mask))
            caches["feats"] = self.embed_clips(context_clips, film=film, train=train,
                                               clip_mask=context_mask)
        return caches

    def personalise_with_lite(self, context_clips, context_labels, context_mask,
                              num_classes: int, grad_idxs: torch.Tensor,
                              caches: Optional[Dict[str, torch.Tensor]] = None,
                              train: bool = False) -> TaskState:
        """LITE personalise (reference: personalise_with_lite,
        few_shot_recognisers.py:328-343,388-437): the context clips at
        ``grad_idxs`` are recomputed with gradients and scattered into the
        no-grad ``caches`` (:meth:`lite_caches`, computed here if not
        given): with FiLM first their set-encoder reps, whose masked mean
        generates the FiLM values, then their features under those values;
        the head is configured on the mixed features. The meta-training
        step computes the caches once per task and calls this once per
        target batch (orbit_tpu/learners/steps.py:191-225). ``train``: the
        subset's forward (and the caches', if computed here) runs the
        BatchNorms on the batch statistics of the subset's real clips and
        updates the running ones (orbit_tpu steps.py:226-240)."""
        if caches is None:
            caches = self.lite_caches(context_clips, context_mask, train)
        idx = grad_idxs.to(device=context_clips.device, dtype=torch.long)
        subset = context_clips[idx]
        film, film_l2 = None, torch.zeros((), device=context_clips.device)
        if self.adapt_features:
            reps = caches["reps"].index_copy(0, idx, self.encode_set_clips(subset))
            film, film_l2 = self.generate_film(self.masked_set_mean(reps, context_mask))
        grad_feats = self.embed_clips(subset, with_grad=True, film=film, train=train,
                                      clip_mask=context_mask[idx])
        feats = caches["feats"].index_copy(0, idx, grad_feats)
        return {"film": film, "film_l2": film_l2,
                "head": self.configure_head(feats, context_labels, context_mask,
                                            num_classes)}

    def predict(self, task_state: TaskState, clips,
                class_mask: Optional[torch.Tensor] = None,
                with_grad: bool = False, train: bool = False,
                clip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of ``clips`` under the task state; ``train``: the
        BatchNorms on the batch statistics of the clips ``clip_mask`` marks
        real, updating the running ones."""
        feats = self.embed_clips(clips, with_grad, task_state["film"], train, clip_mask)
        return self.head_logits(task_state["head"], feats, class_mask)


class MultiStepFewShotRecogniser(FewShotRecogniser):
    """FineTuner: personalise by gradient steps on the context set
    (reference: few_shot_recognisers.py:185-269); the inner loop is
    ``orbit_tpu_torch.learners.multi_step``'s."""

    HEADS = ("linear",)

    def init_task_params(self, num_classes: int) -> Dict[str, Any]:
        """Fresh per-task trainables: a zero linear head, plus with
        ``adapt_features`` the FiLM leaves' current values as f32 leaf
        tensors (reference: init_classifier :263-269, unfreeze_film
        :195-198). The JAX package trains those leaves in their storage
        dtype (bf16 under ``--compute_dtype bfloat16``); here they are f32
        masters that the extractor rounds to the parameter's dtype at each
        use."""
        device = self.pixel_mean.device
        task_params = {"head": heads_lib.init_linear_head(num_classes, self.output_size,
                                                           device=device)}
        if self.adapt_features:
            task_params["film"] = {
                name: value.detach().float().clone() for name, value in
                get_initial_film_values(self.extractor, self.film_spec).items()}
        for leaf in self.task_leaves(task_params):
            leaf.requires_grad_(True)
        return task_params

    @staticmethod
    def task_leaves(task_params: Dict[str, Any]):
        """The head's tensors, then the FiLM leaves' in sorted-name order."""
        film = task_params.get("film") or {}
        return [task_params["head"]["weight"], task_params["head"]["bias"],
                *(film[name] for name in sorted(film))]

    def task_logits(self, task_params: Dict[str, Any], clips,
                    class_mask: Optional[torch.Tensor] = None,
                    with_grad: bool = False) -> torch.Tensor:
        feats = self.embed_clips(clips, with_grad, task_params.get("film"))
        return heads_lib.predict_linear(task_params["head"], feats,
                                        logit_scale=self.logit_scale,
                                        class_mask=class_mask)
