"""Task-level eval parallelism: the CLU-VE outer loop in groups of tasks
(counterpart of ``orbit_tpu/parallel/task_dp.py``).

The protocol's outer loop (17 users x 50 tasks, each personalise+predict
independent; reference: single-step-learner.py:314-357) is the
embarrassingly parallel axis. ``--task_parallel N`` runs N whole tasks as
one group: each lane personalises on its own context set and predicts its
own stacked query block (:func:`build_query_block`).

- On one device (:class:`TaskBatchedEval`, :class:`TaskBatchedFineTune`)
  the lanes are a leading axis of one batched call. The JAX package vmaps
  the per-task program; the port's kernels are ``ctypes`` launches inside
  ``torch.autograd.Function``s with no vmap rule, so instead the lane axis
  is folded into the extractor's batch (chunk i of every lane in one call,
  ``FewShotRecogniser.embed_lanes``), and everything after the extractor
  (class means, the proto, cosine, Versa and Mahalanobis heads, the set
  encoder, the FiLM generator, the FineTuner's head steps) takes the lane
  axis. #7 runs once a lane. Where the extractor is conditioned per task
  (FiLM), the lanes' extractor forwards run one after another in the
  group: kernel B and #8 take one affine per channel for the whole batch.
- Across ranks (:class:`TaskParallelEval`, :class:`TaskParallelFineTune`)
  the lanes of a group are split over the ranks (lane i on rank i mod the
  world size), each running the serial per-task program; no collective
  runs inside a lane, and the logits are gathered to every rank.

Group assembly: consecutive tasks whose padded episodes share their shapes
(context bucket, query block, class bucket) form a group; a partial group
is filled with duplicate lanes whose outputs the caller discards; the
query blocks are cut to the group's largest real video count
(:func:`trim_videos`). The batched calls are timed once and divided over
the group's real tasks and real frames (the learners'
``_run_eval_protocol_taskdp`` and ``_test_taskdp``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from orbit_tpu_torch.data.episodes import Episode, bucket_size, pad_rows
from orbit_tpu_torch.data.transforms import attach_frame_history
from orbit_tpu_torch.models import heads as heads_lib
from orbit_tpu_torch.parallel.episode_dp import Mesh, make_mesh
from orbit_tpu_torch.utils.optim import cross_entropy

# video-COUNT buckets: the number of target videos per task varies with way
# and per-object clutter-video counts; bucketing it keeps the stacked query
# block's shape (V_b * F_b) in a small grid
VIDEO_COUNT_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256)


@dataclass
class QueryBlock:
    """One task's target videos stacked into a single padded query tensor."""

    clips: np.ndarray        # (V_b * F_b, T, H, W, 3)
    frame_bucket: int        # F_b
    video_bucket: int        # V_b
    n_videos: int            # real videos
    n_frames: List[int]      # real frames per video (len n_videos)


def build_query_block(ep: Episode, clip_length: int,
                      count_buckets: Sequence[int] = VIDEO_COUNT_BUCKETS) -> QueryBlock:
    """Stack a test episode's per-video frame stacks into one fixed-shape
    query tensor: per-video frame history (data/transforms.py), videos
    re-padded to the task's largest frame bucket, video axis padded to a
    count bucket."""
    f_b = max(f.shape[0] for f in ep.video_frames)
    v_b = bucket_size(len(ep.video_frames), count_buckets)
    clips = [attach_frame_history(pad_rows(frames, f_b), clip_length)
             for frames in ep.video_frames]
    block = pad_rows(np.stack(clips), v_b)       # (V_b, F_b, T, H, W, 3)
    return QueryBlock(
        clips=block.reshape(v_b * f_b, *block.shape[2:]),
        frame_bucket=f_b, video_bucket=v_b,
        n_videos=len(ep.video_frames),
        n_frames=[int(m.sum()) for m in ep.video_masks])


def stack_eval_group(episodes: Sequence[Episode], blocks: Sequence[QueryBlock],
                     dp: int) -> Dict[str, np.ndarray]:
    """Stack a group of same-shape test episodes (and their query blocks)
    on a leading lane axis, duplicating the first lane to fill a partial
    group (duplicate lanes' outputs are discarded by the caller)."""
    idx = [min(i, len(episodes) - 1) for i in range(dp)]
    return {
        "context_clips": np.stack([episodes[i].context_clips for i in idx]),
        "context_labels": np.stack([episodes[i].context_labels for i in idx]),
        "context_mask": np.stack([episodes[i].context_mask for i in idx]),
        "class_mask": np.stack([episodes[i].class_mask for i in idx]),
        "query_clips": np.stack([blocks[i].clips for i in idx]),
    }


def trim_videos(batch: Dict[str, np.ndarray], blocks: Sequence[QueryBlock]) -> int:
    """Cut the group's stacked query blocks (``batch["query_clips"]``, in
    place) to the largest real video count of its lanes, and return it: the
    video-count bucket's padding videos hold no frame that a caller reads,
    and the port runs eagerly, so they are not embedded (the JAX package's
    vmap needs the bucket's fixed shape). Each lane's logits then reshape
    to (that count, F_b, C)."""
    videos = max(qb.n_videos for qb in blocks)
    batch["query_clips"] = batch["query_clips"][:, :videos * blocks[0].frame_bucket]
    return videos


def _lane(tree: dict, i: int) -> dict:
    """Lane ``i`` of a dict of lane-stacked tensors."""
    return {k: v[i] for k, v in tree.items()}


# ------------------------------------------------------------ one device ----
class TaskBatchedEval:
    """The single-step protocol's group on one device: ``dp`` lanes, the
    extractor's batch holding chunk i of every lane (no FiLM) or the lanes'
    forwards one after another (FiLM), the heads batched over lanes.

    ``personalise(batch)`` takes the device tensors of
    :func:`stack_eval_group` (``context_clips`` (dp, N, T, H, W, 3),
    ``context_labels``, ``context_mask`` (dp, N), ``class_mask`` (dp, C))
    and returns the lanes' states ``{"film": one FiLM dict a lane or None,
    "head": lane-stacked head}``; ``predict(states, query_clips,
    class_mask)`` the (dp, V_b·F_b, C) logits."""

    def __init__(self, recogniser, dp: int):
        self.recogniser, self.dp = recogniser, dp

    def local(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The lanes this process runs: all of them."""
        return batch

    def _embed(self, clips, films) -> torch.Tensor:
        rec = self.recogniser
        if films is None:
            return rec.embed_lanes(clips)
        return torch.stack([rec.embed_clips(c, film=f) for c, f in zip(clips, films)])

    @torch.inference_mode()
    def personalise(self, batch: Dict[str, torch.Tensor]):
        rec = self.recogniser
        clips, mask = batch["context_clips"], batch["context_mask"]
        films = None
        if rec.adapt_features:
            embedding = rec.masked_set_mean(rec.encode_set_clips(clips), mask)
            values, _ = rec.generate_film(embedding, lanes=True)
            films = [_lane(values, i) for i in range(clips.shape[0])]
        feats = self._embed(clips, films)
        head = rec.configure_head(feats, batch["context_labels"], mask,
                                  batch["class_mask"].shape[-1])
        return {"film": films, "head": head}

    @torch.inference_mode()
    def predict(self, states, query_clips, class_mask) -> torch.Tensor:
        rec = self.recogniser
        feats = self._embed(query_clips, states["film"])
        if rec.classifier == "mahalanobis":  # #7 takes one task's classes a launch
            return torch.stack([rec.head_logits(_lane(states["head"], i), feats[i],
                                                class_mask[i])
                                for i in range(feats.shape[0])])
        return rec.head_logits(states["head"], feats, class_mask)


def build_finetune_lane_fns(recogniser, args):
    """(personalise, predict) of the FineTuner over a lane axis: the serial
    ``learners.multi_step.build_finetune_fns`` for ``dp`` tasks at once.
    Every task parameter is stacked over the lanes and the loss is the sum
    of the lanes' losses, so each lane's slice gets exactly its own
    gradient; the inner optimiser (Adam or SGD, with coupled weight decay,
    over f32 leaves, the FiLM leaves as f32 masters) is elementwise, so one
    optimiser over the stacked leaves takes each lane's own steps. A frozen
    extractor embeds the context once with the lanes folded; with FiLM each
    inner step runs the lanes' extractor forwards one after another, in
    batches of ``min(batch_size, N)`` clips as the serial step does."""
    from orbit_tpu_torch.learners.multi_step import inner_optimizer

    recogniser.requires_grad_(False)
    steps = args.personalize_num_grad_steps
    scale = recogniser.logit_scale

    def init_lanes(lanes: int, num_classes: int) -> dict:
        one = recogniser.init_task_params(num_classes)
        stacked = {"head": {k: v.detach()[None].repeat(lanes, *([1] * v.dim()))
                            for k, v in one["head"].items()}}
        if "film" in one:
            stacked["film"] = {k: v.detach()[None].repeat(lanes, *([1] * v.dim()))
                               for k, v in one["film"].items()}
        for leaf in recogniser.task_leaves(stacked):
            leaf.requires_grad_(True)
        return stacked

    @torch.enable_grad()
    def personalise(context_clips, context_labels, context_mask, class_mask):
        lanes, n = context_clips.shape[:2]
        task_params = init_lanes(lanes, class_mask.shape[-1])
        optimizer = inner_optimizer(args, task_params)
        total = torch.clamp(context_mask.float().sum(dim=-1), min=1.0)   # (L,)
        eff_b = min(args.batch_size, n)
        if not recogniser.adapt_features:
            feats = recogniser.embed_lanes(context_clips)                 # (L, N, D)
        for _ in range(steps):
            optimizer.zero_grad(set_to_none=True)
            if recogniser.adapt_features:
                for i in range(lanes):
                    for j in range(0, n, eff_b):
                        film = _lane(task_params["film"], i)
                        f = recogniser.embed_clips(context_clips[i, j:j + eff_b],
                                                   with_grad=True, film=film)
                        logits = heads_lib.predict_linear(_lane(task_params["head"], i), f,
                                                          logit_scale=scale,
                                                          class_mask=class_mask[i])
                        (cross_entropy(logits, context_labels[i, j:j + eff_b],
                                       context_mask[i, j:j + eff_b], reduction="sum")
                         / total[i]).backward()
            else:
                logits = heads_lib.predict_linear(task_params["head"], feats,
                                                  logit_scale=scale, class_mask=class_mask)
                (cross_entropy(logits, context_labels, context_mask, reduction="sum")
                 / total).sum().backward()
            optimizer.step()
        return task_params

    @torch.inference_mode()
    def predict(task_params, clips, class_mask):
        if recogniser.adapt_features:
            feats = torch.stack([recogniser.embed_clips(clips[i],
                                                        film=_lane(task_params["film"], i))
                                 for i in range(clips.shape[0])])
        else:
            feats = recogniser.embed_lanes(clips)
        return heads_lib.predict_linear(task_params["head"], feats, logit_scale=scale,
                                        class_mask=class_mask)

    return personalise, predict


class TaskBatchedFineTune(TaskBatchedEval):
    """The FineTuner protocol's group on one device: ``dp`` whole inner
    gradient loops as one batched loop (:func:`build_finetune_lane_fns`).
    ``personalise`` returns the lane-stacked task parameters."""

    def __init__(self, recogniser, args, dp: int):
        super().__init__(recogniser, dp)
        self._personalise, self._predict = build_finetune_lane_fns(recogniser, args)

    def personalise(self, batch: Dict[str, torch.Tensor]):
        return self._personalise(batch["context_clips"], batch["context_labels"],
                                 batch["context_mask"], batch["class_mask"])

    def predict(self, task_params, query_clips, class_mask) -> torch.Tensor:
        return self._predict(task_params, query_clips, class_mask)


# ---------------------------------------------------------- across ranks ----
class _LaneParallel:
    """A group's lanes split over the ranks: lane i runs on rank i mod the
    world size, through the serial per-task ``personalise_one(clips,
    labels, mask, class_mask)`` and ``predict_one(state, clips,
    class_mask)``; nothing crosses lanes. ``predict`` gathers every lane's
    logits to every rank."""

    def __init__(self, dp: int, mesh: Optional[Mesh], personalise_one, predict_one):
        self.mesh = mesh or make_mesh()
        self.dp = dp
        self.lanes = [i for i in range(dp) if i % self.mesh.size == self.mesh.rank]
        self._personalise_one, self._predict_one = personalise_one, predict_one

    def local(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's lanes of a :func:`stack_eval_group` batch (the only
        ones it copies to its device)."""
        return {k: v[self.lanes] for k, v in batch.items()}

    def personalise(self, batch: Dict[str, torch.Tensor]) -> list:
        return [self._personalise_one(batch["context_clips"][j], batch["context_labels"][j],
                                      batch["context_mask"][j], batch["class_mask"][j])
                for j in range(len(self.lanes))]

    def predict(self, states: list, query_clips, class_mask) -> torch.Tensor:
        """(dp, V_b·F_b, C) logits on every rank."""
        size = self.mesh.size
        per_rank = -(-self.dp // size)
        mine = query_clips.new_zeros((per_rank, query_clips.shape[1], class_mask.shape[-1]),
                                     dtype=torch.float32)
        for j, state in enumerate(states):
            mine[j] = self._predict_one(state, query_clips[j], class_mask[j]).float()
        gathered = self.mesh.all_gather(mine)
        return torch.stack([gathered[i % size][i // size] for i in range(self.dp)])


def _eval_task_fns(recogniser):
    """The serial per-task (personalise, predict) of the single-step protocol."""
    from orbit_tpu_torch.learners.steps import build_eval_fns

    return build_eval_fns(recogniser)


class TaskParallelEval(_LaneParallel):
    """Task lanes across ranks for the single-step protocol (reference loop:
    single-step-learner.py:314-357)."""

    def __init__(self, recogniser, dp: int, mesh: Optional[Mesh] = None):
        super().__init__(dp, mesh, *_eval_task_fns(recogniser))


class TaskParallelFineTune(_LaneParallel):
    """Task lanes across ranks for the FineTuner protocol: each lane runs
    one task's whole inner gradient loop (``build_finetune_fns``), then
    predicts its query block (reference: multi-step-learner.py:84-150)."""

    def __init__(self, recogniser, args, dp: int, mesh: Optional[Mesh] = None):
        from orbit_tpu_torch.learners.multi_step import build_finetune_fns

        super().__init__(dp, mesh, *build_finetune_fns(recogniser, args))
