"""Episode-data-parallel meta-training over ``torch.distributed`` ranks
(counterpart of ``orbit_tpu/parallel/episode_dp.py``).

The reference trains on one GPU, simulating a task batch by serial
gradient accumulation (single-step-learner.py:162-166). Here a group of
``dp`` consecutive tasks runs one task a rank (one process a GPU, launched
by ``torchrun``): each rank runs its lane's task step, which adds the
task's gradient (already scaled by ``1/tasks_per_batch``) into ``.grad``,
and at the end of an update window one ``all_reduce(SUM)`` over a flat
buffer of every trainable gradient stands in for the psum that the JAX
package's shard_map inserts; then every rank applies the same update.

- Dummy lanes fill a final group of fewer than ``dp`` tasks: copies of
  real tasks with ``target_mask`` zeroed, whose loss and gradient are
  exactly zero (``learners/steps.py``), so every task trains, as in the
  serial loop.
- BatchNorm running statistics (``--learn_extractor`` on an
  EfficientNet): every rank starts a group from the same statistics and
  its lane's step moves them; then they are averaged over the ranks,
  weighted by real lanes (a dummy lane's forward would push its donor's
  statistics in twice), as the JAX package does (:117-132).
- An update window that overshoots ``tasks_per_batch`` (whole groups when
  ``dp`` does not divide it) is renormalised to its mean; the final partial
  window is applied as it is (:225-236).
- LITE: every rank draws every lane's grad subsets from the same
  generator, in lane order, and passes its own lane's to its step, so the
  ranks stay in lockstep and the subsets are the serial loop's.
- Each rank pads and copies to its device only its own lane; the losses
  and logits are gathered, so every rank's train evaluator (rank 0's
  logs) sees every task. Every rank still reads and decodes the whole
  task stream (ROADMAP).

``make_mesh`` describes the ranks of the process group; one process with
no group is a mesh of size 1 whose collectives do nothing. A one-rank group
that is initialised runs its collectives.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from orbit_tpu_torch.data.episodes import Episode, bucket_size, pad_episode, pad_rows
from orbit_tpu_torch.learners import steps as steps_lib
from orbit_tpu_torch.models.backbones.masked_bn import load_running_stats, running_stats


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank: the group's, else ``RANK`` as ``torchrun`` sets
    it, else 0."""
    return dist.get_rank() if distributed() else int(os.environ.get("RANK", "0"))


def world_size() -> int:
    return dist.get_world_size() if distributed() else int(os.environ.get("WORLD_SIZE", "1"))


def local_device() -> Optional[torch.device]:
    """``cuda:LOCAL_RANK`` under ``torchrun``, else None."""
    if "LOCAL_RANK" in os.environ:
        return torch.device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return None


@dataclass
class Mesh:
    """The ranks of the process group, one device each: ``size`` ranks, this
    process's ``rank``. Without an initialised group (one process) every
    collective is the identity."""

    size: int
    rank: int

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if distributed():
            dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (all of one shape), in rank order."""
        if not distributed():
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return out

    def all_gather_object(self, obj) -> list:
        if not distributed():
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def all_reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum the gradients of ``params`` over the ranks through one flat
        buffer; a parameter without a gradient counts as zeros and gets
        the sum."""
        if not distributed():
            return
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()

    def local_rows(self, *ts: torch.Tensor):
        """Each tensor zero-padded along its first axis to a multiple of the
        mesh size, and this rank's contiguous slice of it."""
        out = []
        for t in ts:
            t = pad_rows_to_multiple(t, self.size)
            rows = t.shape[0] // self.size
            out.append(t[self.rank * rows:(self.rank + 1) * rows])
        return out


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if distributed():
        dist.barrier()


def init_process_group(device: Optional[torch.device] = None) -> None:
    """Join the group that ``torchrun`` describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): NCCL for a CUDA device (made
    current first), gloo on the CPU."""
    if distributed():
        return
    device = device if device is not None else local_device() or torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")


def make_mesh(n_devices: Optional[int] = None, device: Optional[torch.device] = None) -> Mesh:
    """The mesh of every rank, joining ``torchrun``'s group first when there
    is one; raises, as the JAX ``make_mesh`` does, when ``n_devices`` asks
    for more ranks than there are."""
    n_world = world_size()
    if n_world > 1:
        init_process_group(device)
    n = n_devices or n_world
    if n > n_world:
        raise ValueError(f"requested {n} devices, only {n_world} available")
    return Mesh(size=n_world, rank=process_rank())


def pad_rows_to_multiple(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the leading axis up to a multiple of ``n`` (the mesh size);
    padded rows carry zero masks or are sliced off by the caller."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def stack_group(episodes: Sequence[Episode]) -> Dict[str, np.ndarray]:
    """Re-pad a group of train episodes to their common largest buckets and
    stack them along a leading lane axis."""
    n_ctx = max(e.context_clips.shape[0] for e in episodes)
    n_tgt = max(e.target_clips.shape[0] for e in episodes)
    n_cls = max(e.class_mask.shape[0] for e in episodes)

    def stack(field, n):
        return np.stack([pad_rows(getattr(e, field), n) for e in episodes])

    return {
        "context_clips": stack("context_clips", n_ctx),
        "context_labels": stack("context_labels", n_ctx),
        "context_mask": stack("context_mask", n_ctx),
        # class buckets can differ under --with_cluster_labels (16/32/...);
        # padded classes stay mask-0 -> -inf logits, inert like padded rows
        "class_mask": stack("class_mask", n_cls),
        "target_clips": stack("target_clips", n_tgt),
        "target_labels": stack("target_labels", n_tgt),
        "target_mask": stack("target_mask", n_tgt),
    }


TRAIN_FIELDS = ("context_clips", "context_labels", "context_mask", "class_mask",
                "target_clips", "target_labels", "target_mask")


def episode_to_device(ep: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A train episode's arrays (``TRAIN_FIELDS``) as tensors on ``device``,
    labels int64."""
    out = {}
    for k in TRAIN_FIELDS:
        t = torch.from_numpy(np.ascontiguousarray(ep[k])).to(device)
        out[k] = t.long() if k.endswith("labels") else t
    return out


class EpisodeDataParallel:
    """One lane of a task group on each rank, gradients summed over the
    ranks, one optimiser update a window on every rank.

    ``optimizer``: the learner's, over the recogniser's parameters.
    ``to_device``: a padded :class:`Episode` -> the step's dict of device
    tensors (the learner's pinned copy); by default a plain copy to the
    recogniser's device."""

    def __init__(self, recogniser, args, optimizer: torch.optim.Optimizer,
                 mesh: Optional[Mesh] = None, to_device: Optional[Callable] = None):
        dp = getattr(args, "data_parallel", None)
        self.mesh = mesh or make_mesh(dp)
        if dp and dp != self.mesh.size:
            raise ValueError(f"--data_parallel {dp} needs {dp} ranks, the group has "
                             f"{self.mesh.size} (torchrun --nproc_per_node {dp})")
        self.dp, self.rank = self.mesh.size, self.mesh.rank
        self.recogniser, self.args, self.optimizer = recogniser, args, optimizer
        self.lite = bool(getattr(args, "with_lite", False))
        build = steps_lib.build_train_task_lite if self.lite else steps_lib.build_train_task
        self.task_fn = build(recogniser, args)
        self.apply_update = steps_lib.build_apply_update(optimizer)
        self.params = [p for group in optimizer.param_groups for p in group["params"]
                       if p.requires_grad]
        self.train_bn = steps_lib._learns_batch_stats(recogniser, args)
        device = recogniser.pixel_mean.device
        self.to_device = to_device or (lambda ep: episode_to_device(
            {k: getattr(ep, k) for k in TRAIN_FIELDS}, device))

    # ------------------------------------------------------ one group ----
    def lane_subsets(self, generator: torch.Generator, lanes: Sequence[dict]):
        """Every lane's LITE grad subsets, drawn in lane order from
        ``generator`` (one per target batch the lane's step runs, as the
        step itself would draw them); each lane gives its padded
        ``ctx_mask``, ``m`` (its target rows up to the last real one) and
        ``target_rows``. None without LITE."""
        if not self.lite:
            return None
        out = []
        for lane in lanes:
            ctx_mask = torch.from_numpy(lane["ctx_mask"])
            runs = steps_lib.lite_runs(lane["m"], lane["target_rows"], self.args.batch_size,
                                       self.train_bn)
            out.append([steps_lib.lite_grad_subset(generator, ctx_mask,
                                                   self.args.num_lite_samples)
                        for _ in range(runs)])
        return out

    def run_lane(self, episode: Dict[str, torch.Tensor], real: bool, subsets=None):
        """This rank's lane: its step adds its gradient into ``.grad``; with
        BatchNorm statistics, they are then averaged over the ranks' real
        lanes. Returns every lane's (loss, logits as numpy), gathered."""
        if self.lite:
            loss, logits = self.task_fn(episode, grad_idxs=subsets)
        else:
            loss, logits = self.task_fn(episode)
        if self.train_bn:
            self._average_stats(1.0 if real else 0.0)
        return self.mesh.all_gather_object((float(loss), logits.float().cpu().numpy()))

    @torch.no_grad()
    def _average_stats(self, weight: float) -> None:
        extractor = self.recogniser.extractor
        stats = running_stats(extractor)
        names = sorted(stats)
        flat = torch.cat([t.reshape(-1) * weight for n in names for t in stats[n]]
                         + [torch.full((1,), weight, device=stats[names[0]][0].device)])
        self.mesh.all_reduce(flat)
        flat = flat[:-1] / torch.clamp(flat[-1], min=1.0)
        offset, averaged = 0, {}
        for n in names:
            parts = []
            for t in stats[n]:
                parts.append(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            averaged[n] = tuple(parts)
        load_running_stats(extractor, averaged)

    def batch_grads(self, batch: Dict[str, np.ndarray], generator=None, subsets=None):
        """Rank-summed gradients (left in ``.grad``, cleared first) and every
        lane's (loss, logits) for a ``(dp, ...)`` stacked episode batch
        (:func:`stack_group`). ``subsets``: every lane's LITE subsets, else
        drawn from ``generator``."""
        self.optimizer.zero_grad(set_to_none=True)
        lanes = []
        for mask, target_mask in zip(batch["context_mask"], batch["target_mask"]):
            real = np.nonzero(target_mask > 0)[0]
            lanes.append({"ctx_mask": mask, "target_rows": target_mask.shape[0],
                          "m": int(real.max()) + 1 if real.size else 0})
        if self.lite and subsets is None:
            subsets = self.lane_subsets(generator, lanes)
        lane = {k: v[self.rank] for k, v in batch.items()}
        device = self.recogniser.pixel_mean.device
        out = self.run_lane(episode_to_device(lane, device), lanes[self.rank]["m"] > 0,
                            None if subsets is None else subsets[self.rank])
        self.mesh.all_reduce_grads(self.params)
        return out

    # ---------------------------------------------------------- epoch ----
    def train_epoch(self, tasks, generator: Optional[torch.Generator] = None,
                    evaluator=None) -> List[float]:
        """Stream an epoch's task dicts through groups of ``dp`` tasks (one a
        rank); sum the gradients until ``tasks_per_batch`` real tasks are in,
        then update (single-step-learner.py:162-166, over ranks). A final
        group of fewer than ``dp`` tasks is filled with dummy lanes, and the
        final partial window is applied. Returns the real tasks' losses in
        task order; ``evaluator`` sees every real task's target logits."""
        losses: List[float] = []
        tasks_per_batch = max(1, self.args.tasks_per_batch)
        pending = 0  # real tasks whose gradients sit in .grad

        def lane_info(task) -> dict:
            """What every rank knows of a lane without padding its pixels."""
            labels = np.asarray(task["context_labels"])
            n_ctx, n_tgt = len(task["context_clips"]), len(task["target_clips"])
            return {"ctx_mask": pad_rows(np.ones(n_ctx, np.float32), bucket_size(n_ctx)),
                    "m": n_tgt, "target_rows": bucket_size(n_tgt),
                    "way": int(labels.max()) + 1 if labels.size else 0,
                    "labels": np.asarray(task["target_labels"])}

        def run_group(group):
            nonlocal pending
            n_real = len(group)
            lanes = [lane_info(task) for task, _ in group]
            for i in range(n_real, self.dp):  # dummies copy this group's real lanes
                lanes.append(dict(lanes[i % n_real], m=0))
            subsets = self.lane_subsets(generator, lanes)
            if self.rank < n_real:
                episode = group[self.rank][1]
            else:  # a dummy: its donor padded here, its target masked out
                donor = pad_episode(group[self.rank % n_real][0])
                donor.target_mask = np.zeros_like(donor.target_mask)
                episode = self.to_device(donor)
            gathered = self.run_lane(episode, self.rank < n_real,
                                     None if subsets is None else subsets[self.rank])
            for lane, (loss, logits) in zip(lanes[:n_real], gathered):
                losses.append(loss)
                if evaluator is not None:
                    n_valid = lane["m"]
                    evaluator.update_stats(logits[:n_valid, :lane["way"]],
                                           lane["labels"][:n_valid])
            # count real tasks, so that dp not dividing tasks_per_batch keeps
            # closest to the reference's cadence
            pending += n_real
            if pending >= tasks_per_batch:
                self.mesh.all_reduce_grads(self.params)
                if pending > tasks_per_batch:
                    # the step's gradients are pre-scaled by 1/tasks_per_batch:
                    # an overshooting window applies its mean
                    for p in self.params:
                        p.grad.mul_(tasks_per_batch / pending)
                self.apply_update()
                pending = 0

        def prepare(indexed):
            i, task = indexed
            # pad and copy only this rank's lane
            return self.to_device(pad_episode(task)) if i % self.dp == self.rank else None

        from orbit_tpu_torch.data.episodes import prefetch_prepared

        group = []
        prepared = prefetch_prepared(enumerate(tasks), prepare,
                                     depth=getattr(self.args, "episode_prefetch", 1))
        for (_, task), episode in prepared:
            group.append((task, episode))
            if len(group) == self.dp:
                run_group(group)
                group = []  # drop the references before the next group
        if group:
            run_group(group)
        if pending:  # the final partial window: sum/tasks_per_batch, as serial
            self.mesh.all_reduce_grads(self.params)
            self.apply_update()
        return losses

