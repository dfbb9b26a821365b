"""Multi-step learner on the port: the FineTuner's CLU-VE test protocol
(counterpart of ``orbit_tpu/learners/multi_step.py``; reference:
multi-step-learner.py:48-228, model/few_shot_recognisers.py:185-269).
Test-only, like the reference.

Per task, a zero linear head (and with ``--adapt_features`` an f32 copy of
the FiLM leaves) is trained by ``--personalize_num_grad_steps`` steps of
the inner optimiser on the context set, then predicts every query video
(:func:`build_finetune_fns`). The meta-trained parameters never change.

- **Frozen extractor**: the context is embedded once, without a graph, and
  the steps train the head on the cached features, as the JAX learner does
  (orbit_tpu multi_step.py:127-150). The loss is the masked cross-entropy
  summed over the real rows and divided by their count.
- **With FiLM**: every step reruns the extractor over the context in
  batches of ``min(batch_size, n)`` clips, adds each batch's ``sum/total``
  gradient into ``.grad`` and then takes one optimiser step (:152-194). On
  the card a ViT's batches run kernels A and B forward and #4 and #6
  backward in every layer; an EfficientNet's run #8 forward and its
  plain-recompute backward.

Same flags, host side, evaluator and timers as the single-step learner of
the port (``learners/single_step.py``), and the same differences from the
JAX learner: ``cuda:<--gpu>`` or an explicit ``device="cpu"``, pinned
copies, timed regions ended by ``torch.cuda.synchronize()``, one untimed
personalise first. The MACs to personalise follow the JAX learner's
``_personalise_macs`` (:256-271): the personalise is counted on a meta copy
of the recogniser at the task's real context rows with 1 and with 2 grad
steps, and the task is charged ``base + per_step * K``. The FiLM leaves
are f32 masters (``MultiStepFewShotRecogniser.init_task_params``), where
the JAX learner trains them in their storage dtype. ``--profile_dir``,
``--pretrained_extractor_path``, a JAX ``--model_path`` and the bf16 pixel
wire work as in the single-step learner.

The parallel axes (``orbit_tpu_torch/parallel/``), as in the single-step
learner: ``--task_parallel N`` runs groups of N tasks' whole inner loops,
on one device as one batched loop (``TaskBatchedFineTune``), under
``torchrun`` with at least N ranks one lane a rank
(``TaskParallelFineTune``); ``--data_parallel N`` under ``torchrun
--nproc_per_node N`` shards each task's context rows and query frames over
the ranks (``ShardedFineTune``). With fewer ranks than asked for (but more
than one for ``--task_parallel``) it warns and runs single-chip, as the JAX
learner does; only rank 0 logs and writes ``results.json``.
"""
from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np
import torch

from orbit_tpu_torch.data.episodes import pad_episode, prefetch_prepared
from orbit_tpu_torch.data.transforms import attach_frame_history
from orbit_tpu_torch.learners.single_step import (SingleStepLearner, check_ported,
                                                  eval_mesh, load_pretrained,
                                                  select_device)
from orbit_tpu_torch.models import heads as heads_lib
from orbit_tpu_torch.models.precision import cast_extractor_params, compute_dtype
from orbit_tpu_torch.models.recognisers import MultiStepFewShotRecogniser
from orbit_tpu_torch.parallel.episode_dp import process_rank
from orbit_tpu_torch.utils.checkpoint import maybe_load_params
from orbit_tpu_torch.utils.eval_metrics import TestEvaluator
from orbit_tpu_torch.utils.logging import get_log_files, print_and_log, stats_to_str
from orbit_tpu_torch.utils.ops_counter import meta_copy
from orbit_tpu_torch.utils.optim import cross_entropy
from orbit_tpu_torch.utils.profiling import trace


def inner_optimizer(args, task_params) -> torch.optim.Optimizer:
    """The per-task optimiser over the head and the FiLM leaves (orbit_tpu
    multi_step.py:46-67; reference: multi-step-learner.py:157-169). The
    FiLM leaves are a param group at ``personalize_extractor_lr_scale`` x
    the rate. optax's ``add_decayed_weights`` before ``scale_by_adam`` is
    coupled L2, torch's ``weight_decay``; its ``trace(decay=m)`` is SGD
    momentum with zero dampening."""
    lr = args.personalize_learning_rate
    leaves = MultiStepFewShotRecogniser.task_leaves(task_params)
    groups = [{"params": leaves[:2]}]
    if leaves[2:]:
        groups.append({"params": leaves[2:], "lr": lr * args.personalize_extractor_lr_scale})
    if args.personalize_optimizer == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=tuple(args.personalize_betas),
                                eps=args.personalize_epsilon,
                                weight_decay=args.personalize_weight_decay)
    return torch.optim.SGD(groups, lr=lr, momentum=args.personalize_momentum,
                           weight_decay=args.personalize_weight_decay)


def build_finetune_fns(recogniser: MultiStepFewShotRecogniser, args,
                       num_grad_steps: Optional[int] = None, mesh=None):
    """(personalise, predict) of the FineTuner protocol (orbit_tpu
    multi_step.py:70-202, serial). ``personalise(context_clips, labels,
    context_mask, class_mask)`` returns the trained task parameters;
    ``predict(task_params, clips, class_mask)`` the logits.
    ``num_grad_steps`` overrides ``--personalize_num_grad_steps`` (the MACs
    count runs 1 and 2). Freezes every parameter of ``recogniser``: only
    the task parameters train, so no backward forms a weight gradient.

    ``mesh`` (``parallel.episode_dp.Mesh``): the context rows are sharded
    over its ranks (each its contiguous slice of the rows padded to a
    multiple of the mesh size, the pad rows masked out), the loss is
    normalised by the rows' global count (an ``all_reduce``), and every
    step's gradient is summed over the ranks before the update, so every
    rank takes the serial step (orbit_tpu/parallel/finetune_dp.py)."""
    recogniser.requires_grad_(False)
    steps = args.personalize_num_grad_steps if num_grad_steps is None else num_grad_steps

    def loss_sum(task_params, feats, labels, mask, class_mask, total):
        logits = heads_lib.predict_linear(task_params["head"], feats,
                                          logit_scale=recogniser.logit_scale,
                                          class_mask=class_mask)
        # sum/total == the reference's per-batch means scaled by
        # batch_len/total, summed (few_shot_recognisers.py:241-242)
        return cross_entropy(logits, labels, mask, reduction="sum") / total

    @torch.enable_grad()
    def personalise(context_clips, context_labels, context_mask, class_mask):
        task_params = recogniser.init_task_params(class_mask.shape[0])
        optimizer = inner_optimizer(args, task_params)
        if mesh is not None:
            context_clips, context_labels, context_mask = mesh.local_rows(
                context_clips, context_labels, context_mask)
        total = context_mask.float().sum()
        if mesh is not None:
            mesh.all_reduce(total)
        total = torch.clamp(total, min=1.0)
        if recogniser.adapt_features:
            n = context_clips.shape[0]
            eff_b = min(args.batch_size, n)
            batches = [(context_clips[i:i + eff_b], context_labels[i:i + eff_b],
                        context_mask[i:i + eff_b]) for i in range(0, n, eff_b)]
        else:
            feats = recogniser.embed_clips(context_clips)
        for _ in range(steps):
            optimizer.zero_grad(set_to_none=True)
            if recogniser.adapt_features:
                for clips, labels, mask in batches:
                    feats_b = recogniser.embed_clips(clips, with_grad=True,
                                                     film=task_params["film"])
                    loss_sum(task_params, feats_b, labels, mask, class_mask,
                             total).backward()
            else:
                loss_sum(task_params, feats, context_labels, context_mask, class_mask,
                         total).backward()
            if mesh is not None:
                mesh.all_reduce_grads(MultiStepFewShotRecogniser.task_leaves(task_params))
            optimizer.step()
        return task_params

    @torch.inference_mode()
    def predict(task_params, clips, class_mask):
        return recogniser.task_logits(task_params, clips, class_mask=class_mask)

    return personalise, predict


class MultiStepLearner:
    """``test_queue``: an episodic queue to use instead of the one the data
    loader builds from ``--data_path``; ``device`` and ``after_init`` as
    for ``learners.single_step.SingleStepLearner``."""

    def __init__(self, args, test_queue=None, device=None, after_init=None):
        check_ported(args, heads=MultiStepFewShotRecogniser.HEADS)
        self.args = args
        self.after_init = after_init
        self.device = select_device(args, device)
        self.rank = process_rank()  # only rank 0 logs and writes files
        (self.checkpoint_dir, self.logfile, _, _) = get_log_files(
            args.checkpoint_dir, args.model_path, write=self.rank == 0)
        print_and_log(self.logfile, f"options: {vars(args)}")
        print_and_log(self.logfile, f"checkpoint dir: {self.checkpoint_dir}")
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "CPU: plain PyTorch ops, no CUDA kernels")
        print_and_log(self.logfile, f"torch device: {self.device} ({name})")
        random.seed(args.seed)
        np.random.seed(args.seed)
        self.test_queue = test_queue
        if test_queue is None:
            self.init_dataset()
        self.init_model()
        if getattr(args, "data_parallel", 1) > 1:
            # within-task DP: each task's context rows and query frames
            # sharded over the ranks; the protocol's timing and MACs keep
            # their meaning
            mesh = eval_mesh(args, self.logfile, "data_parallel", self.device)
            if mesh is not None:
                from orbit_tpu_torch.parallel import ShardedFineTune

                ft = ShardedFineTune(self.recogniser, args, mesh)
                self.personalise_fn, self.predict_fn = ft.personalise, ft.predict
        # the personalise already holds its backward: no thop-style x2
        # (reference multi-step-learner.py:126, ops_counter.py:13)
        self.test_evaluator = TestEvaluator(list(getattr(args, "metrics", ["frame_acc"])),
                                            self.checkpoint_dir, with_ops_counter=True,
                                            count_backwards=False)
        self.test_timings = None

    def init_dataset(self):
        from orbit_tpu_torch.data.dataloaders import DataLoader, resolve_host_sharding

        args = self.args
        info = {
            "mode": "test", "data_path": args.data_path, "test_set": args.test_set,
            "test_object_cap": args.test_object_cap,
            "test_way_method": args.test_way_method,
            "test_shot_methods": (args.test_context_shot_method,
                                  args.test_target_shot_method),
            "shots": (args.context_shot, args.target_shot),
            "video_types": (args.context_video_type, args.target_video_type),
            "test_clip_methods": (args.test_context_clip_method,
                                  args.test_target_clip_method),
            "clip_length": args.clip_length, "num_test_tasks": args.num_test_tasks,
            "subsample_factor": args.subsample_factor, "frame_size": args.frame_size,
            "frame_norm_method": args.frame_norm_method,
            "annotations_to_load": args.annotations_to_load,
            "test_filter_by_annotations": (args.test_filter_context,
                                           args.test_filter_target),
            "num_data_threads": args.num_data_threads, "seed": args.seed,
            "logfile": self.logfile,
            "device_normalize": not getattr(args, "host_normalize", False),
        }
        info["num_shards"], info["shard_index"] = resolve_host_sharding(args)
        self.test_queue = DataLoader(info).get_test_queue()
        cache = getattr(args, "frame_cache", 0)
        if cache:
            self.test_queue.loader.enable_cache(cache)

    def init_model(self):
        args = self.args
        self.dtype = compute_dtype(args.compute_dtype)
        self.recogniser = MultiStepFewShotRecogniser(
            feature_extractor_name=args.feature_extractor,
            adapt_features=args.adapt_features, classifier=args.classifier,
            clip_length=args.clip_length, batch_size=args.batch_size,
            logit_scale=args.logit_scale, dtype=self.dtype,
            frame_norm_method=args.frame_norm_method, frame_size=args.frame_size,
        ).to(self.device).init(args.seed)
        load_pretrained(self.recogniser, args, self.logfile)
        if self.after_init is not None:
            self.after_init(self.recogniser)
        self.personalise_fn, self.predict_fn = build_finetune_fns(self.recogniser, args)

    def run(self):
        with trace(getattr(self.args, "profile_dir", None)):
            self.test(self.args.model_path)
        self.logfile.close()

    _sync = SingleStepLearner._sync
    _to_device = SingleStepLearner._to_device
    _host_to_device = SingleStepLearner._host_to_device
    _clips_to_device = SingleStepLearner._clips_to_device

    def personalise_macs(self, ops_counter, n_valid: int, ctx) -> float:
        """The FineTuner's MACs to personalise (orbit_tpu multi_step.py:
        256-271): the personalise counted at the task's ``n_valid`` real
        context clips with 1 and with 2 grad steps, ``per_step = f2 - f1``,
        ``base = f1 - per_step``, charged ``base + per_step * K``."""
        if not hasattr(self, "_macs_fns"):
            meta = meta_copy(self.recogniser)
            self._macs_fns = {k: build_finetune_fns(meta, self.args, num_grad_steps=k)[0]
                              for k in (1, 2)}
        clips, labels, _, class_mask = ctx
        rows = (clips[:n_valid], labels[:n_valid],
                torch.ones(n_valid, device="meta"), class_mask)
        f1, f2 = (ops_counter.flops(f"personalise_ft_k{k}", self._macs_fns[k], *rows)
                  for k in (1, 2))
        per_step = f2 - f1
        return (f1 - per_step + per_step * self.args.personalize_num_grad_steps) / 2.0

    def test(self, path: Optional[str], save_evaluator: bool = True):
        args = self.args
        used = maybe_load_params(path, self.recogniser, self.logfile)
        evaluator = self.test_evaluator
        evaluator.set_base_params(self.recogniser)
        if self.dtype == torch.bfloat16:
            # the inner loop trains only the head and the FiLM leaves' f32
            # copies, so the frozen extractor may be stored in bf16
            cast_extractor_params(self.recogniser.extractor)
        tdp = getattr(args, "task_parallel", 1)
        if tdp > 1:
            mesh = eval_mesh(args, self.logfile, "task_parallel", self.device)
            if mesh is not None:
                if getattr(args, "data_parallel", 1) > 1:
                    print_and_log(self.logfile,
                                  "WARNING: --task_parallel takes precedence over "
                                  "--data_parallel at eval; within-task row sharding "
                                  "disabled for this run.")
                if mesh.size == 1:
                    print_and_log(self.logfile,
                                  f"--task_parallel {tdp} on one device: batching task "
                                  f"groups of {tdp} per call.")
                self._test_taskdp(evaluator, tdp, mesh)
                self._finish_eval(evaluator, used, path, save_evaluator)
                return
        num_context, num_target = [], []
        num_total_tasks = self.test_queue.num_local_tasks()

        def prepare(task_dict):
            # pad + pinned H2D of the context for task t+1 on the prefetch
            # thread; query videos stay on the host until their predict
            ep = pad_episode(task_dict)
            ctx = (self._clips_to_device(ep.context_clips),
                   self._to_device(ep.context_labels.astype(np.int64)),
                   self._to_device(ep.context_mask), self._to_device(ep.class_mask))
            return ep, ctx, [attach_frame_history(fr, args.clip_length)
                             for fr in ep.video_frames]

        warmed = False
        prepared = prefetch_prepared(self.test_queue.get_tasks(), prepare,
                                     depth=getattr(args, "episode_prefetch", 1))
        for step, (task_dict, (ep, ctx, query)) in enumerate(prepared):
            evaluator.set_task_object_list(task_dict["object_list"])
            evaluator.set_task_context_paths(task_dict["context_paths"])
            if not warmed:
                # untimed: the first launch builds/loads the kernels
                self.personalise_fn(*ctx)
                self._sync()
                warmed = True
            t1 = time.perf_counter()
            task_params = self.personalise_fn(*ctx)
            self._sync()
            evaluator.log_time(time.perf_counter() - t1, "personalise")
            # the REAL clip count and the REAL grad-step count (reference
            # ops_counter.py:79-85)
            n_valid = int(ep.context_mask.sum())
            evaluator.ops_counter.add_macs(
                self.personalise_macs(evaluator.ops_counter, n_valid, ctx))

            num_target_clips = 0
            class_mask = ctx[3]
            for clips, mask, label, paths in zip(query, ep.video_masks, ep.video_labels,
                                                 ep.video_paths):
                n_real = int(mask.sum())
                clips = self._clips_to_device(clips)
                self._sync()
                t1 = time.perf_counter()
                logits = self.predict_fn(task_params, clips, class_mask).cpu().numpy()
                evaluator.log_time((time.perf_counter() - t1)
                                   / float(n_real * args.clip_length), "inference")
                evaluator.append_video(logits[:n_real], label, paths)
                num_target_clips += n_real

            num_context.append(n_valid)
            num_target.append(num_target_clips)
            evaluator.task_complete()
            num_context, num_target = self._eval_rollup(
                step + 1, task_dict, evaluator, num_total_tasks, num_context, num_target)
        self._finish_eval(evaluator, used, path, save_evaluator)

    def _finish_eval(self, evaluator, used, path, save_evaluator: bool):
        """Final 4-view summary + results.json (reference:
        multi-step-learner.py:200-217)."""
        args = self.args
        stats_user, stats_obj, stats_task, stats_video = evaluator.get_mean_stats()
        mean_macs, std_macs, mean_params, params_breakdown = \
            evaluator.get_mean_ops_counter_stats()
        p_mean, p_std, i_mean, i_std = evaluator.get_mean_times()
        print_and_log(self.logfile, (
            f"{args.test_set} [{used or path}]\n"
            f"Frame accuracy (averaged per user): {stats_to_str(stats_user)}\n"
            f"Frame accuracy (averaged per object): {stats_to_str(stats_obj)}\n"
            f"Frame accuracy (averaged per task): {stats_to_str(stats_task)}\n"
            f"Frame accuracy (averaged per video): {stats_to_str(stats_video)}\n"
            f"Time to personalise (averaged per task) {p_mean} ({p_std})\n"
            f"Inference time per frame (averaged per task): {i_mean} ({i_std})\n"
            f"MACs to personalise (averaged per task): {mean_macs} ({std_macs})\n"
            f"Number of params: {mean_params} ({params_breakdown})\n"))
        # seconds, per task: personalise, and inference per frame
        self.test_timings = {
            "personalise": [t for u in evaluator.all_personalise_times for t in u],
            "inference_per_frame": [t for u in evaluator.all_inference_times for t in u]}
        if save_evaluator and self.rank == 0:
            evaluator.save()
        evaluator.reset()

    def _test_taskdp(self, evaluator, tdp: int, mesh):
        """The FineTuner protocol in groups of ``tdp`` consecutive tasks of
        one shape (orbit_tpu/learners/multi_step.py:502 on): each group's
        inner loops run as one batched loop on one device
        (``TaskBatchedFineTune``), or one lane a rank
        (``TaskParallelFineTune``). Results are consumed in arrival order,
        so the evaluator, the rollups and ``results.json`` equal the serial
        loop's; a new shape runs once untimed first; the timed calls end in
        a device sync and are divided over the group's real tasks and real
        frames; each task's MACs are the serial loop's."""
        from orbit_tpu_torch.parallel import TaskBatchedFineTune, TaskParallelFineTune
        from orbit_tpu_torch.parallel.task_dp import (build_query_block, stack_eval_group,
                                                      trim_videos)

        args = self.args
        tpf = (TaskParallelFineTune(self.recogniser, args, tdp, mesh) if mesh.size > 1
               else TaskBatchedFineTune(self.recogniser, args, tdp))
        num_total_tasks = self.test_queue.num_local_tasks()
        state = {"tasks_done": 0, "ctx": [], "tgt": []}
        warmed = set()

        def run_group(group):
            eps, qbs = [g[1] for g in group], [g[2] for g in group]
            n_real = len(group)
            batch = stack_eval_group(eps, qbs, tdp)
            videos = trim_videos(batch, qbs)  # no padding video is embedded
            batch = tpf.local(batch)
            dev = {"context_clips": self._clips_to_device(batch["context_clips"]),
                   "context_labels": self._to_device(batch["context_labels"].astype(np.int64)),
                   "context_mask": self._to_device(batch["context_mask"]),
                   "class_mask": self._to_device(batch["class_mask"])}
            query = self._clips_to_device(batch["query_clips"])
            key = (batch["context_clips"].shape, batch["query_clips"].shape,
                   batch["class_mask"].shape)
            if key not in warmed:
                # untimed: the first launch at a shape builds/loads the kernels
                tpf.predict(tpf.personalise(dev), query, dev["class_mask"])
                self._sync()
                warmed.add(key)
            self._sync()
            t1 = time.perf_counter()
            task_params = tpf.personalise(dev)
            self._sync()
            per_task = (time.perf_counter() - t1) / n_real
            t2 = time.perf_counter()
            logits = tpf.predict(task_params, query, dev["class_mask"]).cpu().numpy()
            frames = sum(sum(qb.n_frames) for qb in qbs)
            per_frame = (time.perf_counter() - t2) / float(max(1, frames) * args.clip_length)

            for i, (task_dict, ep, qb) in enumerate(group):
                evaluator.set_task_object_list(task_dict["object_list"])
                evaluator.set_task_context_paths(task_dict["context_paths"])
                evaluator.log_time(per_task, "personalise")
                n_valid = int(ep.context_mask.sum())
                ctx = (torch.from_numpy(ep.context_clips),
                       torch.from_numpy(ep.context_labels.astype(np.int64)), None,
                       torch.from_numpy(ep.class_mask))  # shapes only
                evaluator.ops_counter.add_macs(
                    self.personalise_macs(evaluator.ops_counter, n_valid, ctx))
                lane = logits[i].reshape(videos, qb.frame_bucket, -1)
                num_target_clips = 0
                for vi in range(qb.n_videos):
                    evaluator.log_time(per_frame, "inference")
                    evaluator.append_video(lane[vi][:qb.n_frames[vi]], ep.video_labels[vi],
                                           ep.video_paths[vi])
                    num_target_clips += qb.n_frames[vi]
                state["ctx"].append(n_valid)
                state["tgt"].append(num_target_clips)
                evaluator.task_complete()
                state["tasks_done"] += 1
                state["ctx"], state["tgt"] = self._eval_rollup(
                    state["tasks_done"], task_dict, evaluator, num_total_tasks,
                    state["ctx"], state["tgt"])

        def prepare(task_dict):
            # pad + query block on the prefetch thread, under the device's
            # inner loops of the previous group
            ep = pad_episode(task_dict)
            return ep, build_query_block(ep, args.clip_length)

        depth = getattr(args, "episode_prefetch", 1)
        prepared = prefetch_prepared(self.test_queue.get_tasks(), prepare,
                                     depth=max(depth, tdp) if depth > 0 else depth)
        group, group_key = [], None
        for task_dict, (ep, qb) in prepared:
            key = (ep.context_clips.shape, qb.clips.shape, ep.num_classes)
            if group and key != group_key:
                run_group(group)  # a shape change runs the partial group
                group = []
            group.append((task_dict, ep, qb))
            group_key = key
            if len(group) == tdp:
                run_group(group)
                group = []
        if group:
            run_group(group)

    def _eval_rollup(self, tasks_done, task_dict, evaluator, num_total_tasks,
                     ctx_counts, tgt_counts):
        """Per-user stats rollup at user boundaries (reference:
        multi-step-learner.py:137-150). ``tasks_done`` is 1-based."""
        args = self.args
        if tasks_done % args.num_test_tasks == 0:
            evaluator.set_current_user(task_dict["task_id"])
            _, _, _, video_stats = evaluator.get_mean_stats(current_user=True)
            macs_mean, _, _, _ = evaluator.get_mean_ops_counter_stats(current_user=True)
            print_and_log(self.logfile,
                          f"{args.test_set} user {task_dict['task_id']} "
                          f"({evaluator.current_user + 1}/{self.test_queue.num_users}) "
                          f"stats: {stats_to_str(video_stats)}, avg MACs to "
                          f"personalise/task: {macs_mean}, avg # context clips/task: "
                          f"{np.mean(ctx_counts):.0f}, avg # target clips/task: "
                          f"{np.mean(tgt_counts):.0f}")
            if tasks_done < num_total_tasks:
                ctx_counts, tgt_counts = [], []
                evaluator.next_user()
        else:
            evaluator.next_task()
        return ctx_counts, tgt_counts
