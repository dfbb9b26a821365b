"""Within-task data parallelism for the FineTuner protocol (counterpart of
``orbit_tpu/parallel/finetune_dp.py``).

The reference finetunes each task on one GPU: ``num_grad_steps`` epochs of
batched gradient descent over the context set, then per-video prediction
(multi-step-learner.py:157-184, model/few_shot_recognisers.py:207-258).
Both halves are data-parallel within one task:

- **personalise**: a step's gradient is the sum of per-batch ``sum/total``
  gradients over the whole context set, whatever the grouping of the rows,
  so the context rows are sharded over the ranks (each its contiguous
  slice, padded rows masked out), ``total`` is the global count of valid
  rows (an ``all_reduce``), and each step's gradient is summed over the
  ranks (an ``all_reduce`` over a flat buffer) before the update: every
  rank then takes the serial step (``learners.multi_step.build_finetune_fns``
  with a mesh);
- **predict**: the query rows are sharded as in the single-step eval path
  (``query_sharding.py``), through the FineTuner's ``task_logits``.

The protocol's semantics stay: per-task timing and MACs mean what they
mean serially; the task uses every rank instead of one.

    ft = ShardedFineTune(recogniser, args, mesh=make_mesh(4))
    task_params = ft.personalise(ctx_clips, ctx_labels, ctx_mask, class_mask)
    logits = ft.predict(task_params, clips, class_mask)
"""
from __future__ import annotations

from typing import Optional

import torch

from orbit_tpu_torch.parallel.episode_dp import Mesh, make_mesh
from orbit_tpu_torch.parallel.query_sharding import sharded_rows


class ShardedFineTune:
    def __init__(self, recogniser, args, mesh: Optional[Mesh] = None):
        from orbit_tpu_torch.learners.multi_step import build_finetune_fns

        self.mesh = mesh or make_mesh(getattr(args, "data_parallel", None))
        self.num_shards = self.mesh.size
        self.recogniser = recogniser
        self._personalise, _ = build_finetune_fns(recogniser, args, mesh=self.mesh)

    def personalise(self, ctx_clips, ctx_labels, ctx_mask, class_mask):
        """The task parameters, trained on the context rows sharded over
        the mesh; identical on every rank."""
        return self._personalise(ctx_clips, ctx_labels, ctx_mask, class_mask)

    @torch.inference_mode()
    def predict(self, task_params, clips, class_mask):
        """Logits of ``clips`` (N, T, H, W, 3), the rows sharded over the
        mesh, on every rank."""
        return sharded_rows(self.mesh, lambda c: self.recogniser.task_logits(
            task_params, c, class_mask=class_mask), clips)
