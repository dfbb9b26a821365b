"""Within-task query sharding for inference (counterpart of
``orbit_tpu/parallel/query_sharding.py``; SURVEY.md §2.9 item 2).

The reference streams a video's query clips through the backbone in a
Python batch loop on one GPU (few_shot_recognisers.py:124-153). The query
axis is embarrassingly parallel: every rank holds the (replicated)
personalised task state, the frame axis is padded to a multiple of the
world size, each rank predicts its contiguous slice, and the slices are
gathered (one ``all_gather``) and the padding cut off.

    sq = ShardedQuery(recogniser, mesh)
    logits = sq.predict(task_state, clips, class_mask)
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from orbit_tpu_torch.parallel.episode_dp import Mesh, make_mesh


def sharded_rows(mesh: Mesh, fn: Callable[[torch.Tensor], torch.Tensor],
                 clips: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``clips`` (N, ...) with the rows sharded over the mesh:
    each rank runs its slice of the rows padded to a multiple of the mesh
    size; returns every rank's output rows, gathered, padding cut off."""
    n = clips.shape[0]
    (local,) = mesh.local_rows(clips)
    return torch.cat(mesh.all_gather(fn(local).contiguous()))[:n]


class ShardedQuery:
    def __init__(self, recogniser, mesh: Optional[Mesh] = None):
        self.recogniser = recogniser
        self.mesh = mesh or make_mesh()
        self.num_shards = self.mesh.size

    @torch.inference_mode()
    def predict(self, task_state, clips: torch.Tensor,
                class_mask: torch.Tensor) -> torch.Tensor:
        """Logits of ``clips`` (N, T, H, W, 3), the rows sharded over the
        mesh, on every rank."""
        return sharded_rows(self.mesh, lambda c: self.recogniser.predict(
            task_state, c, class_mask=class_mask), clips)
