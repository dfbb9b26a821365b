"""The parallel axes of the port (counterpart of ``orbit_tpu/parallel/``):
task groups on one device and across ranks (``task_dp``), episode-data-
parallel meta-training (``episode_dp``), query sharding
(``query_sharding``) and FineTuner row sharding (``finetune_dp``). A mesh
is the ranks of a ``torch.distributed`` process group, one process a GPU
(``torchrun``): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU."""
from orbit_tpu_torch.parallel.episode_dp import EpisodeDataParallel, Mesh, make_mesh
from orbit_tpu_torch.parallel.finetune_dp import ShardedFineTune
from orbit_tpu_torch.parallel.query_sharding import ShardedQuery
from orbit_tpu_torch.parallel.task_dp import (TaskBatchedEval, TaskBatchedFineTune,
                                              TaskParallelEval, TaskParallelFineTune)

__all__ = ["EpisodeDataParallel", "Mesh", "ShardedFineTune", "ShardedQuery",
           "TaskBatchedEval", "TaskBatchedFineTune", "TaskParallelEval",
           "TaskParallelFineTune", "make_mesh"]
