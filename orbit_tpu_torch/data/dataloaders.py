"""Facade that turns a ``dataset_info`` dict into train/validation/test queues.

Reference equivalent: data/dataloaders.py:8-93 (same dataset_info keys).

Host-parallel loading (SURVEY.md §2.9 item 3): ``num_shards``/``shard_index``
in ``dataset_info`` (or from ``--num_hosts``/``--host_index`` via
``resolve_host_sharding``) give every host a disjoint strided slice of each
queue's task stream, so a multi-host run decodes frames in parallel.

Copy of ``orbit_tpu/data/dataloaders.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step. One difference: unset
host flags mean one shard, index 0 (the original asks the JAX process
grid).
"""
from __future__ import annotations

import os

from orbit_tpu_torch.data.queues import ObjectEpisodicDatasetQueue, UserEpisodicDatasetQueue


def resolve_host_sharding(args) -> tuple:
    """(num_shards, shard_index) for this host.

    ``--num_hosts 0`` / ``--host_index -1`` (the defaults) mean one shard,
    index 0.
    """
    num = int(getattr(args, "num_hosts", 0) or 0)
    idx = int(getattr(args, "host_index", -1))
    num = num if num > 0 else 1
    idx = idx if idx >= 0 else 0
    if idx >= num:
        raise ValueError(f"host_index {idx} out of range for num_hosts {num}")
    return num, idx


class DataLoader:
    def __init__(self, dataset_info: dict):
        self.train_queue = None
        self.validation_queue = None
        self.test_queue = None

        mode = dataset_info["mode"]
        num_threads = dataset_info.get("num_data_threads", 4)
        seed = dataset_info.get("seed")
        num_shards = dataset_info.get("num_shards", 1)
        shard_index = dataset_info.get("shard_index", 0)

        def common(queue_cls, root, way, cap, shot_methods, clip_methods, num_tasks,
                   filters, test_mode, with_caps=False, shuffle=False):
            return queue_cls(
                root,
                way,
                cap,
                shot_methods,
                dataset_info["shots"],
                dataset_info["video_types"],
                dataset_info["subsample_factor"],
                clip_methods,
                dataset_info["clip_length"],
                dataset_info["frame_size"],
                dataset_info["frame_norm_method"],
                annotations_to_load=dataset_info["annotations_to_load"],
                filter_by_annotations=filters,
                num_tasks=num_tasks,
                test_mode=test_mode,
                with_cluster_labels=dataset_info.get("with_cluster_labels", False),
                with_caps=with_caps,
                shuffle=shuffle,
                num_threads=num_threads,
                seed=seed,
                logfile=dataset_info.get("logfile"),
                num_shards=num_shards,
                shard_index=shard_index,
                # uint8 wire format: ship raw pixels, normalize on device
                # (models/recognisers.py _maybe_normalize)
                raw_uint8=dataset_info.get("device_normalize", False),
            )

        if "train" in mode:
            train_cls = (
                UserEpisodicDatasetQueue
                if dataset_info.get("train_task_type", "user_centric") == "user_centric"
                else ObjectEpisodicDatasetQueue
            )
            self.train_queue = common(
                train_cls,
                os.path.join(dataset_info["data_path"], "train"),
                dataset_info["train_way_method"],
                dataset_info["train_object_cap"],
                dataset_info["train_shot_methods"],
                dataset_info["train_clip_methods"],
                dataset_info["num_train_tasks"],
                dataset_info["train_filter_by_annotations"],
                test_mode=False,
                with_caps=dataset_info.get("with_train_shot_caps", False),
                shuffle=True,
            )
            self.validation_queue = common(
                UserEpisodicDatasetQueue,
                os.path.join(dataset_info["data_path"], "validation"),
                dataset_info["test_way_method"],
                dataset_info["test_object_cap"],
                dataset_info["test_shot_methods"],
                dataset_info["test_clip_methods"],
                dataset_info["num_val_tasks"],
                dataset_info.get("test_filter_by_annotations", (None, None)),
                test_mode=True,
            )
        if "test" in mode:
            self.test_queue = common(
                UserEpisodicDatasetQueue,
                os.path.join(dataset_info["data_path"], dataset_info["test_set"]),
                dataset_info["test_way_method"],
                dataset_info["test_object_cap"],
                dataset_info["test_shot_methods"],
                dataset_info["test_clip_methods"],
                dataset_info["num_test_tasks"],
                dataset_info.get("test_filter_by_annotations", (None, None)),
                test_mode=True,
            )

    def get_train_queue(self):
        return self.train_queue

    def get_validation_queue(self):
        return self.validation_queue

    def get_test_queue(self):
        return self.test_queue
