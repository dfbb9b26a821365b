"""Episodic task sampling: pure, seeded, no pixel IO.

Produces a ``TaskPlan`` (frame paths arranged in clips + labels + video ids)
from a ``DatasetIndex``. The plan is later materialised by
``orbit_tpu.data.loader`` — splitting plan from load lets the decode path run
in parallel threads and keeps sampling unit-testable.

Behavioural parity with the reference sampler (data/datasets.py:289-598):
way computation, shot methods (specific/fixed/random/max), shot caps and the
dynamic train caps, clip methods (max/random/random_200/uniform) with
frame_cap/clip_cap, pad-to-clip-multiple with the last frame, train-time
shuffling and test-time group-by-video.

All randomness flows through one ``random.Random`` instance so the eval
protocol (50 tasks x 17 users, random_200 target frames) is reproducible from
a single seed (SURVEY.md §7 hard part 5).

Known deviation (intentional): for clip methods 'random'/'random_200' with
clip_length > 1 the reference indexes *frames* with sampled *clip* ids
(data/datasets.py:455-461 vs :350) which scrambles clips; we map sampled clip
ids to their actual frame rows. Identical behaviour for clip_length == 1 (the
benchmark setting).

Copy of ``orbit_tpu/data/sampling.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

import random
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from orbit_tpu_torch.data.episodes import SIZE_BUCKETS
from orbit_tpu_torch.data.index import DatasetIndex

CLIP_CAP = 200     # max clips sampled from one video (datasets.py:79)
FRAME_CAP = 1000   # max frames considered in one video (datasets.py:80)
DEFAULT_SHOT_CAP = 15
# hard ceiling on clips per episode set: the largest fixed-shape bucket
# (orbit_tpu.data.episodes). Legal un-capped configs can exceed it (way 15 x
# 15 target videos x 200 clips = 45,000 clips); instead of crashing at pad
# time we subsample proportionally per video at plan time — the train-time
# analog of the reference's memory caps (data/datasets.py:77-81).
MAX_CLIPS_PER_SET = SIZE_BUCKETS[-1]
EPISODE_BYTES_WARN = 1 << 30  # warn (once) past a 1 GiB host episode

_warned_once: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned_once:
        _warned_once.add(key)
        print(f"orbit_tpu warning: {msg}", file=sys.stderr, flush=True)


@dataclass
class SamplingConfig:
    way_method: str = "max"                    # 'random' | 'max'
    object_cap: Union[int, str] = 15           # int or 'max'
    shot_method_context: str = "max"           # specific | fixed | random | max
    shot_method_target: str = "max"
    shot_context: int = 5
    shot_target: int = 2
    clip_method_context: str = "uniform"       # random | random_200 | max | uniform
    clip_method_target: str = "random_200"
    clip_length: int = 1
    subsample_factor: int = 30
    with_caps: bool = False                    # dynamic train-time shot caps
    test_mode: bool = False                    # group target by video
    frame_size: int = 224                      # for episode byte estimates


@dataclass
class TaskPlan:
    """A fully-specified episodic task, before any pixels are read."""
    task_id: str
    object_list: List[str]
    # context: clips of shape (num_clips, clip_length) of frame paths
    context_paths: np.ndarray
    context_labels: np.ndarray            # (num_clips,) int64
    context_video_ids: np.ndarray         # (num_clips,) int64
    # target, train mode: same layout as context
    target_paths: Optional[np.ndarray] = None
    target_labels: Optional[np.ndarray] = None
    target_video_ids: Optional[np.ndarray] = None
    # target, test mode: grouped per video (flattened frames, sorted order)
    target_paths_by_video: List[np.ndarray] = field(default_factory=list)
    target_labels_by_video: List[int] = field(default_factory=list)


def compute_way(rng: random.Random, num_objects: int, object_cap, way_method: str) -> int:
    """Number of classes for the task (reference: datasets.py:289-301)."""
    cap = num_objects if object_cap == "max" else int(object_cap)
    max_objects = min(num_objects, cap)
    if way_method == "random":
        lo = min(2, max_objects)
        return rng.choice(range(lo, max_objects + 1))
    if way_method == "max":
        return max_objects
    raise ValueError(f"way_method {way_method} not valid")


def choose_videos(rng: random.Random, videos: Sequence[str], required_shots: int,
                  shot_method: str, shot_cap: int) -> List[str]:
    """Select video paths by shot method (reference: datasets.py:313-336)."""
    required_shots = min(required_shots, shot_cap)
    num_videos = len(videos)
    available_shots = min(required_shots, num_videos)
    if shot_method == "specific":
        return list(videos[:available_shots])
    if shot_method == "fixed":
        return rng.sample(list(videos), available_shots)
    if shot_method == "random":
        max_shots = min(num_videos, shot_cap)
        return rng.sample(list(videos), rng.choice(range(1, max_shots + 1)))
    if shot_method == "max":
        max_shots = min(num_videos, shot_cap)
        return rng.sample(list(videos), max_shots)
    raise ValueError(f"shot_method {shot_method} not valid")


def sample_clip_indices(rng: random.Random, num_frames: int, sample_method: str,
                        clip_length: int, subsample_factor: int) -> np.ndarray:
    """Sample frame indices organised as (num_clips, clip_length)
    (reference: datasets.py:433-469)."""
    frame_idxs = np.arange(min(num_frames, FRAME_CAP))
    spare = len(frame_idxs) % clip_length
    if spare > 0:
        # pad with the last frame so the video splits into whole clips
        frame_idxs = np.append(frame_idxs, [frame_idxs[-1]] * (clip_length - spare))
    max_num_clips = len(frame_idxs) // clip_length
    clip_view = frame_idxs.reshape(max_num_clips, clip_length)

    if sample_method == "max":
        return clip_view
    if sample_method == "random":
        capped = min(max_num_clips, CLIP_CAP)
        k = rng.choice(range(1, capped + 1))
        clip_ids = rng.sample(range(max_num_clips), k)
        return clip_view[np.array(clip_ids, dtype=np.int64)]
    if sample_method == "random_200":
        capped = min(max_num_clips, 200)
        clip_ids = rng.sample(range(max_num_clips), capped)
        return clip_view[np.array(clip_ids, dtype=np.int64)]
    if sample_method == "uniform":
        capped = min(max_num_clips, CLIP_CAP)
        step = min(subsample_factor, max_num_clips)
        clip_ids = np.arange(0, max_num_clips, step)[:capped]
        return clip_view[clip_ids]
    raise ValueError(f"Clip sampling method {sample_method} not valid")


def _sample_clips_from_videos(rng: random.Random, index: DatasetIndex, video_paths: List[str],
                              sample_method: str, cfg: SamplingConfig):
    paths, video_ids = [], []
    for video_path in video_paths:
        frame_paths = np.array(index.vid2frames[video_path])
        idxs = sample_clip_indices(rng, len(frame_paths), sample_method, cfg.clip_length, cfg.subsample_factor)
        sampled = frame_paths[idxs.reshape(-1)].reshape(-1, cfg.clip_length)
        paths.extend(list(sampled))
        video_ids.extend([index.video2id[video_path]] * len(sampled))
    return paths, video_ids


def _cap_clip_rows(rng: random.Random, paths: np.ndarray, labels: np.ndarray,
                   vids: np.ndarray, cap: int, task_id: str, set_name: str):
    """Seeded proportional-per-video subsample of clip rows down to ``cap``.

    Quotas follow the largest-remainder method over per-video clip counts, so
    every video keeps (approximately) its share and no video is dropped
    outright; selection within a video is a seeded ``rng.sample``. Row order
    is preserved (callers shuffle afterwards where the protocol requires it).
    """
    n = len(paths)
    if n <= cap:
        return paths, labels, vids
    uniq = list(dict.fromkeys(vids.tolist()))  # order-preserving unique
    rows_by_vid = {v: np.flatnonzero(vids == v) for v in uniq}
    quotas = {v: len(rows_by_vid[v]) * cap / n for v in uniq}
    take = {v: int(quotas[v]) for v in uniq}
    for v in sorted(uniq, key=lambda v: quotas[v] - take[v], reverse=True):
        if sum(take.values()) >= cap:
            break
        take[v] += 1
    keep: List[int] = []
    for v in uniq:
        rows = rows_by_vid[v]
        keep.extend(sorted(rng.sample(list(rows), min(take[v], len(rows)))))
    keep_arr = np.array(sorted(keep), dtype=np.int64)
    _warn_once(
        f"clip-cap:{set_name}",
        f"task {task_id}: {set_name} set sampled {n} clips, above the largest "
        f"episode bucket ({cap}); subsampled proportionally per video. Use "
        f"--with_train_shot_caps (or lower shot/clip settings) to avoid this.")
    return paths[keep_arr], labels[keep_arr], vids[keep_arr]


def sample_task_plan(index: DatasetIndex, task_objects: Sequence[int], task_id: str,
                     cfg: SamplingConfig, rng: random.Random,
                     obj2cluster: Optional[Dict[int, int]] = None) -> TaskPlan:
    """Sample one episodic task over ``task_objects``
    (reference: datasets.py:540-598)."""
    way = compute_way(rng, len(task_objects), cfg.object_cap, cfg.way_method)
    selected = sorted(rng.sample(list(task_objects), way))
    if obj2cluster:
        label_map = {obj: obj2cluster[obj] for obj in selected}
    else:
        label_map = {obj: i for i, obj in enumerate(selected)}

    # dynamic train-time caps for memory (datasets.py:549-551)
    context_cap = target_cap = DEFAULT_SHOT_CAP
    if cfg.with_caps:
        context_cap = 5 if way >= 6 else 10
        target_cap = 4 if way >= 6 else 8

    object_list: List[str] = []
    c_paths, c_labels, c_vids = [], [], []
    t_paths, t_labels, t_vids = [], [], []
    for obj in selected:
        label = label_map[obj]
        object_list.append(index.obj2name[obj])
        vids = index.obj2vids[obj]
        context_videos = choose_videos(rng, vids["context"], cfg.shot_context, cfg.shot_method_context, context_cap)
        target_videos = choose_videos(rng, vids["target"], cfg.shot_target, cfg.shot_method_target, target_cap)

        cp, cv = _sample_clips_from_videos(rng, index, context_videos, cfg.clip_method_context, cfg)
        c_paths.extend(cp); c_vids.extend(cv); c_labels.extend([label] * len(cp))
        tp, tv = _sample_clips_from_videos(rng, index, target_videos, cfg.clip_method_target, cfg)
        t_paths.extend(tp); t_vids.extend(tv); t_labels.extend([label] * len(tp))

    # context set: always clip-shaped, shuffled (train semantics; for test the
    # reference also shuffles context via shuffle_set — prepare_set test_mode
    # only applies to the *target* set, datasets.py:581-582)
    c_paths = np.array(c_paths)
    c_labels = np.array(c_labels, dtype=np.int64)
    c_vids = np.array(c_vids, dtype=np.int64)
    c_paths, c_labels, c_vids = _cap_clip_rows(
        rng, c_paths, c_labels, c_vids, MAX_CLIPS_PER_SET, task_id, "context")
    perm = np.arange(len(c_paths))
    rng.shuffle(perm)
    plan = TaskPlan(
        task_id=task_id,
        object_list=object_list,
        context_paths=c_paths[perm],
        context_labels=c_labels[perm],
        context_video_ids=c_vids[perm],
    )

    t_paths = np.array(t_paths)
    t_labels = np.array(t_labels, dtype=np.int64)
    t_vids = np.array(t_vids, dtype=np.int64)
    if not cfg.test_mode:
        # flat train targets pad into the same clip buckets as context; the
        # test-mode per-video grouping is bounded by FRAME_CAP per video
        t_paths, t_labels, t_vids = _cap_clip_rows(
            rng, t_paths, t_labels, t_vids, MAX_CLIPS_PER_SET, task_id, "target")
    est_bytes = (len(c_paths) + len(t_paths)) * cfg.clip_length \
        * cfg.frame_size * cfg.frame_size * 3 * 4
    if est_bytes > EPISODE_BYTES_WARN:
        _warn_once(
            "episode-bytes",
            f"task {task_id}: episode is ~{est_bytes / (1 << 30):.1f} GiB of "
            f"float32 pixels on the host ({len(c_paths)} context + "
            f"{len(t_paths)} target clips at {cfg.frame_size}px); consider "
            f"--with_train_shot_caps or a smaller frame size.")
    if cfg.test_mode:
        # group clips by video and flatten to per-video frame lists
        # (reference: prepare_set, datasets.py:487-504)
        for vid in np.unique(t_vids):
            sel = t_vids == vid
            plan.target_paths_by_video.append(t_paths[sel].reshape(-1))
            plan.target_labels_by_video.append(int(t_labels[sel][0]))
    else:
        perm = np.arange(len(t_paths))
        rng.shuffle(perm)
        plan.target_paths = t_paths[perm]
        plan.target_labels = t_labels[perm]
        plan.target_video_ids = t_vids[perm]
    return plan


def task_order(rng: random.Random, num_items: int, num_tasks_per_item: int, shuffle: bool) -> List[int]:
    """Flat task order: each user/object index repeated ``num_tasks_per_item``
    times, optionally shuffled (reference: data/samplers.py:8-33)."""
    ids = [i for i in range(num_items) for _ in range(num_tasks_per_item)]
    if shuffle:
        rng.shuffle(ids)
    return ids
