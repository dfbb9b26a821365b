"""Fixed-shape padded episodes: the bridge between ragged host tasks and XLA.

XLA compiles one program per input shape, but ORBIT tasks are ragged (way
2-15, variable clips per video — SURVEY.md §7 hard part 1). This module pads
``task_dict`` arrays into bucketed shapes with validity masks so the entire
personalise/predict pipeline compiles once per bucket:

- context/target clip counts    -> next size in ``SIZE_BUCKETS``
- per-video frame counts (test) -> next size in ``VIDEO_BUCKETS``
- class count                   -> ``max_way``-sized steps (16 covers every
  normal task; --with_cluster_labels tasks carry sparse global-vocabulary
  ids and round up to 32/48/...)

Masks make padding inert: padded rows carry label 0 and mask 0 (excluded from
class means, covariance, CE and accuracy); padded classes are masked to -inf
logits by the heads.

Copy of ``orbit_tpu/data/episodes.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIZE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# 200 gets its own bucket: the CLU-VE protocol samples exactly 200 frames per
# clutter video (test_target_clip_method=random_200), so padding to 256 would
# waste 28% of eval compute on every video
VIDEO_BUCKETS = (64, 128, 200, 256, 512, 1024, 2048)
MAX_WAY = 16


def bucket_size(n: int, buckets: Sequence[int] = SIZE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def _as_clip_array(clips) -> np.ndarray:
    """Pixels as float32 — EXCEPT the uint8 wire format, which must survive
    padding untouched: device-side normalization (models/recognisers.py
    ``_maybe_normalize``) keys on the uint8 dtype, so a host-side float cast
    here would silently ship raw 0..255 values that nothing ever normalizes
    (round-5 review finding)."""
    arr = np.asarray(clips)
    if arr.dtype == np.uint8:
        return arr
    return arr.astype(np.float32, copy=False)


def pad_rows(arr: np.ndarray, target: int, fill=0) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    pad_shape = (target - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


@dataclass
class Episode:
    """One device-ready task (train mode: flat target; test: per-video)."""

    context_clips: np.ndarray        # (N, T, H, W, 3) float32
    context_labels: np.ndarray       # (N,) int32, padded rows = 0
    context_mask: np.ndarray         # (N,) float32
    num_classes: int                 # static bucket (= max_way)
    class_mask: np.ndarray           # (C,) float32, 1 for real classes
    way: int                         # actual number of classes
    # train mode
    target_clips: Optional[np.ndarray] = None
    target_labels: Optional[np.ndarray] = None
    target_mask: Optional[np.ndarray] = None
    # test mode: per-video padded frame stacks
    video_frames: Optional[List[np.ndarray]] = None   # each (F_b, H, W, 3)
    video_masks: Optional[List[np.ndarray]] = None    # each (F_b,)
    video_labels: Optional[List[int]] = None
    video_paths: Optional[List[np.ndarray]] = None


def pad_episode(task: Dict, max_way: int = MAX_WAY,
                size_buckets: Sequence[int] = SIZE_BUCKETS,
                video_buckets: Sequence[int] = VIDEO_BUCKETS) -> Episode:
    """Pad a loader ``task_dict`` (orbit_tpu.data.loader.load_task) into a
    fixed-shape Episode."""
    ctx = _as_clip_array(task["context_clips"])
    labels = np.asarray(task["context_labels"], np.int64)
    way = int(labels.max()) + 1 if labels.size else 0
    n_bucket = bucket_size(ctx.shape[0], size_buckets)

    # class-axis bucket: normal tasks have dense 0..way-1 labels with
    # way <= 16, but --with_cluster_labels tasks carry SPARSE ids from the
    # split's global cluster vocabulary (up to ~100 — data/index.py), so
    # the class axis rounds up in max_way-sized steps and the mask marks
    # only the ids actually PRESENT (absent clusters -> -inf logits, never
    # zero-count prototypes)
    c_bucket = max_way * max(1, -(-way // max_way))
    present = np.zeros(way, np.float32)
    if labels.size:
        present[np.unique(labels)] = 1.0

    episode = Episode(
        context_clips=pad_rows(ctx, n_bucket),
        context_labels=pad_rows(labels.astype(np.int32), n_bucket),
        context_mask=pad_rows(np.ones(ctx.shape[0], np.float32), n_bucket),
        num_classes=c_bucket,
        class_mask=pad_rows(present, c_bucket),
        way=way,
    )

    target = task.get("target_clips")
    if isinstance(target, list):                      # test mode: per video
        episode.video_frames, episode.video_masks = [], []
        episode.video_labels = [int(l) for l in task["target_labels"]]
        episode.video_paths = list(task["target_paths"])
        for video in target:
            v = _as_clip_array(video)
            f_bucket = bucket_size(v.shape[0], video_buckets)
            episode.video_frames.append(pad_rows(v, f_bucket))
            episode.video_masks.append(pad_rows(np.ones(v.shape[0], np.float32), f_bucket))
    elif target is not None:                          # train mode: flat
        tgt = _as_clip_array(target)
        t_labels = np.asarray(task["target_labels"], np.int64).astype(np.int32)
        m_bucket = bucket_size(tgt.shape[0], size_buckets)
        episode.target_clips = pad_rows(tgt, m_bucket)
        episode.target_labels = pad_rows(t_labels, m_bucket)
        episode.target_mask = pad_rows(np.ones(tgt.shape[0], np.float32), m_bucket)
    return episode


def batch_episodes(episodes: Sequence[Episode]) -> Episode:
    """Stack same-bucket train episodes into a leading task axis for
    episode-data-parallel training (SURVEY.md §2.9). All episodes must share
    bucket shapes; the caller groups them."""
    first = episodes[0]
    assert all(e.context_clips.shape == first.context_clips.shape for e in episodes)
    assert all(e.target_clips is not None for e in episodes)
    assert all(e.target_clips.shape == first.target_clips.shape for e in episodes)
    return Episode(
        context_clips=np.stack([e.context_clips for e in episodes]),
        context_labels=np.stack([e.context_labels for e in episodes]),
        context_mask=np.stack([e.context_mask for e in episodes]),
        num_classes=first.num_classes,
        class_mask=np.stack([e.class_mask for e in episodes]),
        way=max(e.way for e in episodes),
        target_clips=np.stack([e.target_clips for e in episodes]),
        target_labels=np.stack([e.target_labels for e in episodes]),
        target_mask=np.stack([e.target_mask for e in episodes]),
    )


def prefetch_prepared(tasks, prepare, depth: int = 1):
    """Pipeline host episode preparation under device compute.

    The queue's producer thread already decodes task t+1's JPEGs while the
    device computes task t (orbit_tpu/data/queues.py), but ``pad_episode`` +
    the transfer-dtype cast + the host->device copy still sat serial in the
    step loop (round-3 verdict, weak #5). This wraps a task_dict iterator
    with one more pipeline stage: a background thread runs ``prepare``
    (typically pad + cast + ``jax.device_put``) for the NEXT task while the
    consumer computes on the current one, yielding ``(task_dict, prepared)``
    pairs in order. ``depth`` bounds how many prepared episodes (device
    buffers included) may be resident ahead of the consumer; ``depth <= 0``
    degrades to the serial loop (no thread).

    If the consumer abandons the generator early (step-loop exception,
    partial iteration), the generator's ``finally`` signals the producer to
    stop and drains the queue, so prepared tasks' device buffers are freed
    and the thread exits instead of blocking on a full queue forever.
    """
    if depth <= 0:
        for task in tasks:
            yield (task, prepare(task))
        return

    import queue as _q
    import threading

    out: "_q.Queue" = _q.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except _q.Full:
                continue
        return False

    def produce():
        try:
            for task in tasks:
                if stop.is_set() or not put((task, prepare(task))):
                    return
        except BaseException as e:  # surfaced on the consumer side
            put(e)
        finally:
            put(sentinel)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            got = out.get()
            if got is sentinel:
                return
            if isinstance(got, BaseException):
                raise got
            yield got
    finally:
        stop.set()
        try:  # unblock a pending producer put; drop its device buffers
            while True:
                out.get_nowait()
        except _q.Empty:
            pass
