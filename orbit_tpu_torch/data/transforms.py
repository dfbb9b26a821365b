"""Array-side task helpers (NumPy): frame history, task unpacking, batching.

Reference equivalents: data/utils.py:8-54.

Copy of ``orbit_tpu/data/transforms.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def attach_frame_history(frames: np.ndarray, history_length: int) -> np.ndarray:
    """For each frame, attach its immediate history of ``history_length``
    frames: (N, H, W, 3) -> (N, history_length, H, W, 3).

    Frame i's clip is [f_{i-L+1}, ..., f_i] with the first frame repeated for
    the warm-up region (reference: data/utils.py:8-28, reimplemented with a
    sliding window over a front-padded array).
    """
    if history_length == 1:
        return frames[:, None]
    num_frames = frames.shape[0]
    pad = np.repeat(frames[:1], history_length - 1, axis=0)
    padded = np.concatenate([pad, frames], axis=0)
    idx = np.arange(num_frames)[:, None] + np.arange(history_length)[None, :]
    return padded[idx]


def unpack_task(task_dict: dict) -> Tuple:
    """Unpack a task dict into the canonical 7-tuple
    (reference: data/utils.py:30-47; device placement is JAX-managed here)."""
    return (
        task_dict["context_clips"],
        task_dict["context_paths"],
        task_dict["context_labels"],
        task_dict["target_clips"],
        task_dict["target_paths"],
        task_dict["target_labels"],
        task_dict["object_list"],
    )


def get_batch_indices(index: int, total: int, batch_size: int) -> Tuple[int, int]:
    """Half-open [start, end) indices of batch ``index``
    (reference: data/utils.py:49-54)."""
    start = index * batch_size
    end = min(start + batch_size, total)
    return start, end
