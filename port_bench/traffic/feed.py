"""The one general generator of the benchmark's traffic: task dicts made
from a mix file's fixed sequence of task shapes and frames from a seeded
bank, yielded as the port's episodic queues yield them.

- :class:`FrameBank`: ``frames_per_object`` uint8 frames an object slot,
  drawn on the card from ``--seed`` in one pass an object (a colour,
  optional horizontal stripes, uniform noise) and copied to the host once.
- :class:`Window`: the measured window's clock; the feed stops at the
  first multiple of ``window_unit_tasks`` tasks at or past ``--seconds``.
- :class:`EvalFeed` (test-mode tasks: context clips and per-video target
  frames with unique frame paths) and :class:`TrainFeed` (train-mode tasks:
  flat, shuffled context and target clips) expose the surface the learner
  reads of a queue: ``get_tasks()``, ``num_local_tasks()``, ``num_users``,
  ``loader``. ``make(j)`` builds task ``j`` of the run, the same for every
  call with the same seed, so the check can rebuild what the window ran.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch


class FrameBank:
    """(objects, frames_per_object, size, size, 3) uint8 frames on the host."""

    def __init__(self, params: dict, objects: int, seed: int, device, size: int = 224):
        lo, hi = params["colour"]
        g = torch.Generator(device=device).manual_seed(seed)
        n = params["frames_per_object"]
        if params.get("object_spread") is None:
            colours = torch.randint(lo, hi + 1, (objects, 3), generator=g, device=device)
        else:
            s = params["object_spread"]
            colours = (torch.randint(lo, hi + 1, (1, 3), generator=g, device=device)
                       + torch.randint(-s, s + 1, (objects, 3), generator=g, device=device))
        y = torch.arange(size, device=device)[:, None, None]
        self.frames = np.empty((objects, n, size, size, 3), np.uint8)
        for i in range(objects):
            stripes = ((y // (8 + 6 * i)) % 2) * params.get("stripes", 0)
            noise = torch.randint(-params["noise"], params["noise"] + 1, (n, size, size, 3),
                                  generator=g, device=device, dtype=torch.int16)
            frame = (colours[i] + stripes + noise).clamp_(0, 255).to(torch.uint8)
            self.frames[i] = frame.cpu().numpy()
            del noise, frame

    def start(self, rng: np.random.Generator, n: int) -> int:
        """A seeded first row for ``n`` consecutive rows that wrap past the
        bank's end only as far as ``n`` exceeds it: every seed does the same
        host work."""
        return int(rng.integers(self.frames.shape[1] - min(n, self.frames.shape[1]) + 1))

    def rows(self, obj: int, start: int, n: int) -> np.ndarray:
        """``n`` consecutive rows of object ``obj`` from ``start``, wrapping;
        rows past the bank's end repeat it one level brighter a pass, so all
        ``n`` rows differ."""
        per = self.frames.shape[1]
        idx = (start + np.arange(n)) % per
        out = self.frames[obj][idx]
        passes = (start + np.arange(n)) // per
        again = passes > 0
        if again.any():
            out[again] = np.minimum(out[again].astype(np.int16) + passes[again, None, None, None],
                                    255).astype(np.uint8)
        return out


class Window:
    """The measured window: opened by the loop module, read by the feed."""

    def __init__(self, seconds: float, unit: int, before: int = 0):
        self.seconds, self.unit = seconds, unit
        self.before = before   # tasks of the same feed that run before the window
        self.start: Optional[float] = None
        self.end: Optional[float] = None

    def open(self) -> None:
        self.start = time.perf_counter()

    def close(self) -> None:
        self.end = time.perf_counter()

    @property
    def seconds_measured(self) -> float:
        return self.end - self.start

    def done(self, handed: int) -> bool:
        """Whether the feed stops before handing out its next task, having
        handed out ``handed``: the window has run ``seconds`` and holds a
        whole number of units (every task handed out runs)."""
        inside = handed - self.before
        return (self.start is not None and inside > 0 and inside % self.unit == 0
                and time.perf_counter() - self.start >= self.seconds)


class _Feed:
    """``limit``: tasks handed out at most (None: the window decides);
    ``order``: the run's task indices to hand out, in order, in place of
    0, 1, 2, ... (the check's readings run chosen tasks alone)."""

    def __init__(self, mix: dict, bank: FrameBank, seed: int, limit: Optional[int] = None,
                 order: Optional[list] = None):
        self.mix, self.bank, self.seed = mix, bank, seed
        self.shapes = mix["tasks"]
        self.num_users = len(mix["users"])
        self.loader = SimpleNamespace(_cache_cap=0)
        self.order = order
        self.limit = len(order) if order is not None else limit
        self.window: Optional[Window] = None
        self.handed = 0                 # tasks handed out: position k is the k-th

    def num_local_tasks(self) -> int:
        return self.limit if self.limit is not None else 1 << 40

    def index(self, k: int) -> int:
        """The run's task index at position ``k``."""
        return self.order[k] if self.order is not None else k

    def shape(self, k: int) -> dict:
        return self.shapes[self.index(k) % len(self.shapes)]

    def rng(self, k: int) -> np.random.Generator:
        return np.random.default_rng([self.seed % (1 << 63), self.index(k)])

    def get_tasks(self):
        while self.limit is None or self.handed < self.limit:
            if self.window is not None and self.window.done(self.handed):
                return
            self.handed += 1
            yield self.make(self.handed - 1)


class EvalFeed(_Feed):
    """Test-mode tasks: each class's context clips are distinct bank rows
    from a seeded offset; each clutter video is ``video_frames``
    consecutive bank rows from a seeded offset (a view, no copy)."""

    def __init__(self, mix, bank, seed, limit=None, order=None):
        super().__init__(mix, bank, seed, limit, order)
        self.paths = [self._paths(s) for s in self.shapes]

    @staticmethod
    def _paths(shape: dict):
        user, f = shape["user"], shape["video_frames"]
        ctx, videos = [], []
        for obj, n_ctx, n_vid in zip(shape["objects"], shape["context_clips"],
                                     shape["target_videos"]):
            ctx += [f"/bench/{user}/{obj}/clean/{user}--{obj}--clean/{i + 1:05d}.jpg"
                    for i in range(n_ctx)]
            for v in range(n_vid):
                name = f"{user}--{obj}--clutter--V{v}"
                videos.append(np.array([f"/bench/{user}/{obj}/clutter/{name}/{name}-{i + 1:05d}.jpg"
                                        for i in range(f)]))
        return np.array(ctx)[:, None], videos

    def make(self, j: int) -> dict:
        shape, rng = self.shape(j), self.rng(j)
        f = shape["video_frames"]
        ctx, labels, videos, video_labels = [], [], [], []
        for c, (n_ctx, n_vid) in enumerate(zip(shape["context_clips"], shape["target_videos"])):
            ctx.append(self.bank.rows(c, self.bank.start(rng, n_ctx), n_ctx))
            labels += [c] * n_ctx
            for _ in range(n_vid):
                s = self.bank.start(rng, f)
                videos.append(self.bank.frames[c, s:s + f])
                video_labels.append(np.int64(c))
        ctx_paths, video_paths = self.paths[self.index(j) % len(self.shapes)]
        return {"context_clips": np.concatenate(ctx)[:, None],
                "context_paths": ctx_paths,
                "context_labels": np.array(labels, np.int64),
                "context_annotations": {},
                "object_list": list(shape["objects"]),
                "task_id": shape["user"],
                "target_clips": videos,
                "target_paths": video_paths,
                "target_labels": video_labels,
                "target_annotations": {}}


class TrainFeed(_Feed):
    """Train-mode tasks: each class's context and target clips are distinct
    bank rows from seeded offsets; both sets are shuffled by a permutation
    drawn from (``shape_seed``, task index), the same for every seed."""

    def permutation(self, j: int, n: int, which: int) -> np.ndarray:
        return np.random.default_rng([self.mix["shape_seed"], self.index(j) % len(self.shapes),
                                      which]).permutation(n)

    def make(self, j: int) -> dict:
        shape, rng = self.shape(j), self.rng(j)
        out = {}
        for which, key in enumerate(("context", "target")):
            counts = shape[f"{key}_clips"]
            clips = np.concatenate([self.bank.rows(c, self.bank.start(rng, n), n)
                                    for c, n in enumerate(counts)])
            labels = np.repeat(np.arange(len(counts)), counts).astype(np.int64)
            perm = self.permutation(j, len(labels), which)
            out[f"{key}_clips"] = clips[perm][:, None]
            out[f"{key}_labels"] = labels[perm]
        return out


def bank_objects(mix: dict) -> int:
    """The object slots a mix's largest task uses."""
    return max(len(t["context_clips"]) for t in mix["tasks"])
