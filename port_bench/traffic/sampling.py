"""Frozen copy of the task-sampling arithmetic the traffic mixes use, and
the derivation of each mix's fixed sequence of task shapes.

The rules are those of the CLU-VE protocol and of user-centric
meta-training as ``orbit_tpu_torch/data/sampling.py`` applies them
(``compute_way``, ``choose_videos``, ``sample_clip_indices``), reduced to
counts: a task's shape is, for each of its classes, the number of context
clips and of target clips (test mode: of target videos of a fixed length).
The users, their objects and each object's clean (context) and clutter
(target) videos come from the split's ``orbit_<split>_object_cluster_labels
.json``, whose keys are ``user--object--clean|clutter--id`` video names.
Every video is assumed to hold ``frames_per_video`` frames.

A mix file stores the parameters and the derived ``tasks``; the benchmark
reads only the file. Regenerate one with::

    python port_bench/traffic/sampling.py port_bench/traffic/<mix>.json

(the split files are read from ``data/`` at the repository root).
"""
from __future__ import annotations

import json
import random
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

CLIP_CAP = 200      # clips sampled from one video at most
FRAME_CAP = 1000    # frames of one video considered at most
SIZE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def split_users(path) -> Dict[str, Dict[str, List[int]]]:
    """user -> object -> [clean videos, clutter videos], from a split's
    video names."""
    users: Dict[str, Dict[str, List[int]]] = defaultdict(lambda: defaultdict(lambda: [0, 0]))
    for video in json.loads(Path(path).read_text()):
        parts = video.split("--")
        user, kind, obj = parts[0], parts[-2], "--".join(parts[1:-2])
        users[user][obj][0 if kind == "clean" else 1] += 1
    return {u: dict(objs) for u, objs in users.items()}


def uniform_clips(frames: int, subsample_factor: int) -> int:
    """Clips of length 1 the ``uniform`` method takes from one video: every
    ``subsample_factor``-th frame, at most ``CLIP_CAP``."""
    n = min(frames, FRAME_CAP)
    return len(range(0, n, min(subsample_factor, n))[:CLIP_CAP])


def random_clips(rng: random.Random, frames: int) -> int:
    """Clips the ``random`` method takes: uniform in 1..min(clips, CLIP_CAP)."""
    return rng.choice(range(1, min(min(frames, FRAME_CAP), CLIP_CAP) + 1))


def random_shots(rng: random.Random, videos: int, cap: int) -> int:
    """Videos the ``random`` shot method takes: uniform in 1..min(videos, cap)."""
    return rng.choice(range(1, min(videos, cap) + 1))


def bucket(n: int) -> int:
    """The padded row count of a set of ``n`` clips."""
    return next(b for b in SIZE_BUCKETS if n <= b)


def clu_ve_tasks(p: dict, users: Dict[str, Dict[str, List[int]]]) -> List[dict]:
    """One test-mode task a user, in ``p["users"]`` order: every object with
    a clean video (``max`` way, at most ``object_cap``), every clean video
    up to ``shot_cap`` as context (``uniform`` clips), every clutter video
    up to ``shot_cap`` as a target video of ``random_200`` frames."""
    clips = uniform_clips(p["frames_per_video"], p["subsample_factor"])
    tasks = []
    for user in p["users"]:
        objects = sorted(o for o, (clean, _) in users[user].items() if clean > 0)
        objects = objects[:p["object_cap"]]
        tasks.append({
            "user": user, "objects": objects,
            "context_clips": [min(users[user][o][0], p["shot_cap"]) * clips for o in objects],
            "target_videos": [min(users[user][o][1], p["shot_cap"]) for o in objects],
            "video_frames": min(p["frames_per_video"], p["target_clips_per_video"]),
        })
    return tasks


def lite_train_tasks(p: dict, users: Dict[str, Dict[str, List[int]]]) -> List[dict]:
    """``passes`` passes over the users in an order shuffled by
    ``shape_seed``, one task a visit: ``random`` way (2 to the user's
    objects, at most ``object_cap``), ``random`` shots of clean (context,
    ``uniform`` clips) and clutter (target, ``random`` clips) videos, at
    most ``shot_cap`` each. Objects need a clean and a clutter video."""
    rng = random.Random(p["shape_seed"])
    clips = uniform_clips(p["frames_per_video"], p["subsample_factor"])
    tasks = []
    for _ in range(p["passes"]):
        order = list(p["users"])
        rng.shuffle(order)
        for user in order:
            objects = sorted(o for o, (clean, clutter) in users[user].items()
                             if clean > 0 and clutter > 0)
            top = min(len(objects), p["object_cap"])
            way = rng.choice(range(min(2, top), top + 1))
            selected = sorted(rng.sample(objects, way))
            context, target = [], []
            for o in selected:
                clean, clutter = users[user][o]
                context.append(random_shots(rng, clean, p["shot_cap"]) * clips)
                target.append(sum(random_clips(rng, p["frames_per_video"])
                                  for _ in range(random_shots(rng, clutter, p["shot_cap"]))))
            tasks.append({"user": user, "context_clips": context, "target_clips": target})
    return tasks


DERIVE = {"clu_ve_protocol": clu_ve_tasks, "lite_meta_train": lite_train_tasks}


def derive(p: dict, root: Path) -> List[dict]:
    """The task sequence of mix parameters ``p``; the split file is read
    under ``root``."""
    return DERIVE[p["loop"]](p, split_users(root / p["split"]))


def summary(tasks: List[dict]) -> dict:
    """Realised sizes of a sequence: ways, context and target rows."""
    ctx = [sum(t["context_clips"]) for t in tasks]
    if "target_videos" in tasks[0]:
        tgt = [t["video_frames"] * sum(t["target_videos"]) for t in tasks]
    else:
        tgt = [sum(t["target_clips"]) for t in tasks]
    ways = [len(t["context_clips"]) for t in tasks]

    def stats(v):
        return [min(v), max(v), round(sum(v) / len(v), 2)]
    return {"tasks": len(tasks), "way": stats(ways), "context_rows": stats(ctx),
            "target_rows": stats(tgt), "context_rows_total": sum(ctx),
            "target_rows_total": sum(tgt)}


def main(argv) -> int:
    root = Path(__file__).resolve().parents[2]
    for name in argv:
        path = Path(name)
        mix = json.loads(path.read_text())
        mix["tasks"] = derive(mix, root)
        mix["realised"] = summary(mix["tasks"])
        path.write_text(json.dumps(mix, indent=1) + "\n")
        print(path, mix["realised"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
