"""Dataset index: one pure-Python scan of the ORBIT directory tree.

Separates *indexing* (this module: directory scan -> id maps, annotation
filtering) from *task sampling* (``orbit_tpu.data.sampling``) and *pixel IO*
(``orbit_tpu.data.loader``), so that task plans can be built without touching
frames and the decode path can be parallelised/fused independently.

Behavioural parity with the reference's ``ORBITDataset.__load_all_users``
(reference: data/datasets.py:89-281):
- layout ``root/<user>/<object>/<clean|clutter>/<video>/*.jpg``
- context comes from 'clean' videos; target from 'clutter' (or a 5/rest split
  of clean videos when both types are 'clean', datasets.py:152-160)
- frame-annotation filters; a context video needs >=1 valid frame, a target
  video >=50 (datasets.py:121-134)
- an object is valid iff both sets are non-empty; a user is valid iff they
  have >=1 valid object (datasets.py:180-200)

Copy of ``orbit_tpu/data/index.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from orbit_tpu_torch.utils.logging import print_and_log

# Pixel stats per normalisation method (reference: data/datasets.py:82-87).
NORMALIZE_STATS = {
    "imagenet": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "imagenet_inception": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]},
    "openai_clip": {"mean": [0.48145466, 0.4578275, 0.40821073], "std": [0.26862954, 0.26130258, 0.27577711]},
}

ORIGINAL_FRAME_SIZE = 1080  # source capture resolution (datasets.py:81)
ANNOTATION_DIMS = {"object_bounding_box": 4}


@dataclass
class DatasetIndex:
    """Immutable index over one split (train/validation/test) of ORBIT."""

    root: str
    mode: str
    context_type: str
    target_type: str
    frame_size: int
    annotations_to_load: List[str] = field(default_factory=list)

    users: List[str] = field(default_factory=list)
    user2objs: Dict[str, List[int]] = field(default_factory=dict)
    obj2user: Dict[int, str] = field(default_factory=dict)
    obj2name: Dict[int, str] = field(default_factory=dict)
    # obj id -> {"context": [video paths], "target": [video paths]}
    obj2vids: Dict[int, Dict[str, List[str]]] = field(default_factory=dict)
    video2id: Dict[str, int] = field(default_factory=dict)
    vid2frames: Dict[str, List[str]] = field(default_factory=dict)
    frame2anns: Dict[str, dict] = field(default_factory=dict)
    obj2cluster: Dict[int, int] = field(default_factory=dict)
    cluster_classes: List[str] = field(default_factory=list)

    @property
    def num_users(self) -> int:
        return len(self.users)

    @property
    def num_objects(self) -> int:
        return len(self.obj2name)

    def get_user_objects(self, user_idx: int) -> List[int]:
        return self.user2objs[self.users[user_idx]]


def _preprocess_bounding_box(bbox: dict, frame_size: int) -> np.ndarray:
    """Scale a source-resolution box to ``frame_size`` and clamp it in-frame
    (reference: data/datasets.py:268-281)."""
    arr = np.array([bbox["x"], bbox["y"], bbox["w"], bbox["h"]], dtype=np.float64)
    arr = ((arr / ORIGINAL_FRAME_SIZE) * frame_size).astype(np.int32)
    arr[0:2] = np.clip(arr[0:2], 0, frame_size - 1)
    arr[2:4] = np.clip(arr[2:4], 1, frame_size)
    return arr


def _frame_satisfies_criteria(frame_name: str, video_annotations: dict, criteria: List[str]) -> bool:
    """A frame passes if any of its (possibly negated) annotations appears in
    ``criteria`` (reference: data/datasets.py:247-256)."""
    anns = video_annotations.get(frame_name, {})
    present = {a for a, v in anns.items() if v is True}
    present |= {f"no_{a}" for a, v in anns.items() if v is False}
    return bool(present & set(criteria))


def build_index(
    root: str,
    context_type: str = "clean",
    target_type: str = "clutter",
    frame_size: int = 224,
    annotations_to_load: Optional[List[str]] = None,
    filter_context: Optional[List[str]] = None,
    filter_target: Optional[List[str]] = None,
    with_cluster_labels: bool = False,
    cluster_label_dir: str = "data",
    logfile=None,
) -> DatasetIndex:
    annotations_to_load = sorted(annotations_to_load or [])
    filter_context = sorted(filter_context or [])
    filter_target = sorted(filter_target or [])
    with_annotations = bool(annotations_to_load)
    with_filtering = bool(filter_context or filter_target)

    mode = os.path.basename(os.path.normpath(root))
    index = DatasetIndex(
        root=root, mode=mode, context_type=context_type, target_type=target_type,
        frame_size=frame_size, annotations_to_load=annotations_to_load,
    )

    annotation_root = None
    if with_annotations or with_filtering:
        annotation_root = os.path.join(os.path.dirname(os.path.normpath(root)), "annotations", mode)
        if not os.path.isdir(annotation_root):
            raise IOError(f"Annotation directory {annotation_root} does not exist.")

    vid2cluster, cluster_id_map = {}, {}
    if with_cluster_labels:
        # video name -> cluster label for this split (datasets.py:106-118)
        with open(os.path.join(cluster_label_dir, f"orbit_{mode}_object_cluster_labels.json")) as f:
            vid2cluster = json.load(f)
        index.cluster_classes = sorted(set(vid2cluster.values()))
        cluster_id_map = {c: i for i, c in enumerate(index.cluster_classes)}

    needs_bbox = "object_bounding_box" in annotations_to_load or "object_bounding_box" in filter_context + filter_target

    def load_video_annotations(video_name: str) -> dict:
        path = os.path.join(annotation_root, f"{video_name}.json")
        with open(path) as f:
            video_annotations = json.load(f)
        if needs_bbox:
            for frame_id, ann in video_annotations.items():
                if ann.get("object_bounding_box") is not None:
                    ann["object_bounding_box"] = _preprocess_bounding_box(ann["object_bounding_box"], frame_size)
        return video_annotations

    # A context video needs >=1 valid frame; a target video >=50
    # (reference: data/datasets.py:121-134).
    filter_params = {
        "context": {"criteria": filter_context, "min_video_frames": 1, "video_type": context_type},
        "target": {"criteria": filter_target, "min_video_frames": 50, "video_type": target_type},
    }

    obj_id, vid_id = 0, 0
    n_context_videos, n_target_videos = 0, 0
    for user in sorted(os.listdir(root)):
        user_path = os.path.join(root, user)
        if not os.path.isdir(user_path):
            continue
        obj_ids: List[int] = []
        for obj_name in sorted(os.listdir(user_path)):
            obj_path = os.path.join(user_path, obj_name)
            if not os.path.isdir(obj_path):
                continue

            all_videos = {"context": [], "target": []}
            clean_dir = os.path.join(obj_path, "clean")
            if context_type == "clean" and target_type == "clean":
                clean_names = sorted(os.listdir(clean_dir)) if os.path.isdir(clean_dir) else []
                # aim for 5 context videos, leaving >=1 target (datasets.py:152-156)
                split = min(5, len(clean_names) - 1)
                all_videos["context"] = clean_names[:split]
                all_videos["target"] = clean_names[split:]
            elif context_type == "clean" and target_type == "clutter":
                clutter_dir = os.path.join(obj_path, "clutter")
                all_videos["context"] = sorted(os.listdir(clean_dir)) if os.path.isdir(clean_dir) else []
                all_videos["target"] = sorted(os.listdir(clutter_dir)) if os.path.isdir(clutter_dir) else []

            kept = {"context": [], "target": []}
            kept_frames: Dict[str, List[str]] = {}
            for set_type, video_names in all_videos.items():
                vtype = filter_params[set_type]["video_type"]
                for video_name in video_names:
                    video_path = os.path.join(obj_path, vtype, video_name)
                    frames = glob.glob(os.path.join(video_path, "*.jpg"))
                    if with_annotations or filter_params[set_type]["criteria"]:
                        video_annotations = load_video_annotations(video_name)
                        index.frame2anns.update(video_annotations)
                        crit = filter_params[set_type]["criteria"]
                        if crit:
                            frames = [f for f in frames if _frame_satisfies_criteria(os.path.basename(f), video_annotations, crit)]
                    if len(frames) >= filter_params[set_type]["min_video_frames"]:
                        kept[set_type].append(video_path)
                        kept_frames[video_path] = sorted(frames)

            if kept["context"] and kept["target"]:
                obj_ids.append(obj_id)
                index.obj2user[obj_id] = user
                index.obj2name[obj_id] = obj_name
                index.obj2vids[obj_id] = kept
                if with_cluster_labels:
                    # look the cluster up via the object's KEPT videos (any of
                    # them — they share the object); keying off the last
                    # iterated name could hit a filtered-out video absent from
                    # the json, and a silently missing entry would crash
                    # sampling with a KeyError mid-protocol (or, all-missing,
                    # silently fall back to per-task labels). Fail loudly at
                    # index time instead.
                    names = [os.path.basename(v)
                             for v in kept["context"] + kept["target"]]
                    hit = next((n for n in names if n in vid2cluster), None)
                    if hit is None:
                        raise KeyError(
                            f"--with_cluster_labels: no video of object "
                            f"'{user}/{obj_name}' appears in the cluster "
                            f"label json (looked up {names[:3]}...)")
                    index.obj2cluster[obj_id] = cluster_id_map[vid2cluster[hit]]
                obj_id += 1
                for video_path in kept["context"] + kept["target"]:
                    index.video2id[video_path] = vid_id
                    index.vid2frames[video_path] = kept_frames[video_path]
                    vid_id += 1
                n_context_videos += len(kept["context"])
                n_target_videos += len(kept["target"])

        if obj_ids:
            index.users.append(user)
            index.user2objs[user] = obj_ids

    print_and_log(
        logfile,
        f"Loaded data summary: {index.num_users} users, {index.num_objects} objects, "
        f"{len(index.video2id)} videos (#context: {n_context_videos}, #target: {n_target_videos})",
    )
    return index
