"""Evaluation metrics and aggregation (host-side NumPy bookkeeping).

Capability parity with the reference's utils/eval_metrics.py:14-363 —
frame accuracy / video accuracy / frames-to-recognition, 95% CIs, the
TestEvaluator's nested per-user -> per-task -> per-video logs with four
aggregation views, personalise/inference timers, MACs logging, and the
challenge-format results.json export. This is bookkeeping, not compute, so it
stays NumPy on the host (SURVEY.md §7 architecture map).

Copy of ``orbit_tpu/utils/eval_metrics.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step. One difference:
``TestEvaluator(with_ops_counter=True)`` builds the port's MACs counter
(``orbit_tpu_torch/utils/ops_counter.py``).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from orbit_tpu_torch.utils.logging import convert_to_microseconds, convert_to_minutes


def softmax(logits: np.ndarray, axis: int = -1) -> np.ndarray:
    z = logits - logits.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def clever_format(value: float) -> str:
    """Human-readable op/param counts (reference uses thop.clever_format)."""
    for unit, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(value) >= scale:
            return f"{value / scale:.2f}{unit}"
    return f"{value:.2f}B"  # thop suffixes bare numbers with B


class Evaluator:
    """Metric functions shared by all evaluators
    (reference: eval_metrics.py:14-69)."""

    def __init__(self, stats_to_compute: Sequence[str]):
        self.stats_to_compute = list(stats_to_compute)
        self.stat_fns = {
            "frame_acc": self.get_frame_accuracy,
            "frames_to_recognition": self.get_frames_to_recognition,
            "video_acc": self.get_video_accuracy,
        }

    @staticmethod
    def get_confidence_interval(scores) -> float:
        """95% CI = 1.96 * sigma / sqrt(n) (reference: eval_metrics.py:24-25)."""
        scores = np.asarray(scores, dtype=np.float64)
        return float(1.96 * np.std(scores) / np.sqrt(len(scores)))

    @staticmethod
    def get_frame_accuracy(label, probs) -> float:
        predictions = np.argmax(probs, axis=-1)
        return float(np.mean(np.equal(label, predictions)))

    def get_video_accuracy(self, label, probs) -> float:
        return 1.0 if self.get_video_prediction(probs) == label else 0.0

    @staticmethod
    def get_frames_to_recognition(label, probs) -> float:
        """First-correct-frame index / video length; 1.0 if never correct
        (reference: eval_metrics.py:48-60)."""
        predictions = np.argmax(probs, axis=-1)
        correct = np.where(label == predictions)[0]
        return float(correct[0] / len(predictions)) if len(correct) else 1.0

    @staticmethod
    def get_video_prediction(probs) -> int:
        predictions = np.argmax(probs, axis=-1)
        return int(np.bincount(predictions).argmax())


class TrainEvaluator(Evaluator):
    """Running per-step stats during meta-training
    (reference: eval_metrics.py:71-99)."""

    def __init__(self, stats_to_compute):
        super().__init__(stats_to_compute)
        self.reset()

    def reset(self):
        self.current_stats = {s: 0.0 for s in self.stats_to_compute}
        self.running_stats = {s: [] for s in self.stats_to_compute}

    def update_stats(self, logits: np.ndarray, labels: np.ndarray):
        probs = softmax(np.asarray(logits, dtype=np.float32))
        labels = np.asarray(labels)
        for stat in self.stats_to_compute:
            self.current_stats[stat] = self.stat_fns[stat](labels, probs)
            self.running_stats[stat].append(self.current_stats[stat])

    def get_current_stats(self):
        return self.current_stats

    def get_mean_stats(self):
        return {
            stat: [float(np.mean(scores)), self.get_confidence_interval(scores)]
            for stat, scores in self.running_stats.items()
        }


class TestEvaluator(Evaluator):
    """Nested per-user/task/video logs + 4 aggregation views + timers + MACs
    (reference: eval_metrics.py:101-343)."""

    __test__ = False  # "Test" prefix is domain naming, not a pytest class

    def __init__(self, stats_to_compute, save_dir: Optional[str] = None,
                 with_ops_counter: bool = False, count_backwards: bool = False):
        super().__init__(stats_to_compute)
        self.save_dir = save_dir
        if with_ops_counter:
            from orbit_tpu_torch.utils.ops_counter import OpsCounter
            self.ops_counter = OpsCounter(count_backward=count_backwards)
        else:
            self.ops_counter = None
        self.reset()

    # ------------------------------------------------------------ state ----
    def reset(self):
        self.current_user = 0
        self.current_task = 0
        self.all_frame_probs = [[[]]]
        self.all_video_labels = [[[]]]
        self.all_frame_paths = [[[]]]
        self.all_frame_predictions = [[[]]]
        self.all_users: List[str] = []
        self.all_object_lists = [[[]]]
        self.all_personalise_times = [[[]]]
        self.all_inference_times = [[[]]]
        if self.ops_counter:
            self.macs_counter = [[[]]]
            self.params_counter = [[[]]]

    def set_current_user(self, user_id: str):
        self.all_users.append(user_id)
        assert len(self.all_users) == self.current_user + 1

    def set_task_object_list(self, task_object_list):
        self.all_object_lists[self.current_user][self.current_task] = list(task_object_list)

    def set_task_context_paths(self, context_paths):
        """Accepted for API parity; context paths are not used in aggregation.
        (The reference *calls* this on ValidationEvaluator without defining it
        — a latent crash, single-step-learner.py:256; defined here instead.)"""
        self._task_context_paths = context_paths

    def next_user(self):
        for log in (self.all_frame_probs, self.all_video_labels, self.all_frame_paths,
                    self.all_frame_predictions, self.all_object_lists,
                    self.all_personalise_times, self.all_inference_times):
            log.append([[]])
        if self.ops_counter:
            self.macs_counter.append([[]])
            self.params_counter.append([[]])
        self.current_task = 0
        self.current_user += 1

    def next_task(self):
        for log in (self.all_frame_probs, self.all_video_labels, self.all_frame_paths,
                    self.all_frame_predictions, self.all_object_lists,
                    self.all_personalise_times, self.all_inference_times):
            log[self.current_user].append([])
        if self.ops_counter:
            self.macs_counter[self.current_user].append([])
            self.params_counter[self.current_user].append([])
        self.current_task += 1

    # ---------------------------------------------------------- logging ----
    def append_video(self, frame_logits, video_label, frame_paths):
        """Log one target video's frame logits; de-duplicates padding frames
        by unique path (reference: eval_metrics.py:260-276)."""
        frame_logits = np.asarray(frame_logits, dtype=np.float32)
        frame_paths = np.asarray(frame_paths).reshape(-1)
        frame_paths, unique_idxs = np.unique(frame_paths, return_index=True)
        frame_logits = frame_logits[unique_idxs]
        assert frame_paths.shape[0] == frame_logits.shape[0]

        frame_probs = softmax(frame_logits)
        video_label = np.asarray(video_label)
        frame_predictions = frame_logits.argmax(axis=-1).tolist()

        self.all_frame_probs[self.current_user][self.current_task].append(frame_probs)
        self.all_video_labels[self.current_user][self.current_task].append(video_label)
        self.all_frame_paths[self.current_user][self.current_task].append(frame_paths)
        self.all_frame_predictions[self.current_user][self.current_task].append(frame_predictions)

    def log_time(self, time: float, time_type: str = "personalise"):
        if time_type == "personalise":
            self.all_personalise_times[self.current_user][self.current_task] = time
        elif time_type == "inference":
            self.all_inference_times[self.current_user][self.current_task] = time
        else:
            raise ValueError(f"time_type must be 'personalise' or 'inference' but got {time_type}")

    def set_base_params(self, params_tree):
        if self.ops_counter:
            self.ops_counter.set_base_params(params_tree)

    def log_macs(self, macs: float):
        if self.ops_counter:
            self.ops_counter.add_macs(macs)

    def task_complete(self):
        if self.ops_counter:
            self.macs_counter[self.current_user][self.current_task] = self.ops_counter.get_task_macs()
            self.params_counter[self.current_user][self.current_task] = self.ops_counter.get_task_params()
            self.ops_counter.task_complete()

    # ------------------------------------------------------ aggregation ----
    # video_acc / frames_to_recognition are defined per video; for the other
    # views their per-video scores are averaged (the reference computes but
    # never wires these metrics — its flattened aggregation would crash on
    # them, SURVEY.md §2.6)
    VIDEO_LEVEL_STATS = ("video_acc", "frames_to_recognition")

    def get_mean_stats(self, current_user: bool = False):
        """Four views (per-user / per-object / per-task / per-video), each
        mean +/- 95% CI (reference: eval_metrics.py:155-211)."""
        user_scores = {s: [] for s in self.stats_to_compute}
        object_scores = {s: [] for s in self.stats_to_compute}
        task_scores = {s: [] for s in self.stats_to_compute}
        video_scores = {s: [] for s in self.stats_to_compute}

        num_users = self.current_user + 1
        users = [self.current_user] if current_user else range(num_users)
        for stat in self.stats_to_compute:
            per_video_stat = stat in self.VIDEO_LEVEL_STATS
            for user in users:
                user_frame_probs = self.all_frame_probs[user]
                user_video_labels = self.all_video_labels[user]

                obj2probs: Dict[int, list] = {}
                obj2vscores: Dict[int, list] = {}
                flat_user_probs, flat_user_labels, user_vscores = [], [], []
                for task in range(len(user_frame_probs)):
                    flat_task_probs, flat_task_labels, task_vscores = [], [], []
                    for video_label, frame_probs in zip(user_video_labels[task],
                                                        user_frame_probs[task]):
                        vscore = self.stat_fns[stat](video_label, frame_probs)
                        video_scores[stat].append(vscore)
                        task_vscores.append(vscore)
                        flat_task_probs.extend(frame_probs)
                        flat_task_labels.extend(np.repeat(video_label, frame_probs.shape[0]))
                        obj2probs.setdefault(int(video_label), []).extend(frame_probs)
                        obj2vscores.setdefault(int(video_label), []).append(vscore)

                    task_scores[stat].append(
                        float(np.mean(task_vscores)) if per_video_stat
                        else self.stat_fns[stat](np.array(flat_task_labels),
                                                 np.vstack(flat_task_probs)))
                    flat_user_probs.extend(flat_task_probs)
                    flat_user_labels.extend(flat_task_labels)
                    user_vscores.extend(task_vscores)

                for obj in obj2probs:
                    object_scores[stat].append(
                        float(np.mean(obj2vscores[obj])) if per_video_stat
                        else self.stat_fns[stat](np.array(obj), np.vstack(obj2probs[obj])))

                user_scores[stat].append(
                    float(np.mean(user_vscores)) if per_video_stat
                    else self.stat_fns[stat](np.array(flat_user_labels),
                                             np.vstack(flat_user_probs)))

        return (self.average_over_scores(user_scores),
                self.average_over_scores(object_scores),
                self.average_over_scores(task_scores),
                self.average_over_scores(video_scores))

    def average_over_scores(self, scores_by_stat):
        return {
            stat: [float(np.mean(scores)), self.get_confidence_interval(scores)]
            for stat, scores in scores_by_stat.items() if stat in self.stats_to_compute
        }

    def _flat_counter(self, counter, current_user: bool):
        users = [self.current_user] if current_user else range(self.current_user + 1)
        return [v for u in users for v in np.atleast_1d(counter[u]).tolist()
                if not isinstance(v, list)]

    def raw_task_macs(self, current_user: bool = False):
        """Flat list of per-task MACs values (raw floats, not formatted)."""
        return self._flat_counter(self.macs_counter, current_user)

    def get_mean_ops_counter_stats(self, current_user: bool = False):
        """Mean/std MACs-to-personalise per task + param count breakdown
        (reference: eval_metrics.py:221-234)."""
        if not self.ops_counter:
            return "0.00B", "0.00B", "0.00B", ""
        task_macs = self.raw_task_macs(current_user)
        task_params = self._flat_counter(self.params_counter, current_user)
        if not task_macs:
            return "0.00B", "0.00B", "0.00B", self.ops_counter.params_break_down
        return (clever_format(float(np.mean(task_macs))),
                clever_format(float(np.std(task_macs))),
                clever_format(float(np.mean(task_params))),
                self.ops_counter.params_break_down)

    def get_mean_times(self, current_user: bool = False):
        users = [self.current_user] if current_user else range(self.current_user + 1)
        personalise = [np.mean(self.all_personalise_times[u]) for u in users]
        inference = [np.mean(self.all_inference_times[u]) for u in users]
        return (convert_to_minutes(float(np.mean(personalise))),
                convert_to_minutes(float(np.std(personalise))),
                convert_to_microseconds(float(np.mean(inference))),
                convert_to_microseconds(float(np.std(inference))))

    # ------------------------------------------------------------- save ----
    def save(self):
        """Challenge-format results.json: {user: [{task_object_list,
        task_macs_to_personalise, task_videos: {video: {frame_id: pred}}}]}
        (reference: eval_metrics.py:112-153)."""
        output = {}
        num_users = self.current_user + 1
        assert len(self.all_users) == num_users
        for user in range(num_users):
            user_id = self.all_users[user]
            output[user_id] = []
            for task in range(len(self.all_frame_paths[user])):
                task_output = {
                    "task_object_list": self.all_object_lists[user][task],
                    "task_videos": {},
                }
                if self.ops_counter:
                    task_output["task_macs_to_personalise"] = int(self.macs_counter[user][task])
                task_paths = self.all_frame_paths[user][task]
                task_preds = self.all_frame_predictions[user][task]
                for video_paths, video_preds in zip(task_paths, task_preds):
                    video_id = Path(str(video_paths[0])).parts[-2]
                    video_out = {}
                    for path, pred in zip(video_paths, video_preds):
                        frame_id = int(Path(str(path)).stem.split("-")[-1])
                        video_out[frame_id] = pred
                    task_output["task_videos"][video_id] = video_out
                output[user_id].append(task_output)

        self.json_results_path = Path(self.save_dir or ".", "results.json")
        self.json_results_path.parent.mkdir(exist_ok=True, parents=True)
        with open(self.json_results_path, "w") as f:
            json.dump(output, f)


class ValidationEvaluator(TestEvaluator):
    """Tracks the best validation stats; the first stat is the comparison key
    (reference: eval_metrics.py:345-363)."""

    def __init__(self, stats_to_compute):
        super().__init__(stats_to_compute)
        self.comparison_stat = self.stats_to_compute[0]
        self.current_best_stats = {s: [0.0, 0.0] for s in self.stats_to_compute}

    def is_better(self, stats) -> bool:
        return stats[self.comparison_stat][0] > self.current_best_stats[self.comparison_stat][0]

    def replace(self, stats):
        self.current_best_stats = stats

    def get_current_best_stats(self):
        return self.current_best_stats
