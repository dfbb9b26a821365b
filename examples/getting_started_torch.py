#!/usr/bin/env python
"""ORBIT challenge getting-started walkthrough on the PyTorch port
(counterpart of ``examples/getting_started.py``; same flags and steps).

Script equivalent of the reference's ``orbit_challenge_getting_started.ipynb``:
build a user-episodic queue over the validation split, personalise a
ProtoNets + ViT-B-32-CLIP recogniser on each task's context clips, predict
every frame of each target video, report frame accuracy + MACs, and save the
challenge-format ``results.json``. It drives the port's
``SingleStepLearner`` on ``cuda:0`` (``main(argv, device="cpu")`` runs it
on the CPU with the kernels' plain versions).

With the reference's pinned ProtoNets ViT-B-32-CLIP checkpoint (converted
with ``scripts/convert_checkpoint_torch.py --full_model``) and
``--num_tasks 10`` this should reproduce the notebook's expected output:
frame accuracy (per-video) 85.67 (1.50), MACs to personalise 4.78T (1.27T)
(reference notebook cell 8).

Usage:
    python examples/getting_started_torch.py --data_path /data/orbit_benchmark_224 \\
        --pretrained_extractor_path pretrained/vit_b_32_clip.ckpt \\
        --model_path checkpoints/protonets_vit_b_32_clip.ckpt
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbit_tpu_torch.learners.single_step import SingleStepLearner
from orbit_tpu_torch.utils.args import parse_args


def main(argv=None, device=None):
    wrapper = argparse.ArgumentParser()
    wrapper.add_argument("--data_path", required=True)
    wrapper.add_argument("--model_path", default=None)
    wrapper.add_argument("--pretrained_extractor_path", default=None)
    wrapper.add_argument("--num_tasks", type=int, default=10)
    wrapper.add_argument("--checkpoint_dir", default="./getting_started_runs")
    wrapper.add_argument("--feature_extractor", default="vit_b_32_clip")
    wrapper.add_argument("--frame_size", type=int, default=224,
                         help="224 for the real protocol; smaller for smoke "
                              "tests on synthetic trees.")
    wrapper.add_argument("--assert_oracle", action="store_true",
                         help="Assert the notebook oracle after the run: "
                              "per-video frame accuracy 85.67 +/- 1.50 and "
                              "4.78T mean MACs to personalise (+/-30%%) "
                              "(reference notebook cell 8). Use with the "
                              "pinned ProtoNets ViT-B-32-CLIP checkpoint and "
                              "--num_tasks 10.")
    a = wrapper.parse_args(argv)

    # The notebook's dataset settings (cell 4): validation split, max way,
    # all context videos, uniform context clips, random_200 target frames.
    flags = [
        "--data_path", a.data_path,
        "--checkpoint_dir", a.checkpoint_dir,
        "--mode", "test",
        "--test_set", "validation",
        "--feature_extractor", a.feature_extractor,
        "--classifier", "proto",
        "--logit_scale", "1.0",
        "--num_test_tasks", str(a.num_tasks),
        "--frame_size", str(a.frame_size),
    ]
    if a.model_path:
        flags += ["--model_path", a.model_path]
    if a.pretrained_extractor_path:
        flags += ["--pretrained_extractor_path", a.pretrained_extractor_path]

    learner = SingleStepLearner(parse_args("single-step-learner", flags), device=device)
    learner.test(a.model_path)
    learner.logfile.close()
    print(f"results.json saved under {learner.checkpoint_dir}")

    if a.assert_oracle:
        # Notebook cell 8 oracle: 85.67 (1.50) per-video frame accuracy,
        # 4.78T (1.27T) MACs to personalise.
        _, _, _, video_stats = learner.test_evaluator.get_mean_stats()
        acc, ci = video_stats["frame_acc"]
        acc, ci = acc * 100.0, ci * 100.0  # stats are fractions; oracle is %
        macs = np.mean(learner.test_evaluator.raw_task_macs())
        print(f"oracle check: frame_acc={acc:.2f} ({ci:.2f}), "
              f"mean MACs={macs / 1e12:.2f}T")
        assert abs(acc - 85.67) <= 1.50, (
            f"frame accuracy {acc:.2f} outside 85.67 +/- 1.50")
        assert abs(macs - 4.78e12) <= 0.3 * 4.78e12, (
            f"mean MACs {macs / 1e12:.2f}T far from the 4.78T oracle")
        print("oracle check passed")
    return learner


if __name__ == "__main__":
    main()
