"""CLI flag surface.

Keeps the reference's public flag names, choices and defaults
(reference: utils/args.py:12-192) so existing ORBIT command lines work
unchanged, plus TPU-specific additions (mesh/sharding, dtype, bucketing).

Copy of ``orbit_tpu/utils/args.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

import argparse
import sys

FRAME_ANNOTATION_OPTIONS = [
    "object_not_present_issue", "framing_issue", "viewpoint_issue",
    "blur_issue", "occlusion_issue", "overexposed_issue", "underexposed_issue",
]
NEGATED_FRAME_ANNOTATION_OPTIONS = [f"no_{a}" for a in FRAME_ANNOTATION_OPTIONS]
BOUNDING_BOX_OPTIONS = ["object_bounding_box"]
ALL_FRAME_ANNOTATION_OPTIONS = (
    FRAME_ANNOTATION_OPTIONS + NEGATED_FRAME_ANNOTATION_OPTIONS + ["no_issues", "mixed_issues"]
)

FEATURE_EXTRACTORS = ["efficientnet_b0", "efficientnet_v2_s", "vit_s_32", "vit_b_32", "vit_b_32_clip"]

# Pixel-normalisation method implied by each backbone's pretraining recipe
# (reference: utils/args.py:185-190).
NORM_METHOD_FOR_EXTRACTOR = {
    "efficientnet_b0": "imagenet",
    "efficientnet_v2_s": "imagenet_inception",
    "vit_s_32": "imagenet_inception",
    "vit_b_32": "imagenet_inception",
    "vit_b_32_clip": "openai_clip",
}


def build_parser(learner: str = "default") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    parser.add_argument("--checkpoint_dir", default="./checkpoints", help="Directory to save checkpoints to.")
    parser.add_argument("--data_path", required=True, help="Path to ORBIT root directory.")
    parser.add_argument("--test_set", default="test", choices=["validation", "test"])

    # model parameters
    parser.add_argument("--model_path", "-m", default=None, help="Path to model to load and test.")
    parser.add_argument("--mode", choices=["train", "test", "train_test"], default="train_test")
    parser.add_argument("--feature_extractor", type=str, default="efficientnet_b0", choices=FEATURE_EXTRACTORS)
    parser.add_argument("--learn_extractor", action="store_true")
    parser.add_argument("--adapt_features", action="store_true")
    parser.add_argument("--classifier", default="proto", choices=["linear", "versa", "proto", "proto_cosine", "mahalanobis"])
    parser.add_argument("--logit_scale", type=float, default=1.0)

    # data parameters
    parser.add_argument("--train_way_method", type=str, default="random", choices=["random", "max"])
    parser.add_argument("--test_way_method", type=str, default="max", choices=["random", "max"])
    parser.add_argument("--train_object_cap", type=int, default=15)
    parser.add_argument("--test_object_cap", type=int, default=15)
    parser.add_argument("--train_context_shot_method", type=str, default="random", choices=["specific", "fixed", "random", "max"])
    parser.add_argument("--train_target_shot_method", type=str, default="random", choices=["specific", "fixed", "random", "max"])
    parser.add_argument("--test_context_shot_method", type=str, default="max", choices=["specific", "fixed", "random", "max"])
    parser.add_argument("--test_target_shot_method", type=str, default="max", choices=["specific", "fixed", "random", "max"])
    parser.add_argument("--context_shot", type=int, default=5)
    parser.add_argument("--target_shot", type=int, default=2)
    parser.add_argument("--with_train_shot_caps", action="store_true")
    parser.add_argument("--context_video_type", type=str, default="clean", choices=["clean"])
    parser.add_argument("--target_video_type", type=str, default="clutter", choices=["clutter", "clean"])
    parser.add_argument("--subsample_factor", type=int, default=30)
    parser.add_argument("--train_context_clip_method", type=str, default="uniform", choices=["random", "random_200", "max", "uniform"])
    parser.add_argument("--train_target_clip_method", type=str, default="random", choices=["random", "random_200", "max"])
    parser.add_argument("--test_context_clip_method", type=str, default="uniform", choices=["random", "random_200", "max", "uniform"])
    parser.add_argument("--test_target_clip_method", type=str, default="random_200", choices=["random", "random_200", "max"])
    parser.add_argument("--clip_length", type=int, default=1)
    parser.add_argument("--frame_size", type=int, default=224, choices=[224, 84])
    parser.add_argument("--annotations_to_load", nargs="+", type=str, default=[], choices=FRAME_ANNOTATION_OPTIONS + BOUNDING_BOX_OPTIONS)
    parser.add_argument("--train_filter_context", nargs="+", type=str, default=[], choices=ALL_FRAME_ANNOTATION_OPTIONS)
    parser.add_argument("--train_filter_target", nargs="+", type=str, default=[], choices=ALL_FRAME_ANNOTATION_OPTIONS)
    parser.add_argument("--test_filter_context", nargs="+", type=str, default=[], choices=ALL_FRAME_ANNOTATION_OPTIONS)
    parser.add_argument("--test_filter_target", nargs="+", type=str, default=[], choices=ALL_FRAME_ANNOTATION_OPTIONS)
    parser.add_argument("--train_task_type", type=str, default="user_centric", choices=["user_centric", "object_centric"])
    parser.add_argument("--num_train_tasks", type=int, default=50)
    parser.add_argument("--num_val_tasks", type=int, default=30)
    parser.add_argument("--num_test_tasks", type=int, default=50)

    # training parameters
    parser.add_argument("--seed", type=int, default=1991)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--tasks_per_batch", type=int, default=16)
    parser.add_argument("--with_lite", action="store_true")
    parser.add_argument("--num_lite_samples", type=int, default=16)
    parser.add_argument("--gpu", type=int, default=0, help="Accepted for CLI parity; device selection is JAX-managed.")
    parser.add_argument("--print_by_step", action="store_true")

    # optimization parameters
    parser.add_argument("--epochs", "-e", type=int, default=30)
    parser.add_argument("--validation_on_epoch", type=int, default=1)
    parser.add_argument("--learning_rate", "-lr", type=float, default=5e-6)
    parser.add_argument("--extractor_lr_scale", type=float, default=1.0)
    parser.add_argument("--optimizer", type=str, default="adam", choices=["adam", "sgd"])
    parser.add_argument("--weight_decay", type=float, default=0.2)
    parser.add_argument("--epsilon", type=float, default=1e-6)
    parser.add_argument("--betas", type=float, nargs=2, default=(0.9, 0.98))
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--scheduler", dest="sched", type=str, default="multistep", choices=["step", "multistep", "cosine"])
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--warmup_epochs", type=int, default=5)
    parser.add_argument("--decay_epochs", type=int, default=15)
    parser.add_argument("--decay_rate", type=float, default=0.5)
    parser.add_argument("--cooldown_epochs", type=int, default=0)
    parser.add_argument("--lr_k_decay", type=float, default=0.1)
    parser.add_argument("--min_lr", type=float, default=1e-6)

    # TPU-native additions (not present in the reference)
    parser.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                        help="Backbone matmul/conv dtype; heads always run float32.")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="Number of GPUs (torchrun ranks) to shard across: one task a "
                             "rank in meta-training, each predict's query frames at eval, "
                             "the FineTuner's context rows and query frames "
                             "(orbit_tpu_torch/parallel/).")
    parser.add_argument("--task_parallel", type=int, default=1,
                        help="Eval-time task-level parallelism: run N whole "
                             "CLU-VE tasks as one group, as one batched call "
                             "on one GPU or one task a rank under torchrun "
                             "(orbit_tpu_torch/parallel/task_dp.py). Works on both "
                             "drivers — the FineTuner runs N whole inner "
                             "gradient loops at once. Results and "
                             "results.json equal the serial loop's.")
    parser.add_argument("--num_data_threads", type=int, default=4,
                        help="Host threads for JPEG decode in the data loader.")
    parser.add_argument("--num_hosts", type=int, default=0,
                        help="Host-parallel data loading (SURVEY §2.9 item 3): "
                             "total hosts sharding the task stream. 0 = derive "
                             "from the JAX process grid (jax.process_count()).")
    parser.add_argument("--host_index", type=int, default=-1,
                        help="This host's shard of the task stream. "
                             "-1 = derive from jax.process_index().")
    parser.add_argument("--pretrained_extractor_path", type=str, default=None,
                        help="Converted pretrained backbone weights, a flax msgpack file "
                             "(scripts/convert_checkpoint_torch.py, or the JAX package's "
                             "scripts/convert_checkpoint.py). The reference downloads "
                             "timm/CLIP checkpoints at construction.")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="Path to a checkpoint.ckpt to resume training from: the "
                             "port's, or the JAX package's train state (flax msgpack with "
                             "its optax opt_state), mapped onto the port's optimiser by "
                             "parameter name (the reference's load_checkpoint is dead "
                             "code; wired here).")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the run here "
                             "(trace.json; view in Perfetto or chrome://tracing).")
    parser.add_argument("--compile_cache", type=str,
                        default="~/.cache/orbit_tpu/xla",
                        help="JAX persistent compilation cache directory: repeat "
                             "runs skip the 20-40s-per-program XLA compiles "
                             "(one per episode bucket). Empty string disables.")
    parser.add_argument("--batch_videos", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="Predict all of a task's target videos in one device "
                             "batch when they share a padded length (the standard "
                             "protocol pads every clutter video to 200 frames): one "
                             "dispatch per task instead of per video. Per-frame "
                             "inference time is then the batch average. On by "
                             "default (numerically identical to per-video dispatch, "
                             "tests/test_learners.py); --no-batch_videos restores "
                             "per-video dispatch.")
    parser.add_argument("--episode_prefetch", type=int, default=1,
                        help="Pipeline depth for host episode preparation "
                             "(pad + dtype cast + host->device copy) under "
                             "device compute: task t+1 is prepared on a "
                             "background thread while the device computes "
                             "task t. 0 disables (serial prepare). Each "
                             "extra level holds one more task's context "
                             "(and, with --batch_videos, its stacked query "
                             "block) resident in HBM; ragged-bucket query "
                             "videos always transfer one at a time.")
    parser.add_argument("--host_normalize", action="store_true",
                        help="Normalize pixels on the host (the reference's "
                             "transform placement, data/datasets.py:422-431) "
                             "instead of the default uint8 wire format + "
                             "on-device normalization. Pixel values are "
                             "identical either way; the default quarters "
                             "host->device transfer bytes and the "
                             "--frame_cache footprint.")
    parser.add_argument("--frame_cache", type=int, default=0,
                        help="Memoise up to N decoded frames across tasks in the "
                             "test/validation loaders. The CLU-VE protocol samples 50 "
                             "tasks per user from the same videos; the reference "
                             "re-decodes every frame every task (its pipeline hot loop).")
    parser.add_argument("--metrics", nargs="+", type=str, default=["frame_acc"],
                        choices=["frame_acc", "video_acc", "frames_to_recognition"],
                        help="Evaluation metrics. The reference computes all three "
                             "but only wires frame_acc (eval_metrics.py:27-60, "
                             "single-step-learner.py:129-130); here any subset "
                             "can be selected.")

    if learner == "multi-step-learner":
        ft = parser.add_argument_group("Finetuning hyperparameters to use for personalization")
        ft.add_argument("--personalize_num_grad_steps", type=int, default=50)
        ft.add_argument("--personalize_learning_rate", type=float, default=0.001)
        ft.add_argument("--personalize_optimizer", type=str, choices=["sgd", "adam"], default="adam")
        ft.add_argument("--personalize_weight_decay", type=float, default=0.0)
        ft.add_argument("--personalize_extractor_lr_scale", type=float, default=1.0)
        ft.add_argument("--personalize_epsilon", type=float, default=1e-8)
        ft.add_argument("--personalize_betas", type=float, nargs=2, default=(0.9, 0.999))
        ft.add_argument("--personalize_momentum", type=float, default=0.0)

    return parser


def expand_issues(filter_list):
    """Expand the ``no_issues`` / ``mixed_issues`` macro filters
    (reference: utils/args.py:194-199)."""
    if "no_issues" in filter_list:
        return NEGATED_FRAME_ANNOTATION_OPTIONS
    if "mixed_issues" in filter_list:
        return FRAME_ANNOTATION_OPTIONS
    return filter_list


def postprocess_args(args, learner: str = "default"):
    args.train_filter_context = expand_issues(getattr(args, "train_filter_context", []))
    args.train_filter_target = expand_issues(getattr(args, "train_filter_target", []))
    args.test_filter_context = expand_issues(getattr(args, "test_filter_context", []))
    args.test_filter_target = expand_issues(getattr(args, "test_filter_target", []))
    args.frame_norm_method = NORM_METHOD_FOR_EXTRACTOR[args.feature_extractor]
    verify_args(learner, args)
    return args


def verify_args(learner, args):
    red, yellow, end = "\33[31m", "\33[33m", "\33[0m"
    if "train" in args.mode and not args.learn_extractor and not args.adapt_features:
        sys.exit(f'{red}error: at least one of "--learn_extractor" and "--adapt_features" must be used during training{end}')
    if learner == "multi-step-learner":
        if "train" in args.mode:
            sys.exit(f'{red}error: Only "--mode test" is supported for multi-step-learner.py{end}')
        if getattr(args, "with_lite", False):
            print(f'{yellow}warning: "--with_lite" is not relevant for multi-step-learner.py. Normal batching is used instead{end}')


def parse_args(learner: str = "default", argv=None):
    parser = build_parser(learner)
    args = parser.parse_args(argv)
    return postprocess_args(args, learner)
