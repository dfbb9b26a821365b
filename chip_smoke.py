#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``orbit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --seed 7   # another draw of weights, tasks and inputs

Phases, each of which passes or raises:
1. card: the ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``orbit_tpu_torch/csrc``, timed, and the
   registers and spills of the kernels of the bf16 wgmma routes of A, B,
   #4 and #6 and of the f32 routes of A, B, #4 and #6 (from nvcc's
   ``-Xptxas -v`` log);
3. kernels: the wgmma mainloop alone in every operand layout and tile
   width against ``torch.matmul`` on a ragged shape; kernel A (fused qkv
   attention), kernel B (fused MLP block) and
   their backward kernels against their plain PyTorch versions on the card,
   at the ViT-B/32 and ViT-S/32 shapes (B = 256 and a ragged 13, S = 50)
   and at ViT-B/32's 84 px shape (S = 5, with a ragged f32 B = 26: one
   row tile of 25 sequences and one of 1), in f32 and bf16, and #4 and #6
   in f32 at the FineTuner's B = 64 (the weight gradients' K = 3,200
   rows), #4's and #6's f32 lines at B = 13 timed too; the fused
   depthwise tail (#8) at EfficientNet-B0's 8 and EfficientNetV2-S's 4
   stride-1 tail shapes at 224 px and B0's 8 at 84 px (B = 256 and 13,
   f32 and bf16, act1 on and off), beside cuDNN's grouped convolution alone,
   and the Mahalanobis logits (#7, D = 1280: the path's batched query,
   M = 1000 against 16 class slots of which 5 are real, the train path's
   M = 256, 44 and 16 against the same slots, then M = 256 and 13 against
   C = 5 and 10 with one padded class), beside f32 ``torch.bmm``
   on the real classes' products; the attention on a raw qkv
   (#1) and its backward (#2) at the ViT-B/32 and ViT-S/32 shapes (B = 256
   and 13, f32 and bf16), also timed against
   ``F.scaled_dot_product_attention`` and its backward; #1's, #2's,
   #7's, #8's and SDPA's device time from ``torch.profiler``; each timed
   with
   CUDA events at B = 256 and at #7's path shape, beside its bound, and
   repeated to show that a second call gives the same bits, and its share
   of the bound and its time over the plain version's printed (#4's and
   #6's f32 lines at B = 64 and 13 too); A, B, #4 and #6 also back to back (A's
   and B's f32 routes at S = 50 and 5 too), beside cuBLAS bf16 on their
   products alone (x @ W; xn @ W1 and h @ W2; #4's three and #6's five) and
   cuBLAS f32 with TF32 off on the same products at S = 50 and 5 (and
   #4's and #6's at B = 64 and 13), a yardstick the port never calls, and #4 and
   #6 with a ``torch.profiler`` breakdown of one call by launch (bf16 at S
   = 50, f32 at S = 50 and 5 and at B = 64); and A, B, #4 and #6 timed at
   the ViT
   train path's other batch sizes (44, the ragged target batch, and 16,
   the LITE grad subset);
4. ViT path: the CLU-VE test protocol of the port's single-step learner on
   ViT-B/32 at full width (224 px, 12 layers, D = 768; random weights from
   ``--seed``), bf16 compute, proto head, batch 256, over two synthetic
   uint8 tasks made in memory (5 objects, about 8 context clips each, one
   200-frame clutter video per object), through ``pad_episode``, the
   learner's protocol loop and ``TestEvaluator`` to ``results.json``. The
   launch counters must show both kernels in every encoder layer of every
   extractor forward; one task is rerun with the plain versions and must
   agree; task 0 is repeated 10 times, warm, for the median and range of
   query frames/s and time to personalise; a ``torch.profiler`` trace of
   one warm task gives the device time by kernel group and the device's
   idle share.
5. train path: the learner in ``--mode train_test`` on ViT-B/32 at full
   width, bf16 compute with f32 parameters, proto head, ``--with_lite
   --learn_extractor --num_lite_samples 16 --batch_size 256
   --tasks_per_batch 2``, over 4 synthetic uint8 train tasks (about 40
   context and 300 target clips each: one full target batch and a ragged
   tail), one validation task and the test protocol from the final and
   best checkpoints. The launch counters must show both backward kernels
   in every encoder layer of both differentiated forwards of every target
   batch; the losses must be finite and every update must move the
   parameters; on one task, with the same injected subsets, the gradients
   through the kernels must agree with those through the plain versions;
   a ``torch.profiler`` trace of one warm task step; the median and range
   of the time per task step and the peak device memory.
6. SimpleCNAPs path: phase 4's protocol, tasks and checks on
   EfficientNet-B0 at full width (224 px, all 16 MBConv blocks, D = 1280)
   with ``--adapt_features --classifier mahalanobis``: the set encoder, the
   FiLM generator over every tagged BatchNorm and the Mahalanobis head.
   Every BatchNorm's running statistics are calibrated on the first task's
   frames after each weight draw (``calibrate_batchnorm`` through the
   learner's ``after_init`` hook: uncalibrated random weights lose the
   input within a few blocks). The launch counters must show #8 in all 12
   stride-1 tails of every extractor forward and #7 in every predict call.
   Beside the kernels-vs-plain check, phase 7's witness (#8's plain
   version with its f32 stages in f64) against the plain version is
   printed: what a change of f32 rounding alone does to the features, the
   logits and the argmax; and, for every frame whose argmax differs
   between the kernels and the plain versions, the plain logits' top-1 to
   top-2 margin, absolute and in bf16 ulps of the top logit, beside that
   frame's largest kernels-vs-plain logit difference.
7. FiLM train path: SimpleCNAPs meta-training with LITE on EfficientNet-B0
   at full width, through the learner in ``--mode train_test``
   (``--adapt_features --classifier mahalanobis --with_lite
   --num_lite_samples 16 --batch_size 256``, bf16) over phase 5's train
   tasks, calibrated as phase 6. One target batch's gradients of the set
   encoder and the FiLM generator under a fixed upstream gradient of the
   logits, kernels against plain versions, held per tensor in f32 and
   over the whole gradient's norm in bf16, beside a witness (#8's plain
   version with its f32 stages in f64) and a planted fault (a wrong
   border in #8's plain version), which the f32 check must see;
   a ``torch.profiler`` trace of one warm bf16 task step; then the run, whose counters
   must show #8 in every extractor forward and #7 in every head call, whose
   updates must move the trained parameters and leave the frozen extractor
   bit for bit; the median and range of the time per task step and the
   peak device memory.
8. FineTuner+FiLM path: the port's multi-step learner in ``--mode test``
   on ViT-B/32-CLIP at full width (224 px, 12 layers, D = 768, pre-norm,
   LayerNorm eps 1e-5) with ``--adapt_features --classifier linear``, bf16,
   batch 256 and the CLI's defaults (50 Adam steps at lr 0.001), over
   phase 4's two tasks. One inner step's gradients of the head and the
   FiLM leaves under a fixed upstream gradient of the features, kernels
   against plain versions, per tensor within 2^-4 of its largest value;
   the launch counters must show A and B in every layer of every extractor
   forward and #4 and #6 in every layer of every backward (50 a task), and
   no other kernel; every task's head and FiLM leaves must move; the
   results must carry ``task_macs_to_personalise``, and the extractor's
   forward 3.8-5.2 GMACs a frame; task 0 through the plain versions must
   give the same argmax on 99% of the real query frames; the median and
   range of the time to personalise and of query frames/s over warm
   repeats, the peak memory, a ``torch.profiler`` trace of a personalise
   of 5 inner steps (its idle share read against its untraced time too),
   and #4 and #6 by launch at the FineTuner's batch of 64 clips.
9. EfficientNet-B0 FineTuner paths: phase 8's protocol and checks for the
   README's command (``--feature_extractor efficientnet_b0 --classifier
   linear``, frozen extractor: the context embedded once, 50 steps on the
   head) and then with ``--adapt_features`` (the extractor rerun every
   step, #8's plain-recompute backward), calibrated as phase 6; #8 in all
   12 stride-1 tails of every extractor forward; the gradients held to
   phase 7's limits (per tensor 2e-4 in f32, 2^-3 of the norm in bf16).
10. learn_extractor path: phase 5's run on EfficientNet-B0 at full width
   (224 px, all 16 MBConv blocks, D = 1280), bf16, ``--classifier proto
   --with_lite --learn_extractor --num_lite_samples 16 --batch_size 256``
   in ``--mode train_test`` over phase 5's train tasks, calibrated as
   phase 6: every BatchNorm of the train-mode forwards on the masked batch
   statistics, every depthwise tail composed there. Before the run, one
   reduced f32 LITE step on the card against the same step on the CPU
   (the loss, every extractor gradient against its tensor's largest value
   and every running statistic, a mean in units of the running deviation,
   within 2e-4: no kernel runs in a train-mode forward, so this is the
   check of train-mode BatchNorm on the card); a
   ``torch.profiler`` trace of one warm bf16 task step (after an untimed
   first one, which picks cuDNN's algorithms). The counters must show #8
   in all 12 stride-1 tails of every eval forward (validation and test, on
   the learned statistics) and in no train-mode forward; every extractor
   parameter and running statistic must move. On the trained model: one
   f32 eval forward on the learned statistics on the card against the
   same forward on the CPU, stage by stage (stem, each block, head, each
   fed the CPU's input), every stage within 2e-4 of its largest value, as
   the step is held; each
   launch of #8 against its plain version on the same inputs (phase 3's
   limits, f32 and bf16), and the test task end to end through the kernels
   against their plain versions, its argmax on 99% of the real query
   frames held in f32 and printed in bf16 beside the witness's, as phase 9
   (random weights on learned statistics amplify a change of rounding:
   the features and logits are printed); the median and range of the time
   per task step and the peak device memory.
11. pretrained weights through the CLIs: for each upstream format a fake
   checkpoint at the published width and depth, made from ``--seed`` in
   that upstream's key layout (independently of the converter), converted
   by ``scripts/convert_checkpoint_torch.py`` into a flax ``.ckpt`` and
   run in ``--mode test`` by phase 4's protocol, tasks and checks (bf16,
   batch 256, 224 px; 3 warm repeats, traced only in (a)): (a) ViT-S/32
   from a timm ``.pth``, proto, with ``--profile_dir``, whose Chrome trace
   must name kernels A and B; (b) ViT-B/32 from an augreg ``.npz``, proto_cosine;
   (c) ViT-B/32-CLIP from an open_clip ``.bin`` through the multi-step
   learner (the FineTuner, frozen; phase 8's checks); (d) EfficientNetV2-S
   from a timm ``.pth`` with the Mahalanobis head, its BatchNorms
   calibrated after the load (#8 in its 28 stride-1 tails, #7); (e) an
   EfficientNet-B0 CNAPs reference recogniser (``--full_model``: set
   encoder, FiLM generator, Versa) through ``--model_path``, calibrated
   after the load. Each run holds a handful of loaded leaves to the
   upstream tensors after their transposes, bit for bit.
12. the parallel axes: (a)-(c) ``--task_parallel`` on one device through
   the learners' protocols, each against the serial protocol in the same
   call, on phase 4's synthetic tasks (bf16, batch 256, 224 px): (a)
   ViT-B/32 ProtoNets in groups of 4 over 8 tasks; (b) the ViT-B/32-CLIP
   FineTuner with a frozen extractor in groups of 4 over 8 tasks; (c)
   EfficientNet-B0 SimpleCNAPs with FiLM in groups of 2 over 4 tasks,
   calibrated as phase 6. Every grouped run must launch A and B (#8)
   DEPTH times in every extractor forward, the lanes folded into one
   forward without FiLM and run one after another with it, and (c) #7 once
   a lane of every grouped predict; every video's logits within
   PATH_REL_TOL of the serial run's and the argmax on 99% of the frames
   (in (c) printed, and one group held in f32 instead: FiLM values and
   logits within 2e-4 of their largest value, as phases 7 and 9 hold B0);
   then one group's tasks repeated warm, grouped and serially, for the
   median and range of query frames/s and time to personalise, the idle
   share of a traced repeat and the peak memory of each loop. (d) the
   distributed paths in a one-rank NCCL group on the card: an episode-DP
   LITE step on ViT-B/32 (#4, #6) against the serial step, query sharding
   and FineTuner row sharding against their serial counterparts; then a
   two-rank gloo group on the one card (two processes), whose summed
   gradients are held against the serial sum, or whose refusal of CUDA
   tensors is printed.
13. the configurations of the JAX package that no earlier phase runs, each
   through the learner and the CLI's flags at full width with the checks
   of the phase it extends, smallest first (2 warm repeats on the eval
   paths): (a) ViT-B/32 proto in ``--mode test`` at the CLI's default
   ``--compute_dtype float32`` (A's and B's f32 routes on a whole path), at
   224 px and at ``--frame_size 84`` (S = 5), phase 4's checks, its
   repeats timed through the kernels and through the plain versions, and
   the ratio of their query frames/s printed; (b)
   EfficientNet-B0 ProtoNets with ``--learn_extractor`` and no
   ``--with_lite`` at 84 px in f32 (``--mode train_test``), phase 10's
   checks with a non-LITE step on the card against the CPU's and #8 on the
   84 px tails (its K5 tails on 6 x 6 and 3 x 3 frames), the f32 argmax
   printed; (c)
   EfficientNetV2-S SimpleCNAPs (``--adapt_features --classifier
   mahalanobis``, FiLM into the post-affine of #8 in its 28 tails), bf16,
   phase 6's checks; (d) ViT-B/32-CLIP SimpleCNAPs+LITE meta-training
   (FiLM from the set encoder and generator into every LayerNorm, kernel
   B's norm2 affine among them, #4 and #6 in the backward, #7 at D = 768),
   phase 7's checks with a ViT witness and planted fault (kernel B's plain
   forward with its f32 stages in f64; its LayerNorm's statistics over all
   channels but the last), its bf16 gradients printed, then ViT-B/32-CLIP
   CNAPs (Versa) in ``--mode test``; (e) EfficientNetV2-S ProtoNets+LITE
   with ``--learn_extractor`` at batch 256 (train-mode ConvBnAct and
   EdgeResidual blocks on masked batch statistics), phase 10's checks, the
   f32 argmax printed, and its peak memory. Phase 13's
   seconds are printed.
14. the CLI's default ``--compute_dtype float32`` on the two ViT paths that
   run the f32 routes of #4 and #6, at full width through the learners
   and the CLI's flags: (a) ViT-B/32 ProtoNets+LITE in ``--mode
   train_test`` (phase 5's run and checks in f32: the gradients under a
   fixed upstream gradient, kernels against plain, held to 2e-4 of each
   tensor's largest value as the f32 FiLM paths are held; A, B, #4 and #6
   launched as the path's forwards and backwards say), at 224 px and at
   ``--frame_size 84`` (S = 5), with warm repeats of one task step through
   the kernels and through the plain versions, their ratio, the peak
   memory and a traced step's idle share; (b) the ViT-B/32-CLIP
   FineTuner+FiLM in f32 (phase 8's run and launch checks; its first-step
   gradients per tensor within 2e-4 and task 0's argmax on 99% of the
   frames held, as phase 9 holds the B0 FineTuner's), its time to
   personalise through the kernels and through the plain versions, and
   the idle share of a traced short personalise. Phase 14's seconds are
   printed.
15. the entry points of ``graft_entry_torch.py`` and the golden file
   of the JAX package's outputs (``data/golden_torch``,
   ``orbit_tpu_torch/models/golden.py``): (1) ``entry()``, the flagship
   forward (EfficientNet-B0 ProtoNets, f32, 224 px, 16 + 16 frames) on
   the golden file's fake B0, through the kernels and through the plain
   versions (logits within 1e-3 of their largest value, the argmax equal
   on all 16 frames, #8 in both forwards' 12 tails, one warm call timed);
   (2) ``dryrun_multichip(1)`` in a one-rank NCCL group (its six checks,
   A, B, #4 and #6 in the ViT check's gradient, #8 in the eval checks);
   (3) every golden record (features of the five backbones, ViT-B/32 and
   B0 at 84 px, ProtoNets, SimpleCNAPs, CNAPs, the FineTuner, the flagship,
   ViT-B/32 ProtoNets in bf16) through the kernels, and in f32 also
   through the plain versions, against the JAX package's CPU outputs: f32
   within 1e-3 of the largest magnitude with the argmax equal on every
   frame, bf16 within 2^-4 with the argmax printed. Phase 15's seconds and
   the whole script's are printed.

The line before the last is ``{"kernels": [...]}`` (launches: kernels A and
B from phase 4, #4 and #6 from phase 5, #7 and #8 from phase 6; #1 and #2
are on no path and report their launches over phases 4 to 15 together,
which must be 0; their checks and times are phase 3's; ``launches_by_path``
gives every kernel's launches on each path, phases 8 to 15's paths
included, ``gemm_ms`` the cuBLAS yardsticks of A, B, #4 and #6 by dtype
and S, ``float32`` the f32 routes' times at S = 50 and 5, and #4's and
#6's at B = 64 and 13); the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.

    python3 chip_smoke.py --breakdown-only DIR

prints only kernel A's device time and the per-launch breakdown of #4
and #6 (ViT-B/32, B = 256: bf16 and f32 at S = 50, f32 at S = 5; f32 at B =
13 and 44) with the
``orbit_tpu_torch`` package found in DIR (a checkout of another commit, to
set the kernels of two commits side by side in one call).

    python3 chip_smoke.py --kernels-only DIR

prints only phase 3's lines of #1, #2, #8 and #7, and kernel A's and #4's
device time (bf16 and f32), with the package found in DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
SEED = 1991
DEPTH = 12

# Kernel vs plain version on the card. Both sides round at the same points
# and differ in summation order only. f32: 1e-5 relative (plus the same
# absolute term for values near 0). bf16: a sum on either side of a bf16
# rounding boundary rounds one ulp apart (2^-8..2^-7 of a value) and the
# ulp travels on through the later products: two ulps, 2^-6.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -6)}
# The depthwise tail (#8) and the Mahalanobis logits (#7) vs their plain
# versions, against the largest value of the output (DW_TOL, MAHALANOBIS_TOL).
# #8 in f32: summation order of the K*K taps only; bf16: an f32 affine that
# lands on either side of a bf16 rounding boundary flips one ulp of an
# activated input (2^-8..2^-7), which the taps carry into the sum before the
# output rounds once more: 2^-6, as for the other bf16 kernels. #7 (f32
# only): the quadratic form's D*D terms summed in another order, and they
# cancel (the precisions have both signs off the diagonal): 1e-5 of the
# largest logit.
DW_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
MAHALANOBIS_TOL = 1e-5
# Backward kernels vs plain versions, per gradient tensor against its
# largest value (the parameter gradients are sums over all B*S rows). f32:
# summation order only; a sum over 12,800 rows of random-sign terms keeps
# its error near 1e-6 of its size: 1e-5. bf16: both sides round qkv, p, ds,
# dqkv, xn, hg and dhpre at the same points; a sum on either side of a bf16
# boundary flips one ulp (2^-8..2^-7) of that element, and the flips feed
# the later products: 2^-6, as for the forward kernels.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# Main path, kernels vs plain versions through all 12 bf16 layers: per-op
# differences of an ulp feed the residual stream layer after layer; allow
# 2^-4 of the largest value for features and logits, and require the same
# argmax on at least 99% of the real query frames. The train path's
# gradients, through 12 layers forward and back, are held to the same 2^-4
# of each tensor's largest value.
PATH_REL_TOL = 2.0 ** -4
# The FiLM train path's gradients under a fixed upstream gradient, kernels
# vs plain versions. In f32, per tensor against its largest value:
# summation order only (#8's K*K taps, #7's D*D terms, which cancel),
# carried back through 16 blocks, the heads' inverse and the generators.
# On an H100, over --seed 1991, 7 and 12345: the kernels read 1.5e-5 to
# 2.4e-5, #8's plain version with its f32 stages in f64 (the witness)
# 1.4e-5 to 2.3e-5, and a wrong border in #8 2.1e-3 to 2.7e-3: held to
# 2e-4, and the wrong border must read above it. Phase 14 holds the f32 ViT
# paths (the LITE step's and the FineTuner's gradients) to the same limit.
F32_PATH_GRAD_TOL = 2e-4
# In bf16, against the whole gradient's norm: a one-ulp flip of an
# activation travels back through 16 blocks into per-channel sums that
# cancel. Over the same seeds the witness reads 2.8e-2 to 9.2e-2 of the
# norm (up to 0.30 of a tensor's largest value), the kernels 3.0e-2 to
# 5.4e-2: held to 2^-3. A wrong border (4.3e-2 to 5.0e-2) hides in this
# noise; the f32 check sees it.
BF16_PATH_GRAD_NORM_TOL = 2.0 ** -3
ARGMAX_AGREEMENT = 0.99
# warm repeats of one task for the eval paths' median metrics
PATH_REPEATS = 10
# warm repeats of one task's personalise and predict on the FineTuner
# paths: each personalise is 50 inner steps, so fewer repeats
FT_REPEATS = 3
# inner steps of the FineTuner personalise that phases 8 and 9 trace
TRACE_STEPS = 5
# ViT-B/32's forward MACs a frame at 224 px: the envelope of
# tests/test_macs_oracle_scale.py (about 4.4 G)
VIT_B_FRAME_MACS = (3.8e9, 5.2e9)

KERNELS = {
    "fused_qkv_attention": ("orbit_tpu_torch/csrc/fused_qkv_attention.cu",
                            "orbit_tpu/ops/tiny_attention.py:344"),
    "fused_mlp_block": ("orbit_tpu_torch/csrc/mlp_block.cu",
                        "orbit_tpu/ops/mlp_block.py:102"),
    "fused_qkv_attention_bwd": ("orbit_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
                                "orbit_tpu/ops/tiny_attention.py:392"),
    "fused_mlp_block_bwd": ("orbit_tpu_torch/csrc/mlp_block_bwd.cu",
                            "orbit_tpu/ops/mlp_block.py:172"),
    "mahalanobis_logits": ("orbit_tpu_torch/csrc/mahalanobis.cu",
                           "orbit_tpu/ops/mahalanobis.py:47"),
    "fused_dw_act": ("orbit_tpu_torch/csrc/depthwise.cu",
                     "orbit_tpu/ops/depthwise.py:81"),
    "tiny_attention": ("orbit_tpu_torch/csrc/tiny_attention.cu",
                       "orbit_tpu/ops/tiny_attention.py:114"),
    "tiny_attention_bwd": ("orbit_tpu_torch/csrc/tiny_attention.cu",
                           "orbit_tpu/ops/tiny_attention.py:247"),
}
# EfficientNet-B0's stride-1 depthwise tails at 224 px, one extractor
# forward: (H = W, C, K, act1) -> tails of that shape
B0_DW_TAILS = {(112, 32, 3, False): 1, (56, 144, 3, True): 1, (28, 240, 5, True): 1,
               (14, 480, 3, True): 2, (14, 480, 5, True): 1, (14, 672, 5, True): 2,
               (7, 1152, 5, True): 3, (7, 1152, 3, True): 1}
B0_DW_PER_FORWARD = sum(B0_DW_TAILS.values())  # 12
# the same tails at --frame_size 84 (the stem's 42 px, then 21, 11, 6 and
# 3): the K5 tails at 6 x 6 and 3 x 3 take a TF-SAME pad as wide as the
# frame itself
B0_DW_TAILS_84 = {(42, 32, 3, False): 1, (21, 144, 3, True): 1, (11, 240, 5, True): 1,
                  (6, 480, 3, True): 2, (6, 480, 5, True): 1, (6, 672, 5, True): 2,
                  (3, 1152, 5, True): 3, (3, 1152, 3, True): 1}
# EfficientNetV2-S's stride-1 depthwise tails at 224 px (all in its
# InvertedResidual stages; orbit_tpu_torch/models/backbones/efficientnet.py
# V2_S_ARCH): 28 a forward
V2S_DW_TAILS = {(14, 512, 3, True): 5, (14, 768, 3, True): 1, (14, 960, 3, True): 8,
                (7, 1536, 3, True): 14}
V2S_DW_PER_FORWARD = sum(V2S_DW_TAILS.values())  # 28
# The least time one H100 SXM could take (NVIDIA's data sheet, dense peaks
# at the full 700 W): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
# outside them, 3.35 TB/s of device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


# the kernels of the bf16 wgmma routes of A, B, #4 and #6 (csrc/wgmma.cuh),
# of the f32 routes of A, B, #4 and #6 (csrc/sgemm.cuh, csrc/sgemm_grads.cuh),
# the mainloop's layout check and the bf16 kernels of #1 and #2, whose
# registers and spills phase 2 prints from nvcc's -Xptxas -v output
REGISTER_KERNELS = ("fused_qkv_attention_wgmma_kernel", "fused_mlp_block_layernorm_kernel",
                    "fused_mlp_block_gemm_kernel", "fused_qkv_attention_f32_kernel",
                    "fused_mlp_block_sgemm_kernel", "qkv_recompute_kernel",
                    "attention_bwd_mma_kernel", "mlp_bwd_hidden_kernel", "grads_kernel",
                    "layer_norm_kernel", "layer_norm_backward_kernel", "wgmma_check_kernel",
                    "tiny_attention_tile_kernel", "tiny_attention_bwd_mma_kernel",
                    "qkv_attention_bwd_f32_kernel", "mlp_bwd_hidden_f32_kernel",
                    "sgemm_grads_kernel")


def print_registers(log: Path, names) -> None:
    """Registers, spills and stack of every entry function in nvcc's log
    whose name contains one of ``names`` (one line per instantiation)."""
    import re
    lines = log.read_text().splitlines() if log.exists() else []
    seen = set()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        # the longest name: attention_bwd_mma_kernel is inside tiny_attention_bwd_mma_kernel
        name = max((n for n in names if m and n in m.group(1)), key=len, default=None)
        if name is None or m.group(1) in seen:
            continue
        seen.add(m.group(1))
        # the template arguments: a width, an epilogue, a storage type, the
        # mainloop's operand layouts
        args = [a for pat in (r"I(f)[EL]", r"I13__nv_(bfloat16)", r"Li(\d+)E",
                              r"(GeluStore(?:F32)?|ResidualStore(?:F32)?)")
                for a in re.findall(pat, m.group(1))]
        args = ["float" if a == "f" else a for a in args]
        args += ["K" if a == "0" else "MN" for a in
                 re.findall(r"L(?:N5orbit2wg5MajorE|S\d*_)(\d)E", m.group(1))]
        tag = "<" + ",".join(args) + ">" if args else ""
        info = " ".join(x.split("ptxas info    : ")[-1].strip() for x in lines[i + 1:i + 4]
                        if "bytes stack" in x or "Used" in x)
        print(f"  {name}{tag}: {info}")
    if not seen:
        print(f"  registers: no entry in {log} (nvcc's log not found)")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, calls: int = 20, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn`` over ``calls`` calls enqueued back to
    back between two CUDA events, as the layers of a forward run: the
    host's time before a call's first launch hides behind the previous
    call's kernels, where ``cuda_ms``'s single calls include it."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def compare(ours, ref, rtol: float, atol: float, what: str):
    """Assert |ours - ref| <= atol + rtol * |ref| everywhere; return
    (max abs error, max abs error / max |ref|)."""
    import torch
    a, b = ours.float(), ref.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (a - b).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(b.abs().max()), 1e-30)
    if not bool((err <= atol + rtol * b.abs()).all()):
        raise AssertionError(f"{what}: kernel and plain version differ: max abs "
                             f"{max_abs:.3e}, max rel {max_rel:.3e} "
                             f"(rtol {rtol}, atol {atol})")
    return max_abs, max_rel


def compare_grads(ours, ref, tol: float, what: str) -> float:
    """Assert, for every tensor, max |ours - ref| <= tol * max |ref|; return
    the largest absolute error."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(ours, ref)):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what}: output {i} has shape {tuple(a.shape)} "
                                 f"(plain {tuple(b.shape)}) or non-finite values")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if err > tol * scale:
            raise AssertionError(f"{what}: output {i} differs from the plain version "
                                 f"by {err:.3e}, more than {tol} x {scale:.3e}")
        worst = max(worst, err)
    return worst


def worst_rel(ours, ref) -> float:
    """The largest, over tensors, of max |ours - ref| / max |ref|."""
    return max(float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(ours, ref))


def norm_rel(ours, ref) -> float:
    """|ours - ref| / |ref| over all tensors together (Euclidean norms)."""
    diff = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(ours, ref))
    return math.sqrt(diff / max(sum(float(b.float().square().sum()) for b in ref), 1e-30))


@contextlib.contextmanager
def dw_plain_as(fn):
    """#8's plain version replaced by ``fn`` (None keeps it) in the op's
    forward and in its backward's recompute."""
    from orbit_tpu_torch.ops import depthwise
    plain = depthwise.fused_dw_reference
    depthwise.fused_dw_reference = fn or plain
    try:
        yield
    finally:
        depthwise.fused_dw_reference = plain


@contextlib.contextmanager
def mlp_plain_as(fn):
    """Kernel B's plain forward replaced by ``fn`` (None keeps it); its
    plain backward stays the analytic one, which recomputes the true
    forward from the saved input."""
    from orbit_tpu_torch.ops import mlp_block
    plain = mlp_block.mlp_block_reference
    mlp_block.mlp_block_reference = fn or plain
    try:
        yield
    finally:
        mlp_block.mlp_block_reference = plain


def mlp_variant(x, ln_scale, ln_bias, w1, b1, w2, b2, *, ln_eps: float,
                wide: bool = False, short_norm: bool = False):
    """Kernel B's plain forward (``mlp_block_reference``) with one change.
    ``wide`` computes its f32 stages (the LayerNorm, both products, the
    GELU, the residual) in f64 and keeps its rounding points to x's dtype.
    ``short_norm`` is a planted fault: the LayerNorm's mean and variance
    over all channels but the last, as a column tile's edge left out."""
    import torch

    dt = x.dtype
    acc = torch.float64 if wide else torch.float32
    xf = x.to(acc)
    cols = xf[..., :-1] if short_norm else xf
    mean = cols.mean(dim=-1, keepdim=True)
    var = ((cols - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + ln_eps) * ln_scale.to(acc)
          + ln_bias.to(acc)).to(dt).to(acc)
    hpre = torch.matmul(xn, w1.to(dt).to(acc)) + b1.to(acc)
    hg = (0.5 * hpre * (1.0 + torch.erf(hpre * 0.5 ** 0.5))).to(dt).to(acc)
    return (torch.matmul(hg, w2.to(dt).to(acc)) + b2.to(acc) + xf).to(dt)


def dw_variant(x, w, a1, b1, a2, b2, *, act1: bool, act2: bool, wide: bool = False,
               raw_border: bool = False):
    """#8's plain version (``fused_dw_reference``) with one change. ``wide``
    computes its f32 stages (the affines, the SiLUs, the K*K tap sum) in
    f64 and keeps its bf16 rounding points: every f32 rounding moves, as
    the kernel's FMA order moves them. ``raw_border`` is a planted fault:
    the border is padded before the pre-affine and SiLU, so it holds
    act1(b1) where TF-SAME holds zeros."""
    import torch
    import torch.nn.functional as F

    from orbit_tpu_torch.ops.depthwise import tf_same_pads
    dt, (n, h, wd, c), k = x.dtype, x.shape, w.shape[0]
    acc = torch.float64 if wide else torch.float32
    (top, bottom), (left, right) = tf_same_pads(h, k, 1), tf_same_pads(wd, k, 1)
    pad = (0, 0, left, right, top, bottom)  # NHWC
    if raw_border:
        x = F.pad(x, pad)
    a = x.to(acc) * a1.to(acc) + b1.to(acc)
    if act1:
        a = F.silu(a)
    a = a.to(dt).to(acc)
    if not raw_border:
        a = F.pad(a, pad)
    taps = w.to(dt).to(acc).permute(3, 2, 0, 1)  # (C, 1, K, K)
    y = F.conv2d(a.permute(0, 3, 1, 2), taps, groups=c).permute(0, 2, 3, 1)
    y = y * a2.to(acc) + b2.to(acc)
    if act2:
        y = F.silu(y)
    return y.to(dt).contiguous()


def bound(name: str, b: int, s: int, d: int, dtype_name: str):
    """(least milliseconds, "bytes" or "operations") for one call of kernel
    ``name`` at B = b, S = s, width d (hidden 4d) in ``dtype_name``: the
    larger of its multiply-add operations over the card's peak for the type
    and the bytes it must move (each input read once, each output written
    once) over the memory rate."""
    rows, h, e = b * s, 4 * d, (2 if dtype_name == "bfloat16" else 4)
    if name == "fused_qkv_attention":      # qkv product + q k^T and p v per head
        flops = 2 * rows * d * 3 * d + 4 * b * s * s * d
        nbytes = e * (2 * rows * d + 3 * d * d + 3 * d)
    elif name == "fused_mlp_block":        # fc1 and fc2
        flops = 4 * rows * d * h
        nbytes = e * (2 * rows * d + 2 * d * h) + 4 * (3 * d + h)
    elif name == "fused_qkv_attention_bwd":  # recompute, dx, dW + 5 attention products
        flops = 3 * 2 * rows * d * 3 * d + 10 * b * s * s * d
        nbytes = e * (3 * rows * d + 3 * d * d + 3 * d) + 4 * (3 * d * d + 3 * d)
    else:                                  # fc1 recompute, dhg, dxn, dW1, dW2
        flops = 5 * 2 * rows * d * h
        nbytes = (e * (3 * rows * d + 2 * d * h) + 4 * (3 * d + h)
                  + 4 * (2 * d * h + h + 3 * d))
    return _roofline(flops, nbytes, PEAK_FLOPS[dtype_name])


def _roofline(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_dw(n: int, h: int, c: int, k: int, dtype_name: str):
    """The bound of one depthwise-tail call on (n, h, h, c): 2 K^2 FLOPs an
    output on the CUDA cores (the f32 peak whatever the storage type);
    the activation read and the output written once, f32 taps and affines."""
    e = 2 if dtype_name == "bfloat16" else 4
    return _roofline(2 * k * k * n * h * h * c, e * 2 * n * h * h * c + 4 * (k * k * c + 4 * c),
                     PEAK_FLOPS["float32"])


def bound_mahalanobis(m: int, d: int, c: int, real: int):
    """The bound of one Mahalanobis-logits call with ``real`` of its ``c``
    classes real (a padded class's logit is -1e30 whatever its statistics):
    2 M D^2 f32 FLOPs a real class; the features and the real classes'
    means and precisions read and all M x C logits written once."""
    return _roofline(2 * m * d * d * real, 4 * (m * d + real * d + real * d * d + m * c),
                     PEAK_FLOPS["float32"])


def kernel_phase(torch, card: str) -> dict:
    """Phase 3: every kernel against its plain version at the path's shapes."""
    from orbit_tpu_torch.ops import (fused_mlp_block, fused_mlp_block_backward,
                                     fused_qkv_attention, fused_qkv_attention_backward)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    print(f"kernels vs plain PyTorch (card: {card}):")
    # S = 50 at 224 px; S = 5 at --frame_size 84 (2 x 2 patches and the
    # class token), where a row tile of A holds many more sequences
    for vit, d, heads, s in (("vit_b_32", 768, 12, 50), ("vit_s_32", 384, 6, 50),
                             ("vit_b_32", 768, 12, 5)):
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            rtol, atol = KERNEL_TOL[dtype_name]
            # B 26 at S 5 (f32): one row tile of 25 sequences and one of 1;
            # B 64 at S 50 (f32, the backward kernels): the FineTuner's
            # context batch, whose weight gradients walk K = 3,200 rows
            batches = (256, 13)
            if dtype_name == "float32" and vit == "vit_b_32":
                batches += (26,) if s == 5 else (64,)
            for b in batches:
                x = randn(b, s, d).to(dt)
                cot = randn(b, s, d).to(dt)
                qkv = (randn(d, 3 * d, scale=d ** -0.5).to(dt), randn(3 * d, scale=0.1).to(dt))
                mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
                       randn(d, 4 * d, scale=d ** -0.5).to(dt), randn(4 * d, scale=0.02),
                       randn(4 * d, d, scale=(4 * d) ** -0.5).to(dt), randn(d, scale=0.02))
                runs = {
                    "fused_qkv_attention": lambda impl: fused_qkv_attention(
                        x, *qkv, heads, impl=impl),
                    "fused_mlp_block": lambda impl: fused_mlp_block(
                        x, *mlp, ln_eps=1e-6, impl=impl),
                    "fused_qkv_attention_bwd": lambda impl: fused_qkv_attention_backward(
                        x, *qkv, cot, heads, impl=impl),
                    "fused_mlp_block_bwd": lambda impl: fused_mlp_block_backward(
                        x, *mlp[:5], cot, ln_eps=1e-6, impl=impl),
                }
                for name, run in runs.items():
                    if b == 26 and name.endswith("_bwd"):
                        continue  # the ragged tiles are the forward routes'
                    if b == 64 and not name.endswith("_bwd"):
                        continue  # the FineTuner's shape is the backward routes'
                    with torch.inference_mode():
                        ours, ref = run(None), run("reference")
                    torch.cuda.synchronize()
                    where = f"{name} {vit} {dtype_name} B={b}" + (f" S={s}" if s != 50 else "")
                    if name.endswith("_bwd"):
                        max_abs = compare_grads(ours, ref, GRAD_TOL[dtype_name], where)
                        line = f"  {where}: max abs {max_abs:.3e}"
                    else:
                        max_abs, max_rel = compare(ours, ref, rtol, atol, where)
                        line = f"  {where}: max abs {max_abs:.3e}, max rel {max_rel:.3e}"
                    # the f32 backward routes are timed at the small batches too
                    time_it = b == 256 or (b in (64, 13) and dtype_name == "float32"
                                           and name.endswith("_bwd"))
                    if time_it or b == 26:
                        with torch.inference_mode():
                            again = run(None)
                            torch.cuda.synchronize()
                            outs = ours if isinstance(ours, tuple) else (ours,)
                            agains = again if isinstance(again, tuple) else (again,)
                            if not all(torch.equal(u, v) for u, v in zip(outs, agains)):
                                raise AssertionError(f"{where}: a second call gave other bits")
                        line += "; same bits on a repeat"
                    if time_it:
                        with torch.inference_mode():
                            ms = cuda_ms(lambda: run(None))
                            plain_ms = cuda_ms(lambda: run("reference"))
                        bound_ms, bound_by = bound(name, b, s, d, dtype_name)
                        line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                                 f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% of "
                                 f"it), kernel over plain {ms / plain_ms:.3f}")
                        timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
                        if b != 256:
                            if vit == "vit_b_32":
                                rows[name].setdefault("float32", {})[f"S={s} B={b}"] = timed
                        elif vit == "vit_b_32" and (dtype_name, s) != ("bfloat16", 5):
                            # the calls enqueued back to back, as a forward's
                            # layers enqueue them (f32: the forward routes)
                            if dtype_name == "bfloat16" or not name.endswith("_bwd"):
                                with torch.inference_mode():
                                    timed["back_to_back_ms"] = cuda_ms_back_to_back(
                                        lambda: run(None))
                                line += f"; back to back {timed['back_to_back_ms']:.4f} ms a call"
                            if dtype_name == "bfloat16":
                                rows[name].update(timed)
                            else:
                                rows[name].setdefault("float32", {})[f"S={s}"] = timed
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_abs)
                    print(line)
                if (b == 256 and (dtype_name, s) != ("bfloat16", 5)
                        and (vit == "vit_b_32" or dtype_name == "float32")) or (
                        b in (64, 13) and dtype_name == "float32"):
                    gemm_yardstick(torch, rows, x, qkv, mlp, cot,
                                   f"{dtype_name} S={s}" + (f" B={b}" if b != 256 else "")
                                   + ("" if vit == "vit_b_32" else " ViT-S/32"),
                                   f"{'ViT-B/32' if vit == 'vit_b_32' else 'ViT-S/32'} B={b}")
                if vit == "vit_b_32" and b in (256, 64) and (dtype_name, s) != ("bfloat16", 5):
                    for name in ("fused_qkv_attention_bwd", "fused_mlp_block_bwd"):
                        launch_breakdown(torch, lambda: runs[name](None), name, card,
                                         dtype="bf16" if dtype_name == "bfloat16" else "f32",
                                         shape=f"ViT-B/32 B={b}" + (f" S={s}" if s != 50 else ""))
    train_shapes_phase(torch, randn)
    return rows


def gemm_yardstick(torch, rows: dict, x, qkv, mlp, cot, key: str,
                   shape: str = "ViT-B/32 B=256") -> None:
    """cuBLAS on the ViT kernels' products alone, at their inputs, in x's
    dtype (f32 with TF32 off, as configure_matmul_precision sets it): A's
    x @ W; B's xn @ W1 and h @ W2 (xn and h from the staged plain
    version); #4's x @ W, cast(dqkv) @ W^T and x^T @ cast(dqkv), #6's xn @
    W1, g @ W2^T, cast(dhpre) @ W1^T, xn^T @ cast(dhpre) and hg^T @ g (the
    operands from the staged plain backwards; a transpose is cuBLAS's
    operand flag, no copy); at the f32 backward kernels' B = 64 and 13 (a
    ``key`` naming B) only #4's and #6's. A yardstick of what a library GEMM gives
    at these shapes, kept in each row's ``gemm_ms`` under ``key``; the
    port never calls it."""
    from orbit_tpu_torch.ops.mlp_block import mlp_block_backward_stages, mlp_block_stages
    from orbit_tpu_torch.ops.tiny_attention import qkv_attention_backward_stages
    if x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick must run with TF32 off")
    x2 = x.reshape(-1, x.shape[-1])
    heads = x.shape[-1] // 64
    with torch.inference_mode():
        xn, h, _ = mlp_block_stages(x, *mlp, ln_eps=1e-6)
        xn, h = xn.reshape(x2.shape), h.reshape(x2.shape[0], -1)
        w1, w2 = mlp[2].contiguous(), mlp[4].contiguous()
        w = qkv[0].contiguous()
        products = {} if "B=" in key else {
            "fused_qkv_attention": {"x @ W": (x2, w)},
            "fused_mlp_block": {"xn @ W1": (xn, w1), "h @ W2": (h, w2)}}
        (_, hg, dhb, _), _ = mlp_block_backward_stages(x, *mlp[:5], cot, ln_eps=1e-6)
        hg, dhb = hg.reshape(h.shape), dhb.reshape(h.shape)
        (_, dqkv), _ = qkv_attention_backward_stages(x, *qkv, cot, heads)
        g2 = cot.reshape(x2.shape)
        products.update({
            "fused_qkv_attention_bwd": {"x @ W": (x2, w), "dqkv @ W^T": (dqkv, w.t()),
                                        "x^T @ dqkv": (x2.t(), dqkv)},
            "fused_mlp_block_bwd": {"xn @ W1": (xn, w1), "g @ W2^T": (g2, w2.t()),
                                    "dhb @ W1^T": (dhb, w1.t()),
                                    "xn^T @ dhb": (xn.t(), dhb), "hg^T @ g": (hg.t(), g2)}})
        for name, prods in products.items():
            ms = {p: cuda_ms(lambda a=a, b=b: torch.matmul(a, b)) for p, (a, b) in prods.items()}
            rows[name].setdefault("gemm_ms", {})[key] = sum(ms.values())
            if key == "bfloat16 S=50":
                rows[name]["yardstick_ms"] = sum(ms.values())
            print(f"  cuBLAS {key} yardstick (never called by the port), {shape}, "
                  f"{name}: " + " + ".join(f"{p} {t:.4f}" for p, t in ms.items())
                  + f" = {sum(ms.values()):.4f} ms")


def launch_breakdown(torch, fn, label: str, card: str, calls: int = 5,
                     dtype: str = "bf16", shape: str = "ViT-B/32 B=256") -> None:
    """``calls`` warm calls of ``fn`` under ``torch.profiler``: each
    launch's device time per call and its share of the call's device
    time, the launches in the order of their time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            times[evt.key] = times.get(evt.key, 0.0) + us / 1e3 / calls
    total = sum(times.values())
    if total <= 0:
        print(f"  {label} by launch ({card}): the profiler recorded no device time (not measured)")
        return
    print(f"  {label} by launch, {shape} {dtype}, device time a call {total:.4f} ms "
          f"({card}):")
    for key, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:.4f} ms ({100 * ms / total:.1f}%)  {key[:100]}")


def breakdown_only(torch, root: Path) -> None:
    """``--breakdown-only``: kernel A's device time and the per-launch
    breakdown of #4 and #6 (bf16 and f32 at B 256, S 50; f32 at S 5, and at
    B 13 and 44) with the ``orbit_tpu_torch`` package under ``root``."""
    sys.path.insert(0, str(root))
    import orbit_tpu_torch
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    from orbit_tpu_torch.ops import fused_mlp_block_backward, fused_qkv_attention_backward
    configure_matmul_precision()
    card = card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d = 768

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    x, cot = randn(256, 50, d).bfloat16(), randn(256, 50, d).bfloat16()
    mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, 4 * d, scale=d ** -0.5).bfloat16(), randn(4 * d, scale=0.02),
           randn(4 * d, d, scale=(4 * d) ** -0.5).bfloat16())
    print(f"orbit_tpu_torch from {Path(orbit_tpu_torch.__file__).parent} ({card})")
    vit_attention_device_time(torch, card)
    launch_breakdown(torch, lambda: fused_mlp_block_backward(x, *mlp, cot, ln_eps=1e-6),
                     "fused_mlp_block_bwd", card)
    # the f32 routes: #6 at S 50, both at S 5 (#4's f32 S 50 is above)
    xf, cf, mf = x.float(), cot.float(), tuple(t.float() for t in mlp)
    launch_breakdown(torch, lambda: fused_mlp_block_backward(xf, *mf, cf, ln_eps=1e-6),
                     "fused_mlp_block_bwd", card, dtype="f32")
    x5, c5 = randn(256, 5, d), randn(256, 5, d)
    w = (randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1))
    launch_breakdown(torch, lambda: fused_qkv_attention_backward(x5, *w, c5, d // 64),
                     "fused_qkv_attention_bwd", card, dtype="f32", shape="ViT-B/32 B=256 S=5")
    launch_breakdown(torch, lambda: fused_mlp_block_backward(x5, *mf, c5, ln_eps=1e-6),
                     "fused_mlp_block_bwd", card, dtype="f32", shape="ViT-B/32 B=256 S=5")
    # and both at phase 3's ragged B 13 and the f32 train path's B 44
    for b in (13, 44):
        xb, cb = randn(b, 50, d), randn(b, 50, d)
        launch_breakdown(torch, lambda: fused_qkv_attention_backward(xb, *w, cb, d // 64),
                         "fused_qkv_attention_bwd", card, dtype="f32", shape=f"ViT-B/32 B={b}")
        launch_breakdown(torch, lambda: fused_mlp_block_backward(xb, *mf, cb, ln_eps=1e-6),
                         "fused_mlp_block_bwd", card, dtype="f32", shape=f"ViT-B/32 B={b}")


def mainloop_layout_phase(torch, card: str) -> None:
    """Phase 3, first: the wgmma mainloop alone (csrc/wgmma_check.cu) in
    every (A major, B major, tile width) against torch.matmul of the same
    bf16 operands on a ragged M = 200, N = 320, K = 328: exact products,
    f32 sums in another order, within 1e-5 of the largest value."""
    import itertools

    from orbit_tpu_torch.kernels import build as kbuild
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(200, 328, generator=g, device=dev).bfloat16()
    b = torch.randn(328, 320, generator=g, device=dev).bfloat16()
    ref = a.float() @ b.float()
    parts = []
    for a_mn, b_k, bn in itertools.product((False, True), (False, True), (128, 192)):
        c = kbuild.mainloop_product(a.t().contiguous() if a_mn else a,
                                    b.t().contiguous() if b_k else b, a_mn=a_mn, b_k=b_k, bn=bn)
        torch.cuda.synchronize()
        rel = float((c - ref).abs().max()) / float(ref.abs().max())
        what = f"A {'MN' if a_mn else 'K'}-major, B {'K' if b_k else 'MN'}-major, BN {bn}"
        if not rel <= 1e-5:
            raise AssertionError(f"wgmma mainloop, {what}: differs from torch.matmul by {rel:.3e} "
                                 f"of the largest value")
        parts.append(f"{what} {rel:.2e}")
    print(f"wgmma mainloop vs torch.matmul, M=200 N=320 K=328 ({card}), max rel: "
          + "; ".join(parts))


# the batch sizes besides 256 at which the ViT-B/32 train path runs kernels
# A, B, #4 and #6: the ragged target batch (300 target clips: 256 + 44) and
# the 16-clip LITE grad subset
TRAIN_BATCHES = (44, 16)


def train_shapes_phase(torch, randn) -> None:
    """Phase 3, the ViT kernels' time per launch at the train path's other
    batch sizes (bf16, ViT-B/32), beside their bounds: launches x (time -
    bound) at each shape is the path's loss."""
    from orbit_tpu_torch.ops import (fused_mlp_block, fused_mlp_block_backward,
                                     fused_qkv_attention, fused_qkv_attention_backward)
    d, heads, dt = 768, 12, torch.bfloat16
    for b in TRAIN_BATCHES:
        x, cot = randn(b, 50, d).to(dt), randn(b, 50, d).to(dt)
        qkv = (randn(d, 3 * d, scale=d ** -0.5).to(dt), randn(3 * d, scale=0.1).to(dt))
        mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
               randn(d, 4 * d, scale=d ** -0.5).to(dt), randn(4 * d, scale=0.02),
               randn(4 * d, d, scale=(4 * d) ** -0.5).to(dt), randn(d, scale=0.02))
        runs = {"fused_qkv_attention": lambda: fused_qkv_attention(x, *qkv, heads),
                "fused_mlp_block": lambda: fused_mlp_block(x, *mlp, ln_eps=1e-6),
                "fused_qkv_attention_bwd": lambda: fused_qkv_attention_backward(
                    x, *qkv, cot, heads),
                "fused_mlp_block_bwd": lambda: fused_mlp_block_backward(
                    x, *mlp[:5], cot, ln_eps=1e-6)}
        parts = []
        for name, run in runs.items():
            with torch.inference_mode():
                ms = cuda_ms(run)
            bound_ms, bound_by = bound(name, b, 50, d, "bfloat16")
            parts.append(f"{name} {ms:.4f} ms (bound {bound_ms:.4f}, {bound_by})")
        print(f"  ViT-B/32 bf16 B={b}: " + "; ".join(parts))


def _repeat_check(torch, run, ours, where: str) -> None:
    again = run(None)
    torch.cuda.synchronize()
    if not torch.equal(ours, again):
        raise AssertionError(f"{where}: a second call gave other bits")


def device_ms(torch, fn, match: str, calls: int = 10, sessions: int = 3) -> float:
    """Device time a call of ``fn``'s kernels whose names contain ``match``,
    from ``torch.profiler`` over ``calls`` warm calls: the kernels alone,
    without the host's time before a launch, which single calls timed with
    CUDA events include. The median over ``sessions`` sessions: on an H100
    one session in a few hundred recorded no kernel, or only some kernels
    of a call of several."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(evt.self_device_time_total for evt in prof.key_averages()
                 if evt.device_type == torch.autograd.DeviceType.CUDA and match in evt.key)
        if us > 0:
            times.append(us / 1e3 / calls)
    if not times:
        raise AssertionError(f"the profiler recorded no device time for kernels named {match} "
                             f"in {sessions} sessions")
    return statistics.median(times)


def dw_kernel_phase(torch, card: str) -> dict:
    """Phase 3, #8: the depthwise tail against its plain version at every
    stride-1 shape of B0 and V2-S at 224 px and of B0 at 84 px (B 256 and
    13, f32 and bf16, both act1);
    at B 256 the kernel's device time (``device_ms``), a single call's time,
    the plain version's, cuDNN's grouped convolution alone on a
    channels-last view (a yardstick the port never calls: the convolution
    without the affines and SiLUs) and the bound. Returns the JSON row with
    the bf16 times summed over the 12 tails of one B0 forward."""
    import torch.nn.functional as F

    from orbit_tpu_torch.ops import fused_dw_act

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    row = {"max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "yardstick_ms": 0.0}
    bound_by = set()
    sums = {}
    for net, tails in (("B0", B0_DW_TAILS), ("V2-S", V2S_DW_TAILS),
                       ("B0 84px", B0_DW_TAILS_84)):
        for (h, c, k, path_act1), count in tails.items():
            for dtype_name in ("float32", "bfloat16"):
                dt = getattr(torch, dtype_name)
                for b in (256, 13):
                    x = torch.randn(b, h, h, c, generator=g, device=dev).to(dt)
                    w = 0.3 * torch.randn(k, k, 1, c, generator=g, device=dev)
                    aff = [1 + 0.2 * torch.randn(c, generator=g, device=dev),
                           0.2 * torch.randn(c, generator=g, device=dev),
                           1 + 0.2 * torch.randn(c, generator=g, device=dev),
                           0.2 * torch.randn(c, generator=g, device=dev)]
                    for act1 in (path_act1, not path_act1):
                        def run(impl, act1=act1):
                            return fused_dw_act(x, w, *aff, act1=act1, impl=impl)
                        ours, ref = run(None), run("reference")
                        torch.cuda.synchronize()
                        where = (f"fused_dw_act {net} {h}x{h}x{c} K{k} act1={act1} "
                                 f"{dtype_name} B={b}")
                        max_abs = compare_grads([ours], [ref], DW_TOL[dtype_name], where)
                        row["max_abs_err"] = max(row["max_abs_err"], max_abs)
                        line = (f"  {where}: max abs {max_abs:.3e} "
                                f"({max_abs / float(ref.float().abs().max()):.2e} of the largest)")
                        if b == 256 and act1 == path_act1:
                            _repeat_check(torch, run, ours, where)
                            ms = device_ms(torch, lambda: run(None), "fused_dw")
                            call_ms = cuda_ms(lambda: run(None))
                            plain_ms = cuda_ms(lambda: run("reference"))
                            xc = x.permute(0, 3, 1, 2)             # NCHW, channels last
                            wc = w.to(dt).permute(3, 2, 0, 1).contiguous()
                            conv_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=k // 2,
                                                               groups=c))
                            bound_ms, by = bound_dw(b, h, c, k, dtype_name)
                            line += (f"; kernel {ms:.4f} ms on the device ({100 * bound_ms / ms:.1f}%"
                                     f" of the bound), {call_ms:.4f} ms a call, plain "
                                     f"{plain_ms:.4f} ms, cuDNN conv alone {conv_ms:.4f} ms, "
                                     f"bound {bound_ms:.4f} ms ({by}), x{count} a forward, same "
                                     f"bits on a repeat ({card})")
                            key = (net, dtype_name)
                            total = sums.setdefault(key, [0.0, 0.0, 0.0])
                            total[0] += count * ms
                            total[1] += count * bound_ms
                            total[2] += count * conv_ms
                            if net == "B0" and dtype_name == "bfloat16":
                                for name, v in (("ms", ms), ("call_ms", call_ms),
                                                ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                                                ("yardstick_ms", conv_ms)):
                                    row[name] += count * v
                                bound_by.add(by)
                        print(line)
                    del x
    row["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
    for (net, dtype_name), (ms, bound_ms, conv_ms) in sums.items():
        print(f"  fused_dw_act, the tails of one {net} forward at B=256 {dtype_name} ({card}): "
              f"kernel {ms:.4f} ms on the device, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}%), cuDNN conv alone {conv_ms:.4f} ms")
    return row


# #7's shapes as (C, real classes, [M, ...]); the first is the SimpleCNAPs
# path's: each task's 5 videos x 200 frames in one batched predict call
# against the episode's 16 class slots (pad_episode's MAX_WAY), 5 of them
# real; its row in the kernels line is taken there. Then the FiLM train
# path's target batches (256 and 44 of 300 clips, 16 in a LITE subset)
# against the same slots.
MAHALANOBIS_SHAPES = ((16, 5, (1000, 256, 44, 16)), (5, 4, (256, 13)), (10, 9, (256, 13)))


def mahalanobis_kernel_phase(torch, card: str) -> dict:
    """Phase 3, #7: the Mahalanobis logits against their plain version; at
    M != 13 the kernels' device time, a single call's time, the plain
    version's, true-f32 ``torch.bmm`` of the real classes' diffs and
    precisions (the product alone: a yardstick the port never calls) and
    the bound."""
    from orbit_tpu_torch.ops import mahalanobis_logits

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d = 1280
    row = {"max_abs_err": 0.0}
    for c, real, ms_ in MAHALANOBIS_SHAPES:
        # symmetric positive-definite precisions, as the head makes them
        a = torch.randn(c, d, 2 * d, generator=g, device=dev) / math.sqrt(2 * d)
        prec = torch.linalg.inv(a @ a.transpose(1, 2) + torch.eye(d, device=dev))
        del a
        means = 0.5 * torch.randn(c, d, generator=g, device=dev)
        mask = (torch.arange(c, device=dev) < real).float()  # the rest padded
        for m in ms_:
            f = torch.randn(m, d, generator=g, device=dev)

            def run(impl):
                return mahalanobis_logits(f, means, prec, mask, 0.5, impl=impl)
            ours, ref = run(None), run("reference")
            torch.cuda.synchronize()
            where = f"mahalanobis_logits M={m} D={d} C={c} ({real} real)"
            if not bool((ours[:, real:] == -1e30).all()):
                raise AssertionError(f"{where}: a padded class is not -1e30")
            max_abs = compare_grads([ours[:, :real]], [ref[:, :real]], MAHALANOBIS_TOL, where)
            row["max_abs_err"] = max(row["max_abs_err"], max_abs)
            line = (f"  {where}: max abs {max_abs:.3e} "
                    f"({max_abs / float(ref[:, :real].abs().max()):.2e} of the largest)")
            if m != 13:
                _repeat_check(torch, run, ours, where)
                ms = device_ms(torch, lambda: run(None), "mahalanobis")
                call_ms, plain_ms = cuda_ms(lambda: run(None)), cuda_ms(lambda: run("reference"))
                diffs = (f[None] - means[:real, None]).contiguous()
                bmm_ms = cuda_ms(lambda: torch.bmm(diffs, prec[:real]))
                del diffs
                bound_ms, by = bound_mahalanobis(m, d, c, real)
                line += (f"; kernel {ms:.4f} ms on the device ({100 * bound_ms / ms:.1f}% of "
                         f"the bound), {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms, f32 "
                         f"bmm alone {bmm_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), same "
                         f"bits on a repeat ({card})")
                if "ms" not in row:
                    row.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=by, yardstick_ms=bmm_ms)
            print(line)
    return row


def kernels_only(torch, root: Path) -> None:
    """``--kernels-only``: phase 3's checks and times of #1 and #2, #8 and
    #7, and the device time of kernel A and of #4's launches, with the
    ``orbit_tpu_torch`` package under ``root``."""
    sys.path.insert(0, str(root))
    import orbit_tpu_torch
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    configure_matmul_precision()
    card = card_line()
    print(f"orbit_tpu_torch from {Path(orbit_tpu_torch.__file__).parent} ({card})")
    attention_kernel_phase(torch, card)
    vit_attention_device_time(torch, card)
    dw_kernel_phase(torch, card)
    mahalanobis_kernel_phase(torch, card)


def vit_attention_device_time(torch, card: str) -> None:
    """Kernel A's and #4's device time at ViT-B/32, B = 256, bf16 and f32
    (A's launch; #4 by launch), the kernels whose attention stages #1 and
    #2 share: ``--kernels-only`` and ``--breakdown-only`` set two packages
    side by side."""
    from orbit_tpu_torch.ops import fused_qkv_attention, fused_qkv_attention_backward
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, heads = 768, 12
    x = torch.randn(256, 50, d, generator=g, device=dev)
    cot = torch.randn(256, 50, d, generator=g, device=dev)
    qkv = (torch.randn(d, 3 * d, generator=g, device=dev) * d ** -0.5,
           torch.randn(3 * d, generator=g, device=dev) * 0.1)
    for dtype_name, short in (("bfloat16", "bf16"), ("float32", "f32")):
        dt = getattr(torch, dtype_name)
        xd, cd, qd = x.to(dt), cot.to(dt), tuple(t.to(dt) for t in qkv)
        with torch.inference_mode():
            ms = device_ms(torch, lambda: fused_qkv_attention(xd, *qd, heads),
                           "fused_qkv_attention")
        print(f"  fused_qkv_attention vit_b_32 {dtype_name} B=256: kernel {ms:.4f} ms on the "
              f"device ({card})")
        launch_breakdown(torch, lambda: fused_qkv_attention_backward(xd, *qd, cd, heads),
                         "fused_qkv_attention_bwd", card, dtype=short)


def bound_attention(backward: bool, b: int, s: int, d: int, dtype_name: str):
    """The bound of one call of the attention on a raw qkv (#1) or its
    backward (#2) at B = b, S = s, width d: q k^T and p v a head (4 S^2 D
    FLOPs a batch row), five such products in the backward (the scores
    recomputed, dp, dv, dq, dk); qkv read and the output written once (the
    backward also reads g and writes dqkv)."""
    e = 2 if dtype_name == "bfloat16" else 4
    flops = (10 if backward else 4) * b * s * s * d
    nbytes = e * b * s * d * (7 if backward else 4)
    return _roofline(flops, nbytes, PEAK_FLOPS[dtype_name])


def attention_kernel_phase(torch, card: str) -> dict:
    """Phase 3, #1 and #2: the attention on a raw qkv and its backward
    against their plain versions at the ViT-B/32 and ViT-S/32 shapes (B 256
    and a ragged 13, S 50), f32 and bf16; at B 256 the same bits on a
    repeat, the kernel's device time (``device_ms``: the kernel alone) and
    a single call's, the plain version's time, and
    ``F.scaled_dot_product_attention``'s device time (every kernel of one
    call: its attention kernels, layout copies and, in the backward, dqkv's
    assembly) and single call's, beside the bound. Rows of the kernels line
    from ViT-B/32 bf16."""
    import torch.nn.functional as F

    from orbit_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_backward

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {name: {"max_abs_err": 0.0} for name in ("tiny_attention", "tiny_attention_bwd")}
    for vit, d, heads in (("vit_b_32", 768, 12), ("vit_s_32", 384, 6)):
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            for b in (256, 13):
                qkv = (0.5 * torch.randn(b, 50, 3 * d, generator=g, device=dev)).to(dt)
                cot = torch.randn(b, 50, d, generator=g, device=dev).to(dt)
                runs = {"tiny_attention": lambda impl: tiny_attention(qkv, heads, impl=impl),
                        "tiny_attention_bwd": lambda impl: tiny_attention_backward(
                            qkv, cot, heads, impl=impl)}
                for name, run in runs.items():
                    ours, ref = run(None), run("reference")
                    torch.cuda.synchronize()
                    where = f"{name} {vit} {dtype_name} B={b}"
                    if name == "tiny_attention":
                        max_abs, max_rel = compare(ours, ref, *KERNEL_TOL[dtype_name], where)
                        line = f"  {where}: max abs {max_abs:.3e}, max rel {max_rel:.3e}"
                    else:
                        max_abs = compare_grads([ours], [ref], GRAD_TOL[dtype_name], where)
                        line = f"  {where}: max abs {max_abs:.3e}"
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_abs)
                    if b == 256:
                        _repeat_check(torch, run, ours, where)
                        ms = device_ms(torch, lambda: run(None), "tiny_attention")
                        call_ms = cuda_ms(lambda: run(None))
                        plain_ms = cuda_ms(lambda: run("reference"))
                        # the same function in one library call: SDPA on
                        # (B, H, S, hd) views of q, k and v (no copy)
                        leaf = qkv.detach().requires_grad_(name == "tiny_attention_bwd")
                        q, k, v = leaf.view(b, 50, 3, heads, 64).permute(2, 0, 3, 1, 4)
                        if name == "tiny_attention":
                            def library():
                                return F.scaled_dot_product_attention(q, k, v)
                        else:
                            out = F.scaled_dot_product_attention(q, k, v)
                            up = cot.view(b, 50, heads, 64).transpose(1, 2)

                            def library():
                                return torch.autograd.grad(out, leaf, up, retain_graph=True)
                        library_ms = device_ms(torch, library, "")
                        library_call_ms = cuda_ms(library)
                        bound_ms, by = bound_attention(name.endswith("_bwd"), b, 50, d, dtype_name)
                        line += (f"; kernel {ms:.4f} ms on the device ({100 * bound_ms / ms:.1f}% "
                                 f"of the bound), {call_ms:.4f} ms a call, plain {plain_ms:.4f} "
                                 f"ms, SDPA {library_ms:.4f} ms on the device, "
                                 f"{library_call_ms:.4f} ms a call, bound {bound_ms:.4f} ms "
                                 f"({by}), same bits on a repeat ({card})")
                        if vit == "vit_b_32" and dtype_name == "bfloat16":
                            rows[name].update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                              bound_ms=bound_ms, bound_by=by,
                                              library_ms=library_ms)
                        del leaf, q, k, v
                        if name == "tiny_attention_bwd":
                            del out
                    print(line)
    return rows


def synthetic_tasks(num_tasks: int = 2, frame_size: int = 224,
                    video_frames: int = 200, seed: int | None = None):
    """Test-mode task dicts (orbit_tpu/data/loader.py:229-247 keys) with
    uint8 frames made in memory: per object a colour and a stripe pattern
    plus noise, about 8 context clips and one clutter video of
    ``video_frames`` frames."""
    import numpy as np

    rng = np.random.default_rng(SEED if seed is None else seed)
    shots = (8, 7, 9, 8, 8)
    root = "/synthetic/test"
    yy = np.arange(frame_size)[:, None, None]
    tasks = []
    for t in range(num_tasks):
        user = f"P9{t:02d}"
        objects = [f"object{i}" for i in range(len(shots))]
        bases = rng.integers(40, 216, size=(len(shots), 3))

        def frames(i, n):
            base = bases[i]
            stripes = ((yy // (8 + 6 * i)) % 2) * 30
            noise = rng.integers(-20, 21, size=(n, frame_size, frame_size, 3))
            return np.clip(base + stripes + noise, 0, 255).astype(np.uint8)

        ctx, ctx_paths, ctx_labels, videos, video_paths = [], [], [], [], []
        for i, (obj, shot) in enumerate(zip(objects, shots)):
            clean = f"{user}--{obj}--clean--V0"
            ctx.append(frames(i, shot))
            ctx_paths += [f"{root}/{user}/{obj}/clean/{clean}/{clean}-{f + 1:05d}.jpg"
                          for f in range(shot)]
            ctx_labels += [i] * shot
            clutter = f"{user}--{obj}--clutter--V0"
            videos.append(frames(i, video_frames))
            video_paths.append(np.array(
                [f"{root}/{user}/{obj}/clutter/{clutter}/{clutter}-{f + 1:05d}.jpg"
                 for f in range(video_frames)]))
        tasks.append({
            "context_clips": np.concatenate(ctx)[:, None],          # (N, 1, H, W, 3)
            "context_paths": np.array(ctx_paths)[:, None],
            "context_labels": np.array(ctx_labels, np.int64),
            "context_annotations": {},
            "object_list": objects,
            "task_id": user,
            "target_clips": videos,
            "target_paths": video_paths,
            "target_labels": [np.int64(i) for i in range(len(objects))],
            "target_annotations": {},
        })
    return tasks


def synthetic_train_tasks(num_tasks: int = 4, frame_size: int = 224,
                          seed: int | None = None, target_shots: int = 60):
    """Train-mode task dicts (the loader's train keys: flat target clips)
    with uint8 frames made in memory, 5 objects each: 8 context clips and
    ``target_shots`` target clips per object (40 and 300 a task by default).
    A task's objects share one colour and differ by at most 2 levels per
    channel under noise of +-20, so the random-weight recogniser's logits
    stay within about ten of each other: the loss and its gradients do not
    saturate (distinct objects give logits hundreds apart and a loss of 0)."""
    import numpy as np

    rng = np.random.default_rng(SEED if seed is None else seed)
    tasks = []
    for _ in range(num_tasks):
        colours = rng.integers(60, 190, size=3) + rng.integers(-2, 3, size=(5, 3))

        def clips(labels):
            noise = rng.integers(-20, 21, size=(len(labels), frame_size, frame_size, 3))
            return np.clip(colours[labels][:, None, None] + noise,
                           0, 255).astype(np.uint8)[:, None]   # (N, 1, H, W, 3)

        ctx_labels = np.repeat(np.arange(5), 8)
        tgt_labels = np.repeat(np.arange(5), target_shots)
        tasks.append({"context_clips": clips(ctx_labels), "context_labels": ctx_labels,
                      "target_clips": clips(tgt_labels), "target_labels": tgt_labels})
    return tasks


class TaskQueue:
    """The episodic-queue surface the learner's protocol loop reads, over
    tasks held in memory (one task per user)."""

    def __init__(self, tasks):
        self.tasks = tasks
        self.num_users = len(tasks)
        self.loader = SimpleNamespace(_cache_cap=0)

    def num_local_tasks(self) -> int:
        return len(self.tasks)

    def get_tasks(self):
        return iter(self.tasks)


def recorded_run(torch, learner):
    """``learner.run()`` with the train step (LITE or not) recording every
    task's loss and every optimiser update checked: it must move a
    parameter, and no frozen parameter (``requires_grad`` off) may change by
    a bit. The launch counts are set to 0 just before the run and read just
    after it. Returns (losses, per update (tensors moved, tensors with a
    nonzero gradient, tensors), launches)."""
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import steps as steps_lib

    losses, moved = [], []
    build_lite, build_plain = steps_lib.build_train_task_lite, steps_lib.build_train_task
    build_update = steps_lib.build_apply_update

    def recorded(build):
        def build_recorded(recogniser, a):
            fn = build(recogniser, a)

            def run(*xs, **kw):
                loss, logits = fn(*xs, **kw)
                losses.append(float(loss))
                return loss, logits
            return run
        return build_recorded

    def checked_update(optimizer):
        apply = build_update(optimizer)
        params = [p for group in optimizer.param_groups for p in group["params"]]

        def run():
            had_grad = [p.grad is not None and bool(p.grad.abs().max() > 0) for p in params]
            before = [p.detach().clone() for p in params]
            apply()
            changed = [not torch.equal(b, p) for b, p in zip(before, params)]
            if not any(changed):
                raise AssertionError("an optimiser update moved no parameter")
            if any(c and not p.requires_grad for c, p in zip(changed, params)):
                raise AssertionError("an optimiser update moved a frozen parameter")
            moved.append((sum(changed), sum(had_grad), len(params)))
        return run

    steps_lib.build_train_task_lite = recorded(build_lite)
    steps_lib.build_train_task = recorded(build_plain)
    steps_lib.build_apply_update = checked_update
    kbuild.reset_launch_counts()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        steps_lib.build_train_task_lite, steps_lib.build_train_task = build_lite, build_plain
        steps_lib.build_apply_update = build_update
    return losses, moved, dict(kbuild.LAUNCHES)


def train_path_phase(torch, card: str, workdir: Path, extractor: str = "vit_b_32",
                     frame_size: int = 224, target_shots: int = 60,
                     dtype: str = "bfloat16", lite: bool = True,
                     argmax_held: bool = True, plain_repeats: int = 0) -> dict:
    """Phases 5, 10, 13 (b, e) and 14 (a): the port's ProtoNets meta-training path
    with ``--learn_extractor`` (ViT-B/32 at 224 px, bf16, with
    ``--with_lite`` unless told otherwise) in ``--mode train_test``. Before
    the run, on the ViT, one task's gradients through the kernels against
    those through the plain versions; on an EfficientNet (phases 10 and
    13), whose train-mode forwards launch no kernel, one f32 step (LITE or
    not, as the run) on the card against the same step on the CPU
    (:func:`card_vs_cpu_step`), with every BatchNorm calibrated after each
    weight draw as in phase 6. Then one warm step traced, and the run.
    ``argmax_held``: on an EfficientNet, whether the f32 test task's argmax
    is held (:func:`effnet_train_checks`) or printed. ``plain_repeats``:
    after the run, that many warm repeats of the first task's step through
    the kernels and then through the plain versions, and their ratio."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import EfficientNet, calibrate_batchnorm
    from orbit_tpu_torch.models.backbones.vit import ViT
    from orbit_tpu_torch.utils.args import parse_args

    effnet = extractor.startswith("efficientnet")
    if not (effnet or lite):
        raise ValueError("the ViT train path runs with LITE (phase 5)")
    batch, num_lite = 256, 16
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "train_test", "--feature_extractor", extractor, "--classifier", "proto",
        "--compute_dtype", dtype, "--batch_size", str(batch),
        "--frame_size", str(frame_size), *(["--with_lite"] if lite else []),
        "--learn_extractor", "--num_lite_samples", str(num_lite),
        "--tasks_per_batch", "2", "--epochs", "1", "--num_train_tasks", "1",
        "--num_val_tasks", "1", "--num_test_tasks", "1", "--seed", str(SEED)])
    train_tasks = synthetic_train_tasks(frame_size=frame_size, target_shots=target_shots)
    test_tasks = synthetic_tasks(2, frame_size, seed=SEED + 2)
    after_init = None
    if effnet:
        # every task's context frames, as phase 7
        frames = torch.from_numpy(np.concatenate([t["context_clips"][:, 0]
                                                  for t in train_tasks]))

        def after_init(rec):
            calibrate_batchnorm(rec.extractor,
                                rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
    learner = SingleStepLearner(
        args, train_queue=TaskQueue(train_tasks),
        validation_queue=TaskQueue(synthetic_tasks(1, frame_size, seed=SEED + 1)),
        test_queue=TaskQueue(test_tasks), after_init=after_init)
    batches = [math.ceil(len(t["target_labels"]) / batch) for t in train_tasks]
    rec = learner.recogniser
    episode = learner._train_episode(pad_episode(train_tasks[0]))
    gen = torch.Generator().manual_seed(SEED)
    subsets = [steps_lib.lite_grad_subset(gen, episode["context_mask"], num_lite)
               for _ in range(batches[0])]
    if lite:
        step = functools.partial(steps_lib.build_train_task_lite(rec, args), episode,
                                 grad_idxs=subsets)
    else:
        step = functools.partial(steps_lib.build_train_task(rec, args), episode)
    if effnet:
        card_vs_cpu_step(torch, learner, train_tasks[0], card, lite)
        # the first train-mode step picks cuDNN's algorithms for its
        # shapes: not a warm step
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        print(f"  first {dtype} task step (cold): {time.perf_counter() - t0:.2f} s")
    else:
        vit_step_kernels_vs_plain(torch, rec, args, episode, subsets, batch, card,
                                  F32_PATH_GRAD_TOL if dtype == "float32" else PATH_REL_TOL)
    # one warm step under the profiler: device time by kernel group and the
    # device's idle share
    device_breakdown(torch, step, card)
    rec.zero_grad(set_to_none=True)

    # the learner's run, with its updates and losses checked; extractor
    # forwards counted by mode (the MACs counter's run on a meta copy, the
    # calibration's take the composed route; neither launches a kernel)
    forwards = {"train": 0, "eval": 0}
    model = EfficientNet if effnet else ViT
    model_forward = model.forward

    def counted_forward(self, x, *a, **kw):
        if x.device.type != "meta" and kw.get("impl") != "composed":
            forwards["train" if kw.get("train") else "eval"] += 1
        return model_forward(self, x, *a, **kw)

    initial = {k: v.detach().to("cpu", copy=True) for k, v in rec.extractor.state_dict().items()}
    model.forward = counted_forward
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        losses, moved, launches = recorded_run(torch, learner)
    finally:
        model.forward = model_forward
    wall = time.perf_counter() - t0

    if len(losses) != len(train_tasks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if len(moved) != math.ceil(len(train_tasks) / args.tasks_per_batch):
        raise AssertionError(f"{len(moved)} optimiser updates")
    if not Path(learner.test_evaluator.json_results_path).exists():
        raise AssertionError("the test protocol after training wrote no results.json")
    if effnet:
        if lite:  # per task the cache pass, then the grad subset and the batch
            train_forwards = len(train_tasks) + 2 * sum(batches)
        else:  # the context and the target rows, a forward a chunk, each
            # chunk recomputed in the backward where there are more than one
            def chunked(n):
                chunks = math.ceil(n / batch)
                return chunks * (2 if chunks > 1 else 1)
            train_forwards = sum(chunked(pad_episode(t).context_clips.shape[0])
                                 + chunked(len(t["target_labels"])) for t in train_tasks)
        effnet_train_checks(torch, learner, launches, forwards, initial, test_tasks[0],
                            train_forwards, card, argmax_held)
    else:
        vit_train_checks(launches, forwards["eval"] + forwards["train"], batches, batch,
                         num_lite, train_tasks)
    print(f"  {len(train_tasks)} tasks, {sum(batches)} target batches, {len(moved)} "
          f"updates (parameter tensors moved, with a nonzero gradient, in all: "
          f"{moved}), losses "
          f"{[round(x, 6) for x in losses]}, extractor forwards {forwards}, "
          f"wall {wall:.2f} s")
    print_step_times(torch, learner.train_step_seconds, card)
    if plain_repeats:
        step_kernels_vs_plain_times(torch, rec, step, plain_repeats, card)
    return launches


def step_kernels_vs_plain_times(torch, rec, step, repeats: int, card: str) -> None:
    """``repeats`` warm calls of one task's step (its gradients, each call
    ended by a device sync) through the kernels, then through the plain
    versions: the median and range of each and the ratio of the medians."""
    medians = {}
    for impl in (None, "reference"):
        rec.impl = impl
        ms = []
        for _ in range(repeats + 1):  # the first call of a route is not timed
            rec.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        ms = ms[1:]
        medians[impl] = statistics.median(ms)
        print(f"  task 0's step repeated {repeats}x, warm, "
              f"{'the plain versions' if impl else 'kernels'}: median {medians[impl]:.2f} ms "
              f"({min(ms):.2f}-{max(ms):.2f}) ({card})")
    rec.impl = None
    rec.zero_grad(set_to_none=True)
    print(f"  ms a task step, kernels over the plain versions: "
          f"{medians[None] / medians['reference']:.3f} ({card})")


def vit_step_kernels_vs_plain(torch, rec, args, episode, subsets, batch: int,
                              card: str, limit: float = PATH_REL_TOL) -> None:
    """Phase 5: one task, the same injected subsets, through the kernels and
    through the plain versions. (a) The whole LITE step: its losses and its
    gradients' largest difference, per tensor against its largest value,
    are printed. They are not held to PATH_REL_TOL: the proto logits are
    about a hundred times their spread across classes (|f|^2 is about D),
    so the bf16 drift of the features through 12 layers (about 1e-2 of
    their size, phase 4) moves the logits by about 1 and reweights the
    loss's softmax by tens of percent, whatever the kernels do. (b) The
    step's two differentiated forwards (its grad subset and its first
    target batch) under one fixed upstream gradient of the features, which
    takes that sensitivity out: held per tensor to ``limit`` (PATH_REL_TOL
    in bf16, F32_PATH_GRAD_TOL in f32, where the two routes differ in
    summation order only)."""
    from orbit_tpu_torch.learners import steps as steps_lib

    dev = episode["context_clips"].device
    step = steps_lib.build_train_task_lite(rec, args)
    forwards_in = (episode["context_clips"][subsets[0].to(dev)],
                   episode["target_clips"][:batch])
    g = torch.Generator(device=dev).manual_seed(SEED)
    upstream = [torch.randn(c.shape[0], rec.output_size, generator=g, device=dev)
                for c in forwards_in]
    grads, fixed, step_loss = {}, {}, {}
    for impl in (None, "reference"):
        rec.impl = impl
        rec.zero_grad(set_to_none=True)
        step_loss[impl] = float(step(episode, grad_idxs=subsets)[0])
        grads[impl] = [p.grad.clone() for p in rec.extractor.parameters()]
        rec.zero_grad(set_to_none=True)
        sum((rec.embed_clips(c, with_grad=True) * u).sum()
            for c, u in zip(forwards_in, upstream)).backward()
        fixed[impl] = [p.grad.clone() for p in rec.extractor.parameters()]
    rec.impl = None
    rec.zero_grad(set_to_none=True)
    step_worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                     for a, b in zip(grads[None], grads["reference"]))
    worst = compare_grads(fixed[None], fixed["reference"], limit,
                          "gradients under a fixed upstream gradient, kernels vs plain")
    print(f"train path, {rec.dtype} (card: {card}): one task's LITE step loss {step_loss[None]:.6f} "
          f"with the kernels, {step_loss['reference']:.6f} plain; its gradients differ "
          f"by at most {step_worst:.3e} of a tensor's largest value")
    print(f"  under a fixed upstream gradient: {len(fixed[None])} gradient tensors agree "
          f"within {limit} of their largest value (worst {worst_rel(fixed[None], fixed['reference']):.3e}), "
          f"max abs {worst:.3e}")


def vit_train_checks(launches: dict, forwards: int, batches, batch: int, num_lite: int,
                     train_tasks) -> None:
    """Phase 5's launch counts: both differentiated forwards of a target
    batch (the grad subset and the target clips) run both backward kernels
    once per encoder layer, and every extractor forward runs both forward
    kernels once per layer."""
    for name in ("fused_qkv_attention_bwd", "fused_mlp_block_bwd"):
        if launches[name] != DEPTH * 2 * sum(batches):
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{DEPTH} x 2 x {sum(batches)} target batches")
    sizes = [min(batch, len(t["target_labels"]) - i * batch)
             for t in train_tasks for i in range(math.ceil(len(t["target_labels"]) / batch))]
    by_size = {n: DEPTH * sizes.count(n) for n in sorted(set(sizes), reverse=True)}
    print(f"  #4 and #6 launches by batch size: {by_size} (target batches), "
          f"{num_lite}: {DEPTH * len(sizes)} (grad subsets)")
    for name in ("fused_qkv_attention", "fused_mlp_block"):
        if launches[name] != DEPTH * forwards:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{DEPTH} x {forwards} extractor forwards")


def card_vs_cpu_step(torch, learner, task: dict, card: str, lite: bool = True) -> None:
    """Phase 10's check of train-mode BatchNorm on the card (and phase 13's,
    without LITE where the run has none): one f32 step of copies of the
    learner's recogniser on the card and on the CPU, on a reduced task at
    the run's frame size (5 context clips padded to 8, 4 target clips
    padded to 8, batch 4; with LITE 2 samples, the subsets injected): with
    LITE the context's second chunk and the second target batch hold
    padding only, so the step runs the masked statistics, the all-padding
    fallback and a padding-only batch's subset pass; without, the context
    runs as two checkpointed chunks (the second of one real clip and three
    pads), recomputed in the backward. The loss, every extractor gradient
    (against its tensor's largest value, at least 1e-2 of the step's
    largest gradient) and every running statistic after the step (a mean in
    units of the running deviation, a variance against itself) are held to
    F32_PATH_GRAD_TOL: in f32 the two sides differ in summation order
    only. No kernel runs in a train-mode forward, so the card's step is held
    against the CPU's rather than against its own plain version."""
    import copy

    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps as steps_lib

    ctx = np.concatenate([np.nonzero(task["context_labels"] == c)[0][:1] for c in range(5)])
    tgt = np.concatenate([np.nonzero(task["target_labels"] == c)[0][:1] for c in range(4)])
    small = {"context_clips": task["context_clips"][ctx],
             "context_labels": task["context_labels"][ctx],
             "target_clips": task["target_clips"][tgt],
             "target_labels": task["target_labels"][tgt]}
    ep = learner._train_episode(pad_episode(small, size_buckets=(8,)))
    a = SimpleNamespace(tasks_per_batch=2, num_lite_samples=2, batch_size=4,
                        learn_extractor=True)
    gen = torch.Generator().manual_seed(SEED)
    subsets = [steps_lib.lite_grad_subset(gen, ep["context_mask"], a.num_lite_samples)
               for _ in range(2)]
    out = []
    for where in (learner.device, torch.device("cpu")):
        rec = copy.deepcopy(learner.recogniser).to(where)
        rec.dtype = rec.extractor.dtype = torch.float32
        rec.batch_size = a.batch_size
        rec.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        here = {k: v.to(where) for k, v in ep.items()}
        if lite:
            loss, _ = steps_lib.build_train_task_lite(rec, a)(here, grad_idxs=subsets)
        else:
            loss, _ = steps_lib.build_train_task(rec, a)(here)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        out.append((loss, {n: p.grad.cpu() for n, p in rec.extractor.named_parameters()},
                    {n: b.cpu() for n, b in rec.extractor.named_buffers()}, seconds))
        del rec
    (loss, grads, stats, s_card), (loss_cpu, grads_cpu, stats_cpu, s_cpu) = out
    loss_rel = abs(loss - loss_cpu) / max(abs(loss_cpu), 1e-30)
    if loss_rel > F32_PATH_GRAD_TOL:
        raise AssertionError(f"f32 step loss on the card {loss:.7f}, on the CPU "
                             f"{loss_cpu:.7f}: {loss_rel:.3e} apart")
    # A tensor whose exact gradient is zero holds rounding noise only: the
    # bias of a BatchNorm that reaches the loss through linear maps into
    # train-mode BatchNorms only (bn3 of every InvertedResidual block, bn2
    # of the DepthwiseSeparable one), which subtract any constant shift. As
    # in the CPU tests, a gradient's scale is at least 1e-2 of the step's
    # largest gradient. The running means are read in units of the running
    # deviation sqrt(var + eps), the variances relative to themselves, as
    # tests/test_torch_learn_extractor.py reads them.
    largest = max(float(g.abs().max()) for g in grads_cpu.values())

    def scale(name, ref):
        if name in grads_cpu:
            return torch.clamp(ref.abs().max(), min=1e-2 * largest)
        if name.endswith(".mean"):
            return (stats_cpu[name[:-len("mean")] + "var"] + 1e-3).sqrt()
        return ref.abs()

    worst = {}
    for kind, ours, ref in (("gradients", grads, grads_cpu),
                            ("running statistics", stats, stats_cpu)):
        rel = {}
        for name, b in ref.items():
            a = ours[name]
            if not torch.isfinite(a).all():
                raise AssertionError(f"f32 step on the card: non-finite {name}")
            rel[name] = float(((a - b).abs() / scale(name, b)).max())
        name = max(rel, key=rel.get)
        worst[kind] = (name, rel[name])
        if rel[name] > F32_PATH_GRAD_TOL:
            raise AssertionError(f"f32 step {kind}, card vs CPU: {name} differs by "
                                 f"{rel[name]:.3e} of its scale, more than {F32_PATH_GRAD_TOL}")
    print(f"{learner.args.feature_extractor} learn_extractor path (card: {card}): one "
          f"reduced f32 {'LITE' if lite else 'non-LITE'} step (5 + 3 pad context, 4 + 4 pad "
          f"target clips, batch 4, {ep['context_clips'].shape[2]} px) on the card against the "
          f"CPU: loss {loss:.7f} vs {loss_cpu:.7f} ({loss_rel:.3e} apart); " + "; ".join(
              f"{len(grads if kind == 'gradients' else stats)} extractor {kind} within "
              f"{F32_PATH_GRAD_TOL} of their scale (worst {r:.3e}, {name})"
              for kind, (name, r) in worst.items())
          + f"; {s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU")


def effnet_train_checks(torch, learner, launches: dict, forwards: dict, initial: dict,
                        test_task: dict, train_forwards: int, card: str,
                        argmax_held: bool = True) -> None:
    """Phase 10's checks after the run: #8 in all 12 stride-1 tails of every
    eval forward (validation and test, on the learned statistics) and in no
    train-mode forward (``train_forwards``: per task the cache pass and two
    a target batch); every extractor parameter and running statistic moved
    from its calibrated initial value; on the model the test protocol ran
    last (the best validation checkpoint), in f32 and in bf16, every launch
    of #8 in one eval forward against its plain version on the same inputs
    (phase 3's DW_TOL); and the test task end to end through the kernels
    against their plain versions, its argmax held in f32 as phase 9 holds
    the B0 FineTuner's, and printed in bf16 beside the witness's (#8's plain
    version with its f32 stages in f64: a change of f32 rounding alone).
    The learned statistics are moving averages of batch statistics, not
    the eval frames' own (phase 6 calibrates on them), and random weights
    amplify the difference block after block: the features reach about
    1e5, and the witness moves them by 8% in f32 and 43% in bf16 (PERF.md
    §6), so the features and logits are printed, not held. Where the
    witness flips the f32 argmax too (B0 at 84 px without LITE: 0.9% of
    the frames; V2-S: 25.2%; PERF.md §6), ``argmax_held`` off prints
    it; the stage-by-stage forward and #8's launches stay held."""
    import copy

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.models import convert

    per_forward = dw_per_forward(learner.args.feature_extractor)
    if forwards["train"] != train_forwards:
        raise AssertionError(f"{forwards['train']} train-mode extractor forwards, expected "
                             f"{train_forwards}")
    if launches["fused_dw_act"] != per_forward * forwards["eval"]:
        raise AssertionError(f"fused_dw_act: {launches['fused_dw_act']} launches, expected "
                             f"{per_forward} x {forwards['eval']} eval forwards and none "
                             f"in the {forwards['train']} train-mode forwards")
    final = convert.load(learner.checkpoint_path_final)
    kinds = {"parameters": [k for k, _ in learner.recogniser.extractor.named_parameters()],
             "running statistics": [k for k, _ in learner.recogniser.extractor.named_buffers()]}
    for kind, keys in kinds.items():
        still = [k for k in keys if torch.equal(final[f"extractor.{k}"], initial[k])]
        if still:
            raise AssertionError(f"{len(still)} of {len(keys)} extractor {kind} did not move "
                                 f"in training: {still[:4]}")
    print(f"  launches: fused_dw_act {launches['fused_dw_act']} = {per_forward} x "
          f"{forwards['eval']} eval forwards, none in {forwards['train']} train-mode forwards; "
          f"all {len(kinds['parameters'])} extractor parameter tensors and "
          f"{len(kinds['running statistics'])} running statistics moved")
    ep = pad_episode(test_task)
    rec32 = copy.deepcopy(learner.recogniser).float()
    rec32.load_state_dict(convert.load(learner.checkpoint_path_validation), strict=True)
    rec32.dtype = rec32.extractor.dtype = torch.float32
    ctx = torch.from_numpy(ep.context_clips).to(learner.device)
    card_vs_cpu_eval_forward(torch, rec32, ctx[:16, 0], card)
    # the run's own model too where it computes in bf16
    models = [("float32", rec32)] + ([("bfloat16", learner.recogniser)]
                                     if learner.dtype == torch.bfloat16 else [])
    for dtype_name, model in models:
        errs = []
        with dw_launches_checked(errs), torch.inference_mode():
            model.embed_clips(ctx)
        worst = max(errs)
        print(f"  {dtype_name}: #8 on the learned statistics, each of the {len(errs)} launches "
              f"of the test task's context forward against its plain version on the same "
              f"inputs: worst {worst:.3e} of the output's largest value (limit "
              f"{DW_TOL[dtype_name]})")
        if worst > DW_TOL[dtype_name]:
            raise AssertionError(f"#8 on the learned statistics ({dtype_name}) differs from "
                                 f"its plain version by {worst:.3e} of its output")
    for dtype_name, model in models:
        held = dtype_name == "float32" and argmax_held
        print(f"  the test task in {dtype_name}, end to end (argmax "
              f"{'held' if held else 'printed'}):")
        hold_task_kernels_vs_plain(torch, model, ep, f"learn_extractor test task, {dtype_name}",
                                   witness=True, outputs_held=False, argmax_held=held)
    del rec32


def dw_per_forward(extractor: str) -> int:
    """#8's launches in one eval forward of the EfficientNet: a launch a
    stride-1 tail, at any frame size."""
    return V2S_DW_PER_FORWARD if extractor == "efficientnet_v2_s" else B0_DW_PER_FORWARD


def card_vs_cpu_eval_forward(torch, rec, frames, card: str) -> None:
    """One f32 eval forward of the EfficientNet on its learned statistics
    (``rec``: the f32 recogniser the test protocol ran last) on the card
    against the same forward on the CPU, stage by stage: the stem, each
    block and the head, each fed the CPU's output of the stage before it, so
    that random weights on learned statistics (PERF.md §6, PR 10) do not
    amplify a difference from one stage to the next. Each stage's output is
    held to F32_PATH_GRAD_TOL of its largest value, as card_vs_cpu_step
    holds the step: in f32 the two sides differ in summation order only
    (the card runs #8 in the stride-1 tails, the CPU its plain version), so
    a fault in the eval route of masked BatchNorm on the card (its folded
    affine, its statistics) would show. The end-to-end features are printed
    beside."""
    import copy

    import torch.nn.functional as F

    def stages(ext):
        out = [("stem", lambda x: F.silu(ext.bn1(ext.conv_stem(x), None, None)))]
        out += [(name, getattr(ext, name)) for name in ext.block_names]
        out.append(("head", lambda x: F.silu(ext.bn2(ext.conv_head(x), None, None))
                    .mean(dim=(1, 2))))
        return out

    x = rec._maybe_normalize(frames).float()
    cpu = copy.deepcopy(rec.extractor).cpu()
    worst, inputs, outputs = ("stem", 0.0), [], []
    with torch.inference_mode():
        h = x.cpu()
        for _, fn in stages(cpu):
            inputs.append(h)
            h = fn(h)
            outputs.append(h)
        for (name, fn), inp, ref in zip(stages(rec.extractor), inputs, outputs):
            ours = fn(inp.to(x.device)).cpu()
            if not torch.isfinite(ours).all():
                raise AssertionError(f"f32 eval forward on the card: non-finite {name}")
            rel = float((ours - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            if rel > worst[1]:
                worst = (name, rel)
        whole = rec.extractor(x).cpu()
    end = float((whole - outputs[-1]).abs().max()) / max(float(outputs[-1].abs().max()), 1e-30)
    print(f"  f32 eval forward on the learned statistics, {x.shape[0]} test frames, card vs "
          f"CPU stage by stage ({len(outputs)} stages, each fed the CPU's input): worst "
          f"{worst[1]:.3e} of the stage's largest value ({worst[0]}; limit {F32_PATH_GRAD_TOL}); "
          f"end to end, features {end:.3e} apart (printed) ({card})")
    if worst[1] > F32_PATH_GRAD_TOL:
        raise AssertionError(f"f32 eval forward, card vs CPU: {worst[0]} differs by "
                             f"{worst[1]:.3e} of its largest value, more than {F32_PATH_GRAD_TOL}")


@contextlib.contextmanager
def dw_launches_checked(errs: list):
    """Every launch of #8 also runs its plain version on the same inputs
    and appends the largest difference over the output's largest value to
    ``errs``."""
    from orbit_tpu_torch.ops import depthwise
    launch = depthwise._launch

    def checked(x, w, a1, b1, a2, b2, act1, act2):
        out = launch(x, w, a1, b1, a2, b2, act1, act2)
        ref = depthwise.fused_dw_reference(x, w, a1, b1, a2, b2, act1=act1, act2=act2).float()
        errs.append(float((out.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
        return out
    depthwise._launch = checked
    try:
        yield
    finally:
        depthwise._launch = launch


def print_step_times(torch, seconds, card: str) -> None:
    """The learner's time per task step (each ended by a device sync):
    the median and range of the warm steps (all but the first), every
    step, and the run's peak device memory."""
    ms = [1e3 * x for x in seconds]
    warm = ms[1:] or ms
    print(f"  time per task step: median {statistics.median(warm):.2f} ms over {len(warm)} "
          f"warm steps ({min(warm):.2f}-{max(warm):.2f}; each: {[round(x, 2) for x in ms]}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")


def film_train_phase(torch, card: str, workdir: Path,
                     extractor: str = "efficientnet_b0", bf16_held: bool = True) -> dict:
    """Phases 7 and 13 (d): FiLM meta-training of SimpleCNAPs with LITE at
    full width (224 px; EfficientNet-B0 with all 16 MBConv blocks and D =
    1280 unless told otherwise, or a ViT, D = 768), bf16, through the
    learner in ``--mode train_test`` (``--adapt_features --classifier
    mahalanobis --with_lite --num_lite_samples 16 --batch_size 256
    --tasks_per_batch 2``) over phase 5's synthetic train tasks, with an
    EfficientNet's BatchNorms calibrated after each weight draw, as phase 6.
    Before the run, one task's target batch through the kernels and
    through their plain versions, with the same injected subsets: the
    gradients of every trained parameter (set encoder, FiLM generator)
    under one fixed upstream gradient of the logits, in f32 (the parameters
    are f32; only the activations change type) held per tensor to
    F32_PATH_GRAD_TOL, in bf16 held over the whole gradient to
    BF16_PATH_GRAD_NORM_TOL (a bf16 rounding flip of an activation travels
    back through the blocks into per-channel sums that cancel, so
    per-tensor differences of a tenth appear whatever the kernels do).
    Beside them, against the same plain route: the witness, which shows the
    size of those differences, and a planted fault, which the f32 check
    must see. On an EfficientNet the witness is #8's plain version with its
    f32 stages in f64 and the fault a wrong border in it; on a ViT, kernel
    B's plain forward with its f32 stages in f64, and its LayerNorm's
    statistics over all channels but the last (a column tile's edge). The
    whole steps' losses and gradients are printed, as phase 5 prints its
    whole step. The run must launch #8 in every stride-1 tail of every
    EfficientNet forward, or A and B in every layer of every ViT forward
    and #4 and #6 in every layer of both differentiated forwards of every
    target batch, and #7 in every head call; move the trained parameters
    and keep the frozen extractor's bits. ``bf16_held`` off prints the bf16
    check where the witness alone reaches its limit (FiLM on ViT-B/32-CLIP:
    0.1165 of the norm against 2^-3; PERF.md §6); the f32 check
    stays held, and must see the planted fault."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import EfficientNet, calibrate_batchnorm
    from orbit_tpu_torch.models.backbones.vit import ViT
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.utils.args import parse_args

    effnet = extractor.startswith("efficientnet")
    batch, num_lite = 256, 16
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "train_test", "--feature_extractor", extractor, "--adapt_features",
        "--classifier", "mahalanobis", "--compute_dtype", "bfloat16",
        "--batch_size", str(batch), "--frame_size", "224", "--with_lite",
        "--num_lite_samples", str(num_lite), "--tasks_per_batch", "2", "--epochs", "1",
        "--num_train_tasks", "1", "--num_val_tasks", "1", "--num_test_tasks", "1",
        "--seed", str(SEED)])
    train_tasks = synthetic_train_tasks()
    after_init = None
    if effnet:
        # every task's context frames: each task has its own colour, and
        # statistics of one task's frames alone put the others' activations
        # many deviations out, where B0's features grow to about 1e4
        frames = torch.from_numpy(np.concatenate([t["context_clips"][:, 0]
                                                  for t in train_tasks]))

        def after_init(rec):
            calibrate_batchnorm(rec.extractor,
                                rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
    learner = SingleStepLearner(
        args, train_queue=TaskQueue(train_tasks),
        validation_queue=TaskQueue(synthetic_tasks(1, seed=SEED + 1)),
        test_queue=TaskQueue(synthetic_tasks(2, seed=SEED + 2)), after_init=after_init)
    batches = [math.ceil(len(t["target_labels"]) / batch) for t in train_tasks]

    rec, dev = learner.recogniser, learner.device
    episode = learner._train_episode(pad_episode(train_tasks[0]))
    gen = torch.Generator().manual_seed(SEED)
    subsets = [steps_lib.lite_grad_subset(gen, episode["context_mask"], num_lite)
               for _ in range(batches[0])]
    step = steps_lib.build_train_task_lite(rec, args)
    class_mask, target = episode["class_mask"], episode["target_clips"][:batch]
    upstream = torch.where(class_mask.bool(), torch.randn(
        target.shape[0], class_mask.shape[0],
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev), 0.0)
    trained = [p for p in rec.parameters() if p.requires_grad]
    step_loss, step_worst = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        # the parameters are f32 in training; the compute dtype only casts
        # the activations, so one model serves both dtypes
        rec.dtype = rec.extractor.dtype = getattr(torch, dtype_name)
        grads = {}
        for impl in (None, "reference"):
            rec.impl = impl
            rec.zero_grad(set_to_none=True)
            step_loss[dtype_name, impl] = float(step(episode, grad_idxs=subsets)[0])
            grads[impl] = [p.grad.clone() for p in trained]
        step_worst[dtype_name] = worst_rel(grads[None], grads["reference"])
        del grads

    plain_as, variant = (dw_plain_as, dw_variant) if effnet else (mlp_plain_as, mlp_variant)

    def fixed_grads(dtype_name, impl, plain=None):
        """The trained parameters' gradients for one target batch under the
        fixed upstream gradient of the logits; ``plain`` stands in for the
        plain version of #8 (forward and recompute) or of B's forward."""
        rec.dtype = rec.extractor.dtype = getattr(torch, dtype_name)
        rec.impl = impl
        try:
            with plain_as(plain):
                rec.zero_grad(set_to_none=True)
                state = rec.personalise_with_lite(
                    episode["context_clips"], episode["context_labels"],
                    episode["context_mask"], class_mask.shape[0], subsets[0])
                logits = rec.predict(state, target, class_mask, with_grad=True)
                torch.where(class_mask.bool(), logits, 0.0).mul(upstream).sum().backward()
            return [p.grad.clone() for p in trained]
        finally:
            rec.dtype = rec.extractor.dtype = learner.dtype
            rec.impl = None
            rec.zero_grad(set_to_none=True)

    # kernels and plain versions; the plain route with the f32 stages in
    # f64 (the witness: what moving the f32 roundings alone does); the plain
    # route with a planted fault
    fault = {"raw_border": True} if effnet else {"short_norm": True}
    variants = {"kernels": (None,), "plain": ("reference",),
                "wide": ("reference", functools.partial(variant, wide=True)),
                "fault": ("reference", functools.partial(variant, **fault))}
    read = {}
    for dtype_name in ("float32", "bfloat16"):
        fixed = {v: fixed_grads(dtype_name, *a) for v, a in variants.items()}
        for v in ("kernels", "wide", "fault"):
            read[dtype_name, v] = (worst_rel(fixed[v], fixed["plain"]),
                                   norm_rel(fixed[v], fixed["plain"]))
        if dtype_name == "float32":
            worst = compare_grads(fixed["kernels"], fixed["plain"], F32_PATH_GRAD_TOL,
                                  "f32 FiLM gradients under a fixed upstream gradient, "
                                  "kernels vs plain")
        del fixed
    print(f"FiLM train path, {extractor} SimpleCNAPs LITE (card: {card}): one task's "
          + "; ".join(f"{dt} step loss {step_loss[dt, None]:.6f} with the kernels, "
                      f"{step_loss[dt, 'reference']:.6f} plain, gradients differing by at most "
                      f"{step_worst[dt]:.3e} of a tensor's largest value" for dt in step_worst))
    print(f"  under a fixed upstream gradient of the logits, {len(trained)} gradient tensors "
          f"(set encoder, FiLM generator) against the plain route, as (largest per-tensor "
          f"difference over the tensor's largest value, difference's norm over the whole "
          f"gradient's norm): " + "; ".join(
              f"{dt} {v} ({read[dt, v][0]:.3e}, {read[dt, v][1]:.3e})"
              for dt in ("float32", "bfloat16") for v in ("kernels", "wide", "fault"))
          + f"; f32 kernels max abs {worst:.3e}; bf16 "
          + ("held" if bf16_held else "printed") + f" to {BF16_PATH_GRAD_NORM_TOL} of the norm")
    if read["float32", "fault"][0] <= F32_PATH_GRAD_TOL:
        raise AssertionError("the f32 gradient check does not see the planted fault")
    if bf16_held and read["bfloat16", "kernels"][1] > BF16_PATH_GRAD_NORM_TOL:
        raise AssertionError(f"bf16 FiLM gradients, kernels vs plain, differ by "
                             f"{read['bfloat16', 'kernels'][1]:.3e} of the gradient's norm, "
                             f"more than {BF16_PATH_GRAD_NORM_TOL}")
    # one warm bf16 LITE step under the profiler: device time by kernel
    # group and the device's idle share
    device_breakdown(torch, lambda: step(episode, grad_idxs=subsets), card)
    rec.zero_grad(set_to_none=True)

    # the learner's run; extractor forwards and head calls counted (the
    # calibration's composed forwards launch no kernel and are not counted)
    forwards, heads = [0], [0]
    model = EfficientNet if effnet else ViT
    model_forward, head_logits = model.forward, SingleStepFewShotRecogniser.head_logits

    def counted_forward(self, x, *a, **kw):
        # neither the calibration's composed forwards nor the MACs counter's
        # on a meta copy launch a kernel
        forwards[0] += kw.get("impl") != "composed" and x.device.type != "meta"
        return model_forward(self, x, *a, **kw)

    def counted_head(self, *a, **kw):
        heads[0] += 1
        return head_logits(self, *a, **kw)

    model.forward, SingleStepFewShotRecogniser.head_logits = counted_forward, counted_head
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        losses, moved, launches = recorded_run(torch, learner)
    finally:
        model.forward, SingleStepFewShotRecogniser.head_logits = model_forward, head_logits
    wall = time.perf_counter() - t0

    if len(losses) != len(train_tasks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if len(moved) != math.ceil(len(train_tasks) / args.tasks_per_batch):
        raise AssertionError(f"{len(moved)} optimiser updates")
    if effnet:  # a launch of #8 in every stride-1 tail of every forward
        expected = {"fused_dw_act": dw_per_forward(extractor) * forwards[0]}
    else:  # A and B in every layer of every forward; #4 and #6 in every
        # layer of the grad subset's and the target batch's backward
        expected = {"fused_qkv_attention": DEPTH * forwards[0],
                    "fused_mlp_block": DEPTH * forwards[0],
                    "fused_qkv_attention_bwd": DEPTH * 2 * sum(batches),
                    "fused_mlp_block_bwd": DEPTH * 2 * sum(batches)}
    expected["mahalanobis_logits"] = heads[0]
    wrong = {n: (launches[n], c) for n, c in expected.items() if launches[n] != c}
    if wrong:
        raise AssertionError(f"launches (counted, expected) for {forwards[0]} extractor "
                             f"forwards and {heads[0]} head calls: {wrong}")
    if not Path(learner.test_evaluator.json_results_path).exists():
        raise AssertionError("the test protocol after training wrote no results.json")
    print(f"  {len(train_tasks)} tasks, {sum(batches)} target batches, {len(moved)} updates "
          f"(parameter tensors moved, with a nonzero gradient, in all: {moved}), losses "
          f"{[round(x, 6) for x in losses]}, {forwards[0]} extractor forwards, {heads[0]} head "
          f"calls; launches: " + ", ".join(f"{n} {c}" for n, c in expected.items())
          + f"; wall {wall:.2f} s")
    print_step_times(torch, learner.train_step_seconds, card)
    return launches


def device_breakdown(torch, fn, card: str) -> float:
    """Run ``fn`` (one warm task) under ``torch.profiler`` and print the
    device time by kernel group and the device's idle share (1 - the
    kernels' summed time over the host's wall time of the region); return
    the kernels' summed time in ms (0 if the trace holds none)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    groups = (("#4 fused_qkv_attention_bwd", r"qkv_recompute|attention_bwd_mma|"
                                              r"grads_kernel<__nv_bfloat16>|"
                                              r"qkv_attention_bwd_f32|sgemm_grads_kernel<1>"),
              # the anonymous namespace keeps PyTorch's vectorized_layer_norm_kernel out
              ("#6 fused_mlp_block_bwd", r"mlp_bwd_hidden|grads_kernel<float>|"
                                         r"sgemm_grads_kernel<2>|"
                                         r"namespace\)::layer_norm_(kernel|backward)"),
              ("#4 and #6 second passes (vector gradients, f32 weight runs)",
               r"sum_partials|sum_runs"),
              ("A fused_qkv_attention", r"fused_qkv_attention"),
              ("B fused_mlp_block", r"fused_mlp_block"),
              ("#8 fused_dw_act", r"fused_dw_\w*kernel"),
              ("#7 mahalanobis_logits", r"mahalanobis_(partial|finish)"),
              ("linalg.inv (MAGMA LU, swaps, solves)",
               r"getrf|getri|getrs|trsm|laswp|swap_kernel|computecolumn|displace_pointers|"
               r"magma|cusolver|_batched"),
              ("convolutions (cuDNN, ATen)", r"conv|cudnn|fprop|implicit|dgrad|wgrad|"
                                             r"winograd|nchwToNhwc|nhwcToNchw"),
              ("matmuls (cuBLAS)", r"gemm|cutlass|gemv|nvjet"),
              ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    totals, names = {}, {}
    for evt in prof.key_averages():
        # kernels and copies only: an operator's own entry repeats the
        # device time of the kernels it launched
        us = evt.self_device_time_total
        # user annotations (``Optimizer.step#Adam.step``) repeat the device
        # time of the kernels inside them
        if (evt.device_type != torch.autograd.DeviceType.CUDA or us <= 0
                or getattr(evt, "is_user_annotation", False)):
            continue
        group = next((g for g, pat in groups if re.search(pat, evt.key)), "other (elementwise, "
                     "reductions, casts)")
        totals[group] = totals.get(group, 0.0) + us / 1e3
        names[evt.key] = names.get(evt.key, 0.0) + us / 1e3
    busy = sum(totals.values())
    if busy <= 0:
        print(f"  trace ({card}): the profiler recorded no device time (not measured)")
        return 0.0
    print(f"  trace of one warm task ({card}): wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {100 * (1 - busy / wall_ms):.1f}%")
    for group, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"    {group}: {ms:.3f} ms ({100 * ms / busy:.1f}%)")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"      {ms:.3f} ms  {name[:110]}")
    return busy


def hold_task_kernels_vs_plain(torch, rec, ep, label: str, witness: bool,
                               outputs_held: bool = True, argmax_held: bool = True):
    """The padded test task ``ep`` personalised and predicted through the
    kernels and through their plain versions (inference mode): features and
    logits within PATH_REL_TOL of their largest value (``outputs_held``)
    and the same argmax on ARGMAX_AGREEMENT of the real query frames
    (``argmax_held``); what is not held is printed. For every frame whose
    argmax flips, the plain route's top-1 to top-2 margin is printed.
    ``witness``: also #8's plain version with its f32 stages in f64 against
    the plain version. Returns the task's device tensors (context clips,
    labels, mask, class mask, query clips) and the real query frames."""
    import numpy as np

    dev = rec.pixel_mean.device
    ctx = torch.from_numpy(ep.context_clips).to(dev)
    labels = torch.from_numpy(ep.context_labels.astype(np.int64)).to(dev)
    mask = torch.from_numpy(ep.context_mask).to(dev)
    class_mask = torch.from_numpy(ep.class_mask).to(dev)
    query = torch.from_numpy(np.concatenate(ep.video_frames)[:, None]).to(dev)
    real = np.concatenate([m > 0 for m in ep.video_masks])
    runs = {"kernels": (None, None), "plain": ("reference", None)}
    if witness:  # the EfficientNet: phase 7's witness, #8's f32 stages in f64
        runs["wide"] = ("reference", functools.partial(dw_variant, wide=True))
    out = {}
    for run, (impl, dw_plain) in runs.items():
        rec.impl = impl
        with torch.inference_mode(), dw_plain_as(dw_plain):
            state = rec.personalise(ctx, labels, mask, ep.num_classes)
            out[run] = (rec.embed_clips(ctx, film=state["film"]),
                        rec.predict(state, query, class_mask))
    rec.impl = None
    (fk, lk), (fr, lr) = out["kernels"], out["plain"]
    if not (torch.isfinite(lk).all() and torch.isfinite(fk).all()):
        raise AssertionError("non-finite features or logits on the kernel path")
    present = class_mask.bool()  # padded classes hold -1e30 on both sides

    def agreement(logits):
        return float((logits.argmax(-1) == lr.argmax(-1)).cpu().numpy()[real].mean())
    limit = PATH_REL_TOL if outputs_held else math.inf
    for what, a, b in (("features", fk, fr), ("logits", lk[:, present], lr[:, present])):
        max_abs, max_rel = compare(a, b, 0.0, limit * float(b.abs().max()),
                                   f"{label} {what}")
        print(f"  kernels vs plain, task 0 {what}: max abs {max_abs:.3e}, max rel {max_rel:.3e}")
    agree = agreement(lk)
    print(f"  argmax agreement on {int(real.sum())} real query frames: {agree:.4f}")
    # the frames whose argmax flips: how close the plain route's top two
    # logits were, against the bf16 ulp at the top logit (2^(e - 7) for a
    # value in [2^e, 2^(e+1))) and the frame's kernels-vs-plain difference
    flips = np.nonzero((lk.argmax(-1) != lr.argmax(-1)).cpu().numpy() & real)[0]
    if len(flips):
        top2 = lr[:, present].topk(2, dim=-1).values[flips].cpu()
        diff = (lk[:, present] - lr[:, present]).abs().amax(dim=-1)[flips].cpu()
        margin = top2[:, 0] - top2[:, 1]
        ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
        print(f"  {len(flips)} flipped frames, plain top-1 minus top-2 logit (bf16 ulps of the "
              f"top logit; the frame's largest kernels-vs-plain logit difference): "
              + ", ".join(f"{float(m):.3e} ({float(m / u):.2f} ulp; {float(d):.3e})"
                          for m, u, d in zip(margin, ulp, diff)))
    if "wide" in out:
        fw, lw = out["wide"]
        print(f"  witness (#8's f32 stages in f64) vs plain, task 0: features max rel "
              f"{compare(fw, fr, 0.0, math.inf, 'witness features')[1]:.3e}, logits max rel "
              f"{compare(lw[:, present], lr[:, present], 0.0, math.inf, 'witness')[1]:.3e}, "
              f"argmax agreement {agreement(lw):.4f}")
    if argmax_held and agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {agree:.4f} < {ARGMAX_AGREEMENT}")
    return ctx, labels, mask, class_mask, query, real


def eval_path_phase(torch, card: str, workdir: Path, label: str, flags: list,
                    per_forward: dict, calibrate: bool = False, repeats: int = PATH_REPEATS,
                    traced: bool = True, after_construct=None, after_load=None,
                    dtype: str = "bfloat16", frame_size: int = 224,
                    plain_timed: bool = False) -> dict:
    """Phases 4, 6, 11, 13 (a, c, d): the port's CLU-VE test protocol
    through the learner (batch 256; bf16 at 224 px unless told otherwise,
    ``flags`` naming the model) on two synthetic tasks, to
    ``results.json``. Every extractor forward (one per chunk of at
    most 256 frames, the untimed warm-up personalise included) must launch
    each kernel of ``per_forward`` that many times, and the Mahalanobis
    kernel must run once per predict call. ``calibrate`` sets the
    EfficientNet's BatchNorm statistics from the first task's frames after
    each weight draw. Then task 0 is rerun through the kernels and through
    their plain versions, repeated warm ``repeats`` times for the metrics'
    median, and traced once (``traced``). ``after_construct`` is given the
    learner before its run; ``after_load`` the recogniser after each load of
    ``--model_path`` (its BatchNorm calibration, where the loaded statistics
    replace the calibrated ones). ``plain_timed`` repeats task 0 through
    the plain versions too, for the kernels' share of the path's time."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import single_step
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.utils.args import parse_args

    batch = 256
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "test", *flags, "--compute_dtype", dtype, "--batch_size", str(batch),
        "--frame_size", str(frame_size), "--num_test_tasks", "1", "--seed", str(SEED)])
    tasks = synthetic_tasks(frame_size=frame_size)
    eps = [pad_episode(t) for t in tasks]
    after_init = None
    if calibrate:
        frames = torch.from_numpy(np.concatenate(
            [eps[0].context_clips[:, 0]] + [v[:40] for v in eps[0].video_frames]))

        def after_init(rec):
            # every weight draw (the test protocol draws its own) is calibrated
            calibrate_batchnorm(rec.extractor,
                                rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
    learner = SingleStepLearner(args, test_queue=TaskQueue(tasks), after_init=after_init)
    if after_construct is not None:
        after_construct(learner)

    # keep every logits tensor the protocol computes, to check them after
    logits_seen = []
    predict = SingleStepFewShotRecogniser.predict

    def predict_kept(self, *a, **kw):
        out = predict(self, *a, **kw)
        logits_seen.append(out)
        return out

    load = single_step.maybe_load_params

    def load_then(path, recogniser, logfile=None):
        used = load(path, recogniser, logfile)
        if used is None:
            raise AssertionError(f"--model_path {path} was not loaded")
        after_load(recogniser)
        return used

    SingleStepFewShotRecogniser.predict = predict_kept
    if after_load is not None:
        single_step.maybe_load_params = load_then
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        SingleStepFewShotRecogniser.predict = predict
        single_step.maybe_load_params = load
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    if not logits_seen or not all(bool(torch.isfinite(t).all()) for t in logits_seen):
        raise AssertionError("the protocol produced no logits, or non-finite ones")
    results = Path(learner.test_evaluator.json_results_path)
    if not results.exists():
        raise AssertionError("results.json was not written")
    saved = json.loads(results.read_text())
    if sorted(saved) != sorted(t["task_id"] for t in tasks):
        raise AssertionError(f"results.json users {sorted(saved)}")

    rec = learner.recogniser
    ctx_chunks = [math.ceil(ep.context_clips.shape[0] / batch) for ep in eps]
    query_chunks = [math.ceil(sum(v.shape[0] for v in ep.video_frames) / batch) for ep in eps]
    expected_chunks = ctx_chunks[0] + sum(ctx_chunks) + sum(query_chunks)
    forwards = rec.extractor.forward_calls
    if forwards != expected_chunks:
        raise AssertionError(f"{forwards} extractor forwards, expected {expected_chunks}")
    for name, count in per_forward.items():
        if launches[name] != count * forwards:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{count} x {forwards} extractor forwards")
    if rec.classifier == "mahalanobis" and launches["mahalanobis_logits"] != len(logits_seen):
        raise AssertionError(f"mahalanobis_logits: {launches['mahalanobis_logits']} launches "
                             f"for {len(logits_seen)} predict calls")

    timings = learner.test_timings
    per_frame = statistics.mean(timings["inference_per_frame"])
    personalise = statistics.mean(timings["personalise"])
    query_frames = sum(int(m.sum()) for ep in eps for m in ep.video_masks)
    counts = ", ".join(f"{n} {launches[n]}" for n in KERNELS if launches[n])
    print(f"{label} (card: {card}): {frame_size}px {dtype}, batch {batch}, {len(tasks)} tasks, "
          f"{query_frames} query frames, {forwards} extractor forwards, {len(logits_seen)} "
          f"predict calls, wall {wall:.2f} s; launches: {counts}")
    print(f"  query frames/s: {1.0 / per_frame:.1f}; time to personalise: "
          f"{personalise * 1e3:.2f} ms per task ({card})")

    # task 0 again through the kernels and through their plain versions
    ctx, labels, mask, class_mask, query, real = hold_task_kernels_vs_plain(
        torch, rec, eps[0], label, witness=calibrate)

    # the two metrics over warm repeats of task 0, timed as the protocol
    # times them (each call ended by a sync, the logits copied to the host)
    medians = {}
    for impl in (None, "reference") if plain_timed else (None,):
        rec.impl = impl
        seconds = {"personalise": [], "predict": []}
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = learner.personalise_fn(ctx, labels, mask, class_mask)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            learner.predict_fn(state, query, class_mask).cpu()
            t2 = time.perf_counter()
            seconds["personalise"].append(t1 - t0)
            seconds["predict"].append(t2 - t1)
        fps = [int(real.sum()) / t for t in seconds["predict"]]
        pers = [1e3 * t for t in seconds["personalise"]]
        medians[impl] = statistics.median(fps)
        print(f"  task 0 repeated {repeats}x, warm, {'the plain versions' if impl else 'kernels'}:"
              f" query frames/s median {statistics.median(fps):.1f} ({min(fps):.1f}-"
              f"{max(fps):.1f}); time to personalise median {statistics.median(pers):.2f} ms "
              f"({min(pers):.2f}-{max(pers):.2f}) ({card})")
    if plain_timed:
        print(f"  query frames/s, kernels over the plain versions: "
              f"{medians[None] / medians['reference']:.3f} ({card})")
    rec.impl = None
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    def warm_task():
        learner.predict_fn(learner.personalise_fn(ctx, labels, mask, class_mask), query,
                           class_mask)
    if traced:
        device_breakdown(torch, warm_task, card)
    return launches


def finetune_dw_breakdown(torch, card: str, rows: int, steps: int,
                          dtype: str = "bfloat16") -> None:
    """#4 and #6 by launch at the FineTuner's context batch (``rows`` clips
    of 50 tokens at ViT-B/32's width, in ``dtype``). Their grads launch forms the
    weight gradients beside dx (half of #4's products there, two thirds of
    #6's), which a FiLM step with the extractor frozen does not read; the
    bound of those dW products alone is printed beside."""
    from orbit_tpu_torch.ops import fused_mlp_block_backward, fused_qkv_attention_backward
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, s = 768, 50

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    dt = getattr(torch, dtype)
    x, cot = randn(rows, s, d).to(dt), randn(rows, s, d).to(dt)
    qkv = (randn(d, 3 * d, scale=d ** -0.5).to(dt), randn(3 * d, scale=0.02))
    mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, 4 * d, scale=d ** -0.5).to(dt), randn(4 * d, scale=0.02),
           randn(4 * d, d, scale=(4 * d) ** -0.5).to(dt))
    shape, short = f"ViT-B/32 B={rows}", "bf16" if dtype == "bfloat16" else "f32"
    launch_breakdown(torch, lambda: fused_qkv_attention_backward(x, *qkv, cot, DEPTH),
                     "fused_qkv_attention_bwd", card, shape=shape, dtype=short)
    launch_breakdown(torch, lambda: fused_mlp_block_backward(x, *mlp, cot, ln_eps=1e-5),
                     "fused_mlp_block_bwd", card, shape=shape, dtype=short)
    dw_flops = 2 * rows * s * (3 * d * d + 2 * 4 * d * d)
    print(f"  the dW products of #4 and #6 a layer at B={rows}: {dw_flops / 1e9:.3f} GFLOP, "
          f"bound {1e3 * dw_flops / PEAK_FLOPS[dtype]:.4f} ms; a FiLM personalise runs "
          f"them {DEPTH} x {steps} times ({card})")


def finetuner_phase(torch, card: str, workdir: Path, label: str, flags: list,
                    per_forward: dict, per_backward: dict | None = None,
                    calibrate: bool = False, repeats: int = FT_REPEATS, traced: bool = True,
                    after_construct=None, dtype: str = "bfloat16",
                    plain_timed: bool = False) -> dict:
    """Phases 8, 9 and 14 (b): the port's FineTuner through the multi-step learner
    (``--mode test --classifier linear``, ``flags`` naming the model, bf16
    unless ``dtype`` says otherwise, batch 256, 224 px, the CLI's
    defaults: 50 Adam steps at lr 0.001) over phase 4's two synthetic
    tasks, to ``results.json``.

    Before the run, through the kernels and through their plain versions:
    one inner step's gradients of the task parameters (the head, and with
    FiLM the FiLM leaves) at their initial values, under the loss's head
    term and a fixed upstream gradient of the context features (the zero
    head sends the FiLM leaves none at the first step); and task 0's whole
    personalise and predict, whose argmax must agree on at least 99% of
    the real query frames. A ViT is held in bf16, its gradients per tensor
    to PATH_REL_TOL as in phase 5; in f32 (phase 14) per tensor to
    F32_PATH_GRAD_TOL, its argmax held as phase 9 holds B0's. An EfficientNet (``calibrate``: its
    BatchNorm statistics set as in phase 6) is held to phase 7's limits:
    per tensor F32_PATH_GRAD_TOL and the argmax in f32, which must also see
    a wrong border planted in #8; BF16_PATH_GRAD_NORM_TOL of the norm in
    bf16, whose argmax agreement is printed beside the witness's (#8's
    plain version with its f32 stages in f64). The run must launch each
    kernel of ``per_forward`` that many times in every extractor forward,
    and each of ``per_backward`` in every backward of every inner step, and
    no other kernel; every task's head (and FiLM leaves) must move, and the
    results must carry ``task_macs_to_personalise``. Then task 0 repeated
    warm for the metrics (``plain_timed``: then through the plain versions
    too, and the ratio of the times to personalise), and a personalise of
    TRACE_STEPS inner steps traced (``traced``); on a ViT, #4 and #6 by
    launch at the FineTuner's batch. ``after_construct`` is given the
    learner before the checks."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners.multi_step import MultiStepLearner, build_finetune_fns
    from orbit_tpu_torch.models import heads as heads_lib
    from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
    from orbit_tpu_torch.utils.args import parse_args
    from orbit_tpu_torch.utils.ops_counter import flops_of, meta_copy
    from orbit_tpu_torch.utils.optim import cross_entropy

    batch = 256
    per_backward = per_backward or {}
    started, marks = time.perf_counter(), []
    args = parse_args("multi-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "test", *flags, "--classifier", "linear", "--compute_dtype", dtype,
        "--batch_size", str(batch), "--frame_size", "224", "--num_test_tasks", "1",
        "--seed", str(SEED)])
    steps = args.personalize_num_grad_steps
    tasks = synthetic_tasks()
    eps = [pad_episode(t) for t in tasks]
    after_init = None
    if calibrate:
        frames = torch.from_numpy(np.concatenate(
            [eps[0].context_clips[:, 0]] + [v[:40] for v in eps[0].video_frames]))

        def after_init(rec):
            calibrate_batchnorm(rec.extractor,
                                rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
    learner = MultiStepLearner(args, test_queue=TaskQueue(tasks), after_init=after_init)
    if after_construct is not None:
        after_construct(learner)
    rec, dev = learner.recogniser, learner.device
    film = rec.adapt_features
    marks.append(("set-up", time.perf_counter()))

    ep = eps[0]
    n_ctx = int(ep.context_mask.sum())
    ctx = tuple(torch.from_numpy(a).to(dev) for a in (
        ep.context_clips, ep.context_labels.astype(np.int64), ep.context_mask, ep.class_mask))
    upstream = torch.randn(n_ctx, rec.output_size, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))

    query = torch.from_numpy(np.concatenate(ep.video_frames)[:, None]).to(dev)
    real = np.concatenate([m > 0 for m in ep.video_masks])
    present = ctx[3].bool()

    @contextlib.contextmanager
    def route(dtype_name, impl, dw_plain=None):
        """The model in ``dtype_name`` through ``impl``, #8's plain version
        replaced by ``dw_plain``; the parameters stay as stored (f32 before
        the run: bf16 compute casts them at each use)."""
        rec.dtype = rec.extractor.dtype = getattr(torch, dtype_name)
        rec.impl = impl
        try:
            with dw_plain_as(dw_plain):
                yield
        finally:
            rec.dtype = rec.extractor.dtype = learner.dtype
            rec.impl = None

    def first_step_grads(*how):
        with route(*how):
            tp = rec.init_task_params(ctx[3].shape[0])
            feats = rec.embed_clips(ctx[0][:n_ctx], with_grad=True, film=tp.get("film"))
            logits = heads_lib.predict_linear(tp["head"], feats, logit_scale=rec.logit_scale,
                                              class_mask=ctx[3])
            loss = (cross_entropy(logits, ctx[1][:n_ctx], ctx[2][:n_ctx], reduction="sum")
                    / n_ctx + (feats * upstream).sum())
            return list(torch.autograd.grad(loss, rec.task_leaves(tp)))

    def task0_logits(*how):
        with route(*how):
            return learner.predict_fn(learner.personalise_fn(*ctx), query, ctx[3])[:, present]

    # (dtype, gradient limit by "tensor" or "norm", limit, argmax held). The
    # ViT as phase 5, in bf16. The EfficientNet as phase 7: its gradients
    # per tensor in f32 and over the norm in bf16; its argmax held in f32,
    # where the two routes differ in summation order only. In bf16 a change
    # of f32 rounding alone (the witness: #8's plain version with its f32
    # stages in f64) moves 1-2% of task 0's query argmax after 50 Adam
    # steps (PERF.md §6), so there the agreement is printed beside the
    # witness's; the planted fault (a wrong border in #8) must show in the
    # f32 gradients.
    checks = ([("float32", "tensor", F32_PATH_GRAD_TOL, True)] if dtype == "float32" else
              [("bfloat16", "tensor", PATH_REL_TOL, True)] if not calibrate else
              [("float32", "tensor", F32_PATH_GRAD_TOL, True),
               ("bfloat16", "norm", BF16_PATH_GRAD_NORM_TOL, False)])
    wide = functools.partial(dw_variant, wide=True)
    fault = functools.partial(dw_variant, raw_border=True)
    read = []
    for dtype_name, kind, limit, held in checks:
        kern = first_step_grads(dtype_name, None)
        plain = first_step_grads(dtype_name, "reference")
        if kind == "tensor":
            compare_grads(kern, plain, limit, f"{label} {dtype_name} first-step gradients")
        elif norm_rel(kern, plain) > limit:
            raise AssertionError(f"{label} {dtype_name} first-step gradients differ by "
                                 f"{norm_rel(kern, plain):.3e} of the norm, more than {limit}")
        line = (f"{dtype_name}: first-step gradients of {len(kern)} task tensors under a "
                f"fixed upstream gradient of the features, kernels vs plain, largest per-tensor difference over the tensor's largest value "
                f"{worst_rel(kern, plain):.3e}, over the norm {norm_rel(kern, plain):.3e} "
                f"(limit {limit} by {kind})")
        if calibrate and dtype_name == "float32":
            # with FiLM the gradient runs back through #8, as in phase 7;
            # frozen, only the head's gradient, through the features, reads it
            planted = worst_rel(first_step_grads(dtype_name, "reference", fault), plain)
            if film and planted <= limit:
                raise AssertionError("the f32 gradient check does not see a wrong border in #8")
            line += f", a wrong border in #8 {planted:.3e}"
        del kern, plain
        logits = {"kernels": task0_logits(dtype_name, None),
                  "plain": task0_logits(dtype_name, "reference")}
        if calibrate and not held:
            logits["witness"] = task0_logits(dtype_name, "reference", wide)
        if not torch.isfinite(logits["kernels"]).all():
            raise AssertionError(f"{label}: non-finite logits on the kernel path")
        top = {k: v.argmax(-1).cpu().numpy() for k, v in logits.items()}
        agree = {k: float((top[k] == top["plain"])[real].mean()) for k in top if k != "plain"}
        line += (f"; task 0 personalise and predict, logits max rel "
                 f"{worst_rel([logits['kernels']], [logits['plain']]):.3e}, argmax agreement "
                 f"with the plain route on {int(real.sum())} real query frames: "
                 + ", ".join(f"{k} {v:.4f}" for k, v in agree.items())
                 + (f" (held to {ARGMAX_AGREEMENT})" if held else " (printed)"))
        read.append(line)
        if held and agree["kernels"] < ARGMAX_AGREEMENT:
            raise AssertionError(f"{label} {dtype_name} argmax agreement "
                                 f"{agree['kernels']:.4f} < {ARGMAX_AGREEMENT}")
        del logits

    marks.append(("checks before the run", time.perf_counter()))
    # the learner's run, every personalise kept
    kept = []
    personalise = learner.personalise_fn

    def kept_personalise(*a):
        kept.append(personalise(*a))
        return kept[-1]
    learner.personalise_fn = kept_personalise
    forwards0 = rec.extractor.forward_calls
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        learner.personalise_fn = personalise
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    forwards = rec.extractor.forward_calls - forwards0

    # one untimed personalise of task 0, then each task's
    runs = [eps[0]] + eps
    if len(kept) != len(runs):
        raise AssertionError(f"{len(kept)} personalise calls, expected {len(runs)}")
    passes = [math.ceil(e.context_clips.shape[0] / min(batch, e.context_clips.shape[0]))
              * steps if film else math.ceil(e.context_clips.shape[0] / batch) for e in runs]
    backwards = sum(passes) if film else 0
    query_chunks = sum(math.ceil(v.shape[0] / batch) for e in eps for v in e.video_frames)
    if forwards != sum(passes) + query_chunks:
        raise AssertionError(f"{forwards} extractor forwards, expected {sum(passes)} in the "
                             f"personalise calls and {query_chunks} in the predictions")
    for name in KERNELS:
        want = per_forward.get(name, 0) * forwards + per_backward.get(name, 0) * backwards
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want} "
                                 f"({forwards} extractor forwards, {backwards} backwards)")
    for tp in kept:
        if not float(tp["head"]["weight"].detach().abs().max()) > 0:
            raise AssertionError("a personalise left the head at zero")
        if film and not max(float((v.detach() - rec.extractor.get_parameter(k).float())
                                  .abs().max()) for k, v in tp["film"].items()) > 0:
            raise AssertionError("a personalise left the FiLM leaves where they started")
    saved = json.loads(Path(learner.test_evaluator.json_results_path).read_text())
    macs = [t["task_macs_to_personalise"] for user in sorted(saved) for t in saved[user]]
    if len(macs) != len(tasks) or not all(m > 0 for m in macs):
        raise AssertionError(f"results.json MACs to personalise {macs}")
    frame_macs = flops_of(meta_copy(rec).embed_clips, ctx[0][:n_ctx]) / 2.0 / n_ctx
    low, high = VIT_B_FRAME_MACS
    if "vit_b_32" in args.feature_extractor and not low < frame_macs < high:
        raise AssertionError(f"{frame_macs / 1e9:.3f} GMACs a frame, off "
                             f"{low / 1e9}-{high / 1e9} G")
    counts = ", ".join(f"{n} {launches[n]}" for n in KERNELS if launches[n])
    timings = learner.test_timings
    print(f"{label} (card: {card}): 224px {dtype}, batch {batch}, {len(tasks)} tasks, {steps} "
          f"inner steps, {len(kept)} personalise calls, {forwards} extractor forwards, "
          f"{backwards} backwards, wall {wall:.2f} s; launches: {counts}")
    for line in read:
        print(f"  {line}")
    print(f"  MACs to personalise per task (results.json) {macs}; extractor forward "
          f"{frame_macs / 1e9:.4f} GMACs a frame; peak memory "
          f"{peak / 2**30:.2f} GiB ({card})")
    print(f"  the protocol's reading: time to personalise "
          f"{1e3 * statistics.mean(timings['personalise']):.2f} ms per task, query frames/s "
          f"{1.0 / statistics.mean(timings['inference_per_frame']):.1f} ({card})")

    marks.append(("the run and its checks", time.perf_counter()))
    medians = {}
    for impl in (None, "reference") if plain_timed else (None,):
        rec.impl = impl
        seconds = {"personalise": [], "predict": []}
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tp = learner.personalise_fn(*ctx)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            learner.predict_fn(tp, query, ctx[3]).cpu()
            seconds["personalise"].append(1e3 * (t1 - t0))
            seconds["predict"].append(time.perf_counter() - t1)
        fps = [int(real.sum()) / t for t in seconds["predict"]]
        pers = seconds["personalise"]
        medians[impl] = statistics.median(pers)
        print(f"  task 0 repeated {repeats}x, warm, "
              f"{'the plain versions' if impl else 'kernels'}: time to personalise median "
              f"{statistics.median(pers):.2f} ms ({min(pers):.2f}-{max(pers):.2f}); query "
              f"frames/s median {statistics.median(fps):.1f} ({min(fps):.1f}-{max(fps):.1f}) "
              f"({card})")
    rec.impl = None
    if plain_timed:
        print(f"  time to personalise, kernels over the plain versions: "
              f"{medians[None] / medians['reference']:.3f} ({card})")
    if not traced:
        marks.append(("repeats", time.perf_counter()))
        print("  phase time: " + ", ".join(
            f"{label} {t - before:.1f} s"
            for (label, t), before in zip(marks, [started] + [t for _, t in marks])))
        return launches
    # the trace: a personalise of TRACE_STEPS inner steps (the profiler's
    # own work on a 50-step personalise's 10^5 launches takes tens of
    # seconds), whose untraced time is taken first; the profiler's host work
    # on every launch stretches the traced wall, so the idle share is also
    # read against the untraced time
    short = build_finetune_fns(rec, args, num_grad_steps=TRACE_STEPS)[0]
    untraced = []
    for _ in range(FT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        short(*ctx)
        torch.cuda.synchronize()
        untraced.append(1e3 * (time.perf_counter() - t0))
    print(f"  a personalise of {TRACE_STEPS} inner steps, traced next: untraced median "
          f"{statistics.median(untraced):.2f} ms ({min(untraced):.2f}-{max(untraced):.2f})")
    busy = device_breakdown(torch, lambda: short(*ctx), card)
    if busy > 0:
        print(f"  device busy {busy:.2f} ms of the untraced {statistics.median(untraced):.2f} "
              f"ms: idle share {100 * (1 - busy / statistics.median(untraced)):.1f}% ({card})")
    if "fused_mlp_block_bwd" in per_backward:
        finetune_dw_breakdown(torch, card, ctx[0].shape[0], steps, dtype)
    marks.append(("repeats and traces", time.perf_counter()))
    print("  phase time: " + ", ".join(
        f"{label} {t - before:.1f} s"
        for (label, t), before in zip(marks, [started] + [t for _, t in marks])))
    return launches


# ---------------------------------------------------------------- phase 11 ----
# The fake upstream checkpoints are models/fakes.py's.
def _save_upstream(sd: dict, path: Path) -> None:
    import numpy as np

    if path.suffix == ".npz":
        np.savez(path, **sd)
    else:
        import torch
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)


def _convert_script():
    """``scripts/convert_checkpoint_torch.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint_torch", REPO / "scripts" / "convert_checkpoint_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_leaves(torch, state: dict, expected: dict, label: str) -> None:
    """Loaded leaves of the port's state dict against the upstream tensors
    after their transposes: bit for bit."""
    for key, value in expected.items():
        ours = state[key].detach().float().cpu()
        if tuple(ours.shape) != value.shape or not torch.equal(ours, torch.from_numpy(value)):
            raise AssertionError(f"{label}: loaded {key} is not the upstream tensor")
    print(f"  {label}: {len(expected)} loaded leaves equal the upstream tensors after their "
          f"transposes, bit for bit ({', '.join(expected)})")


def trace_kernel_names(trace: Path) -> dict:
    """Kernel events of a Chrome trace by name: their count."""
    names = {}
    for evt in json.loads(trace.read_text()).get("traceEvents", []):
        if evt.get("cat") == "kernel":
            names[evt["name"]] = names.get(evt["name"], 0) + 1
    return names


def pretrained_phase(torch, card: str, workdir: Path) -> dict:
    """Phase 11: pretrained weights through the CLIs. For each upstream
    format a fake checkpoint at the published width and depth (from the
    seed, in that upstream's own key layout) is converted with
    ``scripts/convert_checkpoint_torch.py`` into a flax ``.ckpt`` and run
    in ``--mode test`` (bf16, batch 256, 224 px, phase 4's tasks):
    (a) ViT-S/32 from a timm ``.pth``, proto, with ``--profile_dir``, whose
    trace must name kernels A and B; (b) ViT-B/32 from an augreg ``.npz``,
    proto_cosine; (c) ViT-B/32-CLIP from an open_clip ``.bin`` through the
    multi-step learner (FineTuner, frozen); (d) EfficientNetV2-S from a timm
    ``.pth``, Mahalanobis head, its BatchNorms calibrated after the load;
    (e) an EfficientNet-B0 CNAPs reference recogniser (``--full_model``,
    set encoder, FiLM generator, Versa) through ``--model_path``,
    calibrated after the load. Each run checks a handful of loaded leaves
    against the upstream tensors bit for bit, and holds task 0 through the
    kernels against their plain versions at phase 4's and 6's limits
    (phase 8's for the FineTuner); the launch counters must show each
    path's kernels in every extractor forward. Each run repeats task 0
    warm 3 times (2 on the FineTuner); only (a) is traced, for ViT-S/32's
    device breakdown and idle share."""
    import numpy as np

    from orbit_tpu_torch.models.backbones.efficientnet import (ARCHS, STEM_CHS,
                                                               efficientnet_film_spec)
    from orbit_tpu_torch.models.fakes import (fake_augreg_vit, fake_openclip_vit,
                                              fake_reference_cnaps, fake_timm_efficientnet,
                                              fake_timm_vit, reference_film_name)

    script = _convert_script()
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 11)
    vit = {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}
    conv_t = (2, 3, 1, 0)
    paths = {}

    def converted(sd: dict, name: str, extractor: str, *more) -> str:
        src, out = workdir / name, workdir / f"{Path(name).stem}.ckpt"
        _save_upstream(sd, src)
        t0 = time.perf_counter()
        script.main(["--feature_extractor", extractor, "--torch_path", str(src),
                     "--out", str(out), *more])
        print(f"phase 11: {name} ({len(sd)} tensors, {src.stat().st_size / 2**20:.1f} MiB) "
              f"-> {out.name} ({out.stat().st_size / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.2f} s")
        src.unlink()
        return str(out)

    def leaves_after_construct(expected: dict, label: str):
        return lambda learner: check_leaves(
            torch, {f"extractor.{k}": v for k, v in
                    learner.recogniser.extractor.state_dict().items()}, expected, label)

    # (a) ViT-S/32, timm .pth, proto, --profile_dir
    sd = fake_timm_vit(rng, 384, DEPTH)
    expected = {"extractor.patch_embed.kernel": sd["patch_embed.proj.weight"].transpose(conv_t),
                "extractor.blocks.0.attn.qkv.kernel": sd["blocks.0.attn.qkv.weight"].T,
                "extractor.blocks.11.mlp.fc2.kernel": sd["blocks.11.mlp.fc2.weight"].T,
                "extractor.norm.scale": sd["norm.weight"], "extractor.pos_embed": sd["pos_embed"]}
    ckpt = converted(sd, "vit_s_32.pth", "vit_s_32")
    profile = workdir / "profile"
    paths["pretrained_vit_s_32"] = eval_path_phase(
        torch, card, workdir / "vit_s", "phase 11 (a): ViT-S/32 from a timm .pth, proto",
        ["--feature_extractor", "vit_s_32", "--classifier", "proto",
         "--pretrained_extractor_path", ckpt, "--profile_dir", str(profile)], vit,
        repeats=3, after_construct=leaves_after_construct(expected, "(a)"))
    names = trace_kernel_names(profile / "trace.json")
    found = {k: sum(n for name, n in names.items() if k in name)
             for k in ("fused_qkv_attention", "fused_mlp_block")}
    if not all(found.values()):
        raise AssertionError(f"--profile_dir trace names no launch of {found}")
    print(f"  --profile_dir: {profile / 'trace.json'} holds {sum(names.values())} kernel "
          f"events; A's kernels {found['fused_qkv_attention']}, B's "
          f"{found['fused_mlp_block']}")

    # (b) ViT-B/32, augreg .npz, proto_cosine
    sd = fake_augreg_vit(rng, 768, DEPTH, 12)
    a = "Transformer/encoderblock_3/MultiHeadDotProductAttention_1"
    expected = {"extractor.patch_embed.kernel": sd["embedding/kernel"],
                "extractor.blocks.3.attn.qkv.kernel": np.concatenate(
                    [sd[f"{a}/{m}/kernel"].reshape(768, -1) for m in ("query", "key", "value")],
                    axis=1),
                "extractor.blocks.3.attn.proj.kernel": sd[f"{a}/out/kernel"].reshape(-1, 768),
                "extractor.blocks.7.norm2.scale": sd[
                    "Transformer/encoderblock_7/LayerNorm_2/scale"]}
    ckpt = converted(sd, "vit_b_32.npz", "vit_b_32")
    paths["pretrained_vit_b_32_cosine"] = eval_path_phase(
        torch, card, workdir / "vit_b", "phase 11 (b): ViT-B/32 from an augreg .npz, "
        "proto_cosine", ["--feature_extractor", "vit_b_32", "--classifier", "proto_cosine",
                         "--pretrained_extractor_path", ckpt], vit, repeats=3, traced=False,
        after_construct=leaves_after_construct(expected, "(b)"))

    # (c) ViT-B/32-CLIP, open_clip .bin, the FineTuner (frozen extractor)
    sd = fake_openclip_vit(rng, 768, DEPTH)
    r = "visual.transformer.resblocks.5"
    expected = {"extractor.cls_token": sd["visual.class_embedding"].reshape(1, 1, 768),
                "extractor.norm_pre.scale": sd["visual.ln_pre.weight"],
                "extractor.blocks.5.attn.qkv.kernel": sd[f"{r}.attn.in_proj_weight"].T,
                "extractor.blocks.5.mlp.fc1.kernel": sd[f"{r}.mlp.c_fc.weight"].T,
                "extractor.patch_embed.kernel": sd["visual.conv1.weight"].transpose(conv_t)}
    ckpt = converted(sd, "open_clip_pytorch_model.bin", "vit_b_32_clip")
    paths["pretrained_clip_finetuner"] = finetuner_phase(
        torch, card, workdir / "clip", "phase 11 (c): ViT-B/32-CLIP from an open_clip .bin, "
        "FineTuner", ["--feature_extractor", "vit_b_32_clip", "--pretrained_extractor_path",
                      ckpt], vit, repeats=2, traced=False,
        after_construct=leaves_after_construct(expected, "(c)"))

    # (d) EfficientNetV2-S, timm .pth, Mahalanobis head, calibrated after the load
    sd = fake_timm_efficientnet(rng, ARCHS["efficientnet_v2_s"], STEM_CHS["efficientnet_v2_s"])
    expected = {"extractor.conv_stem.kernel": sd["conv_stem.weight"].transpose(conv_t),
                "extractor.blocks_1_0.conv_exp.kernel":
                    sd["blocks.1.0.conv_exp.weight"].transpose(conv_t),
                "extractor.blocks_4_2.conv_dw.kernel":
                    sd["blocks.4.2.conv_dw.weight"].transpose(conv_t),
                "extractor.blocks_5_3.se.conv_reduce.bias": sd["blocks.5.3.se.conv_reduce.bias"],
                "extractor.bn2.scale": sd["bn2.weight"]}
    ckpt = converted(sd, "tf_efficientnetv2_s.pth", "efficientnet_v2_s")
    paths["pretrained_v2_s"] = eval_path_phase(
        torch, card, workdir / "v2_s", "phase 11 (d): EfficientNetV2-S from a timm .pth, "
        "Mahalanobis head", ["--feature_extractor", "efficientnet_v2_s", "--classifier",
                             "mahalanobis", "--pretrained_extractor_path", ckpt],
        {"fused_dw_act": sum(V2S_DW_TAILS.values())}, calibrate=True, repeats=3, traced=False,
        after_construct=leaves_after_construct(expected, "(d)"))

    # (e) EfficientNet-B0 CNAPs reference recogniser, --full_model, --model_path
    spec = efficientnet_film_spec(ARCHS["efficientnet_b0"], STEM_CHS["efficientnet_b0"])
    sd = fake_reference_cnaps(rng, spec)
    index = {name: i for i, name in enumerate(sorted(reference_film_name(p) for p, _ in spec))}
    g = f"film_generator.generators.{index['blocks.2.0.bn2.weight']}"
    expected = {
        "extractor.blocks_2_0.conv_dw.kernel":
            sd["feature_extractor.blocks.2.0.conv_dw.weight"].transpose(conv_t),
        "extractor.conv_head.kernel": sd["feature_extractor.conv_head.weight"].transpose(conv_t),
        "set_encoder.conv3.kernel": sd["set_encoder.encoder.layer3.0.weight"].transpose(conv_t),
        "film_generator.gen__blocks_2_0_bn2_scale.fc2.kernel": sd[f"{g}.block.3.weight"].T,
        "film_generator.reg__blocks_2_0_bn2_scale": sd[
            f"film_generator.regularizers.{index['blocks.2.0.bn2.weight']}"],
        "versa.weight_processor.linear2.kernel":
            sd["classifier.weight_processor.linear2.weight"].T}
    ckpt = converted(sd, "cnaps_efficientnet_b0.pt", "efficientnet_b0", "--full_model",
                     "--classifier", "versa", "--adapt_features")
    from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
    from orbit_tpu_torch.data.episodes import pad_episode
    ep = pad_episode(synthetic_tasks()[0])
    frames = torch.from_numpy(np.concatenate(
        [ep.context_clips[:, 0]] + [v[:40] for v in ep.video_frames]))

    def after_load(rec):
        check_leaves(torch, rec.state_dict(), expected, "(e)")
        calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
    paths["pretrained_cnaps"] = eval_path_phase(
        torch, card, workdir / "cnaps", "phase 11 (e): EfficientNet-B0 CNAPs reference "
        "recogniser through --model_path", ["--feature_extractor", "efficientnet_b0",
                                            "--adapt_features", "--classifier", "versa",
                                            "--model_path", ckpt],
        {"fused_dw_act": B0_DW_PER_FORWARD}, repeats=3, traced=False, after_load=after_load)
    return paths


# ------------------------------------------------------------ phase 12 ----
# warm repeats of each loop in phase 12 (phases 4 and 6 take 10)
TP_REPEATS = 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def protocol_run(torch, learner) -> dict:
    """``learner.run()`` with every video's logits that reach the evaluator
    kept in arrival order; the launch counts set to 0 just before the run
    and read just after it; the run's peak device memory."""
    import numpy as np

    from orbit_tpu_torch.kernels import build as kbuild

    seen = []
    append = learner.test_evaluator.append_video

    def kept(logits, label, paths):
        seen.append(np.array(logits, np.float32))
        return append(logits, label, paths)
    learner.test_evaluator.append_video = kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    learner.run()
    torch.cuda.synchronize()
    return {"wall": time.perf_counter() - t0, "launches": dict(kbuild.LAUNCHES),
            "logits": seen, "forwards": learner.recogniser.extractor.forward_calls,
            "peak": torch.cuda.max_memory_allocated() / 2**30,
            "timings": learner.test_timings}


def hold_protocols(serial: dict, grouped: dict, label: str, held: bool = True) -> None:
    """Every video's logits of the grouped run against the serial run's:
    within PATH_REL_TOL of the video's largest serial logit over the
    present classes, and the argmax on ARGMAX_AGREEMENT of the frames;
    printed only, where not ``held``."""
    import numpy as np

    if len(serial["logits"]) != len(grouped["logits"]) or not serial["logits"]:
        raise AssertionError(f"{label}: {len(grouped['logits'])} videos grouped, "
                             f"{len(serial['logits'])} serial")
    worst, same, frames = 0.0, 0, 0
    for a, b in zip(grouped["logits"], serial["logits"]):
        present = b[0] > -1e29
        if a.shape != b.shape or not np.array_equal(a[0] > -1e29, present):
            raise AssertionError(f"{label}: a video's logits differ in shape or classes")
        if not np.isfinite(a[:, present]).all():
            raise AssertionError(f"{label}: non-finite grouped logits")
        err = float(np.abs(a[:, present] - b[:, present]).max())
        rel = err / max(float(np.abs(b[:, present]).max()), 1e-30)
        if held and rel > PATH_REL_TOL:
            raise AssertionError(f"{label}: grouped logits differ from serial by {rel:.3e} "
                                 f"of the largest, more than {PATH_REL_TOL}")
        worst = max(worst, rel)
        same += int((a.argmax(-1) == b.argmax(-1)).sum())
        frames += a.shape[0]
    agree = same / frames
    print(f"  grouped vs serial, {len(serial['logits'])} videos: logits max rel {worst:.3e} "
          f"({f'limit {PATH_REL_TOL}' if held else 'printed, not held'}), argmax agreement "
          f"{agree:.4f} on {frames} query frames")
    if held and agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"{label}: argmax agreement {agree:.4f} < {ARGMAX_AGREEMENT}")


def group_tensors(torch, dev, eps, dp: int, per_video: bool):
    """A group of the first ``dp`` padded test episodes on ``dev``: the
    grouped batch (:func:`stack_eval_group`, cut by :func:`trim_videos`),
    and each task's context tensors and query (each video alone where
    ``per_video``, else the task's videos in one tensor)."""
    import numpy as np

    from orbit_tpu_torch.parallel.task_dp import (build_query_block, stack_eval_group,
                                                  trim_videos)

    eps = eps[:dp]
    qbs = [build_query_block(ep, 1) for ep in eps]
    batch = stack_eval_group(eps, qbs, dp)
    trim_videos(batch, qbs)
    gdev = {k: torch.from_numpy(v.astype(np.int64) if k == "context_labels" else v).to(dev)
            for k, v in batch.items()}
    tasks = [(tuple(torch.from_numpy(a).to(dev) for a in (
        ep.context_clips, ep.context_labels.astype(np.int64), ep.context_mask, ep.class_mask)),
        [torch.from_numpy(v[:, None]).to(dev) for v in ep.video_frames] if per_video
        else [torch.from_numpy(np.concatenate(ep.video_frames)[:, None]).to(dev)])
        for ep in eps]
    return gdev, tasks


def hold_group_in_f32(torch, learner, grouped, eps, label: str) -> None:
    """The group's first ``dp`` tasks through the grouped call and serially
    with the model computing in f32 (its parameters as drawn, f32): each
    lane's FiLM values and its context features under them within
    F32_PATH_GRAD_TOL of their largest value, and the argmax of every real
    query frame on ARGMAX_AGREEMENT. The Mahalanobis head's precisions (a
    batched ``linalg.inv`` of 1280 x 1280 matrices whose conditioning the
    random weights set) and the logits are printed: the grouped call
    inverts every lane's classes in one batch, the serial loop one task's,
    and the two factorisations round differently. In bf16 rounding alone
    (the set encoder's and the heads' batch shapes) moves the features,
    which random EfficientNet weights amplify (phases 6 and 9): there the
    protocols' comparison is printed."""
    import numpy as np

    if len({v.shape[0] for ep in eps[:grouped.dp] for v in ep.video_frames}) != 1:
        raise ValueError("hold_group_in_f32 takes tasks whose videos share one frame bucket")
    rec = learner.recogniser
    rec.dtype = rec.extractor.dtype = torch.float32
    worst = {"film": 0.0, "features": 0.0, "precisions": 0.0, "logits": 0.0}
    same = frames = 0
    try:
        gdev, tasks = group_tensors(torch, learner.device, eps, grouped.dp, per_video=False)
        states = grouped.personalise(gdev)
        logits = grouped.predict(states, gdev["query_clips"], gdev["class_mask"])
        for i, (ep, (ctx, (query,))) in enumerate(zip(eps, tasks)):
            state = learner.personalise_fn(*ctx)
            for name, value in state["film"].items():
                _, rel = compare(states["film"][i][name], value, 0.0,
                                 F32_PATH_GRAD_TOL * float(value.abs().max()),
                                 f"{label} f32 FiLM {name}")
                worst["film"] = max(worst["film"], rel)
            with torch.inference_mode():
                ours = rec.embed_clips(ctx[0], film=states["film"][i])
                ref = rec.embed_clips(ctx[0], film=state["film"])
            _, rel = compare(ours, ref, 0.0, F32_PATH_GRAD_TOL * float(ref.abs().max()),
                             f"{label} f32 context features")
            worst["features"] = max(worst["features"], rel)
            worst["precisions"] = max(worst["precisions"], worst_rel(
                [states["head"]["precisions"][i]], [state["head"]["precisions"]]))
            ref = learner.predict_fn(state, query, ctx[3])
            real = torch.from_numpy(np.concatenate([m > 0 for m in ep.video_masks]))
            present = ctx[3].bool()
            ours = logits[i][:query.shape[0]][real][:, present]
            ref = ref[real][:, present]
            worst["logits"] = max(worst["logits"], worst_rel([ours], [ref]))
            same += int((ours.argmax(-1) == ref.argmax(-1)).sum())
            frames += int(real.sum())
    finally:
        rec.dtype = rec.extractor.dtype = learner.dtype
    agree = same / frames
    print(f"  grouped vs serial in f32, {grouped.dp} tasks: FiLM values max rel "
          f"{worst['film']:.3e}, context features {worst['features']:.3e} (limit "
          f"{F32_PATH_GRAD_TOL}); printed: precisions {worst['precisions']:.3e}, logits "
          f"{worst['logits']:.3e}; argmax agreement {agree:.4f} on {frames} real query frames")
    if agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"{label}: f32 argmax agreement {agree:.4f} < {ARGMAX_AGREEMENT}")


def grouped_vs_serial_repeats(torch, learner, grouped, eps, card: str, label: str,
                              per_video: bool) -> None:
    """The group's first ``dp`` tasks, warm, ``TP_REPEATS`` times: once as
    one grouped personalise and predict, once task by task as the serial
    protocol runs them (personalise, then the predict copied to the host:
    each video's alone where ``per_video``, as the FineTuner's loop does,
    else the task's videos in one call, as the single-step loop does under
    ``--batch_videos``, its default); each timed as the protocol times it.
    Prints query frames/s
    and time to personalise a task (median and range), the device's idle
    share over one traced repeat and the peak memory of each loop."""
    dp = grouped.dp
    real = sum(int(m.sum()) for ep in eps[:dp] for m in ep.video_masks)
    gdev, tasks = group_tensors(torch, learner.device, eps, dp, per_video)

    def grouped_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = grouped.personalise(gdev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grouped.predict(states, gdev["query_clips"], gdev["class_mask"]).cpu()
        return t1 - t0, time.perf_counter() - t1

    def serial_once():
        pers = pred = 0.0
        for ctx, videos in tasks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = learner.personalise_fn(*ctx)
            torch.cuda.synchronize()
            pers += time.perf_counter() - t0
            for clips in videos:
                t1 = time.perf_counter()
                learner.predict_fn(state, clips, ctx[3]).cpu()
                pred += time.perf_counter() - t1
        return pers, pred

    for name, once in (("serial", serial_once), (f"grouped x{dp}", grouped_once)):
        once()  # warm
        torch.cuda.reset_peak_memory_stats()
        runs = [once() for _ in range(TP_REPEATS)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        pers = [1e3 * p / dp for p, _ in runs]
        fps = [real / q for _, q in runs]
        print(f"  {label}, {name}: {dp} tasks repeated {TP_REPEATS}x warm: query frames/s "
              f"median {statistics.median(fps):.1f} ({min(fps):.1f}-{max(fps):.1f}); time to "
              f"personalise median {statistics.median(pers):.2f} ms a task "
              f"({min(pers):.2f}-{max(pers):.2f}); peak memory {peak:.2f} GiB ({card})")
        device_breakdown(torch, once, card)


def task_parallel_phase(torch, card: str, workdir: Path) -> dict:
    """Phase 12 (a)-(c): ``--task_parallel`` on one device through the
    learners' protocols, each against the serial protocol in the same call
    (bf16, batch 256, 224 px, phase 4's synthetic tasks, which share one
    bucket): (a) ViT-B/32 ProtoNets, groups of 4 over 8 tasks; (b) the
    ViT-B/32-CLIP FineTuner with a frozen extractor, groups of 4 over 8
    tasks; (c) EfficientNet-B0 SimpleCNAPs with FiLM, groups of 2 over 4
    tasks, calibrated as phase 6. Each grouped run must launch A and B
    (#8) DEPTH (12) times in every extractor forward, its lanes folded
    into one forward without FiLM; (c) #7 once a lane of every grouped
    predict. Every video's logits against the serial run's (PATH_REL_TOL,
    ARGMAX_AGREEMENT; in (c) printed, and one group held in f32 instead:
    :func:`hold_group_in_f32`); then warm repeats of one group against its
    tasks run serially."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners.multi_step import MultiStepLearner
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
    from orbit_tpu_torch.parallel import task_dp
    from orbit_tpu_torch.utils.args import parse_args

    all_tasks = synthetic_tasks(num_tasks=8)
    eps = [pad_episode(t) for t in all_tasks]
    runs = {
        "task_parallel_vit": ("(a) ViT-B/32 ProtoNets", "single-step-learner", 4, 8,
                              ["--feature_extractor", "vit_b_32", "--classifier", "proto"],
                              {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}),
        "task_parallel_clip_finetuner": (
            "(b) ViT-B/32-CLIP FineTuner, frozen", "multi-step-learner", 4, 8,
            ["--feature_extractor", "vit_b_32_clip", "--classifier", "linear"],
            {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}),
        "task_parallel_b0_simplecnaps": (
            "(c) EfficientNet-B0 SimpleCNAPs, FiLM", "single-step-learner", 2, 4,
            ["--feature_extractor", "efficientnet_b0", "--adapt_features",
             "--classifier", "mahalanobis"], {"fused_dw_act": B0_DW_PER_FORWARD})}
    frames = torch.from_numpy(np.concatenate(
        [eps[0].context_clips[:, 0]] + [v[:40] for v in eps[0].video_frames]))

    def calibrated(rec):
        calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames.to(rec.pixel_mean.device)))

    paths = {}
    for path, (label, learner_name, dp, n_tasks, flags, per_forward) in runs.items():
        tasks = all_tasks[:n_tasks]
        b0 = "efficientnet_b0" in flags

        def make(tdp):
            sub = workdir / path / f"tp{tdp}"
            args = parse_args(learner_name, [
                "--data_path", str(sub / "data"), "--checkpoint_dir", str(sub / "ckpt"),
                "--mode", "test", *flags, "--compute_dtype", "bfloat16", "--batch_size", "256",
                "--frame_size", "224", "--num_test_tasks", "1", "--seed", str(SEED),
                "--task_parallel", str(tdp)])
            cls = MultiStepLearner if learner_name == "multi-step-learner" else SingleStepLearner
            return cls(args, test_queue=TaskQueue(tasks), after_init=calibrated if b0 else None)

        # the grouped predict calls, for #7's count (once a lane a call)
        predicts = [0]
        predict = task_dp.TaskBatchedEval.predict

        def counted(self, *a, **kw):
            predicts[0] += 1
            return predict(self, *a, **kw)
        if b0:  # held in f32 on a learner of its own, before the bf16 runs
            f32 = make(dp)
            hold_group_in_f32(torch, f32, task_dp.TaskBatchedEval(f32.recogniser, dp),
                              eps[:n_tasks], label)
            del f32
        serial = protocol_run(torch, make(1))
        task_dp.TaskBatchedEval.predict = counted
        try:
            learner = make(dp)
            grouped = protocol_run(torch, learner)
        finally:
            task_dp.TaskBatchedEval.predict = predict
        for name, run in (("serial", serial), (f"--task_parallel {dp}", grouped)):
            counts = ", ".join(f"{n} {run['launches'][n]}" for n in KERNELS if run["launches"][n])
            fps = 1.0 / statistics.mean(run["timings"]["inference_per_frame"])
            ms = 1e3 * statistics.mean(run["timings"]["personalise"])
            print(f"phase 12 {label}, {name} ({card}): {n_tasks} tasks, {run['forwards']} "
                  f"extractor forwards, wall {run['wall']:.2f} s; launches: {counts}; "
                  f"protocol's reading: query frames/s {fps:.1f}, time to personalise "
                  f"{ms:.2f} ms a task; peak memory {run['peak']:.2f} GiB")
            for kernel, count in per_forward.items():
                if run["launches"][kernel] != count * run["forwards"] or not run["forwards"]:
                    raise AssertionError(f"{label}, {name}: {kernel} {run['launches'][kernel]} "
                                         f"launches, expected {count} x {run['forwards']} "
                                         f"extractor forwards")
        if b0 and grouped["launches"]["mahalanobis_logits"] != dp * predicts[0]:
            raise AssertionError(f"{label}: mahalanobis_logits "
                                 f"{grouped['launches']['mahalanobis_logits']} launches for "
                                 f"{predicts[0]} grouped predicts of {dp} lanes")
        if not b0 and grouped["forwards"] >= serial["forwards"]:
            raise AssertionError(f"{label}: the lanes were not folded into the extractor's "
                                 f"batch ({grouped['forwards']} forwards, serial "
                                 f"{serial['forwards']})")
        hold_protocols(serial, grouped, label, held=not b0)
        if learner_name == "multi-step-learner":
            group = task_dp.TaskBatchedFineTune(learner.recogniser, learner.args, dp)
        else:
            group = task_dp.TaskBatchedEval(learner.recogniser, dp)
        grouped_vs_serial_repeats(torch, learner, group, eps[:n_tasks], card, label,
                                  per_video=learner_name == "multi-step-learner")
        paths[path] = grouped["launches"]
    return paths


def _gloo_rank(rank: int, port: int, out: str, seed: int, device: str) -> None:
    """Phase 12 (d), one rank of a two-rank gloo group on the one card:
    probes an ``all_reduce`` of a CUDA tensor; if gloo takes it, the
    episode-DP step of two train tasks (one a rank) on ViT-B/32 cut to
    depth 2, bf16, the extractor learned; rank 0 also runs the serial sum
    and writes what it found to ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.models.backbones import vit
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.parallel import EpisodeDataParallel, make_mesh
    from orbit_tpu_torch.parallel.episode_dp import episode_to_device, stack_group
    from orbit_tpu_torch.utils.optim import init_optimizer

    global SEED
    SEED = seed
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    result = {}
    try:
        probe = torch.ones(4, device=device)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:  # gloo refuses CUDA tensors: a finding, not a fault
            result = {"refused": str(e).splitlines()[0][:300]}
        else:
            vit.VIT_CONFIGS["vit_b_32"] = (768, 2, 12, False, 1e-6)
            args = SimpleNamespace(tasks_per_batch=2, learn_extractor=True, with_lite=False,
                                   num_lite_samples=16, batch_size=256, optimizer="adam",
                                   learning_rate=1e-4, weight_decay=0.0, betas=(0.9, 0.999),
                                   epsilon=1e-8, momentum=0.0, data_parallel=2,
                                   episode_prefetch=1)

            def model():
                rec = SingleStepFewShotRecogniser("vit_b_32", batch_size=256,
                                                  dtype=torch.bfloat16).to(device).init(SEED)
                return rec.train()
            eps = [pad_episode(t) for t in synthetic_train_tasks(num_tasks=2, target_shots=8)]
            batch = stack_group(eps)
            rec = model()
            edp = EpisodeDataParallel(rec, args, init_optimizer(rec, args), make_mesh(2))
            kbuild.reset_launch_counts()
            edp.batch_grads(batch)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            result = {"launches": dict(kbuild.LAUNCHES)}
            if rank == 0:
                ref = model()
                fn = steps_lib.build_train_task(ref, args)
                for i in range(2):
                    fn(episode_to_device({k: v[i] for k, v in batch.items()}, device))
                named = dict(ref.named_parameters())
                result["worst"] = max(
                    float((p.grad - named[n].grad).abs().max())
                    / max(float(named[n].grad.abs().max()), 1e-30)
                    for n, p in rec.named_parameters() if p.requires_grad)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out).write_text(json.dumps(result))


def distributed_phase(torch, card: str, workdir: Path, device: str = "cuda:0",
                      backend: str = "nccl") -> dict:
    """Phase 12 (d): the distributed paths in a one-rank NCCL group on the
    card (their collectives run), each against its serial counterpart:
    an episode-DP LITE step on ViT-B/32 (bf16, batch 256, 16 LITE clips,
    the extractor learned: #4 and #6), every gradient held per tensor to
    PATH_REL_TOL; query sharding of a 1000-frame query; FineTuner row
    sharding (frozen, 50 Adam steps), the task parameters and logits. Then
    a two-rank gloo group on the one card (NCCL refuses two ranks on one
    device), whose summed gradients are held against the serial sum, or
    whose refusal of CUDA tensors is printed."""
    import numpy as np
    import torch.distributed as dist

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.multi_step import build_finetune_fns
    from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                    SingleStepFewShotRecogniser)
    from orbit_tpu_torch.parallel import (EpisodeDataParallel, ShardedFineTune, ShardedQuery,
                                          make_mesh)
    from orbit_tpu_torch.parallel.episode_dp import episode_to_device, stack_group
    from orbit_tpu_torch.utils.args import parse_args
    from orbit_tpu_torch.utils.optim import init_optimizer

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    paths = {}
    try:
        mesh = make_mesh(1)
        # episode-DP: a LITE step of one lane, its gradients through NCCL
        args = SimpleNamespace(tasks_per_batch=2, learn_extractor=True, with_lite=True,
                               num_lite_samples=16, batch_size=256, optimizer="adam",
                               learning_rate=1e-4, weight_decay=0.0, betas=(0.9, 0.999),
                               epsilon=1e-8, momentum=0.0, data_parallel=1, episode_prefetch=1)
        rec = SingleStepFewShotRecogniser("vit_b_32", batch_size=256,
                                          dtype=torch.bfloat16).to(dev).init(SEED).train()
        optimizer = init_optimizer(rec, args)
        edp = EpisodeDataParallel(rec, args, optimizer, mesh)
        batch = stack_group([pad_episode(synthetic_train_tasks(num_tasks=1)[0])])
        torch.cuda.synchronize()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        (loss, _), = edp.batch_grads(batch, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        paths["dist_episode_dp"] = dict(kbuild.LAUNCHES)
        ours = [p.grad.clone() for p in edp.params]
        optimizer.zero_grad(set_to_none=True)
        serial_loss, _ = steps_lib.build_train_task_lite(rec, args)(
            episode_to_device({k: v[0] for k, v in batch.items()}, dev),
            torch.Generator().manual_seed(SEED))
        ref = [p.grad if p.grad is not None else torch.zeros_like(p) for p in edp.params]
        worst = compare_grads(ours, ref, PATH_REL_TOL, "episode-DP vs serial LITE step")
        counts = ", ".join(f"{n} {c}" for n, c in paths["dist_episode_dp"].items() if c)
        print(f"phase 12 (d) one-rank {backend} group ({card}): episode-DP ViT-B/32 LITE "
              f"step {step_ms:.2f} ms (a first step, cold), loss {loss:.6f} (serial "
              f"{float(serial_loss):.6f}), {len(ours)} gradients vs serial max abs {worst:.3e}; "
              f"launches: {counts}")

        # query sharding
        rec.eval()
        ep = pad_episode(synthetic_tasks(num_tasks=1)[0])
        ctx = tuple(torch.from_numpy(a).to(dev) for a in (
            ep.context_clips, ep.context_labels.astype(np.int64), ep.context_mask,
            ep.class_mask))
        query = torch.from_numpy(np.concatenate(ep.video_frames)[:, None]).to(dev)
        present = ctx[3].bool()
        with torch.inference_mode():
            state = rec.personalise(*ctx[:3], ep.num_classes)
            one = rec.predict(state, query, ctx[3])
            kbuild.reset_launch_counts()
            sharded = ShardedQuery(rec, mesh).predict(state, query, ctx[3])
            torch.cuda.synchronize()
        paths["dist_query"] = dict(kbuild.LAUNCHES)
        _, rel = compare(sharded[:, present], one[:, present], 0.0,
                         PATH_REL_TOL * float(one[:, present].abs().max()), "query sharding")
        print(f"  query sharding, {query.shape[0]} frames: logits vs one rank max rel {rel:.3e}")

        # FineTuner row sharding (frozen extractor, the CLI's 50 Adam steps)
        del rec, edp, optimizer
        ft_args = parse_args("multi-step-learner", [
            "--data_path", str(workdir / "data"), "--mode", "test", "--classifier", "linear",
            "--compute_dtype", "bfloat16", "--batch_size", "256", "--frame_size", "224"])
        ft_rec = MultiStepFewShotRecogniser("vit_b_32", classifier="linear", batch_size=256,
                                            dtype=torch.bfloat16).to(dev).init(SEED)
        kbuild.reset_launch_counts()
        ft = ShardedFineTune(ft_rec, ft_args, mesh)
        params = ft.personalise(*ctx)
        logits = ft.predict(params, query, ctx[3])
        torch.cuda.synchronize()
        paths["dist_finetune"] = dict(kbuild.LAUNCHES)
        personalise, predict = build_finetune_fns(ft_rec, ft_args)
        serial = personalise(*ctx)
        leaves = MultiStepFewShotRecogniser.task_leaves
        worst = compare_grads([t.detach() for t in leaves(params)],
                              [t.detach() for t in leaves(serial)], PATH_REL_TOL,
                              "FineTuner row sharding vs serial task parameters")
        ref_logits = predict(serial, query, ctx[3])
        _, rel = compare(logits[:, present], ref_logits[:, present], 0.0,
                         PATH_REL_TOL * float(ref_logits[:, present].abs().max()),
                         "FineTuner row sharding logits")
        print(f"  FineTuner row sharding, {int(ep.context_mask.sum())} context clips, "
              f"{ft_args.personalize_num_grad_steps} steps: task parameters vs serial max abs "
              f"{worst:.3e}, logits max rel {rel:.3e}")
    finally:
        dist.destroy_process_group()

    # two ranks on the one card over gloo, each its own process
    out = workdir / "gloo_rank0.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, str(out), SEED, device))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if [p.exitcode for p in procs] != [0, 0]:
        raise AssertionError(f"two-rank gloo group: exit codes {[p.exitcode for p in procs]}")
    found = json.loads(out.read_text())
    if "refused" in found:
        print(f"  two-rank gloo group on one card: gloo refused CUDA tensors "
              f"({found['refused']}); not run")
    else:
        if found["worst"] > PATH_REL_TOL:
            raise AssertionError(f"two-rank gloo group: summed gradients differ from the "
                                 f"serial sum by {found['worst']:.3e} of a tensor's largest")
        counts = ", ".join(f"{n} {c}" for n, c in found["launches"].items() if c)
        print(f"  two-rank gloo group on one card (CUDA tensors): summed gradients of 2 "
              f"tasks vs the serial sum, worst tensor max rel {found['worst']:.3e}; rank 0 "
              f"launches: {counts}")
    return paths


# ------------------------------------------------------------ phase 13 ----

# warm repeats of task 0 on phase 13's eval paths
UNRUN_REPEATS = 2


def unrun_configs_phase(torch, card: str, workdir: Path) -> dict:
    """Phase 13: the configurations of the JAX package that no earlier
    phase runs on the card, each through the port's learner and CLI flags
    at full width, smallest first, with the earlier phases' checks:
    (a) ViT-B/32 proto in ``--mode test`` at the CLI's default
    ``--compute_dtype float32``, at 224 px and then at ``--frame_size 84``
    (S = 5), its repeats timed through the kernels and through the plain
    versions; (b) EfficientNet-B0 ProtoNets ``--learn_extractor`` without
    ``--with_lite`` at 84 px in f32 (phase 10's checks: a non-LITE step on
    the card against the CPU's, the eval forward stage by stage, #8 launch
    by launch on the 84 px tails); (c) EfficientNetV2-S SimpleCNAPs (FiLM
    into its 28 tails' post-affine, the Mahalanobis head) in ``--mode
    test``, bf16; (d) ViT-B/32-CLIP SimpleCNAPs+LITE meta-training (FiLM
    into every LayerNorm, #4 and #6 in the backward, the Mahalanobis head
    at D = 768; phase 7's checks), then ViT-B/32-CLIP CNAPs (Versa) in
    ``--mode test``; (e) EfficientNetV2-S ProtoNets+LITE with
    ``--learn_extractor`` at batch 256 (phase 10's checks). Each eval path
    repeats task 0 warm UNRUN_REPEATS times. Where a witness (a change of
    f32 rounding alone, without a kernel) reaches an earlier phase's limit,
    that check is printed and the check that sees a planted fault is held:
    (b) and (e) print the f32 test task's argmax on random weights and
    learned statistics (the witness flips 0.9% and 25.2% of the frames)
    and hold the eval forward stage by stage; (d) prints the bf16
    gradients' norm (the witness reads 0.1165 against 2^-3) and holds the
    f32 ones per tensor."""
    vit = {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}
    v2s = {"fused_dw_act": V2S_DW_PER_FORWARD}
    t0 = time.perf_counter()
    paths = {}
    for px in (224, 84):
        paths[f"f32_vit_{px}"] = eval_path_phase(
            torch, card, workdir / f"vit_{px}", f"phase 13 (a): ViT-B/32 proto, f32, {px} px",
            ["--feature_extractor", "vit_b_32", "--classifier", "proto"], vit,
            repeats=UNRUN_REPEATS, dtype="float32", frame_size=px, plain_timed=True)
    print("phase 13 (b): EfficientNet-B0 ProtoNets, --learn_extractor without LITE, 84 px, f32")
    paths["b0_84_non_lite"] = train_path_phase(
        torch, card, workdir / "b0_84", extractor="efficientnet_b0", frame_size=84,
        dtype="float32", lite=False, argmax_held=False)
    paths["v2_s_simplecnaps"] = eval_path_phase(
        torch, card, workdir / "v2_s_film", "phase 13 (c): EfficientNetV2-S SimpleCNAPs (FiLM, "
        "Mahalanobis head)", ["--feature_extractor", "efficientnet_v2_s", "--adapt_features",
                              "--classifier", "mahalanobis"], v2s, calibrate=True,
        repeats=UNRUN_REPEATS)
    print("phase 13 (d): ViT-B/32-CLIP SimpleCNAPs+LITE meta-training, then CNAPs test")
    paths["clip_simplecnaps_train"] = film_train_phase(
        torch, card, workdir / "clip_film_train", extractor="vit_b_32_clip", bf16_held=False)
    paths["clip_cnaps"] = eval_path_phase(
        torch, card, workdir / "clip_cnaps", "phase 13 (d): ViT-B/32-CLIP CNAPs (FiLM, Versa)",
        ["--feature_extractor", "vit_b_32_clip", "--adapt_features", "--classifier", "versa"],
        vit, repeats=UNRUN_REPEATS)
    print("phase 13 (e): EfficientNetV2-S ProtoNets+LITE, --learn_extractor, batch 256")
    paths["v2_s_learn_extractor"] = train_path_phase(
        torch, card, workdir / "v2_s_learn", extractor="efficientnet_v2_s", argmax_held=False)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return paths


# ------------------------------------------------------------ phase 14 ----

# warm repeats, through the kernels and through the plain versions, of a
# task step on phase 14 (a)'s paths and of task 0's personalise on (b)
F32_PATH_REPEATS = 3
F32_FT_REPEATS = 2


def f32_paths_phase(torch, card: str, workdir: Path) -> dict:
    """Phase 14: the CLI's default ``--compute_dtype float32`` on the ViT
    paths that run the f32 routes of #4 and #6, through the learners and
    the CLI's flags at full width: (a) ViT-B/32 ProtoNets+LITE in ``--mode
    train_test`` (phase 5's run, checks and trace; the gradients under a
    fixed upstream gradient held to F32_PATH_GRAD_TOL) at 224 px and at
    ``--frame_size 84`` (S = 5), then warm repeats of a task step through
    the kernels and through the plain versions; (b) the ViT-B/32-CLIP
    FineTuner+FiLM (phase 8's run and checks in f32: first-step gradients
    per tensor within F32_PATH_GRAD_TOL, task 0's argmax held), its time to
    personalise through the kernels and through the plain versions."""
    vit = {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}
    vit_bwd = {"fused_qkv_attention_bwd": DEPTH, "fused_mlp_block_bwd": DEPTH}
    t0 = time.perf_counter()
    paths = {}
    for px in (224, 84):
        print(f"phase 14 (a): ViT-B/32 ProtoNets+LITE, --mode train_test, f32, {px} px")
        paths[f"f32_vit_train_{px}"] = train_path_phase(
            torch, card, workdir / f"vit_train_{px}", frame_size=px, dtype="float32",
            plain_repeats=F32_PATH_REPEATS)
    paths["f32_finetune_vit_film"] = finetuner_phase(
        torch, card, workdir / "finetune_vit", "phase 14 (b): ViT-B/32-CLIP FineTuner+FiLM, f32",
        ["--feature_extractor", "vit_b_32_clip", "--adapt_features"], vit, vit_bwd,
        repeats=F32_FT_REPEATS, dtype="float32", plain_timed=True)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return paths



# ------------------------------------------------------------ phase 15 ----

# The golden records of the JAX package (data/golden_torch) on the card, f32:
# the card's kernels against the JAX package's CPU outputs, through 12-16
# layers or blocks in another summation order; held to 1e-3 of each tensor's
# largest magnitude (the CPU tests hold the plain versions to 2e-4). bf16:
# PATH_REL_TOL, as phase 4 holds the kernels against the plain versions.
GOLDEN_F32_TOL = 1e-3
# the kernels each golden record's forward runs: by backbone family, and #7
# under the Mahalanobis head
GOLDEN_KERNELS = {"efficientnet": ["fused_dw_act"],
                  "vit": ["fused_qkv_attention", "fused_mlp_block"]}
# the dry run's checks and the kernels each runs on the card: the train
# steps compose every depthwise tail (train-mode BatchNorm), so none
DRYRUN_KERNELS = {"train": [], "query": ["fused_dw_act"],
                  "vit": ["fused_qkv_attention", "fused_mlp_block",
                          "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                  "finetune": ["fused_dw_act"], "task_eval": ["fused_dw_act"],
                  "task_finetune": ["fused_dw_act"]}


def golden_kernels(record) -> list:
    names = list(GOLDEN_KERNELS[record.backbone.split("_")[0]])
    if record.classifier == "mahalanobis":
        names.append("mahalanobis_logits")
    return names


def graft_entry_phase(torch, card: str, device: str = "cuda") -> tuple:
    """Phase 15: the entry points (``graft_entry_torch.py``) and the
    golden file on the card. (1) ``entry()``, the flagship forward (B0
    ProtoNets, f32, 224 px) on the golden file's fake B0, through the
    kernels and through the plain versions: the logits within
    GOLDEN_F32_TOL of their largest value, the argmax equal on all 16
    frames, #8 launched in both forwards' 12 tails, one warm call timed;
    (2) ``dryrun_multichip(1)`` in a one-rank NCCL group, its line printed,
    kernels A, B, #4, #6 (the ViT check) and #8 (the eval checks)
    launched; (3) every golden record replayed through the kernels, and in
    f32 also through the plain versions (a kernel's error apart from the
    device's): f32 within GOLDEN_F32_TOL of the largest magnitude with the
    argmax equal on every frame, bf16 within PATH_REL_TOL with the argmax
    printed. Returns (paths, their kernels). ``device`` "cpu" rehearses
    the phase (one gloo rank)."""
    import graft_entry_torch as ge
    import numpy as np

    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.models import golden

    t0 = time.perf_counter()
    manifest, arrays = golden.load()
    paths, expected = {}, {}

    def counts() -> dict:
        if device != "cpu":
            torch.cuda.synchronize()
        return {name: kbuild.LAUNCHES[name] for name in KERNELS}

    # (1) the flagship forward, on the golden record's weights and episode
    flagship = golden.RECORD["flagship_efficientnet_b0"]
    golden.inputs(flagship, manifest)  # entry()'s episode is the record's
    fn, args = ge.entry(device, golden.extractor_state_dict(flagship, arrays))
    fn(*args)
    counts()
    kbuild.reset_launch_counts()
    start = time.perf_counter()
    logits = fn(*args)
    paths["graft_entry"] = counts()
    warm_ms = 1e3 * (time.perf_counter() - start)
    expected["graft_entry"] = ["fused_dw_act"]
    if paths["graft_entry"]["fused_dw_act"] != 2 * B0_DW_PER_FORWARD:
        raise AssertionError(f"entry(): #8 launched {paths['graft_entry']['fused_dw_act']} "
                             f"times in two forwards, not {2 * B0_DW_PER_FORWARD}")
    args[0].impl = "reference"
    plain = fn(*args)
    real = args[4].bool()
    ours, ref = logits[:, real].float().cpu().numpy(), plain[:, real].float().cpu().numpy()
    rel = float(np.abs(ours - ref).max() / np.abs(ref).max())
    agree = int((ours.argmax(1) == ref.argmax(1)).sum())
    if rel > GOLDEN_F32_TOL or agree != ours.shape[0]:
        raise AssertionError(f"entry(): kernels vs plain versions {rel:.3e} of the largest "
                             f"logit, argmax {agree}/{ours.shape[0]}")
    print(f"phase 15 (1): entry(), B0 ProtoNets f32 224 px, 16 + 16 frames ({card}): logits "
          f"{tuple(logits.shape)}, one warm call {warm_ms:.2f} ms, #8 "
          f"{paths['graft_entry']['fused_dw_act']} launches; kernels vs plain versions max "
          f"rel {rel:.3e}, argmax {agree}/{ours.shape[0]}")
    entry_out = tuple({"logits": out.float().cpu().numpy()} for out in (logits, plain))
    del fn, args

    # (2) the dry run in a one-rank NCCL group
    start = time.perf_counter()
    rank = ge.dryrun_multichip(1, device)["ranks"][0]
    for check, names in DRYRUN_KERNELS.items():
        launched = rank["launches"][check]
        paths[f"dryrun_{check}"] = {name: launched.get(name, 0) for name in KERNELS}
        if names:
            expected[f"dryrun_{check}"] = names
    print(f"phase 15 (2): dryrun_multichip(1), one-rank NCCL group ({card}): "
          f"{time.perf_counter() - start:.1f} s, ViT gradient vs plain versions max rel "
          f"{rank['vit_worst_vs_plain']:.3e}")

    # (3) the golden records through the kernels (and the plain versions);
    # the flagship record's forwards are (1)'s
    for record in golden.RECORDS:
        want = golden.outputs_of(arrays, record)
        class_mask = golden.draw_inputs(record).get("class_mask")
        rec = None
        if record.kind == "flagship":
            got, plain = entry_out
        else:
            rec = golden.build(record, golden.stats_of(arrays, record), device)
            kbuild.reset_launch_counts()
            got = golden.replay(record, manifest, arrays, device, rec=rec)
            path = f"golden_{record.name}"
            paths[path], expected[path] = counts(), golden_kernels(record)
        worst, agree, frames = golden.error(record, got, want, class_mask)
        line, plain_agree = f"kernels {worst:.3e}", ""
        if record.dtype == "float32":
            if rec is not None:
                rec.impl = "reference"
                plain = golden.replay(record, manifest, arrays, device, impl="reference",
                                      rec=rec)
            plain_worst, plain_agree, _ = golden.error(record, plain, want, class_mask)
            line += f", plain versions {plain_worst:.3e}"
            plain_agree = f" (plain versions {plain_agree}/{frames})"
        if frames:
            line += f"; argmax {agree}/{frames}" + (plain_agree if record.dtype == "float32"
                                                    else " (printed, not held)")
        print(f"phase 15 (3): golden {record.name} ({card}): worst vs the JAX package {line}")
        limit = GOLDEN_F32_TOL if record.dtype == "float32" else PATH_REL_TOL
        if worst > limit or (record.dtype == "float32" and agree != frames):
            raise AssertionError(f"golden {record.name}: {line} (limit {limit})")
        del rec
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return paths, expected


def main(argv=None) -> int:
    global SEED
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one GPU")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the weights, the synthetic tasks, the grad subsets and "
                             "the kernels' inputs (default %(default)s)")
    parser.add_argument("--breakdown-only", type=Path, metavar="DIR",
                        help="print only A's device time and the per-launch breakdown of #4 "
                             "and #6 with the orbit_tpu_torch package under DIR")
    parser.add_argument("--kernels-only", type=Path, metavar="DIR",
                        help="print only phase 3's checks and times of #1, #2, #8 and #7, "
                             "and A's and #4's device time, with the orbit_tpu_torch "
                             "package under DIR")
    opts = parser.parse_args(argv)
    SEED = opts.seed
    if not (REPO / "orbit_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of an orbit-tpu checkout "
              "(orbit_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    if opts.breakdown_only:
        breakdown_only(torch, opts.breakdown_only.resolve())
        return 0
    if opts.kernels_only:
        kernels_only(torch, opts.kernels_only.resolve())
        return 0
    sys.path.insert(0, str(REPO))

    started = time.perf_counter()
    # phase 1: card
    card = card_line()
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    configure_matmul_precision()
    t0 = time.perf_counter()
    kbuild.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if kbuild.build_seconds is not None else 'skipped: built'}) "
          f"-> {kbuild.library_path()}")
    print_registers(kbuild.library_path().parent / "nvcc.log", REGISTER_KERNELS)

    # phase 3: the mainloop's layouts, then kernels vs plain versions
    mainloop_layout_phase(torch, card)
    rows = kernel_phase(torch, card)
    rows["fused_dw_act"] = dw_kernel_phase(torch, card)
    rows["mahalanobis_logits"] = mahalanobis_kernel_phase(torch, card)
    rows.update(attention_kernel_phase(torch, card))

    # phases 4 to 11: the ViT eval path, the ViT train path, the SimpleCNAPs
    # path, the SimpleCNAPs FiLM train path, the ViT-B/32-CLIP FineTuner with
    # FiLM, the EfficientNet-B0 FineTuner frozen and with FiLM, the
    # EfficientNet-B0 ProtoNets+LITE meta-training with --learn_extractor,
    # and pretrained weights from each upstream format, each read alone
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = {
            "eval": eval_path_phase(
                torch, card, Path(tmp) / "eval", "ViT-B/32 proto path",
                ["--feature_extractor", "vit_b_32", "--classifier", "proto"],
                {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH}),
            "train": train_path_phase(torch, card, Path(tmp) / "train"),
            "simplecnaps": eval_path_phase(
                torch, card, Path(tmp) / "simplecnaps",
                "EfficientNet-B0 SimpleCNAPs path (FiLM, Mahalanobis head)",
                ["--feature_extractor", "efficientnet_b0", "--adapt_features",
                 "--classifier", "mahalanobis"],
                {"fused_dw_act": B0_DW_PER_FORWARD}, calibrate=True),
            "film_train": film_train_phase(torch, card, Path(tmp) / "film_train"),
            "finetune_vit_film": finetuner_phase(
                torch, card, Path(tmp) / "finetune_vit", "ViT-B/32-CLIP FineTuner+FiLM path",
                ["--feature_extractor", "vit_b_32_clip", "--adapt_features"],
                {"fused_qkv_attention": DEPTH, "fused_mlp_block": DEPTH},
                {"fused_qkv_attention_bwd": DEPTH, "fused_mlp_block_bwd": DEPTH}),
            "finetune_b0": finetuner_phase(
                torch, card, Path(tmp) / "finetune_b0", "EfficientNet-B0 FineTuner path",
                ["--feature_extractor", "efficientnet_b0"],
                {"fused_dw_act": B0_DW_PER_FORWARD}, calibrate=True),
            "finetune_b0_film": finetuner_phase(
                torch, card, Path(tmp) / "finetune_b0_film",
                "EfficientNet-B0 FineTuner+FiLM path",
                ["--feature_extractor", "efficientnet_b0", "--adapt_features"],
                {"fused_dw_act": B0_DW_PER_FORWARD}, calibrate=True),
            "learn_extractor": train_path_phase(torch, card, Path(tmp) / "learn_extractor",
                                                extractor="efficientnet_b0")}
        # phase 11: pretrained weights from each upstream format through the CLIs
        paths.update(pretrained_phase(torch, card, Path(tmp) / "pretrained"))
        # phase 12: --task_parallel on one device, then the distributed paths
        paths.update(task_parallel_phase(torch, card, Path(tmp) / "task_parallel"))
        paths.update(distributed_phase(torch, card, Path(tmp) / "distributed"))
        # phase 13: the configurations that no earlier phase runs
        paths.update(unrun_configs_phase(torch, card, Path(tmp) / "unrun"))
        # phase 14: the f32 ViT train and FineTuner+FiLM paths (#4's and #6's f32 routes)
        paths.update(f32_paths_phase(torch, card, Path(tmp) / "f32_paths"))
    # phase 15: the entry points and the golden file of the JAX package
    entry_paths, entry_kernels = graft_entry_phase(torch, card)
    paths.update(entry_paths)
    # the kernels each path must launch; a kernel's row reports the first
    # path that launches it
    path_kernels = {"eval": ["fused_qkv_attention", "fused_mlp_block"],
                    "train": ["fused_qkv_attention", "fused_mlp_block",
                              "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    "simplecnaps": ["mahalanobis_logits", "fused_dw_act"],
                    "film_train": ["mahalanobis_logits", "fused_dw_act"],
                    "finetune_vit_film": ["fused_qkv_attention", "fused_mlp_block",
                                          "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    "finetune_b0": ["fused_dw_act"], "finetune_b0_film": ["fused_dw_act"],
                    "learn_extractor": ["fused_dw_act"],
                    "pretrained_vit_s_32": ["fused_qkv_attention", "fused_mlp_block"],
                    "pretrained_vit_b_32_cosine": ["fused_qkv_attention", "fused_mlp_block"],
                    "pretrained_clip_finetuner": ["fused_qkv_attention", "fused_mlp_block"],
                    "pretrained_v2_s": ["mahalanobis_logits", "fused_dw_act"],
                    "pretrained_cnaps": ["fused_dw_act"],
                    "task_parallel_vit": ["fused_qkv_attention", "fused_mlp_block"],
                    "task_parallel_clip_finetuner": ["fused_qkv_attention", "fused_mlp_block"],
                    "task_parallel_b0_simplecnaps": ["mahalanobis_logits", "fused_dw_act"],
                    "dist_episode_dp": ["fused_qkv_attention", "fused_mlp_block",
                                        "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    "dist_query": ["fused_qkv_attention", "fused_mlp_block"],
                    "dist_finetune": ["fused_qkv_attention", "fused_mlp_block"],
                    "f32_vit_224": ["fused_qkv_attention", "fused_mlp_block"],
                    "f32_vit_84": ["fused_qkv_attention", "fused_mlp_block"],
                    "b0_84_non_lite": ["fused_dw_act"],
                    "v2_s_simplecnaps": ["mahalanobis_logits", "fused_dw_act"],
                    "clip_simplecnaps_train": ["fused_qkv_attention", "fused_mlp_block",
                                               "fused_qkv_attention_bwd", "fused_mlp_block_bwd",
                                               "mahalanobis_logits"],
                    "clip_cnaps": ["fused_qkv_attention", "fused_mlp_block"],
                    "v2_s_learn_extractor": ["fused_dw_act"],
                    "f32_vit_train_224": ["fused_qkv_attention", "fused_mlp_block",
                                          "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    "f32_vit_train_84": ["fused_qkv_attention", "fused_mlp_block",
                                         "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    "f32_finetune_vit_film": ["fused_qkv_attention", "fused_mlp_block",
                                              "fused_qkv_attention_bwd", "fused_mlp_block_bwd"],
                    **entry_kernels}
    path_of = {}
    for path, names in path_kernels.items():
        unused = [n for n in names if paths[path][n] < 1]
        if unused:
            raise AssertionError(f"not launched on the {path} path: {unused}")
        for name in names:
            path_of.setdefault(name, path)
    # #1 and #2 are on no path (no learner calls the attention on a raw
    # qkv, in the JAX package or here): their rows report every path's
    # launches together, which must be 0; their checks and times are phase 3's
    off_path = {name: sum(launches[name] for launches in paths.values())
                for name in KERNELS if name not in path_of}
    if any(off_path.values()):
        raise AssertionError(f"kernels of no path were launched on a path: {off_path}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # one PyTorch call computes the same function only for #1 and #2
        # (scaled_dot_product_attention, forward and backward)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": (paths[path_of[name]][name] if name in path_of
                                     else off_path[name]),
                        "path": path_of.get(name, "none (phase 3 only)"),
                        "max_abs_err": rows[name]["max_abs_err"],
                        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                        "bound_ms": rows[name]["bound_ms"],
                        "bound_by": rows[name]["bound_by"],
                        "library_ms": rows[name].get("library_ms"),
                        "call_ms": rows[name].get("call_ms"),
                        "yardstick_ms": rows[name].get("yardstick_ms"),
                        "gemm_ms": rows[name].get("gemm_ms"),
                        "float32": rows[name].get("float32"),
                        "launches_by_path": {path: launches[name]
                                             for path, launches in paths.items()}})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
