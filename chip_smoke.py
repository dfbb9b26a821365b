#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``orbit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --seed 7   # another draw of weights, tasks and inputs

Phases, each of which passes or raises:
1. card: the ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``orbit_tpu_torch/csrc``, timed, and the
   registers and spills of the kernels of the bf16 wgmma routes of A, B,
   #4 and #6 (from nvcc's ``-Xptxas -v`` log);
3. kernels: the wgmma mainloop alone in every operand layout and tile
   width against ``torch.matmul`` on a ragged shape; kernel A (fused qkv
   attention), kernel B (fused MLP block) and
   their backward kernels against their plain PyTorch versions on the card,
   at the ViT-B/32 and ViT-S/32 shapes (B = 256 and a ragged 13, S = 50), in
   f32 and bf16; the fused depthwise tail (#8) at EfficientNet-B0's 8 and
   EfficientNetV2-S's 4 stride-1 tail shapes at 224 px (B = 256 and 13,
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
   repeated to show that a second call gives the same bits; A, B, #4 and
   #6 also back to back, beside cuBLAS bf16 on their products alone (x @
   W; xn @ W1 and h @ W2; #4's three and #6's five), a yardstick the port
   never calls, and #4 and #6 with a ``torch.profiler`` breakdown of one
   call by launch; and A, B, #4 and #6 timed at the ViT
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
   parameter and running statistic must move. On the trained model: each
   launch of #8 against its plain version on the same inputs (phase 3's
   limits, f32 and bf16), and the test task end to end through the kernels
   against their plain versions, its argmax on 99% of the real query
   frames held in f32 and printed in bf16 beside the witness's, as phase 9
   (random weights on learned statistics amplify a change of rounding:
   the features and logits are printed); the median and range of the time
   per task step and the peak device memory.

The line before the last is ``{"kernels": [...]}`` (launches: kernels A and
B from phase 4, #4 and #6 from phase 5, #7 and #8 from phase 6; #1 and #2
are on no path and report their launches over phases 4 to 10 together,
which must be 0; their checks and times are phase 3's; ``launches_by_path``
gives every kernel's launches on each path, phases 8 to 10's paths
included, ``gemm_ms`` the cuBLAS yardstick of A, B, #4 and #6); the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.

    python3 chip_smoke.py --breakdown-only DIR

prints only kernel A's device time and the per-launch breakdown of #4
(ViT-B/32, B = 256, bf16 and f32) and of #6 (bf16) with the
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
# 2e-4, and the wrong border must read above it.
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
# EfficientNetV2-S's stride-1 depthwise tails at 224 px (all in its
# InvertedResidual stages; orbit_tpu_torch/models/backbones/efficientnet.py
# V2_S_ARCH): 28 a forward
V2S_DW_TAILS = {(14, 512, 3, True): 5, (14, 768, 3, True): 1, (14, 960, 3, True): 8,
                (7, 1536, 3, True): 14}
# The least time one H100 SXM could take (NVIDIA's data sheet, dense peaks
# at the full 700 W): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
# outside them, 3.35 TB/s of device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


# the kernels of the bf16 wgmma routes of A, B, #4 and #6 (csrc/wgmma.cuh),
# the mainloop's layout check and the bf16 kernels of #1 and #2, whose
# registers and spills phase 2 prints from nvcc's -Xptxas -v output
WGMMA_KERNELS = ("fused_qkv_attention_wgmma_kernel", "fused_mlp_block_layernorm_kernel",
                 "fused_mlp_block_gemm_kernel", "qkv_recompute_kernel",
                 "attention_bwd_mma_kernel", "mlp_bwd_hidden_kernel", "grads_kernel",
                 "layer_norm_kernel", "layer_norm_backward_kernel", "wgmma_check_kernel",
                 "tiny_attention_tile_kernel", "tiny_attention_bwd_mma_kernel")


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
                              r"(GeluStore|ResidualStore)") for a in re.findall(pat, m.group(1))]
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
    for vit, d, heads in (("vit_b_32", 768, 12), ("vit_s_32", 384, 6)):
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            rtol, atol = KERNEL_TOL[dtype_name]
            for b in (256, 13):
                x = randn(b, 50, d).to(dt)
                cot = randn(b, 50, d).to(dt)
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
                    with torch.inference_mode():
                        ours, ref = run(None), run("reference")
                    torch.cuda.synchronize()
                    where = f"{name} {vit} {dtype_name} B={b}"
                    if name.endswith("_bwd"):
                        max_abs = compare_grads(ours, ref, GRAD_TOL[dtype_name], where)
                        line = f"  {where}: max abs {max_abs:.3e}"
                    else:
                        max_abs, max_rel = compare(ours, ref, rtol, atol, where)
                        line = f"  {where}: max abs {max_abs:.3e}, max rel {max_rel:.3e}"
                    if b == 256:
                        with torch.inference_mode():
                            again = run(None)
                            torch.cuda.synchronize()
                            outs = ours if isinstance(ours, tuple) else (ours,)
                            agains = again if isinstance(again, tuple) else (again,)
                            if not all(torch.equal(u, v) for u, v in zip(outs, agains)):
                                raise AssertionError(f"{where}: a second call gave other bits")
                            ms = cuda_ms(lambda: run(None))
                            plain_ms = cuda_ms(lambda: run("reference"))
                        bound_ms, bound_by = bound(name, b, 50, d, dtype_name)
                        line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                                 f"{bound_ms:.4f} ms ({bound_by}), same bits on a repeat")
                        if vit == "vit_b_32" and dtype_name == "bfloat16":
                            rows[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by)
                            with torch.inference_mode():
                                b2b = cuda_ms_back_to_back(lambda: run(None))
                            line += f"; back to back {b2b:.4f} ms a call"
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_abs)
                    print(line)
                if vit == "vit_b_32" and dtype_name == "bfloat16" and b == 256:
                    gemm_yardstick(torch, rows, x, qkv, mlp, cot)
                    for name in ("fused_qkv_attention_bwd", "fused_mlp_block_bwd"):
                        launch_breakdown(torch, lambda: runs[name](None), name, card)
    train_shapes_phase(torch, randn)
    return rows


def gemm_yardstick(torch, rows: dict, x, qkv, mlp, cot) -> None:
    """cuBLAS bf16 on the ViT kernels' products alone, at their inputs: A's
    x @ W; B's xn @ W1 and h @ W2 (xn and h from the staged plain version);
    #4's x @ W, cast(dqkv) @ W^T and x^T @ cast(dqkv); #6's xn @ W1,
    g @ W2^T, cast(dhpre) @ W1^T, xn^T @ cast(dhpre) and hg^T @ g (the
    operands from the staged plain backwards; a transpose is cuBLAS's
    operand flag, no copy). A yardstick of what the tensor cores give a
    library GEMM at these shapes; the port never calls it."""
    from orbit_tpu_torch.ops.mlp_block import mlp_block_backward_stages, mlp_block_stages
    from orbit_tpu_torch.ops.tiny_attention import qkv_attention_backward_stages
    x2 = x.reshape(-1, x.shape[-1])
    heads = x.shape[-1] // 64
    with torch.inference_mode():
        xn, h, _ = mlp_block_stages(x, *mlp, ln_eps=1e-6)
        xn, h = xn.reshape(x2.shape), h.reshape(x2.shape[0], -1)
        (_, hg, dhb, _), _ = mlp_block_backward_stages(x, *mlp[:5], cot, ln_eps=1e-6)
        hg, dhb = hg.reshape(h.shape), dhb.reshape(h.shape)
        (_, dqkv), _ = qkv_attention_backward_stages(x, *qkv, cot, heads)
        g2 = cot.reshape(x2.shape)
        w1, w2 = mlp[2].contiguous(), mlp[4].contiguous()
        w = qkv[0].contiguous()
        products = {
            "fused_qkv_attention": {"x @ W": (x2, w)},
            "fused_mlp_block": {"xn @ W1": (xn, w1), "h @ W2": (h, w2)},
            "fused_qkv_attention_bwd": {"x @ W": (x2, w), "dqkv @ W^T": (dqkv, w.t()),
                                        "x^T @ dqkv": (x2.t(), dqkv)},
            "fused_mlp_block_bwd": {"xn @ W1": (xn, w1), "g @ W2^T": (g2, w2.t()),
                                    "dhb @ W1^T": (dhb, w1.t()), "xn^T @ dhb": (xn.t(), dhb),
                                    "hg^T @ g": (hg.t(), g2)}}
        for name, prods in products.items():
            ms = {p: cuda_ms(lambda a=a, b=b: torch.matmul(a, b)) for p, (a, b) in prods.items()}
            rows[name]["yardstick_ms"] = sum(ms.values())
            print(f"  cuBLAS bf16 yardstick (never called by the port), ViT-B/32 B=256, {name}: "
                  + " + ".join(f"{p} {t:.4f}" for p, t in ms.items())
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
    """``--breakdown-only``: kernel A's device time and phase 3's per-launch
    breakdown of #4 and #6 with the ``orbit_tpu_torch`` package under
    ``root``."""
    sys.path.insert(0, str(root))
    import orbit_tpu_torch
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    from orbit_tpu_torch.ops import fused_mlp_block_backward
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
    stride-1 shape of B0 and V2-S (B 256 and 13, f32 and bf16, both act1);
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
    for net, tails in (("B0", B0_DW_TAILS), ("V2-S", V2S_DW_TAILS)):
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
    """``learner.run()`` with the LITE step recording every task's loss and
    every optimiser update checked: it must move a parameter, and no frozen
    parameter (``requires_grad`` off) may change by a bit. The launch
    counts are set to 0 just before the run and read just after it.
    Returns (losses, per update (tensors moved, tensors with a nonzero
    gradient, tensors), launches)."""
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import steps as steps_lib

    losses, moved = [], []
    build_lite, build_update = steps_lib.build_train_task_lite, steps_lib.build_apply_update

    def recorded_lite(recogniser, a):
        fn = build_lite(recogniser, a)

        def run(*xs, **kw):
            loss, logits = fn(*xs, **kw)
            losses.append(float(loss))
            return loss, logits
        return run

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

    steps_lib.build_train_task_lite, steps_lib.build_apply_update = recorded_lite, checked_update
    kbuild.reset_launch_counts()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        steps_lib.build_train_task_lite, steps_lib.build_apply_update = build_lite, build_update
    return losses, moved, dict(kbuild.LAUNCHES)


def train_path_phase(torch, card: str, workdir: Path, extractor: str = "vit_b_32",
                     frame_size: int = 224, target_shots: int = 60) -> dict:
    """Phases 5 and 10: the port's ProtoNets+LITE meta-training path with
    ``--learn_extractor`` (ViT-B/32 at 224 px unless told otherwise) in
    ``--mode train_test``. Before the run, on the ViT, one task's gradients
    through the kernels against those through the plain versions; on an
    EfficientNet (phase 10), whose train-mode forwards launch no kernel, one
    f32 LITE step on the card against the same step on the CPU
    (:func:`card_vs_cpu_step`), with every BatchNorm calibrated after each
    weight draw as in phase 6. Then one warm step traced, and the run."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import EfficientNet, calibrate_batchnorm
    from orbit_tpu_torch.models.backbones.vit import ViT
    from orbit_tpu_torch.utils.args import parse_args

    effnet = extractor.startswith("efficientnet")
    batch, num_lite = 256, 16
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "train_test", "--feature_extractor", extractor, "--classifier", "proto",
        "--compute_dtype", "bfloat16", "--batch_size", str(batch),
        "--frame_size", str(frame_size),
        "--with_lite", "--learn_extractor", "--num_lite_samples", str(num_lite),
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
    step = steps_lib.build_train_task_lite(rec, args)
    if effnet:
        card_vs_cpu_step(torch, learner, train_tasks[0], card)
        # the first bf16 train-mode step picks cuDNN's algorithms for its
        # shapes: not a warm step
        t0 = time.perf_counter()
        step(episode, grad_idxs=subsets)
        torch.cuda.synchronize()
        print(f"  first bf16 task step (cold): {time.perf_counter() - t0:.2f} s")
    else:
        vit_step_kernels_vs_plain(torch, rec, args, episode, subsets, batch, card)
    # one warm LITE step under the profiler: device time by kernel group
    # and the device's idle share
    device_breakdown(torch, lambda: step(episode, grad_idxs=subsets), card)
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
        effnet_train_checks(torch, learner, launches, forwards, initial, test_tasks[0],
                            len(train_tasks) + 2 * sum(batches))
    else:
        vit_train_checks(launches, forwards["eval"] + forwards["train"], batches, batch,
                         num_lite, train_tasks)
    print(f"  {len(train_tasks)} tasks, {sum(batches)} target batches, {len(moved)} "
          f"updates (parameter tensors moved, with a nonzero gradient, in all: "
          f"{moved}), losses "
          f"{[round(x, 6) for x in losses]}, extractor forwards {forwards}, "
          f"wall {wall:.2f} s")
    print_step_times(torch, learner.train_step_seconds, card)
    return launches


def vit_step_kernels_vs_plain(torch, rec, args, episode, subsets, batch: int,
                              card: str) -> None:
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
    takes that sensitivity out: held to PATH_REL_TOL per tensor."""
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
    worst = compare_grads(fixed[None], fixed["reference"], PATH_REL_TOL,
                          "gradients under a fixed upstream gradient, kernels vs plain")
    print(f"train path (card: {card}): one task's LITE step loss {step_loss[None]:.6f} "
          f"with the kernels, {step_loss['reference']:.6f} plain; its gradients differ "
          f"by at most {step_worst:.3e} of a tensor's largest value")
    print(f"  under a fixed upstream gradient: {len(fixed[None])} gradient tensors agree "
          f"within {PATH_REL_TOL} of their largest value, max abs {worst:.3e}")


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


def card_vs_cpu_step(torch, learner, task: dict, card: str) -> None:
    """Phase 10's check of train-mode BatchNorm on the card: one f32 LITE
    step of copies of the learner's recogniser on the card and on the CPU,
    on a reduced task at 224 px (5 context clips padded to 8, 4 target clips
    padded to 8, batch 4, 2 LITE samples, the subsets injected): the
    context's second chunk and the second target batch hold padding only,
    so the step runs the masked statistics, the all-padding fallback and a
    padding-only batch's subset pass. The loss, every extractor gradient
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
        loss, _ = steps_lib.build_train_task_lite(rec, a)(
            {k: v.to(where) for k, v in ep.items()}, grad_idxs=subsets)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        out.append((loss, {n: p.grad.cpu() for n, p in rec.extractor.named_parameters()},
                    {n: b.cpu() for n, b in rec.extractor.named_buffers()}, seconds))
        del rec
    (loss, grads, stats, s_card), (loss_cpu, grads_cpu, stats_cpu, s_cpu) = out
    loss_rel = abs(loss - loss_cpu) / max(abs(loss_cpu), 1e-30)
    if loss_rel > F32_PATH_GRAD_TOL:
        raise AssertionError(f"f32 LITE step loss on the card {loss:.7f}, on the CPU "
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
                raise AssertionError(f"f32 LITE step on the card: non-finite {name}")
            rel[name] = float(((a - b).abs() / scale(name, b)).max())
        name = max(rel, key=rel.get)
        worst[kind] = (name, rel[name])
        if rel[name] > F32_PATH_GRAD_TOL:
            raise AssertionError(f"f32 LITE step {kind}, card vs CPU: {name} differs by "
                                 f"{rel[name]:.3e} of its scale, more than {F32_PATH_GRAD_TOL}")
    print(f"EfficientNet-B0 learn_extractor path (card: {card}): one reduced f32 LITE step "
          f"(5 + 3 pad context, 4 + 4 pad target clips, batch 4) on the card against the "
          f"CPU: loss {loss:.7f} vs {loss_cpu:.7f} ({loss_rel:.3e} apart); " + "; ".join(
              f"{len(grads if kind == 'gradients' else stats)} extractor {kind} within "
              f"{F32_PATH_GRAD_TOL} of their scale (worst {r:.3e}, {name})"
              for kind, (name, r) in worst.items())
          + f"; {s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU")


def effnet_train_checks(torch, learner, launches: dict, forwards: dict, initial: dict,
                        test_task: dict, train_forwards: int) -> None:
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
    §6), so the features and logits are printed, not held."""
    import copy

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.models import convert

    if forwards["train"] != train_forwards:
        raise AssertionError(f"{forwards['train']} train-mode extractor forwards, expected "
                             f"{train_forwards}")
    if launches["fused_dw_act"] != B0_DW_PER_FORWARD * forwards["eval"]:
        raise AssertionError(f"fused_dw_act: {launches['fused_dw_act']} launches, expected "
                             f"{B0_DW_PER_FORWARD} x {forwards['eval']} eval forwards and none "
                             f"in the {forwards['train']} train-mode forwards")
    final = convert.load(learner.checkpoint_path_final)
    kinds = {"parameters": [k for k, _ in learner.recogniser.extractor.named_parameters()],
             "running statistics": [k for k, _ in learner.recogniser.extractor.named_buffers()]}
    for kind, keys in kinds.items():
        still = [k for k in keys if torch.equal(final[f"extractor.{k}"], initial[k])]
        if still:
            raise AssertionError(f"{len(still)} of {len(keys)} extractor {kind} did not move "
                                 f"in training: {still[:4]}")
    print(f"  launches: fused_dw_act {launches['fused_dw_act']} = {B0_DW_PER_FORWARD} x "
          f"{forwards['eval']} eval forwards, none in {forwards['train']} train-mode forwards; "
          f"all {len(kinds['parameters'])} extractor parameter tensors and "
          f"{len(kinds['running statistics'])} running statistics moved")
    ep = pad_episode(test_task)
    rec32 = copy.deepcopy(learner.recogniser).float()
    rec32.load_state_dict(convert.load(learner.checkpoint_path_validation), strict=True)
    rec32.dtype = rec32.extractor.dtype = torch.float32
    ctx = torch.from_numpy(ep.context_clips).to(learner.device)
    for dtype_name, model in (("float32", rec32), ("bfloat16", learner.recogniser)):
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
    for dtype_name, model in (("float32", rec32), ("bfloat16", learner.recogniser)):
        held = dtype_name == "float32"
        print(f"  the test task in {dtype_name}, end to end (argmax "
              f"{'held' if held else 'printed'}):")
        hold_task_kernels_vs_plain(torch, model, ep, f"learn_extractor test task, {dtype_name}",
                                   witness=True, outputs_held=False, argmax_held=held)
    del rec32


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


def film_train_phase(torch, card: str, workdir: Path) -> dict:
    """Phase 7: FiLM meta-training of SimpleCNAPs with LITE on
    EfficientNet-B0 at full width (224 px, all 16 MBConv blocks, D = 1280),
    bf16, through the learner in ``--mode train_test`` (``--adapt_features
    --classifier mahalanobis --with_lite --num_lite_samples 16 --batch_size
    256 --tasks_per_batch 2``) over phase 5's synthetic train tasks, with
    every BatchNorm calibrated after each weight draw, as phase 6. Before
    the run, one task's target batch through the kernels and through their
    plain versions, with the same injected subsets: the gradients of every
    trained parameter (set encoder, FiLM generator) under one fixed upstream
    gradient of the logits, in f32 (the parameters are f32; only the
    activations change type) held per tensor to F32_PATH_GRAD_TOL, in bf16
    held over the whole gradient to BF16_PATH_GRAD_NORM_TOL (a bf16
    rounding flip of an activation travels back through 16 blocks into
    per-channel sums that cancel, so per-tensor differences of a tenth
    appear whatever the kernels do). Beside them, against the same plain
    route: the witness, #8's plain version with its f32 stages in f64,
    which shows the size of those differences; and a planted fault, a wrong
    border in #8's plain version, which the f32 check must see. The whole
    steps' losses and gradients are printed, as phase 5 prints its whole
    step. The run must launch #8 in all 12 stride-1 tails of every
    extractor forward and #7 in every head call, move the trained
    parameters and keep the frozen extractor's bits."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import EfficientNet, calibrate_batchnorm
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.utils.args import parse_args

    batch, num_lite = 256, 16
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "train_test", "--feature_extractor", "efficientnet_b0", "--adapt_features",
        "--classifier", "mahalanobis", "--compute_dtype", "bfloat16",
        "--batch_size", str(batch), "--frame_size", "224", "--with_lite",
        "--num_lite_samples", str(num_lite), "--tasks_per_batch", "2", "--epochs", "1",
        "--num_train_tasks", "1", "--num_val_tasks", "1", "--num_test_tasks", "1",
        "--seed", str(SEED)])
    train_tasks = synthetic_train_tasks()
    # every task's context frames: each task has its own colour, and
    # statistics of one task's frames alone put the others' activations
    # many deviations out, where B0's features grow to about 1e4
    frames = torch.from_numpy(np.concatenate([t["context_clips"][:, 0] for t in train_tasks]))

    def after_init(rec):
        calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames.to(rec.pixel_mean.device)))
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

    def fixed_grads(dtype_name, impl, dw_plain=None):
        """The trained parameters' gradients for one target batch under the
        fixed upstream gradient of the logits; ``dw_plain`` stands in for
        #8's plain version (forward and recompute)."""
        rec.dtype = rec.extractor.dtype = getattr(torch, dtype_name)
        rec.impl = impl
        try:
            with dw_plain_as(dw_plain):
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

    # kernels and plain versions; the plain route with #8's f32 stages in
    # f64 (the witness: what moving the f32 roundings alone does); the plain
    # route with a wrong border in #8 (a planted fault)
    variants = {"kernels": (None,), "plain": ("reference",),
                "wide": ("reference", functools.partial(dw_variant, wide=True)),
                "fault": ("reference", functools.partial(dw_variant, raw_border=True))}
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
    print(f"FiLM train path, EfficientNet-B0 SimpleCNAPs LITE (card: {card}): one task's "
          + "; ".join(f"{dt} step loss {step_loss[dt, None]:.6f} with the kernels, "
                      f"{step_loss[dt, 'reference']:.6f} plain, gradients differing by at most "
                      f"{step_worst[dt]:.3e} of a tensor's largest value" for dt in step_worst))
    print(f"  under a fixed upstream gradient of the logits, {len(trained)} gradient tensors "
          f"(set encoder, FiLM generator) against the plain route, as (largest per-tensor "
          f"difference over the tensor's largest value, difference's norm over the whole "
          f"gradient's norm): " + "; ".join(
              f"{dt} {v} ({read[dt, v][0]:.3e}, {read[dt, v][1]:.3e})"
              for dt in ("float32", "bfloat16") for v in ("kernels", "wide", "fault"))
          + f"; f32 kernels max abs {worst:.3e}")
    if read["float32", "fault"][0] <= F32_PATH_GRAD_TOL:
        raise AssertionError("the f32 gradient check does not see a wrong border in #8")
    if read["bfloat16", "kernels"][1] > BF16_PATH_GRAD_NORM_TOL:
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
    eff_forward, head_logits = EfficientNet.forward, SingleStepFewShotRecogniser.head_logits

    def counted_forward(self, x, film=None, impl=None):
        # neither the calibration's composed forwards nor the MACs counter's
        # on a meta copy launch a kernel
        forwards[0] += impl != "composed" and x.device.type != "meta"
        return eff_forward(self, x, film, impl)

    def counted_head(self, *a, **kw):
        heads[0] += 1
        return head_logits(self, *a, **kw)

    EfficientNet.forward, SingleStepFewShotRecogniser.head_logits = counted_forward, counted_head
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        losses, moved, launches = recorded_run(torch, learner)
    finally:
        EfficientNet.forward, SingleStepFewShotRecogniser.head_logits = eff_forward, head_logits
    wall = time.perf_counter() - t0

    if len(losses) != len(train_tasks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if len(moved) != math.ceil(len(train_tasks) / args.tasks_per_batch):
        raise AssertionError(f"{len(moved)} optimiser updates")
    if launches["fused_dw_act"] != B0_DW_PER_FORWARD * forwards[0]:
        raise AssertionError(f"fused_dw_act: {launches['fused_dw_act']} launches, expected "
                             f"{B0_DW_PER_FORWARD} x {forwards[0]} extractor forwards")
    if launches["mahalanobis_logits"] != heads[0]:
        raise AssertionError(f"mahalanobis_logits: {launches['mahalanobis_logits']} launches "
                             f"for {heads[0]} head calls")
    if not Path(learner.test_evaluator.json_results_path).exists():
        raise AssertionError("the test protocol after training wrote no results.json")
    print(f"  {len(train_tasks)} tasks, {sum(batches)} target batches, {len(moved)} updates "
          f"(parameter tensors moved, with a nonzero gradient, in all: {moved}), losses "
          f"{[round(x, 6) for x in losses]}, {forwards[0]} extractor forwards, {heads[0]} head "
          f"calls; launches: fused_dw_act {launches['fused_dw_act']}, mahalanobis_logits "
          f"{launches['mahalanobis_logits']}; wall {wall:.2f} s")
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
                                              r"grads_kernel<__nv_bfloat16>"),
              # the anonymous namespace keeps PyTorch's vectorized_layer_norm_kernel out
              ("#6 fused_mlp_block_bwd", r"mlp_bwd_hidden|grads_kernel<float>|"
                                         r"namespace\)::layer_norm_(kernel|backward)"),
              ("#4 and #6 second passes (vector gradients)", r"sum_partials"),
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
                    per_forward: dict, calibrate: bool = False) -> dict:
    """Phases 4 and 6: the port's CLU-VE test protocol through the learner
    (bf16, batch 256, 224 px, ``flags`` naming the model) on two synthetic
    tasks, to ``results.json``. Every extractor forward (one per chunk of at
    most 256 frames, the untimed warm-up personalise included) must launch
    each kernel of ``per_forward`` that many times, and the Mahalanobis
    kernel must run once per predict call. ``calibrate`` sets the
    EfficientNet's BatchNorm statistics from the first task's frames after
    each weight draw. Then task 0 is rerun through the kernels and through
    their plain versions, repeated warm for the metrics' median, and traced
    once."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.utils.args import parse_args

    batch = 256
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "test", *flags, "--compute_dtype", "bfloat16", "--batch_size", str(batch),
        "--frame_size", "224", "--num_test_tasks", "1", "--seed", str(SEED)])
    tasks = synthetic_tasks()
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

    # keep every logits tensor the protocol computes, to check them after
    logits_seen = []
    predict = SingleStepFewShotRecogniser.predict

    def predict_kept(self, *a, **kw):
        out = predict(self, *a, **kw)
        logits_seen.append(out)
        return out

    SingleStepFewShotRecogniser.predict = predict_kept
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        SingleStepFewShotRecogniser.predict = predict
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
    print(f"{label} (card: {card}): 224px bf16, batch {batch}, {len(tasks)} tasks, "
          f"{query_frames} query frames, {forwards} extractor forwards, {len(logits_seen)} "
          f"predict calls, wall {wall:.2f} s; launches: {counts}")
    print(f"  query frames/s: {1.0 / per_frame:.1f}; time to personalise: "
          f"{personalise * 1e3:.2f} ms per task ({card})")

    # task 0 again through the kernels and through their plain versions
    ctx, labels, mask, class_mask, query, real = hold_task_kernels_vs_plain(
        torch, rec, eps[0], label, witness=calibrate)

    # the two metrics over warm repeats of task 0, timed as the protocol
    # times them (each call ended by a sync, the logits copied to the host)
    seconds = {"personalise": [], "predict": []}
    for _ in range(PATH_REPEATS):
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
    print(f"  task 0 repeated {PATH_REPEATS}x, warm: query frames/s median "
          f"{statistics.median(fps):.1f} ({min(fps):.1f}-{max(fps):.1f}); time to personalise "
          f"median {statistics.median(pers):.2f} ms ({min(pers):.2f}-{max(pers):.2f}) ({card})")

    def warm_task():
        learner.predict_fn(learner.personalise_fn(ctx, labels, mask, class_mask), query,
                           class_mask)
    device_breakdown(torch, warm_task, card)
    return launches


def finetune_dw_breakdown(torch, card: str, rows: int, steps: int) -> None:
    """#4 and #6 by launch at the FineTuner's context batch (``rows`` clips
    of 50 tokens at ViT-B/32's width, bf16). Their grads launch forms the
    weight gradients beside dx (half of #4's products there, two thirds of
    #6's), which a FiLM step with the extractor frozen does not read; the
    bound of those dW products alone is printed beside."""
    from orbit_tpu_torch.ops import fused_mlp_block_backward, fused_qkv_attention_backward
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, s = 768, 50

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    x, cot = randn(rows, s, d).bfloat16(), randn(rows, s, d).bfloat16()
    qkv = (randn(d, 3 * d, scale=d ** -0.5).bfloat16(), randn(3 * d, scale=0.02))
    mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, 4 * d, scale=d ** -0.5).bfloat16(), randn(4 * d, scale=0.02),
           randn(4 * d, d, scale=(4 * d) ** -0.5).bfloat16())
    shape = f"ViT-B/32 B={rows}"
    launch_breakdown(torch, lambda: fused_qkv_attention_backward(x, *qkv, cot, DEPTH),
                     "fused_qkv_attention_bwd", card, shape=shape)
    launch_breakdown(torch, lambda: fused_mlp_block_backward(x, *mlp, cot, ln_eps=1e-5),
                     "fused_mlp_block_bwd", card, shape=shape)
    dw_flops = 2 * rows * s * (3 * d * d + 2 * 4 * d * d)
    print(f"  the dW products of #4 and #6 a layer at B={rows}: {dw_flops / 1e9:.3f} GFLOP, "
          f"bound {1e3 * dw_flops / PEAK_FLOPS['bfloat16']:.4f} ms; a FiLM personalise runs "
          f"them {DEPTH} x {steps} times ({card})")


def finetuner_phase(torch, card: str, workdir: Path, label: str, flags: list,
                    per_forward: dict, per_backward: dict | None = None,
                    calibrate: bool = False) -> dict:
    """Phases 8 and 9: the port's FineTuner through the multi-step learner
    (``--mode test --classifier linear``, ``flags`` naming the model, bf16,
    batch 256, 224 px, the CLI's defaults: 50 Adam steps at lr 0.001) over
    phase 4's two synthetic tasks, to ``results.json``.

    Before the run, through the kernels and through their plain versions:
    one inner step's gradients of the task parameters (the head, and with
    FiLM the FiLM leaves) at their initial values, under the loss's head
    term and a fixed upstream gradient of the context features (the zero
    head sends the FiLM leaves none at the first step); and task 0's whole
    personalise and predict, whose argmax must agree on at least 99% of
    the real query frames. A ViT is held in bf16, its gradients per tensor
    to PATH_REL_TOL as in phase 5. An EfficientNet (``calibrate``: its
    BatchNorm statistics set as in phase 6) is held to phase 7's limits:
    per tensor F32_PATH_GRAD_TOL and the argmax in f32, which must also see
    a wrong border planted in #8; BF16_PATH_GRAD_NORM_TOL of the norm in
    bf16, whose argmax agreement is printed beside the witness's (#8's
    plain version with its f32 stages in f64). The run must launch each
    kernel of ``per_forward`` that many times in every extractor forward,
    and each of ``per_backward`` in every backward of every inner step, and
    no other kernel; every task's head (and FiLM leaves) must move, and the
    results must carry ``task_macs_to_personalise``. Then task 0 repeated
    warm for the metrics, and a personalise of TRACE_STEPS inner steps
    traced; on a ViT, #4 and #6 by launch at the FineTuner's batch."""
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
        "--mode", "test", *flags, "--classifier", "linear", "--compute_dtype", "bfloat16",
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
    checks = ([("bfloat16", "tensor", PATH_REL_TOL, True)] if not calibrate else
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
    print(f"{label} (card: {card}): 224px bf16, batch {batch}, {len(tasks)} tasks, {steps} "
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
    seconds = {"personalise": [], "predict": []}
    for _ in range(FT_REPEATS):
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
    print(f"  task 0 repeated {FT_REPEATS}x, warm: time to personalise median "
          f"{statistics.median(pers):.2f} ms ({min(pers):.2f}-{max(pers):.2f}); query frames/s "
          f"median {statistics.median(fps):.1f} ({min(fps):.1f}-{max(fps):.1f}) ({card})")
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
        finetune_dw_breakdown(torch, card, ctx[0].shape[0], steps)
    marks.append(("repeats and traces", time.perf_counter()))
    print("  phase time: " + ", ".join(
        f"{label} {t - before:.1f} s"
        for (label, t), before in zip(marks, [started] + [t for _, t in marks])))
    return launches


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
    print_registers(kbuild.library_path().parent / "nvcc.log", WGMMA_KERNELS)

    # phase 3: the mainloop's layouts, then kernels vs plain versions
    mainloop_layout_phase(torch, card)
    rows = kernel_phase(torch, card)
    rows["fused_dw_act"] = dw_kernel_phase(torch, card)
    rows["mahalanobis_logits"] = mahalanobis_kernel_phase(torch, card)
    rows.update(attention_kernel_phase(torch, card))

    # phases 4 to 10: the ViT eval path, the ViT train path, the SimpleCNAPs
    # path, the SimpleCNAPs FiLM train path, the ViT-B/32-CLIP FineTuner with
    # FiLM, the EfficientNet-B0 FineTuner frozen and with FiLM, and the
    # EfficientNet-B0 ProtoNets+LITE meta-training with --learn_extractor,
    # each read alone
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
                    "learn_extractor": ["fused_dw_act"]}
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
                        "launches_by_path": {path: launches[name]
                                             for path, launches in paths.items()}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
