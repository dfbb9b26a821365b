#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``orbit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which passes or raises:
1. card: the ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``orbit_tpu_torch/csrc``, timed;
3. kernels: kernel A (fused qkv attention), kernel B (fused MLP block) and
   their backward kernels against their plain PyTorch versions on the card,
   at the ViT-B/32 and ViT-S/32 shapes (B = 256 and a ragged 13, S = 50), in
   f32 and bf16; timed with CUDA events at B = 256, each beside its bound,
   and repeated at B = 256 to show that a second call gives the same bits;
4. main path: the CLU-VE test protocol of the port's single-step learner on
   ViT-B/32 at full width (224 px, 12 layers, D = 768; random weights from
   ``--seed``), bf16 compute, proto head, batch 256, over two synthetic
   uint8 tasks made in memory (5 objects, about 8 context clips each, one
   200-frame clutter video per object), through ``pad_episode``, the
   learner's protocol loop and ``TestEvaluator`` to ``results.json``. The
   launch counters must show both kernels in every encoder layer of every
   extractor forward; one task is rerun with the plain versions and must
   agree.
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
   through the kernels must agree with those through the plain versions.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
ARGMAX_AGREEMENT = 0.99

KERNELS = {
    "fused_qkv_attention": ("orbit_tpu_torch/csrc/fused_qkv_attention.cu",
                            "orbit_tpu/ops/tiny_attention.py:344"),
    "fused_mlp_block": ("orbit_tpu_torch/csrc/mlp_block.cu",
                        "orbit_tpu/ops/mlp_block.py:102"),
    "fused_qkv_attention_bwd": ("orbit_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
                                "orbit_tpu/ops/tiny_attention.py:392"),
    "fused_mlp_block_bwd": ("orbit_tpu_torch/csrc/mlp_block_bwd.cu",
                            "orbit_tpu/ops/mlp_block.py:172"),
}
# The least time one H100 SXM could take (NVIDIA's data sheet, dense peaks
# at the full 700 W): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
# outside them, 3.35 TB/s of device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


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
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_abs)
                    print(line)
    return rows


def synthetic_tasks(num_tasks: int = 2, frame_size: int = 224,
                    video_frames: int = 200, seed: int = SEED):
    """Test-mode task dicts (orbit_tpu/data/loader.py:229-247 keys) with
    uint8 frames made in memory: per object a colour and a stripe pattern
    plus noise, about 8 context clips and one clutter video of
    ``video_frames`` frames."""
    import numpy as np

    rng = np.random.default_rng(seed)
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
                          seed: int = SEED, target_shots: int = 60):
    """Train-mode task dicts (the loader's train keys: flat target clips)
    with uint8 frames made in memory, 5 objects each: 8 context clips and
    ``target_shots`` target clips per object (40 and 300 a task by default).
    A task's objects share one colour and differ by at most 2 levels per
    channel under noise of +-20, so the random-weight recogniser's logits
    stay within about ten of each other: the loss and its gradients do not
    saturate (distinct objects give logits hundreds apart and a loss of 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
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


def main_path_phase(torch, card: str, workdir: Path, extractor: str = "vit_b_32",
                    frame_size: int = 224, video_frames: int = 200) -> dict:
    """Phase 4: the port's CLU-VE test path (ViT-B/32 at 224 px unless told
    otherwise), then one task rerun with the plain versions of the kernels."""
    import numpy as np

    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from orbit_tpu_torch.utils.args import parse_args

    batch = 256
    args = parse_args("single-step-learner", [
        "--data_path", str(workdir / "data"), "--checkpoint_dir", str(workdir / "ckpt"),
        "--mode", "test", "--feature_extractor", extractor, "--classifier", "proto",
        "--compute_dtype", "bfloat16", "--batch_size", str(batch),
        "--frame_size", str(frame_size), "--num_test_tasks", "1", "--seed", str(SEED)])
    tasks = synthetic_tasks(frame_size=frame_size, video_frames=video_frames)
    learner = SingleStepLearner(args, test_queue=TaskQueue(tasks))

    # keep every logits tensor the protocol computes, to check them after
    logits_seen = []
    predict = SingleStepFewShotRecogniser.predict

    def predict_kept(self, *args, **kwargs):
        out = predict(self, *args, **kwargs)
        logits_seen.append(out)
        return out

    SingleStepFewShotRecogniser.predict = predict_kept
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        learner.run()
        if learner.device.type == "cuda":
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

    # every extractor forward (one per chunk of <= batch frames) runs both
    # kernels once per encoder layer; one untimed warm-up personalise first
    eps = [pad_episode(t) for t in tasks]
    ctx_chunks = [math.ceil(ep.context_clips.shape[0] / batch) for ep in eps]
    query_chunks = [math.ceil(sum(v.shape[0] for v in ep.video_frames) / batch) for ep in eps]
    expected_chunks = ctx_chunks[0] + sum(ctx_chunks) + sum(query_chunks)
    forwards = learner.recogniser.extractor.forward_calls
    if forwards != expected_chunks:
        raise AssertionError(f"{forwards} extractor forwards, expected {expected_chunks}")
    for name in ("fused_qkv_attention", "fused_mlp_block"):
        if launches[name] != DEPTH * forwards:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{DEPTH} x {forwards}")

    timings = learner.test_timings
    per_frame = statistics.mean(timings["inference_per_frame"])
    personalise = statistics.mean(timings["personalise"])
    query_frames = sum(int(m.sum()) for ep in eps for m in ep.video_masks)
    print(f"main path (card: {card}): {extractor} {frame_size}px bf16 proto, batch {batch}, "
          f"{len(tasks)} tasks, {query_frames} query frames, {forwards} extractor "
          f"forwards, wall {wall:.2f} s")
    print(f"  query frames/s: {1.0 / per_frame:.1f}; time to personalise: "
          f"{personalise * 1e3:.2f} ms per task ({card})")

    # rerun task 0 with the plain versions; the same frames through the kernels
    rec = learner.recogniser
    ep = eps[0]
    dev = learner.device
    ctx = torch.from_numpy(ep.context_clips).to(dev)
    labels = torch.from_numpy(ep.context_labels.astype(np.int64)).to(dev)
    mask = torch.from_numpy(ep.context_mask).to(dev)
    class_mask = torch.from_numpy(ep.class_mask).to(dev)
    query = torch.from_numpy(np.concatenate(ep.video_frames)[:, None]).to(dev)
    real = np.concatenate([m > 0 for m in ep.video_masks])
    out = {}
    for impl in (None, "reference"):
        rec.extractor.impl = impl
        with torch.inference_mode():
            state = rec.personalise(ctx, labels, mask, ep.num_classes)
            out[impl] = (rec.embed_clips(ctx), rec.predict(state, query, class_mask))
    rec.extractor.impl = None
    (fk, lk), (fr, lr) = out[None], out["reference"]
    if not (torch.isfinite(lk).all() and torch.isfinite(fk).all()):
        raise AssertionError("non-finite features or logits on the kernel path")
    present = class_mask.bool()  # padded classes hold -1e30 on both sides
    for what, a, b in (("features", fk, fr),
                       ("logits", lk[:, present], lr[:, present])):
        scale = float(b.abs().max())
        max_abs, max_rel = compare(a, b, 0.0, PATH_REL_TOL * scale, f"main path {what}")
        print(f"  kernels vs plain, task 0 {what}: max abs {max_abs:.3e}, "
              f"max rel {max_rel:.3e}")
    agree = float((lk.argmax(-1) == lr.argmax(-1)).cpu().numpy()[real].mean())
    print(f"  argmax agreement on {int(real.sum())} real query frames: {agree:.4f}")
    if agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {agree:.4f} < {ARGMAX_AGREEMENT}")
    return launches


def train_path_phase(torch, card: str, workdir: Path, extractor: str = "vit_b_32",
                     frame_size: int = 224, target_shots: int = 60) -> dict:
    """Phase 5: the port's LITE meta-training path (ViT-B/32 at 224 px
    unless told otherwise) in ``--mode train_test``; before it, one task's
    gradients through the kernels against those through the plain
    versions."""
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners import steps as steps_lib
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.backbones.vit import ViT
    from orbit_tpu_torch.utils.args import parse_args

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
    learner = SingleStepLearner(
        args, train_queue=TaskQueue(train_tasks),
        validation_queue=TaskQueue(synthetic_tasks(1, frame_size, seed=SEED + 1)),
        test_queue=TaskQueue(synthetic_tasks(2, frame_size, seed=SEED + 2)))
    batches = [math.ceil(len(t["target_labels"]) / batch) for t in train_tasks]

    # One task, the same injected subsets, through the kernels and through
    # the plain versions. (a) The whole LITE step: its losses and its
    # gradients' largest difference, per tensor against its largest value,
    # are printed. They are not held to PATH_REL_TOL: the proto logits are
    # about a hundred times their spread across classes (|f|^2 is about D),
    # so the bf16 drift of the features through 12 layers (about 1e-2 of
    # their size, phase 4) moves the logits by about 1 and reweights the
    # loss's softmax by tens of percent, whatever the kernels do. (b) The
    # step's two differentiated forwards (its grad subset and its first
    # target batch) under one fixed upstream gradient of the features, which
    # takes that sensitivity out: held to PATH_REL_TOL per tensor.
    rec = learner.recogniser
    dev = learner.device
    episode = learner._train_episode(pad_episode(train_tasks[0]))
    gen = torch.Generator().manual_seed(SEED)
    subsets = [steps_lib.lite_grad_subset(gen, episode["context_mask"], num_lite)
               for _ in range(batches[0])]
    step = steps_lib.build_train_task_lite(rec, args)
    forwards_in = (episode["context_clips"][subsets[0].to(dev)],
                   episode["target_clips"][:batch])
    g = torch.Generator(device=dev).manual_seed(SEED)
    upstream = [torch.randn(c.shape[0], rec.output_size, generator=g, device=dev)
                for c in forwards_in]
    grads, fixed, step_loss = {}, {}, {}
    for impl in (None, "reference"):
        rec.extractor.impl = impl
        rec.zero_grad(set_to_none=True)
        step_loss[impl] = float(step(episode, grad_idxs=subsets)[0])
        grads[impl] = [p.grad.clone() for p in rec.extractor.parameters()]
        rec.zero_grad(set_to_none=True)
        sum((rec.embed_clips(c, with_grad=True) * u).sum()
            for c, u in zip(forwards_in, upstream)).backward()
        fixed[impl] = [p.grad.clone() for p in rec.extractor.parameters()]
    rec.extractor.impl = None
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
    del grads, fixed

    # the learner's run, with its updates and losses checked
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
            moved.append((sum(changed), sum(had_grad), len(params)))
        return run

    forwards = [0]
    vit_forward = ViT.forward

    def counted_forward(self, x):
        forwards[0] += 1
        return vit_forward(self, x)

    steps_lib.build_train_task_lite, steps_lib.build_apply_update = recorded_lite, checked_update
    ViT.forward = counted_forward
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        learner.run()
        torch.cuda.synchronize()
    finally:
        steps_lib.build_train_task_lite, steps_lib.build_apply_update = build_lite, build_update
        ViT.forward = vit_forward
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)

    if len(losses) != len(train_tasks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if len(moved) != math.ceil(len(train_tasks) / args.tasks_per_batch):
        raise AssertionError(f"{len(moved)} optimiser updates")
    # both differentiated forwards of a target batch (the grad subset and
    # the target clips) run both backward kernels once per encoder layer
    for name in ("fused_qkv_attention_bwd", "fused_mlp_block_bwd"):
        if launches[name] != DEPTH * 2 * sum(batches):
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{DEPTH} x 2 x {sum(batches)} target batches")
    for name in ("fused_qkv_attention", "fused_mlp_block"):
        if launches[name] != DEPTH * forwards[0]:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{DEPTH} x {forwards[0]} extractor forwards")
    if not Path(learner.test_evaluator.json_results_path).exists():
        raise AssertionError("the test protocol after training wrote no results.json")
    steps = learner.train_step_seconds
    print(f"  {len(train_tasks)} tasks, {sum(batches)} target batches, {len(moved)} "
          f"updates (parameter tensors moved, with a nonzero gradient, in all: "
          f"{moved}), losses "
          f"{[round(x, 6) for x in losses]}, {forwards[0]} extractor forwards, "
          f"wall {wall:.2f} s")
    print(f"  time per task step: {1e3 * statistics.mean(steps):.2f} ms (each: "
          f"{[round(1e3 * x, 2) for x in steps]}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    return launches


def main() -> int:
    if not (REPO / "orbit_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of an orbit-tpu checkout "
              "(orbit_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
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

    # phase 3: kernels vs plain versions
    rows = kernel_phase(torch, card)

    # phases 4 and 5: the eval path, then the train path, each read alone
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        eval_launches = main_path_phase(torch, card, Path(tmp) / "eval")
        train_launches = train_path_phase(torch, card, Path(tmp) / "train")
    for path, launches in (("eval", eval_launches), ("train", train_launches)):
        unused = [n for n in KERNELS if launches[n] < 1 and (path == "train" or
                                                             not n.endswith("_bwd"))]
        if unused:
            raise AssertionError(f"not launched on the {path} path: {unused}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # the forward kernels' count is the eval path's, the backward
        # kernels' the train path's; no single PyTorch call computes any of
        # the four functions, so there is no library time
        launches = (train_launches if name.endswith("_bwd") else eval_launches)[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": rows[name]["max_abs_err"],
                        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                        "bound_ms": rows[name]["bound_ms"],
                        "bound_by": rows[name]["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
