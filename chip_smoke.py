#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``orbit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which passes or raises:
1. card: the ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``orbit_tpu_torch/csrc``, timed;
3. kernels: kernel A (fused qkv attention) and kernel B (fused MLP block)
   against their plain PyTorch versions on the card, at the ViT-B/32 and
   ViT-S/32 shapes (B = 256 and a ragged 13, S = 50), in f32 and bf16, and
   timed with CUDA events at B = 256;
4. main path: the CLU-VE test protocol of the port's single-step learner on
   ViT-B/32 at full width (224 px, 12 layers, D = 768; random weights from
   ``--seed``), bf16 compute, proto head, batch 256, over two synthetic
   uint8 tasks made in memory (5 objects, about 8 context clips each, one
   200-frame clutter video per object), through ``pad_episode``, the
   learner's protocol loop and ``TestEvaluator`` to ``results.json``. The
   launch counters must show both kernels in every encoder layer of every
   extractor forward; one task is rerun with the plain versions and must
   agree.

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
# Main path, kernels vs plain versions through all 12 bf16 layers: per-op
# differences of an ulp feed the residual stream layer after layer; allow
# 2^-4 of the largest value for features and logits, and require the same
# argmax on at least 99% of the real query frames.
PATH_REL_TOL = 2.0 ** -4
ARGMAX_AGREEMENT = 0.99

KERNELS = {
    "fused_qkv_attention": ("orbit_tpu_torch/csrc/fused_qkv_attention.cu",
                            "orbit_tpu/ops/tiny_attention.py:344"),
    "fused_mlp_block": ("orbit_tpu_torch/csrc/mlp_block.cu",
                        "orbit_tpu/ops/mlp_block.py:102"),
}


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


def kernel_phase(torch, card: str) -> dict:
    """Phase 3: every kernel against its plain version at the path's shapes."""
    from orbit_tpu_torch.ops import fused_mlp_block, fused_qkv_attention

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
                qkv = (randn(d, 3 * d, scale=d ** -0.5).to(dt), randn(3 * d, scale=0.1).to(dt))
                mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
                       randn(d, 4 * d, scale=d ** -0.5).to(dt), randn(4 * d, scale=0.02),
                       randn(4 * d, d, scale=(4 * d) ** -0.5).to(dt), randn(d, scale=0.02))
                runs = {
                    "fused_qkv_attention": lambda impl: fused_qkv_attention(
                        x, *qkv, heads, impl=impl),
                    "fused_mlp_block": lambda impl: fused_mlp_block(
                        x, *mlp, ln_eps=1e-6, impl=impl),
                }
                for name, run in runs.items():
                    with torch.inference_mode():
                        ours, ref = run(None), run("reference")
                    torch.cuda.synchronize()
                    where = f"{name} {vit} {dtype_name} B={b}"
                    max_abs, max_rel = compare(ours, ref, rtol, atol, where)
                    line = f"  {where}: max abs {max_abs:.3e}, max rel {max_rel:.3e}"
                    if b == 256:
                        with torch.inference_mode():
                            ms = cuda_ms(lambda: run(None))
                            plain_ms = cuda_ms(lambda: run("reference"))
                        line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                        if vit == "vit_b_32" and dtype_name == "bfloat16":
                            rows[name].update(ms=ms, plain_ms=plain_ms)
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

    from orbit_tpu.data.episodes import pad_episode
    from orbit_tpu.utils.args import parse_args
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

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
    for name, n in launches.items():
        if n != DEPTH * forwards:
            raise AssertionError(f"{name}: {n} launches, expected {DEPTH} x {forwards}")

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

    # phase 4: main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = main_path_phase(torch, card, Path(tmp))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rows[name]["max_abs_err"],
                        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
