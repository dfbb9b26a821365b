#!/usr/bin/env python
"""Times the f32 routes of kernel A (fused qkv attention) and kernel B
(fused MLP block), ``orbit_tpu_torch/csrc/fused_qkv_attention.cu`` and
``mlp_block.cu`` on the f32 mainloop ``sgemm.cuh``, with one choice of
their design changed at a time, on an NVIDIA GPU:

- "128-row tiles for A": A's tiles are always 128 rows (2 sequences at
  S = 50), not the 160 (3 sequences) that ``plans.qkv_f32_rows`` takes
  there;
- "8 x 12 sums a thread for A": A's blocks have 2 BM threads (256 or 320)
  with 8 x 12 sums each, not 4 BM with 4 x 12;
- "stages of 16 x 4": the mainloop's ring of 4 stages of depth 16, not 3
  of 32, for both kernels;
- "stages of 32 x 4 for A": A's ring of 4 stages of depth 32;
- "64-row small tiles for B": where B's 128-row tiles would leave SMs
  without a block (fc2 at S = 5), 64-row tiles of 256 threads, not 32-row
  tiles of 128;
- "128-row tiles only for B": B's products always on 128-row tiles.

Each as ViT-B/32 at B = 256, S = 50 and S = 5 (84 px): the kernel's time,
a median of CUDA-event timed single calls (``chip_smoke.py::cuda_ms``),
beside the plain version's in the same process (the processes' times
differ by a few percent, so compare the ratios). Every variant's output is checked against the
plain version at ``chip_smoke.py``'s f32 limits. A variant is built from a
copy of the package under ``build/f32_ablation/``, its sources patched,
and timed in a process of its own.

    python3 scripts/f32_ablation_torch.py
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# variant -> (the kernels it times, [(file under orbit_tpu_torch, source
# text, its replacement)])
VARIANTS = {
    "as built": (("A", "B"), []),
    "128-row tiles for A": (("A",), [
        ("kernels/plans.py", "QKV_F32_TILES = (128, 160)", "QKV_F32_TILES = (128,)")]),
    "8 x 12 sums a thread for A": (("A",), [
        ("csrc/fused_qkv_attention.cu", "static constexpr int kThreads = 4 * BM;",
         "static constexpr int kThreads = 2 * BM;")]),
    "stages of 16 x 4": (("A", "B"), [
        ("csrc/sgemm.cuh", "constexpr int kBK = 32;", "constexpr int kBK = 16;"),
        ("csrc/sgemm.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "stages of 32 x 4 for A": (("A",), [
        ("csrc/sgemm.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "64-row small tiles for B": (("B",), [
        ("csrc/mlp_block.cu", "if (bm == 32) return launch_sgemm_tile<32, 128, 3>",
         "if (bm == 32) return launch_sgemm_tile<64, 256, 2>")]),
    "128-row tiles only for B": (("B",), [
        ("kernels/plans.py", "return 128 if -(-m // 128) * (n // SG_TILE_N) >= sms else 32",
         "return 128")]),
}


def patched_copy(name: str) -> Path:
    """The package under build/f32_ablation/<name>/ with the variant's
    patches applied (every occurrence of each source text)."""
    root = REPO / "build" / "f32_ablation" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "orbit_tpu_torch", root / "orbit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name][1]:
        path = root / "orbit_tpu_torch" / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {rel} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    return root


def time_variant(name: str) -> None:
    """In this process: the package on sys.path[0], the variant's kernels
    timed against their plain versions."""
    import torch

    import chip_smoke as cs
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    from orbit_tpu_torch.ops import fused_mlp_block, fused_qkv_attention

    configure_matmul_precision()  # f32 matmuls in full f32 (TF32 off)
    card = cs.card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    d, heads, b = 768, 12, 256
    for s in (50, 5):
        x = randn(b, s, d)
        qkv = (randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1))
        mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1), randn(d, 4 * d, scale=d ** -0.5),
               randn(4 * d, scale=0.02), randn(4 * d, d, scale=(4 * d) ** -0.5),
               randn(d, scale=0.02))
        runs = {"A": lambda impl: fused_qkv_attention(x, *qkv, heads, impl=impl),
                "B": lambda impl: fused_mlp_block(x, *mlp, ln_eps=1e-6, impl=impl)}
        for kernel in VARIANTS[name][0]:
            run = runs[kernel]
            with torch.inference_mode():
                ours, ref = run(None), run("reference")
                torch.cuda.synchronize()
                cs.compare(ours, ref, *cs.KERNEL_TOL["float32"], f"{kernel} {name} S={s}")
                ms = cs.cuda_ms(lambda: run(None))
                plain_ms = cs.cuda_ms(lambda: run("reference"))
            print(f"  {kernel} f32 ViT-B/32 B={b} S={s}, {name}: {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, kernel over plain {ms / plain_ms:.3f} ({card})", flush=True)


def main() -> int:
    if len(sys.argv) == 3:  # a child: the variant, the package's root
        sys.path[:0] = [sys.argv[2], str(REPO)]
        time_variant(sys.argv[1])
        return 0
    rc = 0
    for name in VARIANTS:
        root = REPO if name == "as built" else patched_copy(name)
        rc |= subprocess.run([sys.executable, __file__, name, str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
