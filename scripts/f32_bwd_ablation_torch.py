#!/usr/bin/env python
"""Times the f32 routes of the backward kernels #4 (fused qkv attention
backward) and #6 (fused MLP block backward), whose weight and data
gradients share one launch on the f32 mainloop
(``orbit_tpu_torch/csrc/sgemm_grads.cuh``), with the launch's plan
(``kernels/plans.py::sgemm_grads_plan``) or #6's hidden tiles
(``plans.hidden_f32_rows``) changed one choice at a time, on an NVIDIA GPU:

- "as built": data tiles of 64 rows where 128-row ones would leave SMs
  idle, the weight gradients' K cut into runs no longer than a data
  block's work, the runs added by a second pass; #6's hidden kernel on
  64-row tiles where 128-row ones would give an SM fewer than two blocks;
- "no runs of K": each weight tile walks all the rows;
- "128-row data tiles": data tiles always of 128 rows;
- "runs for every SM": runs only where the weight tiles number fewer
  than the SMs, as many as give every SM a weight block;
- "128-row hidden tiles" (#6): the hidden kernel always on 128-row tiles.

Each at the shapes the f32 ViT paths give the kernels (ViT-B/32 at B 256
with S 50 and S 5, the FineTuner's B 64, the train path's ragged B 44 and
its LITE subsets' B 16, ``chip_smoke.py``'s ragged B 13; ViT-S/32 at B
256): the kernel's time, a median
of CUDA-event timed single calls (``chip_smoke.py::cuda_ms``), beside the
plain version's in the same process. Every variant's gradients are held
against the plain version at ``chip_smoke.py``'s f32 limit (GRAD_TOL, per
tensor against its largest value). The plan is chosen on the host, so
every variant runs in one process on one build.

    python3 scripts/f32_bwd_ablation_torch.py
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((768, 12, 256, 50), (768, 12, 256, 5), (768, 12, 64, 50), (768, 12, 44, 50),
          (768, 12, 16, 50), (768, 12, 13, 50), (384, 6, 256, 50))


def variants(plans):
    """name -> (the grads launch's plan, #6's hidden tile rows)"""
    built, hidden = plans.sgemm_grads_plan, plans.hidden_f32_rows

    def every_sm(rows, weights, data, sms):
        nk = -(-rows // plans.SG_BK)
        w_tiles = sum(plans.tiles(m, n) for m, n in weights)
        split = min(nk, -(-sms // w_tiles)) if w_tiles < sms else 1
        return built(rows, weights, data, sms)[0], -(-nk // -(-nk // split))

    return {"as built": (built, hidden),
            "no runs of K": (lambda *a: (built(*a)[0], 1), hidden),
            "128-row data tiles": (lambda *a: (plans.TILE, built(*a)[1]), hidden),
            "runs for every SM": (every_sm, hidden),
            "128-row hidden tiles": (built, lambda *a: plans.TILE)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("f32_bwd_ablation_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.kernels import plans
    from orbit_tpu_torch.models.precision import configure_matmul_precision
    from orbit_tpu_torch.ops import fused_mlp_block_backward, fused_qkv_attention_backward
    configure_matmul_precision()
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    sms = kbuild.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    built, hidden, ways = plans.sgemm_grads_plan, plans.hidden_f32_rows, variants(plans)
    print(f"#4 and #6 f32, kernel ms (kernel over plain) by the grads launch's plan (x_rows, "
          f"wsplit; #6: hidden tile rows first) ({card}):")
    for d, heads, b, s in SHAPES:
        x, cot = randn(b, s, d), randn(b, s, d)
        qkv = (randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1))
        mlp = (1 + randn(d, scale=0.1), randn(d, scale=0.1), randn(d, 4 * d, scale=d ** -0.5),
               randn(4 * d, scale=0.02), randn(4 * d, d, scale=(4 * d) ** -0.5))
        runs = {"#4": (lambda i: fused_qkv_attention_backward(x, *qkv, cot, heads, impl=i),
                       [(d, 3 * d)], (d, 3 * d)),
                "#6": (lambda i: fused_mlp_block_backward(x, *mlp, cot, ln_eps=1e-6, impl=i),
                       [(d, 4 * d), (4 * d, d)], (d, 4 * d))}
        for name, (run, weights, data) in runs.items():
            with torch.inference_mode():
                ref = run("reference")
                plain = chip_smoke.cuda_ms(lambda: run("reference"))
                parts = []
                try:
                    for way, (plan, rows_of) in ways.items():
                        if name == "#4" and rows_of is not hidden:
                            continue  # #4 has no hidden kernel
                        plans.sgemm_grads_plan, plans.hidden_f32_rows = plan, rows_of
                        chip_smoke.compare_grads(run(None), ref, chip_smoke.GRAD_TOL["float32"],
                                                 f"{name} {way}")
                        ms = chip_smoke.cuda_ms(lambda: run(None))
                        shown = plan(b * s, weights, data, sms)
                        if name == "#6":
                            shown = (rows_of(b * s, 4 * d, sms), *shown)
                        parts.append(f"{way} {shown} {ms:.4f} ({ms / plain:.3f})")
                finally:
                    plans.sgemm_grads_plan, plans.hidden_f32_rows = built, hidden
            print(f"  {name} D={d} B={b} S={s}: plain {plain:.4f}; " + "; ".join(parts),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
