#!/usr/bin/env python
"""Times the bf16 kernels of the attention on a raw qkv (#1) and its
backward (#2), ``orbit_tpu_torch/csrc/tiny_attention.cu``, with one part
of their design taken away at a time, on an NVIDIA GPU:

- "no ring": one block a tile (item), so nothing is copied ahead;
- "one sequence a tile" (#1): tiles of one sequence instead of
  floor(128 / S);
- "4-byte stores": each lane stores its fragments' pairs instead of the
  rows' 16-byte segments (the source patched);
- "a block fewer an SM": each block asks for more shared memory than its
  ring needs (the source patched), so one block fewer fits an SM.

Each as ViT-B/32 and ViT-S/32 at B = 256, S = 50: the device time of the
kernel alone (``chip_smoke.py::device_ms``). Every variant's output is
checked against the plain version (``chip_smoke.py``'s tolerances) and, in
the unpatched build, against the planned launch bit for bit. A patched
variant is built from a copy of the package under
``build/attn_ablation/`` and timed in a process of its own.

    python3 scripts/attn_ablation_torch.py
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = (("vit_b_32", 768, 12), ("vit_s_32", 384, 6))
# variant -> (source text, its replacement) in csrc/tiny_attention.cu
PATCHES = {
    "4-byte stores": [("store_strip<false, true>", "store_strip<false, false>")],
    "a block fewer an SM": [
        ("tiny_attention_tile_kernel<<<blocks, kFwdThreads, fwd_smem(rows),",
         "tiny_attention_tile_kernel<<<blocks, kFwdThreads, kSmemLimit,"),
        ("constexpr size_t kBwdSmem = kStages * kBwdStageElems * sizeof(bf16);",
         "constexpr size_t kBwdSmem = 233472 / 2 - 1024;"),
    ],
}


def patched_copy(name: str) -> Path:
    """The package under build/attn_ablation/<name>/ with the variant's
    patches applied to its source."""
    root = REPO / "build" / "attn_ablation" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "orbit_tpu_torch", root / "orbit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / "orbit_tpu_torch" / "csrc" / "tiny_attention.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def time_variants(variant: str) -> None:
    """In this process: the package on sys.path[0] (the repo's own for
    "as planned"), each launch of ``variant`` timed against the plain
    version."""
    import torch

    import chip_smoke as cs
    from orbit_tpu_torch.kernels import build as kbuild
    from orbit_tpu_torch.kernels import plans
    from orbit_tpu_torch.ops.tiny_attention import tiny_attention, tiny_attention_backward

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = kbuild.library()
    card = cs.card_line()

    def fwd(qkv, heads, nseq, rows, blocks):
        n, s, d3 = qkv.shape
        out = torch.empty(n, s, d3 // 3, device=dev, dtype=qkv.dtype)
        kbuild.check(lib.orbit_tiny_attention_bf16(
            qkv.data_ptr(), out.data_ptr(), n, s, d3 // 3, heads, nseq, rows, blocks,
            torch.cuda.current_stream().cuda_stream), "tiny_attention")
        return out

    def bwd(qkv, cot, heads, blocks):
        n, s, d3 = qkv.shape
        dqkv = torch.empty_like(qkv)
        kbuild.check(lib.orbit_tiny_attention_bwd_bf16(
            qkv.data_ptr(), cot.data_ptr(), dqkv.data_ptr(), n, s, d3 // 3, heads, blocks,
            torch.cuda.current_stream().cuda_stream), "tiny_attention_bwd")
        return dqkv

    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for vit, d, heads in SHAPES:
        b, s = 256, 50
        qkv = (torch.randn(b, s, 3 * d, generator=g, device=dev) * 0.5).bfloat16()
        cot = torch.randn(b, s, d, generator=g, device=dev).bfloat16()
        fp = plans.attn_fwd_plan(b, s, heads, sms)
        bp = plans.attn_bwd_plan(b, s, heads, sms)
        # one sequence a tile: 64-row stages, as many blocks as the SMs hold
        one_blocks = min(heads * b, sms * plans.attn_per_sm(
            plans.attn_fwd_smem(plans.ATTN_KEYS), plans.ATTN_FWD_PER_SM))
        runs = {"as planned": {
            "#1": lambda: fwd(qkv, heads, fp.nseq, fp.rows, fp.blocks),
            "#2": lambda: bwd(qkv, cot, heads, bp.blocks)}}
        if variant == "as planned":
            runs["no ring"] = {"#1": lambda: fwd(qkv, heads, fp.nseq, fp.rows, fp.tiles),
                               "#2": lambda: bwd(qkv, cot, heads, bp.tiles)}
            runs["one sequence a tile"] = {
                "#1": lambda: fwd(qkv, heads, 1, plans.ATTN_KEYS, one_blocks)}
        elif variant == "a block fewer an SM":
            runs = {variant: {
                "#1": lambda: fwd(qkv, heads, fp.nseq, fp.rows,
                                  min(fp.tiles, sms * (fp.per_sm - 1))),
                "#2": lambda: bwd(qkv, cot, heads, min(bp.tiles, sms * (bp.per_sm - 1)))}}
        else:
            runs = {variant: runs["as planned"]}
        ref = {"#1": tiny_attention(qkv, heads, impl="reference"),
               "#2": tiny_attention_backward(qkv, cot, heads, impl="reference")}
        planned = {k: fn() for k, fn in runs["as planned"].items()} if "as planned" in runs else {}
        for name, kernels in runs.items():
            for k, fn in kernels.items():
                out = fn()
                torch.cuda.synchronize()
                where = f"{k} {vit} {name}"
                if k in planned and not torch.equal(out, planned[k]):
                    raise AssertionError(f"{where}: other bits than the planned launch")
                if k == "#1":
                    cs.compare(out, ref[k], *cs.KERNEL_TOL["bfloat16"], where)
                else:
                    cs.compare_grads([out], [ref[k]], cs.GRAD_TOL["bfloat16"], where)
                ms = cs.device_ms(torch, fn, "tiny_attention")
                print(f"  {k} bf16 {vit} B={b} {name}: {ms:.4f} ms on the device ({card})",
                      flush=True)


def main() -> int:
    if len(sys.argv) == 3:  # a child: the variant, the package's root
        sys.path[:0] = [sys.argv[2], str(REPO)]
        time_variants(sys.argv[1])
        return 0
    rc = 0
    for name in ("as planned", *PATCHES):
        root = REPO if name == "as planned" else patched_copy(name)
        rc |= subprocess.run([sys.executable, __file__, name, str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
