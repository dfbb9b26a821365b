#!/usr/bin/env python
"""Write, or check, the golden file of the JAX package's outputs at
published widths: ``data/golden_torch/golden.npz`` and ``manifest.json``.

    JAX_PLATFORMS=cpu python scripts/make_golden_torch.py           # write the file
    JAX_PLATFORMS=cpu python scripts/make_golden_torch.py --check   # recompute, compare bit for bit

For every record of ``orbit_tpu_torch/models/golden.py::RECORDS`` the JAX
package (``orbit_tpu``) runs once on the CPU, on the record's fake reference
checkpoint (``golden.reference_state_dict``) through its own converter
(``orbit_tpu.models.convert.convert_recogniser_checkpoint``) and on the
record's inputs (``golden.draw_inputs``): the extractor's features, a
personalise-then-predict pass, the FineTuner's inner loop, or the flagship
forward of ``__graft_entry__.entry``. An EfficientNet's BatchNorm
statistics are first calibrated by the port on the record's frames
(``golden.calibrate``, one torch thread) and given to both packages. The
JAX side runs every stride-1 depthwise tail through its fused op
(``efficientnet.DW_FUSED = True``), the route the port always takes, and
casts the extractor as ``--compute_dtype bfloat16`` does for the bf16
record. ``--check`` recomputes every array and compares it with the file
bit for bit; it exits 1 on any difference.

The manifest keeps each record's configuration, its inputs' shapes and
SHA-256 (the replay refuses other draws), its outputs' shapes, the
smallest argmax margin of its logits (top-1 less top-2 over the largest
magnitude, real classes), the seconds the JAX side took, and the commits
of the repository and of the JAX package it was made from.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _git(*args) -> str:
    return subprocess.run(["git", "-C", str(REPO), *args], capture_output=True, text=True,
                          check=True).stdout.strip()


def _components(record) -> list:
    comps = ["extractor"]
    if record.adapt_features:
        comps += ["set_encoder", "film_generator"]
    if record.classifier == "versa":
        comps.append("versa")
    return comps


def jax_outputs(record, stats: dict, x: dict) -> dict:
    """The JAX package's outputs of ``record`` on the inputs ``x``, an
    EfficientNet under the calibrated statistics ``stats``."""
    import jax
    import jax.numpy as jnp

    from orbit_tpu.models.convert import convert_recogniser_checkpoint
    from orbit_tpu.models.precision import cast_extractor_params
    from orbit_tpu.models.recognisers import (MultiStepFewShotRecogniser,
                                              SingleStepFewShotRecogniser)
    from orbit_tpu_torch.models import golden

    bf16 = record.dtype == "bfloat16"
    cls = MultiStepFewShotRecogniser if record.kind == "finetuner" else \
        SingleStepFewShotRecogniser
    rec = cls(feature_extractor_name=record.backbone, adapt_features=record.adapt_features,
              classifier=record.classifier, batch_size=golden.BATCH_SIZE,
              dtype=jnp.bfloat16 if bf16 else jnp.float32)
    skeleton = {"params": {k: {} for k in _components(record)}}
    sd = golden.reference_state_dict(record, stats)
    variables = jax.tree_util.tree_map(np.asarray,
                                       convert_recogniser_checkpoint(sd, rec, skeleton))
    if bf16:
        variables = cast_extractor_params(variables)
    if record.kind == "features":
        out = jax.jit(lambda v, c: rec.embed_clips(v, c, None, train=False,
                                                   with_grad=False))(variables, x["clips"])
        return {"features": np.asarray(out, np.float32)}
    if record.kind == "flagship":
        import __graft_entry__

        forward, example_args = __graft_entry__.entry()
        ours = [x[k] for k in ("context_clips", "context_labels", "context_mask",
                               "class_mask", "target_clips")]
        if not all(np.array_equal(a, np.asarray(b)) for a, b in zip(ours, example_args[1:])):
            raise AssertionError("the port's flagship episode is not __graft_entry__'s")
        return {"logits": np.asarray(jax.jit(forward)(variables, *example_args[1:]),
                                     np.float32)}
    ctx = (x["context_clips"], x["context_labels"], x["context_mask"])
    if record.kind == "finetuner":
        from orbit_tpu.learners.multi_step import build_finetune_fns

        personalise, predict = build_finetune_fns(rec, golden.finetune_args())
        params = personalise(variables, *ctx, x["class_mask"])
        return {"logits": np.asarray(predict(variables, params, x["query_clips"],
                                             x["class_mask"]), np.float32)}

    def forward(v, c, labels, mask, query, class_mask):
        state = rec.personalise(v, c, labels, mask, golden.NUM_CLASSES, train=False,
                                with_grad=False)
        return rec.predict(v, state, query, class_mask=class_mask)
    return {"logits": np.asarray(jax.jit(forward)(variables, *ctx, x["query_clips"],
                                                  x["class_mask"]), np.float32)}


def argmax_margin(logits: np.ndarray, class_mask: np.ndarray) -> float:
    real = logits[:, class_mask > 0]
    top = np.sort(real, axis=1)
    return float((top[:, -1] - top[:, -2]).min() / np.abs(real).max())


def compute() -> tuple:
    """(arrays, manifest records) of every golden record."""
    import torch

    import orbit_tpu.models.backbones.efficientnet as jax_eff
    from orbit_tpu_torch.models import golden

    torch.set_num_threads(1)
    arrays, records = {}, {}
    saved = jax_eff.DW_FUSED
    jax_eff.DW_FUSED = True
    try:
        for record in golden.RECORDS:
            x = golden.draw_inputs(record)
            stats = {}
            if record.backbone.startswith("efficientnet"):
                stats = golden.calibrate(record, x)
                arrays.update({f"{golden.stats_key(record)}{k}": v for k, v in stats.items()})
            t0 = time.perf_counter()
            outputs = jax_outputs(record, stats, x)
            seconds = time.perf_counter() - t0
            entry = {"config": asdict(record),
                     "inputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                                    "sha256": golden.digest(v)} for k, v in x.items()},
                     "outputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                                 for k, v in outputs.items()},
                     "jax_seconds": round(seconds, 1)}
            if "logits" in outputs:
                entry["argmax_margin"] = argmax_margin(outputs["logits"], x["class_mask"])
            records[record.name] = entry
            arrays.update({f"{record.name}/{k}": v for k, v in outputs.items()})
            print(f"{record.name}: {', '.join(f'{k} {v.shape}' for k, v in outputs.items())} "
                  f"in {seconds:.1f} s", flush=True)
    finally:
        jax_eff.DW_FUSED = saved
    return arrays, records


def main(argv=None) -> int:
    from orbit_tpu_torch.models import golden

    parser = argparse.ArgumentParser(description="the golden file of the JAX package's outputs")
    parser.add_argument("--check", action="store_true",
                        help="recompute every array and compare it with the file bit for bit")
    parser.add_argument("--out", type=Path, default=golden.GOLDEN_DIR)
    opts = parser.parse_args(argv)
    t0 = time.perf_counter()
    arrays, records = compute()
    if opts.check:
        manifest, stored = golden.load(opts.out)
        bad = sorted(set(arrays) ^ set(stored))
        bad += [k for k in arrays if k in stored and not (
            arrays[k].dtype == stored[k].dtype and np.array_equal(arrays[k], stored[k]))]
        bad += [f"{name}: inputs" for name, rec in records.items()
                if rec["inputs"] != manifest["records"][name]["inputs"]]
        print(f"--check: {len(arrays)} arrays recomputed in {time.perf_counter() - t0:.1f} s; "
              f"{'all equal to the file bit for bit' if not bad else f'differ: {bad[:10]}'}")
        return 1 if bad else 0
    opts.out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(opts.out / "golden.npz", **arrays)
    import jax
    import torch
    manifest = {
        "about": "the JAX package's outputs at published widths on fake upstream weights, "
                 "made by scripts/make_golden_torch.py; replayed by "
                 "orbit_tpu_torch/models/golden.py",
        "commit": _git("rev-parse", "HEAD"),
        "jax_package_commit": _git("log", "-1", "--format=%H", "--", "orbit_tpu"),
        "versions": {"numpy": np.__version__, "jax": jax.__version__,
                     "torch": torch.__version__},
        "seed": golden.SEED,
        "calibrated": sorted({k.split("/")[1] for k in arrays if k.startswith("stats/")}),
        "seconds": round(time.perf_counter() - t0, 1),
        "records": records}
    (opts.out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    size = (opts.out / "golden.npz").stat().st_size
    print(f"wrote {opts.out} ({size / 2**20:.2f} MiB, {len(arrays)} arrays) in "
          f"{manifest['seconds']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
