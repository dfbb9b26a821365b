"""Golden records: the JAX package's outputs at published widths, and their
replay through the port.

``scripts/make_golden_torch.py`` runs the JAX package once, on the CPU, on
the fake upstream state dicts of ``models/fakes.py``, and writes
``data/golden_torch/golden.npz`` (each record's outputs, and the
EfficientNets' calibrated BatchNorm statistics) beside
``manifest.json`` (each record's configuration, its inputs' shapes and
SHA-256, the commit it was made at). Nothing here imports JAX:
:func:`replay` runs a record through the port on any device, and the
callers hold its outputs against the stored ones, ``tests/
test_torch_golden.py`` on the CPU through the plain versions and
``chip_smoke.py``'s phase 15 on the card through the kernels and the plain
versions.

Weights. Each record's recogniser loads one fake reference checkpoint
(:func:`reference_state_dict`: the upstream extractor under
``feature_extractor.``, and with FiLM the set encoder, FiLM generator and
Versa processors of ``fakes.fake_reference_cnaps``) through the port's
converter (``convert.convert_recogniser_checkpoint``); the generator gives
the same state dict to the JAX package's converter. A fake EfficientNet's
BatchNorm statistics lose the input within a few blocks, so they are
replaced by statistics calibrated on the record's own frames, as
``chip_smoke.py`` calibrates on a task's frames (:func:`calibrate`:
``efficientnet.calibrate_batchnorm``, f32 on the CPU), which the file
keeps by their timm names (``stats/<record>/blocks.1.0.bn1.running_mean``);
the replay does not calibrate.

Inputs. uint8 frames of a colour per class under noise (:func:`task`),
drawn with numpy from the record's name; the flagship record takes
``graft_entry_torch.py``'s own episode (float frames). :func:`inputs`
refuses a draw whose SHA-256 differs from the manifest's (another numpy's
stream), so a replay never compares other inputs.
"""
from __future__ import annotations

import functools
import hashlib
import json
import zlib
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from orbit_tpu_torch.models import convert, fakes
from orbit_tpu_torch.models.backbones import FEATURE_EXTRACTORS, create_feature_extractor
from orbit_tpu_torch.models.backbones.efficientnet import ARCHS, STEM_CHS, calibrate_batchnorm
from orbit_tpu_torch.models.backbones.vit import VIT_CONFIGS
from orbit_tpu_torch.models.precision import cast_extractor_params
from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                SingleStepFewShotRecogniser)

GOLDEN_DIR = Path(__file__).resolve().parents[2] / "data" / "golden_torch"
SEED = 16
BATCH_SIZE = 256
NUM_CLASSES = 16                  # class slots of a padded episode
WAY, CONTEXT, QUERY = 5, 5, 10    # the logits records' task: one clip a class
FEATURE_FRAMES = 4
# the FineTuner record's inner loop: the CLI's Adam at lr 0.001, 5 steps
FINETUNE_ARGS = dict(personalize_num_grad_steps=5, personalize_learning_rate=0.001,
                     personalize_optimizer="adam", personalize_weight_decay=0.0,
                     personalize_extractor_lr_scale=1.0, personalize_epsilon=1e-8,
                     personalize_betas=(0.9, 0.999), personalize_momentum=0.0,
                     batch_size=BATCH_SIZE)


@dataclass(frozen=True)
class Record:
    """One golden record: ``kind`` "features" (the extractor's f32
    features of FEATURE_FRAMES frames), "logits" (personalise on the task's
    context, predict its query), "finetuner" (the FineTuner's inner loop,
    then the query's logits) or "flagship" (``graft_entry_torch.entry``'s
    forward)."""
    name: str
    kind: str
    backbone: str
    classifier: str = "proto"
    adapt_features: bool = False
    frame_size: int = 224
    dtype: str = "float32"


# grouped by fake extractor, which fake_extractor keeps for the next record
RECORDS = (
    Record("features_efficientnet_b0", "features", "efficientnet_b0"),
    Record("features_efficientnet_b0_84px", "features", "efficientnet_b0", frame_size=84),
    Record("simplecnaps_efficientnet_b0", "logits", "efficientnet_b0", "mahalanobis", True),
    Record("finetuner_efficientnet_b0", "finetuner", "efficientnet_b0", "linear"),
    Record("flagship_efficientnet_b0", "flagship", "efficientnet_b0"),
    Record("features_efficientnet_v2_s", "features", "efficientnet_v2_s"),
    Record("features_vit_s_32", "features", "vit_s_32"),
    Record("features_vit_b_32", "features", "vit_b_32"),
    Record("proto_vit_b_32", "logits", "vit_b_32"),
    Record("proto_vit_b_32_bf16", "logits", "vit_b_32", dtype="bfloat16"),
    Record("features_vit_b_32_84px", "features", "vit_b_32", frame_size=84),
    Record("features_vit_b_32_clip", "features", "vit_b_32_clip"),
    Record("cnaps_vit_b_32_clip", "logits", "vit_b_32_clip", "versa", True),
)
RECORD = {r.name: r for r in RECORDS}


def finetune_args() -> SimpleNamespace:
    return SimpleNamespace(**FINETUNE_ARGS)


# ---------------------------------------------------------------- weights ----
def _tokens(backbone: str, frame_size: int) -> int:
    """Position-embedding rows of a ViT at ``frame_size`` (0 for an
    EfficientNet, whose weights do not depend on it)."""
    return (frame_size // 32) ** 2 + 1 if backbone.startswith("vit") else 0


def fake_extractor(backbone: str, frame_size: int = 224) -> Dict[str, np.ndarray]:
    """The backbone's fake upstream state dict (timm layout; open_clip for
    ViT-B/32-CLIP, as the reference pins it), drawn from SEED; a ViT's
    position embedding sized for ``frame_size``. A new dict each call; its
    arrays, kept for the next call with the same arguments (a ViT-B/32
    takes seconds to draw), are shared and must not be written."""
    return dict(_drawn_extractor(backbone, _tokens(backbone, frame_size)))


@functools.lru_cache(maxsize=1)
def _drawn_extractor(backbone: str, tokens: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([SEED, FEATURE_EXTRACTORS.index(backbone), tokens])
    if backbone.startswith("efficientnet"):
        sd = fakes.fake_timm_efficientnet(rng, ARCHS[backbone], STEM_CHS[backbone])
    elif backbone == "vit_b_32_clip":
        sd = fakes.fake_openclip_vit(rng, *VIT_CONFIGS[backbone][:2], tokens)
    else:
        sd = fakes.fake_timm_vit(rng, *VIT_CONFIGS[backbone][:2], tokens)
    for value in sd.values():
        value.setflags(write=False)
    return sd


def reference_state_dict(record: Record, stats: Optional[Dict[str, np.ndarray]] = None):
    """The record's fake reference recogniser checkpoint: its extractor
    (with ``stats``, timm names -> arrays, in place of the fake's BatchNorm
    statistics) under ``feature_extractor.``, and with FiLM the set encoder,
    FiLM generator and Versa processors."""
    extractor = fake_extractor(record.backbone, record.frame_size)
    extractor.update(stats or {})
    if not record.adapt_features:
        return {f"feature_extractor.{k}": v for k, v in extractor.items()}
    _, feat_dim, film_spec = create_feature_extractor(record.backbone, record.frame_size)
    rng = np.random.default_rng([SEED, FEATURE_EXTRACTORS.index(record.backbone),
                                 _tokens(record.backbone, record.frame_size), 1])
    return fakes.fake_reference_cnaps(rng, film_spec, extractor, feat_dim)


def extractor_state_dict(record: Record, arrays) -> Dict[str, np.ndarray]:
    """The record's fake upstream extractor with the file's statistics (the
    flagship's ``entry(state_dict=...)``)."""
    sd = fake_extractor(record.backbone, record.frame_size)
    sd.update(stats_of(arrays, record))
    return sd


def stats_key(record: Record) -> str:
    return f"stats/{record.name}/"


def stats_of(arrays, record: Record) -> Dict[str, np.ndarray]:
    """The record's calibrated statistics from the file, timm names ->
    arrays (empty for a ViT)."""
    prefix = stats_key(record)
    return {k[len(prefix):]: arrays[k] for k in arrays if k.startswith(prefix)}


def build(record: Record, stats: Dict[str, np.ndarray], device="cpu",
          impl: Optional[str] = None):
    """The record's port recogniser, its weights from
    :func:`reference_state_dict` through the port's converter, cast as
    ``--compute_dtype`` casts it, on ``device`` with the ops' route
    ``impl``."""
    dtype = torch.bfloat16 if record.dtype == "bfloat16" else torch.float32
    cls = (MultiStepFewShotRecogniser if record.kind == "finetuner"
           else SingleStepFewShotRecogniser)
    rec = cls(record.backbone, adapt_features=record.adapt_features,
              classifier=record.classifier, batch_size=BATCH_SIZE, dtype=dtype,
              frame_size=record.frame_size)
    tree = convert.convert_recogniser_checkpoint(reference_state_dict(record, stats), rec)
    rec.load_state_dict(convert.from_jax_variables(tree, expected=set(rec.state_dict())),
                        strict=True)
    if dtype == torch.bfloat16:
        cast_extractor_params(rec.extractor)
    rec.to(device)
    rec.impl = impl
    return rec


@torch.no_grad()
def calibrate(record: Record, x: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The fake EfficientNet's BatchNorm statistics calibrated (f32, CPU) on
    every frame of the record's inputs ``x``, by their timm names."""
    rec = SingleStepFewShotRecogniser(record.backbone, batch_size=BATCH_SIZE)
    convert.load_upstream_extractor(rec, fake_extractor(record.backbone))
    frames = torch.from_numpy(np.concatenate(
        [v[:, 0] for k, v in sorted(x.items()) if k.endswith("clips")]))
    calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames))
    out = {}
    for key, value in rec.extractor.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        if leaf in ("mean", "var"):
            name = module.replace("blocks_", "blocks.").replace("_", ".")
            out[f"{name}.running_{leaf}"] = value.numpy().copy()
    return out


# ----------------------------------------------------------------- inputs ----
def _clips(rng, colours: np.ndarray, labels: np.ndarray, size: int) -> np.ndarray:
    """(N, 1, size, size, 3) uint8 one-frame clips: each label's colour
    under uniform noise of +-30 levels."""
    noise = rng.integers(-30, 31, size=(len(labels), size, size, 3))
    return np.clip(colours[labels][:, None, None, :] + noise, 0, 255).astype(np.uint8)[:, None]


def task(rng, size: int, way: int = WAY, context: int = CONTEXT,
         query: int = QUERY) -> Dict[str, np.ndarray]:
    """A ``way``-way task of one-frame uint8 clips: ``context`` clips
    (labels 0, 1, ... in turn), ``query`` clips of the same colours, all
    rows real, NUM_CLASSES class slots."""
    colours = rng.integers(40, 216, size=(way, 3))
    ctx_labels, query_labels = np.arange(context) % way, np.arange(query) % way
    return {"context_clips": _clips(rng, colours, ctx_labels, size),
            "context_labels": ctx_labels.astype(np.int64),
            "context_mask": np.ones(context, np.float32),
            "class_mask": (np.arange(NUM_CLASSES) < way).astype(np.float32),
            "query_clips": _clips(rng, colours, query_labels, size),
            "query_labels": query_labels.astype(np.int64)}


def draw_inputs(record: Record) -> Dict[str, np.ndarray]:
    """The record's inputs as drawn here, unchecked (:func:`inputs`)."""
    if record.kind == "flagship":
        import graft_entry_torch

        return graft_entry_torch.flagship_episode()
    rng = np.random.default_rng([SEED, zlib.crc32(record.name.encode())])
    if record.kind == "features":
        return {"clips": task(rng, record.frame_size, way=FEATURE_FRAMES,
                              context=FEATURE_FRAMES, query=0)["context_clips"]}
    return task(rng, record.frame_size)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def inputs(record: Record, manifest: dict) -> Dict[str, np.ndarray]:
    """The record's inputs, each checked against the manifest's SHA-256."""
    out = draw_inputs(record)
    want = manifest["records"][record.name]["inputs"]
    if set(out) != set(want):
        raise ValueError(f"{record.name}: inputs {sorted(out)}, the manifest has {sorted(want)}")
    for key, value in out.items():
        if digest(value) != want[key]["sha256"]:
            raise ValueError(f"{record.name}: input {key} differs from the one the golden "
                             f"file was made from (numpy {np.__version__} draws another "
                             f"stream?)")
    return out


# ------------------------------------------------------------------ files ----
def load(directory: Path = GOLDEN_DIR):
    """(manifest, arrays) of the golden file in ``directory``."""
    manifest = json.loads((directory / "manifest.json").read_text())
    with np.load(directory / "golden.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return manifest, arrays


def error(record: Record, ours: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
          class_mask: Optional[np.ndarray]):
    """(worst |ours - ref| over the largest |ref|, frames whose argmax
    agrees, frames) of a replay against the file's outputs: logits over the
    real classes of ``class_mask``; no argmax for features (0, 0)."""
    if set(ours) != set(ref):
        raise ValueError(f"{record.name}: outputs {sorted(ours)}, the file has {sorted(ref)}")
    if record.kind == "features":
        got, want = ours["features"], ref["features"]
        return float(np.abs(got - want).max() / np.abs(want).max()), 0, 0
    real = class_mask > 0
    got, want = ours["logits"][:, real], ref["logits"][:, real]
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    return float(np.abs(got - want).max() / np.abs(want).max()), agree, got.shape[0]


def outputs_of(arrays, record: Record) -> Dict[str, np.ndarray]:
    prefix = f"{record.name}/"
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


# ----------------------------------------------------------------- replay ----
def replay(record: Record, manifest: dict, arrays, device="cpu",
           impl: Optional[str] = None, rec=None) -> Dict[str, np.ndarray]:
    """The record's outputs from the port (f32 numpy, by the file's output
    names), the recogniser built by :func:`build` on ``device`` with the
    route ``impl`` (or ``rec``, built so)."""
    x = {k: torch.from_numpy(v).to(device) for k, v in inputs(record, manifest).items()}
    if record.kind == "flagship":
        import graft_entry_torch

        fn, args = graft_entry_torch.entry(device=device,
                                           state_dict=extractor_state_dict(record, arrays))
        args[0].impl = impl
        return {"logits": fn(*args).float().cpu().numpy()}
    rec = rec if rec is not None else build(record, stats_of(arrays, record), device, impl)
    if record.kind == "features":
        with torch.inference_mode():
            return {"features": rec.embed_clips(x["clips"]).float().cpu().numpy()}
    ctx = (x["context_clips"], x["context_labels"], x["context_mask"], x["class_mask"])
    if record.kind == "finetuner":
        from orbit_tpu_torch.learners.multi_step import build_finetune_fns

        personalise, predict = build_finetune_fns(rec, finetune_args())
        logits = predict(personalise(*ctx), x["query_clips"], x["class_mask"])
    else:
        with torch.inference_mode():
            state = rec.personalise(*ctx[:3], NUM_CLASSES)
            logits = rec.predict(state, x["query_clips"], class_mask=x["class_mask"])
    return {"logits": logits.float().cpu().numpy()}
