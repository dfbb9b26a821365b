"""The port against the golden file of the JAX package's outputs at
published widths (``data/golden_torch/``, written by
``scripts/make_golden_torch.py``), on the CPU through the plain versions.
No JAX program is compiled here: the JAX package ran once, when the file
was made.

One case a record of ``orbit_tpu_torch/models/golden.py::RECORDS``: the
extractor features of every backbone at 224 px (and ViT-B/32 and B0 at
84 px), the personalise-then-predict logits of ViT-B/32 ProtoNets, B0
SimpleCNAPs and ViT-B/32-CLIP CNAPs, the frozen B0 FineTuner's logits after
5 Adam steps, the flagship forward (``graft_entry_torch.entry``), and the
ViT-B/32 ProtoNets logits under ``--compute_dtype bfloat16``. Each record
loads the same fake reference checkpoint that the JAX package loaded, from
the same seed, through the port's own converter.

Tolerances (the two sides differ in summation order only in f32):
- features: rtol = atol = 2e-4, as tests/test_torch_parity.py:63;
- logits: 2e-4 of their largest magnitude over the real classes, and the
  argmax equal on every frame; the FineTuner's logits after 5 steps, whose
  feature differences pass through Adam's normalised updates: 1e-3 of the
  largest magnitude;
- bf16: 2^-4 of the largest value (PERF.md §2); the argmax is not held,
  as random weights put the classes within bf16's rounding.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orbit_tpu_torch.models import golden

F32_LOGITS_TOL = {"logits": 2e-4, "finetuner": 1e-3, "flagship": 2e-4}
BF16_TOL = 2.0 ** -4
MAX_BYTES = 4 * 2 ** 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops (as in
    tests/test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden_file():
    return golden.load()


def hold(record, ours: dict, ref: dict, class_mask: np.ndarray) -> None:
    """``ours`` against the file's outputs at the record's tolerance
    (module docstring)."""
    if record.kind == "features":
        np.testing.assert_allclose(ours["features"], ref["features"], rtol=2e-4, atol=2e-4,
                                   err_msg=record.name)
        return
    worst, agree, frames = golden.error(record, ours, ref, class_mask)
    tol = BF16_TOL if record.dtype == "bfloat16" else F32_LOGITS_TOL[record.kind]
    assert worst <= tol, f"{record.name}: {worst:.3e} of the largest logit (limit {tol})"
    if record.dtype == "float32":
        assert agree == frames, f"{record.name}: argmax on {agree}/{frames} frames"


def test_golden_file_is_whole(golden_file):
    """Every record in the manifest and the file, each output of the shape
    the manifest gives, the EfficientNets' calibrated statistics, under
    4 MB."""
    manifest, arrays = golden_file
    assert (golden.GOLDEN_DIR / "golden.npz").stat().st_size < MAX_BYTES
    assert list(manifest["records"]) == [r.name for r in golden.RECORDS]
    for record in golden.RECORDS:
        entry = manifest["records"][record.name]
        outputs = golden.outputs_of(arrays, record)
        assert {k: list(v.shape) for k, v in outputs.items()} == {
            k: v["shape"] for k, v in entry["outputs"].items()}
        assert all(np.isfinite(v).all() for v in outputs.values())
        if record.backbone.startswith("efficientnet"):
            stats = golden.stats_of(arrays, record)
            assert stats and all(k.endswith((".running_mean", ".running_var")) for k in stats)


@pytest.mark.parametrize("name", [r.name for r in golden.RECORDS])
def test_port_replays_golden_record(golden_file, name):
    manifest, arrays = golden_file
    record = golden.RECORD[name]
    ours = golden.replay(record, manifest, arrays, "cpu")
    class_mask = golden.draw_inputs(record).get("class_mask")
    hold(record, ours, golden.outputs_of(arrays, record), class_mask)
