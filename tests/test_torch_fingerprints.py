"""The port's forward against the golden-activation fingerprints of the
pinned checkpoints: the counterpart of tests/test_fingerprints.py, which
replays the JAX package's converted forward against the same records.

``scripts/make_activation_fingerprints.py`` (run once where the pinned
timm/CLIP checkpoints exist) commits JSON fingerprints under
``data/fingerprints/``: each holds a backbone, an input seed, the state
dict's SHA-256 and the first values of the pooled features of two seeded
224 px frames from the converted Flax model (``flax_features``), and where
timm was importable from timm itself (``timm_features``). This test loads
the matching local state dict (``ORBIT_TPU_WEIGHTS_DIR``, by default
``pretrained/``) through the port's converter and replays the port's f32
forward on the CPU (the plain versions) against them: 1e-4 against Flax,
2e-3 against timm, as tests/test_fingerprints.py holds Flax. It reads the
records and writes nothing.

Environment-dependent by design: with no fingerprints committed or no
local weights the cases skip visibly, never pass vacuously.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINGERPRINT_DIR = os.path.join(REPO, "data", "fingerprints")
WEIGHTS_DIR = os.environ.get("ORBIT_TPU_WEIGHTS_DIR", os.path.join(REPO, "pretrained"))

fingerprints = sorted(glob.glob(os.path.join(FINGERPRINT_DIR, "*.json")))


def seeded_input(seed: int = 0, n: int = 2) -> np.ndarray:
    """The fingerprinted frames (scripts/make_activation_fingerprints.py::
    seeded_input): ``n`` standard-normal 224 px frames from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 224, 224, 3)).astype(np.float32)


@pytest.mark.skipif(not fingerprints,
                    reason="no committed fingerprints (data/fingerprints/) — "
                           "generate with scripts/make_activation_fingerprints.py "
                           "where the pinned checkpoints exist")
@pytest.mark.parametrize("path", fingerprints,
                         ids=[os.path.basename(p) for p in fingerprints])
def test_port_forward_reproduces_fingerprint(path):
    from orbit_tpu_torch.models import convert
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

    with open(path) as f:
        record = json.load(f)
    sd_path = os.path.join(WEIGHTS_DIR, record["state_dict_basename"])
    if not os.path.exists(sd_path):
        pytest.skip(f"pinned checkpoint {record['state_dict_basename']} not "
                    f"present under {WEIGHTS_DIR}")
    with open(sd_path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == record["state_dict_sha256"], \
            "local state dict differs from the fingerprinted pinned checkpoint"

    rec = SingleStepFewShotRecogniser(record["backbone"])
    convert.load_upstream_extractor(rec, convert.load_torch_state_dict(sd_path))
    x = seeded_input(record["input_seed"])
    assert list(x.shape) == record["input_shape"]
    with torch.no_grad():
        out = rec.extractor(torch.from_numpy(x)).numpy()

    expected = np.asarray(record["flax_features"], np.float32)
    np.testing.assert_allclose(out[:, :expected.shape[1]], expected, rtol=1e-4, atol=1e-4)
    if "timm_features" in record:
        timm_expected = np.asarray(record["timm_features"], np.float32)
        np.testing.assert_allclose(out[:, :timm_expected.shape[1]], timm_expected,
                                   rtol=2e-3, atol=2e-3)
