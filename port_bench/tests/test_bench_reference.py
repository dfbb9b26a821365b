"""The plain reference against the port's plain versions on the CPU: the
same state dict keys and shapes at the published widths, and the same task
state and logits for one small task."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import DATA, ROOT

CONFIGS = [("vit_b32_proto_f32", "vit_b_32"), ("b0_simplecnaps_f32", "efficientnet_b0")]


def config(name, data=ROOT / "port_bench" / "configs"):
    return json.loads((data / f"{name}.json").read_text())


@pytest.mark.parametrize("name,extractor", CONFIGS)
def test_same_leaves_as_the_port(name, extractor):
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from port_bench.reference.models import Recogniser

    a = config(name)["architecture"]
    ref = Recogniser(a).state_dict()
    port = SingleStepFewShotRecogniser(feature_extractor_name=extractor,
                                       adapt_features=a["adapt_features"],
                                       classifier=a["classifier"]).state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: tuple(v.shape)
                                                           for k, v in port.items()}


@pytest.mark.parametrize("name,extractor", CONFIGS)
def test_task_matches_the_port(name, extractor):
    from orbit_tpu_torch.learners.steps import build_eval_fns
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
    from port_bench import setup
    from port_bench.reference import protocol
    from port_bench.traffic.feed import FrameBank

    c = config(f"{name}_84px", DATA)
    a = c["architecture"]
    bank = FrameBank({"frames_per_object": 8, "colour": [40, 216], "stripes": 30, "noise": 20},
                     2, 3, "cpu", 84)
    ref = setup.reference(c, 11, "cpu", bank)
    port = SingleStepFewShotRecogniser(feature_extractor_name=extractor,
                                       adapt_features=a["adapt_features"],
                                       classifier=a["classifier"], frame_size=84)
    port.load_state_dict(ref.state_dict())
    port.pixel_mean.copy_(torch.tensor(a["pixel_mean"]))
    port.pixel_std.copy_(torch.tensor(a["pixel_std"]))
    frames = torch.from_numpy(bank.frames.reshape(-1, 84, 84, 3))
    ctx, labels, query = frames[[0, 1, 2, 8, 9]], torch.tensor([0, 0, 0, 1, 1]), frames[[3, 10]]
    personalise, predict = build_eval_fns(port)
    class_mask = torch.tensor([1.0, 1.0] + [0.0] * 14)
    state = personalise(ctx[:, None], labels, torch.ones(5), class_mask)
    ours = predict(state, query[:, None], class_mask)[:, :2].numpy()
    theirs = protocol.predict(ref, protocol.personalise(ref, ctx, labels, 16), query.numpy(), 2,
                              "cpu")[:, :2]
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()
