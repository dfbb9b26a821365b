"""A run with the timed path broken underneath comes out not correct, and a
sound one correct, under each cell's own limits. The runs skip the look for
a card and drive everything else of a run on the CPU (the port's plain
versions), full widths at 84 px over small mixes. Faults, planted in the
port: a head over half of the context rows (half of the batch left out, the
mean taken over the rest); one logit altered where the head produces it; for
meta-training also an update that leaves the parameters unchanged and a
loss over half of each batch's rows. One chip: no exchange to leave out."""
from __future__ import annotations

import pytest
import torch

EVAL = [("vit_b32_proto_f32_84px", "vit_b32_proto_f32.clu_ve", "proto"),
        ("b0_simplecnaps_f32_84px", "b0_simplecnaps_f32.clu_ve", "mahalanobis")]


def half_rows(configure):
    def faulty(features, labels, sample_mask, num_classes, processors=None):
        rows = torch.arange(sample_mask.shape[-1], device=sample_mask.device)
        mask = sample_mask * (rows % 2 == 0)   # every other row: half the real ones
        return configure(features, labels, mask, num_classes, processors)
    return faulty


def altered_answer(predict):
    def faulty(head, features, **kw):
        out = predict(head, features, **kw)
        delta = torch.zeros_like(out)
        delta[0, 0] = 0.05 * out.detach()[:, 0].abs().max()
        return out + delta
    return faulty


def run_loop(run):
    from port_bench import core

    core.loop(run.cell.mix["loop"]).run(run)
    return core.verdict(run.numbers, run.cell.checks)[0]


@pytest.mark.parametrize("fault", [None, "half", "answer"])
@pytest.mark.parametrize("config,workload,head", EVAL)
def test_eval_fault_is_not_correct(tiny, monkeypatch, config, workload, head, fault):
    from orbit_tpu_torch.models import heads

    if fault == "half":
        monkeypatch.setitem(heads.CONFIGURE, head, half_rows(heads.CONFIGURE[head]))
    if fault == "answer":
        monkeypatch.setitem(heads.PREDICT, head, altered_answer(heads.PREDICT[head]))
    assert run_loop(tiny(config, "clu_ve_tiny", workload)) is (fault is None)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "answer"])
def test_train_fault_is_not_correct(tiny, monkeypatch, fault):
    from orbit_tpu_torch.learners import steps
    from orbit_tpu_torch.models import heads

    if fault == "unchanged":
        def no_update(optimizer):
            def apply():
                optimizer.zero_grad(set_to_none=True)
            return apply
        monkeypatch.setattr(steps, "build_apply_update", no_update)
    if fault == "half":
        ce = steps.cross_entropy

        def half_loss(logits, labels, mask=None, **kw):
            keep = max(1, logits.shape[0] // 2)
            return ce(logits[:keep], labels[:keep], None if mask is None else mask[:keep], **kw)
        monkeypatch.setattr(steps, "cross_entropy", half_loss)
    if fault == "answer":
        monkeypatch.setitem(heads.PREDICT, "proto", altered_answer(heads.PREDICT["proto"]))
    torch.manual_seed(0)
    run = tiny("vit_b32_proto_f32_84px", "lite_train_tiny", "vit_b32_proto_f32.lite_train")
    assert run_loop(run) is (fault is None)
