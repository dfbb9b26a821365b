"""The yardstick's arithmetic against hand counts."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT


def arch(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())["architecture"]


def test_vit_b32_frame_flops_by_hand():
    from port_bench import roofline

    s, d = 50, 768
    layer = 2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d + 4 * s * d * 3072
    assert roofline.vit_frame_flops(arch("vit_b32_proto_f32")) == 49 * 2 * 3072 * d + 12 * layer
    assert round(roofline.vit_frame_flops(arch("vit_b32_proto_f32")) / 1e9, 2) == 8.82


def test_b0_tails_and_flops():
    from port_bench import roofline

    a = arch("b0_simplecnaps_f32")
    assert roofline.effnet_dw_tails(a) == {
        (112, 32, 3): 1, (56, 144, 3): 1, (28, 240, 5): 1, (14, 480, 3): 2, (14, 480, 5): 1,
        (14, 672, 5): 2, (7, 1152, 5): 3, (7, 1152, 3): 1}
    assert 0.76e9 < roofline.effnet_frame_flops(a) < 0.78e9      # 0.39 GMACs, as published
    assert roofline.set_encoder_frame_flops(224) == pytest.approx(
        2 * 9 * 64 * (224 ** 2 * 3 + 64 * (112 ** 2 + 56 ** 2 + 28 ** 2 + 14 ** 2)))


def test_bounds_match_the_kernel_table():
    from port_bench import roofline

    assert roofline.bound_vit("fused_qkv_attention", 256, 50, 768, "float32") * 1e3 == \
        pytest.approx(0.7054, abs=1e-4)
    assert roofline.bound_vit("fused_mlp_block", 256, 50, 768, "float32") * 1e3 == \
        pytest.approx(1.8029, abs=1e-4)


@pytest.mark.parametrize("name", ["fused_qkv_attention_bwd", "fused_mlp_block_bwd"])
def test_backward_charged_for_dw_only_when_computed(name):
    from port_bench import roofline

    full = roofline.bound_vit(name, 256, 50, 768, "float32", weight_grads=True)
    dx = roofline.bound_vit(name, 256, 50, 768, "float32", weight_grads=False)
    assert dx < full and dx / full == pytest.approx(
        {"fused_qkv_attention_bwd": 2 / 3, "fused_mlp_block_bwd": 3 / 5}[name], rel=0.02)


def test_port_kernel_pattern():
    import re

    from port_bench.roofline import PORT_KERNELS

    p = re.compile(PORT_KERNELS)
    assert p.search("void (anonymous namespace)::fused_mlp_block_sgemm_kernel<128, 256, 2>(...)")
    assert p.search("(anonymous namespace)::layer_norm_kernel<float>(float const*)")
    assert not p.search("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>")
    assert not p.search("ampere_sgemm_128x64_nn")


def config(name, **changes):
    c = json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())
    c["architecture"].update(changes)
    return c


def test_eval_task_by_hand():
    from port_bench import roofline

    w = roofline.Work(config("vit_b32_proto_f32"))
    w.eval_task(1000, 2000, 5, 256)      # context padded to 1,024: 4 calls; query 8
    assert w.calls == {"fused_qkv_attention": 12 * 12, "fused_mlp_block": 12 * 12}
    a = config("vit_b32_proto_f32")["architecture"]
    assert w.flops == pytest.approx(3000 * roofline.vit_frame_flops(a)
                                    + roofline.proto_head_flops(1000, 2000, 768, 5))
    b0 = roofline.Work(config("b0_simplecnaps_f32"))
    b0.eval_task(1000, 2000, 5, 256)
    assert b0.calls == {"fused_dw_act": 12 * 12, "mahalanobis_logits": 1}


@pytest.mark.parametrize("name,changes,launches", [
    ("vit_b32_proto_f32", {"classifier": "mahalanobis"},
     {"fused_qkv_attention": 24, "fused_mlp_block": 24, "mahalanobis_logits": 1}),
    ("b0_simplecnaps_f32", {"classifier": "proto", "adapt_features": False},
     {"fused_dw_act": 24})])
def test_eval_calls_follow_head_and_backbone(name, changes, launches):
    from port_bench import roofline

    w, base = roofline.Work(config(name, **changes)), roofline.Work(config(name))
    w.eval_task(16, 200, 3, 256)       # one context call (16 rows), one query call
    base.eval_task(16, 200, 3, 256)
    assert w.calls == launches
    head = roofline.bound_mahalanobis(200, roofline.feature_dim(w.a), 16, 3)
    assert w.bound_s - base.bound_s == pytest.approx(
        head if changes.get("classifier") == "mahalanobis" else -head)


@pytest.mark.parametrize("learn_extractor,ratio", [(True, 1.0), (False, None)])
def test_lite_task_charges_dw_only_when_the_extractor_learns(learn_extractor, ratio):
    from port_bench import roofline

    full, w = roofline.Work(config("vit_b32_proto_f32")), roofline.Work(config("vit_b32_proto_f32"))
    full.lite_task(300, 500, 256, 16, True)
    w.lite_task(300, 500, 256, 16, learn_extractor)
    assert w.calls == full.calls and w.calls["fused_mlp_block_bwd"] == 12 * 2 * 2
    assert (w.bound_s == full.bound_s) is learn_extractor


@pytest.mark.parametrize("name,changes", [("b0_simplecnaps_f32", {}),
                                          ("vit_b32_proto_f32", {"adapt_features": True}),
                                          ("vit_b32_proto_f32", {"classifier": "mahalanobis"})])
def test_training_calls_not_derived_say_so(name, changes):
    from port_bench import roofline

    out = roofline.traced_work(config(name, **changes),
                               lambda w: w.lite_task(300, 500, 256, 16, True))
    assert set(out) == {"unpredicted"}


def _traced_run(launches, expected):
    from types import SimpleNamespace

    return SimpleNamespace(trace={"port_kernel_s": 1.0, "bound_s": 0.5, "launches": launches,
                                  "expected_launches": expected, "window_s": 2.0,
                                  "busy_s": 1.5, "model_flops": 1e12, "peak_flops": 67e12})


@pytest.mark.parametrize("launches,value", [
    ({"fused_dw_act": 12, "mahalanobis_logits": 0}, 50.0),
    ({"fused_dw_act": 12, "mahalanobis_logits": 1}, None),    # a launch no shape predicts
    ({"fused_dw_act": 11}, None)])                            # a predicted launch missing
def test_roofline_needs_every_launch_predicted(launches, value):
    from port_bench import measure

    assert measure.roofline_pct(_traced_run(launches, {"fused_dw_act": 12})) == value


def test_unpredicted_work_leaves_roofline_and_mfu_out():
    from types import SimpleNamespace

    from port_bench import measure

    run = SimpleNamespace(trace={"unpredicted": "why", "port_kernel_s": 1.0,
                                 "window_s": 2.0, "busy_s": 1.5})
    assert measure.roofline_pct(run) is None and measure.mfu_pct(run) is None
    assert measure.idle_pct(run) == pytest.approx(25.0)
