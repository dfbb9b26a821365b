"""The port's tools held against the JAX package: the upstream key maps,
``--pretrained_extractor_path``, the converter script, ``--profile_dir``
and the bf16 pixel wire.

- Every upstream layout (timm EfficientNet-B0, timm ViT, augreg
  big_vision ``.npz``, open_clip ``.bin``) through
  ``scripts/convert_checkpoint_torch.py``: the same Flax-layout tree as the
  JAX converter (tolerance 0), the same ``.ckpt`` bytes as the JAX
  ``save_converted``, and ``load_pretrained_extractor`` giving the
  extractor ``from_jax_variables`` of the JAX tree bit for bit. The fakes
  are ``tests/test_convert.py``'s.
- The refusals: a source tensor the maps do not know, and a converted file
  with a leaf too many, one too few or of the wrong shape.
- The CLIs: both learners (the JAX ``SingleStepLearner`` and
  ``single_step_learner_torch``) in ``--mode test
  --pretrained_extractor_path`` on the same ``.ckpt`` (a timm-layout
  ViT-S/32 at 84 px) on ``conftest``'s ORBIT tree: f32 logits within
  ``tests/test_torch_slice.py``'s tolerance (1e-4 relative, 1e-4 of the
  largest logit absolute), and the port's run with ``--profile_dir``
  writes a Chrome trace on the CPU; the multi-step learner loads the same
  file into its extractor; ``examples/getting_started_torch.py`` runs with
  it; the tools import no JAX, Flax or msgpack.
- The bf16 wire: under ``--host_normalize --compute_dtype bfloat16`` the
  JAX learner ships bf16-rounded pixels, and its f32 set encoder sees them;
  the port's learner ships the same, so the task representations agree to
  f32 summation order: held to 1e-5 of the largest component (1.4e-7
  measured). Shipping f32, as the port did before, reads 9.2e-5 of the
  largest component (2.1e-3 of an element).
"""
from __future__ import annotations

import json
import os
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orbit_tpu.models import convert as jax_convert
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones.vit import ViT
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from tests.test_convert import _vit_tensors, fake_timm_efficientnet_b0
from tests.test_learners import make_args
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import convert_checkpoint_torch  # noqa: E402

RTOL = 1e-4


def _assert_equal_trees(ours, ref, where=""):
    assert isinstance(ours, dict) == isinstance(ref, dict), where
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (where, sorted(set(ours) ^ set(ref))[:5])
        for k in ref:
            _assert_equal_trees(ours[k], ref[k], f"{where}/{k}")
    else:
        assert np.asarray(ours).dtype == np.asarray(ref).dtype, where
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref), err_msg=where)


def _openclip_with_text(oc):
    out = dict(oc)
    out["text.token_embedding.weight"] = np.zeros((4, 4), np.float32)  # dropped
    return out


# (fake state dict, extractor, file name, frame size); the ViT layouts hold
# one draw of a small ViT (D 16, depth 2, 8 px patches), as
# tests/test_convert.py's layout tests do
LAYOUTS = {
    "timm_efficientnet_b0": (fake_timm_efficientnet_b0, "efficientnet_b0", "b0.pth", 64),
    "timm_vit": (lambda: _vit_tensors()[0], "vit_b_32", "vit.pth", 16),
    "augreg_npz": (lambda: _vit_tensors()[1], "vit_b_32", "augreg.npz", 16),
    "open_clip_bin": (lambda: _openclip_with_text(_vit_tensors()[2]),
                      "vit_b_32_clip", "open_clip_pytorch_model.bin", 16),
}


def _save_upstream(sd, path):
    if path.endswith(".npz"):
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_converters_match_jax(layout, tmp_path):
    make, extractor, name, frame_size = LAYOUTS[layout]
    sd = make()
    upstream = str(tmp_path / name)
    _save_upstream(sd, upstream)
    ours_ckpt, ref_ckpt = str(tmp_path / "ours.ckpt"), str(tmp_path / "ref.ckpt")
    convert_checkpoint_torch.main(["--feature_extractor", extractor, "--torch_path",
                                   upstream, "--out", ours_ckpt])

    ref_params, ref_stats = jax_convert.convert_extractor(
        jax_convert.load_torch_state_dict(upstream), extractor)
    params, stats = convert.convert_extractor(convert.load_torch_state_dict(upstream),
                                              extractor)
    _assert_equal_trees(params, ref_params)
    _assert_equal_trees(stats, ref_stats)
    jax_convert.save_converted(ref_ckpt, ref_params, ref_stats)
    with open(ours_ckpt, "rb") as a, open(ref_ckpt, "rb") as b:
        assert a.read() == b.read()

    if extractor == "efficientnet_b0":
        module = SingleStepFewShotRecogniser(extractor, frame_size=frame_size).extractor
    else:  # 2 x 2 patches of 8 px
        module = ViT(patch_size=8, dim=16, depth=2, num_heads=2,
                     pre_norm=layout == "open_clip_bin", frame_size=frame_size)
    rec = types.SimpleNamespace(extractor=module, feature_extractor_name=extractor)
    convert.load_pretrained_extractor(rec, ours_ckpt)
    expected = convert.from_jax_variables({"params": {"extractor": ref_params},
                                           "batch_stats": {"extractor": ref_stats}})
    state = module.state_dict()
    assert set(expected) == {f"extractor.{k}" for k in state}
    for k, v in expected.items():
        assert torch.equal(state[k[len("extractor."):]], v), k


def test_converters_refuse_silent_drops(tmp_path):
    sd = fake_timm_efficientnet_b0()
    sd["blocks.0.0.bn1.running_median"] = sd["blocks.0.0.bn1.running_mean"]
    with pytest.raises(ValueError, match="bn leaf"):
        convert.convert_extractor(sd, "efficientnet_b0")
    _, npz, oc = _vit_tensors()
    npz["Transformer/mystery"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="npz"):
        convert.convert_vit_npz(npz)
    oc["visual.mystery"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="open_clip"):
        convert.convert_vit_openclip(oc)
    timm, _, _ = _vit_tensors()
    timm["blocks.0.attn.rel_pos"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError):
        convert.convert_extractor(timm, "vit_b_32")

    # a converted file with a leaf too many, one too few, or the wrong shape
    params, stats = convert.convert_extractor(fake_timm_efficientnet_b0(), "efficientnet_b0")
    rec = SingleStepFewShotRecogniser("efficientnet_b0", frame_size=64)
    path = str(tmp_path / "b0.ckpt")
    for mutate, match in (
            (lambda p, s: p["blocks_0_0"].update(extra={"kernel": np.zeros(1)}), "does not map"),
            (lambda p, s: s["bn1"].pop("var"), "lack parameters"),
            (lambda p, s: p["bn1"].update(scale=np.ones(31, np.float32)), "shape mismatch")):
        p = jax.tree_util.tree_map(np.copy, params)
        s = jax.tree_util.tree_map(np.copy, stats)
        mutate(p, s)
        convert.save_converted(path, p, s)
        with pytest.raises(ValueError, match=match):
            convert.load_pretrained_extractor(rec, path)
    # a ViT-S/32 file into a ViT-B/32
    vit_s = SingleStepFewShotRecogniser("vit_s_32", frame_size=64)
    from orbit_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(path, {"params": convert.to_jax_variables(
        vit_s.state_dict())["params"]["extractor"], "batch_stats": {}})
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.load_pretrained_extractor(SingleStepFewShotRecogniser("vit_b_32", frame_size=64),
                                          path)


def fake_timm_vit_s_32_84px(seed: int = 11):
    """A timm ``vit_small_patch32_224`` state dict at its published width and
    depth (D 384, 12 blocks, 6 heads) with an 84 px frame's position
    embedding (2 x 2 patches + the class token), from a seed."""
    rng = np.random.default_rng(seed)
    d, depth = 384, 12

    def w(*shape, scale=0.02):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    sd = {"cls_token": w(1, 1, d), "pos_embed": w(1, 5, d),
          "patch_embed.proj.weight": w(d, 3, 32, 32), "patch_embed.proj.bias": w(d),
          "norm.weight": 1 + w(d, scale=0.1), "norm.bias": w(d),
          "head.weight": w(1000, d), "head.bias": w(1000)}
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + w(d, scale=0.1), f"{p}.norm1.bias": w(d),
                   f"{p}.norm2.weight": 1 + w(d, scale=0.1), f"{p}.norm2.bias": w(d),
                   f"{p}.attn.qkv.weight": w(3 * d, d), f"{p}.attn.qkv.bias": w(3 * d),
                   f"{p}.attn.proj.weight": w(d, d), f"{p}.attn.proj.bias": w(d),
                   f"{p}.mlp.fc1.weight": w(4 * d, d), f"{p}.mlp.fc1.bias": w(4 * d),
                   f"{p}.mlp.fc2.weight": w(d, 4 * d), f"{p}.mlp.fc2.bias": w(d)})
    return sd


@pytest.fixture(scope="module")
def vit_s_ckpt(tmp_path_factory):
    """The fake timm ViT-S/32 converted by the port's script."""
    root = tmp_path_factory.mktemp("pretrained")
    upstream, out = str(root / "vit_s_32.pth"), str(root / "vit_s_32.ckpt")
    _save_upstream(fake_timm_vit_s_32_84px(), upstream)
    convert_checkpoint_torch.main(["--feature_extractor", "vit_s_32", "--torch_path",
                                   upstream, "--out", out])
    return out


def _record_logits(sink: list, predict):
    def recorded(*args):
        out = predict(*args)
        sink.append(np.asarray(out))
        return out
    return recorded


def test_learner_clis_load_the_same_pretrained_extractor(orbit_root, vit_s_ckpt, tmp_path,
                                                        monkeypatch):
    from orbit_tpu.learners import SingleStepLearner as JaxLearner
    from orbit_tpu.utils.eval_metrics import TestEvaluator
    from orbit_tpu_torch.learners import single_step as port_learner
    import single_step_learner_torch

    args = make_args(orbit_root, str(tmp_path / "jax"), mode="test",
                     feature_extractor="vit_s_32", pretrained_extractor_path=vit_s_ckpt)
    jl = JaxLearner(args)
    j_eval = TestEvaluator(jl.evaluation_metrics, str(tmp_path / "jax_results"))
    j_logits: list = []
    jl.predict_fn = _record_logits(j_logits, jl.predict_fn)
    jl._run_eval_protocol(jl.test_queue, j_eval, args.num_test_tasks, "test",
                          with_timing=False)
    jl.logfile.close()

    t_logits: list = []
    real_build = port_learner.build_eval_fns

    def build(rec):
        personalise, predict = real_build(rec)
        return personalise, _record_logits(t_logits, predict)
    monkeypatch.setattr(port_learner, "build_eval_fns", build)
    argv = ["--data_path", orbit_root, "--checkpoint_dir", str(tmp_path / "torch"),
            "--pretrained_extractor_path", vit_s_ckpt]
    for flag, value in vars(args).items():
        if flag in ("frame_size", "num_test_tasks", "batch_size", "subsample_factor",
                    "context_shot", "target_shot", "test_target_clip_method",
                    "classifier", "feature_extractor", "mode"):
            argv += [f"--{flag}", str(value)]
    profile = tmp_path / "profile"
    single_step_learner_torch.main(argv + ["--profile_dir", str(profile)], device="cpu")
    log = next((tmp_path / "torch").glob("*/log.txt")).read_text()
    assert f"loaded pretrained extractor: {vit_s_ckpt}" in log
    # --profile_dir: a Chrome trace of the run's ops
    trace = json.loads((profile / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])

    assert len(t_logits) == len(j_logits) > 0
    for a, b in zip(t_logits, j_logits):
        real = b > -1e29
        np.testing.assert_allclose(a[real], b[real], rtol=RTOL,
                                   atol=RTOL * np.abs(b[real]).max())


def test_multi_step_learner_loads_the_pretrained_extractor(orbit_root, vit_s_ckpt, tmp_path):
    """The FineTuner's learner takes the flag from its CLI's parser and loads
    the file into every weight draw, before ``after_init``."""
    from orbit_tpu_torch.learners.multi_step import MultiStepLearner
    from orbit_tpu_torch.utils.args import parse_args

    seen = []
    args = parse_args("multi-step-learner", [
        "--data_path", orbit_root, "--checkpoint_dir", str(tmp_path), "--mode", "test",
        "--feature_extractor", "vit_s_32", "--classifier", "linear", "--frame_size", "84",
        "--pretrained_extractor_path", vit_s_ckpt])
    learner = MultiStepLearner(args, device="cpu", after_init=lambda rec: seen.append(
        {k: v.clone() for k, v in rec.extractor.state_dict().items()}))
    learner.logfile.close()
    expected = convert.from_jax_variables({"params": {"extractor": jax_convert.convert_vit(
        fake_timm_vit_s_32_84px())[0]}})
    assert len(seen) == 1
    for k, v in expected.items():
        assert torch.equal(seen[0][k[len("extractor."):]], v), k


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_pretrained")
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "test")
    return str(root)


def test_bf16_wire_gives_the_set_encoder_the_jax_pixels():
    """The same host-normalised task through each learner's pixel wire
    (``_clips_to_device``) and each package's task representation."""
    import jax.numpy as jnp
    import ml_dtypes
    from orbit_tpu.learners.single_step import SingleStepLearner as JaxLearner
    from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
    from orbit_tpu_torch.learners.single_step import SingleStepLearner

    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, size=(6, 2, 64, 64, 3)).astype(np.float32) / 255.0
    context = ((frames - 0.45) / 0.27).astype(np.float32)   # host-normalised
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)

    j_rec = JaxRecogniser(feature_extractor_name="vit_s_32", adapt_features=True,
                          batch_size=8, dtype=jnp.bfloat16)
    se_params = jax.jit(j_rec.set_encoder.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))["params"]
    j_wire = JaxLearner._clips_to_device(
        types.SimpleNamespace(clip_dtype=ml_dtypes.bfloat16), context)
    ref = np.asarray(j_rec.task_embedding({"params": {"set_encoder": se_params}}, j_wire,
                                          jnp.asarray(mask)))

    rec = SingleStepFewShotRecogniser("vit_s_32", adapt_features=True, batch_size=8,
                                      dtype=torch.bfloat16, frame_size=64)
    rec.set_encoder.load_state_dict({
        f"{m}.{leaf}": torch.from_numpy(np.array(v))
        for m, leaves in se_params.items() for leaf, v in leaves.items()}, strict=True)
    stub = types.SimpleNamespace(dtype=torch.bfloat16, device=torch.device("cpu"))
    stub._host_to_device = types.MethodType(SingleStepLearner._host_to_device, stub)
    wire = SingleStepLearner._clips_to_device(stub, context)
    assert wire.dtype == torch.bfloat16 and wire.element_size() == 2
    ours = rec.task_embedding(wire, torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_getting_started_example_runs(orbit_fixture_tree, vit_s_ckpt, tmp_path):
    """``examples/getting_started_torch.py`` drives the port's learner on the
    notebook's settings (validation split) with the converted extractor."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
    import getting_started_torch

    root = tmp_path / "root"
    root.mkdir()
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "validation")
    learner = getting_started_torch.main([
        "--data_path", str(root), "--num_tasks", "1", "--feature_extractor", "vit_s_32",
        "--frame_size", "84", "--checkpoint_dir", str(tmp_path / "runs"),
        "--pretrained_extractor_path", vit_s_ckpt], device="cpu")
    results = json.loads((Path(learner.checkpoint_dir) / "results.json").read_text())
    assert set(results) == {"P001", "P002"}


def test_tools_import_no_jax_flax_or_msgpack():
    """The converter script, the example and the port's checkpoint modules
    load no JAX, Flax, msgpack or anything of the JAX package."""
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "sys.path[:0] = ['scripts', 'examples']\n"
            "import convert_checkpoint_torch, getting_started_torch\n"
            "import orbit_tpu_torch.utils.msgpack_tree, orbit_tpu_torch.utils.profiling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'msgpack', 'optax', 'orbit_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # as the one-thread fixture, under a loaded suite
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_timed_reports_to_its_sink():
    from orbit_tpu_torch.utils.profiling import timed

    seen = []
    with timed("block", sink=lambda label, s: seen.append((label, s))):
        pass
    assert len(seen) == 1 and seen[0][0] == "block" and seen[0][1] >= 0.0
