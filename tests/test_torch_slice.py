"""The port's CLU-VE test slice held against the JAX package, end to end.

- personalise + predict of the port's recogniser against the JAX
  ``build_eval_fns`` on the same uint8 padded episode (ViT-S/32 at 84 px,
  the JAX variables carried over by ``from_jax_variables``), for the
  ``proto`` and ``proto_cosine`` heads;
- the port's CLI (``single_step_learner_torch``) against the JAX learner
  on the synthetic ORBIT tree of ``conftest.orbit_fixture_tree``, with the
  flags of ``tests/test_learners.py`` and the JAX learner's parameters:
  the per-frame predictions in ``results.json`` and the logits behind them;
- the import boundary: the port, its CLIs and ``chip_smoke.py`` load no JAX,
  Flax or PIL and nothing of the JAX package, and ``chip_smoke.py`` refuses
  to run without a GPU.

f32 tolerance: the two sides differ in summation order only; through 12
layers and the final LayerNorm the features agree to about 1e-5 of their
size, and the heads (means, dot products, f32) keep that: 1e-4 relative,
1e-4 of the largest logit absolute.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.data.episodes import pad_episode
from orbit_tpu.learners.steps import build_eval_fns as jax_build_eval_fns
from orbit_tpu.models.recognisers import \
    SingleStepFewShotRecogniser as JaxRecogniser
from orbit_tpu_torch.learners.steps import build_eval_fns
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from tests.test_learners import make_args
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_vit_s():
    """One JAX ViT-S/32 recogniser at 84 px: its variables (numpy) and its
    eval functions per head."""
    rec = {c: JaxRecogniser(feature_extractor_name="vit_s_32", classifier=c,
                            batch_size=16, frame_norm_method="imagenet_inception")
           for c in ("proto", "proto_cosine")}
    variables = rec["proto"].init(jax.random.PRNGKey(7), frame_size=84)
    return (jax.tree_util.tree_map(np.asarray, variables),
            {c: jax_build_eval_fns(r) for c, r in rec.items()})


def _episode(seed=0):
    """A uint8 test-mode task: 3 objects, 11 context clips, 2 videos."""
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 220, size=(3, 1, 1, 3))
    labels = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2])

    def frames(lab):
        noise = rng.integers(-40, 41, size=(len(lab), 84, 84, 3))
        return np.clip(base[lab] + noise, 0, 255).astype(np.uint8)

    vids = [np.array([1] * 21), np.array([2] * 9)]
    return pad_episode({
        "context_clips": frames(labels)[:, None], "context_labels": labels,
        "target_clips": [frames(v) for v in vids],
        "target_labels": [np.int64(v[0]) for v in vids],
        "target_paths": [np.array([f"u/o/clutter/V{i}/V{i}-{f:05d}.jpg"
                                   for f in range(len(v))]) for i, v in enumerate(vids)]})


@pytest.mark.parametrize("classifier", ["proto", "proto_cosine"])
def test_personalise_predict_match_jax(jax_vit_s, classifier):
    variables, jax_fns = jax_vit_s
    ep = _episode()
    ctx = (ep.context_clips, ep.context_labels, ep.context_mask, ep.class_mask)
    j_personalise, j_predict = jax_fns[classifier]
    j_state = j_personalise(variables, *map(jnp.asarray, ctx))
    j_logits = [np.asarray(j_predict(variables, j_state, jnp.asarray(v[:, None]),
                                     jnp.asarray(ep.class_mask)))
                for v in ep.video_frames]

    rec = SingleStepFewShotRecogniser(
        "vit_s_32", classifier=classifier, batch_size=16,
        frame_norm_method="imagenet_inception", frame_size=84)
    rec.load_state_dict(convert.from_jax_variables(variables), strict=True)
    personalise, predict = build_eval_fns(rec)
    t_ctx = [torch.from_numpy(a) for a in ctx]
    t_ctx[1] = t_ctx[1].long()
    state = personalise(*t_ctx)
    for key in state["head"]:
        ref = np.asarray(j_state["head"][key])
        np.testing.assert_allclose(state["head"][key].numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(), err_msg=key)
    for frames, ref in zip(ep.video_frames, j_logits):
        logits = predict(state, torch.from_numpy(frames[:, None]),
                         torch.from_numpy(ep.class_mask)).numpy()
        assert logits.dtype == np.float32 and logits.shape == ref.shape
        real = ep.class_mask > 0
        np.testing.assert_allclose(logits[:, real], ref[:, real], rtol=RTOL,
                                   atol=RTOL * np.abs(ref[:, real]).max())
        assert (logits[:, ~real] == -1e30).all()
        np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))


def _record_logits(sink: list, predict):
    def recorded(*args):
        out = predict(*args)
        sink.append(np.asarray(out))
        return out
    return recorded


def test_port_learner_matches_jax_learner(orbit_root, tmp_path, monkeypatch):
    from orbit_tpu.learners import SingleStepLearner as JaxLearner
    from orbit_tpu.utils.eval_metrics import TestEvaluator
    from orbit_tpu_torch.learners import single_step as port_learner
    import single_step_learner_torch

    # JAX learner: the CLU-VE loop on its own initial variables (no MACs pass)
    args = make_args(orbit_root, str(tmp_path / "jax"), mode="test",
                     feature_extractor="vit_s_32")
    jl = JaxLearner(args)
    j_eval = TestEvaluator(jl.evaluation_metrics, str(tmp_path / "jax_results"))
    j_logits: list = []
    jl.predict_fn = _record_logits(j_logits, jl.predict_fn)
    jl._run_eval_protocol(jl.test_queue, j_eval, args.num_test_tasks, "test",
                          with_timing=False)
    j_eval.save()
    jl.logfile.close()
    model = str(tmp_path / "vit_s_32.pt")
    convert.save(model, convert.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jl.variables)))

    # port learner, run from its CLI on the same flags plus --model_path
    t_logits: list = []
    real_build = port_learner.build_eval_fns

    def build(rec):
        personalise, predict = real_build(rec)
        return personalise, _record_logits(t_logits, predict)
    monkeypatch.setattr(port_learner, "build_eval_fns", build)
    argv = ["--data_path", orbit_root, "--checkpoint_dir", str(tmp_path / "torch"),
            "--model_path", model]
    for flag, value in vars(args).items():
        if flag in ("frame_size", "num_test_tasks", "batch_size", "subsample_factor",
                    "context_shot", "target_shot", "test_target_clip_method",
                    "classifier", "feature_extractor", "mode"):
            argv += [f"--{flag}", str(value)]
    single_step_learner_torch.main(argv, device="cpu")

    t_results = sorted((tmp_path / "torch").glob("*/results.json"))
    assert len(t_results) == 1
    ours = json.loads(t_results[0].read_text())
    ref = json.loads((tmp_path / "jax_results" / "results.json").read_text())
    assert set(ours) == set(ref) == {"P001", "P002"}
    same = total = 0
    for user, tasks in ref.items():
        assert len(ours[user]) == len(tasks)
        for t_task, j_task in zip(ours[user], tasks):
            assert t_task["task_object_list"] == j_task["task_object_list"]
            assert t_task["task_macs_to_personalise"] > 0  # the port's MACs counter
            assert t_task["task_videos"].keys() == j_task["task_videos"].keys()
            for video, frames in j_task["task_videos"].items():
                assert t_task["task_videos"][video].keys() == frames.keys()
                for f, pred in frames.items():
                    same += t_task["task_videos"][video][f] == pred
                    total += 1
    assert total > 0 and same / total >= 0.99, (same, total)
    assert len(t_logits) == len(j_logits)
    for a, b in zip(t_logits, j_logits):
        real = b > -1e29
        np.testing.assert_allclose(a[real], b[real], rtol=RTOL,
                                   atol=RTOL * np.abs(b[real]).max())


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_torch")
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "test")
    return str(root)


def _run(code: list, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # as the one-thread fixture, under a loaded suite
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_flax_or_pil():
    code = ("import importlib, pkgutil, sys\n"
            "import orbit_tpu_torch\n"
            "for m in pkgutil.walk_packages(orbit_tpu_torch.__path__, 'orbit_tpu_torch.'):\n"
            "    if m.module_finder.find_spec(m.name).origin.endswith('.py'):  # not a built .so\n"
            "        importlib.import_module(m.name)\n"
            "import single_step_learner_torch, multi_step_learner_torch, chip_smoke\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'PIL', 'optax')\n"
            "       or m == 'orbit_tpu' or m.startswith('orbit_tpu.')]\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    proc = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
