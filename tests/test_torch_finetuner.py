"""The port's FineTuner (multi-step learner) and FiLM on the ViTs held
against the JAX package.

- The frozen inner loop against JAX ``build_finetune_fns`` on the same
  cached features, with padded rows and classes (the pattern of
  ``tests/test_finetuner_parity.py``): Adam with coupled weight decay, and
  SGD with momentum and weight decay. f32 on both sides, only the summation
  order differs over 12 steps: heads within rtol 2e-3 and atol 2e-4, and
  padded class rows stay exactly 0.
- FineTuner+FiLM on a depth-2, width-64 ViT at 64 px, pre-norm on and off
  (as ``tests/test_torch_vit.py`` builds it), 3 steps, Adam and SGD with
  momentum and weight decay, ``extractor_lr_scale`` 0.5, over two context
  batches (8 + 4 padded clips). The JAX package runs its XLA route
  (``force_impl("xla")``); the port takes the kernels' plain versions.
  FiLM and head leaves, and the FiLM leaves' moves from their start,
  within atol 5e-4 and rtol 5e-3, logits within 5e-3:
  the margins of ``test_finetuner_parity.py``'s FiLM test (a few f32 ulps a
  step, amplified by Adam's division by the root of small second moments).
- The single-step recogniser with ``adapt_features`` on that ViT (ProtoNets,
  CNAPs and SimpleCNAPs), the JAX variables carried across by
  ``convert.from_jax_variables``: logits within 1e-4 of their largest value
  (f32, summation order through two layers, the generators and the heads).
- ``multi_step_learner_torch.main(argv, device="cpu")`` against the JAX
  ``MultiStepLearner`` on the synthetic ORBIT tree: at least 99% of the
  frames predict the same object, and both results carry
  ``task_macs_to_personalise``.
- The plain backward routes of kernels #4 and #6 skip the weight gradients
  that no input needs; the gradients they still compute are unchanged.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.learners.multi_step import build_finetune_fns as jax_finetune_fns
from orbit_tpu.learners.steps import build_eval_fns as jax_build_eval_fns
from orbit_tpu.models.backbones.vit import ViT as FlaxViT
from orbit_tpu.models.backbones.vit import vit_film_spec as jax_vit_film_spec
from orbit_tpu.models.film import FilmParameterGenerator as JaxFilmGenerator
from orbit_tpu.models.heads import VersaProcessors as JaxVersa
from orbit_tpu.models.recognisers import MultiStepFewShotRecogniser as JaxMultiStep
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxSingleStep
from orbit_tpu.ops.tiny_attention import force_impl
from orbit_tpu_torch.learners.multi_step import build_finetune_fns
from orbit_tpu_torch.learners.steps import build_eval_fns
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones import vit
from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                SingleStepFewShotRecogniser)
from orbit_tpu_torch.ops.mlp_block import fused_mlp_block
from orbit_tpu_torch.ops.tiny_attention import fused_qkv_attention
from tests.test_learners import make_args
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

FRAME, DIM, DEPTH = 64, 64, 2
WAY, SLOTS = 3, 16


def _ft_args(optimizer: str, steps: int, lr: float, batch_size: int,
             lr_scale: float = 1.0) -> SimpleNamespace:
    sgd = optimizer == "sgd"
    return SimpleNamespace(
        personalize_num_grad_steps=steps, personalize_learning_rate=lr,
        personalize_optimizer=optimizer, personalize_weight_decay=0.1,
        personalize_extractor_lr_scale=lr_scale, personalize_epsilon=1e-8,
        personalize_betas=(0.9, 0.999), personalize_momentum=0.9 if sgd else 0.0,
        batch_size=batch_size)


@pytest.fixture
def small_vit(monkeypatch):
    """The port's ``vit_s_32`` cut to depth 2 and width 64 (one head), with
    pre-norm as asked; returns the setter."""
    def cut(pre_norm: bool):
        monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32",
                            (DIM, DEPTH, 1, pre_norm, 1e-5 if pre_norm else 1e-6))
    return cut


def _jax_cut(rec, pre_norm: bool):
    """The JAX recogniser with the same cut ViT, its FiLM spec and
    generator, and (for CNAPs) Versa processors of its width."""
    spec = tuple(jax_vit_film_spec(DEPTH, DIM))
    object.__setattr__(rec, "extractor", FlaxViT(
        patch_size=32, dim=DIM, depth=DEPTH, num_heads=1, pre_norm=pre_norm,
        ln_eps=1e-5 if pre_norm else 1e-6))
    object.__setattr__(rec, "output_size", DIM)
    if rec.adapt_features:
        object.__setattr__(rec, "film_spec", spec)
        object.__setattr__(rec, "film_generator", JaxFilmGenerator(film_spec=spec))
    if rec.classifier == "versa":
        object.__setattr__(rec, "versa", JaxVersa(feat_dim=DIM))
    return rec


def _variables(rec, seed: int = 0):
    """Initialised JAX variables with every leaf perturbed (Flax inits
    biases, LayerNorm affines and the class token to 0 and 1)."""
    variables = rec.init(jax.random.PRNGKey(seed), frame_size=FRAME)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables)


def _context(n_real: int, n_pad: int, seed: int = 3):
    """uint8 clips of WAY objects that differ by a few levels under noise
    (so the loss does not saturate), padded rows, and the masks."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n_pad) % WAY
    colours = rng.integers(80, 170, size=3) + rng.integers(-6, 7, size=(WAY, 3))
    noise = rng.integers(-20, 21, size=(n_pad, 1, FRAME, FRAME, 3))
    clips = np.clip(colours[labels][:, None, None, None] + noise, 0, 255).astype(np.uint8)
    mask = (np.arange(n_pad) < n_real).astype(np.float32)
    clips[n_real:] = 0
    labels[n_real:] = 0
    return clips, labels.astype(np.int32), mask, (np.arange(SLOTS) < WAY).astype(np.float32)


def _torch_ctx(ctx):
    clips, labels, mask, class_mask = (torch.from_numpy(a) for a in ctx)
    return clips, labels.long(), mask, class_mask


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_frozen_inner_loop_matches_jax(optimizer, small_vit):
    small_vit(False)
    n, n_pad, d = 37, 48, 96
    rng = np.random.default_rng(0)
    feats = np.zeros((n_pad, d), np.float32)
    feats[:n] = rng.standard_normal((n, d)).astype(np.float32)
    labels = np.r_[np.arange(n) % 4, np.zeros(n_pad - n)].astype(np.int32)
    mask = (np.arange(n_pad) < n).astype(np.float32)
    class_mask = (np.arange(SLOTS) < 4).astype(np.float32)
    args = _ft_args(optimizer, steps=12, lr=0.05, batch_size=8)

    rec = JaxMultiStep(feature_extractor_name="vit_s_32", classifier="linear", batch_size=8)
    object.__setattr__(rec, "output_size", d)
    object.__setattr__(rec, "embed_clips", lambda *a, **k: jnp.asarray(feats))
    clips = np.zeros((n_pad, 1, FRAME, FRAME, 3), np.float32)
    personalise, _ = jax_finetune_fns(rec, args)
    ref = personalise({}, *map(jnp.asarray, (clips, labels, mask, class_mask)))

    port = MultiStepFewShotRecogniser("vit_s_32", classifier="linear", batch_size=8,
                                      frame_size=FRAME)
    port.output_size = d
    port.embed_clips = lambda *a, **k: torch.from_numpy(feats)
    ours = build_finetune_fns(port, args)[0](*_torch_ctx((clips, labels, mask, class_mask)))
    for key in ("weight", "bias"):
        got, want = ours["head"][key].detach().numpy(), np.asarray(ref["head"][key])
        np.testing.assert_allclose(got[:4], want[:4], rtol=2e-3, atol=2e-4, err_msg=key)
        assert np.abs(got[4:]).max() == 0, key  # padded classes never move


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("pre_norm", [False, True])
def test_film_finetuner_on_vit_matches_jax(pre_norm, optimizer, small_vit):
    small_vit(pre_norm)
    rec = _jax_cut(JaxMultiStep(feature_extractor_name="vit_s_32", adapt_features=True,
                                classifier="linear", batch_size=8), pre_norm)
    variables = _variables(rec)
    ctx = _context(n_real=10, n_pad=12)
    args = _ft_args(optimizer, steps=3, lr=0.01 if optimizer == "adam" else 0.1,
                    batch_size=8, lr_scale=0.5)
    with force_impl("xla"):
        j_personalise, j_predict = jax_finetune_fns(rec, args)
        j_tp = j_personalise(variables, *map(jnp.asarray, ctx))
        j_logits = np.asarray(j_predict(variables, j_tp, jnp.asarray(ctx[0]),
                                        jnp.asarray(ctx[3])))

    port = MultiStepFewShotRecogniser("vit_s_32", adapt_features=True, classifier="linear",
                                      batch_size=8, frame_size=FRAME)
    port.load_state_dict(convert.from_jax_variables(variables), strict=True)
    personalise, predict = build_finetune_fns(port, args)
    t_ctx = _torch_ctx(ctx)
    tp = personalise(*t_ctx)
    logits = predict(tp, t_ctx[0], t_ctx[3]).numpy()

    film = {".".join(path): np.asarray(v) for path, v in j_tp["film"].items()}
    assert sorted(tp["film"]) == sorted(n.replace("blocks_", "blocks.") for n in film)
    moved = 0.0
    for name, want in film.items():
        got = tp["film"][name.replace("blocks_", "blocks.")].detach().numpy()
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3, err_msg=name)
        # the leaves' moves too: a scale leaf near 1 would hide them in rtol
        start = port.extractor.get_parameter(name.replace("blocks_", "blocks.")).detach()
        np.testing.assert_allclose(got - start.numpy(), want - start.numpy(), atol=5e-4,
                                   rtol=5e-3, err_msg=name)
        moved = max(moved, float(np.abs(got - start.numpy()).max()))
    assert moved > 1e-2  # the FiLM leaves trained
    for key in ("weight", "bias"):
        got, want = tp["head"][key].detach().numpy(), np.asarray(j_tp["head"][key])
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3, err_msg=key)
        assert np.abs(got[WAY:]).max() == 0, key
    real = ctx[3] > 0
    np.testing.assert_allclose(logits[:, real], j_logits[:, real], atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("classifier", ["proto", "versa", "mahalanobis"])
def test_single_step_film_on_vit_matches_jax(classifier, small_vit):
    small_vit(False)
    rec = _jax_cut(JaxSingleStep(feature_extractor_name="vit_s_32", adapt_features=True,
                                 classifier=classifier, batch_size=8), False)
    variables = _variables(rec, seed=1)
    ctx = _context(n_real=10, n_pad=12, seed=4)
    query = _context(n_real=9, n_pad=9, seed=5)[0]
    j_personalise, j_predict = jax_build_eval_fns(rec)
    with force_impl("xla"):
        j_state = j_personalise(variables, *map(jnp.asarray, ctx))
        ref = np.asarray(j_predict(variables, j_state, jnp.asarray(query), jnp.asarray(ctx[3])))

    port = SingleStepFewShotRecogniser("vit_s_32", adapt_features=True, classifier=classifier,
                                       batch_size=8, frame_size=FRAME)
    port.load_state_dict(convert.from_jax_variables(variables), strict=True)
    personalise, predict = build_eval_fns(port)
    t_ctx = _torch_ctx(ctx)
    state = personalise(*t_ctx)
    assert len(state["film"]) == 4 * DEPTH + 2
    logits = predict(state, torch.from_numpy(query), t_ctx[3]).numpy()
    real = ctx[3] > 0
    scale = np.abs(ref[:, real]).max()
    np.testing.assert_allclose(logits[:, real], ref[:, real], rtol=1e-4, atol=1e-4 * scale)
    assert (logits[:, ~real] == -1e30).all()


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_finetuner")
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "test")
    return str(root)


def test_cli_matches_jax_multi_step_learner(orbit_root, tmp_path, monkeypatch):
    from orbit_tpu.learners import MultiStepLearner as JaxLearner
    import multi_step_learner_torch

    args = make_args(orbit_root, str(tmp_path / "jax"), mode="test",
                     learner="multi-step-learner", classifier="linear",
                     feature_extractor="vit_s_32", personalize_num_grad_steps=3,
                     personalize_learning_rate=0.1)
    # the JAX MACs pass lowers four more programs; the MACs are compared in
    # tests/test_torch_ops_counter.py, so it charges a stand-in here
    monkeypatch.setattr(JaxLearner, "_personalise_macs", lambda self, *a: 1.0)
    jl = JaxLearner(args)
    model = str(tmp_path / "vit_s_32.pt")
    convert.save(model, convert.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jl.variables)))
    jl.run()
    ref = json.loads(open(jl.test_evaluator.json_results_path).read())

    argv = ["--data_path", orbit_root, "--checkpoint_dir", str(tmp_path / "torch"),
            "--model_path", model]
    for flag, value in vars(args).items():
        if flag in ("frame_size", "num_test_tasks", "batch_size", "subsample_factor",
                    "context_shot", "target_shot", "test_target_clip_method", "classifier",
                    "feature_extractor", "mode", "personalize_num_grad_steps",
                    "personalize_learning_rate"):
            argv += [f"--{flag}", str(value)]
    multi_step_learner_torch.main(argv, device="cpu")
    t_results = sorted((tmp_path / "torch").glob("*/results.json"))
    assert len(t_results) == 1
    ours = json.loads(t_results[0].read_text())
    assert set(ours) == set(ref) == {"P001", "P002"}
    same = total = 0
    for user, tasks in ref.items():
        assert len(ours[user]) == len(tasks)
        for t_task, j_task in zip(ours[user], tasks):
            assert t_task["task_object_list"] == j_task["task_object_list"]
            assert t_task["task_macs_to_personalise"] > 0
            assert "task_macs_to_personalise" in j_task
            for video, frames in j_task["task_videos"].items():
                for f, pred in frames.items():
                    same += t_task["task_videos"][video][f] == pred
                    total += 1
    assert total > 0 and same / total >= 0.99, (same, total)


def _plain_grads(op, inputs, frozen, **kw):
    """Gradients of ``op`` on the CPU (its plain backward) for a fixed
    upstream gradient, with the ``frozen`` inputs' requires_grad off."""
    ts = [torch.from_numpy(a).requires_grad_(i not in frozen) for i, a in enumerate(inputs)]
    out = op(*ts, **kw)
    out.backward(torch.from_numpy(np.random.default_rng(9).standard_normal(
        out.shape).astype(np.float32)))
    return [t.grad for t in ts]


@pytest.mark.parametrize("which", ["attention", "mlp"])
def test_plain_backward_skips_unneeded_weight_grads(which, monkeypatch):
    from orbit_tpu_torch.ops import mlp_block, tiny_attention

    rng = np.random.default_rng(8)
    r = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    if which == "attention":
        inputs, op, frozen = [r(3, 5, 64), r(64, 192), r(192)], fused_qkv_attention, {1, 2}
        kw, module, name = {"num_heads": 1}, tiny_attention, "qkv_attention_backward_reference"
    else:
        inputs = [r(3, 5, 64), 1 + r(64), r(64), r(64, 256), r(256), r(256, 64), r(64)]
        op, frozen, kw = fused_mlp_block, {3, 4, 5, 6}, {}
        module, name = mlp_block, "mlp_block_backward_reference"
    seen = []
    reference = getattr(module, name)

    def spy(*a, **k):
        out = reference(*a, **k)
        seen.append(sum(t is None for t in out))
        return out
    monkeypatch.setattr(module, name, spy)
    full = _plain_grads(op, inputs, set(), **kw)
    skipped = _plain_grads(op, inputs, frozen, **kw)
    assert seen == [0, len(frozen)]  # the frozen weights' products were not formed
    for i, (a, b) in enumerate(zip(full, skipped)):
        if i in frozen:
            assert b is None
        else:
            assert torch.equal(a, b), i
