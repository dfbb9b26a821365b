"""The port's meta-training held against the JAX package on the CPU.

- One LITE step (``build_train_task_lite``, ``learn_extractor``, proto
  head): its loss, logits and every gradient against the JAX step on the
  same variables and episode. The JAX subsets cannot be drawn in torch: the
  test recomputes them from the JAX key (``split(key, nb)``, then
  ``argsort(uniform - 10·mask)[:L]``, as orbit_tpu/learners/steps.py:181-186
  and :305-310 do) and injects them. Then one Adam update over
  ``tasks_per_batch = 2`` tasks, against ``build_apply_update``.
- One non-LITE step (``build_train_task``), whose 8 context clips run as two
  checkpointed chunks of 4.
- An all-padding episode gives zero loss and no gradient.
The setting is that of tests/test_meta_learning.py:151-188 (64 px, 8
context clips, ``num_lite_samples`` 4, batch 4), with the extractor swapped
on both sides for a depth-2 ViT of width 128 (two 64-wide heads) to keep the
JAX compile short. The target set has 7 clips: one full batch and a tail of
3 (the JAX step pads its tail to 8 rows, the port runs 3).
- The CLI in ``--mode train_test`` on the fixture tree with
  ``device="cpu"``: it writes ``checkpoint.ckpt`` and the final and best
  models, and resumes from the checkpoint; without a card and without
  ``device="cpu"`` it raises. Its train queue yields the JAX package's task
  dicts for the same seed.

Tolerances (f32 throughout): the two sides differ in summation order, in
Flax's one-pass LayerNorm variance against the port's two-pass, and in the
XLA erf against torch's. Through two layers and the proto head that leaves
the logits within 1e-5 of their largest value; the loss, a log-sum-exp of
logits less a logit, within twice that of the largest logit; the gradients, compared per tensor against its largest value, chain about
ten more reductions: 1e-4. A tensor whose exact gradient is zero (the final
LayerNorm's bias: the proto logits do not change when every feature shifts
alike) holds rounding noise only, so a tensor's scale is at least 1e-3 of
the step's largest gradient. The Adam update divides by |g| + eps with eps =
1e-3, so an error e in a gradient moves the first update by at most
lr·e/eps: with e up to 1e-4 of the tensor's largest gradient g_max, the
update is held to lr·1e-4·g_max/eps.
"""
from __future__ import annotations

import os
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.learners import steps as jax_steps
from orbit_tpu.models.backbones.vit import ViT as FlaxViT
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
from orbit_tpu.utils.optim import init_optimizer as jax_init_optimizer
from orbit_tpu_torch.learners import steps
from orbit_tpu_torch.learners.single_step import SingleStepLearner
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones.vit import ViT
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from orbit_tpu_torch.utils.optim import init_optimizer
from tests.test_learners import make_args
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

ARGS = SimpleNamespace(tasks_per_batch=2, learn_extractor=True, with_lite=True,
                       num_lite_samples=4, batch_size=4, optimizer="adam",
                       learning_rate=1e-3, weight_decay=0.1, betas=(0.9, 0.98),
                       epsilon=1e-3, extractor_lr_scale=0.5)
STEP_RTOL, GRAD_TOL = 1e-5, 1e-4


def _episode(seed: int, n_ctx: int = 8, n_tgt: int = 7, size: int = 64):
    """uint8 clips of 3 objects that differ by a few levels under noise, so
    the random-weight recogniser's loss and gradients do not saturate."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(80, 170, size=3) + rng.integers(-3, 4, size=(3, 3))

    def clips(labels):
        noise = rng.integers(-20, 21, size=(len(labels), 1, size, size, 3))
        return np.clip(colours[labels][:, None, None, None] + noise, 0, 255).astype(np.uint8)

    ctx_labels, tgt_labels = np.arange(n_ctx) % 3, np.arange(n_tgt) % 3
    return {"context_clips": clips(ctx_labels), "context_labels": ctx_labels.astype(np.int32),
            "context_mask": np.ones(n_ctx, np.float32),
            "class_mask": (np.arange(16) < 3).astype(np.float32),
            "target_clips": clips(tgt_labels), "target_labels": tgt_labels.astype(np.int32),
            "target_mask": np.ones(n_tgt, np.float32)}


def _torch_episode(ep):
    return {k: torch.from_numpy(v).long() if k.endswith("labels") else torch.from_numpy(v)
            for k, v in ep.items()}


@pytest.fixture(scope="module")
def models():
    """The JAX recogniser (depth-2, width-128 ViT) with perturbed variables,
    and a factory of port recognisers loaded with the same values."""
    rec = JaxRecogniser(feature_extractor_name="vit_s_32", classifier="proto",
                        batch_size=4, learn_extractor=True, num_lite_samples=4)
    object.__setattr__(rec, "extractor", FlaxViT(patch_size=32, dim=128, depth=2,
                                                 num_heads=2))
    object.__setattr__(rec, "output_size", 128)
    variables = rec.init(jax.random.PRNGKey(0), frame_size=64)
    # non-trivial biases, LayerNorm affines and class token
    noise = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * noise.standard_normal(a.shape).astype(np.float32),
        variables)

    def port():
        r = SingleStepFewShotRecogniser("vit_s_32", batch_size=4, frame_size=64)
        r.extractor = ViT(dim=128, depth=2, num_heads=2, frame_size=64)
        r.load_state_dict(convert.from_jax_variables(variables), strict=True)
        return r
    return rec, variables, port


def _subsets(key, context_mask, nb: int):
    """The JAX step's LITE subsets for its ``nb`` target batches."""
    return [torch.from_numpy(np.array(jnp.argsort(
        jax.random.uniform(k, (context_mask.shape[0],))
        - jnp.asarray(context_mask) * 10.0)[:ARGS.num_lite_samples]))
        for k in jax.random.split(key, nb)]


def _close_grads(port_rec, jax_grads):
    ref = convert.from_jax_variables({"params": jax_grads})
    named = dict(port_rec.named_parameters())
    assert set(ref) == set(named)
    largest = max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = named[name].grad
        assert g is not None, name
        scale = max(float(r.abs().max()), 1e-3 * largest)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def _close_step(loss, logits, j_loss, j_logits):
    j_logits = np.asarray(j_logits)
    real = j_logits > -1e29
    assert logits.shape == j_logits.shape
    np.testing.assert_array_equal(logits.numpy() > -1e29, real)
    scale = np.abs(j_logits[real]).max()
    np.testing.assert_allclose(logits.numpy()[real], j_logits[real], rtol=STEP_RTOL,
                               atol=STEP_RTOL * scale)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                               atol=2 * STEP_RTOL * scale)


def test_lite_step_and_adam_update_match_jax(models):
    rec, variables, port = models
    lite = jax.jit(jax_steps.build_train_task_lite(rec, ARGS, jit=False))
    eps = [_episode(10), _episode(11)]
    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    jax_out = [lite(variables, {k: jnp.asarray(v) for k, v in ep.items()}, key)
               for ep, key in zip(eps, keys)]

    r = port()
    optimizer = init_optimizer(r, ARGS, extractor_lr_scale=ARGS.extractor_lr_scale)
    step = steps.build_train_task_lite(r, ARGS)
    for i, (ep, key, (j_grads, j_loss, j_logits, _)) in enumerate(zip(eps, keys, jax_out)):
        r.zero_grad(set_to_none=True)
        loss, logits = step(_torch_episode(ep), grad_idxs=_subsets(key, ep["context_mask"], 2))
        _close_step(loss, logits, j_loss, j_logits)
        _close_grads(r, j_grads)
        if i == 0:
            first = {n: p.grad.clone() for n, p in r.named_parameters()}
    for n, p in r.named_parameters():  # the two tasks' gradients, accumulated
        p.grad += first[n]

    before = {n: p.detach().clone() for n, p in r.named_parameters()}
    steps.build_apply_update(optimizer)()
    tx, opt_state = jax_init_optimizer(variables["params"], ARGS,
                                       extractor_lr_scale=ARGS.extractor_lr_scale)
    acc = jax.tree_util.tree_map(jnp.add, jax_out[0][0], jax_out[1][0])
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    new_params, _ = jax_steps.build_apply_update(tx)(params, opt_state, acc)
    ref = convert.from_jax_variables({"params": new_params})
    g_max = convert.from_jax_variables({"params": acc})
    for n, p in r.named_parameters():
        moved = (p.detach() - before[n]).numpy()
        tol = ARGS.learning_rate * GRAD_TOL * float(g_max[n].abs().max()) / ARGS.epsilon
        np.testing.assert_allclose(moved, ref[n].numpy() - before[n].numpy(), rtol=0,
                                   atol=tol, err_msg=n)
        assert p.grad is None


def test_non_lite_step_matches_jax(models):
    rec, variables, port = models
    ep = _episode(12)
    fn = jax.jit(jax_steps.build_train_task(rec, ARGS, jit=False))
    j_grads, j_loss, j_logits, _ = fn(variables, {k: jnp.asarray(v) for k, v in ep.items()},
                                      jax.random.PRNGKey(0))
    r = port()
    loss, logits = steps.build_train_task(r, ARGS)(_torch_episode(ep))
    _close_step(loss, logits, j_loss, j_logits)
    _close_grads(r, j_grads)


def test_all_padding_episode_gives_zero_loss_and_no_gradient(models):
    r = models[2]()
    ep = _torch_episode(_episode(13))
    ep["target_mask"] = torch.zeros_like(ep["target_mask"])
    for build in (steps.build_train_task, steps.build_train_task_lite):
        loss, logits = build(r, ARGS)(ep, torch.Generator().manual_seed(0))
        assert float(loss) == 0.0 and logits.shape[0] == 0
        assert all(p.grad is None for p in r.parameters())


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_train")
    for mode in ("train", "validation", "test"):
        os.symlink(os.path.realpath(orbit_fixture_tree), root / mode)
    return str(root)


CLI_FLAGS = dict(frame_size=84, epochs=1, num_train_tasks=1, num_val_tasks=1,
                 num_test_tasks=1, tasks_per_batch=2, batch_size=8, num_lite_samples=4,
                 subsample_factor=2, context_shot=2, target_shot=1,
                 test_target_clip_method="random", feature_extractor="vit_s_32",
                 classifier="proto")


def _argv(root, ckpt, **extra):
    argv = ["--data_path", root, "--checkpoint_dir", str(ckpt)]
    for flag, value in {**CLI_FLAGS, **extra}.items():
        argv += [f"--{flag}"] if value is True else [f"--{flag}", str(value)]
    return argv


def test_cli_train_test_checkpoints_and_resume(orbit_root, tmp_path, monkeypatch):
    import single_step_learner_torch
    from orbit_tpu_torch.models.backbones import vit

    # the CLI's path at a cut depth and width: "vit_s_32" builds a depth-2,
    # width-128 ViT here, so the whole run takes seconds on one thread
    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32", (128, 2, 2, False, 1e-6))
    argv = _argv(orbit_root, tmp_path / "run", mode="train_test", with_lite=True,
                 learn_extractor=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_step_learner_torch.main(argv)
    single_step_learner_torch.main(argv, device="cpu")
    (run,) = (tmp_path / "run").iterdir()
    for name in ("checkpoint.ckpt", "final.ckpt", "best.ckpt", "results.json", "log.txt"):
        assert (run / name).exists(), name
    log = (run / "log.txt").read_text()
    assert "epoch [1/1] train loss" in log and "validation per-video stats" in log

    # resume at the end of epoch 1 of 1: nothing is left to train, so the
    # final model is the checkpoint's, which is the first run's final model
    single_step_learner_torch.main(
        _argv(orbit_root, tmp_path / "resumed", mode="train", with_lite=True,
              learn_extractor=True, resume_from=run / "checkpoint.ckpt"), device="cpu")
    (resumed,) = (tmp_path / "resumed").iterdir()
    assert "resumed from" in (resumed / "log.txt").read_text()
    final, again = convert.load(str(run / "final.ckpt")), convert.load(str(resumed / "final.ckpt"))
    assert final.keys() == again.keys()
    assert all(torch.equal(final[k], again[k]) for k in final)


def test_train_queue_matches_jax(orbit_root, tmp_path):
    from orbit_tpu.data.dataloaders import DataLoader as JaxDataLoader

    args = make_args(orbit_root, str(tmp_path), mode="train", learn_extractor=True,
                     **{k: v for k, v in CLI_FLAGS.items() if k != "classifier"})
    learner = SingleStepLearner(args, device="cpu")
    ours = list(learner.train_queue.get_tasks())
    random.seed(args.seed)
    np.random.seed(args.seed)
    ref = list(JaxDataLoader(dict(learner.dataset_info(), num_shards=1,
                                  shard_index=0)).get_train_queue().get_tasks())
    learner.logfile.close()
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert repr(a[k]) == repr(b[k]), k
