"""The port's FiLM meta-training (CNAPs/SimpleCNAPs, LITE and not) held
against the JAX package on the CPU.

The setting: an EfficientNet-B0 cut to its stem and first two stages (the
fused DepthwiseSeparable tail, a stride-2 and a fused stride-1
InvertedResidual tail) with a 64-wide head conv, at 32 px, on both sides;
FiLM over its tagged BatchNorms (stem, both InvertedResidual bn2 and the
head), the set encoder and the Versa processors at width 64. The extractor
is frozen (``learn_extractor`` off), its BatchNorms in eval mode with
running statistics calibrated on frames of the episode's kind
(``calibrate_batchnorm``) and given to both sides. The regularisers are
drawn at 0.05 instead of 0.001, so that the FiLM values move the features.
The JAX side keeps its default composed depthwise route: in f32 it
computes the function of the port's fused op, in another summation order.
The episode has 8 context and 7 target clips of 3 classes, 4 class slots
(one padded), batch 4 and ``num_lite_samples`` 4: the non-LITE context
runs as two checkpointed chunks and the LITE target as a full batch and a
ragged tail (the JAX step pads its tail to 4 rows, the port runs 3). The
JAX subsets are recomputed from its key and injected, as in
tests/test_torch_train.py.

- One step with LITE for each head (proto, versa, mahalanobis), and
  without LITE for versa and mahalanobis: its loss, logits and the
  gradients of the set encoder, the FiLM generator and the Versa
  processors against the JAX step's; the JAX step's extractor gradient is
  zero and the port's extractor gets none.
- One LITE step of SimpleCNAPs and CNAPs with FiLM on a cut ViT (the
  ViT-B/32-CLIP layout: pre-norm, eps 1e-5; depth 2, width 64, one head,
  the cut of tests/test_torch_finetuner.py) at 64 px, where S = 5: FiLM
  into every LayerNorm, kernel B's norm2 affine included; the loss,
  logits and every gradient of the set encoder, FiLM generator and Versa
  processors against the JAX step's, at the B0 steps' tolerances.
- The heads alone: the gradients of the context and query features (and
  of the Versa processors) through the Mahalanobis head's batched inverse
  and through the Versa head, against JAX's, on the inputs of
  tests/test_heads_grads.py.
- The frozen extractor keeps its bits through an Adam update with weight
  decay; the generator moves.
- An all-padding episode gives zero loss and no gradient.
- The CLI in ``--mode train_test`` with ``--adapt_features --with_lite``
  (CNAPs) writes its checkpoints and results and resumes.

Tolerances (f32): the two sides differ in summation order (convolutions,
the K*K taps, the heads' products and inverses) and in Flax's one-pass
LayerNorm variance in the generators. The logits are held to 1e-5 of their
largest value and the loss to twice that; each gradient tensor, through
the head, the extractor's backward and the generator's, to 1e-4 of its
largest value. A tensor whose exact gradient is zero holds rounding noise
only: the last biases of the Versa processors, since adding one vector to
every class's weight, or one number to every class's bias, leaves the
softmax unchanged (measured: noise of 1.5e-7 of the step's largest
gradient). So a tensor's scale is at least 1e-2 of the step's largest
gradient, which holds such noise to 1e-6 of it.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.learners import steps as jax_steps
from orbit_tpu.models.backbones.efficientnet import EfficientNet as FlaxEfficientNet
from orbit_tpu.models.film import FilmParameterGenerator as FlaxFilmGenerator
from orbit_tpu.models.heads import VersaProcessors as FlaxVersa
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
from orbit_tpu_torch.learners import steps
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones import efficientnet
from orbit_tpu_torch.models.film import FilmParameterGenerator
from orbit_tpu_torch.models.heads import VersaProcessors
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from orbit_tpu_torch.utils.optim import init_optimizer
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

ARCH = tuple(efficientnet.B0_ARCH[:2])
HEAD, SIZE, WAY = 64, 32, 4
# the cut B0's FiLM leaves, the head's at its cut width
SPEC = tuple((path, HEAD if path[0] == "bn2" else size)
             for path, size in efficientnet.efficientnet_film_spec(ARCH, 32))
ARGS = SimpleNamespace(tasks_per_batch=2, learn_extractor=False, with_lite=True,
                       num_lite_samples=4, batch_size=4, optimizer="adam",
                       learning_rate=1e-3, weight_decay=0.1, betas=(0.9, 0.98),
                       epsilon=1e-3, extractor_lr_scale=0.5)
STEP_RTOL, GRAD_TOL = 1e-5, 1e-4


def _clips(rng, colours, labels):
    noise = rng.integers(-25, 26, size=(len(labels), 1, SIZE, SIZE, 3))
    return np.clip(colours[labels][:, None, None, None] + noise, 0, 255).astype(np.uint8)


def _episode(seed: int):
    """8 context and 7 target uint8 clips of 3 objects a few levels apart."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(70, 180, size=3) + rng.integers(-6, 7, size=(3, 3))
    ctx_labels, tgt_labels = np.arange(8) % 3, np.arange(7) % 3
    return {"context_clips": _clips(rng, colours, ctx_labels),
            "context_labels": ctx_labels.astype(np.int32),
            "context_mask": np.ones(8, np.float32),
            "class_mask": (np.arange(WAY) < 3).astype(np.float32),
            "target_clips": _clips(rng, colours, tgt_labels),
            "target_labels": tgt_labels.astype(np.int32),
            "target_mask": np.ones(7, np.float32)}


def _torch_episode(ep):
    return {k: torch.from_numpy(v).long() if k.endswith("labels") else torch.from_numpy(v)
            for k, v in ep.items()}


def _jax_recogniser(classifier: str) -> JaxRecogniser:
    rec = JaxRecogniser(feature_extractor_name="efficientnet_b0", adapt_features=True,
                        classifier=classifier, batch_size=4, learn_extractor=False,
                        num_lite_samples=4)
    object.__setattr__(rec, "extractor", FlaxEfficientNet(arch=ARCH, head_chs=HEAD))
    object.__setattr__(rec, "output_size", HEAD)
    object.__setattr__(rec, "film_spec", SPEC)
    object.__setattr__(rec, "film_generator", FlaxFilmGenerator(film_spec=SPEC))
    if classifier == "versa":
        object.__setattr__(rec, "versa", FlaxVersa(feat_dim=HEAD))
    return rec


def _port(variables, classifier: str) -> SingleStepFewShotRecogniser:
    r = SingleStepFewShotRecogniser("efficientnet_b0", adapt_features=True,
                                    classifier=classifier, batch_size=4, frame_size=SIZE)
    r.extractor = efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD)
    r.output_size, r.film_spec = HEAD, SPEC
    r.film_generator = FilmParameterGenerator(SPEC)
    if classifier == "versa":
        r.versa = VersaProcessors(HEAD)
    state = convert._renamed(convert._flatten(variables))  # the EfficientNet renaming
    r.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()
                       if classifier == "versa" or not k.startswith("versa.")}, strict=True)
    r.extractor.requires_grad_(False)  # the learner's freeze
    return r


@pytest.fixture(scope="module")
def variables():
    """JAX variables of the versa recogniser (every component), numpy, with
    calibrated running statistics and regularisers drawn at 0.05."""
    v = jax.tree_util.tree_map(np.asarray,
                               _jax_recogniser("versa").init(jax.random.PRNGKey(0), SIZE))
    noise = np.random.default_rng(1)
    gen = v["params"]["film_generator"]
    for name in [k for k in gen if k.startswith("reg__")]:
        gen[name] = (0.05 * noise.standard_normal(gen[name].shape)).astype(np.float32)
    port = _port(v, "versa")
    rng = np.random.default_rng(2)
    frames = np.concatenate([_clips(rng, rng.integers(70, 180, size=(3, 3)), np.arange(3))
                             for _ in range(8)])[:, 0]
    efficientnet.calibrate_batchnorm(port.extractor,
                                     port._maybe_normalize(torch.from_numpy(frames)))
    stats = v["batch_stats"]["extractor"]
    for key, value in port.extractor.state_dict().items():
        if key.endswith((".mean", ".var")):
            *path, leaf = key.split(".")
            node = stats
            for part in path:
                node = node[part]
            node[leaf] = value.numpy()
    return v


def _subsets(key, context_mask, nb: int):
    """The JAX step's LITE subsets for its ``nb`` target batches."""
    return [torch.from_numpy(np.array(jnp.argsort(
        jax.random.uniform(k, (context_mask.shape[0],))
        - jnp.asarray(context_mask) * 10.0)[:ARGS.num_lite_samples]))
        for k in jax.random.split(key, nb)]


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


def _close_grads(port_rec, jax_grads):
    named = dict(port_rec.named_parameters())
    ref = convert.from_jax_variables({"params": jax_grads}, expected=set(named))
    assert all(float(r.abs().max()) == 0.0 for k, r in ref.items()
               if k.startswith("extractor."))
    trained = {k: r for k, r in ref.items() if not k.startswith("extractor.")}
    largest = max(float(r.abs().max()) for r in trained.values())
    assert largest > 0
    for name, p in named.items():
        if name.startswith("extractor."):
            assert p.grad is None, name
            continue
        assert p.grad is not None, name
        r = trained[name]
        scale = max(float(r.abs().max()), 1e-2 * largest)
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


# every head with LITE; without LITE the two heads with parameters or an
# inverse (proto's non-LITE step differs from versa's only in the head)
STEP_CASES = [("proto", True), ("versa", True), ("mahalanobis", True), ("versa", False),
              ("mahalanobis", False)]


@pytest.mark.parametrize("classifier,lite", STEP_CASES,
                         ids=[f"{c}-{'lite' if lite else 'non_lite'}" for c, lite in STEP_CASES])
def test_film_step_matches_jax(variables, classifier, lite):
    rec = _jax_recogniser(classifier)
    v = variables if classifier == "versa" else {
        **variables, "params": {k: p for k, p in variables["params"].items() if k != "versa"}}
    ep, key = _episode(10), jax.random.PRNGKey(5)
    build = jax_steps.build_train_task_lite if lite else jax_steps.build_train_task
    j_grads, j_loss, j_logits, _ = jax.jit(build(rec, ARGS, jit=False))(
        v, {k: jnp.asarray(a) for k, a in ep.items()}, key)

    r = _port(v, classifier)
    if lite:
        loss, logits = steps.build_train_task_lite(r, ARGS)(
            _torch_episode(ep), grad_idxs=_subsets(key, ep["context_mask"], 2))
    else:
        loss, logits = steps.build_train_task(r, ARGS)(_torch_episode(ep))
    _close_step(loss, logits, j_loss, j_logits)
    _close_grads(r, j_grads)


# the cut ViT of tests/test_torch_finetuner.py (its _jax_cut and _context)
VIT_FRAME, VIT_DIM, VIT_DEPTH = 64, 64, 2


@pytest.mark.parametrize("classifier", ["mahalanobis", "versa"], ids=["simplecnaps", "cnaps"])
def test_vit_film_lite_step_matches_jax(classifier, monkeypatch):
    """A LITE step of SimpleCNAPs and CNAPs with FiLM on a ViT (the
    ViT-B/32-CLIP layout, pre-norm and LayerNorm eps 1e-5, cut to depth 2,
    width 64, one head) at 64 px, where 2 x 2 patches and the class token
    make S = 5: FiLM from the set encoder and generator into every block's
    norm1 and norm2 (kernel B's affine) and the final norm, the extractor
    frozen. The JAX side takes its plain XLA ops (``force_impl``), every
    leaf of its variables perturbed away from Flax's initial values."""
    from orbit_tpu.ops.tiny_attention import force_impl
    from orbit_tpu_torch.models.backbones import vit
    from tests.test_torch_finetuner import _context, _jax_cut

    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_b_32_clip", (VIT_DIM, VIT_DEPTH, 1, True, 1e-5))
    rec = _jax_cut(JaxRecogniser(feature_extractor_name="vit_b_32_clip", adapt_features=True,
                                 classifier=classifier, batch_size=4, learn_extractor=False,
                                 num_lite_samples=4), True)
    rng = np.random.default_rng(6)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        rec.init(jax.random.PRNGKey(3), frame_size=VIT_FRAME))
    clips, labels, mask, _ = _context(n_real=8, n_pad=8, seed=7)
    t_clips, t_labels, t_mask, _ = _context(n_real=6, n_pad=7, seed=8)
    ep = {"context_clips": clips, "context_labels": labels, "context_mask": mask,
          "class_mask": (np.arange(WAY) < 3).astype(np.float32), "target_clips": t_clips,
          "target_labels": t_labels, "target_mask": t_mask}
    key = jax.random.PRNGKey(9)
    with force_impl("xla"):
        j_grads, j_loss, j_logits, _ = jax.jit(jax_steps.build_train_task_lite(
            rec, ARGS, jit=False))(v, {k: jnp.asarray(a) for k, a in ep.items()}, key)

    r = SingleStepFewShotRecogniser("vit_b_32_clip", adapt_features=True, classifier=classifier,
                                    batch_size=4, frame_size=VIT_FRAME)
    r.load_state_dict(convert.from_jax_variables(v), strict=True)
    r.extractor.requires_grad_(False)  # the learner's freeze
    assert len(r.film_spec) == 4 * VIT_DEPTH + 2
    loss, logits = steps.build_train_task_lite(r, ARGS)(
        _torch_episode(ep), grad_idxs=_subsets(key, ep["context_mask"], 2))
    _close_step(loss, logits, j_loss, np.asarray(j_logits)[:int(t_mask.sum())])
    _close_grads(r, j_grads)


@pytest.mark.parametrize("name", ["mahalanobis", "versa"])
def test_head_gradients_match_jax(name):
    from orbit_tpu.models import heads as jax_heads
    from orbit_tpu.utils.optim import cross_entropy as jax_cross_entropy
    from orbit_tpu_torch.models import heads
    from orbit_tpu_torch.utils.optim import cross_entropy
    from tests.test_heads_grads import C, D, setup

    feats, labels, mask, q, q_labels, class_mask = (np.asarray(a) for a in setup(seed=3))
    processors = FlaxVersa(feat_dim=D)
    params = processors.init(jax.random.PRNGKey(1), jnp.zeros((2, D)))["params"]

    def jax_loss(f, qq, p):
        if name == "versa":
            head = jax_heads.configure_versa(processors, {"params": p}, f, labels, mask, C)
        else:
            head = jax_heads.configure_mahalanobis(f, labels, mask, C)
        logits = jax_heads.PREDICT[name](head, qq, class_mask=class_mask)
        return jax_cross_entropy(logits, q_labels)

    refs = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(feats, q, params)
    ref = [refs[0], refs[1]] + [v for _, v in sorted(convert._flatten(refs[2]).items())]

    versa = VersaProcessors(D)
    versa.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                           for k, v in convert._flatten(params).items()})
    f, qq = (torch.from_numpy(a).requires_grad_() for a in (feats, q))
    head = heads.CONFIGURE[name](f, torch.from_numpy(labels).long(), torch.from_numpy(mask), C,
                                 versa)
    logits = heads.PREDICT[name](head, qq, class_mask=torch.from_numpy(class_mask))
    cross_entropy(logits, torch.from_numpy(q_labels).long()).backward()
    ours = [f.grad, qq.grad] + [torch.zeros_like(p) if p.grad is None else p.grad
                                for _, p in sorted(versa.named_parameters())]
    assert (name == "versa") == all(p.grad is not None for p in versa.parameters())
    largest = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for a, r in zip(ours, ref):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-2 * largest)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=GRAD_TOL * scale)


def test_frozen_extractor_keeps_its_bits_through_adam(variables):
    r = _port(variables, "mahalanobis")
    optimizer = init_optimizer(r, ARGS, extractor_lr_scale=ARGS.extractor_lr_scale)
    frozen = {k: v.clone() for k, v in r.extractor.state_dict().items()}
    generator = {n: p.detach().clone() for n, p in r.film_generator.named_parameters()}
    steps.build_train_task_lite(r, ARGS)(_torch_episode(_episode(11)),
                                         torch.Generator().manual_seed(0))
    steps.build_apply_update(optimizer)()
    assert all(torch.equal(v, frozen[k]) for k, v in r.extractor.state_dict().items())
    moved = [n for n, p in r.film_generator.named_parameters()
             if not torch.equal(p, generator[n])]
    assert len(moved) == len(generator)


def test_all_padding_film_episode_gives_zero_loss_and_no_gradient(variables):
    r = _port(variables, "versa")
    ep = _torch_episode(_episode(12))
    ep["target_mask"] = torch.zeros_like(ep["target_mask"])
    for build in (steps.build_train_task, steps.build_train_task_lite):
        loss, logits = build(r, ARGS)(ep, torch.Generator().manual_seed(0))
        assert float(loss) == 0.0 and logits.shape[0] == 0
        assert all(p.grad is None for p in r.parameters())


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_film")
    for mode in ("train", "validation", "test"):
        os.symlink(os.path.realpath(orbit_fixture_tree), root / mode)
    return str(root)


def _argv(root, ckpt, **flags):
    argv = ["--data_path", root, "--checkpoint_dir", str(ckpt)]
    for flag, value in flags.items():
        argv += [f"--{flag}"] if value is True else [f"--{flag}", str(value)]
    return argv


def test_cli_film_train_test_and_resume(orbit_root, tmp_path, monkeypatch):
    """CNAPs meta-training with LITE through the CLI, on the cut B0 of the
    step tests: the set encoder, the generator and the Versa processors are
    saved, and a resume at the end of the last epoch gives the same final
    model."""
    import single_step_learner_torch
    from orbit_tpu_torch.models import backbones

    def cut_b0(name, dtype=torch.float32):
        return efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD, dtype=dtype), HEAD, SPEC
    monkeypatch.setattr(backbones, "create_efficientnet", cut_b0)
    flags = dict(mode="train_test", feature_extractor="efficientnet_b0", adapt_features=True,
                 classifier="versa", with_lite=True, frame_size=84, epochs=1,
                 num_train_tasks=1, num_val_tasks=1, num_test_tasks=1, tasks_per_batch=2,
                 batch_size=32, num_lite_samples=4, subsample_factor=12, context_shot=2,
                 target_shot=1, test_target_clip_method="random")
    single_step_learner_torch.main(_argv(orbit_root, tmp_path / "run", **flags), device="cpu")
    (run,) = (tmp_path / "run").iterdir()
    for name in ("checkpoint.ckpt", "final.ckpt", "best.ckpt", "results.json", "log.txt"):
        assert (run / name).exists(), name
    log = (run / "log.txt").read_text()
    assert "epoch [1/1] train loss" in log and "validation per-video stats" in log
    final = convert.load(str(run / "final.ckpt"))
    assert any(k.startswith("film_generator.") for k in final)
    assert any(k.startswith("versa.") for k in final)

    single_step_learner_torch.main(
        _argv(orbit_root, tmp_path / "resumed", **{**flags, "mode": "train"},
              resume_from=run / "checkpoint.ckpt"), device="cpu")
    (resumed,) = (tmp_path / "resumed").iterdir()
    assert "resumed from" in (resumed / "log.txt").read_text()
    again = convert.load(str(resumed / "final.ckpt"))
    assert final.keys() == again.keys()
    assert all(torch.equal(final[k], again[k]) for k in final)
