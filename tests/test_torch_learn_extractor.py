"""Meta-training an EfficientNet with ``--learn_extractor`` on the port,
held against the JAX package on the CPU: train-mode BatchNorm on masked
batch statistics and the running statistics' schedule.

Two settings, both at 32 px:
- the cut B0 of tests/test_torch_film_train.py (stem, the DepthwiseSeparable
  block, a stride-2 and a stride-1 InvertedResidual, a 64-wide head conv),
  batch 4, its weights drawn by the port's initialisers and carried to the
  JAX side by name, every BatchNorm's scale, bias and running statistics
  drawn away from their initial values. Its episode has 10 context clips of
  which 8 are real (three chunks of 4, the last of padding only) and 12
  target clips of which 5 are real: the JAX LITE step runs three target
  batches, the third of padding only, whose grad subset still moves the
  running statistics; the port runs rows 0-3, then row 4 alone, then that
  subset's forward without a graph. The JAX subsets are recomputed from its
  key and injected, as in tests/test_torch_train.py.
- EfficientNet-B0 at full depth and width, batch 8, ``num_lite_samples``
  4, 8 context and 8 target clips: the setting of tests/test_lite_bn_drift.py,
  whose JAX step this file reuses.

- The masked train-mode forward over three chunks (one of padding only):
  the real clips' features and the running statistics against JAX's.
- The statistics after a checkpointed three-chunk embed with gradients and
  its backward equal those after the same embed with no gradients: the
  recompute neither updates them twice nor sees later ones.
- One LITE and one non-LITE step, ProtoNets and SimpleCNAPs (FiLM, the
  Mahalanobis head), on the cut B0: loss, logits, every gradient (the
  extractor's, and the set encoder's and FiLM generator's) and the running
  statistics after the step against the JAX step's; and a target of
  padding only, whose context passes still move the statistics.
- The LITE schedule over 3 tasks on the full B0, the running statistics
  carried from task to task: each task's loss and the statistics after the
  last against the JAX steps', and the first task's extractor gradients;
  the JAX statistics reach the port's buffers through
  ``convert.from_jax_variables``.
- A cut EfficientNetV2-S (its three block kinds: ConvBnAct with its
  residual, EdgeResidual at stride 2 and with its residual, InvertedResidual
  with squeeze-excite) in train mode on 2 real frames and a pad frame.
- The CLI in ``--mode train_test`` with ``--learn_extractor --with_lite`` on
  the cut B0: it writes its checkpoints and ``results.json``, the trained
  running statistics are in them, and ``--resume_from`` restores them.

Tolerances (f32): the two sides differ in summation order (convolutions,
the BatchNorm moments, the heads' products and inverses). The features and
logits are held to 1e-5 of their largest value, the loss to 2e-5 of the
largest logit (as tests/test_torch_film_train.py); each gradient tensor to
1e-4 of its largest value, with a floor of 1e-2 of the step's largest
gradient: a tensor whose exact gradient is zero holds rounding noise only,
e.g. the bias of a BatchNorm that reaches the loss through linear maps
into train-mode BatchNorms only (bn3 of an InvertedResidual block), which
subtract any constant shift. The running means are held in units of the
running deviation sqrt(var + eps) (a mean near 0 is a sum of values the
size of the deviation, and carries their rounding), the variances relative
to themselves: 1e-5 (measured: 2.7e-7 and 4.4e-7). On the full B0, 16
blocks of batch statistics compound the roundings over three tasks: the
loss is held to 1e-4 of the largest logit (measured 8.2e-6), the
gradients to 1e-3 of a tensor (4.4e-4), the means to 1e-5 (7.1e-7) and
the variances to 2e-4 (5.2e-5).
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
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
from orbit_tpu_torch.learners import steps
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones import efficientnet
from orbit_tpu_torch.models.film import FilmParameterGenerator
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from tests.test_torch_film_train import ARCH, HEAD, SIZE, SPEC, WAY, _clips
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

ARGS = SimpleNamespace(tasks_per_batch=2, learn_extractor=True, with_lite=True,
                       num_lite_samples=4, batch_size=4)
STEP_RTOL, GRAD_TOL, MEAN_TOL, VAR_TOL = 1e-5, 1e-4, 1e-5, 1e-5
N_CTX, N_TGT, REAL_CTX, REAL_TGT = 10, 12, 8, 5


def _jax_rec(classifier: str) -> JaxRecogniser:
    """The cut B0 recogniser meta-training its extractor: ProtoNets, or
    SimpleCNAPs with FiLM over the cut B0's tagged BatchNorms."""
    film = classifier == "mahalanobis"
    rec = JaxRecogniser(feature_extractor_name="efficientnet_b0", adapt_features=film,
                        classifier=classifier, batch_size=4, learn_extractor=True,
                        num_lite_samples=4)
    object.__setattr__(rec, "extractor", FlaxEfficientNet(arch=ARCH, head_chs=HEAD))
    object.__setattr__(rec, "output_size", HEAD)
    if film:
        object.__setattr__(rec, "film_spec", SPEC)
        object.__setattr__(rec, "film_generator", FlaxFilmGenerator(film_spec=SPEC))
    return rec


def _port(variables, classifier: str) -> SingleStepFewShotRecogniser:
    film = classifier == "mahalanobis"
    r = SingleStepFewShotRecogniser("efficientnet_b0", adapt_features=film,
                                    classifier=classifier, batch_size=4, frame_size=SIZE)
    r.extractor = efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD)
    r.output_size = HEAD
    if film:
        r.film_spec = SPEC
        r.film_generator = FilmParameterGenerator(SPEC)
    if variables is not None:
        state = convert._renamed(convert._flatten(variables))  # the EfficientNet renaming
        r.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in state.items()}, strict=True)
    return r


def _jax_variables(state_dict) -> dict:
    """A port state dict as JAX variables: the Flax names, the running
    statistics under ``batch_stats`` (the inverse of ``convert``'s
    renaming)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().numpy().copy()
    return tree


@pytest.fixture(scope="module")
def variables():
    """Variables of the cut B0 with the set encoder and FiLM generator,
    drawn by the port's initialisers, with the BatchNorms' scale, bias, mean
    and var drawn away from the identity; as JAX variables."""
    r = _port(None, "mahalanobis").init(0)
    rng = np.random.default_rng(3)
    state = r.state_dict()
    for key, value in state.items():
        if key.startswith("extractor.") and key.endswith((".scale", ".bias", ".mean", ".var")):
            noise = torch.from_numpy(rng.standard_normal(value.shape).astype(np.float32))
            leaf = key.rsplit(".", 1)[1]
            value.copy_({"scale": 1 + 0.2 * noise, "bias": 0.2 * noise, "mean": 0.3 * noise,
                         "var": 1.25 + 0.75 * torch.tanh(noise)}[leaf])
    return _jax_variables(state)


def _for(variables, classifier: str):
    if classifier == "mahalanobis":
        return variables
    return {**variables, "params": {"extractor": variables["params"]["extractor"]}}


def _episode(seed: int):
    """10 context clips (8 real) and 12 target clips (5 real) of 3 objects a
    few levels apart, 4 class slots (one padded)."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(70, 180, size=3) + rng.integers(-6, 7, size=(3, 3))
    ctx_labels, tgt_labels = np.arange(N_CTX) % 3, np.arange(N_TGT) % 3
    return {"context_clips": _clips(rng, colours, ctx_labels),
            "context_labels": ctx_labels.astype(np.int32),
            "context_mask": (np.arange(N_CTX) < REAL_CTX).astype(np.float32),
            "class_mask": (np.arange(WAY) < 3).astype(np.float32),
            "target_clips": _clips(rng, colours, tgt_labels),
            "target_labels": tgt_labels.astype(np.int32),
            "target_mask": (np.arange(N_TGT) < REAL_TGT).astype(np.float32)}


def _torch_episode(ep):
    return {k: torch.from_numpy(v).long() if k.endswith("labels") else torch.from_numpy(v)
            for k, v in ep.items()}


@jax.jit
def _order(key, context_mask):
    return jnp.argsort(jax.random.uniform(key, context_mask.shape) - context_mask * 10.0)


def _subsets(key, context_mask, nb: int, num_lite: int):
    """The JAX step's LITE subsets for its ``nb`` target batches."""
    return [torch.from_numpy(np.array(_order(k, jnp.asarray(context_mask))[:num_lite]))
            for k in jax.random.split(key, nb)]


def _stats_state(stats) -> dict:
    """A JAX ``batch_stats/extractor`` tree as the port's buffer names."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            convert._renamed(convert._flatten({"batch_stats": {"extractor": stats}})).items()}


def _close_stats(buffers: dict, reference: dict, mean_tol=MEAN_TOL, var_tol=VAR_TOL):
    """Running means in units of the running deviation sqrt(var + eps)
    (a mean near 0 carries the rounding of sums of values the size of the
    deviation), running variances relative to themselves."""
    assert reference and set(reference) <= set(buffers)
    for name, ref in reference.items():
        if name.endswith(".mean"):
            unit = (reference[name[:-len("mean")] + "var"] + 1e-3).sqrt()
            err, tol = float(((buffers[name] - ref).abs() / unit).max()), mean_tol
        else:
            err, tol = float(((buffers[name] - ref).abs() / ref).max()), var_tol
        assert err <= tol, f"{name}: {err:.3e} > {tol}"


def _close_grads(port_rec, jax_grads, tol=GRAD_TOL):
    ref = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in convert._renamed(convert._flatten({"params": jax_grads})).items()}
    named = dict(port_rec.named_parameters())
    assert set(ref) == set(named)
    largest = max(float(r.abs().max()) for r in ref.values())
    assert largest > 0
    for name, r in ref.items():
        g = named[name].grad
        assert g is not None, name
        scale = max(float(r.abs().max()), 1e-2 * largest)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=tol * scale,
                                   err_msg=name)


def _close_step(loss, logits, j_loss, j_logits):
    j_logits = np.asarray(j_logits)[:REAL_TGT]
    real = j_logits > -1e29
    assert logits.shape == j_logits.shape
    np.testing.assert_array_equal(logits.numpy() > -1e29, real)
    scale = np.abs(j_logits[real]).max()
    np.testing.assert_allclose(logits.numpy()[real], j_logits[real], rtol=STEP_RTOL,
                               atol=STEP_RTOL * scale)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                               atol=2 * STEP_RTOL * scale)


def test_masked_train_forward_matches_jax(variables):
    """Three chunks of 4 (the last of padding only) in train mode: the real
    clips' features and the running statistics threaded chunk to chunk."""
    rec = _jax_rec("proto")
    v = _for(variables, "proto")
    ep = _episode(20)
    feats, stats = jax.jit(lambda v, c, m: rec.embed_clips(
        v, c, train=True, with_grad=False, collect_stats=True, clip_mask=m))(
        v, jnp.asarray(ep["context_clips"]), jnp.asarray(ep["context_mask"]))
    r = _port(v, "proto")
    ours = r.embed_clips(torch.from_numpy(ep["context_clips"]), train=True,
                         clip_mask=torch.from_numpy(ep["context_mask"]))
    ref = np.asarray(feats)[:REAL_CTX]
    np.testing.assert_allclose(ours.numpy()[:REAL_CTX], ref, rtol=0,
                               atol=STEP_RTOL * np.abs(ref).max())
    assert not ours[REAL_CTX:].any()  # pad rows are pinned to zero
    _close_stats(dict(r.named_buffers()), _stats_state(stats))


def test_checkpointed_embed_statistics_equal_unchecked(variables):
    """With gradients, above ``batch_size`` frames each chunk is recomputed
    in the backward; the running statistics must be those of the same embed
    with no gradients, and the backward must not move them."""
    ep = _torch_episode(_episode(21))
    clips, mask = ep["context_clips"], ep["context_mask"]
    plain = _port(_for(variables, "proto"), "proto")
    with torch.no_grad():
        ref_feats = plain.embed_clips(clips, train=True, clip_mask=mask)
    ref = {k: b.clone() for k, b in plain.named_buffers() if k.startswith("extractor.")}

    r = _port(_for(variables, "proto"), "proto")
    calls = r.extractor.forward_calls
    feats = r.embed_clips(clips, with_grad=True, train=True, clip_mask=mask)
    assert feats.requires_grad and r.extractor.forward_calls == calls + 3
    after_forward = {k: b.clone() for k, b in r.named_buffers() if k in ref}
    (feats * torch.linspace(-1, 1, feats.numel()).reshape(feats.shape)).sum().backward()
    assert r.extractor.forward_calls == calls + 6  # the backward recomputed 3 chunks
    assert all(torch.equal(after_forward[k], b) for k, b in r.named_buffers() if k in ref)
    assert torch.equal(feats.detach(), ref_feats)
    assert all(torch.equal(ref[k], b) for k, b in r.named_buffers() if k in ref)
    assert all(p.grad is not None for p in r.extractor.parameters())


STEP_CASES = [("proto", True), ("proto", False), ("mahalanobis", True),
              ("mahalanobis", False)]


_JAX_STEPS = {}


def _jax_step(classifier: str, lite: bool):
    """The JAX step, jitted once per module (its trace takes seconds)."""
    if (classifier, lite) not in _JAX_STEPS:
        build = jax_steps.build_train_task_lite if lite else jax_steps.build_train_task
        _JAX_STEPS[classifier, lite] = jax.jit(build(_jax_rec(classifier), ARGS, jit=False))
    return _JAX_STEPS[classifier, lite]


@pytest.mark.parametrize("classifier,lite", STEP_CASES,
                         ids=[f"{'protonets' if c == 'proto' else 'simplecnaps'}-"
                              f"{'lite' if lite else 'non_lite'}" for c, lite in STEP_CASES])
def test_step_matches_jax(variables, classifier, lite):
    v = _for(variables, classifier)
    ep, key = _episode(22), jax.random.PRNGKey(7)
    j_grads, j_loss, j_logits, j_stats = _jax_step(classifier, lite)(
        v, {k: jnp.asarray(a) for k, a in ep.items()}, key)

    r = _port(v, classifier)
    if lite:
        nb = -(-N_TGT // ARGS.batch_size)  # the JAX step's batches, the last padding only
        loss, logits = steps.build_train_task_lite(r, ARGS)(
            _torch_episode(ep), grad_idxs=_subsets(key, ep["context_mask"], nb, 4))
    else:
        loss, logits = steps.build_train_task(r, ARGS)(_torch_episode(ep))
    _close_step(loss, logits, j_loss, j_logits)
    _close_grads(r, j_grads)
    _close_stats(dict(r.named_buffers()), _stats_state(j_stats))


@pytest.mark.parametrize("lite", [True, False], ids=["lite", "non_lite"])
def test_all_padding_target_moves_statistics_as_jax(variables, lite):
    """A target of padding only: zero loss and no gradient, but the context
    passes (and with LITE every batch's grad subset) still move the running
    statistics, as in the JAX step."""
    v = _for(variables, "proto")
    ep, key = _episode(23), jax.random.PRNGKey(8)
    ep["target_mask"] = np.zeros_like(ep["target_mask"])
    *_, j_stats = _jax_step("proto", lite)(v, {k: jnp.asarray(a) for k, a in ep.items()}, key)
    r = _port(v, "proto")
    before = {k: b.clone() for k, b in r.extractor.named_buffers()}
    if lite:
        loss, logits = steps.build_train_task_lite(r, ARGS)(
            _torch_episode(ep), grad_idxs=_subsets(key, ep["context_mask"], 3, 4))
    else:
        loss, logits = steps.build_train_task(r, ARGS)(_torch_episode(ep))
    assert float(loss) == 0.0 and logits.shape[0] == 0
    assert all(p.grad is None for p in r.parameters())
    assert all(not torch.equal(before[k], b) for k, b in r.extractor.named_buffers())
    _close_stats(dict(r.named_buffers()), _stats_state(j_stats))


B0_LOSS_TOL, B0_GRAD_TOL, B0_MEAN_TOL, B0_VAR_TOL = 1e-4, 1e-3, 1e-5, 2e-4
B0_ARGS = SimpleNamespace(tasks_per_batch=1, learn_extractor=True, with_lite=True,
                          num_lite_samples=4, batch_size=8)


def test_lite_schedule_over_three_tasks_on_b0():
    """Full B0, the setting of tests/test_lite_bn_drift.py: three LITE tasks
    with the running statistics carried from task to task."""
    from tests.test_lite_bn_drift import episode

    rec = JaxRecogniser(feature_extractor_name="efficientnet_b0", classifier="proto",
                        batch_size=8, learn_extractor=True, num_lite_samples=4)
    task_fn = jax_steps.build_train_task_lite(rec, B0_ARGS)
    rng = np.random.default_rng(0)
    episodes = [episode(rng) for _ in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(1), len(episodes))

    r = SingleStepFewShotRecogniser("efficientnet_b0", classifier="proto", batch_size=8,
                                    frame_size=32).init(0)
    variables = _jax_variables(r.state_dict())
    r.load_state_dict(convert.from_jax_variables(variables), strict=True)
    step = steps.build_train_task_lite(r, B0_ARGS)
    ours = variables
    for i, (ep, k) in enumerate(zip(episodes, keys)):
        j_grads, j_loss, j_logits, new_stats = task_fn(
            ours, {k2: jnp.asarray(a) for k2, a in ep.items()}, k)
        ours = {**ours, "batch_stats": {**ours["batch_stats"], "extractor": new_stats}}
        r.zero_grad(set_to_none=True)
        loss, logits = step(_torch_episode(ep),
                            grad_idxs=_subsets(k, ep["context_mask"], 1, 4))
        j_logits = np.asarray(j_logits)
        scale = float(np.abs(j_logits[j_logits > -1e29]).max())  # the real classes
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                                   atol=B0_LOSS_TOL * scale, err_msg=f"task {i}")
        if i == 0:
            _close_grads(r, j_grads, tol=B0_GRAD_TOL)
    state = convert.from_jax_variables(jax.tree_util.tree_map(np.asarray, ours))
    _close_stats(dict(r.named_buffers()),
                 {k: v for k, v in state.items() if k.endswith((".mean", ".var"))},
                 B0_MEAN_TOL, B0_VAR_TOL)


V2_ARCH = (("cn", 2, 3, 1, 1.0, 24, 0.0), ("er", 2, 3, 2, 4.0, 48, 0.0),
           ("ir", 2, 3, 2, 4.0, 64, 0.25))


def test_v2_s_train_forward_matches_jax():
    """A cut EfficientNetV2-S (stem 24, ConvBnAct, EdgeResidual and
    InvertedResidual stages of two blocks, a 64-wide head) in train mode on
    two real frames and a pad frame."""
    flax_model = FlaxEfficientNet(arch=V2_ARCH, stem_chs=24, head_chs=HEAD)
    x = np.random.default_rng(4).standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(flax_model.init)(
        jax.random.PRNGKey(2), jnp.asarray(x)))
    feats, mut = jax.jit(lambda v, x, m: flax_model.apply(
        v, x, train=True, mask=m, mutable=["batch_stats"]))(v, jnp.asarray(x), jnp.asarray(mask))

    port = efficientnet.EfficientNet(arch=V2_ARCH, stem_chs=24, head_chs=HEAD)
    state = convert._renamed(convert._flatten({"params": {"extractor": v["params"]},
                                               "batch_stats": {"extractor": v["batch_stats"]}}))
    port.load_state_dict({k[len("extractor."):]: torch.from_numpy(np.array(a, np.float32))
                          for k, a in state.items()}, strict=True)
    with torch.no_grad():
        ours, new = port(torch.from_numpy(x), train=True, mask=torch.from_numpy(mask))
    ref = np.asarray(feats)
    np.testing.assert_allclose(ours.numpy()[:2], ref[:2], rtol=0,
                               atol=STEP_RTOL * np.abs(ref).max())
    ref_stats = _stats_state(mut["batch_stats"])
    assert len(new) == len(ref_stats) // 2
    _close_stats({f"extractor.{path}.{leaf}": t for path, pair in new.items()
                  for leaf, t in zip(("mean", "var"), pair)}, ref_stats)


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_learn_extractor")
    for mode in ("train", "validation", "test"):
        os.symlink(os.path.realpath(orbit_fixture_tree), root / mode)
    return str(root)


def _argv(root, ckpt, **flags):
    argv = ["--data_path", root, "--checkpoint_dir", str(ckpt)]
    for flag, value in flags.items():
        argv += [f"--{flag}"] if value is True else [f"--{flag}", str(value)]
    return argv


def test_cli_learn_extractor_train_test_and_resume(orbit_root, tmp_path, monkeypatch):
    """ProtoNets+LITE meta-training of the cut B0 through the CLI: the
    running statistics move, are saved in the checkpoints and the final
    model, and a resume at the end of the last epoch restores them."""
    import single_step_learner_torch
    from orbit_tpu_torch.models import backbones

    def cut_b0(name, dtype=torch.float32):
        return efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD, dtype=dtype), HEAD, SPEC
    monkeypatch.setattr(backbones, "create_efficientnet", cut_b0)
    flags = dict(mode="train_test", feature_extractor="efficientnet_b0", classifier="proto",
                 with_lite=True, learn_extractor=True, frame_size=84, epochs=1,
                 num_train_tasks=1, num_val_tasks=1, num_test_tasks=1, tasks_per_batch=2,
                 batch_size=8, num_lite_samples=4, subsample_factor=12, context_shot=2,
                 target_shot=1, test_target_clip_method="random")
    single_step_learner_torch.main(_argv(orbit_root, tmp_path / "run", **flags), device="cpu")
    (run,) = (tmp_path / "run").iterdir()
    for name in ("checkpoint.ckpt", "final.ckpt", "best.ckpt", "results.json", "log.txt"):
        assert (run / name).exists(), name
    log = (run / "log.txt").read_text()
    assert "epoch [1/1] train loss" in log and "validation per-video stats" in log
    final = convert.load(str(run / "final.ckpt"))
    init = efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD).state_dict()
    stats = [k for k in final if k.endswith((".mean", ".var"))]
    assert stats and all(not torch.equal(final[k], init[k[len("extractor."):]])
                         for k in stats)
    saved = torch.load(str(run / "checkpoint.ckpt"), weights_only=True)["state_dict"]
    assert all(torch.equal(saved[k], final[k]) for k in stats)

    single_step_learner_torch.main(
        _argv(orbit_root, tmp_path / "resumed", **{**flags, "mode": "train"},
              resume_from=run / "checkpoint.ckpt"), device="cpu")
    (resumed,) = (tmp_path / "resumed").iterdir()
    assert "resumed from" in (resumed / "log.txt").read_text()
    again = convert.load(str(resumed / "final.ckpt"))
    assert final.keys() == again.keys()
    assert all(torch.equal(final[k], again[k]) for k in final)
