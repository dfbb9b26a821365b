"""``--task_parallel`` on one device: the port's task groups
(``orbit_tpu_torch/parallel/task_dp.py``) held against the port's serial
protocol and against the JAX package, on the CPU (the kernels' plain
versions), f32.

- The host side (``build_query_block``, ``stack_eval_group``) equals the
  JAX package's array for array.
- ``TaskBatchedEval`` (the extractor's batch holding chunk i of every lane,
  the heads batched over lanes; with FiLM, the lanes' forwards one after
  another) against the serial personalise and predict of each task: a
  depth-1, width-64 ViT with the proto head and with CNAPs (FiLM, Versa),
  and EfficientNet-B0's first two stages with a 64-wide head and
  SimpleCNAPs (FiLM, Mahalanobis), over 3 tasks in a group of 4 (a duplicate fill lane) whose
  ragged video counts bucket to one query block.
- ``TaskBatchedFineTune`` against the serial FineTuner, head-only (Adam)
  and with FiLM (SGD with momentum), over lanes of 2, 3 and 4 ways and a
  fill lane: the task parameters and the logits.
- The port's ``TaskBatchedEval`` against the JAX ``TaskBatchedEval`` on
  the same weights (``convert.from_jax_variables``).
- Both port CLIs with ``--task_parallel 2`` against serial on the fixture
  tree: ``results.json`` identical.

Tolerances: rtol = atol = 2e-4, as tests/test_task_parallel.py:81; the
port against itself differs only in batch shapes and summation order, the
JAX check in Flax's one-pass LayerNorm variance and XLA's erf.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from orbit_tpu_torch.data.episodes import Episode, pad_rows
from orbit_tpu_torch.learners.multi_step import build_finetune_fns
from orbit_tpu_torch.learners.steps import build_eval_fns
from orbit_tpu_torch.models.backbones import efficientnet, vit
from orbit_tpu_torch.models.film import FilmParameterGenerator
from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                SingleStepFewShotRecogniser)
from orbit_tpu_torch.parallel import TaskBatchedEval, TaskBatchedFineTune
from orbit_tpu_torch.parallel.task_dp import build_query_block, stack_eval_group
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
SIZE, DIM = 32, 64
# vit_s_32 cut to depth 1, width 64, one head
SMALL_VIT = (DIM, 1, 1, False, 1e-6)


def _arrays(rng, way: int, n_ctx: int, videos, f_b: int = 8):
    """A test episode's arrays: uint8 frames, per-video stacks of ragged
    lengths padded to one frame bucket."""
    frames = [rng.integers(0, 256, (f, SIZE, SIZE, 3), dtype=np.uint8) for f in videos]
    return dict(
        context_clips=rng.integers(0, 256, (n_ctx, 1, SIZE, SIZE, 3), dtype=np.uint8),
        context_labels=(np.arange(n_ctx) % way).astype(np.int32),
        context_mask=np.ones(n_ctx, np.float32), num_classes=16,
        class_mask=(np.arange(16) < way).astype(np.float32), way=way,
        video_frames=[pad_rows(f, f_b) for f in frames],
        video_masks=[pad_rows(np.ones(f.shape[0], np.float32), f_b) for f in frames],
        video_labels=[i % way for i in range(len(videos))],
        video_paths=[np.array([f"v{i}/f{j}" for j in range(f_b)]) for i in range(len(videos))])


def _episodes(seed: int, ways=(3, 3, 3)):
    rng = np.random.default_rng(seed)
    # ragged video counts (3, 3, 4) bucket to one query block of 4 videos
    videos = ([5, 8, 3], [8, 2, 6], [4, 4, 4, 6])
    return [Episode(**_arrays(rng, w, 8, v)) for w, v in zip(ways, videos)]


def _group(eps, dp: int = 4):
    qbs = [build_query_block(e, clip_length=1) for e in eps]
    assert len({q.clips.shape for q in qbs}) == 1
    batch = stack_eval_group(eps, qbs, dp)
    dev = {k: torch.from_numpy(v).long() if k == "context_labels" else torch.from_numpy(v)
           for k, v in batch.items()}
    return qbs, dev


def _serial_ctx(ep):
    return (torch.from_numpy(ep.context_clips), torch.from_numpy(ep.context_labels).long(),
            torch.from_numpy(ep.context_mask), torch.from_numpy(ep.class_mask))


def _lanes_match_serial(logits, eps, qbs, predict_video):
    """Each real lane's logits, video by video, against the serial predict."""
    for i, (ep, qb) in enumerate(zip(eps, qbs)):
        lane = logits[i].numpy().reshape(qb.video_bucket, qb.frame_bucket, -1)
        for vi, frames in enumerate(ep.video_frames):
            ref = predict_video(i, torch.from_numpy(frames[:, None])).numpy()
            n = qb.n_frames[vi]
            np.testing.assert_allclose(lane[vi][:n], ref[:n], **TOL)
            assert (lane[vi][:n, ep.way:] < -1e20).all()  # padded classes masked per lane


def test_host_copies_match_jax():
    from orbit_tpu.data.episodes import Episode as JaxEpisode
    from orbit_tpu.parallel import task_dp as jax_task_dp

    rng = np.random.default_rng(0)
    videos = ([5, 8, 3], [200, 2], [4, 4, 4, 6, 1])
    arrays = [_arrays(rng, 3, 8, v, f_b=f_b) for v, f_b in zip(videos, (8, 256, 8))]
    for clip_length in (1, 4):
        ours = [build_query_block(Episode(**a), clip_length) for a in arrays]
        ref = [jax_task_dp.build_query_block(JaxEpisode(**a), clip_length) for a in arrays]
        for q, r in zip(ours, ref):
            assert (q.frame_bucket, q.video_bucket, q.n_videos, q.n_frames) == \
                   (r.frame_bucket, r.video_bucket, r.n_videos, r.n_frames)
            np.testing.assert_array_equal(q.clips, r.clips)
    eps = [Episode(**a) for a in arrays[:1]] * 2
    j_eps = [JaxEpisode(**a) for a in arrays[:1]] * 2
    ours = stack_eval_group(eps, [build_query_block(e, 1) for e in eps], 3)
    ref = jax_task_dp.stack_eval_group(j_eps, [jax_task_dp.build_query_block(e, 1)
                                               for e in j_eps], 3)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _small_b0(rec, eps):
    """``rec``'s EfficientNet-B0 cut to its first two stages with a 64-wide
    head (its FiLM spec and generator to match), drawn from a seed, its
    BatchNorm statistics calibrated on the tasks' context frames (random
    weights lose the input otherwise)."""
    arch = tuple(efficientnet.B0_ARCH[:2])
    spec = tuple((path, DIM if path[0] == "bn2" else size)
                 for path, size in efficientnet.efficientnet_film_spec(arch, 32))
    rec.extractor = efficientnet.EfficientNet(arch=arch, head_chs=DIM)
    rec.output_size, rec.film_spec = DIM, spec
    rec.film_generator = FilmParameterGenerator(spec)
    rec.init(0)
    frames = torch.from_numpy(np.concatenate([ep.context_clips[:, 0] for ep in eps]))
    efficientnet.calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames))
    return rec


@pytest.mark.parametrize("extractor, classifier, film", [
    ("vit_s_32", "proto", False),
    ("vit_s_32", "versa", True),
    ("efficientnet_b0", "mahalanobis", True)])
def test_batched_eval_matches_serial(extractor, classifier, film, monkeypatch):
    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32", SMALL_VIT)
    eps = _episodes(7)
    rec = SingleStepFewShotRecogniser(extractor, adapt_features=film, classifier=classifier,
                                      batch_size=4, frame_size=SIZE).init(0)
    if extractor == "efficientnet_b0":
        rec = _small_b0(rec, eps)
    qbs, dev = _group(eps)
    forwards = rec.extractor.forward_calls
    tbe = TaskBatchedEval(rec, dp=4)
    logits = tbe.predict(tbe.personalise(dev), dev["query_clips"], dev["class_mask"])
    # context 8 clips and query 32 frames in chunks of 4 a lane: the lanes
    # share each call without FiLM, and run one after another with it
    calls = rec.extractor.forward_calls - forwards
    assert calls == (4 * (2 + 8) if film else 2 + 8)

    personalise, predict = build_eval_fns(rec)
    states = [personalise(*_serial_ctx(ep)) for ep in eps]
    _lanes_match_serial(logits, eps, qbs, lambda i, clips: predict(
        states[i], clips, torch.from_numpy(eps[i].class_mask)))


FT_ARGS = dict(personalize_learning_rate=0.05, personalize_weight_decay=0.1,
               personalize_extractor_lr_scale=0.5, personalize_epsilon=1e-8,
               personalize_betas=(0.9, 0.999), batch_size=6)


@pytest.mark.parametrize("film, optimizer", [(False, "adam"), (True, "sgd")])
def test_batched_finetune_matches_serial(film, optimizer, monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32", SMALL_VIT)
    args = SimpleNamespace(personalize_num_grad_steps=3, personalize_optimizer=optimizer,
                           personalize_momentum=0.9 if optimizer == "sgd" else 0.0,
                           **FT_ARGS)
    rec = MultiStepFewShotRecogniser("vit_s_32", adapt_features=film, classifier="linear",
                                     batch_size=6, frame_size=SIZE).init(0)
    eps = _episodes(9, ways=(2, 3, 4))  # lanes of different way, one fill lane
    qbs, dev = _group(eps)
    tbf = TaskBatchedFineTune(rec, args, dp=4)
    task_params = tbf.personalise(dev)
    logits = tbf.predict(task_params, dev["query_clips"], dev["class_mask"])

    personalise, predict = build_finetune_fns(rec, args)
    serial = [personalise(*_serial_ctx(ep)) for ep in eps]
    for i, ref in enumerate(serial):
        ours = MultiStepFewShotRecogniser.task_leaves(task_params)
        for a, b in zip(ours, MultiStepFewShotRecogniser.task_leaves(ref)):
            np.testing.assert_allclose(a[i].detach().numpy(), b.detach().numpy(), **TOL)
        assert float(ref["head"]["weight"].detach().abs().max()) > 0  # the head trained
    _lanes_match_serial(logits, eps, qbs, lambda i, clips: predict(
        serial[i], clips, torch.from_numpy(eps[i].class_mask)))


def test_batched_eval_matches_jax():
    import jax
    import jax.numpy as jnp

    from orbit_tpu.data.episodes import Episode as JaxEpisode
    from orbit_tpu.models.backbones.vit import ViT as FlaxViT
    from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
    from orbit_tpu.parallel import TaskBatchedEval as JaxTaskBatchedEval
    from orbit_tpu.parallel import task_dp as jax_task_dp
    from orbit_tpu_torch.models import convert

    j_rec = JaxRecogniser(feature_extractor_name="vit_s_32", classifier="proto", batch_size=4)
    object.__setattr__(j_rec, "extractor", FlaxViT(patch_size=32, dim=DIM, depth=1,
                                                   num_heads=1))
    object.__setattr__(j_rec, "output_size", DIM)
    variables = j_rec.init(jax.random.PRNGKey(0), frame_size=SIZE)
    noise = np.random.default_rng(1)  # non-trivial biases, affines and class token
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * noise.standard_normal(a.shape).astype(np.float32),
        variables)
    rec = SingleStepFewShotRecogniser("vit_s_32", batch_size=4, frame_size=SIZE)
    rec.extractor = vit.ViT(dim=DIM, depth=1, num_heads=1, frame_size=SIZE)
    rec.load_state_dict(convert.from_jax_variables(variables), strict=True)

    rng = np.random.default_rng(5)
    arrays = [_arrays(rng, 3, 8, v) for v in ([5, 8, 3], [8, 2, 6])]
    eps = [Episode(**a) for a in arrays]
    _, dev = _group(eps, dp=3)
    tbe = TaskBatchedEval(rec, dp=3)
    ours = tbe.predict(tbe.personalise(dev), dev["query_clips"], dev["class_mask"]).numpy()

    j_eps = [JaxEpisode(**a) for a in arrays]
    j_batch = {k: jnp.asarray(v) for k, v in jax_task_dp.stack_eval_group(
        j_eps, [jax_task_dp.build_query_block(e, 1) for e in j_eps], 3).items()}
    j_tbe = JaxTaskBatchedEval(j_rec, dp=3)
    ref = np.asarray(j_tbe.predict(variables, j_tbe.personalise(variables, j_batch),
                                   j_batch["query_clips"], j_batch["class_mask"]))
    real = ref > -1e29
    assert (ours[~real] == -1e30).all()
    np.testing.assert_allclose(ours[real], ref[real], **TOL)


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_task_parallel")
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "test")
    return str(root)


@pytest.mark.parametrize("learner", ["single", "multi"])
def test_cli_results_identical_to_serial(learner, orbit_root, tmp_path, monkeypatch):
    """``--task_parallel 2`` end to end (2 users x 2 tasks, so two full
    groups): the evaluator's order, the rollups, the MACs and
    ``results.json`` equal the serial run's."""
    import multi_step_learner_torch
    import single_step_learner_torch

    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32", SMALL_VIT)
    main = {"single": single_step_learner_torch.main,
            "multi": multi_step_learner_torch.main}[learner]
    argv = ["--data_path", orbit_root, "--mode", "test", "--feature_extractor", "vit_s_32",
            "--frame_size", "84", "--batch_size", "8", "--num_test_tasks", "2",
            "--subsample_factor", "4", "--context_shot", "2", "--target_shot", "1",
            "--test_target_clip_method", "random"]
    if learner == "multi":
        argv += ["--classifier", "linear", "--personalize_num_grad_steps", "2",
                 "--personalize_learning_rate", "0.1", "--adapt_features"]
    results = {}
    for tp in (1, 2):
        out = tmp_path / f"tp{tp}"
        main(argv + ["--checkpoint_dir", str(out), "--task_parallel", str(tp)], device="cpu")
        (run,) = out.iterdir()
        results[tp] = json.loads((run / "results.json").read_text())
        log = (run / "log.txt").read_text()
    assert set(results[1]) == {"P001", "P002"}
    assert results[2] == results[1]
    assert "--task_parallel 2 on one device: batching task groups of 2" in log
