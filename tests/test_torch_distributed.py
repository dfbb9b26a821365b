"""The port's parallel axes across ranks (``orbit_tpu_torch/parallel/``) in
a 2-rank gloo group on the CPU, held against the port's serial paths and
against the JAX package's ``EpisodeDataParallel``.

The group is spawned once for the module (two processes, one torch thread
each, ``OMP_NUM_THREADS=1``); each rank runs every scenario in it and the
tests assert on what the ranks return:
- episode-DP: the rank-summed gradients of a 2-task batch against the
  serial sum of the same tasks' gradients, LITE (the subsets drawn in
  lane order from one seed on every rank, as the serial loop draws them)
  and not; a dummy lane (``target_mask`` zeroed) gives exactly zero loss
  and gradient; with BatchNorm batch statistics (``--learn_extractor`` on
  an EfficientNet) the averaged running statistics leave the dummy lane
  out; ``train_epoch`` over 4 tasks with ``tasks_per_batch`` 3 applies the
  overshooting window's mean, and over 3 tasks with ``tasks_per_batch`` 4
  trains the leftover task (the final partial window), both against the
  serial accumulate-then-update, with the parameters equal on both ranks;
- query sharding: a 13-frame query's logits against one rank's;
- FineTuner row sharding (head-only and FiLM) against the serial FineTuner:
  the task parameters and the logits;
- task lanes across ranks (3 lanes on 2 ranks), single-step and FineTuner,
  against the serial per-task programs;
- both CLIs in the group (``--data_parallel 2``; the FineTuner also with
  ``--task_parallel 2``, whose results.json equals the row-sharded run's):
  only rank 0 writes;
- the port's 2-rank episode-DP gradient against the JAX
  ``EpisodeDataParallel`` on a 2-device CPU mesh (tests/conftest.py), on
  the same weights (``convert.from_jax_variables``).

Models: ``vit_s_32`` cut to depth 1, width 64 (one head), and
EfficientNet-B0's first two stages with a 64-wide head, at 32 px, f32.
Tolerances: rtol = atol = 2e-4 for logits and task parameters (as
tests/test_task_parallel.py:81); gradients per tensor to 1e-4 of the
tensor's largest value, floored at 1e-3 of the step's largest gradient (a
tensor whose exact gradient is zero, such as the final LayerNorm's bias
under the proto head, holds rounding noise only: ROADMAP, "Exact-zero
gradients"); the JAX check to 1e-4 as tests/test_torch_train.py.
"""
from __future__ import annotations

import json
import os
import socket
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

SIZE, DIM = 32, 64
SMALL_VIT = (DIM, 1, 1, False, 1e-6)
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops (as in
    tests/test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the tasks ----
def train_task(seed: int, n_ctx: int = 8, n_tgt: int = 7, way: int = 3) -> dict:
    """A train task dict (the loader's keys): uint8 clips of ``way``
    objects a few levels apart under noise, so the loss does not saturate."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(80, 170, size=3) + rng.integers(-4, 5, size=(way, 3))

    def clips(labels):
        noise = rng.integers(-20, 21, size=(len(labels), 1, SIZE, SIZE, 3))
        return np.clip(colours[labels][:, None, None, None] + noise, 0, 255).astype(np.uint8)

    ctx_labels, tgt_labels = np.arange(n_ctx) % way, np.arange(n_tgt) % way
    return {"context_clips": clips(ctx_labels), "context_labels": ctx_labels,
            "target_clips": clips(tgt_labels), "target_labels": tgt_labels}


def eval_episode(seed: int, videos=(5, 8, 3), way: int = 3):
    """A padded test-mode episode with per-video frame stacks."""
    from orbit_tpu_torch.data.episodes import pad_episode

    rng = np.random.default_rng(seed)
    task = {"context_clips": rng.integers(0, 256, (8, 1, SIZE, SIZE, 3), dtype=np.uint8),
            "context_labels": np.arange(8) % way,
            "target_clips": [rng.integers(0, 256, (f, SIZE, SIZE, 3), dtype=np.uint8)
                             for f in videos],
            "target_labels": [i % way for i in range(len(videos))],
            "target_paths": [np.array([f"v{i}/f{j}" for j in range(f)])
                             for i, f in enumerate(videos)]}
    return pad_episode(task, video_buckets=(8,))


def train_args(**over) -> SimpleNamespace:
    base = dict(tasks_per_batch=2, learn_extractor=True, with_lite=False, num_lite_samples=4,
                batch_size=4, optimizer="adam", learning_rate=1e-3, weight_decay=0.0,
                betas=(0.9, 0.999), epsilon=1e-8, momentum=0.0, data_parallel=2,
                episode_prefetch=1)
    base.update(over)
    return SimpleNamespace(**base)


def ft_args(film: bool) -> SimpleNamespace:
    return SimpleNamespace(personalize_num_grad_steps=3, personalize_learning_rate=0.05,
                           personalize_optimizer="adam", personalize_weight_decay=0.1,
                           personalize_extractor_lr_scale=0.5, personalize_epsilon=1e-8,
                           personalize_betas=(0.9, 0.999), personalize_momentum=0.0,
                           batch_size=4 if film else 8)


# ---------------------------------------------------------- the models ----
def vit_recogniser(cls=None, seed: int = 0, **kw):
    from orbit_tpu_torch.models.backbones import vit
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

    vit.VIT_CONFIGS["vit_s_32"] = SMALL_VIT
    cls = cls or SingleStepFewShotRecogniser
    return cls("vit_s_32", batch_size=4, frame_size=SIZE, **kw).init(seed)


def b0_recogniser(seed: int = 0):
    """B0's first two stages with a 64-wide head, proto, its BatchNorm
    statistics calibrated on a task's frames."""
    from orbit_tpu_torch.models.backbones import efficientnet
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

    rec = SingleStepFewShotRecogniser("efficientnet_b0", batch_size=4, frame_size=SIZE)
    rec.extractor = efficientnet.EfficientNet(arch=tuple(efficientnet.B0_ARCH[:2]),
                                              head_chs=DIM)
    rec.output_size = DIM
    rec.init(seed)
    frames = torch.from_numpy(train_task(50)["context_clips"][:, 0])
    efficientnet.calibrate_batchnorm(rec.extractor, rec._maybe_normalize(frames))
    return rec


def grads_of(rec) -> dict:
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in rec.named_parameters() if p.requires_grad}


def params_of(rec) -> dict:
    return {n: p.detach().clone() for n, p in rec.named_parameters()}


# ------------------------------------------------------- the scenarios ----
def _edp(rec, args, mesh):
    from orbit_tpu_torch.parallel import EpisodeDataParallel
    from orbit_tpu_torch.utils.optim import init_optimizer

    rec.train()
    return EpisodeDataParallel(rec, args, init_optimizer(rec, args), mesh)


def _serial_sum(rec, args, lanes, generator=None):
    """The serial loop's summed gradients over padded episode dicts."""
    from orbit_tpu_torch.learners import steps
    from orbit_tpu_torch.parallel.episode_dp import episode_to_device

    rec.train()
    rec.zero_grad(set_to_none=True)
    fn = (steps.build_train_task_lite if args.with_lite else steps.build_train_task)(rec, args)
    losses = [float(fn(episode_to_device(lane, "cpu"), generator)[0]) for lane in lanes]
    return grads_of(rec), losses


def scenario_grads(mesh, lite: bool) -> dict:
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.parallel.episode_dp import stack_group

    args = train_args(with_lite=lite)
    # lanes of different buckets: stack_group re-pads them to common shapes
    batch = stack_group([pad_episode(train_task(1)), pad_episode(train_task(2, n_ctx=20))])
    rec = vit_recogniser()
    out = _edp(rec, args, mesh).batch_grads(batch, torch.Generator().manual_seed(5))
    serial, losses = _serial_sum(vit_recogniser(), args,
                                 [{k: v[i] for k, v in batch.items()} for i in range(2)],
                                 torch.Generator().manual_seed(5))
    return {"dp": grads_of(rec), "serial": serial, "dp_losses": [o[0] for o in out],
            "serial_losses": losses}


def scenario_dummy(mesh) -> dict:
    """A real lane on rank 0, its dummy (target masked out) on rank 1."""
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.parallel.episode_dp import episode_to_device, stack_group

    args = train_args()
    real = pad_episode(train_task(3))
    batch = stack_group([real, real])
    batch["target_mask"][1] = 0.0
    rec = vit_recogniser()
    edp = _edp(rec, args, mesh)
    edp.optimizer.zero_grad(set_to_none=True)
    lane = {k: v[mesh.rank] for k, v in batch.items()}
    out = edp.run_lane(episode_to_device(lane, "cpu"), mesh.rank == 0)
    local_zero = all(p.grad is None or not bool(p.grad.any()) for p in edp.params)
    edp.mesh.all_reduce_grads(edp.params)
    solo, _ = _serial_sum(vit_recogniser(), args, [{k: v[0] for k, v in batch.items()}])
    return {"dp": grads_of(rec), "solo": solo, "losses": [o[0] for o in out],
            "local_zero": local_zero}


def scenario_batchnorm(mesh) -> dict:
    """``--learn_extractor`` on the cut B0: a real lane and its dummy; the
    averaged running statistics against the real lane's serial step."""
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.models.backbones.masked_bn import running_stats
    from orbit_tpu_torch.parallel.episode_dp import stack_group

    args = train_args()
    batch = stack_group([pad_episode(train_task(4))] * 2)
    batch["target_mask"][1] = 0.0
    rec = b0_recogniser()
    before = running_stats(rec.extractor)
    _edp(rec, args, mesh).batch_grads(batch)
    ref = b0_recogniser()
    _serial_sum(ref, args, [{k: v[0] for k, v in batch.items()}])
    return {"dp": running_stats(rec.extractor), "serial": running_stats(ref.extractor),
            "before": before}


def _serial_epoch(args, tasks, windows):
    """The serial loop over padded tasks: gradients summed over each window
    of task indices, scaled by the window's factor, then one update."""
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.learners import steps
    from orbit_tpu_torch.parallel.episode_dp import TRAIN_FIELDS, episode_to_device
    from orbit_tpu_torch.utils.optim import init_optimizer

    rec = vit_recogniser()
    rec.train()
    optimizer = init_optimizer(rec, args)
    fn = steps.build_train_task(rec, args)
    update = steps.build_apply_update(optimizer)
    for idx, scale in windows:
        for i in idx:
            ep = pad_episode(tasks[i])
            fn(episode_to_device({k: getattr(ep, k) for k in TRAIN_FIELDS}, "cpu"))
        for p in rec.parameters():
            if p.grad is not None:
                p.grad.mul_(scale)
        update()
    return params_of(rec)


def scenario_epoch(mesh, n_tasks: int, tasks_per_batch: int, optimizer: str) -> dict:
    # Adam's eps of 1e-3 bounds the update's sensitivity to rounding in a
    # near-zero gradient (lr * error / eps), as tests/test_torch_train.py
    args = train_args(tasks_per_batch=tasks_per_batch, optimizer=optimizer,
                      learning_rate=0.05, epsilon=1e-3)
    tasks = [train_task(10 + i) for i in range(n_tasks)]
    rec = vit_recogniser()
    losses = _edp(rec, args, mesh).train_epoch(iter(tasks))
    if n_tasks > tasks_per_batch:  # one window of every task, overshooting
        windows = [(range(n_tasks), tasks_per_batch / n_tasks)]
    else:  # the final partial window, as it is
        windows = [(range(n_tasks), 1.0)]
    return {"dp": params_of(rec), "serial": _serial_epoch(args, tasks, windows),
            "start": params_of(vit_recogniser()), "losses": losses}


def scenario_query(mesh) -> dict:
    from orbit_tpu_torch.parallel import ShardedQuery

    rec = vit_recogniser()
    ep = eval_episode(20)
    ctx = (torch.from_numpy(ep.context_clips), torch.from_numpy(ep.context_labels).long(),
           torch.from_numpy(ep.context_mask))
    with torch.inference_mode():
        state = rec.personalise(*ctx, ep.num_classes)
        clips = torch.from_numpy(np.concatenate(ep.video_frames)[:13, None])
        class_mask = torch.from_numpy(ep.class_mask)
        return {"sharded": ShardedQuery(rec, mesh).predict(state, clips, class_mask),
                "one": rec.predict(state, clips, class_mask)}


def _ft_ctx(seed: int):
    """7 real context clips padded to 8."""
    task = train_task(seed, n_ctx=7)
    clips = np.concatenate([task["context_clips"], np.zeros_like(task["context_clips"][:1])])
    labels = np.concatenate([task["context_labels"], [0]])
    mask = (np.arange(8) < 7).astype(np.float32)
    return (torch.from_numpy(clips), torch.from_numpy(labels).long(), torch.from_numpy(mask),
            torch.from_numpy((np.arange(16) < 3).astype(np.float32)))


def scenario_finetune(mesh, film: bool) -> dict:
    from orbit_tpu_torch.learners.multi_step import build_finetune_fns
    from orbit_tpu_torch.models.recognisers import MultiStepFewShotRecogniser
    from orbit_tpu_torch.parallel import ShardedFineTune

    args = ft_args(film)
    rec = vit_recogniser(MultiStepFewShotRecogniser, classifier="linear", adapt_features=film)
    ctx = _ft_ctx(30)
    query = torch.from_numpy(train_task(31, n_tgt=13)["target_clips"])
    ft = ShardedFineTune(rec, args, mesh)
    params = ft.personalise(*ctx)
    personalise, predict = build_finetune_fns(rec, args)
    ref = personalise(*ctx)
    leaves = MultiStepFewShotRecogniser.task_leaves
    return {"sharded": [t.detach() for t in leaves(params)],
            "serial": [t.detach() for t in leaves(ref)],
            "sharded_logits": ft.predict(params, query, ctx[3]),
            "serial_logits": predict(ref, query, ctx[3])}


def scenario_lanes(mesh, finetune: bool) -> dict:
    """3 lanes on 2 ranks (rank 0: lanes 0 and 2; rank 1: lane 1)."""
    from orbit_tpu_torch.learners.multi_step import build_finetune_fns
    from orbit_tpu_torch.learners.steps import build_eval_fns
    from orbit_tpu_torch.models.recognisers import MultiStepFewShotRecogniser
    from orbit_tpu_torch.parallel import TaskParallelEval, TaskParallelFineTune
    from orbit_tpu_torch.parallel.task_dp import build_query_block, stack_eval_group

    eps = [eval_episode(40 + i, videos=v) for i, v in enumerate(((5, 8, 3), (8, 2, 6), (4, 6, 1)))]
    qbs = [build_query_block(ep, 1) for ep in eps]
    if finetune:
        args = ft_args(False)
        rec = vit_recogniser(MultiStepFewShotRecogniser, classifier="linear")
        tp = TaskParallelFineTune(rec, args, 3, mesh)
        personalise, predict = build_finetune_fns(rec, args)
    else:
        rec = vit_recogniser()
        tp = TaskParallelEval(rec, 3, mesh)
        personalise, predict = build_eval_fns(rec)
    local = tp.local(stack_eval_group(eps, qbs, 3))
    dev = {k: torch.from_numpy(v).long() if k == "context_labels" else torch.from_numpy(v)
           for k, v in local.items()}
    logits = tp.predict(tp.personalise(dev), dev["query_clips"], dev["class_mask"])
    serial = []
    for ep, qb in zip(eps, qbs):
        ctx = (torch.from_numpy(ep.context_clips), torch.from_numpy(ep.context_labels).long(),
               torch.from_numpy(ep.context_mask), torch.from_numpy(ep.class_mask))
        serial.append(predict(personalise(*ctx), torch.from_numpy(qb.clips), ctx[3]))
    return {"lanes": tp.lanes, "logits": logits, "serial": torch.stack(serial)}


def scenario_jax_weights(mesh, path: str) -> dict:
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.parallel.episode_dp import stack_group

    rec = vit_recogniser()
    rec.load_state_dict(torch.load(path), strict=True)
    batch = stack_group([pad_episode(train_task(60)), pad_episode(train_task(61))])
    _edp(rec, train_args(), mesh).batch_grads(batch)
    return {"dp": grads_of(rec)}


def scenario_cli(mesh, data_root: str, out: str) -> dict:
    """Both CLIs in the group (as under ``torchrun``): the single-step
    learner meta-trains with ``--data_parallel 2`` and tests with its
    queries sharded; the FineTuner shards its rows; only rank 0 writes."""
    import multi_step_learner_torch

    from orbit_tpu_torch.learners.single_step import SingleStepLearner
    from orbit_tpu_torch.utils.args import parse_args

    vit_recogniser()  # the cut ViT config
    common = ["--data_path", data_root, "--feature_extractor", "vit_s_32", "--frame_size",
              "84", "--batch_size", "8", "--context_shot", "2", "--target_shot", "1",
              "--subsample_factor", "4", "--test_target_clip_method", "random",
              "--data_parallel", "2"]
    dirs = {name: os.path.join(out, f"cli_{name}_rank{mesh.rank}")
            for name in ("single", "multi", "multi_lanes")}
    learner = SingleStepLearner(parse_args("single-step-learner", common + [
        "--mode", "train_test", "--classifier", "proto", "--learn_extractor", "--epochs", "1",
        "--num_train_tasks", "1", "--num_val_tasks", "1", "--num_test_tasks", "1",
        "--tasks_per_batch", "2", "--checkpoint_dir", dirs["single"]]), device="cpu")
    learner.run()
    for name, flag in (("multi", "--data_parallel"), ("multi_lanes", "--task_parallel")):
        multi_step_learner_torch.main(common + [
            "--mode", "test", "--classifier", "linear", "--num_test_tasks", "1",
            "--personalize_num_grad_steps", "2", "--personalize_learning_rate", "0.1",
            "--checkpoint_dir", dirs[name], flag, "2"], device="cpu")
    written = {name: sorted(str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file())
               if os.path.isdir(d) else [] for name, d in dirs.items()}
    results = {name: json.loads(next(Path(d).glob("*/results.json")).read_text())
               for name, d in dirs.items() if written[name]}
    # the model of the last test: the best validation checkpoint, which
    # rank 0 wrote and every rank loaded
    return {"written": written, "results": results, "tested": params_of(learner.recogniser)}


def _rank_main(rank: int, port: int, out: str, jax_weights: str, data_root: str) -> None:
    """One rank of the 2-rank gloo group: every scenario, its results saved
    to ``out/rank<rank>.pt``."""
    import torch.distributed as dist

    from orbit_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = make_mesh(2)
        results = {
            "grads": scenario_grads(mesh, lite=False),
            "grads_lite": scenario_grads(mesh, lite=True),
            "dummy": scenario_dummy(mesh),
            "batchnorm": scenario_batchnorm(mesh),
            "overshoot": scenario_epoch(mesh, 4, 3, "sgd"),
            "leftover": scenario_epoch(mesh, 3, 4, "adam"),
            "query": scenario_query(mesh),
            "finetune": scenario_finetune(mesh, film=False),
            "finetune_film": scenario_finetune(mesh, film=True),
            "lanes": scenario_lanes(mesh, finetune=False),
            "lanes_finetune": scenario_lanes(mesh, finetune=True),
            "jax": scenario_jax_weights(mesh, jax_weights),
            "cli": scenario_cli(mesh, data_root, out)}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the group ----
def _jax_model():
    """The JAX recogniser with the cut ViT, and its variables (perturbed:
    Flax inits biases, LayerNorm affines and the class token to 0 and 1)."""
    import jax

    from orbit_tpu.models.backbones.vit import ViT as FlaxViT
    from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser

    rec = JaxRecogniser(feature_extractor_name="vit_s_32", classifier="proto", batch_size=4,
                        learn_extractor=True)
    object.__setattr__(rec, "extractor", FlaxViT(patch_size=32, dim=DIM, depth=1, num_heads=1))
    object.__setattr__(rec, "output_size", DIM)
    variables = rec.init(jax.random.PRNGKey(0), frame_size=SIZE)
    noise = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * noise.standard_normal(a.shape).astype(np.float32),
        variables)
    return rec, variables


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, orbit_fixture_tree):
    """The two ranks' results (spawned once for the module)."""
    from orbit_tpu_torch.models import convert

    out = tmp_path_factory.mktemp("torch_distributed")
    data_root = out / "orbit"
    data_root.mkdir()
    for mode in ("train", "validation", "test"):
        os.symlink(os.path.realpath(orbit_fixture_tree), data_root / mode)
    _, variables = _jax_model()
    weights = str(out / "jax_weights.pt")
    torch.save(convert.from_jax_variables(variables), weights)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_rank_main, args=(r, port, str(out), weights,
                                                      str(data_root)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _close_grads(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    largest = max(float(r.abs().max()) for r in ref.values())
    assert largest > 0
    for name, r in ref.items():
        scale = max(float(r.abs().max()), GRAD_FLOOR * largest)
        np.testing.assert_allclose(ours[name].numpy(), r.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("case", ["grads", "grads_lite"])
def test_episode_dp_grads_match_serial_sum(ranks, case):
    for r in ranks:  # every rank holds the sum
        _close_grads(r[case]["dp"], r[case]["serial"])
        np.testing.assert_allclose(r[case]["dp_losses"], r[case]["serial_losses"], **TOL)


def test_dummy_lane_gives_exactly_zero_gradient(ranks):
    assert ranks[1]["dummy"]["local_zero"]
    assert ranks[0]["dummy"]["losses"][1] == 0.0
    for r in ranks:
        _close_grads(r["dummy"]["dp"], r["dummy"]["solo"])


def test_batchnorm_statistics_exclude_dummy_lanes(ranks):
    for r in ranks:
        res = r["batchnorm"]
        moved = 0
        for path, (mean, var) in res["serial"].items():
            np.testing.assert_allclose(res["dp"][path][0].numpy(), mean.numpy(), **TOL)
            np.testing.assert_allclose(res["dp"][path][1].numpy(), var.numpy(), **TOL)
            moved += not torch.equal(mean, res["before"][path][0])
        assert moved  # the step moved the statistics


@pytest.mark.parametrize("case", ["overshoot", "leftover"])
def test_train_epoch_matches_serial(ranks, case):
    """4 tasks, tasks_per_batch 3 (SGD): one overshooting window scaled to
    its mean; 3 tasks, tasks_per_batch 4 (Adam): the leftover task trains in
    the final partial window."""
    res = ranks[0][case]
    assert len(res["losses"]) == {"overshoot": 4, "leftover": 3}[case]
    moved = 0
    for name, ref in res["serial"].items():
        np.testing.assert_allclose(res["dp"][name].numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        torch.testing.assert_close(ranks[1][case]["dp"][name], res["dp"][name], rtol=0, atol=0)
        moved += not torch.equal(ref, res["start"][name])
    assert moved


def test_query_sharded_logits_match_one_rank(ranks):
    for r in ranks:
        assert r["query"]["sharded"].shape == r["query"]["one"].shape == (13, 16)
        np.testing.assert_allclose(r["query"]["sharded"].numpy(), r["query"]["one"].numpy(),
                                   **TOL)


@pytest.mark.parametrize("case", ["finetune", "finetune_film"])
def test_sharded_finetune_matches_serial(ranks, case):
    for r in ranks:
        res = r[case]
        for a, b in zip(res["sharded"], res["serial"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        assert float(res["serial"][0].abs().max()) > 0
        np.testing.assert_allclose(res["sharded_logits"].numpy(), res["serial_logits"].numpy(),
                                   **TOL)


@pytest.mark.parametrize("case", ["lanes", "lanes_finetune"])
def test_task_lanes_across_ranks_match_serial(ranks, case):
    assert ranks[0][case]["lanes"] == [0, 2] and ranks[1][case]["lanes"] == [1]
    for r in ranks:
        np.testing.assert_allclose(r[case]["logits"].numpy(), r[case]["serial"].numpy(), **TOL)


def test_episode_dp_matches_jax(ranks):
    """The port's 2-rank summed gradient against the JAX
    ``EpisodeDataParallel`` on a 2-device CPU mesh, same weights, tasks and
    steps (non-LITE, the extractor learned)."""
    import jax

    from orbit_tpu.parallel import EpisodeDataParallel as JaxEpisodeDataParallel
    from orbit_tpu.parallel import make_mesh as jax_make_mesh
    from orbit_tpu.utils.optim import init_optimizer as jax_init_optimizer
    from orbit_tpu_torch.data.episodes import pad_episode
    from orbit_tpu_torch.models import convert
    from orbit_tpu_torch.parallel.episode_dp import stack_group

    rec, variables = _jax_model()
    args = train_args()
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    tx, _ = jax_init_optimizer(params, args)
    edp = JaxEpisodeDataParallel(rec, args, tx, mesh=jax_make_mesh(2))
    batch = stack_group([pad_episode(train_task(60)), pad_episode(train_task(61))])
    grads, _, _, _ = edp.batch_grads(params, rest, batch,
                                     jax.random.split(jax.random.PRNGKey(0), 2))
    ref = convert.from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, grads)})
    for r in ranks:
        _close_grads(r["jax"]["dp"], ref)


def test_clis_under_a_group_write_on_rank_0_only(ranks):
    """In the group: the single-step learner's train_test with
    ``--data_parallel 2``, the FineTuner's test with ``--data_parallel 2``
    and with ``--task_parallel 2``; rank 0 writes the log, the checkpoints
    and results.json, rank 1 nothing; both ranks test the same trained
    parameters (rank 0's checkpoint)."""
    r0, r1 = ranks[0]["cli"], ranks[1]["cli"]
    assert r1["written"] == {"single": [], "multi": [], "multi_lanes": []}
    for name in ("single", "multi", "multi_lanes"):
        files = {Path(f).name for f in r0["written"][name]}
        assert {"log.txt", "results.json"} <= files, files
    # the FineTuner's rows sharded, or its tasks one a rank: the serial results
    assert r0["results"]["multi"] == r0["results"]["multi_lanes"]
    assert {"final.ckpt", "best.ckpt", "checkpoint.ckpt"} <= {
        Path(f).name for f in r0["written"]["single"]}
    for k, v in r0["tested"].items():
        assert torch.equal(v, r1["tested"][k]), k
