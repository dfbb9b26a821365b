"""Entry points of the PyTorch port: the flagship forward and the
multi-rank dry run (counterpart of ``__graft_entry__.py``, the JAX
package's).

``entry()`` returns the flagship CLU-VE forward: ProtoNets on
EfficientNet-B0, f32, 224 px, one personalise-then-predict pass over a
16 + 16-frame episode with 16 class slots (5 real), as ``fn(*example_args)``.
On the card each forward runs #8 (the fused depthwise tail) in B0's 12
stride-1 tails.

``dryrun_multichip(n)`` spawns ``n`` ranks, one process and one GPU each
over NCCL (or, with ``device="cpu"``, gloo ranks on the plain versions),
and runs the JAX dry run's six checks at its tiny shapes (32 px, batch 8,
3-way, 8 + 8 clips) through ``orbit_tpu_torch/parallel/``: an episode-DP
training step of B0 with FiLM and the extractor learned (then a LITE
step and a step on uint8 pixels), query sharding, a tiny ViT's gradient
under the group through kernels A, B, #4 and #6, FineTuner row sharding,
and task lanes for both learners. Rank 0 prints one line; a failing
check makes its rank, and so the call, fail.

    python3 graft_entry_torch.py          # the card(s): every visible GPU a rank
    python3 graft_entry_torch.py --cpu    # the CPU: the plain versions, two gloo ranks

The weights are random (``init(seed=0)``), or, for ``entry``, a timm-layout
state dict through the port's converter.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

FRAME_SIZE = 224
DRY_FRAME_SIZE = 32
RANK_TIMEOUT_S = 600


def _flagship(frame_size: int, device, adapt_features: bool = False, batch_size: int = 256):
    """The flagship recogniser (``__graft_entry__._flagship``): ProtoNets on
    EfficientNet-B0, clip length 1, f32, weights from ``init(seed=0)``."""
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

    return SingleStepFewShotRecogniser(
        "efficientnet_b0", adapt_features=adapt_features, classifier="proto", clip_length=1,
        batch_size=batch_size, dtype=torch.float32, frame_size=frame_size).to(device).init(0)


def _episode(rng, n_ctx, n_tgt, way, frame_size, clip_length=1):
    """A padded episode of standard-normal (already normalised) frames, 16
    class slots; a copy of ``__graft_entry__._episode``, so both packages'
    entry points see the same inputs bit for bit."""
    return {
        "context_clips": rng.standard_normal(
            (n_ctx, clip_length, frame_size, frame_size, 3)).astype(np.float32),
        "context_labels": (np.arange(n_ctx) % way).astype(np.int32),
        "context_mask": np.ones((n_ctx,), np.float32),
        "class_mask": (np.arange(16) < way).astype(np.float32),
        "target_clips": rng.standard_normal(
            (n_tgt, clip_length, frame_size, frame_size, 3)).astype(np.float32),
        "target_labels": (np.arange(n_tgt) % way).astype(np.int32),
        "target_mask": np.ones((n_tgt,), np.float32),
    }


ENTRY_INPUTS = ("context_clips", "context_labels", "context_mask", "class_mask",
                "target_clips")


def flagship_episode() -> dict:
    """``entry()``'s inputs as numpy arrays (``ENTRY_INPUTS``)."""
    ep = _episode(np.random.default_rng(0), n_ctx=16, n_tgt=16, way=5, frame_size=FRAME_SIZE)
    return {k: ep[k] for k in ENTRY_INPUTS}


def _forward(recogniser, context_clips, context_labels, context_mask, class_mask,
             target_clips):
    with torch.inference_mode():
        task_state = recogniser.personalise(context_clips, context_labels, context_mask,
                                            class_mask.shape[0])
        return recogniser.predict(task_state, target_clips, class_mask=class_mask)


def entry(device=None, state_dict=None):
    """(fn, example_args): the flagship CLU-VE forward, ``fn(*example_args)``
    -> (16, 16) f32 logits, personalised and predicted with no gradient.
    ``example_args[0]`` is the recogniser (the JAX entry's variables), the
    rest the episode's tensors on ``device``. ``device``: the card unless
    the caller names one; with no GPU it raises. ``state_dict``: a timm-layout
    EfficientNet-B0 state dict (numpy) loaded through the port's converter
    in place of the random weights."""
    from orbit_tpu_torch.learners.single_step import select_device
    from orbit_tpu_torch.models import convert

    dev = select_device(None, device)
    recogniser = _flagship(FRAME_SIZE, dev)
    if state_dict is not None:
        convert.load_upstream_extractor(recogniser, state_dict)
    ep = flagship_episode()
    ep["context_labels"] = ep["context_labels"].astype(np.int64)
    return _forward, (recogniser, *(torch.from_numpy(ep[k]).to(dev) for k in ENTRY_INPUTS))


# ---------------------------------------------------------------- dry run ----
def _wire_episode(rng, n_ctx, n_tgt, way, frame_size):
    """``_episode``'s task with its clips as uint8 pixels, the loader's wire
    format, which the recogniser normalises on the device."""
    ep = _episode(rng, n_ctx, n_tgt, way, frame_size)
    for key in ("context_clips", "target_clips"):
        ep[key] = np.clip(ep[key] * 40.0 + 128.0, 0, 255).astype(np.uint8)
    return ep


def _stack(eps) -> dict:
    return {k: np.stack([e[k] for e in eps]) for k in eps[0]}


def train_args(n: int, lite: bool = False) -> SimpleNamespace:
    """The dry run's meta-training flags (``__graft_entry__._dryrun_body``)."""
    return SimpleNamespace(tasks_per_batch=n, learn_extractor=True, with_lite=lite,
                           num_lite_samples=4, batch_size=8, data_parallel=n,
                           optimizer="adam", learning_rate=1e-4, weight_decay=0.0,
                           betas=(0.9, 0.999), epsilon=1e-8, momentum=0.0,
                           episode_prefetch=1)


def finetune_args(n: int) -> SimpleNamespace:
    return SimpleNamespace(personalize_num_grad_steps=2, batch_size=8,
                           personalize_optimizer="adam", personalize_learning_rate=0.01,
                           personalize_weight_decay=0.0, personalize_extractor_lr_scale=1.0,
                           personalize_epsilon=1e-8, personalize_betas=(0.9, 0.999),
                           personalize_momentum=0.0, data_parallel=n)


def dry_run_tasks(n: int):
    """The dry run's tasks: ``n`` float episodes (the train steps, then the
    eval checks) and ``n`` uint8 ones (the wire-format step), drawn in
    order from one generator."""
    rng = np.random.default_rng(0)
    eps = [_episode(rng, n_ctx=8, n_tgt=8, way=3, frame_size=DRY_FRAME_SIZE)
           for _ in range(n)]
    wire = [_wire_episode(rng, n_ctx=8, n_tgt=8, way=3, frame_size=DRY_FRAME_SIZE)
            for _ in range(n)]
    return eps, wire


def _finite(t: torch.Tensor, what: str) -> torch.Tensor:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"non-finite {what} in the dry run")
    return t.detach().float().cpu()


def _launched(device) -> dict:
    from orbit_tpu_torch.kernels import build as kbuild

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    kbuild.reset_launch_counts()
    return counts


VIT_KERNELS = ("fused_qkv_attention", "fused_mlp_block", "fused_qkv_attention_bwd",
               "fused_mlp_block_bwd")


def _vit_check(mesh, device) -> dict:
    """A depth-1, width-64 ViT (one 64-wide head: the kernels' head width)
    over 64 px frames, its squared-feature loss's gradient over the rows
    sharded on the ranks and summed over them: on the card kernels A, B, #4
    and #6 must each launch, and the gradient agree with the plain
    versions' to 1e-4 of its largest value; on the CPU no kernel launches
    and the gradient is the plain versions' bit for bit."""
    from orbit_tpu_torch.models.backbones.vit import ViT

    vit = ViT(patch_size=32, dim=64, depth=1, num_heads=1, frame_size=64)
    vit.reset_parameters(torch.Generator().manual_seed(0))
    vit.to(device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2 * mesh.size, 64, 64, 3)).astype(np.float32)).to(device)
    (local,) = mesh.local_rows(x)

    def grads(impl):
        vit.impl = impl
        vit.zero_grad(set_to_none=True)
        (vit(local) ** 2).mean().backward()
        params = list(vit.parameters())
        mesh.all_reduce_grads(params)
        return [_finite(p.grad, "ViT gradient") for p in params]

    _launched(device)
    ours = grads(None)
    launches = _launched(device)
    plain = grads("reference")
    largest = max(float(g.abs().max()) for g in plain)
    worst = max(float((a - b).abs().max()) for a, b in zip(ours, plain)) / largest
    if device.type == "cuda":
        missing = [k for k in VIT_KERNELS if not launches.get(k)]
        if missing:
            raise AssertionError(f"ViT gradient under the group launched no {missing}")
        if worst > 1e-4:
            raise AssertionError(f"ViT gradient through the kernels differs from the plain "
                                 f"versions' by {worst:.3e} of its largest value")
    elif launches or worst != 0.0:
        raise AssertionError(f"ViT gradient on the CPU: launches {launches}, "
                             f"{worst:.3e} off the plain versions")
    return {"launches": launches, "worst_vs_plain": worst}


def _dryrun_body(n: int, device: torch.device) -> dict:
    """The six checks on this rank (``__graft_entry__._dryrun_body``)."""
    from orbit_tpu_torch.data.episodes import Episode, pad_rows
    from orbit_tpu_torch.models.recognisers import MultiStepFewShotRecogniser
    from orbit_tpu_torch.parallel import (EpisodeDataParallel, ShardedFineTune, ShardedQuery,
                                          TaskParallelEval, TaskParallelFineTune, make_mesh)
    from orbit_tpu_torch.parallel.task_dp import build_query_block, stack_eval_group
    from orbit_tpu_torch.utils.optim import init_optimizer

    mesh = make_mesh(n)
    eps, wire = dry_run_tasks(n)
    launches = {}
    _launched(device)

    # 1. episode-DP meta-training: set encoder -> FiLM -> adapted backbone
    # -> proto head -> CE -> summed gradients -> Adam; then a LITE step
    # and a step on uint8 pixels, each updating the same weights
    rec = _flagship(DRY_FRAME_SIZE, device, adapt_features=True, batch_size=8).train()
    optimizer = init_optimizer(rec, train_args(n))
    edp = EpisodeDataParallel(rec, train_args(n), optimizer, mesh)
    losses = [loss for loss, _ in edp.batch_grads(_stack(eps))]
    edp.apply_update()
    lite = EpisodeDataParallel(rec, train_args(n, lite=True), optimizer, mesh)
    lite_losses = [loss for loss, _ in lite.batch_grads(_stack(eps),
                                                          torch.Generator().manual_seed(0))]
    lite.apply_update()
    wire_losses = [loss for loss, _ in edp.batch_grads(_stack(wire))]
    edp.apply_update()
    for name, values in (("loss", losses), ("LITE loss", lite_losses),
                         ("uint8 loss", wire_losses)):
        _finite(torch.tensor(values), name)
    launches["train"] = _launched(device)

    # 2. query sharding: one task's query frames split over the ranks
    rec.eval()
    ep0 = {k: torch.from_numpy(v).to(device) for k, v in eps[0].items()}
    ep0["context_labels"] = ep0["context_labels"].long()
    with torch.inference_mode():
        state = rec.personalise(ep0["context_clips"], ep0["context_labels"],
                                ep0["context_mask"], 16)
        one = rec.predict(state, ep0["target_clips"], class_mask=ep0["class_mask"])
    _launched(device)
    sharded = ShardedQuery(rec, mesh).predict(state, ep0["target_clips"], ep0["class_mask"])
    launches["query"] = _launched(device)
    sharded = _finite(sharded[:, :3], "sharded-query logits")

    # 3. the ViT kernels forward and backward under the group
    vit = _vit_check(mesh, device)
    launches["vit"] = vit["launches"]

    # 4. FineTuner row sharding: B0, linear head, 2 Adam steps
    ft_args = finetune_args(n)
    ft_rec = MultiStepFewShotRecogniser("efficientnet_b0", classifier="linear", batch_size=8,
                                        frame_size=DRY_FRAME_SIZE).to(device).init(1)
    ft = ShardedFineTune(ft_rec, ft_args, mesh)
    ft_params = ft.personalise(ep0["context_clips"], ep0["context_labels"],
                               ep0["context_mask"], ep0["class_mask"])
    ft_logits = _finite(ft.predict(ft_params, ep0["target_clips"], ep0["class_mask"])[:, :3],
                        "FineTuner row-sharded logits")
    launches["finetune"] = _launched(device)

    # 5. task lanes of the single-step protocol, one lane a rank
    test_eps = [Episode(context_clips=e["context_clips"], context_labels=e["context_labels"],
                        context_mask=e["context_mask"], num_classes=16,
                        class_mask=e["class_mask"], way=3,
                        video_frames=[pad_rows(e["target_clips"][:5, 0], 8),
                                      pad_rows(e["target_clips"][5:8, 0], 8)],
                        video_masks=[pad_rows(np.ones(5, np.float32), 8),
                                     pad_rows(np.ones(3, np.float32), 8)],
                        video_labels=[0, 1], video_paths=[None, None]) for e in eps]
    blocks = [build_query_block(e, clip_length=1) for e in test_eps]
    tpe = TaskParallelEval(rec, n, mesh)
    group = {k: torch.from_numpy(v).to(device)
             for k, v in tpe.local(stack_eval_group(test_eps, blocks, n)).items()}
    group["context_labels"] = group["context_labels"].long()
    task_logits = _finite(tpe.predict(tpe.personalise(group), group["query_clips"],
                                      group["class_mask"])[..., :3], "task-DP logits")
    launches["task_eval"] = _launched(device)

    # 6. task lanes of the FineTuner, each lane its own inner loop
    tpf = TaskParallelFineTune(ft_rec, ft_args, n, mesh)
    task_ft_logits = _finite(tpf.predict(tpf.personalise(group), group["query_clips"],
                                         group["class_mask"])[..., :3],
                             "FineTuner task-DP logits")
    launches["task_finetune"] = _launched(device)

    on_card = device.type == "cuda"
    total = {}
    for counts in launches.values():
        for name, count in counts.items():
            total[name] = total.get(name, 0) + count
    route = ("launches: " + ", ".join(f"{k} {v}" for k, v in sorted(total.items()))
             if on_card else "the plain versions (CPU), no kernel launched")
    line = (f"dryrun_multichip({n}): ok — "
            f"losses={np.round(losses, 4).tolist()}, "
            f"LITE losses={np.round(lite_losses, 4).tolist()}, "
            f"uint8-wire losses={np.round(wire_losses, 4).tolist()}, "
            f"sharded-query logits {tuple(sharded.shape)} finite, "
            f"ViT A/B/#4/#6 fwd+bwd under the group ok, "
            f"finetune-DP logits {tuple(ft_logits.shape)} finite, "
            f"task-DP logits {tuple(task_logits.shape)} finite, "
            f"FineTuner task-DP logits {tuple(task_ft_logits.shape)} finite "
            f"[{'nccl' if on_card else 'gloo'}, {n} rank(s); {route}]")
    return {"line": line, "losses": torch.tensor(losses), "lite_losses": torch.tensor(lite_losses),
            "wire_losses": torch.tensor(wire_losses), "query_logits": sharded,
            "query_one": one[:, :3].float().cpu(), "vit_worst_vs_plain": vit["worst_vs_plain"],
            "finetune_logits": ft_logits, "task_logits": task_logits,
            "task_finetune_logits": task_ft_logits, "launches": launches}


def _rank(rank: int, n: int, port: int, out: str, on_card: bool) -> None:
    """One rank of the dry run: its checks, saved to ``out/rank<rank>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    device = torch.device(f"cuda:{rank}" if on_card else "cpu")
    if on_card:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n)
    try:
        result = _dryrun_body(n, device)
        if rank == 0:
            print(result["line"], flush=True)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run over ``n_devices`` ranks (module docstring): on the
    cards with NCCL, one GPU a rank (it raises when fewer are visible, and
    with no GPU), or with ``device="cpu"`` over gloo. Returns ``{"backend",
    "kernels", "line", "ranks"}``, ``ranks`` each rank's losses, logits and
    launch counts by check. A rank that fails makes it raise."""
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the dry run runs on the GPUs (pass "
                               "device='cpu' for gloo ranks on the plain versions)")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n_devices}) needs one GPU a rank (NCCL "
                             f"refuses two ranks on one device); "
                             f"{torch.cuda.device_count()} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as out:
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, n_devices, port, out, on_card))
                 for r in range(n_devices)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=RANK_TIMEOUT_S)
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS")
            else:
                os.environ["OMP_NUM_THREADS"] = saved
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {codes}")
        ranks = [torch.load(Path(out) / f"rank{r}.pt", weights_only=True)
                 for r in range(n_devices)]
    return {"backend": "nccl" if on_card else "gloo", "kernels": on_card,
            "line": ranks[0]["line"], "ranks": ranks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU: the plain versions, two gloo ranks")
    opts = parser.parse_args(argv)
    device = "cpu" if opts.cpu else None
    fn, example_args = entry(device)
    print("entry forward:", tuple(fn(*example_args).shape))
    dryrun_multichip(2 if opts.cpu else torch.cuda.device_count(), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
