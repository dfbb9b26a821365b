"""The port's entry points (``graft_entry_torch.py``, the
counterpart of ``__graft_entry__.py``) on the CPU, with no JAX: the
flagship forward against the golden file's record of the JAX package's
``__graft_entry__.entry`` forward, and the multi-rank dry run in a two-rank
gloo group.

- ``entry(device="cpu", state_dict=<the fake B0>)``: the (16, 16) logits
  against ``data/golden_torch``'s flagship record, within 2e-4 of their
  largest magnitude over the 5 real classes, the argmax equal on all 16
  frames; ``entry()`` with no card raises.
- importing ``graft_entry_torch`` and the golden replay loads no JAX, Flax
  or PIL and nothing of the JAX package;
- ``dryrun_multichip(2, device="cpu")`` spawns its two ranks once for the
  module; one case a check: (1) the episode-DP steps' losses (non-LITE,
  LITE, uint8 pixels), finite, equal on both ranks and equal to the serial
  port's losses of the same tasks within rtol = atol = 2e-4 (the serial
  loop sums the same gradients and takes the same Adam updates); (2) the
  query-sharded logits against one rank's; (3) the ViT gradient under the
  group: no kernel launched and the plain versions' bits; (4)-(6) the
  row-sharded FineTuner's and the task lanes' logits, finite and equal on
  both ranks.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graft_entry_torch as ge
from orbit_tpu_torch.models import golden

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops (as in
    tests/test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_matches_golden_flagship():
    manifest, arrays = golden.load()
    record = golden.RECORD["flagship_efficientnet_b0"]
    fn, args = ge.entry(device="cpu", state_dict=golden.extractor_state_dict(record, arrays))
    ep = ge.flagship_episode()
    for got, (key, want) in zip(args[1:], ep.items()):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
        assert golden.digest(want) == manifest["records"][record.name]["inputs"][key]["sha256"]
    logits = fn(*args)
    assert logits.shape == (16, 16) and logits.dtype == torch.float32
    real = ep["class_mask"] > 0
    got = logits.numpy()[:, real]
    want = golden.outputs_of(arrays, record)["logits"][:, real]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_entry_point_imports_no_jax():
    code = ("import sys\n"
            "import graft_entry_torch, orbit_tpu_torch.models.golden\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'PIL', 'optax')\n"
            "       or m == 'orbit_tpu' or m.startswith('orbit_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(ge.__file__).parent, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.dryrun_multichip(1)


@pytest.fixture(scope="module")
def dryrun():
    return ge.dryrun_multichip(2, device="cpu")


def serial_losses() -> dict:
    """The dry run's three training steps through the serial loop on one
    process: each step's task losses, the tasks' gradients summed into one
    Adam update, as the ranks' all-reduce does."""
    from orbit_tpu_torch.learners import steps
    from orbit_tpu_torch.parallel.episode_dp import episode_to_device
    from orbit_tpu_torch.utils.optim import init_optimizer

    eps, wire = ge.dry_run_tasks(2)
    rec = ge._flagship(ge.DRY_FRAME_SIZE, "cpu", adapt_features=True, batch_size=8).train()
    optimizer = init_optimizer(rec, ge.train_args(2))
    update = steps.build_apply_update(optimizer)

    def step(fn, tasks, generator=None):
        optimizer.zero_grad(set_to_none=True)
        losses = [float(fn(episode_to_device(t, "cpu"), generator)[0]) for t in tasks]
        update()
        return losses

    plain = steps.build_train_task(rec, ge.train_args(2))
    return {"losses": step(plain, eps),
            "lite_losses": step(steps.build_train_task_lite(rec, ge.train_args(2, lite=True)),
                                eps, torch.Generator().manual_seed(0)),
            "wire_losses": step(plain, wire)}


def _same_on_both_ranks(ranks, key):
    for r in ranks[1:]:
        torch.testing.assert_close(r[key], ranks[0][key], rtol=0, atol=0)


@pytest.mark.parametrize("check", ["train", "query", "vit", "finetune", "task_eval",
                                   "task_finetune"])
def test_dryrun_multichip_on_two_gloo_ranks(dryrun, check):
    ranks = dryrun["ranks"]
    assert dryrun["backend"] == "gloo" and not dryrun["kernels"] and len(ranks) == 2
    assert dryrun["line"].startswith("dryrun_multichip(2): ok — ")
    assert "gloo, 2 rank(s); the plain versions" in dryrun["line"]
    assert all(not r["launches"][check] for r in ranks)  # the CPU launches no kernel
    if check == "train":
        serial = serial_losses()
        for key in ("losses", "lite_losses", "wire_losses"):
            _same_on_both_ranks(ranks, key)
            ours = ranks[0][key].numpy()
            assert ours.shape == (2,) and np.isfinite(ours).all()
            np.testing.assert_allclose(ours, serial[key], **TOL, err_msg=key)
    elif check == "query":
        for r in ranks:
            assert r["query_logits"].shape == (8, 3)
            np.testing.assert_allclose(r["query_logits"].numpy(), r["query_one"].numpy(), **TOL)
    elif check == "vit":
        assert all(r["vit_worst_vs_plain"] == 0.0 for r in ranks)
    else:
        key, shape = {"finetune": ("finetune_logits", (8, 3)),
                      "task_eval": ("task_logits", (2, 16, 3)),
                      "task_finetune": ("task_finetune_logits", (2, 16, 3))}[check]
        assert ranks[0][key].shape == shape
        _same_on_both_ranks(ranks, key)
