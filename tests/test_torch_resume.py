"""``--resume_from`` of a JAX train state, held against the JAX package.

Each case writes the JAX learner's ``checkpoint.ckpt`` with the JAX
package's own optimiser (``orbit_tpu.utils.optim.init_optimizer``), its
jitted ``tx.update`` (``orbit_tpu.learners.steps.build_apply_update``) and
``save_checkpoint``, after one update under seeded gradients. The port
resumes from the file (``utils/checkpoint.py::load_train_state``) into its
own optimiser and takes update 2 under the same gradients as the JAX
chain's update 2. The recogniser is the cut B0 of
tests/test_torch_film_train.py with the set encoder and FiLM generator
(SimpleCNAPs), its weights drawn by the port and carried to the JAX side
by name, its running statistics drawn away from their initial values.

- Adam with ``--weight_decay 0.2`` and ``--extractor_lr_scale 0.1`` under
  ``--learn_extractor``: the chain's four links (decay, Adam, the masked
  extractor scale, the learning rate); the running statistics
  (``batch_stats``) restored bit for bit.
- SGD with momentum 0.9: the trace as torch's momentum buffer (three links).
- A frozen extractor under Adam with weight decay: the JAX chain decays it
  in both updates, the port keeps the file's bits (a known difference).
- Refused trees, each error naming the leaf: a missing ``mu``, an Adam
  state given to SGD, a moment of another shape.
- The CLI in ``--mode train`` resuming a JAX file at epoch 1 of 2.

Tolerance: each moment and each parameter after update 2 within 1e-6 of
its tensor's largest value; the step count exactly. The moments read
1.2e-7 (measured): optax and torch round them in another order. A
parameter that starts at zero (a bias) holds two updates only, and those
carry the JAX chain's f32 bias correction: optax computes 1 - 0.999^2 in
f32, 0.001999 rounded by up to 1.5e-5 of itself, where torch computes it
in f64, so such a tensor reads 5.2e-6 of its largest value (measured).
As in the repo's gradient checks, a parameter's scale therefore has a
floor: 1e-1 of the model's largest parameter value (0.11 here; such a
bias then reads 1.8e-7). An update is 2e-3 (the learning rate), so a
wrong step count, a swapped moment or a missing extractor scale, which
move an update by a large part of itself, still read hundreds of times
the tolerance.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from orbit_tpu.learners import steps as jax_steps
from orbit_tpu.utils import checkpoint as jax_checkpoint
from orbit_tpu.utils import optim as jax_optim
from orbit_tpu_torch.learners import steps
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones import efficientnet
from orbit_tpu_torch.utils import checkpoint, optim
from tests.test_torch_film_train import ARCH, HEAD, SPEC
from tests.test_torch_learn_extractor import _port
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6
LR = 2e-3
BEST = {"frame_acc": [0.25, 0.125]}


def _recogniser(frozen: bool, seed: int = 0):
    """The cut B0 SimpleCNAPs recogniser, every BatchNorm's statistics drawn
    away from the identity; its extractor frozen as the learner freezes it."""
    r = _port(None, "mahalanobis").init(seed)
    rng = np.random.default_rng(5 + seed)
    with torch.no_grad():
        for key, value in r.state_dict().items():
            if key.endswith((".mean", ".var")):
                noise = torch.from_numpy(rng.standard_normal(value.shape).astype(np.float32))
                value.copy_(0.3 * noise if key.endswith(".mean") else 1.0 + 0.5 * noise.abs())
    r.extractor.requires_grad_(not frozen)
    return r


def _gradients(r, seed: int, frozen: bool):
    """Seeded gradients by the port's parameter names; a frozen extractor's
    are zero, as the JAX step returns them."""
    rng = np.random.default_rng(seed)
    return {n: torch.zeros_like(p) if frozen and n.startswith("extractor.") else
            torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            for n, p in r.named_parameters()}


def _jax_tree(tensors):
    return jax.tree_util.tree_map(np.asarray, convert.to_jax_variables(tensors)["params"])


def _args(optimizer: str, **kw):
    base = dict(optimizer=optimizer, learning_rate=LR, weight_decay=0.0, momentum=0.0,
                betas=(0.9, 0.999), epsilon=1e-8)
    return SimpleNamespace(**{**base, **kw})


def _jax_run(r, args, scale: float, grads, path: str):
    """The JAX chain's update 1 (written with its variables to ``path``) and
    update 2; returns (params, opt_state as the file lays it out) after
    update 2 and the variables in the file."""
    variables = jax.tree_util.tree_map(np.asarray, convert.to_jax_variables(r.state_dict()))
    tx, opt_state = jax_optim.init_optimizer(variables["params"], args,
                                             extractor_lr_scale=scale)
    opt_state = jax_optim.set_learning_rate(opt_state, LR)
    apply = jax_steps.build_apply_update(tx)
    params, opt_state = apply(variables["params"], opt_state, _jax_tree(grads[0]))
    saved = {**variables, "params": jax.tree_util.tree_map(np.asarray, params)}
    jax_checkpoint.save_checkpoint(path, {"epoch": 1, "variables": saved,
                                          "opt_state": opt_state, "best_stats": BEST})
    params, opt_state = apply(params, opt_state, _jax_tree(grads[1]))
    return (jax.tree_util.tree_map(np.asarray, params),
            serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, opt_state)), saved)


def _port_resume(r, args, scale: float, grad, path: str):
    """The port resumed from ``path``, then its update 2 through the
    learner's ``apply_update``."""
    opt = optim.init_optimizer(r, args, extractor_lr_scale=scale)
    optim.set_learning_rate(opt, LR)
    out = checkpoint.load_train_state(path, r, opt)
    assert out == {"epoch": 1, "best_stats": BEST}
    for n, p in r.named_parameters():
        if p.requires_grad:
            p.grad = grad[n].clone()
    steps.build_apply_update(opt)()
    return opt


def _by_name(r, tree):
    """A JAX params tree as the port's parameter names."""
    return convert.from_jax_variables({"params": tree},
                                      expected={n for n, _ in r.named_parameters()})


def _close(ours: torch.Tensor, ref: torch.Tensor, what: str, floor: float = 1e-30):
    scale = max(float(ref.abs().max()), floor)
    err = float((ours.detach() - ref).abs().max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of its scale"


def _close_params(r, j_params, skip=()):
    """Every parameter against JAX's, its scale at least 1e-1 of the
    model's largest parameter value."""
    floor = 1e-1 * max(float(v.abs().max()) for v in j_params.values())
    for n, p in r.named_parameters():
        if n not in skip:
            _close(p, j_params[n], n, floor)


def _run_case(tmp_path, optimizer: str, frozen: bool, scale: float, **kw):
    r = _recogniser(frozen)
    args = _args(optimizer, **kw)
    grads = [_gradients(r, s, frozen) for s in (11, 12)]
    path = str(tmp_path / "checkpoint.ckpt")
    j_params, j_state, saved = _jax_run(r, args, scale, grads, path)
    r = _recogniser(frozen, seed=1)  # other weights and statistics: all it has is the file
    opt = _port_resume(r, args, scale, grads[1], path)
    return r, opt, _by_name(r, j_params), j_state, saved


def test_adam_decay_and_extractor_scale_resume_as_jax(tmp_path):
    r, opt, j_params, j_state, saved = _run_case(
        tmp_path, "adam", frozen=False, scale=0.1, weight_decay=0.2)
    names = dict(r.named_parameters())
    assert any(n.startswith("extractor.") for n in names) and any(
        n.startswith("set_encoder.") for n in names)
    _close_params(r, j_params)
    chain = j_state["inner_state"]
    assert sorted(chain) == ["0", "1", "2", "3"]  # decay, Adam, extractor scale, lr
    mu, nu = _by_name(r, chain["1"]["mu"]), _by_name(r, chain["1"]["nu"])
    for n, p in names.items():
        s = opt.state[p]
        assert float(s["step"]) == int(chain["1"]["count"]) == 2
        _close(s["exp_avg"], mu[n], f"{n} exp_avg")
        _close(s["exp_avg_sq"], nu[n], f"{n} exp_avg_sq")
    # the running statistics are the file's, bit for bit
    stats = convert.from_jax_variables(saved, expected=set(r.state_dict()))
    buffers = {k: b for k, b in r.named_buffers() if k.endswith((".mean", ".var"))}
    assert buffers and all(torch.equal(b, stats[k]) for k, b in buffers.items())


def test_sgd_momentum_resumes_as_jax(tmp_path):
    r, opt, j_params, j_state, _ = _run_case(tmp_path, "sgd", frozen=False, scale=1.0,
                                             momentum=0.9)
    chain = j_state["inner_state"]
    assert sorted(chain) == ["0", "1", "2"]  # identity, trace, lr
    trace = _by_name(r, chain["1"]["trace"])
    _close_params(r, j_params)
    for n, p in r.named_parameters():
        _close(opt.state[p]["momentum_buffer"], trace[n], f"{n} momentum_buffer")


def test_frozen_extractor_keeps_the_file_bits(tmp_path):
    r, opt, j_params, _, saved = _run_case(tmp_path, "adam", frozen=True, scale=1.0,
                                           weight_decay=0.2)
    in_file = convert.from_jax_variables(saved, expected=set(r.state_dict()))
    frozen = [n for n, _ in r.named_parameters() if n.startswith("extractor.")]
    _close_params(r, j_params, skip=frozen)
    moved = 0
    for n, p in r.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), in_file[n]), n
            assert not opt.state.get(p), n  # no optimiser state for a frozen parameter
            moved += not torch.equal(j_params[n], in_file[n])
    assert moved  # the JAX chain decays the frozen extractor; the port does not


def _drop_mu(tree):
    del tree["opt_state"]["inner_state"]["1"]["mu"]


def _grow_nu(tree):
    """One of the set encoder's ``nu`` leaves given a leading axis."""
    node = tree["opt_state"]["inner_state"]["1"]["nu"]["set_encoder"]
    while True:
        key = sorted(node)[0]
        if not isinstance(node[key], dict):
            node[key] = np.zeros((1,) + np.shape(node[key]), np.float32)
            return
        node = node[key]


@pytest.mark.parametrize("fault,optimizer,match", [
    ("missing_mu", "adam", r"opt_state/inner_state/1/mu"),
    ("adam_into_sgd", "sgd", r"opt_state/inner_state/1/(count|mu|nu)"),
    ("shape", "adam", r"opt_state/inner_state/1/nu: shapes differ.*set_encoder"),
], ids=["missing_mu", "adam_into_sgd", "shape"])
def test_unexplained_tree_is_refused(tmp_path, fault, optimizer, match):
    """A tree the optimiser's settings do not explain: a ValueError naming
    the leaf, and nothing loaded."""
    r = _recogniser(False)
    grads = [_gradients(r, s, False) for s in (11, 12)]
    path = str(tmp_path / "checkpoint.ckpt")
    _jax_run(r, _args("adam"), 1.0, grads, path)
    if fault != "adam_into_sgd":
        tree = checkpoint.load_checkpoint(path)
        (_drop_mu if fault == "missing_mu" else _grow_nu)(tree)
        checkpoint.save_checkpoint(path, tree)
    fresh = _recogniser(False, seed=1)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    opt = optim.init_optimizer(fresh, _args(optimizer, momentum=0.9), extractor_lr_scale=1.0)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_train_state(path, fresh, opt)
    assert all(torch.equal(before[k], v) for k, v in fresh.state_dict().items())
    assert not opt.state


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_resume")
    for mode in ("train", "validation", "test"):
        os.symlink(os.path.realpath(orbit_fixture_tree), root / mode)
    return str(root)


def test_cli_resumes_a_jax_train_state(orbit_root, tmp_path, monkeypatch):
    """``single_step_learner_torch.py --mode train --resume_from`` a JAX
    ``checkpoint.ckpt`` written at epoch 1 of 2: it logs the resume, trains
    epoch 2 from the file's weights and writes its final model."""
    import single_step_learner_torch
    from orbit_tpu_torch.models import backbones
    from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser

    def cut_b0(name, dtype=torch.float32):
        return efficientnet.EfficientNet(arch=ARCH, head_chs=HEAD, dtype=dtype), HEAD, SPEC
    monkeypatch.setattr(backbones, "create_efficientnet", cut_b0)
    r = SingleStepFewShotRecogniser("efficientnet_b0", classifier="proto", batch_size=8,
                                    frame_size=84).init(3)
    grads = [_gradients(r, s, False) for s in (11, 12)]
    path = str(tmp_path / "checkpoint.ckpt")
    _, _, saved = _jax_run(r, _args("adam"), 1.0, grads, path)
    argv = ["--data_path", orbit_root, "--checkpoint_dir", str(tmp_path / "run"),
            "--mode", "train", "--feature_extractor", "efficientnet_b0",
            "--classifier", "proto", "--with_lite", "--learn_extractor",
            "--frame_size", "84", "--epochs", "2", "--num_train_tasks", "1",
            "--num_val_tasks", "1", "--tasks_per_batch", "1", "--batch_size", "8",
            "--num_lite_samples", "4", "--subsample_factor", "12", "--context_shot", "2",
            "--target_shot", "1", "--learning_rate", str(LR), "--resume_from", path]
    single_step_learner_torch.main(argv, device="cpu")
    (run,) = (tmp_path / "run").iterdir()
    log = (run / "log.txt").read_text()
    assert f"resumed from {path} at epoch 1" in log
    assert "epoch [2/2] train loss" in log and "epoch [1/2]" not in log
    final = convert.load(str(run / "final.ckpt"))
    in_file = convert.from_jax_variables(saved, expected=set(final))
    assert set(final) == set(in_file)
    # epoch 2 trained from the file's weights: every parameter moved from
    # them by a step of the learning rate's size, not from a fresh draw
    for k, v in final.items():
        if not k.endswith((".mean", ".var")):
            assert float((v - in_file[k]).abs().max()) < 10 * LR, k
