"""Checkpoints of the port (counterpart of ``orbit_tpu/utils/checkpoint.py``;
reference: single-step-learner.py:377-390).

The per-epoch ``checkpoint.ckpt`` is a torch file holding the epoch, the
recogniser's state dict, the optimiser's state and the best validation
stats; ``--resume_from`` reads it back. The best-validation and final
models are plain state dicts (:func:`orbit_tpu_torch.models.convert.save`),
which ``--model_path`` loads.

The JAX package writes flax msgpack files; :func:`save_checkpoint`,
:func:`load_checkpoint` and :func:`maybe_load_params` are the counterparts
of its functions of those names, on ``utils/msgpack_tree.py`` (no flax).
``--model_path`` reads a JAX ``best.ckpt``/``final.ckpt`` as well as the
port's file (``convert.load``).

``--resume_from`` reads either package's ``checkpoint.ckpt``. The JAX
learner's (orbit_tpu/learners/single_step.py:312-317) is a flax file of
``epoch``, ``variables``, the optax ``opt_state`` and ``best_stats``. Its
chain (orbit_tpu/utils/optim.py:108-140) is ``inject_hyperparams`` around
``chain(add_decayed_weights | identity, scale_by_adam | trace | identity,
[masked(scale)], scale_by_learning_rate)``; the port's optimiser
(``utils/optim.py``) computes the same update, so the state maps over:

- the variables (``batch_stats`` included) through
  ``convert.from_jax_variables``, against the recogniser's own keys;
- Adam's ``count``, ``mu`` and ``nu`` to every trainable parameter's
  ``step``, ``exp_avg`` and ``exp_avg_sq``; SGD's ``trace`` to its
  ``momentum_buffer``; the empty states (the decay, identity, the masked
  extractor scale, the learning rate) carry nothing, and the learning rate
  comes from the port's schedule at the epoch;
- a frozen extractor (``requires_grad`` off) takes the file's values and no
  optimiser state: the port never updates it, where the JAX chain decays
  it under ``--weight_decay``.

Every leaf is mapped by name. A tree whose layout the optimiser's settings
do not explain (another optimiser, a missing moment, a leaf of another
shape) is refused with a ValueError naming the leaf.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from orbit_tpu_torch.utils import msgpack_tree


def _leaves_as_arrays(tree):
    """``jax.tree_util.tree_map(np.asarray, tree)``, torch tensors kept."""
    if isinstance(tree, Mapping):
        return {k: _leaves_as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _leaves_as_arrays(v) for i, v in enumerate(tree)}
    return tree if isinstance(tree, torch.Tensor) else np.asarray(tree)


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Serialise ``tree`` (nested dicts of arrays, tensors or scalars) to
    ``path`` atomically, as the JAX package's ``save_checkpoint`` does: a
    flax msgpack file with every leaf an array."""
    msgpack_tree.save(path, _leaves_as_arrays(tree))


def load_checkpoint(path: str):
    """Restore a tree saved by either package's ``save_checkpoint``. The JAX
    function's template has no counterpart: the callers validate what they
    read (``load_state_dict(strict=True)``,
    ``convert.load_pretrained_extractor``)."""
    return msgpack_tree.load(path)


def maybe_load_params(path: Optional[str], recogniser: torch.nn.Module, logfile=None):
    """Load a model file (the port's torch file or a JAX flax file) into
    ``recogniser`` if ``path`` exists, else warn and keep the initial
    parameters (reference behaviour: single-step-learner.py:300-305).
    Returns the path used, or None."""
    from orbit_tpu_torch.models import convert
    from orbit_tpu_torch.utils.logging import print_and_log

    if path and os.path.exists(path):
        recogniser.load_state_dict(convert.load(path), strict=True)
        return path
    print_and_log(logfile, "warning: saved model path could not be found; "
                           "using original param initialisation.")
    return None


def _plain(stats: Dict[str, Any]) -> Dict[str, list]:
    """Evaluator stats ({name: [mean, ci]}) as Python floats, so the file
    loads with ``weights_only=True``."""
    return {k: [float(x) for x in v] for k, v in stats.items()}


def save_train_state(path: str, epoch: int, recogniser: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, best_stats) -> None:
    """Write the train state to ``path`` atomically."""
    state = {"epoch": int(epoch),
             "state_dict": {k: v.detach().cpu() for k, v in
                            recogniser.state_dict().items()},
             "optimizer": optimizer.state_dict(),
             "best_stats": _plain(best_stats)}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, recogniser: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Restore the recogniser and optimiser from ``path`` (the port's torch
    file or a JAX train state) in place; return ``{"epoch",
    "best_stats"}``."""
    with open(path, "rb") as f:
        if msgpack_tree.is_msgpack_map(f.read(2)):
            return _load_jax_train_state(path, recogniser, optimizer)
    state = torch.load(path, map_location="cpu", weights_only=True)
    recogniser.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return {"epoch": state["epoch"], "best_stats": state["best_stats"]}


def _keys(tree, expected, where: str) -> None:
    """Refuse ``tree`` unless it is a map with exactly the keys ``expected``."""
    if not isinstance(tree, Mapping):
        raise ValueError(f"{where}: a leaf where the JAX train state holds a map "
                         f"of {sorted(expected)}")
    extra = sorted(set(tree) - set(expected))
    missing = sorted(set(expected) - set(tree))
    if extra or missing:
        raise ValueError(f"{where}: leaves {[f'{where}/{k}' for k in extra]} that the "
                         f"JAX learner's layout and the optimiser's settings do not "
                         f"explain, leaves {[f'{where}/{k}' for k in missing]} missing")


def _mapped(tree, recogniser: torch.nn.Module, names, where: str) -> Dict[str, torch.Tensor]:
    """A tree of the JAX recogniser's layout (``{"params": ...}`` and
    ``batch_stats``) -> the port's tensors under ``names``, each of its
    tensor's shape."""
    from orbit_tpu_torch.models import convert

    try:
        state = convert.from_jax_variables(tree, expected=names)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    own = recogniser.state_dict()
    wrong = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state.items()
             if v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"{where}: shapes differ (leaf, file, model): {wrong[:5]}")
    return state


def _jax_optimizer_state(opt_state, recogniser: torch.nn.Module,
                         optimizer: torch.optim.Optimizer, where: str) -> Dict[str, Any]:
    """The optax state of the JAX chain -> ``optimizer.state_dict()``'s form,
    by parameter name."""
    adam = isinstance(optimizer, torch.optim.Adam)
    if not adam and not isinstance(optimizer, torch.optim.SGD):
        raise ValueError(f"no map from an optax state to {type(optimizer).__name__}")
    momentum = 0.0 if adam else optimizer.param_groups[0]["momentum"]
    scaled = any(g["lr_scale"] != 1.0 for g in optimizer.param_groups)
    if not isinstance(opt_state, Mapping) or "inner_state" not in opt_state:
        raise ValueError(f"{where}/inner_state missing: not an inject_hyperparams state")
    chain = opt_state["inner_state"]
    links = ["decay", "core"] + (["extractor scale"] if scaled else []) + ["learning rate"]
    _keys(chain, [str(i) for i in range(len(links))], f"{where}/inner_state")
    core_keys = ["count", "mu", "nu"] if adam else (["trace"] if momentum else [])
    for i, link in enumerate(links):
        _keys(chain[str(i)], {"core": core_keys, "extractor scale": ["inner_state"]}.get(link, []),
              f"{where}/inner_state/{i}")
    if scaled:
        _keys(chain["2"]["inner_state"], [], f"{where}/inner_state/2/inner_state")

    name_of = {id(p): n for n, p in recogniser.named_parameters()}
    trained = {name_of[id(p)] for g in optimizer.param_groups for p in g["params"]
               if p.requires_grad}
    core, prefix = chain["1"], f"{where}/inner_state/1"
    moments = {k: _mapped({"params": core[k]}, recogniser, set(name_of.values()),
                          f"{prefix}/{k}") for k in core_keys if k != "count"}
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            if name in trained:
                if adam:
                    state[index] = {"step": torch.tensor(float(np.asarray(core["count"]))),
                                    "exp_avg": moments["mu"][name],
                                    "exp_avg_sq": moments["nu"][name]}
                elif momentum:
                    state[index] = {"momentum_buffer": moments["trace"][name]}
            index += 1
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _best_stats(tree) -> Dict[str, list]:
    """The JAX evaluator's ``{name: [mean, ci]}`` (lists stored as maps keyed
    "0", "1", ...) as Python floats."""
    def floats(v):
        if isinstance(v, Mapping):
            return [float(np.asarray(v[str(i)])) for i in range(len(v))]
        return [float(x) for x in np.atleast_1d(np.asarray(v))]
    return {k: floats(v) for k, v in tree.items()}


def _load_jax_train_state(path: str, recogniser: torch.nn.Module,
                          optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    tree = msgpack_tree.load(path)
    _keys(tree, ["epoch", "variables", "opt_state", "best_stats"], path)
    state = _mapped(tree["variables"], recogniser, set(recogniser.state_dict()),
                    f"{path}: variables")
    opt = _jax_optimizer_state(tree["opt_state"], recogniser, optimizer, f"{path}: opt_state")
    recogniser.load_state_dict(state, strict=True)
    optimizer.load_state_dict(opt)
    return {"epoch": int(np.asarray(tree["epoch"])), "best_stats": _best_stats(tree["best_stats"])}
