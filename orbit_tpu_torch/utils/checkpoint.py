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
port's file (``convert.load``). Resuming from a JAX train state (an optax
``opt_state``) is not ported: :func:`load_train_state` refuses a flax file.
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
    """Restore the recogniser and optimiser from ``path`` in place; return
    ``{"epoch", "best_stats"}``. A JAX train state (a flax file) raises
    NotImplementedError."""
    with open(path, "rb") as f:
        if msgpack_tree.is_msgpack_map(f.read(2)):
            raise NotImplementedError(
                f"{path} is a JAX train state (flax msgpack with an optax opt_state): "
                "resuming from it is not ported; pass the JAX package's best.ckpt or "
                "final.ckpt to --model_path, or resume from the port's own checkpoint.ckpt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    recogniser.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return {"epoch": state["epoch"], "best_stats": state["best_stats"]}
