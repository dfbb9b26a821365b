"""Train-state checkpoints of the port (counterpart of
``orbit_tpu/utils/checkpoint.py``; reference: single-step-learner.py:377-390).

The per-epoch ``checkpoint.ckpt`` is a torch file holding the epoch, the
recogniser's state dict, the optimiser's state and the best validation
stats; ``--resume_from`` reads it back. The best-validation and final
models are plain state dicts (:func:`orbit_tpu_torch.models.convert.save`),
which ``--model_path`` loads. The JAX package writes flax msgpack files
instead; the port cannot read them, because reading them needs flax.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


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
    ``{"epoch", "best_stats"}``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    recogniser.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return {"epoch": state["epoch"], "best_stats": state["best_stats"]}
