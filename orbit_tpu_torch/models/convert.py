"""JAX recogniser variables -> the port's state dict, and the port's own
checkpoint files.

:func:`from_jax_variables` takes the ``variables`` of an
``orbit_tpu.models.recognisers.SingleStepFewShotRecogniser`` with a ViT
extractor, as nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)``), and returns the state dict of
:class:`orbit_tpu_torch.models.recognisers.SingleStepFewShotRecogniser`.
The port keeps the Flax names and layouts, so the mapping is a renaming
(``blocks_3/attn/qkv/kernel`` -> ``extractor.blocks.3.attn.qkv.kernel``).
The depth comes from the tree, so a depth-reduced ViT maps as well, and so
does a tree of gradients with the variables' structure. Like
``orbit_tpu/models/convert.py`` it refuses silent drops: a leaf it does not
map raises, and so does a parameter of the inferred architecture that no
leaf sets.

Reading flax msgpack checkpoints needs flax, which the port does not
import; :func:`save`/:func:`load` write and read the port's state dict as a
torch file (``--model_path``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK_LEAVES = ("norm1/scale", "norm1/bias", "attn/qkv/kernel", "attn/qkv/bias",
                 "attn/proj/kernel", "attn/proj/bias", "norm2/scale",
                 "norm2/bias", "mlp/fc1/kernel", "mlp/fc1/bias",
                 "mlp/fc2/kernel", "mlp/fc2/bias")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _expected_vit_leaves(flat: Dict[str, np.ndarray]):
    """The leaf paths a ViT extractor of the tree's depth (and pre-norm)
    must have, under ``params/extractor``."""
    ex = "params/extractor"
    depth = 1 + max((int(m.group(1)) for p in flat
                     if (m := re.match(rf"{ex}/blocks_(\d+)/", p))), default=-1)
    leaves = [f"{ex}/patch_embed/kernel", f"{ex}/patch_embed/bias",
              f"{ex}/cls_token", f"{ex}/pos_embed",
              f"{ex}/norm/scale", f"{ex}/norm/bias"]
    if any(p.startswith(f"{ex}/norm_pre/") for p in flat):
        leaves += [f"{ex}/norm_pre/scale", f"{ex}/norm_pre/bias"]
    for i in range(depth):
        leaves += [f"{ex}/blocks_{i}/{leaf}" for leaf in _BLOCK_LEAVES]
    return leaves


def _port_key(path: str) -> str:
    rest = path[len("params/extractor/"):]
    rest = re.sub(r"^blocks_(\d+)/", r"blocks/\1/", rest)
    return "extractor." + rest.replace("/", ".")


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX recogniser ``variables`` (nested dicts of arrays) -> port state
    dict (f32 CPU tensors, as the JAX package stores its parameters)."""
    flat = _flatten(tree)
    expected = _expected_vit_leaves(flat)
    missing = [p for p in expected if p not in flat]
    if missing:
        raise ValueError(f"JAX variables lack ViT parameters: {missing[:5]}")
    unused = sorted(set(flat) - set(expected))
    if unused:
        raise ValueError(f"JAX leaves the port does not map: {unused[:5]}")
    return {_port_key(p): torch.from_numpy(np.array(flat[p], dtype=np.float32))
            for p in expected}


def save(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
