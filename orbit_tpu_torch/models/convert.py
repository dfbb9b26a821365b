"""JAX recogniser variables -> the port's state dict, and the port's own
checkpoint files.

:func:`from_jax_variables` takes the ``variables`` of an
``orbit_tpu.models.recognisers`` recogniser (single- or multi-step, ViT or
EfficientNet extractor, with or without the set encoder and FiLM
generator), as nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)``), and returns the state dict of the port's
recogniser of the same kind.
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

from orbit_tpu_torch.models.backbones.efficientnet import create_efficientnet
from orbit_tpu_torch.models.backbones.vit import vit_film_spec
from orbit_tpu_torch.models.film import FilmParameterGenerator
from orbit_tpu_torch.models.heads import VersaProcessors
from orbit_tpu_torch.models.set_encoder import SetEncoder

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
    leaves = [f"{ex}/patch_embed/kernel", f"{ex}/patch_embed/bias",
              f"{ex}/cls_token", f"{ex}/pos_embed",
              f"{ex}/norm/scale", f"{ex}/norm/bias"]
    if any(p.startswith(f"{ex}/norm_pre/") for p in flat):
        leaves += [f"{ex}/norm_pre/scale", f"{ex}/norm_pre/bias"]
    for i in range(_vit_depth(flat)):
        leaves += [f"{ex}/blocks_{i}/{leaf}" for leaf in _BLOCK_LEAVES]
    return leaves


def _vit_depth(flat: Dict[str, np.ndarray]) -> int:
    return 1 + max((int(m.group(1)) for p in flat
                    if (m := re.match(r"params/extractor/blocks_(\d+)/", p))), default=-1)


def _port_key(path: str) -> str:
    rest = path[len("params/extractor/"):]
    rest = re.sub(r"^blocks_(\d+)/", r"blocks/\1/", rest)
    return "extractor." + rest.replace("/", ".")


def _vit_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    ex = {p: v for p, v in flat.items() if p.startswith("params/extractor/")}
    expected = _expected_vit_leaves(ex)
    missing = [p for p in expected if p not in ex]
    if missing:
        raise ValueError(f"JAX variables lack ViT parameters: {missing[:5]}")
    unused = sorted(set(ex) - set(expected))
    if unused:
        raise ValueError(f"JAX leaves the port does not map: {unused[:5]}")
    return {_port_key(p): ex[p] for p in expected}


def _renamed(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``params/<component>/...`` and ``batch_stats/extractor/...`` ->
    ``<component>....``; other collections are refused."""
    out = {}
    for p, v in flat.items():
        collection, _, rest = p.partition("/")
        if collection not in ("params", "batch_stats") or (
                collection == "batch_stats" and not rest.startswith("extractor/")):
            raise ValueError(f"JAX leaves the port does not map: {[p]}")
        out[rest.replace("/", ".")] = v
    return out


def _expected_keys(flat: Dict[str, np.ndarray], effnet: str | None):
    """The state-dict keys of the port's modules that the tree's components
    imply, from instances of those modules (no weights drawn)."""
    components = {p.split("/")[1] for p in flat if p.startswith("params/")}
    keys = set()
    if effnet:
        module, _, spec = create_efficientnet(effnet)
        keys |= {f"extractor.{k}" for k in module.state_dict()}
    else:
        spec = vit_film_spec(_vit_depth(flat), flat["params/extractor/norm/scale"].shape[0])
    for name, make in (("set_encoder", SetEncoder),
                       ("film_generator", lambda: FilmParameterGenerator(spec)),
                       ("versa", lambda: VersaProcessors(
                           flat["params/versa/weight_processor/linear1/kernel"].shape[0]))):
        if name in components:
            keys |= {f"{name}.{k}" for k in make().state_dict()}
    return keys


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX recogniser ``variables`` (nested dicts of arrays) -> port state
    dict (f32 CPU tensors, as the JAX package stores its parameters)."""
    flat = _flatten(tree)
    stem = flat.get("params/extractor/conv_stem/kernel")
    if stem is None:  # a ViT: its own mapping, then the other components
        state = _vit_state(flat)
        rest = {p: v for p, v in flat.items() if not p.startswith("params/extractor/")}
        effnet = None
    else:
        effnet = {32: "efficientnet_b0", 24: "efficientnet_v2_s"}.get(stem.shape[-1])
        if effnet is None:
            raise ValueError(f"unknown EfficientNet stem {stem.shape}")
        state, rest = {}, flat
    state.update(_renamed(rest))
    expected = _expected_keys(flat, effnet)
    if effnet is None:
        expected |= {k for k in state if k.startswith("extractor.")}
    unused = sorted(set(state) - expected)
    if unused:
        raise ValueError(f"JAX leaves the port does not map: {unused[:5]}")
    missing = sorted(expected - set(state))
    if missing:
        raise ValueError(f"JAX variables lack parameters of the port: {missing[:5]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}


def save(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
