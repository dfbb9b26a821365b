"""Checkpoint conversion of the port: upstream checkpoints (timm, augreg
big_vision, open_clip, full reference recognisers) -> the JAX package's
Flax-layout trees -> the port's state dict, and back.

:func:`from_jax_variables` takes the ``variables`` of an
``orbit_tpu.models.recognisers`` recogniser (single- or multi-step, ViT or
EfficientNet extractor, with or without the set encoder and FiLM
generator), as nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)``, or a flax checkpoint read by
``utils/msgpack_tree.py``), and returns the state dict of the port's
recogniser of the same kind.
The port keeps the Flax names and layouts, so the mapping is a renaming
(``blocks_3/attn/qkv/kernel`` -> ``extractor.blocks.3.attn.qkv.kernel``);
:func:`to_jax_variables` is its inverse.
The depth comes from the tree, so a depth-reduced ViT maps as well, and so
does a tree of gradients with the variables' structure. Like
``orbit_tpu/models/convert.py`` it refuses silent drops: a leaf it does not
map raises, and so does a parameter of the inferred architecture that no
leaf sets.

The upstream key maps below are copies of ``orbit_tpu/models/convert.py``
(numpy only): ``load_torch_state_dict``, ``convert_efficientnet``,
``convert_vit``, ``convert_vit_npz``, ``convert_vit_openclip``,
``convert_extractor``, ``convert_set_encoder``, ``convert_film_generator``,
``convert_versa``, ``convert_recogniser_checkpoint``, ``save_converted`` and
``load_pretrained_extractor`` (and :func:`load_upstream_extractor`, which
takes the state dict in memory). Each produces the Flax-layout tree, which
then goes through the one renaming above, so a converted checkpoint is a
flax msgpack file that either package loads:

    python scripts/convert_checkpoint_torch.py --feature_extractor efficientnet_b0 \\
        --torch_path tf_efficientnet_b0_aa.pth --out efficientnet_b0.ckpt

then train/test with ``--pretrained_extractor_path efficientnet_b0.ckpt``.
Differences: ``convert_recogniser_checkpoint`` starts from the port's
recogniser (its variables through :func:`to_jax_variables`) where the
original starts from Flax ones, and ``load_pretrained_extractor`` also
refuses a leaf of the file that the extractor does not have, where flax's
restore drops it.

:func:`save`/:func:`load` write and read the port's state dict as a torch
file; :func:`load` also reads the JAX package's flax files (``best.ckpt``,
``final.ckpt``), told apart by content, not by name (``--model_path``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from orbit_tpu_torch.models.backbones.efficientnet import create_efficientnet
from orbit_tpu_torch.models.backbones.vit import vit_film_spec
from orbit_tpu_torch.models.film import FilmParameterGenerator
from orbit_tpu_torch.models.heads import VersaProcessors
from orbit_tpu_torch.models.set_encoder import SetEncoder
from orbit_tpu_torch.utils import msgpack_tree

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
        elif isinstance(v, torch.Tensor):  # a bfloat16 leaf of a flax file
            flat[path] = v.detach().float().cpu().numpy()
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


def from_jax_variables(tree: Mapping, expected=None) -> Dict[str, torch.Tensor]:
    """JAX recogniser ``variables`` (nested dicts of arrays) -> port state
    dict (f32 CPU tensors, as the JAX package stores its parameters).
    ``expected``: the port's keys the tree must fill exactly (a given
    recogniser's, or a subset such as its parameters' names); by default
    those of fresh modules of the components the tree holds."""
    flat = _flatten(tree)
    vit = "params/extractor/conv_stem/kernel" not in flat
    if vit:  # a ViT: its own mapping, then the other components
        state = _vit_state(flat)
        rest = {p: v for p, v in flat.items() if not p.startswith("params/extractor/")}
    else:
        state, rest = {}, flat
    state.update(_renamed(rest))
    if expected is None:
        effnet = None
        if not vit:
            stem = flat["params/extractor/conv_stem/kernel"]
            effnet = {32: "efficientnet_b0", 24: "efficientnet_v2_s"}.get(stem.shape[-1])
            if effnet is None:
                raise ValueError(f"unknown EfficientNet stem {stem.shape}")
        expected = _expected_keys(flat, effnet)
        if vit:
            expected |= {k for k in state if k.startswith("extractor.")}
    expected = set(expected)
    unused = sorted(set(state) - expected)
    if unused:
        raise ValueError(f"JAX leaves the port does not map: {unused[:5]}")
    missing = sorted(expected - set(state))
    if missing:
        raise ValueError(f"JAX variables lack parameters of the port: {missing[:5]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the JAX recogniser's ``variables`` (nested
    dicts of CPU tensors, their dtype kept): the inverse of
    :func:`from_jax_variables`. An EfficientNet's running statistics
    (``extractor.<module>.mean``/``.var``) go to ``batch_stats/extractor``,
    every other leaf to ``params``."""
    flat: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        path = re.sub(r"^extractor\.blocks\.(\d+)\.", r"extractor.blocks_\1.", key)
        leaf = path.rsplit(".", 1)[-1]
        collection = ("batch_stats" if path.startswith("extractor.")
                      and leaf in ("mean", "var") else "params")
        flat[f"{collection}/{path.replace('.', '/')}"] = value.detach().cpu()
    return _nest(flat)


# ------------------------------------- upstream checkpoints (numpy only) ----
def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch ``.pt``/``.pth``/``.bin`` (or ``.npz``) state dict as
    NumPy."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if hasattr(v, "detach")}


def convert_efficientnet(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """timm tf_efficientnet_{b0,v2_s} state dict -> (params, batch_stats)."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, v in sd.items():
        if key.startswith("classifier.") or key.endswith("num_batches_tracked"):
            continue
        key = re.sub(r"^blocks\.(\d+)\.(\d+)\.", r"blocks_\1_\2/", key)
        parts = key.replace(".", "/").split("/")
        prefix, leaf = "/".join(parts[:-1]), parts[-1]
        module = parts[-2] if len(parts) >= 2 else ""
        if module.startswith(("conv", "se")) or "conv" in module:
            if leaf == "weight":
                params[f"{prefix}/kernel"] = _t_conv(v)
            else:
                params[f"{prefix}/{leaf}"] = v
        elif module.startswith("bn"):
            if leaf == "weight":
                params[f"{prefix}/scale"] = v
            elif leaf == "bias":
                params[f"{prefix}/bias"] = v
            elif leaf == "running_mean":
                stats[f"{prefix}/mean"] = v
            elif leaf == "running_var":
                stats[f"{prefix}/var"] = v
            else:  # never drop a source tensor silently
                raise ValueError(f"unmapped efficientnet bn leaf: {key}")
        else:
            raise ValueError(f"unmapped efficientnet key: {key}")
    return _nest(params), _nest(stats)


def convert_vit(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """timm vit_{small,base}_patch32 state dict -> (params, {})."""
    params: Dict[str, np.ndarray] = {}
    for key, v in sd.items():
        if key.startswith(("head.", "pre_logits.", "fc_norm.")):
            continue
        if key == "cls_token":
            params["cls_token"] = v
        elif key == "pos_embed":
            params["pos_embed"] = v
        elif key == "patch_embed.proj.weight":
            params["patch_embed/kernel"] = _t_conv(v)
        elif key == "patch_embed.proj.bias":
            params["patch_embed/bias"] = v
        else:
            key = re.sub(r"^blocks\.(\d+)\.", r"blocks_\1/", key)
            parts = key.replace(".", "/").split("/")
            prefix, leaf = "/".join(parts[:-1]), parts[-1]
            module = parts[-2]
            if module.startswith("norm"):
                params[f"{prefix}/{'scale' if leaf == 'weight' else 'bias'}"] = v
            elif leaf == "weight":
                params[f"{prefix}/kernel"] = _t_linear(v)
            elif leaf == "bias":
                params[f"{prefix}/{leaf}"] = v
            else:
                raise ValueError(f"unmapped vit key: {key}")
    return _nest(params), {}


def convert_vit_npz(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """Google 'augreg' big_vision ``.npz`` checkpoint (the reference's pinned
    vit_s_32 / vit_b_32 URLs, model/feature_extractors.py:49-58) -> the
    Flax-layout tree. Every source tensor is either mapped or in the
    explicit skip-list; anything else raises."""
    params: Dict[str, np.ndarray] = {}
    used = set()

    def get(key: str) -> np.ndarray:
        used.add(key)
        return np.asarray(sd[key])

    cls = get("cls")
    d = cls.shape[-1]
    params["cls_token"] = cls
    params["pos_embed"] = get("Transformer/posembed_input/pos_embedding")
    params["patch_embed/kernel"] = get("embedding/kernel")  # HWIO already
    params["patch_embed/bias"] = get("embedding/bias")
    params["norm/scale"] = get("Transformer/encoder_norm/scale")
    params["norm/bias"] = get("Transformer/encoder_norm/bias")
    depth = 1 + max(int(k.split("/")[1].split("_")[1]) for k in sd
                    if k.startswith("Transformer/encoderblock_"))
    for i in range(depth):
        p = f"Transformer/encoderblock_{i}"
        t = f"blocks_{i}"
        params[f"{t}/norm1/scale"] = get(f"{p}/LayerNorm_0/scale")
        params[f"{t}/norm1/bias"] = get(f"{p}/LayerNorm_0/bias")
        params[f"{t}/norm2/scale"] = get(f"{p}/LayerNorm_2/scale")
        params[f"{t}/norm2/bias"] = get(f"{p}/LayerNorm_2/bias")
        params[f"{t}/mlp/fc1/kernel"] = get(f"{p}/MlpBlock_3/Dense_0/kernel")
        params[f"{t}/mlp/fc1/bias"] = get(f"{p}/MlpBlock_3/Dense_0/bias")
        params[f"{t}/mlp/fc2/kernel"] = get(f"{p}/MlpBlock_3/Dense_1/kernel")
        params[f"{t}/mlp/fc2/bias"] = get(f"{p}/MlpBlock_3/Dense_1/bias")
        a = f"{p}/MultiHeadDotProductAttention_1"
        # (D, H, Dh) per q/k/v -> one fused (D, 3D) kernel, head-major columns
        # matching the attention's reshape(n, s, 3, H, Dh)
        params[f"{t}/attn/qkv/kernel"] = np.concatenate(
            [get(f"{a}/{m}/kernel").reshape(d, -1) for m in ("query", "key", "value")],
            axis=1)
        params[f"{t}/attn/qkv/bias"] = np.concatenate(
            [get(f"{a}/{m}/bias").reshape(-1) for m in ("query", "key", "value")])
        params[f"{t}/attn/proj/kernel"] = get(f"{a}/out/kernel").reshape(-1, d)
        params[f"{t}/attn/proj/bias"] = get(f"{a}/out/bias")
    leftover = {k for k in sd if k not in used
                and not k.startswith(("head", "pre_logits"))}
    if leftover:
        raise ValueError(f"unmapped augreg-npz keys: {sorted(leftover)[:5]}")
    return _nest(params), {}


def convert_vit_openclip(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """open_clip checkpoint (``open_clip_pytorch_model.bin``, the reference's
    pinned laion2B ViT-B/32, model/feature_extractors.py:60-66) -> the
    Flax-layout tree. Only the visual tower is used; the text tower,
    logit_scale and the image->text projection (``visual.proj``) are
    dropped, as timm does with ``num_classes=0``. CLIP's patch conv has no
    bias; the tree's is zero."""
    params: Dict[str, np.ndarray] = {}
    used = set()

    def get(key: str) -> np.ndarray:
        used.add(key)
        return np.asarray(sd[key])

    cls = get("visual.class_embedding")
    d = cls.shape[-1]
    params["cls_token"] = cls.reshape(1, 1, d)
    params["pos_embed"] = get("visual.positional_embedding")[None]
    params["patch_embed/kernel"] = _t_conv(get("visual.conv1.weight"))
    params["patch_embed/bias"] = np.zeros((d,), np.float32)
    params["norm_pre/scale"] = get("visual.ln_pre.weight")
    params["norm_pre/bias"] = get("visual.ln_pre.bias")
    params["norm/scale"] = get("visual.ln_post.weight")
    params["norm/bias"] = get("visual.ln_post.bias")
    blocks = {int(k.split(".")[3]) for k in sd
              if k.startswith("visual.transformer.resblocks.")}
    for i in sorted(blocks):
        p = f"visual.transformer.resblocks.{i}"
        t = f"blocks_{i}"
        params[f"{t}/norm1/scale"] = get(f"{p}.ln_1.weight")
        params[f"{t}/norm1/bias"] = get(f"{p}.ln_1.bias")
        params[f"{t}/norm2/scale"] = get(f"{p}.ln_2.weight")
        params[f"{t}/norm2/bias"] = get(f"{p}.ln_2.bias")
        params[f"{t}/attn/qkv/kernel"] = _t_linear(get(f"{p}.attn.in_proj_weight"))
        params[f"{t}/attn/qkv/bias"] = get(f"{p}.attn.in_proj_bias")
        params[f"{t}/attn/proj/kernel"] = _t_linear(get(f"{p}.attn.out_proj.weight"))
        params[f"{t}/attn/proj/bias"] = get(f"{p}.attn.out_proj.bias")
        params[f"{t}/mlp/fc1/kernel"] = _t_linear(get(f"{p}.mlp.c_fc.weight"))
        params[f"{t}/mlp/fc1/bias"] = get(f"{p}.mlp.c_fc.bias")
        params[f"{t}/mlp/fc2/kernel"] = _t_linear(get(f"{p}.mlp.c_proj.weight"))
        params[f"{t}/mlp/fc2/bias"] = get(f"{p}.mlp.c_proj.bias")
    leftover = {k for k in sd if k not in used and k.startswith("visual.")
                and k != "visual.proj"}
    if leftover:
        raise ValueError(f"unmapped open_clip visual keys: {sorted(leftover)[:5]}")
    return _nest(params), {}


def convert_extractor(sd: Dict[str, np.ndarray], feature_extractor: str):
    """An upstream backbone state dict -> (params, batch_stats), the layout
    told apart by its keys."""
    if feature_extractor.startswith("efficientnet"):
        return convert_efficientnet(sd)
    if feature_extractor.startswith("vit"):
        if any(k.startswith("Transformer/") for k in sd):
            return convert_vit_npz(sd)          # augreg big_vision .npz
        if any(k.startswith("visual.") for k in sd):
            return convert_vit_openclip(sd)     # open_clip .bin
        return convert_vit(sd)                  # timm torch layout
    raise ValueError(f"unknown feature_extractor {feature_extractor}")


def _split_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_set_encoder(sd: Dict[str, np.ndarray]) -> Dict:
    """Reference SetEncoder (set_encoders.py:81-120: 5x Sequential[conv, bn,
    relu, maxpool]) -> conv{i}/norm{i} params. The reference keeps this
    encoder in eval() forever, so its BatchNorm statistics stay (0, 1) and
    the BatchNorm is an affine: weight/bias map onto the affine norm's
    scale/bias, and the statistics must really be at their init."""
    params: Dict[str, np.ndarray] = {}
    for i in range(1, 6):
        layer = f"encoder.layer{i}"
        params[f"conv{i}/kernel"] = _t_conv(sd[f"{layer}.0.weight"])
        params[f"conv{i}/bias"] = sd[f"{layer}.0.bias"]
        params[f"norm{i}/scale"] = sd[f"{layer}.1.weight"]
        params[f"norm{i}/bias"] = sd[f"{layer}.1.bias"]
        mean, var = sd[f"{layer}.1.running_mean"], sd[f"{layer}.1.running_var"]
        if not (np.allclose(mean, 0.0, atol=1e-5) and np.allclose(var, 1.0, atol=1e-5)):
            raise ValueError(
                f"set_encoder {layer} BN stats moved off their init; the "
                "affine-norm mapping assumes eval-mode-forever BN")
    return _nest(params)


def _film_torch_name(path: Tuple[str, ...]) -> str:
    """A FiLM-spec path (the JAX package's or the port's, which differ only
    in ``blocks_3`` against ``blocks``, ``3``) -> the reference's torch
    parameter name (model/film.py:68-74): ('blocks_1_0', 'bn2', 'scale') ->
    'blocks.1.0.bn2.weight', ('blocks', '3', 'norm1', 'bias') ->
    'blocks.3.norm1.bias'."""
    *mods, leaf = path
    names = []
    for m in mods:
        if m.startswith("blocks_"):
            names.extend(["blocks"] + m.split("_")[1:])
        else:
            names.append(m)
    return ".".join(names + ["weight" if leaf == "scale" else "bias"])


def convert_film_generator(sd: Dict[str, np.ndarray], film_spec) -> Dict:
    """Reference FilmParameterGenerator (feature_adapters.py:36-64):
    ModuleList of DenseBlocks + ParameterList of regularisers, both indexed
    by the reference's *sorted torch FiLM parameter names*. Index i ->
    ``gen__<tag>`` / ``reg__<tag>`` params."""
    torch_names = {path: _film_torch_name(path) for path, _ in film_spec}
    idx_of = {name: i for i, name in enumerate(sorted(torch_names.values()))}
    params: Dict[str, np.ndarray] = {}
    for path, _ in film_spec:
        i = idx_of[torch_names[path]]
        tag = "_".join(path)
        params[f"gen__{tag}/fc1/kernel"] = _t_linear(sd[f"generators.{i}.block.0.weight"])
        params[f"gen__{tag}/fc1/bias"] = sd[f"generators.{i}.block.0.bias"]
        params[f"gen__{tag}/ln/scale"] = sd[f"generators.{i}.block.1.weight"]
        params[f"gen__{tag}/ln/bias"] = sd[f"generators.{i}.block.1.bias"]
        params[f"gen__{tag}/fc2/kernel"] = _t_linear(sd[f"generators.{i}.block.3.weight"])
        params[f"gen__{tag}/fc2/bias"] = sd[f"generators.{i}.block.3.bias"]
        params[f"reg__{tag}"] = sd[f"regularizers.{i}"]
    return _nest(params)


def convert_versa(sd: Dict[str, np.ndarray]) -> Dict:
    """Reference VersaClassifier hyper-nets (classifier_heads.py:121-143):
    weight_processor/bias_processor DenseResidualBlocks."""
    params: Dict[str, np.ndarray] = {}
    for proc in ("weight_processor", "bias_processor"):
        for lin in ("linear1", "linear2", "linear3"):
            params[f"{proc}/{lin}/kernel"] = _t_linear(sd[f"{proc}.{lin}.weight"])
            params[f"{proc}/{lin}/bias"] = sd[f"{proc}.{lin}.bias"]
    return _nest(params)


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def convert_recogniser_checkpoint(sd: Dict[str, np.ndarray], recogniser) -> Dict:
    """Full reference recogniser state_dict (torch.save of
    SingleStep/MultiStepFewShotRecogniser) -> Flax-layout variables, from
    the port's ``recogniser`` (its architecture and, for a component the
    checkpoint lacks, its current parameters).

    Handles the feature extractor (with its BatchNorm statistics), the set
    encoder, the FiLM generator and the Versa hyper-nets; per-task state
    (proto/mahalanobis/linear heads) is in no checkpoint of either
    framework.
    """
    variables = _numpy_tree(to_jax_variables(recogniser.state_dict()))
    ex_params, ex_stats = convert_extractor(
        _split_prefix(sd, "feature_extractor."), recogniser.feature_extractor_name)
    params = dict(variables["params"])
    params["extractor"] = ex_params

    se_sd = _split_prefix(sd, "set_encoder.")
    if se_sd and "set_encoder" in params:
        params["set_encoder"] = convert_set_encoder(se_sd)
    fg_sd = _split_prefix(sd, "film_generator.")
    if fg_sd and "film_generator" in params:
        params["film_generator"] = convert_film_generator(fg_sd, recogniser.film_spec)
    cls_sd = _split_prefix(sd, "classifier.")
    if cls_sd and "versa" in params:
        params["versa"] = convert_versa(cls_sd)

    out = dict(variables)
    out["params"] = params
    if ex_stats:
        out["batch_stats"] = {**variables.get("batch_stats", {}), "extractor": ex_stats}
    return out


def save_converted(out_path: str, params: Dict, batch_stats: Dict) -> None:
    """A converted extractor as the flax checkpoint
    ``--pretrained_extractor_path`` reads."""
    from orbit_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(out_path, {"params": params, "batch_stats": batch_stats})


def load_pretrained_extractor(recogniser, path: str) -> None:
    """Load a converted extractor checkpoint (``save_converted``'s flax file)
    into ``recogniser.extractor`` in place (:func:`_load_extractor`)."""
    from orbit_tpu_torch.utils.checkpoint import load_checkpoint

    tree = load_checkpoint(path)
    if set(tree) - {"params", "batch_stats"} or "params" not in tree:
        raise ValueError(f"{path}: not a converted extractor (top-level keys {sorted(tree)})")
    _load_extractor(recogniser, tree["params"], tree.get("batch_stats") or {}, path)


def load_upstream_extractor(recogniser, sd: Dict[str, np.ndarray]) -> None:
    """Load an upstream backbone state dict (timm, augreg or open_clip
    layout, as :func:`convert_extractor` reads it) into
    ``recogniser.extractor`` in place (:func:`_load_extractor`)."""
    params, stats = convert_extractor(sd, recogniser.feature_extractor_name)
    _load_extractor(recogniser, params, stats, "the state dict")


def _load_extractor(recogniser, params: Dict, stats: Dict, what: str) -> None:
    """Flax-layout extractor ``params`` and ``stats`` into
    ``recogniser.extractor``, validating every leaf's shape against the
    initialised model: a leaf the model lacks, or one of the model's that
    ``what`` does not set, raises."""
    state = from_jax_variables({"params": {"extractor": params},
                                "batch_stats": {"extractor": stats}})
    own = recogniser.extractor.state_dict()
    ours = {k[len("extractor."):]: v for k, v in state.items()}
    extra, missing = sorted(set(ours) - set(own)), sorted(set(own) - set(ours))
    if extra or missing:
        raise ValueError(f"{what} does not match the {recogniser.feature_extractor_name} "
                         f"extractor: leaves it lacks {missing[:5]}, leaves the "
                         f"extractor lacks {extra[:5]}")
    wrong = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in ours.items()
             if v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"shape mismatch in {what} (leaf, file, model): {wrong[:5]}")
    recogniser.extractor.load_state_dict(ours, strict=True)


def save(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """A model file -> the port's state dict: the port's torch file, or the
    JAX package's flax ``variables`` file (``best.ckpt``/``final.ckpt``),
    told apart by content (a torch zip starts with ``PK``, a flax file
    with a msgpack map)."""
    with open(path, "rb") as f:
        head = f.read(2)
    if not msgpack_tree.is_msgpack_map(head):
        return torch.load(path, map_location="cpu", weights_only=True)
    tree = msgpack_tree.load(path)
    if "params" not in tree or set(tree) - {"params", "batch_stats"}:
        raise ValueError(f"{path} is a flax file but not recogniser variables "
                         f"(top-level keys {sorted(tree)}); a JAX train state "
                         "(checkpoint.ckpt) is read by --resume_from")
    return from_jax_variables(tree)
