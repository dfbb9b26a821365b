"""Fake upstream checkpoints at the published widths and depths, made from
a numpy generator in each upstream's own key layout, independently of the
converter: the maps under test (``models/convert.py``, and the JAX
package's ``orbit_tpu/models/convert.py`` in the tests) must turn them into
parameters. The arrays are numpy's, float32 (int64 for ``num_batches_tracked``).

- :func:`fake_timm_vit`: timm ``vit_{small,base}_patch32_224``;
- :func:`fake_augreg_vit`: Google's augreg big_vision ``.npz``;
- :func:`fake_openclip_vit`: open_clip's ``open_clip_pytorch_model.bin``;
- :func:`fake_timm_efficientnet`: timm ``tf_efficientnet_b0`` /
  ``tf_efficientnetv2_s``, with BatchNorm running statistics;
- :func:`fake_reference_cnaps`: a full reference CNAPs recogniser (extractor,
  set encoder, FiLM generator, Versa processors).

ViT weights are drawn at 0.02 and LayerNorm scales near 1, so a frame's
features keep their dependence on the input through every layer. An
EfficientNet's kernels are drawn at 1/sqrt(fan in) under BatchNorm
statistics near the identity, which shrink the activations block by block:
calibrate the statistics (``backbones/efficientnet.py::calibrate_batchnorm``)
before comparing heads. ``chip_smoke.py`` (phases 11 and 15),
``scripts/make_golden_torch.py`` and the golden replay
(``models/golden.py``) draw their weights here.
"""
from __future__ import annotations

import numpy as np

from orbit_tpu_torch.models.backbones.efficientnet import ARCHS, STEM_CHS


def _normal(rng, scale: float = 0.02):
    def draw(*shape, s=scale):
        return (s * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)
    return draw


def fake_timm_vit(rng, dim: int, depth: int, tokens: int = 50) -> dict:
    """timm ``vit_{small,base}_patch32_224``: ``blocks.{i}.attn.qkv.weight``
    (3D, D) and the like, with its classifier head."""
    w = _normal(rng)
    sd = {"cls_token": w(1, 1, dim), "pos_embed": w(1, tokens, dim),
          "patch_embed.proj.weight": w(dim, 3, 32, 32), "patch_embed.proj.bias": w(dim),
          "norm.weight": 1 + w(dim, s=0.1), "norm.bias": w(dim),
          "head.weight": w(1000, dim), "head.bias": w(1000)}
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + w(dim, s=0.1), f"{p}.norm1.bias": w(dim),
                   f"{p}.attn.qkv.weight": w(3 * dim, dim), f"{p}.attn.qkv.bias": w(3 * dim),
                   f"{p}.attn.proj.weight": w(dim, dim), f"{p}.attn.proj.bias": w(dim),
                   f"{p}.norm2.weight": 1 + w(dim, s=0.1), f"{p}.norm2.bias": w(dim),
                   f"{p}.mlp.fc1.weight": w(4 * dim, dim), f"{p}.mlp.fc1.bias": w(4 * dim),
                   f"{p}.mlp.fc2.weight": w(dim, 4 * dim), f"{p}.mlp.fc2.bias": w(dim)})
    return sd


def fake_augreg_vit(rng, dim: int, depth: int, heads: int, tokens: int = 50) -> dict:
    """Google's augreg big_vision ``.npz``: ``Transformer/encoderblock_{i}/
    MultiHeadDotProductAttention_1/query/kernel`` (D, H, D/H) and the like,
    the patch kernel already HWIO, with its classifier head."""
    w = _normal(rng)
    hd = dim // heads
    sd = {"cls": w(1, 1, dim), "Transformer/posembed_input/pos_embedding": w(1, tokens, dim),
          "embedding/kernel": w(32, 32, 3, dim), "embedding/bias": w(dim),
          "Transformer/encoder_norm/scale": 1 + w(dim, s=0.1),
          "Transformer/encoder_norm/bias": w(dim),
          "head/kernel": w(dim, 1000), "head/bias": w(1000)}
    for i in range(depth):
        p = f"Transformer/encoderblock_{i}"
        a = f"{p}/MultiHeadDotProductAttention_1"
        sd.update({f"{p}/LayerNorm_0/scale": 1 + w(dim, s=0.1), f"{p}/LayerNorm_0/bias": w(dim),
                   f"{p}/LayerNorm_2/scale": 1 + w(dim, s=0.1), f"{p}/LayerNorm_2/bias": w(dim),
                   f"{p}/MlpBlock_3/Dense_0/kernel": w(dim, 4 * dim),
                   f"{p}/MlpBlock_3/Dense_0/bias": w(4 * dim),
                   f"{p}/MlpBlock_3/Dense_1/kernel": w(4 * dim, dim),
                   f"{p}/MlpBlock_3/Dense_1/bias": w(dim),
                   f"{a}/out/kernel": w(heads, hd, dim), f"{a}/out/bias": w(dim)})
        for m in ("query", "key", "value"):
            sd[f"{a}/{m}/kernel"] = w(dim, heads, hd)
            sd[f"{a}/{m}/bias"] = w(heads, hd)
    return sd


def fake_openclip_vit(rng, dim: int, depth: int, tokens: int = 50) -> dict:
    """open_clip ``open_clip_pytorch_model.bin``: the visual tower
    (``visual.transformer.resblocks.{i}.attn.in_proj_weight`` and the like,
    a bias-free patch conv, ``ln_pre``/``ln_post``, ``visual.proj``) and a
    few of the text tower's tensors, which the map drops."""
    w = _normal(rng)
    sd = {"visual.class_embedding": w(dim), "visual.positional_embedding": w(tokens, dim),
          "visual.conv1.weight": w(dim, 3, 32, 32),
          "visual.ln_pre.weight": 1 + w(dim, s=0.1), "visual.ln_pre.bias": w(dim),
          "visual.ln_post.weight": 1 + w(dim, s=0.1), "visual.ln_post.bias": w(dim),
          "visual.proj": w(dim, 512), "positional_embedding": w(77, 512),
          "text_projection": w(512, 512), "ln_final.weight": 1 + w(512, s=0.1),
          "ln_final.bias": w(512), "logit_scale": w(s=1.0),
          "transformer.resblocks.0.ln_1.weight": 1 + w(512, s=0.1)}
    for i in range(depth):
        p = f"visual.transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": 1 + w(dim, s=0.1), f"{p}.ln_1.bias": w(dim),
                   f"{p}.attn.in_proj_weight": w(3 * dim, dim),
                   f"{p}.attn.in_proj_bias": w(3 * dim),
                   f"{p}.attn.out_proj.weight": w(dim, dim), f"{p}.attn.out_proj.bias": w(dim),
                   f"{p}.ln_2.weight": 1 + w(dim, s=0.1), f"{p}.ln_2.bias": w(dim),
                   f"{p}.mlp.c_fc.weight": w(4 * dim, dim), f"{p}.mlp.c_fc.bias": w(4 * dim),
                   f"{p}.mlp.c_proj.weight": w(dim, 4 * dim), f"{p}.mlp.c_proj.bias": w(dim)})
    return sd


def fake_timm_efficientnet(rng, arch, stem: int, head: int = 1280) -> dict:
    """timm ``tf_efficientnet_b0`` / ``tf_efficientnetv2_s`` from the stage
    table ``arch`` ((type, repeats, k, stride, expansion, out, SE ratio)):
    ``blocks.{s}.{b}.conv_dw.weight`` and the like, BatchNorms with running
    statistics and ``num_batches_tracked``, the classifier. Kernels drawn
    at 1/sqrt(fan in), as tests/test_convert.py draws B0's."""
    sd = {}

    def conv(name, o, i, k, groups=1):
        fan_in = (i // groups) * k * k
        sd[f"{name}.weight"] = (rng.standard_normal((o, i // groups, k, k), dtype=np.float32)
                                * fan_in ** -0.5)

    def bn(name, c):
        sd[f"{name}.weight"] = (1.0 + 0.05 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.05 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.05 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (0.9 + 0.1 * rng.random(c)).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(0, np.int64)

    def se(name, c, rd):
        conv(f"{name}.conv_reduce", rd, c, 1)
        sd[f"{name}.conv_reduce.bias"] = (0.05 * rng.standard_normal(rd)).astype(np.float32)
        conv(f"{name}.conv_expand", c, rd, 1)
        sd[f"{name}.conv_expand.bias"] = (0.05 * rng.standard_normal(c)).astype(np.float32)

    conv("conv_stem", stem, 3, 3)
    bn("bn1", stem)
    in_chs = stem
    for s, (btype, repeats, k, _, exp, out_chs, se_ratio) in enumerate(arch):
        for b in range(repeats):
            p = f"blocks.{s}.{b}"
            mid = int(in_chs * exp)
            if btype == "cn":
                conv(f"{p}.conv", out_chs, in_chs, k)
                bn(f"{p}.bn1", out_chs)
            elif btype == "er":
                conv(f"{p}.conv_exp", mid, in_chs, k)
                bn(f"{p}.bn1", mid)
                conv(f"{p}.conv_pwl", out_chs, mid, 1)
                bn(f"{p}.bn2", out_chs)
            elif btype == "ds":
                conv(f"{p}.conv_dw", in_chs, in_chs, k, groups=in_chs)
                bn(f"{p}.bn1", in_chs)
                se(f"{p}.se", in_chs, max(1, int(in_chs * se_ratio)))
                conv(f"{p}.conv_pw", out_chs, in_chs, 1)
                bn(f"{p}.bn2", out_chs)
            else:  # ir
                conv(f"{p}.conv_pw", mid, in_chs, 1)
                bn(f"{p}.bn1", mid)
                conv(f"{p}.conv_dw", mid, mid, k, groups=mid)
                bn(f"{p}.bn2", mid)
                if se_ratio > 0:
                    se(f"{p}.se", mid, max(1, int(in_chs * se_ratio)))
                conv(f"{p}.conv_pwl", out_chs, mid, 1)
                bn(f"{p}.bn3", out_chs)
            in_chs = out_chs
    conv("conv_head", head, in_chs, 1)
    bn("bn2", head)
    sd["classifier.weight"] = _normal(rng)(1000, head)
    sd["classifier.bias"] = np.zeros(1000, np.float32)
    return sd


def reference_film_name(path) -> str:
    """A FiLM leaf's parameter name in the reference recogniser
    (model/film.py:68-74): ('blocks_1_0', 'bn2', 'scale') ->
    'blocks.1.0.bn2.weight'."""
    *mods, leaf = path
    names = [p for m in mods for p in (m.split("_") if m.startswith("blocks_") else [m])]
    return ".".join(names + ["weight" if leaf == "scale" else "bias"])


def fake_reference_cnaps(rng, film_spec, extractor: dict | None = None,
                         feat_dim: int = 1280) -> dict:
    """A full reference CNAPs recogniser (``torch.save(model.state_dict())``
    of SingleStepFewShotRecogniser with ``--adapt_features --classifier
    versa``): the upstream extractor ``extractor`` (by default a fake timm
    EfficientNet-B0, drawn first) under ``feature_extractor.``, the set
    encoder's five conv/BatchNorm layers, the FiLM generator's DenseBlocks
    and regularisers indexed by the sorted reference names of the FiLM
    leaves (``film_spec``: (path, size)), and the Versa weight and bias
    processors on ``feat_dim`` features."""
    w = _normal(rng)
    if extractor is None:
        extractor = fake_timm_efficientnet(rng, ARCHS["efficientnet_b0"],
                                           STEM_CHS["efficientnet_b0"])
    sd = {f"feature_extractor.{k}": v for k, v in extractor.items()
          if not k.startswith("classifier.")}
    in_ch = 3
    for i in range(1, 6):
        p = f"set_encoder.encoder.layer{i}"
        sd.update({f"{p}.0.weight": w(64, in_ch, 3, 3, s=(9 * in_ch) ** -0.5),
                   f"{p}.0.bias": w(64), f"{p}.1.weight": 1 + w(64, s=0.05),
                   f"{p}.1.bias": w(64), f"{p}.1.running_mean": np.zeros(64, np.float32),
                   f"{p}.1.running_var": np.ones(64, np.float32),
                   f"{p}.1.num_batches_tracked": np.array(0, np.int64)})
        in_ch = 64
    sizes = {reference_film_name(path): size for path, size in film_spec}
    for i, name in enumerate(sorted(sizes)):
        p = f"film_generator.generators.{i}"
        sd.update({f"{p}.block.0.weight": w(64, 64, s=0.125), f"{p}.block.0.bias": w(64),
                   f"{p}.block.1.weight": 1 + w(64, s=0.05), f"{p}.block.1.bias": w(64),
                   f"{p}.block.3.weight": w(sizes[name], 64, s=0.01),
                   f"{p}.block.3.bias": w(sizes[name], s=0.01),
                   f"film_generator.regularizers.{i}": w(sizes[name], s=0.001)})
    for proc, out in (("weight_processor", feat_dim), ("bias_processor", 1)):
        for lin, fan_in in (("linear1", feat_dim), ("linear2", out), ("linear3", out)):
            sd[f"classifier.{proc}.{lin}.weight"] = w(out, fan_in, s=fan_in ** -0.5)
            sd[f"classifier.{proc}.{lin}.bias"] = w(out)
    return sd
