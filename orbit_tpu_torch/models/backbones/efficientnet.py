"""EfficientNet-B0 and EfficientNetV2-S in PyTorch, NHWC, TF-SAME padding,
eval and train mode (counterpart of
``orbit_tpu/models/backbones/efficientnet.py``; reference:
model/feature_extractors.py:39-48, timm tf_efficientnet_b0 and
tf_efficientnetv2_s_in21k).

One generic trunk: stem conv -> BN -> SiLU -> the arch's blocks -> 1x1 head
conv -> BN -> SiLU -> global mean, output (N, 1280) f32. Parameters keep the
Flax names and layouts (``blocks_{stage}_{block}``, conv kernels
(kh, kw, in, out), depthwise taps (K, K, 1, C), BatchNorm ``scale``/``bias``
plus ``mean``/``var`` buffers), so ``models/convert.py`` is a renaming.

The forward copies the JAX module's casts under ``DW_FUSED = True``, the
route the port always takes:
- every stride-1 eval depthwise tail is one call of
  :func:`orbit_tpu_torch.ops.fused_dw_act` (TPU kernel #8 on the card): the
  DepthwiseSeparable block with an identity pre-affine and ``act1=False``,
  the InvertedResidual block with bn1 and bn2 folded, ``act1=act2=True``;
  the folded affines stay f32 there;
- the stride-2 depthwise layers take the composed route: BN in the compute
  dtype, SiLU, a grouped ``F.conv2d`` on TF-SAME padded input, BN, SiLU
  (``impl="composed"`` sends the stride-1 tails that way too, for
  :func:`calibrate_batchnorm`);
- the other convolutions run in the compute dtype: 1x1 convs as matmuls on
  the NHWC tensor, the stem as ``F.conv2d`` on a channels-last view.
Activations stay NHWC-contiguous throughout, so the kernel reads them with
no copy.

Train mode (``forward(x, train=True, mask=...)``, the meta-training of
``--learn_extractor``) runs every BatchNorm on the batch statistics of the
rows ``mask`` marks real (``masked_bn.py``) and returns the updated running
statistics beside the features, without writing the buffers. Every
depthwise tail takes the composed route there, as the JAX package does
(orbit_tpu efficientnet.py:170,232: ``DW_FUSED and not train``): bn2's batch
statistics exist only after the depthwise convolution, so #8, which takes
bn2 as an affine folded before it runs, cannot fuse that tail. A train-mode
forward launches no kernel.

FiLM: ``forward(x, film)`` takes a dict of overrides keyed by the dotted
parameter names of :func:`efficientnet_film_spec` (``bn1.scale``,
``blocks_1_0.bn2.bias``, ...) and applies them for that call only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from orbit_tpu_torch.models.backbones.masked_bn import (BatchStats, Film, MaskedBatchNorm,
                                                       Stats, running_stats)
from orbit_tpu_torch.models.backbones.vit import _lecun_normal_
from orbit_tpu_torch.ops.depthwise import fused_dw_act, tf_same_pads

BN_EPS_TF = 1e-3

# Stage definitions: (block_type, repeats, kernel, stride, exp_ratio, out_chs, se_ratio)
B0_ARCH = [
    ("ds", 1, 3, 1, 1.0, 16, 0.25),
    ("ir", 2, 3, 2, 6.0, 24, 0.25),
    ("ir", 2, 5, 2, 6.0, 40, 0.25),
    ("ir", 3, 3, 2, 6.0, 80, 0.25),
    ("ir", 3, 5, 1, 6.0, 112, 0.25),
    ("ir", 4, 5, 2, 6.0, 192, 0.25),
    ("ir", 1, 3, 1, 6.0, 320, 0.25),
]
V2_S_ARCH = [
    ("cn", 2, 3, 1, 1.0, 24, 0.0),
    ("er", 4, 3, 2, 4.0, 48, 0.0),
    ("er", 4, 3, 2, 4.0, 64, 0.0),
    ("ir", 6, 3, 2, 4.0, 128, 0.25),
    ("ir", 9, 3, 1, 6.0, 160, 0.25),
    ("ir", 15, 3, 2, 6.0, 256, 0.25),
]
STEM_CHS = {"efficientnet_b0": 32, "efficientnet_v2_s": 24}
ARCHS = {"efficientnet_b0": B0_ARCH, "efficientnet_v2_s": V2_S_ARCH}


class Conv(nn.Module):
    """A Flax ``nn.Conv``'s parameters: ``kernel`` (kh, kw, in, out) and an
    optional ``bias`` (out,). ``groups == out`` makes it depthwise, with
    ``kernel`` (kh, kw, 1, C) as Flax's DepthwiseConv stores it."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1,
                 bias: bool = False, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.kernel = nn.Parameter(torch.zeros(k, k, cin // groups, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, g: torch.Generator):
        k, _, cin, _ = self.kernel.shape
        _lecun_normal_(self.kernel.data, k * k * cin, g)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` in the compute dtype -> NHWC, TF-SAME padding."""
        dt = x.dtype
        if self.k == 1 and self.stride == 1 and self.groups == 1:
            y = torch.matmul(x, self.kernel.to(dt).reshape(self.kernel.shape[2:]))
        else:
            _, h, w, _ = x.shape
            ph, pw = tf_same_pads(h, self.k, self.stride), tf_same_pads(w, self.k, self.stride)
            xp = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
            y = F.conv2d(xp, self.kernel.to(dt).permute(3, 2, 0, 1), stride=self.stride,
                         groups=self.groups).permute(0, 2, 3, 1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class SqueezeExcite(nn.Module):
    """SE: global mean -> 1x1 reduce -> SiLU -> 1x1 expand -> sigmoid gate."""

    def __init__(self, chs: int, rd: int):
        super().__init__()
        self.conv_reduce = Conv(1, chs, rd, bias=True)
        self.conv_expand = Conv(1, rd, chs, bias=True)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class ConvBnAct(nn.Module):
    def __init__(self, in_chs, out_chs, k, stride, eps, path):
        super().__init__()
        self.residual = stride == 1 and in_chs == out_chs
        self.conv = Conv(k, in_chs, out_chs, stride)
        self.bn1 = MaskedBatchNorm(out_chs, eps, f"{path}.bn1")

    def forward(self, x, film=None, batch=None):
        y = F.silu(self.bn1(self.conv(x), film, batch))
        return y + x if self.residual else y


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_chs, out_chs, k, stride, se_ratio, eps, path):
        super().__init__()
        self.fused = stride == 1  # the depthwise tail can go through fused_dw_act
        self.residual = stride == 1 and in_chs == out_chs
        self.conv_dw = Conv(k, in_chs, in_chs, stride, groups=in_chs)
        self.bn1 = MaskedBatchNorm(in_chs, eps, f"{path}.bn1")
        self.se = SqueezeExcite(in_chs, max(1, int(in_chs * se_ratio))) if se_ratio > 0 else None
        self.conv_pw = Conv(1, in_chs, out_chs)
        self.bn2 = MaskedBatchNorm(out_chs, eps, f"{path}.bn2")

    def forward(self, x, film=None, impl=None, batch=None):
        shortcut = x
        if self.fused and impl != "composed" and batch is None:
            a1, b1 = self.bn1.fold(film)
            x = fused_dw_act(x, self.conv_dw.kernel, torch.ones_like(a1),
                             torch.zeros_like(b1), a1, b1, act1=False, act2=True,
                             impl=impl)
        else:
            x = F.silu(self.bn1(self.conv_dw(x), film, batch))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x), film, batch)
        return x + shortcut if self.residual else x


class EdgeResidual(nn.Module):
    def __init__(self, in_chs, out_chs, k, stride, exp, eps, path):
        super().__init__()
        mid = int(in_chs * exp)
        self.residual = stride == 1 and in_chs == out_chs
        self.conv_exp = Conv(k, in_chs, mid, stride)
        self.bn1 = MaskedBatchNorm(mid, eps, f"{path}.bn1")
        self.conv_pwl = Conv(1, mid, out_chs)
        self.bn2 = MaskedBatchNorm(out_chs, eps, f"{path}.bn2")

    def forward(self, x, film=None, batch=None):
        y = F.silu(self.bn1(self.conv_exp(x), film, batch))
        y = self.bn2(self.conv_pwl(y), film, batch)
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    def __init__(self, in_chs, out_chs, k, stride, exp, se_ratio, eps, path):
        super().__init__()
        mid = int(in_chs * exp)
        self.fused = stride == 1  # the depthwise tail can go through fused_dw_act
        self.residual = stride == 1 and in_chs == out_chs
        self.conv_pw = Conv(1, in_chs, mid)
        self.bn1 = MaskedBatchNorm(mid, eps, f"{path}.bn1")
        self.conv_dw = Conv(k, mid, mid, stride, groups=mid)
        self.bn2 = MaskedBatchNorm(mid, eps, f"{path}.bn2")
        self.se = SqueezeExcite(mid, max(1, int(in_chs * se_ratio))) if se_ratio > 0 else None
        self.conv_pwl = Conv(1, mid, out_chs)
        self.bn3 = MaskedBatchNorm(out_chs, eps, f"{path}.bn3")

    def forward(self, x, film=None, impl=None, batch=None):
        shortcut = x
        x = self.conv_pw(x)
        if self.fused and impl != "composed" and batch is None:
            x = fused_dw_act(x, self.conv_dw.kernel, *self.bn1.fold(film),
                             *self.bn2.fold(film), act1=True, act2=True, impl=impl)
        else:
            x = F.silu(self.bn1(x, film, batch))
            x = F.silu(self.bn2(self.conv_dw(x), film, batch))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x), film, batch)
        return x + shortcut if self.residual else x


def _make_block(btype, in_chs, k, s, e, c, se, eps, path):
    if btype == "cn":
        return ConvBnAct(in_chs, c, k, s, eps, path)
    if btype == "ds":
        return DepthwiseSeparable(in_chs, c, k, s, se, eps, path)
    if btype == "er":
        return EdgeResidual(in_chs, c, k, s, e, eps, path)
    if btype == "ir":
        return InvertedResidual(in_chs, c, k, s, e, se, eps, path)
    raise ValueError(btype)


# the blocks with a depthwise tail: their forward takes the route ``impl``
DW_BLOCKS = (DepthwiseSeparable, InvertedResidual)


class EfficientNet(nn.Module):
    """Generic EfficientNet trunk; input (N, H, W, 3) normalised frames in
    the compute dtype, output (N, head_chs) f32.

    ``impl`` routes the stride-1 depthwise tails: None (the op, by
    device), "reference" or "autograd" (the op's plain version, with its
    recomputing backward or as plain autograd ops) or "composed" (unfused
    BatchNorms around a grouped conv); ``forward(impl=...)`` overrides it
    for one call. ``forward_calls`` counts forwards (one per
    feature-extraction chunk).

    ``train=True`` runs every BatchNorm on batch statistics over the rows
    that the float (N,) ``mask`` marks real (all rows without one), starting
    from the running statistics ``stats`` (by BatchNorm path; the buffers'
    values if not given), and returns (features, updated statistics); the
    buffers are not written (``masked_bn.load_running_stats``)."""

    def __init__(self, arch: Sequence[Tuple] = tuple(B0_ARCH), stem_chs: int = 32,
                 head_chs: int = 1280, bn_eps: float = BN_EPS_TF, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = Conv(3, 3, stem_chs, stride=2)
        self.bn1 = MaskedBatchNorm(stem_chs, bn_eps, "bn1")
        self.block_names: List[str] = []
        in_chs = stem_chs
        for si, (btype, repeats, k, stride, exp, out_chs, se) in enumerate(arch):
            for bi in range(repeats):
                name = f"blocks_{si}_{bi}"
                self.add_module(name, _make_block(btype, in_chs, k, stride if bi == 0 else 1,
                                                  exp, out_chs, se, bn_eps, name))
                self.block_names.append(name)
                in_chs = out_chs
        self.conv_head = Conv(1, in_chs, head_chs)
        self.bn2 = MaskedBatchNorm(head_chs, bn_eps, "bn2")
        self.impl = None
        self.forward_calls = 0

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        """Flax's initialisers (lecun-normal kernels, zero biases, identity
        BatchNorm), drawn from ``g``."""
        for m in self.modules():
            if isinstance(m, (Conv, MaskedBatchNorm)):
                m.reset_parameters(g)

    def forward(self, x: torch.Tensor, film: Film = None, impl: str | None = None,
                train: bool = False, mask: Optional[torch.Tensor] = None,
                stats: Optional[Stats] = None):
        self.forward_calls += 1
        impl = self.impl if impl is None else impl
        batch = BatchStats(running_stats(self) if stats is None else stats,
                           mask) if train else None
        x = F.silu(self.bn1(self.conv_stem(x.to(self.dtype).contiguous()), film, batch))
        for name in self.block_names:
            block = getattr(self, name)
            x = (block(x, film, impl, batch) if isinstance(block, DW_BLOCKS)
                 else block(x, film, batch))
        x = F.silu(self.bn2(self.conv_head(x), film, batch))
        features = x.mean(dim=(1, 2)).float()
        return (features, batch.new) if train else features


@torch.no_grad()
def calibrate_batchnorm(model: EfficientNet, frames: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and (biased) variance to the
    statistics of its input over ``frames`` (normalised NHWC), in one pass
    in the model's dtype through the composed depthwise route (which calls
    every BatchNorm module). The pass is not counted in ``forward_calls``.

    Random weights drawn with Flax's initialisers (or the fake timm weights
    of the tests) shrink the activations about 8x a block under identity
    BatchNorms, so after 16 blocks every frame maps to the same feature up
    to rounding. Calibrated, each BatchNorm normalises its input as a
    trained network's does, the features keep their dependence on the
    input, and the heads' comparisons mean something. For ``chip_smoke.py``
    and the parity tests; the main path never calls it."""
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]

    def set_stats(bn, args):
        x = args[0].float()
        bn.mean.copy_(x.mean(dim=(0, 1, 2)))
        bn.var.copy_(x.var(dim=(0, 1, 2), unbiased=False))

    hooks = [bn.register_forward_pre_hook(set_stats) for bn in bns]
    try:
        model(frames, impl="composed")
    finally:
        model.forward_calls -= 1
        for h in hooks:
            h.remove()


def efficientnet_film_spec(arch: Sequence[Tuple],
                           stem: int) -> List[Tuple[Tuple[str, ...], int]]:
    """FiLM-able BN scale/bias leaves (reference: model/film.py:38-56): the
    root bn1 (stem) and bn2 (head), ConvBnAct bn1, EdgeResidual bn1 and
    InvertedResidual bn2, on their widths; DepthwiseSeparable blocks are not
    tagged."""
    spec: List[Tuple[Tuple[str, ...], int]] = []

    def add(prefix: Tuple[str, ...], size: int):
        spec.append((prefix + ("scale",), size))
        spec.append((prefix + ("bias",), size))

    add(("bn1",), stem)
    add(("bn2",), 1280)
    in_chs = stem
    for si, (btype, repeats, k, stride, exp, out_chs, se) in enumerate(arch):
        for bi in range(repeats):
            if btype == "cn":
                add((f"blocks_{si}_{bi}", "bn1"), out_chs)
            elif btype == "er":
                add((f"blocks_{si}_{bi}", "bn1"), int(in_chs * exp))
            elif btype == "ir":
                add((f"blocks_{si}_{bi}", "bn2"), int(in_chs * exp))
            in_chs = out_chs
    return spec


def create_efficientnet(name: str, dtype=torch.float32):
    """name -> (module, output size, FiLM spec), parameters not yet
    initialised."""
    if name not in ARCHS:
        raise ValueError(f"Unknown EfficientNet variant: {name}")
    module = EfficientNet(arch=tuple(ARCHS[name]), stem_chs=STEM_CHS[name],
                          head_chs=1280, dtype=dtype)
    return module, 1280, efficientnet_film_spec(ARCHS[name], STEM_CHS[name])
