"""Plain float32 models of the benchmark's reference, built from a
configuration's ``architecture`` (a frozen copy of the port's plain model
code: timm's ViT and TF EfficientNet in the Flax names and layouts the port
keeps, so ``Recogniser.state_dict()`` has the port recogniser's keys and
shapes).

Layouts: Dense kernels (in, out); conv kernels (kh, kw, in, out);
depthwise taps (K, K, 1, C); LayerNorm and BatchNorm ``scale``/``bias``,
BatchNorm ``mean``/``var`` buffers. Frames are NHWC.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Film = Optional[Dict[str, torch.Tensor]]
SET_ENCODER_SIZE = 64


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel, self.bias = _p(cin, cout), _p(cout)

    def forward(self, x):
        return x @ self.kernel + self.bias


class Norm(nn.Module):
    """``scale`` and ``bias`` of a LayerNorm; ``path`` is its FiLM key prefix."""

    def __init__(self, dim: int, path: str = ""):
        super().__init__()
        self.scale, self.bias = _p(dim), _p(dim)
        self.path = path

    def affine(self, film: Film):
        if not film:
            return self.scale, self.bias
        return (film.get(f"{self.path}.scale", self.scale),
                film.get(f"{self.path}.bias", self.bias))

    def forward(self, x, eps: float, film: Film = None):
        scale, bias = self.affine(film)
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


# ------------------------------------------------------------------ ViT ----
class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = Dense(dim, 3 * dim), Dense(dim, dim)

    def forward(self, x):
        n, s, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).view(n, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        return self.proj((p @ v).transpose(1, 2).reshape(n, s, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, hidden), Dense(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, eps: float, path: str):
        super().__init__()
        self.eps = eps
        self.norm1 = Norm(dim, f"{path}.norm1")
        self.attn = Attention(dim, heads)
        self.norm2 = Norm(dim, f"{path}.norm2")
        self.mlp = Mlp(dim, hidden)

    def forward(self, x, film: Film = None):
        x = x + self.attn(self.norm1(x, self.eps, film))
        h = F.gelu(self.mlp.fc1(self.norm2(x, self.eps, film)))  # exact erf GELU
        return x + self.mlp.fc2(h)


class ViT(nn.Module):
    """Class-token ViT: (N, H, W, 3) normalised frames -> (N, D)."""

    def __init__(self, a: dict):
        super().__init__()
        d, self.patch, self.eps = a["hidden_size"], a["patch_size"], a["layer_norm_eps"]
        grid = a["image_size"] // self.patch
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = _p(self.patch, self.patch, 3, d)
        self.patch_embed.bias = _p(d)
        self.cls_token = _p(1, 1, d)
        self.pos_embed = _p(1, grid * grid + 1, d)
        self.blocks = nn.ModuleList(
            Block(d, a["num_attention_heads"], a["intermediate_size"], self.eps, f"blocks.{i}")
            for i in range(a["num_hidden_layers"]))
        self.norm = Norm(d, "norm")

    def forward(self, x, film: Film = None):
        n, h, w, c = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p].reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, gh * gw, p * p * c) @ self.patch_embed.kernel.reshape(p * p * c, -1)
        x = x + self.patch_embed.bias
        x = torch.cat([self.cls_token.expand(n, 1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x, film)
        return self.norm(x, self.eps, film)[:, 0]


def vit_film_spec(a: dict) -> List[Tuple[str, int]]:
    d = a["hidden_size"]
    spec = [(f"blocks.{i}.{ln}.{leaf}", d) for i in range(a["num_hidden_layers"])
            for ln in ("norm1", "norm2") for leaf in ("scale", "bias")]
    return spec + [("norm.scale", d), ("norm.bias", d)]


# --------------------------------------------------------- EfficientNet ----
def tf_same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


class Conv(nn.Module):
    """TF-SAME convolution on NHWC; ``groups == cout`` is depthwise."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1, bias: bool = False,
                 groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.kernel = _p(k, k, cin // groups, cout)
        self.bias = _p(cout) if bias else None

    def forward(self, x):
        _, h, w, _ = x.shape
        ph, pw = tf_same_pads(h, self.k, self.stride), tf_same_pads(w, self.k, self.stride)
        xp = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xp, self.kernel.permute(3, 2, 0, 1), self.bias, stride=self.stride,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Eval BatchNorm on the running statistics, FiLM overriding scale and
    bias."""

    def __init__(self, c: int, eps: float, path: str):
        super().__init__()
        self.eps, self.path = eps, path
        self.scale, self.bias = _p(c), _p(c)
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, film: Film = None):
        scale = film.get(f"{self.path}.scale", self.scale) if film else self.scale
        bias = film.get(f"{self.path}.bias", self.bias) if film else self.bias
        a = scale * torch.rsqrt(self.var + self.eps)
        return x * a + (bias - self.mean * a)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, rd: int):
        super().__init__()
        self.conv_reduce = Conv(1, c, rd, bias=True)
        self.conv_expand = Conv(1, rd, c, bias=True)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))


class DepthwiseSeparable(nn.Module):
    def __init__(self, cin, cout, k, stride, se, eps, path):
        super().__init__()
        self.residual = stride == 1 and cin == cout
        self.conv_dw = Conv(k, cin, cin, stride, groups=cin)
        self.bn1 = BatchNorm(cin, eps, f"{path}.bn1")
        self.se = SqueezeExcite(cin, max(1, int(cin * se))) if se > 0 else None
        self.conv_pw = Conv(1, cin, cout)
        self.bn2 = BatchNorm(cout, eps, f"{path}.bn2")

    def forward(self, x, film):
        y = F.silu(self.bn1(self.conv_dw(x), film))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pw(y), film)
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, k, stride, exp, se, eps, path):
        super().__init__()
        mid = int(cin * exp)
        self.residual = stride == 1 and cin == cout
        self.conv_pw = Conv(1, cin, mid)
        self.bn1 = BatchNorm(mid, eps, f"{path}.bn1")
        self.conv_dw = Conv(k, mid, mid, stride, groups=mid)
        self.bn2 = BatchNorm(mid, eps, f"{path}.bn2")
        self.se = SqueezeExcite(mid, max(1, int(cin * se))) if se > 0 else None
        self.conv_pwl = Conv(1, mid, cout)
        self.bn3 = BatchNorm(cout, eps, f"{path}.bn3")

    def forward(self, x, film):
        y = F.silu(self.bn1(self.conv_pw(x), film))
        y = F.silu(self.bn2(self.conv_dw(y), film))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y), film)
        return y + x if self.residual else y


BLOCKS = {"ds": DepthwiseSeparable, "ir": InvertedResidual}


class EfficientNet(nn.Module):
    """(N, H, W, 3) normalised frames -> (N, head) features; ``arch`` rows
    are (block type, repeats, kernel, stride, expansion, out channels, SE
    ratio)."""

    def __init__(self, a: dict):
        super().__init__()
        eps, cin = a["bn_eps"], a["stem_channels"]
        self.conv_stem = Conv(3, 3, cin, stride=2)
        self.bn1 = BatchNorm(cin, eps, "bn1")
        self.block_names = []
        for si, (btype, repeats, k, stride, exp, cout, se) in enumerate(a["arch"]):
            for bi in range(repeats):
                name = f"blocks_{si}_{bi}"
                s = stride if bi == 0 else 1
                block = (DepthwiseSeparable(cin, cout, k, s, se, eps, name) if btype == "ds"
                         else InvertedResidual(cin, cout, k, s, exp, se, eps, name))
                self.add_module(name, block)
                self.block_names.append(name)
                cin = cout
        self.conv_head = Conv(1, cin, a["head_channels"])
        self.bn2 = BatchNorm(a["head_channels"], eps, "bn2")

    def forward(self, x, film: Film = None):
        x = F.silu(self.bn1(self.conv_stem(x), film))
        for name in self.block_names:
            x = getattr(self, name)(x, film)
        return F.silu(self.bn2(self.conv_head(x), film)).mean(dim=(1, 2))


def efficientnet_film_spec(a: dict) -> List[Tuple[str, int]]:
    """The FiLM leaves: the stem's and the head's BatchNorms and every
    inverted-residual block's bn2 (the depthwise BatchNorm)."""
    spec = [("bn1.scale", a["stem_channels"]), ("bn1.bias", a["stem_channels"]),
            ("bn2.scale", a["head_channels"]), ("bn2.bias", a["head_channels"])]
    cin = a["stem_channels"]
    for si, (btype, repeats, _, _, exp, cout, _) in enumerate(a["arch"]):
        for bi in range(repeats):
            if btype == "ir":
                mid = int(cin * exp)
                spec += [(f"blocks_{si}_{bi}.bn2.scale", mid), (f"blocks_{si}_{bi}.bn2.bias", mid)]
            cin = cout
    return spec


@torch.no_grad()
def calibrate_batchnorm(model: EfficientNet, frames: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and biased variance to those of
    its input over ``frames``, in one forward: random weights with identity
    BatchNorms shrink the activations block by block until every frame
    maps to the same feature, and calibrated statistics keep them apart."""
    def set_stats(bn, args):
        x = args[0]
        bn.mean.copy_(x.mean(dim=(0, 1, 2)))
        bn.var.copy_(x.var(dim=(0, 1, 2), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        model(frames)
    finally:
        for h in hooks:
            h.remove()


# ------------------------------------------------- set encoder and FiLM ----
class SetEncoder(nn.Module):
    """5 x [conv3x3-64, frozen BatchNorm at (0, 1) statistics, ReLU,
    maxpool 2] -> global mean: (N, H, W, 3) -> (N, 64)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i in range(1, 6):
            conv = nn.Module()
            conv.kernel, conv.bias = _p(3, 3, cin, SET_ENCODER_SIZE), _p(SET_ENCODER_SIZE)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"norm{i}", Norm(SET_ENCODER_SIZE))
            cin = SET_ENCODER_SIZE

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(1, 6):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            x = F.conv2d(x, conv.kernel.permute(3, 2, 0, 1), conv.bias, padding=1)
            x = F.relu(x * (norm.scale / math.sqrt(1.0 + 1e-5))[:, None, None]
                       + norm.bias[:, None, None])
            x = F.max_pool2d(x, 2, 2)
        return x.mean(dim=(2, 3))


class DenseBlock(nn.Module):
    """Linear -> Flax LayerNorm (one-pass variance, eps 1e-6) -> ReLU -> Linear."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1, self.ln, self.fc2 = Dense(cin, hidden), Norm(hidden), Dense(hidden, cout)

    def forward(self, x):
        h = self.fc1(x)
        mean = h.mean(dim=-1, keepdim=True)
        var = torch.clamp((h * h).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        h = (h - mean) * (torch.rsqrt(var + 1e-6) * self.ln.scale) + self.ln.bias
        return self.fc2(torch.relu(h))


class FilmGenerator(nn.Module):
    """One DenseBlock and one regulariser a FiLM leaf, in sorted leaf order:
    scale leaves get ``g * reg + 1`` (multiplied into the initial value),
    bias leaves ``g * reg`` (added)."""

    def __init__(self, spec: Sequence[Tuple[str, int]]):
        super().__init__()
        sizes = dict(spec)
        self.names = sorted(sizes)
        for name in self.names:
            tag = name.replace(".", "_")
            self.add_module(f"gen__{tag}", DenseBlock(SET_ENCODER_SIZE, 64, sizes[name]))
            self.register_parameter(f"reg__{tag}", _p(sizes[name]))

    def forward(self, embedding, initial: Dict[str, torch.Tensor]):
        film, l2 = {}, torch.zeros((), device=embedding.device)
        for name in self.names:
            tag = name.replace(".", "_")
            reg = getattr(self, f"reg__{tag}")
            g = getattr(self, f"gen__{tag}")(embedding.reshape(1, -1)).reshape(-1)
            film[name] = (initial[name] * (g * reg + 1.0) if name.endswith(".scale")
                          else initial[name] + g * reg)
            l2 = l2 + (reg ** 2).sum()
        return film, l2


# ------------------------------------------------------------ recogniser ----
class Recogniser(nn.Module):
    """Extractor, and with ``adapt_features`` the set encoder and the FiLM
    generator, under the port recogniser's parameter names."""

    def __init__(self, a: dict):
        super().__init__()
        self.a = a
        if a["backbone"] == "vit":
            self.extractor, spec = ViT(a), vit_film_spec(a)
        else:
            self.extractor, spec = EfficientNet(a), efficientnet_film_spec(a)
        self.adapt = bool(a.get("adapt_features"))
        if self.adapt:
            self.set_encoder = SetEncoder()
            self.film_generator = FilmGenerator(spec)
        self.register_buffer("pixel_mean", torch.tensor(a["pixel_mean"]), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(a["pixel_std"]), persistent=False)

    def normalise(self, frames: torch.Tensor) -> torch.Tensor:
        return (frames.float() / 255.0 - self.pixel_mean) / self.pixel_std

    def embed(self, frames: torch.Tensor, film: Film = None, block: int = 256) -> torch.Tensor:
        """uint8 (N, H, W, 3) -> (N, D) features, ``block`` frames at a time."""
        return torch.cat([self.extractor(self.normalise(frames[i:i + block]), film)
                          for i in range(0, frames.shape[0], block)])

    def film(self, context: torch.Tensor, block: int = 256):
        """FiLM values and their regulariser term from the context frames
        (the real ones only)."""
        reps = torch.cat([self.set_encoder(self.normalise(context[i:i + block]))
                          for i in range(0, context.shape[0], block)])
        params = dict(self.extractor.named_parameters())
        return self.film_generator(reps.mean(dim=0), {n: params[n] for n in
                                                      self.film_generator.names})
