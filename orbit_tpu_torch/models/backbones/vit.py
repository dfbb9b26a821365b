"""Vision Transformers (ViT-S/32, ViT-B/32, ViT-B/32-CLIP) in PyTorch, NHWC.

Counterpart of ``orbit_tpu/models/backbones/vit.py`` (timm layout:
reference model/feature_extractors.py:49-64). Parameters keep the Flax
names and layouts, so :mod:`orbit_tpu_torch.models.convert` is a renaming:
Dense kernels are (in, out), the patch embedding is the Flax conv kernel
(32, 32, 3, D), LayerNorms hold ``scale``/``bias``.

The forward copies the JAX module's casts: every op sees ``x`` cast to the
compute dtype; LayerNorms compute in f32 and round to it; ``proj`` is a
dtype matmul plus a dtype bias, like ``nn.Dense(dtype=...)``. Each encoder
layer runs the two kernel ops, :func:`fused_qkv_attention` (kernel A) and
:func:`fused_mlp_block` (kernel B), whose backward kernels run when
autograd records. The class token after the final norm comes out as f32.

FiLM (orbit_tpu vit.py:171-198, reference model/film.py:57-66):
``forward(x, film)`` takes a dict of overrides keyed by the dotted
parameter names of :func:`vit_film_spec` (``blocks.3.norm1.scale``,
``norm.bias``, ...) for that call only: norm1's values go into the
LayerNorm before kernel A, norm2's into kernel B as ``ln_scale`` and
``ln_bias`` (whose backward kernel #6 returns their gradients), the final
norm's into the last LayerNorm. Each value is rounded to its parameter's
dtype first, as ``orbit_tpu.models.film.apply_film`` casts a value to its
leaf's dtype. CLIP's ``norm_pre`` is not tagged, as in the JAX spec.

Parameters are trainable f32 masters, as Flax keeps them: under bf16
compute the casts sit inside the forward, so the gradients arrive in f32.
Eval may store them in bf16 (``precision.cast_extractor_params``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from orbit_tpu_torch.models.backbones.masked_bn import Film
from orbit_tpu_torch.ops.mlp_block import fused_mlp_block
from orbit_tpu_torch.ops.tiny_attention import fused_qkv_attention

VIT_CONFIGS = {
    # name: (dim, depth, heads, pre_norm, ln_eps)   (orbit_tpu vit.py:188-199)
    "vit_s_32": (384, 12, 6, False, 1e-6),
    "vit_b_32": (768, 12, 12, False, 1e-6),
    "vit_b_32_clip": (768, 12, 12, True, 1e-5),
}


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax lecun_normal: truncated normal on [-2, 2] std units, variance
    # 1/fan_in after truncation (0.8796... is the truncated std of N(0,1))
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=g)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class DenseParams(nn.Module):
    """``kernel`` (in, out) and ``bias`` (out,), as Flax's Dense stores them."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kernel = _param(in_dim, features)
        self.bias = _param(features)

    def reset_parameters(self, g: torch.Generator):
        _lecun_normal_(self.kernel.data, self.kernel.shape[0], g)
        self.bias.data.zero_()


class ConvParams(nn.Module):
    """``kernel`` (kh, kw, in, out) and ``bias`` (out,), as Flax's Conv
    stores them."""

    def __init__(self, kh: int, kw: int, in_dim: int, features: int):
        super().__init__()
        self.kernel = _param(kh, kw, in_dim, features)
        self.bias = _param(features)

    def reset_parameters(self, g: torch.Generator):
        kh, kw, cin, _ = self.kernel.shape
        _lecun_normal_(self.kernel.data, kh * kw * cin, g)
        self.bias.data.zero_()


class LnParams(nn.Module):
    """``scale`` and ``bias`` (dim,), as Flax's LayerNorm stores them;
    ``path`` is the module's dotted name in the extractor, the prefix of
    its FiLM keys (set by :class:`ViT`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = _param(dim)
        self.bias = _param(dim)
        self.path = ""

    def reset_parameters(self, g: torch.Generator = None):
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def affine(self, film: Film = None):
        """(scale, bias) with the FiLM overrides applied, each in its
        parameter's dtype."""
        if not film:
            return self.scale, self.bias
        return (film.get(f"{self.path}.scale", self.scale).to(self.scale.dtype),
                film.get(f"{self.path}.bias", self.bias).to(self.bias.dtype))

    def forward(self, x: torch.Tensor, eps: float, dtype, film: Film = None) -> torch.Tensor:
        """f32 statistics and affine (Flax promotes to f32), rounded to dtype."""
        scale, bias = self.affine(film)
        return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                            eps).to(dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = DenseParams(dim, 3 * dim)
        self.proj = DenseParams(dim, dim)

    def forward(self, x: torch.Tensor, dtype, impl=None) -> torch.Tensor:
        out = fused_qkv_attention(x.to(dtype), self.qkv.kernel, self.qkv.bias,
                                  self.num_heads, impl=impl)
        return (torch.matmul(out, self.proj.kernel.to(dtype))
                + self.proj.bias.to(dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = DenseParams(dim, hidden)
        self.fc2 = DenseParams(hidden, dim)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, ln_eps: float):
        super().__init__()
        self.ln_eps = ln_eps
        self.norm1 = LnParams(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LnParams(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype, impl=None, film: Film = None) -> torch.Tensor:
        h = self.norm1(x, self.ln_eps, dtype, film)
        x = x + self.attn(h, dtype, impl)
        return fused_mlp_block(
            x.to(dtype), *self.norm2.affine(film),
            self.mlp.fc1.kernel, self.mlp.fc1.bias,
            self.mlp.fc2.kernel, self.mlp.fc2.bias, ln_eps=self.ln_eps,
            impl=impl)


class ViT(nn.Module):
    """Patch-embedding ViT with class-token pooling; input (N, H, W, 3)
    normalised frames, output (N, D) f32 class-token features.

    ``frame_size`` sets the number of patches in ``pos_embed`` (49 at
    224 px, 4 at 84 px: the valid 32-px patches), as the Flax module sizes
    it at init. ``forward_calls`` counts forwards (one per
    feature-extraction chunk). ``forward(x, film)`` applies FiLM
    overrides (module docstring)."""

    def __init__(self, *, patch_size: int = 32, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 pre_norm: bool = False, ln_eps: float = 1e-6,
                 frame_size: int = 224, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.ln_eps, self.dtype, self.pre_norm = ln_eps, dtype, pre_norm
        grid = frame_size // patch_size
        self.patch_embed = ConvParams(patch_size, patch_size, 3, dim)
        self.cls_token = _param(1, 1, dim)
        self.pos_embed = _param(1, grid * grid + 1, dim)
        if pre_norm:
            self.norm_pre = LnParams(dim)
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, num_heads, mlp_ratio, ln_eps) for _ in range(depth))
        self.norm = LnParams(dim)
        self.impl = None  # kernel-op impl: None (by device), "reference" or "autograd"
        self.forward_calls = 0
        for name, module in self.named_modules():
            if isinstance(module, LnParams):
                module.path = name

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        """Flax's initialisers (lecun-normal kernels, zero biases and class
        token, N(0, 0.02) position embedding), drawn from ``g``."""
        for m in self.modules():
            if isinstance(m, (DenseParams, ConvParams, LnParams)):
                m.reset_parameters(g)
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=g)

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, P, p*p*C) in the Flax kernel's (kh, kw, c)
        order; a VALID conv drops the right/bottom remainder."""
        n, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p]
        x = x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, gh * gw, p * p * c)

    def forward(self, x: torch.Tensor, film: Film = None) -> torch.Tensor:
        self.forward_calls += 1
        dt = self.dtype
        n = x.shape[0]
        # patch embedding as unfold + matmul against the Flax conv kernel
        # seen as (p*p*3, D): a plain matmul, so cuDNN's TF32 convolutions
        # never enter
        x = (torch.matmul(self._patchify(x.to(dt)),
                          self.patch_embed.kernel.to(dt).reshape(-1, self.dim))
             + self.patch_embed.bias.to(dt))
        cls = self.cls_token.to(dt).expand(n, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if self.pre_norm:
            x = self.norm_pre(x, self.ln_eps, dt)
        for block in self.blocks:
            x = block(x, dt, self.impl, film)
        x = self.norm(x, self.ln_eps, dt, film)
        return x[:, 0].float()


def vit_film_spec(depth: int, dim: int):
    """FiLM-able LayerNorm scale/bias leaves (orbit_tpu vit.py:171-186):
    each block's norm1 and norm2 and the final norm; ``norm_pre`` (CLIP) is
    not tagged. The paths are the port's parameter names
    (``("blocks", "3", "norm1", "scale")``), the JAX spec's
    ``("blocks_3", "norm1", "scale")`` with the block index a module of its
    own; both sort in the same order and give the FiLM generator the same
    leaf tags (``blocks_3_norm1_scale``)."""
    spec = []
    for i in range(depth):
        for ln in ("norm1", "norm2"):
            spec += [(("blocks", str(i), ln, "scale"), dim),
                     (("blocks", str(i), ln, "bias"), dim)]
    return spec + [(("norm", "scale"), dim), (("norm", "bias"), dim)]


def create_vit(name: str, frame_size: int = 224, dtype=torch.float32):
    """name -> (module, output size, FiLM spec), parameters not yet
    initialised."""
    if name not in VIT_CONFIGS:
        raise ValueError(f"Unknown ViT variant: {name}")
    dim, depth, heads, pre_norm, eps = VIT_CONFIGS[name]
    module = ViT(patch_size=32, dim=dim, depth=depth, num_heads=heads,
                 pre_norm=pre_norm, ln_eps=eps, frame_size=frame_size,
                 dtype=dtype)
    return module, dim, vit_film_spec(depth, dim)
