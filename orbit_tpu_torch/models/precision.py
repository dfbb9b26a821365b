"""Numeric policy of the port (counterpart of ``orbit_tpu/models/precision.py``
and ``orbit_tpu/learners/single_step.py:349-353``).

- f32 matmuls are true f32: TF32 is off for cuBLAS and cuDNN, and bf16
  GEMMs may not reduce in reduced precision. The heads compute in f32 and
  must not silently drop to TF32 (CLAUDE.md "Design invariants").
- Under ``--compute_dtype bfloat16`` every floating extractor parameter is
  stored in bf16, as the JAX package casts its extractor leaves, except the
  BatchNorm scale and bias, which stay f32 (orbit_tpu/models/precision.py:
  29-47): the eval affine is folded in f32, and the FiLM overrides and the
  fused depthwise op's affines depend on that. The running statistics are
  buffers and stay f32 too. The ViT's LayerNorm and bias vectors are upcast
  to f32 where they are used (kernel B receives them in f32, as orbit_tpu
  mlp_block.py:145-147 does).
"""
from __future__ import annotations

import torch

from orbit_tpu_torch.models.backbones.masked_bn import MaskedBatchNorm


def configure_matmul_precision() -> None:
    """True-f32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def compute_dtype(name: str) -> torch.dtype:
    """``--compute_dtype`` value -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@torch.no_grad()
def cast_extractor_params(extractor: torch.nn.Module,
                          dtype=torch.bfloat16) -> torch.nn.Module:
    """Store every floating parameter of ``extractor`` in ``dtype`` (in
    place), except the BatchNorm scale and bias, which stay f32; buffers
    (the BatchNorm running statistics) are not touched."""
    configure_matmul_precision()
    for module in extractor.modules():
        if isinstance(module, MaskedBatchNorm):
            continue
        for p in module.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return extractor
