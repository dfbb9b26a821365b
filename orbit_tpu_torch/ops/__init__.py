"""Kernel ops of the port, each beside its plain PyTorch version."""
from orbit_tpu_torch.ops.mlp_block import fused_mlp_block, mlp_block_reference
from orbit_tpu_torch.ops.tiny_attention import (fused_qkv_attention,
                                                qkv_attention_reference)

__all__ = ["fused_mlp_block", "mlp_block_reference", "fused_qkv_attention",
           "qkv_attention_reference"]
