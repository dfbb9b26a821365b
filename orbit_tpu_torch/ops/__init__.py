"""Kernel ops of the port, each beside its plain PyTorch version."""
from orbit_tpu_torch.ops.mlp_block import (fused_mlp_block, fused_mlp_block_backward,
                                           mlp_block_backward_reference,
                                           mlp_block_reference)
from orbit_tpu_torch.ops.tiny_attention import (fused_qkv_attention,
                                                fused_qkv_attention_backward,
                                                qkv_attention_backward_reference,
                                                qkv_attention_reference)

__all__ = ["fused_mlp_block", "fused_mlp_block_backward", "mlp_block_backward_reference",
           "mlp_block_reference", "fused_qkv_attention", "fused_qkv_attention_backward",
           "qkv_attention_backward_reference", "qkv_attention_reference"]
