"""Kernel ops of the port, each beside its plain PyTorch version."""
from orbit_tpu_torch.ops.depthwise import fused_dw_act, fused_dw_reference
from orbit_tpu_torch.ops.mahalanobis import mahalanobis_logits, mahalanobis_reference
from orbit_tpu_torch.ops.mlp_block import (fused_mlp_block, fused_mlp_block_backward,
                                           mlp_block_backward_reference,
                                           mlp_block_reference)
# the raw-qkv attention op itself stays ``ops.tiny_attention.tiny_attention``:
# a package attribute of that name would hide the module
from orbit_tpu_torch.ops.tiny_attention import (attention_backward_reference,
                                                attention_reference, fused_qkv_attention,
                                                fused_qkv_attention_backward,
                                                qkv_attention_backward_reference,
                                                qkv_attention_reference)

__all__ = ["fused_dw_act", "fused_dw_reference", "mahalanobis_logits",
           "mahalanobis_reference", "fused_mlp_block", "fused_mlp_block_backward",
           "mlp_block_backward_reference", "mlp_block_reference", "fused_qkv_attention",
           "fused_qkv_attention_backward", "qkv_attention_backward_reference",
           "qkv_attention_reference", "attention_reference",
           "attention_backward_reference"]
