"""The benchmark's plain reference: what decides ``correct``.

Plain PyTorch, float32, with TF32 off for matmuls and cuDNN unless a caller
asks for the control (``precision.tf32(True)``). It imports neither JAX nor
the JAX package nor anything of ``orbit_tpu_torch``: the models are a
frozen copy of the port's plain model code (the timm architectures in the
port's Flax parameter names and layouts, so one weight dictionary loads
into both), written with ordinary torch operations and no kernel.

- ``models``: ViT-B/32 and EfficientNet-B0 (eval BatchNorm, FiLM
  overrides), the DeepSets set encoder, the FiLM generator, the recogniser
  that holds them.
- ``heads``: ProtoNets and SimpleCNAPs (Mahalanobis) heads, masked
  cross-entropy.
- ``protocol``: one CLU-VE task personalised and predicted.
- ``lite``: LITE meta-training steps and Adam updates.
"""
