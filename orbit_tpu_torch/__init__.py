"""orbit_tpu_torch — PyTorch + CUDA port of ``orbit_tpu`` for one NVIDIA H100.

The JAX package ``orbit_tpu`` stays the reference; this package is held
against it by the ``tests/test_torch_*.py`` parity tests. Ported so far: the
CLU-VE test path of the single-step learner on the ViT backbones with the
``proto`` and ``proto_cosine`` heads.

Subpackages
-----------
- ``orbit_tpu_torch.kernels`` — nvcc build + ctypes loading of ``csrc/*.cu``.
- ``orbit_tpu_torch.ops``     — the kernel ops, each beside its plain PyTorch
  version (used for CPU tensors and as the kernel's reference).
- ``orbit_tpu_torch.models``  — ViT backbones, poolers, heads, precision
  policy, JAX-parameter conversion, the single-step recogniser.
- ``orbit_tpu_torch.learners`` — eval functions and the test-mode learner.

Importing the package has no side effects: kernels build on first launch.
"""

__version__ = "0.1.0"
