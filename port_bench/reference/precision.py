"""The reference's numeric mode: true float32 (TF32 off for cuBLAS and
cuDNN), or TF32 for the control, the nearest precision below float32."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """Run the block with TF32 matmuls and convolutions on (the control) or
    off (the reference), and restore the settings after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
