"""Mahalanobis logits of the SimpleCNAPs head (TPU kernel #7) and their plain
PyTorch version:
``logits[m, c] = -logit_scale * (f_m - mu_c)^T P_c (f_m - mu_c)``, with
-1e30 on padded classes.

Counterpart of ``orbit_tpu/ops/mahalanobis.py::mahalanobis_logits``:
features (M, D), means (C, D), precisions (C, D, D), class_mask (C,) or
None; everything is f32 (the heads never compute in the backbone's dtype).

Dispatch: a CUDA tensor launches the hand-written kernel
(``csrc/mahalanobis.cu``, f32 FMA, no TF32) or raises; a CPU tensor takes
the plain version (:func:`mahalanobis_reference`, the JAX package's einsum
form, orbit_tpu/ops/mahalanobis.py:172-176). ``impl="reference"`` forces
the plain version and is meant for the tests and ``chip_smoke.py`` only.

Gradients: when autograd records, the op runs as a
``torch.autograd.Function`` that saves its inputs; its backward recomputes
:func:`mahalanobis_reference` from them under autograd, as the JAX
package's training path differentiates its einsum (:172-178); there is no
backward kernel. Padded classes get zero gradient (the ``torch.where``).
"""
from __future__ import annotations

from typing import Optional

import torch

from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.kernels import plans

NEG_INF = -1e30


def _check_shapes(features, means, precisions) -> None:
    m, d = features.shape
    c = means.shape[0]
    if means.shape != (c, d) or precisions.shape != (c, d, d):
        raise ValueError(f"Mahalanobis shapes do not match: features {tuple(features.shape)}, "
                         f"means {tuple(means.shape)}, precisions {tuple(precisions.shape)}")


def mahalanobis_reference(features, means, precisions,
                          class_mask: Optional[torch.Tensor] = None,
                          logit_scale: float = 1.0) -> torch.Tensor:
    """Plain version: the (M, C, D) differences, their products with the
    precisions and the row dots, all f32."""
    _check_shapes(features, means, precisions)
    f = features.float()
    diff = means.float()[None, :, :] - f[:, None, :]
    half = torch.einsum("mcd,cde->mce", diff, precisions.float())
    logits = -torch.einsum("mce,mce->mc", half, diff) * logit_scale
    if class_mask is None:
        return logits
    return torch.where(class_mask.bool()[None, :], logits, torch.full_like(logits, NEG_INF))


def _launch(features, means, precisions, class_mask, logit_scale: float) -> torch.Tensor:
    m, d = features.shape
    c = means.shape[0]
    if m == 0 or c > 65535 or d % 4:
        raise ValueError(f"mahalanobis_logits kernel needs M >= 1, C <= 65535 and D a "
                         f"multiple of 4, got M={m}, C={c}, D={d}")
    if class_mask is None:
        class_mask = torch.ones((c,), device=features.device)
    for t in (means, precisions, class_mask):
        if t.device != features.device:
            raise ValueError(f"mahalanobis_logits: tensors on {t.device} and "
                             f"{features.device}")
    # 16-byte aligned rows for the kernel's vector loads
    f, mu, p, mask = (kbuild.aligned(t.float(), 16) for t in
                      (features, means, precisions, class_mask))
    n_parts, _, _ = plans.maha_grid(m, d, c)
    partial = torch.empty((c, n_parts, m), device=f.device, dtype=torch.float32)
    out = torch.empty((m, c), device=f.device, dtype=torch.float32)
    lib = kbuild.library()
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        code = lib.orbit_mahalanobis_logits(f.data_ptr(), mu.data_ptr(), p.data_ptr(),
                                            mask.data_ptr(), partial.data_ptr(),
                                            out.data_ptr(), m, d, c, plans.maha_splits(m, d),
                                            float(logit_scale), stream)
    kbuild.check(code, "mahalanobis_logits")
    kbuild.LAUNCHES["mahalanobis_logits"] += 1
    return out


def _forward(features, means, precisions, class_mask, logit_scale, impl):
    if impl is not None and impl != "reference":
        raise ValueError(f"unknown impl {impl!r} (None or 'reference')")
    if impl == "reference" or features.device.type == "cpu":
        return mahalanobis_reference(features, means, precisions, class_mask, logit_scale)
    if features.device.type != "cuda":
        raise ValueError(f"mahalanobis_logits kernel needs a CUDA tensor, got "
                         f"{features.device}")
    return _launch(features, means, precisions, class_mask, logit_scale)


class _MahalanobisLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, means, precisions, class_mask, logit_scale, impl):
        ctx.save_for_backward(features, means, precisions, class_mask)
        ctx.logit_scale = logit_scale
        return _forward(features, means, precisions, class_mask, logit_scale, impl)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needed = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved[:3], needed)]
            logits = mahalanobis_reference(*inputs, saved[3], ctx.logit_scale)
            wanted = [t for t, n in zip(inputs, needed) if n]
            grads = iter(torch.autograd.grad(logits, wanted, g.float()))
        return (*(next(grads) if n else None for n in needed), None, None, None)


def mahalanobis_logits(features: torch.Tensor, means: torch.Tensor,
                       precisions: torch.Tensor,
                       class_mask: Optional[torch.Tensor] = None,
                       logit_scale: float = 1.0,
                       impl: str | None = None) -> torch.Tensor:
    """(M, D) features against (C, D)/(C, D, D) class statistics -> (M, C)
    f32 logits, differentiable in features, means and precisions.

    impl: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor) or "reference" (the plain version on any device)."""
    _check_shapes(features, means, precisions)
    inputs = (features, means, precisions)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _MahalanobisLogits.apply(*inputs, class_mask, logit_scale, impl)
    return _forward(*inputs, class_mask, logit_scale, impl)
