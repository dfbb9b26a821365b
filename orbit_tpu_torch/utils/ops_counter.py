"""MACs / params accounting of the port (counterpart of
``orbit_tpu/utils/ops_counter.py``; reference: utils/ops_counter.py:10-94).

The JAX package reads the FLOPs of a lowered XLA program. Here
``torch.utils.flop_counter.FlopCounterMode`` counts them while the function
runs on a **meta** copy of the model (:func:`meta_copy`) with meta inputs:
nothing is computed, nothing is allocated on the card, and the count is
taken at the shapes given, so the JAX package's row interpolation (its
cost analysis counts a loop body once) has no counterpart: callers pass
the task's real row count. MACs = FLOPs / 2.

The copy takes the route ``impl="autograd"``: every kernel op runs its plain
version as ordinary autograd ops, as the JAX counter lowers the XLA route
of its Pallas ops (orbit_tpu ops_counter.py:27-41). A meta tensor would
otherwise head for a kernel; and a plain backward that recomputes its
forward, or forms weight gradients nothing reads, would count products the
XLA program does not hold. ``FlopCounterMode`` counts matmuls,
convolutions and attention, not the elementwise ops that XLA counts too,
so the port reads a few percent under the JAX count
(``tests/test_torch_ops_counter.py`` holds it within 5%).
"""
from __future__ import annotations

import copy
import itertools
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode


def meta_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` whose parameters and buffers are meta
    tensors of the same shapes, dtypes and ``requires_grad`` (no data is
    copied), its kernel-op route ``impl="autograd"`` where it has one."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else meta)
    clone = copy.deepcopy(module, memo)
    if hasattr(clone, "impl"):
        clone.impl = "autograd"
    return clone


def _to_meta(x):
    return torch.empty(x.shape, dtype=x.dtype, device="meta") if torch.is_tensor(x) else x


def flops_of(fn: Callable, *args) -> float:
    """FLOPs of ``fn(*args)`` with every tensor argument replaced by a meta
    tensor of its shape and dtype; ``fn`` must run on meta tensors (a
    function of a :func:`meta_copy`)."""
    args = tree_map(_to_meta, args)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def count_params(params) -> int:
    return int(sum(p.numel() for p in params))


class OpsCounter:
    """Per-task MACs/params tally (reference: utils/ops_counter.py:10-94).

    ``compute_macs(key, fn, *args)`` counts ``fn`` once per (key, argument
    shapes) and adds FLOPs/2 to the current task; ``add_macs`` adds MACs
    computed elsewhere (the FineTuner's ``base + per_step * K``)."""

    def __init__(self, count_backward: bool = False):
        self.backward_multiplier = 2 if count_backward else 1
        self.task_mac_counter = 0.0
        self.base_params = 0
        self.base_params_break_down: Dict[str, int] = {}
        self._flops_cache: Dict[Tuple, float] = {}

    @property
    def params_break_down(self) -> str:
        return ", ".join(f"{k}: {v:,}" for k, v in self.base_params_break_down.items())

    def set_base_params(self, model: nn.Module) -> None:
        """Record the meta-trained parameter counts by top-level component
        (reference: set_base_params, ops_counter.py:20-48): the named
        children of ``model`` that hold parameters (extractor, set encoder,
        FiLM generator, Versa processors, as the JAX package's ``params``
        tree)."""
        self.base_params_break_down = {
            name: count_params(child.parameters()) for name, child in model.named_children()
            if count_params(child.parameters())}
        self.base_params = sum(self.base_params_break_down.values())

    def add_macs(self, macs) -> None:
        self.task_mac_counter += float(macs) * self.backward_multiplier

    def flops(self, key: str, fn: Callable, *args) -> float:
        """:func:`flops_of`, cached per (key, argument shapes and dtypes)."""
        shapes = tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else repr(a)
                       for a in args)
        if (key, shapes) not in self._flops_cache:
            self._flops_cache[(key, shapes)] = flops_of(fn, *args)
        return self._flops_cache[(key, shapes)]

    def compute_macs(self, key: str, fn: Callable, *args) -> None:
        """Charge the MACs of ``fn(*args)`` to the current task."""
        self.add_macs(self.flops(key, fn, *args) / 2.0)

    def get_task_macs(self) -> float:
        return self.task_mac_counter

    def get_task_params(self) -> int:
        return self.base_params

    def task_complete(self) -> None:
        self.task_mac_counter = 0.0
