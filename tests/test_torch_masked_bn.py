"""The port's train-mode MaskedBatchNorm held against the JAX one on the CPU.

The cases of tests/test_masked_bn.py, as parametrised cases of one test.
Each case runs a stack of BatchNorms (one, or twelve with a dense mixing
layer before each) through ``orbit_tpu.models.backbones.masked_bn`` and
through ``orbit_tpu_torch.models.backbones.masked_bn`` on the same inputs,
parameters and incoming running statistics (drawn from numpy seeds, and the
BatchNorms' scale and bias away from the identity), and holds the outputs,
the updated running statistics and the gradients of ``sum(y * r)`` for a
fixed ``r`` against the JAX ones; then the case's own property:

- ``padded``: 5 real rows padded with 11 give the outputs and statistics
  of the 5 rows alone (the port against itself);
- ``torch_running``: the running update is torch's (unbiased variance,
  momentum 0.1) against ``torch.nn.BatchNorm2d``;
- ``all_padding``: a chunk with no real row leaves the running statistics
  bit for bit and outputs zeros;
- ``high_offset``: a common offset of 1e4 leaves the two-pass variance of
  the noise (the batch variance out of the running blend, against
  float64, 5e-3 as the JAX test);
- ``one_row_1x1``: one real row at 1x1 through twelve layers stays finite
  and the pad rows stay zero;
- ``inf_pad``: ``inf`` in the pad rows changes neither the outputs, nor
  the statistics, nor the gradients (the port against itself on the input
  with those rows zero). The JAX side runs that clean input: its forward is
  immune to the ``inf`` as the port's, but its backward is not (``0 * inf``
  in the cotangents of the scale and the variance makes every real row's
  gradient NaN), while the port keeps only the selected centred tensor.

Tolerances (f32): the two sides sum in different orders and the port
multiplies by ``rsqrt(var + eps) * scale`` where Flax multiplies by each in
turn, a few ulps. Outputs and statistics are held to 1e-5 relative and
1e-5 absolute (1e-6 for the statistics); gradients, which add a backward
reduction per layer, per tensor to 1e-4 of its largest value. At the
offset of 1e4 the batch mean itself carries the rounding of its sum, a few
ulps of 1e4 (one ulp is 2^-10) whose value depends on the summation order,
and every centred value inherits it: there the outputs are held to 8 ulps
of the offset over the noise's unit deviation, 2^-7 absolute, and the
gradients, sums of those values against ``r``, to 2^-7 of their largest.
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.models.backbones.masked_bn import MaskedBatchNorm as FlaxMaskedBatchNorm
from orbit_tpu_torch.models.backbones.masked_bn import (BatchStats, MaskedBatchNorm,
                                                        running_stats)
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

Y_TOL, STATS_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


class Stack(fnn.Module):
    layers: int
    dense: bool
    eps: float

    @fnn.compact
    def __call__(self, x, mask):
        for i in range(self.layers):
            if self.dense:
                x = fnn.Dense(x.shape[-1], use_bias=False,
                              kernel_init=fnn.initializers.normal(1.0), name=f"mix{i}")(x)
            x = FlaxMaskedBatchNorm(momentum=0.9, epsilon=self.eps,
                                    name=f"bn{i}")(x, use_running_average=False, mask=mask)
        return x


def _case(name: str):
    """(x, mask or None, layers, dense, eps) of a case."""
    rng = np.random.default_rng(0)
    if name == "padded":
        x = np.concatenate([rng.standard_normal((5, 4, 4, 7)), np.zeros((11, 4, 4, 7))])
        return x, np.r_[np.ones(5), np.zeros(11)], 1, False, 1e-3
    if name == "torch_running":
        return rng.standard_normal((6, 3, 3, 4)), None, 1, False, 1e-3
    if name == "all_padding":
        return np.ones((4, 2, 2, 3)), np.zeros(4), 1, False, 1e-3
    if name == "high_offset":
        return 1.0e4 + rng.standard_normal((64, 4, 4, 8)), np.ones(64), 1, False, 1e-5
    if name == "one_row_1x1":
        return rng.standard_normal((8, 1, 1, 32)) * 50, np.eye(8)[0], 12, True, 1e-3
    if name == "inf_pad":
        x = np.concatenate([rng.standard_normal((3, 4, 4, 8)), np.full((2, 4, 4, 8), np.inf)])
        return x, np.r_[np.ones(3), np.zeros(2)], 1, False, 1e-3
    raise ValueError(name)


def _variables(stack: Stack, x, mask, identity: bool):
    """Flax variables of ``stack``; unless ``identity``, BatchNorm scale,
    bias and running statistics drawn away from their initial values."""
    v = jax.tree_util.tree_map(np.asarray, stack.init(
        jax.random.PRNGKey(0), jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    if not identity:
        rng = np.random.default_rng(1)
        for i in range(stack.layers):
            c = v["params"][f"bn{i}"]["scale"].shape
            v["params"][f"bn{i}"]["scale"] = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
            v["params"][f"bn{i}"]["bias"] = (0.3 * rng.standard_normal(c)).astype(np.float32)
            v["batch_stats"][f"bn{i}"]["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
            v["batch_stats"][f"bn{i}"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return v


def _jax_run(stack: Stack, v, x, mask, r):
    """Outputs, updated statistics and the gradients of sum(y * r) with
    respect to x and every parameter, in JAX."""
    m = None if mask is None else jnp.asarray(mask, jnp.float32)

    def loss(x, params):
        y, mut = stack.apply({"params": params, "batch_stats": v["batch_stats"]}, x, m,
                             mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (_, (y, stats)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, jnp.float32), v["params"])
    return y, stats, grads


class PortStack(torch.nn.Module):
    def __init__(self, v, layers: int, dense: bool, eps: float):
        super().__init__()
        self.mix = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(np.array(v["params"][f"mix{i}"]["kernel"])))
             for i in range(layers)] if dense else [])
        self.bns = torch.nn.ModuleList()
        for i in range(layers):
            bn = MaskedBatchNorm(v["params"][f"bn{i}"]["scale"].shape[0], eps, f"bn{i}")
            bn.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                                {**v["params"][f"bn{i}"], **v["batch_stats"][f"bn{i}"]}.items()})
            self.bns.append(bn)

    def forward(self, x, mask):
        batch = BatchStats(running_stats(self), mask)
        for i, bn in enumerate(self.bns):
            if len(self.mix):
                x = x @ self.mix[i]
            x = bn(x, batch=batch)
        return x, batch.new


def _port_run(stack: PortStack, x, mask, r):
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y, new = stack(xt, None if mask is None else torch.tensor(mask, dtype=torch.float32))
    (y * r).sum().backward()
    return y.detach(), new, xt.grad


def _close(a, b, name, atol=Y_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=Y_TOL, atol=atol,
                               err_msg=name)


def _close_grad(a, b, name, tol=GRAD_TOL):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=tol * scale, err_msg=name)


CASES = ["padded", "torch_running", "all_padding", "high_offset", "one_row_1x1", "inf_pad"]


@pytest.mark.parametrize("case", CASES)
def test_train_mode_matches_jax(case):
    x, mask, layers, dense, eps = _case(case)
    x = x.astype(np.float32)
    stack = Stack(layers, dense, eps)
    v = _variables(stack, x, mask, identity=case == "torch_running")
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    clean = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    j_y, j_stats, (j_dx, j_dparams) = _jax_run(stack, v, clean, mask, jnp.asarray(r))

    port = PortStack(v, layers, dense, eps)
    y, new, dx = _port_run(port, x, mask, torch.from_numpy(r))
    tol = 2.0 ** -7 if case == "high_offset" else None
    _close(y, j_y, "y", tol or Y_TOL)
    for i in range(layers):
        for j, leaf in enumerate(("mean", "var")):
            _close(new[f"bn{i}"][j], j_stats[f"bn{i}"][leaf], f"bn{i}.{leaf}", STATS_ATOL)
    _close_grad(dx, j_dx, "dx", tol or GRAD_TOL)
    for i, bn in enumerate(port.bns):
        for leaf in ("scale", "bias"):
            _close_grad(getattr(bn, leaf).grad, j_dparams[f"bn{i}"][leaf], f"bn{i}.{leaf}",
                        tol or GRAD_TOL)
        if dense:
            _close_grad(port.mix[i].grad, j_dparams[f"mix{i}"]["kernel"], f"mix{i}")
    # the port's buffers are never written by the forward
    for i, bn in enumerate(port.bns):
        np.testing.assert_array_equal(bn.mean.numpy(), v["batch_stats"][f"bn{i}"]["mean"])

    if case == "padded":
        y_real, new_real, _ = _port_run(PortStack(v, 1, False, eps), x[:5], None,
                                        torch.from_numpy(r[:5]))
        _close(y[:5], y_real, "padded vs unpadded")
        for a, b in zip(new["bn0"], new_real["bn0"]):
            _close(a, b, "padded vs unpadded statistics", STATS_ATOL)
    elif case == "torch_running":
        ref = torch.nn.BatchNorm2d(x.shape[-1], eps=eps, momentum=0.1)
        ref.train()
        ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        _close(new["bn0"][0], ref.running_mean.detach(), "torch mean", STATS_ATOL)
        _close(new["bn0"][1], ref.running_var.detach(), "torch var", STATS_ATOL)
    elif case == "all_padding":
        assert torch.equal(new["bn0"][0], port.bns[0].mean)
        assert torch.equal(new["bn0"][1], port.bns[0].var)
        assert not y.any()
    elif case == "high_offset":
        # the unbiased batch variance, out of the 0.9/0.1 blend
        batch_var = (new["bn0"][1].double() - 0.9 * port.bns[0].var.double()) / 0.1
        expect = x.astype(np.float64).reshape(-1, x.shape[-1]).var(axis=0, ddof=1)
        np.testing.assert_allclose(batch_var.numpy(), expect, rtol=5e-3)
    elif case == "one_row_1x1":
        assert torch.isfinite(y).all() and not y[1:].any()
        assert all(torch.isfinite(t).all() for pair in new.values() for t in pair)
    elif case == "inf_pad":
        again = PortStack(v, 1, False, eps)
        y_clean, new_clean, dx_clean = _port_run(again, clean, mask, torch.from_numpy(r))
        assert torch.equal(y, y_clean) and not y[3:].any()
        assert all(torch.equal(a, b) for a, b in zip(new["bn0"], new_clean["bn0"]))
        assert torch.equal(dx, dx_clean)
        assert all(torch.equal(getattr(port.bns[0], leaf).grad, getattr(again.bns[0], leaf).grad)
                   for leaf in ("scale", "bias"))
