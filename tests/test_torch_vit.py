"""The port's ViT and parameter converter held against the Flax ViT.

A depth-2, width-64 ViT (one 64-wide head, 64 px frames: 4 patches + cls)
is initialised in Flax, its variables go through
``orbit_tpu_torch.models.convert.from_jax_variables`` into the port, and the
same numpy frames go through both forwards. The Flax attention and MLP run
as the JAX suite runs them on the CPU (``attn_impl`` "xla" and
"interpret"); the port takes the kernels' plain versions on the CPU.

Tolerances:
- f32: summation order only, through two layers and the final LayerNorm:
  2e-5 relative plus 2e-5 absolute on O(1) features.
- bf16: both sides round at the same points in the kernel ops, but the
  Flax "xla" attention and ``nn.Dense``/``nn.Conv`` may round a sum on the
  other side of a bf16 boundary; one-ulp (2^-8..2^-7) differences feed the
  residual stream of both layers, so four ulps: 2^-5 relative and absolute.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit_tpu.models.backbones.vit import ViT as FlaxViT
from orbit_tpu.models.precision import cast_extractor_params as jax_cast
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.backbones.vit import ViT
from orbit_tpu_torch.models.precision import cast_extractor_params
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

FRAME = 64
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.0 ** -5, atol=2.0 ** -5)}


def _flax_variables(pre_norm: bool, seed: int = 0):
    m = FlaxViT(patch_size=32, dim=64, depth=2, num_heads=1, pre_norm=pre_norm,
                ln_eps=1e-5 if pre_norm else 1e-6)
    v = jax.jit(m.init)(jax.random.PRNGKey(seed),
                        jnp.zeros((1, FRAME, FRAME, 3), jnp.float32))
    # non-trivial biases, LN affines and class token (Flax inits them to 0/1)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        v["params"])
    return {"params": {"extractor": params}}


def _port_vit(variables, pre_norm: bool, dtype) -> ViT:
    vit = ViT(patch_size=32, dim=64, depth=2, num_heads=1, pre_norm=pre_norm,
              ln_eps=1e-5 if pre_norm else 1e-6, frame_size=FRAME, dtype=dtype)
    sd = convert.from_jax_variables(variables)
    vit.load_state_dict({k[len("extractor."):]: v for k, v in sd.items()}, strict=True)
    if dtype == torch.bfloat16:
        cast_extractor_params(vit)
    return vit


def _frames(n=6, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, FRAME, FRAME, 3)).astype(np.float32)


@pytest.mark.parametrize("pre_norm,attn_impl", [(False, "interpret"), (True, "xla")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_forward_matches_flax(dtype, pre_norm, attn_impl):
    variables = _flax_variables(pre_norm)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    flax_vit = FlaxViT(patch_size=32, dim=64, depth=2, num_heads=1,
                       pre_norm=pre_norm, ln_eps=1e-5 if pre_norm else 1e-6,
                       dtype=jdt, attn_impl=attn_impl)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    if dtype == "bfloat16":
        jvars = jax_cast(jvars)
    x = _frames()
    ref = np.asarray(jax.jit(flax_vit.apply)(
        {"params": jvars["params"]["extractor"]}, jnp.asarray(x).astype(jdt)))

    vit = _port_vit(variables, pre_norm, getattr(torch, dtype))
    with torch.inference_mode():
        ours = vit(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert ours.dtype == torch.float32 and ours.shape == (6, 64)
    assert vit.forward_calls == 1
    np.testing.assert_allclose(ours.numpy(), ref, **TOL[dtype])


def test_converter_covers_every_leaf():
    variables = _flax_variables(pre_norm=True)
    sd = convert.from_jax_variables(variables)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(sd) == len(leaves) == 2 + 1 + 1 + 2 + 2 + 2 * 12
    vit = ViT(patch_size=32, dim=64, depth=2, num_heads=1, pre_norm=True,
              frame_size=FRAME)
    port = {f"extractor.{k}": v for k, v in vit.state_dict().items()}
    assert sorted(sd) == sorted(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    flat = variables["params"]["extractor"]
    np.testing.assert_array_equal(sd["extractor.blocks.1.attn.qkv.kernel"].numpy(),
                                  flat["blocks_1"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["extractor.patch_embed.kernel"].numpy(),
                                  flat["patch_embed"]["kernel"])


def test_converter_refuses_silent_drops():
    variables = _flax_variables(pre_norm=False)
    extra = {"params": {**variables["params"],
                        "set_encoder": {"w": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="does not map"):
        convert.from_jax_variables(extra)
    ex = dict(variables["params"]["extractor"])
    blk = dict(ex["blocks_1"])
    del blk["norm2"]
    ex["blocks_1"] = blk
    with pytest.raises(ValueError, match="lack ViT parameters"):
        convert.from_jax_variables({"params": {"extractor": ex}})


def test_save_load_round_trip(tmp_path):
    sd = convert.from_jax_variables(_flax_variables(pre_norm=False))
    path = str(tmp_path / "model.pt")
    convert.save(path, sd)
    back = convert.load(path)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_seeded_init_is_deterministic_and_flax_like():
    a, b = (ViT(dim=64, depth=2, num_heads=1, frame_size=FRAME) for _ in range(2))
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    w = a.blocks[0].mlp.fc1.kernel
    # lecun-normal: variance 1/fan_in, truncated at two standard deviations
    assert abs(float(w.std()) - 64 ** -0.5) < 0.02
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a.blocks[0].norm1.scale, torch.ones(64))
    assert torch.equal(a.cls_token, torch.zeros(1, 1, 64))
