"""The port's MACs counter (``orbit_tpu_torch/utils/ops_counter.py``) held
against the JAX package's (``orbit_tpu/utils/ops_counter.py``).

Both count at 224 px with shapes only: the port on a meta copy of the
recogniser, the JAX package on abstract lowerings. ``FlopCounterMode``
counts matmuls, convolutions and attention, XLA also the elementwise ops,
so the port reads a little lower: within 5%.

- Per frame, the single-step personalise on ViT-B/32 and EfficientNet-B0.
- The challenge oracle's scale (``tests/test_macs_oracle_scale.py``): a
  ViT-B/32-CLIP ProtoNets task of 1,080 frames lands in the notebook's
  4.78T +- 1.27T band, at 3.8-5.2 GMACs a frame.
- The FineTuner's ``base + per_step * K`` (K = 50) against the JAX
  learner's ``_personalise_macs`` on a ViT-B/32 cut to depth 2 (full width,
  224 px) with 6 real context clips, frozen and with FiLM, Adam and SGD.
  With FiLM the count goes through the plain backward of autograd (no
  recompute, no weight gradients): the kernels' recomputing backward would
  count about a quarter more, which the test shows too.
- The meta copy leaves the model alone and launches nothing.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from orbit_tpu.learners.multi_step import MultiStepLearner as JaxLearner
from orbit_tpu.learners.multi_step import build_finetune_fns as jax_finetune_fns
from orbit_tpu.learners.steps import build_eval_fns as jax_build_eval_fns
from orbit_tpu.models.backbones.vit import ViT as FlaxViT
from orbit_tpu.models.backbones.vit import vit_film_spec as jax_vit_film_spec
from orbit_tpu.models.film import FilmParameterGenerator as JaxFilmGenerator
from orbit_tpu.models.recognisers import MultiStepFewShotRecogniser as JaxMultiStep
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxSingleStep
from orbit_tpu.utils.ops_counter import OpsCounter as JaxOpsCounter
from orbit_tpu_torch.kernels import build as kbuild
from orbit_tpu_torch.learners import multi_step
from orbit_tpu_torch.learners.multi_step import MultiStepLearner
from orbit_tpu_torch.learners.steps import build_eval_fns
from orbit_tpu_torch.models.backbones import vit
from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                SingleStepFewShotRecogniser)
from orbit_tpu_torch.utils.ops_counter import OpsCounter, meta_copy
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

FRAME = 224
REL = 0.05
ORACLE_FRAMES = 1080


def _jax_ctx(n: int, dtype=jnp.float32):
    return (jax.ShapeDtypeStruct((n, 1, FRAME, FRAME, 3), dtype),
            jax.ShapeDtypeStruct((n,), jnp.int32), jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((16,), jnp.float32))


def _ctx(n: int):
    """Context arguments of n clips: the counter reads their shapes only."""
    return (torch.empty((n, 1, FRAME, FRAME, 3), dtype=torch.uint8, device="meta"),
            torch.empty((n,), dtype=torch.long, device="meta"),
            torch.empty((n,), device="meta"), torch.empty((16,), device="meta"))


def _port_personalise_macs(name: str, n: int, classifier: str = "proto") -> float:
    with torch.device("meta"):
        rec = SingleStepFewShotRecogniser(name, classifier=classifier, batch_size=256,
                                          frame_size=FRAME)
    counter = OpsCounter()
    counter.compute_macs("personalise", build_eval_fns(meta_copy(rec))[0], *_ctx(n))
    return counter.get_task_macs()


@pytest.mark.parametrize("name", ["vit_b_32", "efficientnet_b0"])
def test_per_frame_macs_match_jax(name):
    n = 4
    rec = JaxSingleStep(feature_extractor_name=name, classifier="proto", batch_size=256)
    variables = jax.eval_shape(lambda: rec.init(jax.random.PRNGKey(0), frame_size=FRAME))
    counter = JaxOpsCounter()
    counter.compute_macs("personalise", jax_build_eval_fns(rec)[0], variables, *_jax_ctx(n))
    ref = counter.get_task_macs() / n
    ours = _port_personalise_macs(name, n) / n
    assert abs(ours / ref - 1) < REL, (name, ours, ref)
    assert ours <= ref  # the elementwise ops are all that XLA counts beside


def test_personalise_macs_at_oracle_scale():
    macs = _port_personalise_macs("vit_b_32_clip", ORACLE_FRAMES)
    per_frame = macs / ORACLE_FRAMES
    assert 3.8e9 < per_frame < 5.2e9, f"per-frame MACs {per_frame / 1e9:.2f}G off envelope"
    assert 3.51e12 < macs < 6.05e12, f"task MACs {macs / 1e12:.2f}T off the oracle band"


def _ft_args(optimizer: str) -> SimpleNamespace:
    return SimpleNamespace(
        personalize_num_grad_steps=50, personalize_learning_rate=1e-3,
        personalize_optimizer=optimizer, personalize_weight_decay=0.0,
        personalize_extractor_lr_scale=1.0, personalize_epsilon=1e-8,
        personalize_betas=(0.9, 0.999), personalize_momentum=0.9, batch_size=8)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("film", [False, True])
def test_finetuner_macs_match_jax(film, optimizer, monkeypatch):
    dim, depth, n_pad, n_valid = 768, 2, 8, 6
    args = _ft_args(optimizer)
    rec = JaxMultiStep(feature_extractor_name="vit_b_32", adapt_features=film,
                       classifier="linear", batch_size=args.batch_size)
    object.__setattr__(rec, "extractor", FlaxViT(patch_size=32, dim=dim, depth=depth,
                                                 num_heads=12))
    if film:
        spec = tuple(jax_vit_film_spec(depth, dim))
        object.__setattr__(rec, "film_spec", spec)
        object.__setattr__(rec, "film_generator", JaxFilmGenerator(film_spec=spec))
    twins = {}
    for k in (1, 2):
        a = SimpleNamespace(**vars(args))
        a.personalize_num_grad_steps = k
        twins[k] = jax_finetune_fns(rec, a, unroll_steps=True)[0]
    learner = SimpleNamespace(
        recogniser=rec, args=args, _macs_fn_k1=twins[1], _macs_fn_k2=twins[2],
        variables=jax.eval_shape(lambda: rec.init(jax.random.PRNGKey(0), frame_size=FRAME)))
    ref = JaxLearner._personalise_macs(learner, JaxOpsCounter(), _jax_ctx(n_pad, jnp.uint8),
                                       n_valid) / 2.0

    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_b_32", (dim, depth, 12, False, 1e-6))
    with torch.device("meta"):
        port = MultiStepFewShotRecogniser("vit_b_32", adapt_features=film, classifier="linear",
                                          batch_size=args.batch_size, frame_size=FRAME)
    ours = MultiStepLearner.personalise_macs(SimpleNamespace(recogniser=port, args=args),
                                             OpsCounter(), n_valid, _ctx(n_pad))
    assert abs(ours / ref - 1) < REL, (ours, ref)
    if film:  # the kernels' backward recomputes the forward: the plain route's count
        def recomputing_copy(module):
            clone = meta_copy(module)
            clone.impl = "reference"
            return clone
        monkeypatch.setattr(multi_step, "meta_copy", recomputing_copy)
        recomputing = MultiStepLearner.personalise_macs(
            SimpleNamespace(recogniser=port, args=args), OpsCounter(), n_valid, _ctx(n_pad))
        assert 1.15 < recomputing / ours < 1.35, recomputing / ours


def test_meta_copy_leaves_the_model_and_launches_nothing(monkeypatch):
    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_s_32", (64, 2, 1, False, 1e-6))
    rec = MultiStepFewShotRecogniser("vit_s_32", adapt_features=True, classifier="linear",
                                     batch_size=8, frame_size=64).init(0)
    before = {k: v.clone() for k, v in rec.state_dict().items()}
    clone = meta_copy(rec)
    assert clone.impl == "autograd" and rec.impl is None
    assert all(p.is_meta for p in clone.parameters())
    assert all(not p.is_meta for p in rec.parameters())
    kbuild.reset_launch_counts()
    args = _ft_args("adam")
    args.personalize_num_grad_steps = 2
    ctx = (torch.empty((5, 1, 64, 64, 3), dtype=torch.uint8), torch.zeros(5, dtype=torch.long),
           torch.ones(5), torch.ones(16))
    macs = MultiStepLearner.personalise_macs(SimpleNamespace(recogniser=rec, args=args),
                                             OpsCounter(), 5, ctx)
    assert macs > 0 and not any(kbuild.LAUNCHES.values())
    assert all(torch.equal(before[k], v) for k, v in rec.state_dict().items())
