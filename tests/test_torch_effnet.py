"""The port's EfficientNet-B0 SimpleCNAPs/CNAPs test path held against the
JAX package, on the CPU.

The weights are the fake reference checkpoint of
``tests/test_convert_full.py`` (fake timm EfficientNet-B0 at full width,
set encoder, FiLM generator, Versa processors), carried into the JAX
recogniser by ``orbit_tpu.models.convert`` and into the port by
``from_jax_variables``, with BatchNorm running statistics calibrated on the
frames of the episode's kind (``calibrate_batchnorm``) and given to both
sides. The JAX side runs with ``efficientnet.DW_FUSED =
True`` (set in the fixture, restored after it): the route the port always
takes, every stride-1 depthwise tail through the fused op with its f32
affines. Its programs are compiled once per module: the task embedding and
FiLM generation, one extractor forward under FiLM values (an 8-frame batch
of 32 px frames, context and query alike), and the two heads.

- the backbone: the port's B0 forward against Flax, under the generated
  FiLM values and under the initial leaf values (no FiLM: the port's
  forward without a ``film`` dict); V2-S with the port's seeded weights;
- the slice: SimpleCNAPs (``mahalanobis``) and CNAPs (``versa``)
  personalise + predict on a padded episode (2 padded context rows, a
  single-shot class, a padded class);
- the Mahalanobis head on features of unit size, where the covariances
  matter (the random B0's features are small, so its precisions are near
  the identity);
- the precision policy: casting the port's B0 to bf16 keeps BatchNorm
  scale, bias and running statistics in f32, the leaves the JAX cast keeps;
- the CLI: ``--mode test`` with ``--adapt_features --classifier
  mahalanobis`` on the synthetic ORBIT tree writes ``results.json``.

f32 tolerance: the two sides differ in summation order only (convolutions,
the K*K taps, the head's products and inverses). Calibrated BatchNorms keep
every block's gain near one, but the blocks still carry a rounding
difference of one op into the features: measured 0.7e-5 to 0.8e-5 of their
largest value through B0's 16 blocks, 3.7e-5 through V2-S's 40, and 0.8e-5
to 1.2e-5 for the logits. Features, FiLM values and logits are held to 1e-4
of their largest value, as are the heads on unit-size features (measured
5e-7: a 64 x 64 inverse of a well-conditioned matrix).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbit_tpu.models.backbones.efficientnet as jax_eff
from orbit_tpu.models import heads as jax_heads
from orbit_tpu.models.convert import convert_recogniser_checkpoint
from orbit_tpu.models.precision import cast_extractor_params as jax_cast
from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models import heads
from orbit_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm
from orbit_tpu_torch.models.precision import cast_extractor_params
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from tests.test_convert_full import fake_reference_checkpoint
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
SIZE, N, WAY = 32, 8, 4  # frame size, clips per batch, classes (the last padded)
LABELS = np.array([0, 0, 0, 1, 2, 2, 0, 0])   # class 1 has one shot
CONTEXT_MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
CLASS_MASK = np.array([1, 1, 1, 0], np.float32)


def _frames(seed: int) -> np.ndarray:
    """(N, 1, SIZE, SIZE, 3) uint8 clips of one frame: a colour per label
    plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 216, size=(3, 1, 1, 3))
    noise = rng.integers(-30, 31, size=(N, SIZE, SIZE, 3))
    return np.clip(base[LABELS % 3] + noise, 0, 255).astype(np.uint8)[:, None]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX variables (numpy) and every JAX output the tests compare."""
    rec = JaxRecogniser(feature_extractor_name="efficientnet_b0", adapt_features=True,
                        classifier="versa", batch_size=N)
    sd = fake_reference_checkpoint(rec)
    for k in list(sd):  # small regularisers keep the FiLM'd forward stable
        if k.startswith("film_generator.regularizers."):
            sd[k] = np.full_like(sd[k], 0.01)
    skeleton = {"params": {k: {} for k in ("extractor", "set_encoder",
                                           "film_generator", "versa")}}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_recogniser_checkpoint(sd, rec, skeleton))
    ctx, query = _frames(0), _frames(1)
    # the fake weights lose the input within a few blocks (every frame gets
    # the same feature up to rounding); running statistics calibrated on 64
    # frames of the episode's kind, given to both sides, keep it
    port = _port(variables, "versa")
    calibration = np.concatenate([_frames(seed) for seed in range(8)])[:, 0]  # 64 frames
    calibrate_batchnorm(port.extractor, port._maybe_normalize(torch.from_numpy(calibration)))
    stats = variables["batch_stats"]["extractor"]
    for key, value in port.extractor.state_dict().items():
        if key.endswith((".mean", ".var")):
            *path, leaf = key.split(".")
            _leaf(stats, path)[leaf] = value.numpy()
    out = {"variables": variables, "context": ctx, "query": query}
    saved = jax_eff.DW_FUSED
    jax_eff.DW_FUSED = True
    try:
        film_fn = jax.jit(lambda v, c, m: rec.generate_film(v, rec.task_embedding(v, c, m))[0])
        embed = jax.jit(lambda v, f, c: rec.embed_clips(v, c, f, with_grad=False))
        film = film_fn(variables, jnp.asarray(ctx), jnp.asarray(CONTEXT_MASK))
        initial = {p: jnp.asarray(_leaf(variables["params"]["extractor"], p)) for p in film}
        out["film"] = {".".join(p): np.asarray(v) for p, v in film.items()}
        out["ctx_feats"] = np.asarray(embed(variables, film, jnp.asarray(ctx)))
        out["query_feats"] = np.asarray(embed(variables, film, jnp.asarray(query)))
        out["plain_feats"] = np.asarray(embed(variables, initial, jnp.asarray(query)))
    finally:
        jax_eff.DW_FUSED = saved
    args = (jnp.asarray(out["ctx_feats"]), jnp.asarray(LABELS), jnp.asarray(CONTEXT_MASK))
    query, class_mask = jnp.asarray(out["query_feats"]), jnp.asarray(CLASS_MASK)
    out["mahalanobis"] = np.asarray(_jax_mahalanobis(*args, query, class_mask)[1])
    versa = jax.jit(lambda p, f, y, m, q, c: jax_heads.predict_versa(
        jax_heads.configure_versa(rec.versa, {"params": p}, f, y, m, WAY), q, class_mask=c))
    out["versa"] = np.asarray(versa(variables["params"]["versa"], *args, query, class_mask))
    return out


@jax.jit
def _jax_mahalanobis(feats, labels, mask, query, class_mask, logit_scale=1.0):
    """The JAX head, configured on the context and applied to the query,
    compiled (op-by-op it takes seconds)."""
    head = jax_heads.configure_mahalanobis(feats, labels, mask, WAY)
    return head, jax_heads.predict_mahalanobis(head, query, logit_scale=logit_scale,
                                               class_mask=class_mask)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _port(variables, classifier: str) -> SingleStepFewShotRecogniser:
    rec = SingleStepFewShotRecogniser("efficientnet_b0", adapt_features=True,
                                      classifier=classifier, batch_size=N, frame_size=SIZE)
    state = convert.from_jax_variables(variables)
    if classifier != "versa":
        state = {k: v for k, v in state.items() if not k.startswith("versa.")}
    rec.load_state_dict(state, strict=True)
    return rec


def _close(ours: torch.Tensor, ref: np.ndarray, what: str):
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg=what)


def test_effnet_b0_forward_matches_flax(jax_side):
    rec = _port(jax_side["variables"], "mahalanobis")
    query = torch.from_numpy(jax_side["query"])
    film = {k: torch.from_numpy(v) for k, v in jax_side["film"].items()}
    with torch.no_grad():
        filmed = rec.embed_clips(query, film=film)
        plain = rec.embed_clips(query)
    assert filmed.dtype == torch.float32 and filmed.shape == (N, 1280)
    _close(filmed, jax_side["query_feats"], "B0 under FiLM")
    _close(plain, jax_side["plain_feats"], "B0 without FiLM")
    assert not np.allclose(jax_side["query_feats"], jax_side["plain_feats"])
    spread = np.abs(jax_side["query_feats"] - jax_side["query_feats"].mean(0)).max()
    assert spread > 1e-2 * np.abs(jax_side["query_feats"]).max()  # features see the input
    assert rec.extractor.forward_calls == 2


def test_effnet_v2_s_forward_matches_flax():
    """V2-S (ConvBnAct, EdgeResidual and 28 fused InvertedResidual tails)
    with the port's own seeded weights, calibrated, carried to Flax by the
    inverse of the renaming; the converter maps them back unchanged."""
    from orbit_tpu.models.backbones.efficientnet import create_efficientnet
    from orbit_tpu_torch.models.backbones import create_feature_extractor

    model, _, _ = create_feature_extractor("efficientnet_v2_s")
    model.reset_parameters(torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, SIZE, SIZE, 3)).astype(np.float32))
    calibrate_batchnorm(model, frames)
    x = frames[:4]
    tree = {"params": {"extractor": {}}, "batch_stats": {"extractor": {}}}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        node = tree[collection]["extractor"]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.numpy()
    back = convert.from_jax_variables(tree)
    assert all(torch.equal(back[f"extractor.{k}"], v) for k, v in model.state_dict().items())
    flax_model, _, _ = create_efficientnet("efficientnet_v2_s")
    saved = jax_eff.DW_FUSED
    jax_eff.DW_FUSED = True
    try:
        variables = {c: tree[c]["extractor"] for c in tree}
        ref = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(x.numpy())))
    finally:
        jax_eff.DW_FUSED = saved
    with torch.no_grad():
        ours = model(x)
    assert np.abs(ref - ref.mean(0)).max() > 1e-2 * np.abs(ref).max()
    _close(ours, ref, "V2-S")


@pytest.mark.parametrize("h,k", [(8, 3), (9, 5)])
def test_stride2_inverted_residual_matches_flax(h, k):
    """A stride-2 InvertedResidual, whose depthwise layer takes the composed
    route (BatchNorms in the compute dtype around a grouped conv on TF-SAME
    padded input; the odd H pads asymmetrically), against the Flax block,
    with random weights and running statistics, f32 and bf16. bf16 rounds
    at the same points on both sides; a value an f32 sum puts on either side
    of a rounding boundary flips one ulp (2^-8..2^-7), which the later
    convolutions carry: 2^-6 of the largest value, as the bf16 ops."""
    from orbit_tpu_torch.models.backbones.efficientnet import BN_EPS_TF, InvertedResidual

    block = InvertedResidual(16, 24, k, 2, 6.0, 0.25, BN_EPS_TF, "block")
    rng = np.random.default_rng(h + k)
    tree = {"params": {}, "batch_stats": {}}
    state = {}
    for key, value in block.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(value.shape)
        if leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "scale":
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif leaf in ("mean", "bias"):
            v = 0.2 * rng.standard_normal(shape)
        else:  # a conv kernel (kh, kw, in, out)
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        state[key] = torch.from_numpy(v.astype(np.float32))
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.astype(np.float32)
    block.load_state_dict(state)
    x = rng.standard_normal((2, h, h, 16)).astype(np.float32)
    for dtype, tol in (("float32", TOL), ("bfloat16", 2.0 ** -6)):
        flax_block = jax_eff.InvertedResidual(24, k, 2, 6.0, 0.25, BN_EPS_TF,
                                              dtype=getattr(jnp, dtype))
        ref = np.asarray(flax_block.apply(tree, jnp.asarray(x, getattr(jnp, dtype)))
                         .astype(jnp.float32))
        with torch.no_grad():
            ours = block(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert ours.dtype == getattr(torch, dtype) and ours.shape == (2, -(-h // 2),
                                                                      -(-h // 2), 24)
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max(), err_msg=dtype)


@pytest.mark.parametrize("classifier", ["mahalanobis", "versa"])
def test_personalise_predict_match_jax(jax_side, classifier):
    rec = _port(jax_side["variables"], classifier)
    ctx = torch.from_numpy(jax_side["context"])
    with torch.no_grad():
        state = rec.personalise(ctx, torch.from_numpy(LABELS), torch.from_numpy(CONTEXT_MASK),
                                WAY)
        for name, value in state["film"].items():
            _close(value, jax_side["film"][name], name)
        logits = rec.predict(state, torch.from_numpy(jax_side["query"]),
                             torch.from_numpy(CLASS_MASK))
    ref = jax_side[classifier]
    assert logits.shape == (N, WAY) and (logits[:, -1] == -1e30).all()
    _close(logits[:, :-1], ref[:, :-1], f"{classifier} logits")
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), ref.argmax(-1))


def test_mahalanobis_head_on_unit_features_matches_jax():
    rng = np.random.default_rng(3)
    d, n = 64, 12
    feats = rng.standard_normal((n, d)).astype(np.float32)
    labels = np.array([0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 0, 0])
    mask = np.array([1] * 10 + [0, 0], np.float32)
    query = rng.standard_normal((5, d)).astype(np.float32)
    j_head, ref = _jax_mahalanobis(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(mask),
                                   jnp.asarray(query), jnp.asarray(CLASS_MASK), 2.0)
    ref = np.asarray(ref)
    head = heads.configure_mahalanobis(torch.from_numpy(feats), torch.from_numpy(labels),
                                       torch.from_numpy(mask), WAY)
    for key in ("means", "precisions", "counts"):
        _close(head[key], np.asarray(j_head[key]), key)
    logits = heads.predict_mahalanobis(head, torch.from_numpy(query), logit_scale=2.0,
                                       class_mask=torch.from_numpy(CLASS_MASK))
    _close(logits[:, :-1], ref[:, :-1], "logits")


def test_bf16_cast_keeps_batchnorm_f32_like_jax(jax_side):
    variables = jax_side["variables"]
    rec = _port(variables, "mahalanobis")
    cast_extractor_params(rec.extractor)
    cast = jax_cast({"params": {"extractor": variables["params"]["extractor"]}})
    kept = {k for k, dt in _flat_dtypes(cast["params"]["extractor"]).items()
            if dt == np.float32}
    ours = {k[len("extractor."):]: t.dtype for k, t in rec.extractor.state_dict(
        prefix="extractor.").items()}
    ours_f32 = {k for k, dt in ours.items() if dt == torch.float32}
    buffers = {k for k in ours if k.endswith((".mean", ".var"))}
    assert ours_f32 == kept | buffers
    assert kept and all(k.split(".")[-2].startswith("bn") for k in kept)
    assert ours["conv_stem.kernel"] == torch.bfloat16
    assert ours["blocks_1_0.conv_dw.kernel"] == torch.bfloat16


def test_converter_refuses_silent_drops(jax_side):
    variables = jax_side["variables"]
    extra = {**variables, "params": {**variables["params"],
                                     "set_encoder": {**variables["params"]["set_encoder"],
                                                     "conv6": {"kernel": np.zeros(3)}}}}
    with pytest.raises(ValueError, match="does not map"):
        convert.from_jax_variables(extra)
    stats = {**variables["batch_stats"]["extractor"], "bn2": {"mean": np.zeros(1280)}}
    with pytest.raises(ValueError, match="lack parameters"):
        convert.from_jax_variables({**variables, "batch_stats": {"extractor": stats}})


def _flat_dtypes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat_dtypes(v, name) if isinstance(v, dict) else {name: v.dtype})
    return out


@pytest.fixture(scope="module")
def orbit_root(orbit_fixture_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit_root_effnet")
    os.symlink(os.path.realpath(orbit_fixture_tree), root / "test")
    return str(root)


def test_cli_simplecnaps_writes_results(orbit_root, tmp_path, monkeypatch):
    import json

    import single_step_learner_torch
    from orbit_tpu_torch.models.backbones import efficientnet

    # the CLI's path on B0's first three stages (the stem, the fused
    # DepthwiseSeparable tail, stride-2 and fused stride-1 InvertedResidual
    # tails, the head conv): the whole run takes a few seconds on one thread
    monkeypatch.setitem(efficientnet.ARCHS, "efficientnet_b0", efficientnet.B0_ARCH[:3])
    argv = ["--data_path", orbit_root, "--checkpoint_dir", str(tmp_path),
            "--mode", "test", "--feature_extractor", "efficientnet_b0",
            "--adapt_features", "--classifier", "mahalanobis", "--frame_size", "84",
            "--batch_size", "16", "--num_test_tasks", "1", "--subsample_factor", "8",
            "--context_shot", "2", "--target_shot", "1",
            "--test_target_clip_method", "random"]
    single_step_learner_torch.main(argv, device="cpu")
    (run,) = tmp_path.iterdir()
    results = json.loads((run / "results.json").read_text())
    assert set(results) == {"P001", "P002"}
    frames = [p for user in results.values() for task in user
              for video in task["task_videos"].values() for p in video.values()]
    assert frames and all(isinstance(p, int) for p in frames)
    assert "Frame accuracy (averaged per user)" in (run / "log.txt").read_text()
