"""The port's flax msgpack reader and writer, and its checkpoint files,
held against the JAX package (``orbit_tpu/utils/checkpoint.py`` on
``flax.serialization``).

- JAX ``save_checkpoint`` -> the port's reader: the same tree, arrays,
  dtypes and bits as flax's ``msgpack_restore`` of the file (lists as maps
  keyed "0", "1", ...), for f32, int, bf16 (a ``torch.bfloat16`` tensor on the port's side),
  numpy scalars and flax's chunked form (``MAX_CHUNK_SIZE`` patched small);
- the port's writer -> JAX ``load_checkpoint``: the same arrays, and the
  same bytes as flax writes for the same tree, chunked form included;
- ``--model_path`` content: a JAX variables file and the port's torch file
  both load (``convert.load``), whatever their names; a full CNAPs
  recogniser's variables go both ways between the packages bit for bit
  (``to_jax_variables`` / ``from_jax_variables``); a JAX train state whose
  variables are no recogniser's is refused by ``--resume_from`` with a
  ValueError naming its leaves;
- the full-model converter (``--full_model``) on
  ``tests/test_convert_full.py``'s fake CNAPs checkpoint against the JAX
  ``convert_recogniser_checkpoint``.

Tolerance 0 everywhere: the files carry bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from orbit_tpu.utils import checkpoint as jax_checkpoint
from orbit_tpu_torch.models import convert
from orbit_tpu_torch.models.recognisers import SingleStepFewShotRecogniser
from orbit_tpu_torch.utils import checkpoint, msgpack_tree
from tests.test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


def _bits(x) -> np.ndarray:
    """An array's bits as unsigned ints (a bf16 torch tensor through int16)."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.itemsize in (1, 2, 4, 8) else x


def _dtype_name(x) -> str:
    return "bfloat16" if isinstance(x, torch.Tensor) else np.asarray(x).dtype.name


def _assert_same_tree(ours, ref, where=""):
    assert isinstance(ours, dict) == isinstance(ref, dict), where
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (where, sorted(ours), sorted(ref))
        for k in ref:
            _assert_same_tree(ours[k], ref[k], f"{where}/{k}")
        return
    assert _dtype_name(ours) == np.asarray(ref).dtype.name, where
    assert tuple(ours.shape) == np.shape(ref), where
    np.testing.assert_array_equal(_bits(ours), _bits(np.asarray(ref)), err_msg=where)


def _trees():
    rng = np.random.default_rng(3)
    return {
        "f32_and_ints": {"params": {"b": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                                          "bias": np.zeros((0,), np.float32)},
                                    "a": rng.integers(-9, 9, (4,)).astype(np.int32)},
                         "epoch": 3, "lr": 1e-3,
                         "best_stats": {"frame_acc": [0.5, 0.125]}},
        "bf16": {"w": jnp.asarray(rng.standard_normal((7, 3)), jnp.bfloat16),
                 "s": jnp.asarray(1.5, jnp.bfloat16)},
        "scalars": {"n": np.int64(-70000), "x": np.float32(2.5), "u": np.uint8(200),
                    "big": np.int64(2 ** 40)},
    }


@pytest.mark.parametrize("case", ["f32_and_ints", "bf16", "scalars", "chunked"])
def test_jax_file_reads_bit_for_bit(case, tmp_path, monkeypatch):
    if case == "chunked":  # 40 f32 per chunk: 250 f32 -> 7 chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 160)
        tree = {"big": np.arange(250, dtype=np.float32).reshape(10, 25) / 7,
                "bf": jnp.asarray(np.linspace(-3, 3, 90).reshape(9, 10), jnp.bfloat16),
                "small": np.ones((3,), np.float32)}
    else:
        tree = _trees()[case]
    path = str(tmp_path / "jax.ckpt")
    jax_checkpoint.save_checkpoint(path, tree)
    ours = checkpoint.load_checkpoint(path)
    with open(path, "rb") as f:  # flax's own reader of the same file
        _assert_same_tree(ours, serialization.msgpack_restore(f.read()))
    if case == "scalars":  # ext type 3: numpy scalars, not arrays
        assert all(isinstance(v, np.generic) for v in
                   msgpack_tree.loads(serialization.to_bytes(tree)).values())


@pytest.mark.parametrize("case", ["f32_and_ints", "bf16", "chunked"])
def test_port_file_reads_in_jax(case, tmp_path, monkeypatch):
    if case == "chunked":
        monkeypatch.setattr(msgpack_tree, "MAX_CHUNK_SIZE", 160)
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 160)
        tree = {"big": torch.arange(250, dtype=torch.float32).reshape(10, 25) / 7,
                "small": np.ones((3,), np.float32)}
    else:
        tree = _trees()[case]
    if case == "bf16":  # the port's bf16 leaves are torch tensors
        tree = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(torch.bfloat16)
                for k, v in tree.items()}
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, tree)
    as_numpy = {k: (_bits(v).view(jnp.bfloat16) if isinstance(v, torch.Tensor)
                    and v.dtype == torch.bfloat16 else
                    (v.numpy() if isinstance(v, torch.Tensor) else v))
                for k, v in tree.items()}
    template = jax.tree_util.tree_map(np.asarray, as_numpy)
    restored = jax_checkpoint.load_checkpoint(path, template)
    for k in template:  # same arrays, and the same bytes as flax writes
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
            _bits(np.asarray(a)), _bits(np.asarray(b))), restored[k], template[k])
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(template)


@pytest.fixture(scope="module")
def jax_cnaps():
    """A JAX CNAPs recogniser (B0, set encoder, FiLM generator, Versa) and
    its initial variables at 64 px (numpy)."""
    from orbit_tpu.models.recognisers import SingleStepFewShotRecogniser as JaxRecogniser

    rec = JaxRecogniser(feature_extractor_name="efficientnet_b0", adapt_features=True,
                        classifier="versa", batch_size=8)
    variables = rec.init(jax.random.PRNGKey(0), frame_size=64)
    return rec, jax.tree_util.tree_map(np.asarray, variables)


def test_full_recogniser_variables_round_trip(jax_cnaps, tmp_path):
    """JAX variables file -> the port (``--model_path``, named ``best.ckpt``
    as both packages name it); the port's state dict -> a flax file -> JAX
    ``maybe_load_params`` with the JAX template: bit for bit both ways."""
    _, variables = jax_cnaps
    jax_file = str(tmp_path / "best.ckpt")
    jax_checkpoint.save_checkpoint(jax_file, variables)
    state = convert.load(jax_file)
    rec = SingleStepFewShotRecogniser("efficientnet_b0", adapt_features=True,
                                      classifier="versa", batch_size=8, frame_size=64)
    rec.load_state_dict(state, strict=True)
    reference = convert.from_jax_variables(variables)
    for k, v in reference.items():
        assert torch.equal(state[k], v), k

    # the port's own torch file under the same name loads through the same call
    port_file = str(tmp_path / "port" / "best.ckpt")
    (tmp_path / "port").mkdir()
    convert.save(port_file, rec.state_dict())
    reread = convert.load(port_file)
    assert all(torch.equal(reread[k], v) for k, v in state.items())

    # the port's state dict back to a flax file the JAX package reads
    flax_file = str(tmp_path / "final.ckpt")
    checkpoint.save_checkpoint(flax_file, convert.to_jax_variables(rec.state_dict()))
    restored, used = jax_checkpoint.maybe_load_params(flax_file, variables)
    assert used == flax_file
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, restored), variables)
    with open(flax_file, "rb") as f:
        assert f.read() == serialization.to_bytes(variables)


def test_jax_train_state_is_refused(tmp_path):
    """``--resume_from`` reads a JAX train state by content and maps it by
    name (tests/test_torch_resume.py): a tiny one whose variables are no
    recogniser's is refused with a ValueError naming the file and the
    leaves, before anything is loaded; ``--model_path`` of a train state is
    a ValueError naming the file."""
    path = str(tmp_path / "checkpoint.ckpt")
    jax_checkpoint.save_checkpoint(path, {
        "epoch": 1, "variables": {"params": {"x": np.ones(2, np.float32)}},
        "opt_state": [{"mu": np.zeros(2, np.float32)}], "best_stats": {}})
    rec = SingleStepFewShotRecogniser("vit_s_32", frame_size=64)
    before = {k: v.clone() for k, v in rec.state_dict().items()}
    optimizer = torch.optim.Adam(rec.parameters())
    with pytest.raises(ValueError, match=r"checkpoint\.ckpt: variables: .*params/extractor/"):
        checkpoint.load_train_state(path, rec, optimizer)
    assert all(torch.equal(before[k], v) for k, v in rec.state_dict().items())
    assert not optimizer.state
    with pytest.raises(ValueError, match="not recogniser variables"):
        convert.load(path)


def test_full_model_converter_matches_jax(jax_cnaps, tmp_path):
    """A full reference CNAPs checkpoint (tests/test_convert_full.py's fake)
    through ``scripts/convert_checkpoint_torch.py --full_model``: the same
    variables as the JAX ``convert_recogniser_checkpoint`` (tolerance 0),
    the same file bytes as the JAX package writes for them, and the same
    port state dict through ``from_jax_variables``."""
    import sys
    from pathlib import Path

    from orbit_tpu.models.convert import convert_recogniser_checkpoint
    from tests.test_convert_full import fake_reference_checkpoint

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import convert_checkpoint_torch

    rec, variables = jax_cnaps
    np.random.seed(0)
    sd = fake_reference_checkpoint(rec)
    ref = jax.tree_util.tree_map(np.asarray, convert_recogniser_checkpoint(sd, rec, variables))
    port_rec = SingleStepFewShotRecogniser("efficientnet_b0", adapt_features=True,
                                           classifier="versa", batch_size=8, frame_size=64)
    ours = convert.convert_recogniser_checkpoint(sd, port_rec)
    _assert_same_tree(ours, ref)

    src, out, ref_file = (str(tmp_path / n) for n in ("cnaps.pt", "ours.ckpt", "ref.ckpt"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    convert_checkpoint_torch.main(["--feature_extractor", "efficientnet_b0", "--torch_path",
                                   src, "--out", out, "--full_model", "--classifier", "versa",
                                   "--adapt_features"])
    jax_checkpoint.save_checkpoint(ref_file, ref)
    with open(out, "rb") as a, open(ref_file, "rb") as b:
        assert a.read() == b.read()
    state = convert.load(out)
    for k, v in convert.from_jax_variables(ref).items():
        assert torch.equal(state[k], v), k
