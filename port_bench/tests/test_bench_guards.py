"""The run's guards: no JAX or JAX package after the window (compared by
whole top-level names), a reference that imports nothing of the program,
and a run that refuses rather than falls back to the CPU."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

from conftest import ROOT


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from port_bench import core

    monkeypatch.setitem(sys.modules, "orbit_tpu_torch_fake.x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orbit_tpu.data", types.ModuleType("data"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("xla"))
    assert core.forbidden_modules() == ["jaxlib", "orbit_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import port_bench.reference.models, port_bench.reference.heads,"
            " port_bench.reference.protocol, port_bench.reference.lite,"
            " port_bench.reference.precision, port_bench.roofline, port_bench.weights;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         check=True).stdout
    top = set(eval(out))
    assert not top & {"orbit_tpu_torch", "orbit_tpu", "jax", "jaxlib", "flax", "optax"}


def _run(cwd, env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "vit_b32_proto_f32.clu_ve", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    return p.returncode, lines, p.stderr


def _is_result(line):
    try:
        return "correct" in json.loads(line)
    except ValueError:
        return False


def test_run_refuses_without_a_card():
    rc, lines, err = _run(ROOT)
    assert rc != 0 and not any(_is_result(ln) for ln in lines)
    assert "CUDA device" in err


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, lines, err = _run(tmp_path)
    assert rc != 0 and not any(_is_result(ln) for ln in lines)
    assert "program" in err


def test_lite_loop_refuses_what_it_does_not_drive():
    import pytest

    from port_bench import core
    from port_bench.loops import lite_meta_train

    b0 = json.loads((ROOT / "port_bench" / "configs" / "b0_simplecnaps_f32.json").read_text())
    b0["train_flags"] = ["--with_lite", "--learn_extractor"]
    with pytest.raises(core.Refused):
        lite_meta_train.refuse_unless_driven(b0)
    vit = json.loads((ROOT / "port_bench" / "configs" / "vit_b32_proto_f32.json").read_text())
    lite_meta_train.refuse_unless_driven(vit)
