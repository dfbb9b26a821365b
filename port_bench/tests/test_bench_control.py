"""On the card: each cell's control, the reference computed in TF32 (the
nearest precision below the configurations' float32) in the program's
place, comes out not correct under the cell's own limits, at the cell's own
size; and for the training cell each planted fault too. Runs
``readings.py`` on one seed a cell (the limits were set from such readings
on three seeds or more)."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

CELLS = [("vit_b32_proto_f32.clu_ve", []), ("b0_simplecnaps_f32.clu_ve", []),
         ("vit_b32_proto_f32.lite_train", ["half", "answer"])]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,faults", CELLS)
def test_control_and_faults_are_not_correct(cuda_device, tmp_path, cell, faults):
    from port_bench import core, readings

    out = tmp_path / "readings.json"
    argv = ["--workload", cell, "--seeds", "", "--control", str(2 ** 31 + 99), "--out", str(out)]
    if faults:
        argv += ["--faults", ",".join(faults)]
    assert readings.main(argv) == 0
    found = json.loads(out.read_text())
    checks = json.loads((ROOT / "port_bench" / "checks" / f"{cell}.json").read_text())
    for kind in ["control", *faults]:
        for numbers in found[kind].values():
            assert core.verdict(numbers, checks)[0] is False, (kind, numbers)
