"""The benchmark is data: every cell, configuration, mix, check and metric
of BENCHMARK.json is found by name, and the file keeps the contract's
shape."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert sorted(BENCH) == ["command", "configs", "end_to_end", "paths", "per_layer",
                             "run_seconds", "workloads"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    from port_bench import core

    found = core.load_cell(cell)
    assert found.config["name"] == found.workload["config"]
    assert found.mix["name"] == found.workload["traffic"]
    assert core.loop(found.mix["loop"]).run
    names = {m["name"] for m in found.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert found.per_layer
    assert set(found.checks["numbers"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    from port_bench import core

    assert callable(core.reader(metric))


def test_names_units_and_bounds():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("port_bench/") and config["reduced"] == c["reduced"] == []
        assert config["source"] == c["source"]


def test_metric_reader_returns_nothing_without_its_facts():
    from port_bench import core

    run = core.Run(core.load_cell(CELLS[0]), 1, 1.0, True, 0.0)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert core.reader(m["name"])(run) is None
