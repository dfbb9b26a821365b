"""What every cell's run shares: finding the cell, its configuration, its
traffic mix, its check limits and its metric readers by name; the card and
import guards; and the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives:

- ``port_bench/configs/<config>.json`` (the entry's ``file``);
- ``port_bench/traffic/<traffic>.json``, whose ``loop`` names the module
  ``port_bench/loops/<loop>.py`` that drives the port's loop for it: its
  ``run(run)`` (set-up, window, check), ``readings(cell, args, device,
  out)`` (the check's readings, ``readings.py``) and ``Feed`` (the mix's
  task generator);
- ``port_bench/checks/<workload>.json``: the limit of each number the
  check compares, and the readings it was set from;
- ``port_bench/metrics/<metric>.py``: ``read(run) -> float | None`` for
  each metric, end-to-end or per layer. A reader that finds nothing to
  read returns None and the metric is left out of the line.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbit_tpu")


class Refused(Exception):
    """The run cannot measure: it exits with another code than 0 and prints
    no result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of ``FORBIDDEN``: ``orbit_tpu_torch`` is not ``orbit_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    checks = json.loads((HERE / "checks" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, name, reported)]
    return Cell(name, workload, config, mix, checks, e2e, per_layer)


def reader(metric: str):
    """The ``read`` function of ``port_bench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop(name: str):
    return importlib.import_module(f"port_bench.loops.{name}")


@dataclass
class Run:
    """One run of one cell: its arguments, what the loop observed
    (``facts``), the traced window's summary (``trace``) and the check's
    numbers."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    started: float
    device: object = None
    facts: Dict[str, object] = field(default_factory=dict)
    trace: Optional[dict] = None
    numbers: Dict[str, float] = field(default_factory=dict)

    def metrics(self, which: List[dict]) -> Dict[str, dict]:
        out = {}
        for m in which:
            value = reader(m["name"])(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def verdict(numbers: Dict[str, float], checks: dict):
    """(correct, the compared numbers beside their limits): every number
    the checks file names is present, finite and at most its limit."""
    compared, correct = {}, True
    for name, spec in checks["numbers"].items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= spec["limit"]
        correct = correct and ok
        compared[name] = {"value": value, "limit": spec["limit"]}
    return correct, compared


def result_line(run: Run, correct: bool, compared: dict, attempted: int, failed: int,
                device: dict) -> str:
    """The last line of standard output: the result's keys, the compared
    numbers last."""
    which = run.cell.per_layer if run.traced else run.cell.end_to_end
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": run.metrics(which), "device": device}
    if run.traced and run.trace is not None:
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = compared
    return json.dumps(out)
