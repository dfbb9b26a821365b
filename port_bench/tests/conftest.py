"""Fixtures of the benchmark's own tests (``python -m pytest port_bench/tests``).

Tests marked ``cuda`` run on the card (``python -m pytest port_bench/tests -m
cuda`` there) and skip here; the rest run on the CPU with the port's plain
versions, on the small fixtures of ``tests/data``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def tiny_run(config: str, mix: str, workload: str, seed: int = 2 ** 31 + 77,
             seconds: float = 0.1, traced: bool = False):
    """A run of a full-width configuration at 84 px over a small mix on the
    CPU, held to the limits of ``workload``'s checks file."""
    import torch

    from port_bench import core

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    checks = json.loads((ROOT / "port_bench" / "checks" / f"{workload}.json").read_text())
    cell = core.Cell(workload, {"chips": 1}, json.loads((DATA / f"{config}.json").read_text()),
                     json.loads((DATA / f"{mix}.json").read_text()), checks,
                     bench["end_to_end"], bench["per_layer"])
    return core.Run(cell, seed, seconds, traced, time.perf_counter(), device=torch.device("cpu"))


@pytest.fixture
def tiny():
    return tiny_run
