"""Set-up that every loop shares: the run's scratch directory, the learner's
arguments, and the reference recogniser holding the run's weights (made on
the card from ``--seed``; an EfficientNet's BatchNorm statistics calibrated
on the frame bank), which the port's recogniser loads after every weight
draw of its own."""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from port_bench import weights as weights_lib
from port_bench.reference.models import Recogniser, calibrate_batchnorm
from port_bench.reference.precision import tf32


class Phases:
    """Seconds of each set-up phase, printed for the record."""

    def __init__(self, started: float):
        self.last, self.seconds = started, {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 3)
        self.last = now

    def report(self) -> None:
        print(f"set-up phases (s): {self.seconds}", flush=True)


class Scratch:
    """A directory under ``TMPDIR`` for the learner's log and checkpoints,
    removed when the run ends."""

    def __enter__(self) -> Path:
        self.path = Path(tempfile.mkdtemp(prefix="port_bench_"))
        return self.path

    def __exit__(self, *exc):
        shutil.rmtree(self.path, ignore_errors=True)


def learner_args(config: dict, mode: str, scratch: Path, seed: int, extra: List[str] = ()):
    """The single-step learner's parsed arguments for a configuration."""
    from orbit_tpu_torch.utils.args import parse_args

    return parse_args("single-step-learner", [
        "--data_path", str(scratch / "data"), "--checkpoint_dir", str(scratch / "ckpt"),
        "--mode", mode, "--seed", str(seed), *config["flags"], *extra])


def discard_checkpoints(learner) -> None:
    """Send the epoch's train state and the final weights, which no metric
    reads, to ``/dev/null``: the learner serialises them as it always does,
    and the run writes about 1.4 GB less to the disk (``save_train_state``
    writes ``<path>.tmp`` and renames it, which moves the link)."""
    for path in (os.path.join(learner.checkpoint_dir, "checkpoint.ckpt.tmp"),
                 learner.checkpoint_path_final):
        os.symlink(os.devnull, path)


def sync() -> None:
    """Wait for the card, where there is one (the CPU tests run without)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def weight_seed(seed: int) -> int:
    return seed % (1 << 63)


def bank_seed(seed: int) -> int:
    return (2 * seed + 1) % (1 << 63)


def reference(config: dict, seed: int, device, bank=None) -> Recogniser:
    """The reference recogniser on ``device`` with the run's weights; an
    EfficientNet's running statistics calibrated on the first
    ``calibrate_frames`` frames of ``bank`` taken across its object slots."""
    model = Recogniser(config["architecture"]).to(device)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(weights_lib.make(shapes, config["weights"], weight_seed(seed), device))
    n = config.get("calibrate_frames")
    if n:
        objects, per = bank.frames.shape[:2]
        rows = np.arange(n)
        frames = torch.from_numpy(bank.frames[rows % objects, (rows // objects) % per]).to(device)
        with tf32(False):  # true float32, whatever the process's defaults
            calibrate_batchnorm(model.extractor, model.normalise(frames))
    return model


def loader(model: Recogniser):
    """``after_init`` for the learner: load the reference's weights (and
    calibrated statistics) into the port's freshly drawn recogniser."""
    state = {k: v.detach() for k, v in model.state_dict().items()}

    def load(recogniser):
        recogniser.load_state_dict(state)
    return load
