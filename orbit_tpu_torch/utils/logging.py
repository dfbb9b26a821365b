"""Run-directory + logfile utilities.

Capability parity with the reference's ``utils/logging.py`` (print_and_log,
get_log_files, stats_to_str, time formatters) — reimplemented from scratch.

Copy of ``orbit_tpu/utils/logging.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step. The port's only addition:
:class:`NullLog`, for the ranks of a process group other than 0.
"""
from __future__ import annotations

import os
import sys
from datetime import datetime
from typing import IO, Optional


class NullLog:
    """The log of a process that writes none (a rank other than 0 of a
    process group): :func:`print_and_log` neither prints nor writes."""

    def write(self, message: str) -> None:
        pass

    def close(self) -> None:
        pass


def print_and_log(log_file: Optional[IO], message: str) -> None:
    """Print ``message`` to stdout and append it to ``log_file`` if given
    (neither for a :class:`NullLog`)."""
    if isinstance(log_file, NullLog):
        return
    print(message)
    if log_file:
        log_file.write(message + "\n")


def verify_checkpoint_dir(checkpoint_dir: str) -> None:
    if not os.path.exists(checkpoint_dir):
        print(f"Can't resume/test for checkpoint. Checkpoint directory ({checkpoint_dir}) does not exist.", flush=True)
        sys.exit(1)


def get_log_files(checkpoint_dir: str, model_path: Optional[str] = None,
                  write: bool = True):
    """Create a timestamped run directory and return (run_dir, logfile,
    best-checkpoint path, final-checkpoint path); with ``write`` off (a
    rank other than 0), create nothing and return a :class:`NullLog`.

    Mirrors the reference layout: ``<checkpoint_dir>/YYYY-MM-DD-HH-MM-SS/``
    containing ``log.txt``, ``best.ckpt`` and ``final.ckpt``
    (reference: utils/logging.py:13-33; we use orbax/msgpack checkpoints
    rather than torch ``.pt`` files).
    """
    if model_path:
        verify_checkpoint_dir(os.path.dirname(model_path) or ".")

    run_dir = os.path.join(checkpoint_dir, datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
    best_path = os.path.join(run_dir, "best.ckpt")
    final_path = os.path.join(run_dir, "final.ckpt")
    if not write:
        return run_dir, NullLog(), best_path, final_path
    os.makedirs(run_dir, exist_ok=True)
    logfile = open(os.path.join(run_dir, "log.txt"), "a", buffering=1)
    return run_dir, logfile, best_path, final_path


def stats_to_str(stats: dict) -> str:
    """Format a stats dict (values either float or [mean, ci]) as percentages."""
    parts = []
    for stat, scores in stats.items():
        if isinstance(scores, (list, tuple)):
            parts.append(f"{stat}: {scores[0] * 100:.2f} ({scores[1] * 100:.2f})")
        else:
            parts.append(f"{stat}: {scores * 100:.2f}")
    return "".join(parts)


def convert_to_minutes(seconds: float) -> str:
    mins, secs = divmod(seconds, 60)
    mins, secs = round(mins), round(secs)
    if mins == 0 and secs == 0:
        return f"{seconds:.2f}s"
    return f"{mins:d}m{secs:d}s"


def convert_to_microseconds(seconds: float) -> str:
    return f"{round(seconds * 1_000_000):d}μs"
