"""Run one cell of ``BENCHMARK.json`` once on the card this process sees.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, as its last line on standard output, one JSON object:
``correct``, ``attempted`` (tasks or task steps in the window), ``failed``
(compared numbers over their limits),
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, and ``breakdown``), ``device`` and, last, ``checks``
(each compared number beside its limit, also the last lines of standard
error). Exits with 2 and prints no result when there is no CUDA device or
fewer than the cell asks for, when the program is missing, or when JAX or
the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout: the port builds its kernels
# under build/ itself; these cover torch's extension and Triton caches
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args):
    """(result line, compared numbers) of one run; raises Refused."""
    from port_bench import core

    cell = core.load_cell(args.workload)
    try:
        import orbit_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        raise core.Refused(f"the program is not here: {e}") from e
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise core.Refused(f"needs {chips} CUDA device(s), sees "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    run = core.Run(cell, args.seed, args.seconds, bool(args.trace), STARTED,
                   device=torch.device("cuda:0"))
    attempted = core.loop(cell.mix["loop"]).run(run)
    loaded = core.forbidden_modules()
    if loaded:
        raise core.Refused(f"JAX or the JAX package is loaded: {loaded}")
    correct, compared = core.verdict(run.numbers, cell.checks)
    failed = sum(not (c["value"] is not None and c["value"] <= c["limit"])
                 for c in compared.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(run.facts["peak_bytes"])}
    if run.trace is not None:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    print(f"facts: window {run.facts['window_s']:.3f} s, {run.facts['tasks']} tasks, "
          f"check {run.facts.get('check_s', 0):.1f} s", flush=True)
    if "worst_leaves" in run.facts:
        print(f"worst leaves: {run.facts['worst_leaves']}", flush=True)
    for key in ("personalise_s", "predict_s", "step_s"):
        if key in run.facts:
            print(f"{key[:-2]} ms a task: {[round(1e3 * t, 1) for t in run.facts[key]]}",
                  flush=True)
    return core.result_line(run, correct, compared, attempted, failed, device), compared


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench.core import Refused

    try:
        line, compared = measure(args)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    for name, c in compared.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
