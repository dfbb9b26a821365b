"""The readings a cell's check limits are set from, on the card, in one
process: the program's numbers on many seeds (the lower reading is their
largest), the control's (the reference in TF32 in the program's place, the
nearest precision below float32) and, for a training cell, the planted
faults' (the reference with a batch's loss over half its rows, or with one
logit altered where it is produced). The benchmark's own runs never run
this.

    python3 port_bench/readings.py --workload <cell> --seeds 11,12,... \\
        --control 21,22,23 [--faults half,answer] --out chiprun_out/<file>.json

The cell's loop module (``port_bench/loops/<loop>.py``, named by its mix)
takes the readings with its ``readings(cell, args, device, out)``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import core  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", type=lambda s: [f for f in s.split(",") if f], default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "program": {}, "control": {}}
    device = torch.device("cuda:0")
    core.loop(cell.mix["loop"]).readings(cell, args, device, out)
    for kind in [k for k in out if isinstance(out[k], dict)]:
        values = out[kind].values()
        if values:
            names = sorted({n for v in values for n in v})
            extreme = max if kind == "program" else min
            out.setdefault("summary", {})[kind] = {
                n: extreme(v[n] for v in values if n in v) for n in names}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out.get("summary")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
