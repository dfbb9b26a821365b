"""The traced tasks' model FLOPs (real frames only) over their host time at the
card's float32 peak."""
from port_bench import measure


def read(run):
    return measure.mfu_pct(run)
