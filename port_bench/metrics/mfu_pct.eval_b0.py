"""The traced tasks' model FLOPs (real frames only) over their host time at the
card's float32 peak.
As its ``.eval`` twin, in the B0 SimpleCNAPs cell, whose throughput is
``query_frames_per_s.b0``."""
from port_bench import measure


def read(run):
    return measure.mfu_pct(run)
