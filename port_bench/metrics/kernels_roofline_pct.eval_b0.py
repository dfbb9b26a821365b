"""The traced tasks' summed bounds of the port's kernel calls over those
kernels' device time.
As its ``.eval`` twin, in the B0 SimpleCNAPs cell, whose throughput is
``query_frames_per_s.b0``."""
from port_bench import measure


def read(run):
    return measure.roofline_pct(run)
