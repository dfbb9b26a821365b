"""Share of the traced tasks' host time with nothing running on the device.
As its ``.eval`` twin, in the B0 SimpleCNAPs cell, whose throughput is
``query_frames_per_s.b0``."""
from port_bench import measure


def read(run):
    return measure.idle_pct(run)
