"""The traced steps' summed bounds of the port's kernel calls over those
kernels' device time."""
from port_bench import measure


def read(run):
    return measure.roofline_pct(run)
