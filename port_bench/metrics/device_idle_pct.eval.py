"""Share of the traced tasks' host time with nothing running on the device."""
from port_bench import measure


def read(run):
    return measure.idle_pct(run)
