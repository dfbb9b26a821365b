"""Time to personalise: the mean over the window's tasks of the protocol's own
timer (ended by a device sync)."""
from port_bench import measure


def read(run):
    return measure.mean_ms(run, "personalise_s")
