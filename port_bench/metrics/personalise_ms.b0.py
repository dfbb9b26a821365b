"""Time to personalise: the mean over the window's tasks of the protocol's own
timer (ended by a device sync).

The B0 SimpleCNAPs cell's own metric, with its own bound: its host time outside
the protocol's timers swings 1.6-3.4 s a cycle (PERF.md), where the ViT cell's
holds within 0.2 s."""
from port_bench import measure


def read(run):
    return measure.mean_ms(run, "personalise_s")
