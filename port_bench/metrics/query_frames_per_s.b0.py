"""Real query frames scored over the whole window's host time.

The B0 SimpleCNAPs cell's own metric, with its own bound: its host time outside
the protocol's timers swings 1.6-3.4 s a cycle (PERF.md), where the ViT cell's
holds within 0.2 s."""
from port_bench import measure


def read(run):
    return measure.per_second(run, "query_frames")
