"""Real query frames scored over the whole window's host time."""
from port_bench import measure


def read(run):
    return measure.per_second(run, "query_frames")
